"""Request classes of the verify scheduler and its queue types: the port
of hotstuff_tpu/sidecar/sched/classes.py.

``LATENCY``
    QC/TC verifies from the consensus core (``OP_VERIFY_BATCH`` and every
    BLS verify/sign opcode).  A replica cannot vote, and a leader cannot
    assemble the next block, until the previous certificate checks out,
    so a latency request never waits behind more than the launches
    already in flight.

``BULK``
    Mempool / offchain batch verifies (``OP_VERIFY_BULK``).  Throughput
    matters, per-request latency does not; bulk batches coalesce up to
    the launch cap and yield to any pending latency work.
"""

from __future__ import annotations

import threading
from time import monotonic

from .tenantq import DEFAULT_TENANT, DRR_QUANTUM_SIGS, TenantLanes

# Class identifiers (also the keys of every per-class stats dict).
LATENCY = "latency"
BULK = "bulk"


def class_of_opcode(opcode: int) -> str:
    """Wire opcode -> scheduling class (one source of truth)."""
    from .. import protocol as proto

    return BULK if opcode == proto.OP_VERIFY_BULK else LATENCY


class Pending:
    """One admitted request: the decoded request, its reply callback,
    its class, its tenant (the connection's HELLO identity or the
    default), and the admission time (queue-wait telemetry)."""

    __slots__ = ("request", "reply_fn", "cls", "enqueued_at", "is_bls",
                 "tenant")

    def __init__(self, request, reply_fn, cls: str = LATENCY,
                 is_bls: bool = False, tenant: str | None = None):
        self.request = request
        self.reply_fn = reply_fn
        self.cls = cls
        self.is_bls = is_bls
        self.tenant = DEFAULT_TENANT if tenant is None else tenant
        self.enqueued_at = monotonic()

    def __len__(self):
        """Signature-record count (BLS requests schedule as one unit)."""
        if self.is_bls:
            return 1
        return len(self.request.msgs)


class Launch:
    """One assembled launch: ordered items plus what the engine thread
    needs to fan replies back out.

    ``kind`` is ``"verify"`` (a coalesced Ed25519 batch, possibly a
    latency batch padded out with bulk fill) or ``"bls"`` (one BLS
    request, executed alone).  ``fill_count`` counts the trailing items
    that rode along as pad fill (telemetry only)."""

    __slots__ = ("kind", "items", "cls", "fill_count")

    def __init__(self, kind: str, items: list, cls: str,
                 fill_count: int = 0):
        self.kind = kind
        self.items = items
        self.cls = cls
        self.fill_count = fill_count

    @property
    def total_sigs(self) -> int:
        return sum(len(p) for p in self.items)


class ClassQueue:
    """Bounded queue for one class, counted in signature records, with
    per-tenant lanes drained in deficit round-robin order.

    Admission never blocks: a full queue returns False and the caller
    replies OP_BUSY at once.  The engine thread is the only consumer.
    The scheduler's condition (shared, for cross-queue atomicity when
    assembling) guards the lanes and the signature count.

    Two caps govern admission: the class cap (total records queued) and
    the per-tenant cap, so a flooding tenant sheds on its own share
    while every other tenant keeps admitting.  ``last_refusal`` records
    why the most recent ``_offer_locked`` said no (``"tenant-cap"`` or
    ``"class-cap"``), valid until the lock is released."""

    __slots__ = ("lanes", "cap_sigs", "tenant_cap_sigs", "last_refusal",
                 "_lock")

    def __init__(self, cap_sigs: int, lock: threading.Condition,
                 tenant_cap_sigs: int | None = None,
                 quantum_sigs: int | None = None,
                 per_request: bool = False):
        self.lanes = TenantLanes(
            DRR_QUANTUM_SIGS if quantum_sigs is None else quantum_sigs,
            per_request=per_request)
        self.cap_sigs = cap_sigs
        self.tenant_cap_sigs = cap_sigs if tenant_cap_sigs is None \
            else min(tenant_cap_sigs, cap_sigs)
        self.last_refusal = None
        self._lock = lock

    @property
    def sigs(self) -> int:
        """Total queued signature records (the lanes own the count)."""
        return self.lanes.sigs

    def _offer_locked(self, pending: Pending, cap_sigs: int | None = None)\
            -> bool:
        # A request is admitted whole or not at all; a single request
        # bigger than the whole cap is still admitted when the queue (or
        # its own lane) is empty, and slices inside the engine, so a
        # legal client is never starved by its own size.  ``cap_sigs``
        # admits against a derated cap (the surge controller).  The
        # tenant share is checked first, and only once a second tenant
        # has been seen: with one tenant the class cap is the policy.
        self.last_refusal = None
        cap = self.cap_sigs if cap_sigs is None else cap_sigs
        lane_sigs = self.lanes.tenant_sigs_locked(pending.tenant)
        multi_tenant = len(self.lanes.lanes) >= 2 or (
            self.lanes.lanes and pending.tenant not in self.lanes.lanes)
        tenant_cap = min(self.tenant_cap_sigs, cap)
        if multi_tenant and lane_sigs and \
                lane_sigs + len(pending) > tenant_cap:
            self.last_refusal = "tenant-cap"
            return False
        if self.lanes.sigs and self.lanes.sigs + len(pending) > cap:
            self.last_refusal = "class-cap"
            return False
        self.lanes._offer_locked(pending)
        self._lock.notify()
        return True

    def _head_locked(self) -> Pending | None:
        """The DRR-selected next item (None when empty)."""
        return self.lanes.head_locked()

    def _pop_locked(self) -> Pending:
        return self.lanes.pop_next_locked()

    def __bool__(self):
        return bool(self.lanes)

    def __len__(self):
        return len(self.lanes)
