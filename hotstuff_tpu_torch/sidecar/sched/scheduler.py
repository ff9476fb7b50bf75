"""The deadline-aware two-class batching scheduler of the verify engine:
the port of hotstuff_tpu/sidecar/sched/scheduler.py.

Strict latency priority.
    Whenever latency-class work is queued, the next launch is assembled
    from the latency queue only: a QC verify waits behind no bulk
    backlog, only behind the launches already in flight (the engine's
    pipeline bounds those to PIPELINE_DEPTH).

Carry-over within a class.
    Coalescing never splits a request.  A head request that does not fit
    the remaining launch budget stays queued and leads the next launch of
    its class (``carries`` counts how often).

Bulk pad-fill.
    A latency launch of n unique records rides in a padded bucket of
    ``bucket(n)`` rows anyway; the dead slots are filled with whole bulk
    requests that fit (room sized off the deduped record count, so fill
    never grows the shape), so bulk drains even under sustained latency
    load.

Bounded backpressure.
    Both queues are bounded in signature records, per class and per
    tenant; ``offer`` never blocks.  A full queue is an OP_BUSY reply
    with a retry-after hint (``retry_after_ms``, from the surge
    controller's drain rate).

The scheduler owns queues and policy only; the device, the verify paths
and the reply fan-out stay in ``sidecar/service.VerifyEngine``.
"""

from __future__ import annotations

import os
import threading
from time import monotonic

from ...crypto.eddsa import MAX_SUBBATCH
from .classes import BULK, LATENCY, ClassQueue, Launch, Pending
from .shapes import ShapeRegistry
from .stats import SchedStats
from .surge import AdmissionController

# The STATIC defaults; deployments that know their committee size /
# client rate get caps sized from those parameters instead, and the
# HOTSTUFF_TPU_{LATENCY,BULK}_QUEUE_CAP_SIGS env vars override both.
_DEFAULT_LATENCY_CAP_SIGS = 64 * 1024
_DEFAULT_BULK_CAP_SIGS = 128 * 1024

# Per-replica async verify pipeline depth the latency sizing assumes --
# the C++ node's MAXIMUM adaptive in-flight budget (TpuVerifier::
# kInflightBudgetMax; the budget only ever shrinks below this).
_INFLIGHT_PER_REPLICA = 64


def _env_cap(name: str):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        v = int(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, v))


def size_queue_caps(committee: int | None = None,
                    client_rate: int | None = None):
    """``(latency_cap_sigs, bulk_cap_sigs)`` for a deployment.

    Latency demand scales with the committee: on the shared local
    testbed every replica verifies every certificate, so a worst-case
    burst is ``committee`` replicas x ``_INFLIGHT_PER_REPLICA`` pipelined
    requests x ``quorum`` signatures each.  Bulk demand scales with the
    client transaction rate: the cap admits ~2 s of arrivals, past which
    shedding to the client's host path beats an ever-older backlog.
    Both are clamped to [default/4, 16x default] so a typo'd parameter
    cannot starve or balloon the sidecar, and the explicit env
    overrides (HOTSTUFF_TPU_LATENCY_QUEUE_CAP_SIGS /
    HOTSTUFF_TPU_BULK_QUEUE_CAP_SIGS) win over everything."""
    lat = _env_cap("HOTSTUFF_TPU_LATENCY_QUEUE_CAP_SIGS")
    if lat is None:
        if committee and committee > 1:
            quorum = 2 * committee // 3 + 1
            lat = _clamp(committee * quorum * _INFLIGHT_PER_REPLICA,
                         _DEFAULT_LATENCY_CAP_SIGS // 4,
                         16 * _DEFAULT_LATENCY_CAP_SIGS)
        else:
            lat = _DEFAULT_LATENCY_CAP_SIGS
    blk = _env_cap("HOTSTUFF_TPU_BULK_QUEUE_CAP_SIGS")
    if blk is None:
        if client_rate and client_rate > 0:
            blk = _clamp(2 * client_rate,
                         _DEFAULT_BULK_CAP_SIGS // 4,
                         16 * _DEFAULT_BULK_CAP_SIGS)
        else:
            blk = _DEFAULT_BULK_CAP_SIGS
    return lat, blk


def size_tenant_caps(latency_cap_sigs: int, bulk_cap_sigs: int,
                     committee: int | None = None):
    """``(latency_tenant_cap_sigs, bulk_tenant_cap_sigs)``: one tenant's
    admission share of each class queue.  The latency share is one
    committee's worst-case pipelined QC burst (sized like the class cap),
    the bulk share half the class cap.  Shares engage only once a second
    tenant has been seen (ClassQueue._offer_locked)."""
    if committee and committee > 1:
        quorum = 2 * committee // 3 + 1
        lat = _clamp(committee * quorum * _INFLIGHT_PER_REPLICA,
                     latency_cap_sigs // 4, latency_cap_sigs)
    else:
        lat = latency_cap_sigs
    return lat, max(1, bulk_cap_sigs // 2)


LATENCY_QUEUE_CAP_SIGS, BULK_QUEUE_CAP_SIGS = size_queue_caps()


class Scheduler:
    def __init__(self, shapes: ShapeRegistry | None = None,
                 stats: SchedStats | None = None,
                 latency_cap_sigs: int = LATENCY_QUEUE_CAP_SIGS,
                 bulk_cap_sigs: int = BULK_QUEUE_CAP_SIGS,
                 admission: AdmissionController | None = None,
                 committee: int | None = None):
        self.shapes = shapes if shapes is not None else ShapeRegistry()
        self.stats = stats if stats is not None else SchedStats()
        # The surge controller derates bulk intake off the pipeline
        # overlap; the stats object forwards the engine's pack and launch
        # observations into it and folds its counters into OP_STATS.
        self.admission = admission if admission is not None \
            else AdmissionController()
        self.stats.surge = self.admission
        self._cond = threading.Condition()
        lat_share, blk_share = size_tenant_caps(
            latency_cap_sigs, bulk_cap_sigs, committee)
        # The host path verifies record by record, so a launch's time
        # grows with its size: a host registry launches one request at
        # a time and turns the tenant ring after each.
        host = self.shapes.use_host
        self._queues = {
            LATENCY: ClassQueue(latency_cap_sigs, self._cond,
                                tenant_cap_sigs=lat_share,
                                per_request=host),
            BULK: ClassQueue(bulk_cap_sigs, self._cond,
                             tenant_cap_sigs=blk_share, per_request=host),
        }

    # -- admission (connection threads) -------------------------------------

    def offer(self, request, reply_fn, cls: str = LATENCY,
              is_bls: bool = False, tenant: str | None = None) -> bool:
        """Admit one request; False means queue-full (the caller replies
        OP_BUSY; nothing was retained).

        On top of the caps: bulk is shed outright while the latency class
        is under shed pressure (bulk before latency), and bulk admits
        against a cap derated by the surge controller.  A latency shed at
        the class cap while another tenant holds more than its share is
        counted as ``tenant_starvation``.  Every check runs under the one
        admission lock."""
        pending = Pending(request, reply_fn, cls, is_bls=is_bls,
                          tenant=tenant)
        adm = self.admission
        with self._cond:
            if cls == BULK:
                lat = self._queues[LATENCY]
                if adm.latency_pressure() or (
                        lat.sigs and lat.sigs >= lat.cap_sigs):
                    adm.note_shed(BULK, before_latency=True)
                    self.stats.note_queue_full(cls)
                    self.stats.note_tenant_shed(pending.tenant, cls)
                    return False
                cap = int(self._queues[BULK].cap_sigs * adm.bulk_derate())
                if not self._queues[BULK]._offer_locked(pending,
                                                        cap_sigs=cap):
                    adm.note_shed(BULK)
                    self.stats.note_queue_full(cls)
                    self.stats.note_tenant_shed(pending.tenant, cls)
                    return False
            elif not self._queues[cls]._offer_locked(pending):
                if cls == LATENCY:
                    adm.note_latency_shed()
                    q = self._queues[LATENCY]
                    if q.last_refusal == "class-cap" and \
                            q.lanes.any_over_cap_locked(
                                q.tenant_cap_sigs,
                                exclude=pending.tenant):
                        adm.note_tenant_starvation()
                adm.note_shed(cls)
                self.stats.note_queue_full(cls)
                self.stats.note_tenant_shed(pending.tenant, cls)
                return False
            adm.note_admitted(cls)
            self.stats.note_admitted(cls)
            self.stats.note_tenant_admitted(pending.tenant, cls)
            return True

    def retry_after_ms(self, cls: str) -> int:
        """Hint for an OP_BUSY reply: the time this class's backlog needs
        to drain at the recent launch rate (clamped; see surge.py)."""
        return self.admission.retry_after_ms(cls, self._queues[cls].sigs)

    def wake(self):
        """Unblock a next_launch() waiter (shutdown path)."""
        with self._cond:
            self._cond.notify_all()

    def queued_sigs(self, cls: str) -> int:
        return self._queues[cls].sigs

    def queue_caps(self) -> dict:
        """Admission caps per class (OP_STATS telemetry)."""
        return {cls: q.cap_sigs for cls, q in self._queues.items()}

    def tenant_caps(self) -> dict:
        """Per-tenant admission shares per class (OP_STATS telemetry)."""
        return {cls: q.tenant_cap_sigs for cls, q in self._queues.items()}

    def tenant_occupancy(self) -> dict:
        """{class: {tenant: queued sig records}}."""
        with self._cond:
            return {cls: q.lanes.occupancy_locked()
                    for cls, q in self._queues.items()}

    # -- assembly (engine thread) -------------------------------------------

    def next_launch(self, block: bool = True,
                    timeout: float | None = None) -> Launch | None:
        """Assemble the next launch, or None when (a) non-blocking and
        idle, or (b) the timeout expired."""
        return self._next(None, block, timeout)

    def next_tick(self, quota_sigs: int,
                  timeout: float | None = None) -> Launch | None:
        """One cadence tick's quota: the same policy as next_launch with
        the coalesce run capped at ``quota_sigs`` instead of the launch
        cap.  Non-blocking unless a timeout is given."""
        return self._next(quota_sigs, timeout is not None, timeout)

    def _next(self, cap: int | None, block: bool,
              timeout: float | None) -> Launch | None:
        deadline = None if timeout is None else monotonic() + timeout
        with self._cond:
            while True:
                launch = self._assemble_locked(cap=cap)
                if launch is not None or not block:
                    return launch
                wait = None if deadline is None \
                    else max(0.0, deadline - monotonic())
                if wait == 0.0 or not self._cond.wait(timeout=wait):
                    if deadline is not None and monotonic() >= deadline:
                        return None

    def _assemble_locked(self, cap: int | None = None) -> Launch | None:
        lat, blk = self._queues[LATENCY], self._queues[BULK]
        if lat:
            if lat._head_locked().is_bls:
                launch = Launch("bls", [lat._pop_locked()], LATENCY)
                # One BLS request per launch, capacity 1: no pad waste.
                self.stats.note_launch(launch, 1, monotonic())
                return launch
            items, total = self._coalesce_locked(lat, cap=cap)
            # Fill room comes from the deduped record count: the engine
            # dedups records before dispatch and launches bucket(unique),
            # so N replicas submitting one QC (total >> unique) must not
            # size fill off the raw total.  Each fill request counts at
            # its full record count, so unique-after-fill stays inside
            # the latency batch's bucket (on a mesh, the shard-aligned
            # row count: fill never grows a shard's rows).  The dedup hashes every record
            # under the admission lock, so it runs only when fill is
            # possible (bulk queued, batch within one launch).
            fill = []
            if blk and total <= MAX_SUBBATCH:
                uniq = len({rec for p in items
                            for rec in zip(p.request.msgs, p.request.pks,
                                           p.request.sigs)})
                capacity = self.shapes.bucket_capacity(uniq)
                fill = self._fill_locked(blk, capacity - uniq)
            else:
                capacity = self.shapes.bucket_capacity(total)
            launch = Launch("verify", items + fill, LATENCY,
                            fill_count=len(fill))
            self.stats.note_launch(launch, capacity, monotonic())
            return launch
        if blk:
            items, total = self._coalesce_locked(blk, cap=cap)
            launch = Launch("verify", items, BULK)
            self.stats.note_launch(
                launch, self.shapes.bucket_capacity(total), monotonic())
            return launch
        return None

    def _coalesce_locked(self, q: ClassQueue, cap: int | None = None):
        """Pop a FIFO run of same-class Ed25519 requests up to the launch
        cap (or a tick's quota, never above it).  The head always ships
        (an oversized single request slices inside the engine); a later
        head that would overflow the budget stays queued and leads the
        next launch (carry-over).  A host registry's launch is its head
        alone; a cadence tick still fills its quota."""
        items = [q._pop_locked()]
        total = len(items[0])
        if cap is None and self.shapes.use_host:
            return items, total
        cap = self.shapes.launch_cap if cap is None \
            else min(cap, self.shapes.launch_cap)
        while (nxt := q._head_locked()) is not None and not nxt.is_bls:
            nxt_len = len(nxt)
            if total + nxt_len > cap:
                self.stats.note_carry(items[0].cls)
                break
            items.append(q._pop_locked())
            total += nxt_len
        return items, total

    def _fill_locked(self, blk: ClassQueue, room: int):
        """Whole bulk requests that fit the latency launch's pad slots."""
        fill = []
        while room > 0:
            h = blk._head_locked()
            if h is None or h.is_bls or len(h) > room:
                break
            p = blk._pop_locked()
            fill.append(p)
            room -= len(p)
        return fill
