"""Tenant-keyed queue lanes, the third scheduling key: the port of
hotstuff_tpu/sidecar/sched/tenantq.py.

Under a shared sidecar every replica of every tenant funnels into the
same two class queues, so one greedy tenant could fill a class cap and
starve everyone else.  The tenant id (OP_HELLO; ``DEFAULT_TENANT`` for a
connection that never says HELLO) is therefore a scheduling key under
each class:

* each tenant owns a FIFO lane inside the class queue (arrival order is
  kept within a tenant, the carry-over fairness token);
* ``pop_next_locked`` serves the active tenants in deficit round-robin
  order, each draining up to ``quantum_sigs`` records per round; with
  one tenant queued the ring never rotates and the lane is a FIFO;
* with ``per_request`` (a host-mode engine's queues; the port's own,
  the reference drains quanta there too) each turn is one request and
  the least recently served tenant goes first, so a tenant that queues
  waits behind no more than the request in progress;
* ``ClassQueue`` checks the offering tenant's lane against a per-tenant
  cap before the class cap, so a flooding tenant sheds on its own share.
"""

from __future__ import annotations

from collections import deque

from ..protocol import DEFAULT_TENANT  # noqa: F401  (part of the API)

# DRR quantum: signature records one tenant may drain per ring round --
# one launch's worth, so a tenant can fill a launch it has the backlog
# for but cannot hold the ring across launches.
DRR_QUANTUM_SIGS = 2048


class _Lane:
    """One tenant's private FIFO inside a class queue."""

    __slots__ = ("items", "sigs", "deficit", "served")

    def __init__(self):
        self.items = deque()
        self.sigs = 0
        self.deficit = 0
        self.served = 0     # the pop count when this lane was last served


class TenantLanes:
    """All per-tenant lanes of one class queue and the DRR drain ring.

    Not locked itself: every method runs under the owning scheduler's
    condition.  ``order`` holds the tenants with queued items, in ring
    order; ``order[0]`` is the tenant DRR currently serves."""

    __slots__ = ("lanes", "order", "sigs", "quantum_sigs", "per_request",
                 "pops")

    def __init__(self, quantum_sigs: int = DRR_QUANTUM_SIGS,
                 per_request: bool = False):
        self.lanes: dict[str, _Lane] = {}
        self.order: deque[str] = deque()
        self.sigs = 0
        self.quantum_sigs = max(1, quantum_sigs)
        self.per_request = per_request
        self.pops = 0

    def _offer_locked(self, pending) -> None:
        """Append to the offering tenant's lane (admission checks are the
        ClassQueue's job)."""
        lane = self.lanes.get(pending.tenant)
        if lane is None:
            lane = self.lanes[pending.tenant] = _Lane()
        if not lane.items:
            self.order.append(pending.tenant)
        lane.items.append(pending)
        lane.sigs += len(pending)
        self.sigs += len(pending)

    def head_locked(self):
        """The next Pending DRR will serve, or None when empty.  Grants
        the serving tenant its quantum lazily on first peek of a round."""
        if not self.order:
            return None
        if self.per_request and len(self.order) > 1:
            first = min(self.order, key=lambda t: self.lanes[t].served)
            self.order.remove(first)
            self.order.appendleft(first)
        lane = self.lanes[self.order[0]]
        if lane.deficit <= 0:
            lane.deficit = self.quantum_sigs
        return lane.items[0]

    def pop_next_locked(self):
        """Pop the DRR-selected head; rotate the ring once the serving
        tenant's deficit is spent and other tenants are waiting."""
        head = self.head_locked()
        if head is None:
            raise IndexError("pop from empty tenant lanes")
        tenant = self.order[0]
        lane = self.lanes[tenant]
        p = lane.items.popleft()
        lane.sigs -= len(p)
        lane.deficit -= len(p)
        self.sigs -= len(p)
        self.pops += 1
        lane.served = self.pops
        if not lane.items:
            self.order.popleft()
            lane.deficit = 0
        elif lane.deficit <= 0 and len(self.order) > 1:
            self.order.rotate(-1)
            lane.deficit = 0
        return p

    def tenant_sigs_locked(self, tenant: str) -> int:
        lane = self.lanes.get(tenant)
        return lane.sigs if lane is not None else 0

    def any_over_cap_locked(self, tenant_cap_sigs: int,
                            exclude: str | None = None) -> bool:
        """True if any tenant other than ``exclude`` holds more than the
        per-tenant cap: what a real starvation event requires, and what
        per-lane admission makes unreachable."""
        return any(lane.sigs > tenant_cap_sigs
                   for tenant, lane in self.lanes.items()
                   if tenant != exclude)

    def occupancy_locked(self) -> dict:
        """tenant -> queued signature records (telemetry snapshot)."""
        return {t: lane.sigs for t, lane in self.lanes.items()
                if lane.sigs}

    def __len__(self):
        return sum(len(lane.items) for lane in self.lanes.values())

    def __bool__(self):
        return bool(self.order)
