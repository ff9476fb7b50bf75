"""Pack-side admission control for the verify scheduler: the port of
hotstuff_tpu/sidecar/sched/surge.py.

The queue caps bound how much work the sidecar holds; this controller
decides how much it accepts while the pipeline says the host's pack
stage, not the device, is the bottleneck.  Three policies:

Overlap-driven bulk derate.
    ``note_pack`` takes the per-pack (duration, hidden) observations the
    OP_STATS ``pipeline`` section aggregates.  While recent pack time is
    hidden behind device execution, bulk admits at the full cap; when
    the overlap collapses the effective bulk cap scales down linearly to
    ``DERATE_FLOOR``.  Under the cadence ring the freshest signal is ring
    occupancy instead (``note_ring_occupancy``).

Bulk-before-latency shedding.
    A latency-class shed opens a pressure window during which every bulk
    offer is shed outright.  ``fairness_violations`` counts a bulk
    admission inside that window, which the scheduler's lock makes
    unreachable.

Retry-after hints.
    ``retry_after_ms`` turns queue depth and the recent drain rate into
    the hint an OP_BUSY reply carries, clamped to [RETRY_MIN_MS,
    RETRY_MAX_MS].

Writers: connection threads (offers) and the engine and pack threads.
One private lock guards the state; callers may hold the scheduler's
lock when calling in (scheduler lock, then this one, never back).
"""

from __future__ import annotations

import threading
from collections import deque
from time import monotonic

from .classes import BULK, LATENCY

# Overlap ratio at or above which pack work counts as hidden (full bulk
# cap); below it the cap scales linearly down to DERATE_FLOOR at 0.
OVERLAP_KNEE = 0.5
DERATE_FLOOR = 0.25
# Only recent packs count: at most PACK_WINDOW, none older than
# PACK_WINDOW_S seconds.
PACK_WINDOW = 64
PACK_WINDOW_S = 10.0
# Minimum evidence before derating.
MIN_PACKS = 8
MIN_PACK_S = 0.005

# Ring occupancy samples (one per cadence tick); evidence older than
# RING_OCC_WINDOW_S means the ring stopped and the overlap rule rules.
RING_OCC_WINDOW = 256
RING_OCC_WINDOW_S = 2.0
RING_OCC_KNEE = 0.75

# A latency-class shed opens this pressure window (s).
LATENCY_PRESSURE_S = 1.0

# Launches contributing to the drain-rate estimate behind retry-after.
LAUNCH_WINDOW = 64
RETRY_MIN_MS = 25
RETRY_MAX_MS = 2000
# Without a drain rate yet: latency retries fast, bulk waits a launch.
RETRY_DEFAULT_MS = {LATENCY: 50, BULK: 250}


class AdmissionController:
    """Overlap-driven admission state and the OP_STATS ``surge``
    section."""

    def __init__(self, clock=monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._packs = deque(maxlen=PACK_WINDOW)     # (t, dur_s, hidden)
        self._launches = deque(maxlen=LAUNCH_WINDOW)  # (t, sigs)
        self._ring_occ = deque(maxlen=RING_OCC_WINDOW)  # (t, occ_frac)
        self._lat_pressure_until = 0.0
        self._derate_engaged = False
        self.admitted = {LATENCY: 0, BULK: 0}
        self.shed = {LATENCY: 0, BULK: 0}
        self.busy_replies = {LATENCY: 0, BULK: 0}
        self.bulk_before_latency_sheds = 0
        self.fairness_violations = 0
        # A latency refusal at the class cap while another tenant holds
        # more than its share: unreachable with per-lane admission.
        self.tenant_starvation = 0
        self.derate_engagements = 0

    # -- pipeline evidence (engine / pack threads) --------------------------

    def note_pack(self, duration_s: float, hidden: bool,
                  now: float | None = None):
        now = self._clock() if now is None else now
        with self._lock:
            self._packs.append((now, duration_s, bool(hidden)))
            self._update_engagement_locked()

    def note_launch(self, sigs: int, now: float | None = None):
        now = self._clock() if now is None else now
        with self._lock:
            self._launches.append((now, sigs))

    def note_ring_occupancy(self, occupied: int, depth: int,
                            now: float | None = None):
        """One per-tick ring occupancy sample (occupied slots out of the
        ring's depth).  While fresh, the derate reads it instead of the
        pack overlap."""
        now = self._clock() if now is None else now
        with self._lock:
            frac = occupied / depth if depth > 0 else 0.0
            self._ring_occ.append((now, min(1.0, max(0.0, frac))))
            self._update_engagement_locked()

    def recent_overlap(self) -> float | None:
        """Hidden share of recent pack time, or None without evidence."""
        with self._lock:
            return self._recent_overlap_locked()

    def _recent_overlap_locked(self, now: float | None = None):
        now = self._clock() if now is None else now
        while self._packs and now - self._packs[0][0] > PACK_WINDOW_S:
            self._packs.popleft()
        if len(self._packs) < MIN_PACKS:
            return None
        total = sum(d for _, d, _ in self._packs)
        if total < MIN_PACK_S:
            return None
        return sum(d for _, d, h in self._packs if h) / total

    def _ring_occupancy_locked(self, now: float | None = None):
        """Mean recent ring occupancy, or None when stale or absent."""
        now = self._clock() if now is None else now
        while self._ring_occ and now - self._ring_occ[0][0] > \
                RING_OCC_WINDOW_S:
            self._ring_occ.popleft()
        if not self._ring_occ:
            return None
        return sum(f for _, f in self._ring_occ) / len(self._ring_occ)

    def _derate_factor_locked(self) -> float:
        occ = self._ring_occupancy_locked()
        if occ is not None:
            if occ <= RING_OCC_KNEE:
                return 1.0
            span = (occ - RING_OCC_KNEE) / (1.0 - RING_OCC_KNEE)
            return max(DERATE_FLOOR, 1.0 - (1.0 - DERATE_FLOOR) * span)
        o = self._recent_overlap_locked()
        if o is None or o >= OVERLAP_KNEE:
            return 1.0
        return DERATE_FLOOR + (1.0 - DERATE_FLOOR) * (o / OVERLAP_KNEE)

    def _update_engagement_locked(self):
        engaged = self._derate_factor_locked() < 1.0
        if engaged and not self._derate_engaged:
            self.derate_engagements += 1
        self._derate_engaged = engaged

    def bulk_derate(self) -> float:
        """Multiplier on the bulk queue cap, in [DERATE_FLOOR, 1.0]."""
        with self._lock:
            return self._derate_factor_locked()

    # -- admission outcomes (connection threads, under the scheduler lock) --

    def note_latency_shed(self, now: float | None = None):
        now = self._clock() if now is None else now
        with self._lock:
            self._lat_pressure_until = now + LATENCY_PRESSURE_S

    def latency_pressure(self, now: float | None = None) -> bool:
        now = self._clock() if now is None else now
        with self._lock:
            return now < self._lat_pressure_until

    def note_admitted(self, cls: str, now: float | None = None):
        now = self._clock() if now is None else now
        with self._lock:
            self.admitted[cls] = self.admitted.get(cls, 0) + 1
            if cls == BULK and now < self._lat_pressure_until:
                self.fairness_violations += 1

    def note_tenant_starvation(self):
        with self._lock:
            self.tenant_starvation += 1

    def note_shed(self, cls: str, before_latency: bool = False,
                  busy_reply: bool = True):
        with self._lock:
            self.shed[cls] = self.shed.get(cls, 0) + 1
            if busy_reply:
                self.busy_replies[cls] = self.busy_replies.get(cls, 0) + 1
            if before_latency:
                self.bulk_before_latency_sheds += 1

    # -- retry-after --------------------------------------------------------

    def drain_rate_sigs_per_s(self, now: float | None = None):
        """Recent launch throughput, or None without enough launches."""
        now = self._clock() if now is None else now
        with self._lock:
            if len(self._launches) < 2:
                return None
            t0 = self._launches[0][0]
            span = max(now - t0, 1e-6)
            total = sum(s for _, s in self._launches)
            return total / span

    def retry_after_ms(self, cls: str, queued_sigs: int = 0) -> int:
        rate = self.drain_rate_sigs_per_s()
        if rate is None or rate <= 0 or queued_sigs <= 0:
            ms = RETRY_DEFAULT_MS.get(cls, RETRY_DEFAULT_MS[BULK])
        else:
            ms = queued_sigs / rate * 1e3
        return int(max(RETRY_MIN_MS, min(RETRY_MAX_MS, ms)))

    # -- reporting ----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-safe ``surge`` section of the OP_STATS reply."""
        with self._lock:
            overlap = self._recent_overlap_locked()
            ring_occ = self._ring_occupancy_locked()
            return {
                "admitted": dict(self.admitted),
                "shed": dict(self.shed),
                "busy_replies": dict(self.busy_replies),
                "bulk_before_latency_sheds": self.bulk_before_latency_sheds,
                "fairness_violations": self.fairness_violations,
                "tenant_starvation": self.tenant_starvation,
                "derate": {
                    "factor": round(self._derate_factor_locked(), 3),
                    "engaged": self._derate_engaged,
                    "engagements": self.derate_engagements,
                    "overlap_recent": round(overlap, 3)
                    if overlap is not None else None,
                    "ring_occupancy_recent": round(ring_occ, 3)
                    if ring_occ is not None else None,
                },
            }
