"""Per-launch telemetry behind the OP_STATS wire request: the port of
hotstuff_tpu/sidecar/sched/stats.py.

Launch sizes (coalesce histogram), padded capacity wasted or used by
bulk fill, the verify path each launch took, queue waits per class and
per tenant (p50/p99), admissions and sheds, the bulk lane's source mix,
the mesh and whole-backlog scan sections (fed by a mesh engine's
launches; zero on one card), and the share of host pack time the pipeline
hid behind device execution (the ``pipeline`` overlap section).

Writers: the engine and pack threads and the connection threads; one
lock guards it all.
"""

from __future__ import annotations

import threading
from collections import deque
from time import monotonic

# Rolling window of the ``pipeline`` section, bounded by entry count and
# by age, so it answers for recent pack-boundedness; lifetime totals
# stay under ``lifetime_*`` keys.
PIPE_WINDOW = 512
PIPE_WINDOW_S = 30.0


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile of an ascending list (empty -> 0)."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class SchedStats:
    # Bounded queue-wait reservoirs per class (newest samples win).
    WAIT_SAMPLES_CAP = 4096

    # Distinct tenants tracked in the per-tenant section; overflow
    # tenants fold into "~other".
    TENANT_STATS_CAP = 64
    TENANT_WAIT_SAMPLES_CAP = 1024
    OVERFLOW_TENANT = "~other"

    def __init__(self, clock=monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self.launches = 0
        self.launches_by_class: dict[str, int] = {}
        # padded-bucket capacity -> launches
        self.coalesce_hist: dict[int, int] = {}
        self.sigs_launched = 0
        self.pad_waste_sigs = 0          # padded slots left empty
        self.bulk_fill_sigs = 0          # padded slots used by bulk fill
        self.paths: dict[str, int] = {}  # per_sig / rlc / rlc_bisect / ...
        self.admitted: dict[str, int] = {}
        self.queue_full: dict[str, int] = {}
        self.carries: dict[str, int] = {}
        self.mesh_launches = 0
        self.shard_bucket_hist: dict[int, int] = {}
        # Bulk-lane feed mix: mempool admission verifies (the pinned
        # ingress ctx tag) against offchain batches.
        self.ingress_bulk_requests = 0
        self.ingress_bulk_sigs = 0
        self.offchain_bulk_requests = 0
        self.offchain_bulk_sigs = 0
        self.scan_launches = 0
        self.scan_sigs = 0
        self.scan_chunk_hist: dict[int, int] = {}
        self.scan_slices_avoided = 0
        # Host pack time and the share of it that ran while a launch was
        # executing on the device (hidden).
        self.pack_s = 0.0
        self.pack_hidden_s = 0.0
        self._pack_window = deque(maxlen=PIPE_WINDOW)  # (t, dur, hidden)
        self._waits = {c: deque(maxlen=self.WAIT_SAMPLES_CAP)
                       for c in ("latency", "bulk")}
        self._tenants: dict[str, dict] = {}
        # The admission controller (surge.py), attached by the Scheduler:
        # note_pack / note_launch forward into it, snapshot() folds its
        # counters in as the ``surge`` section.
        self.surge = None

    # -- recording ----------------------------------------------------------

    def _tenant_locked(self, tenant: str) -> dict:
        """The per-tenant record, created under the cap (overflow tenants
        share one "~other" record)."""
        rec = self._tenants.get(tenant)
        if rec is None:
            if len(self._tenants) >= self.TENANT_STATS_CAP:
                tenant = self.OVERFLOW_TENANT
                rec = self._tenants.get(tenant)
            if rec is None:
                rec = self._tenants[tenant] = {
                    "admitted": {},
                    "shed": {},
                    "waits": {c: deque(
                        maxlen=self.TENANT_WAIT_SAMPLES_CAP)
                        for c in ("latency", "bulk")},
                }
        return rec

    def note_tenant_admitted(self, tenant: str, cls: str):
        with self._lock:
            adm = self._tenant_locked(tenant)["admitted"]
            adm[cls] = adm.get(cls, 0) + 1

    def note_tenant_shed(self, tenant: str, cls: str):
        with self._lock:
            shed = self._tenant_locked(tenant)["shed"]
            shed[cls] = shed.get(cls, 0) + 1

    def note_admitted(self, cls: str):
        with self._lock:
            self.admitted[cls] = self.admitted.get(cls, 0) + 1

    def note_queue_full(self, cls: str):
        with self._lock:
            self.queue_full[cls] = self.queue_full.get(cls, 0) + 1

    def note_carry(self, cls: str):
        with self._lock:
            self.carries[cls] = self.carries.get(cls, 0) + 1

    def note_launch(self, launch, capacity: int, now: float):
        """One assembled launch: size/pad/fill accounting and queue
        waits.  ``capacity`` is the padded shape the batch rides in."""
        if self.surge is not None:
            self.surge.note_launch(launch.total_sigs, now)
        with self._lock:
            self.launches += 1
            self.launches_by_class[launch.cls] = \
                self.launches_by_class.get(launch.cls, 0) + 1
            total = launch.total_sigs
            self.sigs_launched += total
            self.coalesce_hist[capacity] = \
                self.coalesce_hist.get(capacity, 0) + 1
            self.pad_waste_sigs += max(0, capacity - total)
            fill = launch.items[len(launch.items) - launch.fill_count:]
            self.bulk_fill_sigs += sum(len(p) for p in fill)
            for p in launch.items:
                waits = self._waits.get(p.cls)
                if waits is not None:
                    waits.append(now - p.enqueued_at)
                tw = self._tenant_locked(
                    getattr(p, "tenant", None) or "default")["waits"]
                if p.cls in tw:
                    tw[p.cls].append(now - p.enqueued_at)

    def note_bulk_source(self, ingress: bool, sigs: int):
        """One offered bulk-lane request, by feed; counted at submit
        time (offered load), so the mix stays honest under shedding."""
        with self._lock:
            if ingress:
                self.ingress_bulk_requests += 1
                self.ingress_bulk_sigs += sigs
            else:
                self.offchain_bulk_requests += 1
                self.offchain_bulk_sigs += sigs

    def note_path(self, path: str):
        with self._lock:
            self.paths[path] = self.paths.get(path, 0) + 1

    def note_mesh_launch(self, buckets):
        """One launch dispatched onto a device mesh, counted once, with
        each slice's per-shard bucket in the histogram."""
        with self._lock:
            self.mesh_launches += 1
            for b in buckets:
                if b is not None:
                    self.shard_bucket_hist[b] = \
                        self.shard_bucket_hist.get(b, 0) + 1

    def note_scan_launch(self, g: int, sigs: int, slices_avoided: int):
        """One whole-backlog chunked mesh scan: g chunks, ``sigs``
        signatures, ``slices_avoided`` ladder dispatches saved."""
        with self._lock:
            self.scan_launches += 1
            self.scan_sigs += sigs
            self.scan_chunk_hist[g] = self.scan_chunk_hist.get(g, 0) + 1
            self.scan_slices_avoided += max(0, slices_avoided)

    def note_pack(self, duration_s: float, hidden: bool,
                  now: float | None = None):
        """One host-side pack stage; ``hidden`` says a launch was
        executing on the device when the pack began."""
        now = self._clock() if now is None else now
        if self.surge is not None:
            self.surge.note_pack(duration_s, hidden, now=now)
        with self._lock:
            self.pack_s += duration_s
            if hidden:
                self.pack_hidden_s += duration_s
            self._pack_window.append((now, duration_s, bool(hidden)))

    # -- reporting ----------------------------------------------------------

    def _pipeline_locked(self) -> dict:
        """The ``pipeline`` section over the rolling window, with the
        lifetime accumulators under ``lifetime_*``."""
        now = self._clock()
        while self._pack_window and \
                now - self._pack_window[0][0] > PIPE_WINDOW_S:
            self._pack_window.popleft()
        win = sum(d for _, d, _ in self._pack_window)
        win_hidden = sum(d for _, d, h in self._pack_window if h)
        return {
            "pack_ms": round(win * 1e3, 3),
            "pack_hidden_ms": round(win_hidden * 1e3, 3),
            "overlap_ratio": round(win_hidden / win, 3) if win else 0.0,
            "window_s": PIPE_WINDOW_S,
            "lifetime_pack_ms": round(self.pack_s * 1e3, 3),
            "lifetime_overlap_ratio": round(
                self.pack_hidden_s / self.pack_s, 3)
            if self.pack_s else 0.0,
        }

    def snapshot(self) -> dict:
        """JSON-safe dict: the OP_STATS reply body."""
        surge = self.surge.snapshot() if self.surge is not None else None
        with self._lock:
            waits = {}
            for cls, samples in self._waits.items():
                vals = sorted(samples)
                waits[cls] = {
                    "n": len(vals),
                    "p50_ms": round(_percentile(vals, 0.50) * 1e3, 3),
                    "p99_ms": round(_percentile(vals, 0.99) * 1e3, 3),
                }
            out = {
                "launches": self.launches,
                "launches_by_class": dict(self.launches_by_class),
                "coalesce_hist": {str(k): v for k, v in
                                  sorted(self.coalesce_hist.items())},
                "sigs_launched": self.sigs_launched,
                "pad_waste_sigs": self.pad_waste_sigs,
                "bulk_fill_sigs": self.bulk_fill_sigs,
                "paths": dict(self.paths),
                "admitted": dict(self.admitted),
                "queue_full": dict(self.queue_full),
                "carries": dict(self.carries),
                "queue_wait": waits,
                "mesh": {
                    "sharded_launches": self.mesh_launches,
                    "shard_buckets": {
                        str(k): v for k, v in
                        sorted(self.shard_bucket_hist.items())},
                },
                "scan": {
                    "launches": self.scan_launches,
                    "sigs": self.scan_sigs,
                    "chunk_hist": {
                        str(k): v for k, v in
                        sorted(self.scan_chunk_hist.items())},
                    "slices_avoided": self.scan_slices_avoided,
                },
                "pipeline": self._pipeline_locked(),
                "tenants": {
                    tenant: {
                        "admitted": dict(rec["admitted"]),
                        "shed": dict(rec["shed"]),
                        "queue_wait": {
                            cls: {
                                "n": len(v),
                                "p50_ms": round(
                                    _percentile(v, 0.50) * 1e3, 3),
                                "p99_ms": round(
                                    _percentile(v, 0.99) * 1e3, 3),
                            }
                            for cls, samples in rec["waits"].items()
                            if (v := sorted(samples))
                        },
                    }
                    for tenant, rec in sorted(self._tenants.items())
                },
                "ingress": {
                    "bulk_requests": self.ingress_bulk_requests,
                    "bulk_sigs": self.ingress_bulk_sigs,
                    "offchain_requests": self.offchain_bulk_requests,
                    "offchain_sigs": self.offchain_bulk_sigs,
                },
            }
            if surge is not None:
                out["surge"] = surge
            return out
