"""The launch guard of the verify engine: per-shape launch deadlines,
wedge detection, poison-record quarantine, and what the crash-only
reboot needs.  The port of hotstuff_tpu/sidecar/guard.py.

One hung dispatch or fetch parks the engine thread, and every queued
consensus verify behind it, until the C++ node's circuit breaker times
the whole sidecar out.  The guard runs each staged device call on a
disposable thread under a deadline per launch shape:

    launch --> guard worker thread (disposable, one per launch)
       |            |
       |            v completes within its deadline
       |        result -> the engine replies normally
       |
       +--> the monitor thread sees the deadline overrun -> WEDGED
                |
                v  the engine's degradation ladder (service._wedge_ladder)
            1. latency-class requests of the wedged batch are answered
               from the host path (ref_ed25519, whose masks equal the
               device's);
            2. bulk-class requests get OP_BUSY with a drain-derived
               retry-after (BusyReply);
            3. the batch's records are quarantined (repeat offenders
               are bisected for poison);
            4. the engine reboots crash-only: it drops the device-side
               tables, re-warms while the host path serves (bulk gets
               OP_BUSY), and routes to the device again only after a
               canary launch passes.

Until a shape has ``MIN_OBSERVATIONS`` completed launches its deadline
is ``warm_grace_s`` on a warm boot (the kernel library is loaded:
``LaunchDeadlines.from_build``) and ``compile_budget_s`` on a cold one;
after that ``p99_multiple`` x its measured p99, floored at
``min_deadline_s``.  The environment knobs are the JAX package's, so an
operator's settings carry over:

    HOTSTUFF_TPU_GUARD_COMPILE_BUDGET_S   cold-boot deadline (180)
    HOTSTUFF_TPU_GUARD_WARM_GRACE_S       warm-boot fallback deadline (30)
    HOTSTUFF_TPU_GUARD_P99_MULTIPLE       deadline = multiple x p99 (8)
    HOTSTUFF_TPU_GUARD_MIN_DEADLINE_S     floor under the p99 rule (1.0)
    HOTSTUFF_TPU_GUARD_MAX_REBOOTS        canary failures before the engine
                                          stays on the host path (3)
    HOTSTUFF_TPU_GUARD_MAX_BISECT_PROBES  poison-bisection probe budget (64)

A wedged launch thread is never interrupted (a hung device call cannot
be cancelled from Python): it is abandoned (a daemon thread, it dies
with the process), its late completion is discarded, and a fresh thread
serves the next launch.  Replies happen on the engine thread only after
a guarded call returns clean, so nothing the abandoned call does
reaches a client.
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
import threading
import traceback
from time import monotonic

log = logging.getLogger("sidecar.guard")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    return v if v > 0 else default


class WedgedLaunch(RuntimeError):
    """A guarded launch overran its deadline; the worker was abandoned."""

    def __init__(self, key: str, deadline_s: float):
        super().__init__(
            f"launch {key} overran its {deadline_s:g}s deadline (wedged)")
        self.key = key
        self.deadline_s = deadline_s


class BusyReply:
    """Sentinel reply value for the wedge ladder's bulk lane: the
    connection handler encodes it as an OP_BUSY frame carrying the
    drain-derived retry-after hint instead of a verdict mask (protocol
    v4 — the C++ client reads it as a shed and the breaker reads it as
    a LIVE sidecar, never silence)."""

    __slots__ = ("retry_after_ms",)

    def __init__(self, retry_after_ms: int):
        self.retry_after_ms = int(retry_after_ms)


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class LaunchDeadlines:
    """Per-shape launch deadlines off the boot state plus the guard's
    own observed launch walls.

    Until ``MIN_OBSERVATIONS`` launches of a shape key have completed,
    the deadline is the boot-state fallback: ``warm_grace_s`` on a warm
    boot (the kernel library is loaded: nothing should take 30 s),
    ``compile_budget_s`` otherwise (a first build can take minutes and
    must not read as a wedge).  With enough observations the deadline
    tightens to ``p99_multiple`` x the measured p99, floored at
    ``min_deadline_s``."""

    MIN_OBSERVATIONS = 8
    SAMPLES_CAP = 256
    # Keys that are always compile-class, whatever the boot state or
    # history: the reboot canary and the poison-bisection probes run
    # right after _teardown_device dropped the device tables, so their
    # first launch re-uploads them; a tight warm deadline there would
    # false-wedge the recovery itself on a contended host.
    COMPILE_CLASS_PREFIXES = ("canary:", "poison-probe:")
    # Cadence-ring tick launches only ever run built shapes, so an
    # unobserved ``tick:`` key gets the warm grace whatever the boot
    # state: the compile budget would let a wedged tick stall the ring
    # for minutes.
    TICK_CLASS_PREFIX = "tick:"

    def __init__(self, warm_boot: bool = False,
                 compile_budget_s: float | None = None,
                 warm_grace_s: float | None = None,
                 p99_multiple: float | None = None,
                 min_deadline_s: float | None = None):
        self.warm_boot = bool(warm_boot)
        self.compile_budget_s = compile_budget_s if compile_budget_s \
            is not None else _env_float(
                "HOTSTUFF_TPU_GUARD_COMPILE_BUDGET_S", 180.0)
        self.warm_grace_s = warm_grace_s if warm_grace_s is not None \
            else _env_float("HOTSTUFF_TPU_GUARD_WARM_GRACE_S", 30.0)
        self.p99_multiple = p99_multiple if p99_multiple is not None \
            else _env_float("HOTSTUFF_TPU_GUARD_P99_MULTIPLE", 8.0)
        self.min_deadline_s = min_deadline_s if min_deadline_s is not None \
            else _env_float("HOTSTUFF_TPU_GUARD_MIN_DEADLINE_S", 1.0)
        self._lock = threading.Lock()
        self._samples: dict[str, list] = {}

    @classmethod
    def from_build(cls, device, **kw):
        """Deadline policy for a boot on ``device``: warm when no launch
        can wait on a kernel build, that is on the CPU (the kernels'
        plain versions) or when this process has the library of the
        current sources loaded (``warmup`` loads it before the socket
        binds); cold otherwise (a first build compiles for minutes)."""
        import torch

        from ..ops.kern import build

        warm = torch.device(device).type == "cpu" or build.loaded()
        return cls(warm_boot=warm, **kw)

    def observe(self, key: str, dur_s: float):
        with self._lock:
            samples = self._samples.setdefault(key, [])
            samples.append(float(dur_s))
            del samples[:-self.SAMPLES_CAP]

    def deadline_s(self, key: str) -> float:
        if key.startswith(self.COMPILE_CLASS_PREFIXES):
            return self.compile_budget_s
        with self._lock:
            samples = self._samples.get(key, ())
            if len(samples) >= self.MIN_OBSERVATIONS:
                p99 = _percentile(sorted(samples), 0.99)
                return max(self.min_deadline_s, self.p99_multiple * p99)
        if key.startswith(self.TICK_CLASS_PREFIX):
            return self.warm_grace_s
        return self.warm_grace_s if self.warm_boot \
            else self.compile_budget_s

    def snapshot(self) -> dict:
        """JSON-safe per-key summary (bounded by SAMPLES_CAP keys in
        practice: keys are padded launch buckets, a handful per boot)."""
        with self._lock:
            keys = dict(self._samples)
        out = {}
        for key, samples in sorted(keys.items()):
            out[key] = {"n": len(samples),
                        "deadline_s": round(self.deadline_s(key), 3)}
        return out


class Quarantine:
    """Wedge bookkeeping per (msg, pk, sig) record.

    First wedge on a record is weather (a stalled device wedges whatever
    batch was in flight); a REPEAT wedge marks the record a bisection
    candidate (``pending``), and ``resolve`` — fed by bisect_poison
    after the reboot's canary passes — moves the confirmed poison
    records into the permanent host-verified set."""

    POISON_WEDGES = 2
    # Wedge-count records kept (FIFO: an attacker evicts, never grows).
    CAP = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._wedges: dict = {}       # record -> wedge count (bounded FIFO)
        self._pending: list = []      # repeat offenders awaiting bisection
        self._poisoned: set = set()   # confirmed poison: host-verified forever

    def note_wedged(self, records) -> int:
        """Bump wedge counts for every record of a wedged batch; records
        reaching POISON_WEDGES join the pending-bisection set.  Returns
        how many records are now pending."""
        with self._lock:
            for rec in records:
                if rec in self._poisoned:
                    continue
                count = self._wedges.get(rec, 0) + 1
                if rec not in self._wedges:
                    while len(self._wedges) >= self.CAP:
                        self._wedges.pop(next(iter(self._wedges)))
                self._wedges[rec] = count
                if count >= self.POISON_WEDGES and \
                        rec not in self._pending:
                    self._pending.append(rec)
            return len(self._pending)

    def pending(self) -> list:
        with self._lock:
            return list(self._pending)

    def resolve(self, poison_records) -> int:
        """Close one bisection round: ``poison_records`` move to the
        permanent poisoned set, everything else pending is released
        (its wedge count survives, so a third wedge re-marks it).
        Returns how many records were newly poisoned."""
        with self._lock:
            before = len(self._poisoned)
            for rec in poison_records:
                self._poisoned.add(rec)
                self._wedges.pop(rec, None)
            self._pending = []
            return len(self._poisoned) - before

    def is_poisoned(self, record) -> bool:
        return record in self._poisoned

    def has_poison(self) -> bool:
        return bool(self._poisoned)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "suspect_records": len(self._wedges),
                "pending_bisection": len(self._pending),
                "poisoned_records": len(self._poisoned),
            }


def bisect_poison(records, probe, max_probes: int = 64) -> list:
    """Isolate the poison records of a wedging batch by bisection — the
    RLC bisection discipline applied to wedges instead of invalid
    masks.  ``probe(subset) -> bool`` launches the subset under the
    guard's deadline and says whether it COMPLETED (True) or wedged
    (False).  Returns the poison records.

    Rules: a completing subset is clean; a wedging singleton is poison;
    a wedging set whose both halves complete is an interaction the
    bisection cannot split — the whole set is returned (quarantined),
    never silently released.  ``max_probes`` bounds the device time one
    recovery spends probing: leftovers past the budget stay quarantined
    (host-verified), which is safe, just conservative."""
    budget = [int(max_probes)]

    def rec(rs):
        if not rs:
            return []
        if budget[0] <= 0:
            return list(rs)  # unprobed leftovers stay quarantined
        budget[0] -= 1
        if probe(list(rs)):
            return []
        if len(rs) == 1:
            return list(rs)
        mid = len(rs) // 2
        left = rec(rs[:mid])
        right = rec(rs[mid:])
        if not left and not right:
            return list(rs)  # both halves clean alone: interaction set
        return left + right

    return rec(list(records))


class GuardStats:
    """Counters behind the OP_STATS ``guard`` section."""

    def __init__(self):
        self._lock = threading.Lock()
        self.wedges = 0
        self.wedges_by_key: dict[str, int] = {}
        self.late_completions = 0
        self.reboots = 0
        self.canary_passes = 0
        self.canary_failures = 0
        self.host_fallback_records = 0
        self.busy_replies = 0
        self.poison_host_verified = 0
        self.last_reboot_wall_s = 0.0
        self.last_rewarm_wall_s = 0.0

    def note_wedge(self, key: str):
        with self._lock:
            self.wedges += 1
            self.wedges_by_key[key] = self.wedges_by_key.get(key, 0) + 1

    def note_late_completion(self, key: str):
        with self._lock:
            self.late_completions += 1

    def note_reboot(self, wall_s: float):
        with self._lock:
            self.reboots += 1
            self.last_reboot_wall_s = float(wall_s)

    def note_rewarm(self, wall_s: float):
        with self._lock:
            self.last_rewarm_wall_s = float(wall_s)

    def note_canary(self, ok: bool):
        with self._lock:
            if ok:
                self.canary_passes += 1
            else:
                self.canary_failures += 1

    def note_host_fallback(self, n: int):
        with self._lock:
            self.host_fallback_records += int(n)

    def note_busy(self):
        with self._lock:
            self.busy_replies += 1

    def note_poison_host(self, n: int):
        with self._lock:
            self.poison_host_verified += int(n)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "wedges": self.wedges,
                "wedges_by_key": dict(self.wedges_by_key),
                "late_completions": self.late_completions,
                "reboots": self.reboots,
                "canary_passes": self.canary_passes,
                "canary_failures": self.canary_failures,
                "host_fallback_records": self.host_fallback_records,
                "busy_replies": self.busy_replies,
                "poison_host_verified": self.poison_host_verified,
                "last_reboot_wall_s": round(self.last_reboot_wall_s, 3),
                "last_rewarm_wall_s": round(self.last_rewarm_wall_s, 3),
            }


class _GuardedCall:
    __slots__ = ("key", "deadline_s", "started_at", "done", "result",
                 "exc", "wedged", "thread_id", "stack")

    def __init__(self, key: str, deadline_s: float, started_at: float):
        self.key = key
        self.deadline_s = deadline_s
        self.started_at = started_at
        self.done = threading.Event()
        self.result = None
        self.exc = None
        self.wedged = False
        self.thread_id = None
        self.stack = ""


class LaunchGuard:
    """The launch supervisor: every staged device call runs on a
    DISPOSABLE daemon thread while the caller waits; a monitor thread
    declares a deadline overrun WEDGED, wakes the caller (which raises
    :class:`WedgedLaunch` and executes the engine's degradation
    ladder), and the hung thread is abandoned: crash-only, never
    interrupted or reused.  A thread per launch means one wedge can
    never poison a shared worker queue."""

    POLL_S = 0.02
    _ids = itertools.count()

    def __init__(self, deadlines: LaunchDeadlines | None = None,
                 stats: GuardStats | None = None, clock=monotonic,
                 max_reboots: int | None = None,
                 max_bisect_probes: int | None = None):
        self.deadlines = deadlines if deadlines is not None \
            else LaunchDeadlines()
        self.stats = stats if stats is not None else GuardStats()
        self.quarantine = Quarantine()
        self.max_reboots = int(max_reboots) if max_reboots is not None \
            else int(_env_float("HOTSTUFF_TPU_GUARD_MAX_REBOOTS", 3))
        self.max_bisect_probes = int(max_bisect_probes) \
            if max_bisect_probes is not None else int(_env_float(
                "HOTSTUFF_TPU_GUARD_MAX_BISECT_PROBES", 64))
        self._clock = clock
        self._lock = threading.Lock()
        self._calls: set = set()
        self._stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="guard-monitor")
        self._monitor.start()

    def close(self):
        self._stop.set()

    # -- supervision ---------------------------------------------------------

    def _monitor_loop(self):
        """Declares overruns: any in-flight guarded call past its
        deadline is marked wedged and its waiter woken NOW — the waiter
        abandons the launch thread and runs the ladder."""
        while not self._stop.wait(self.POLL_S):
            now = self._clock()
            with self._lock:
                live = list(self._calls)
            for call in live:
                if call.done.is_set():
                    continue
                if now - call.started_at > call.deadline_s:
                    # Where the launch thread stands at the overrun: a
                    # scripted wedge parks in an Event wait, a real stall
                    # in whatever device or host call it waits on.
                    frame = sys._current_frames().get(call.thread_id)
                    if frame is not None:
                        call.stack = "".join(traceback.format_stack(frame))
                    call.wedged = True
                    call.done.set()

    def _run_call(self, call: _GuardedCall, thunk):
        try:
            call.result = thunk()
        except BaseException as e:  # noqa: BLE001 — re-raised by call()
            call.exc = e
        if call.wedged:
            # Late completion of an abandoned launch: the engine already
            # answered its batch from the ladder — the result is
            # DISCARDED here and must have no reachable side effects
            # (dispatch/fetch thunks return data; replies happen on the
            # engine thread, and the verdict cache takes its own lock).
            self.stats.note_late_completion(call.key)
            return
        call.done.set()

    def call(self, key: str, thunk):
        """Run ``thunk`` on a disposable launch thread under the shape's
        deadline; returns its result, re-raises its exception, or
        raises :class:`WedgedLaunch` when the monitor declared an
        overrun (the thread is abandoned — crash-only)."""
        call = _GuardedCall(key, self.deadlines.deadline_s(key),
                            self._clock())
        with self._lock:
            self._calls.add(call)
        # One-shot disposable body, not a service loop: it runs exactly
        # one thunk and exits — a stop flag could not interrupt a hung
        # device call anyway, and ABANDONING the thread on a wedge is
        # the crash-only design (daemon: it dies with the process).
        # graftlint: disable=daemon-thread-without-stop-flag
        t = threading.Thread(target=self._run_call, args=(call, thunk),
                             daemon=True,
                             name=f"guard-launch-{next(self._ids)}")
        t.start()
        call.thread_id = t.ident
        # The monitor guarantees a wake-up at the deadline, so this wait
        # is bounded by construction (evidence: _monitor_loop sets
        # call.done on every overrun; the monitor thread is started in
        # __init__ and only close() stops it).
        # graftlint: disable=unsupervised-launch
        call.done.wait()
        with self._lock:
            self._calls.discard(call)
        if call.wedged:
            self.stats.note_wedge(key)
            log.error("guard: launch %s overran its %gs deadline; its "
                      "thread at the overrun:\n%s", key, call.deadline_s,
                      call.stack.rstrip() or "(not yet running)")
            raise WedgedLaunch(key, call.deadline_s)
        self.deadlines.observe(key, self._clock() - call.started_at)
        if call.exc is not None:
            raise call.exc
        return call.result

    # -- reporting -----------------------------------------------------------

    def snapshot(self) -> dict:
        out = self.stats.snapshot()
        out.update(self.quarantine.snapshot())
        out["deadlines"] = self.deadlines.snapshot()
        out["warm_boot"] = self.deadlines.warm_boot
        return out
