"""Plan execution: fire each event at its offset, record what happened.

The runner owns a daemon thread so the harness's duration sleep is the
only clock the bench itself keeps; injector failures are *recorded*
(``ok: false`` + error text), never raised — a fault plan that trips
over its own injection must still let the bench finish, tear down, and
surface the failure through the parsed summary (the LogParser treats a
failed injection as a hard error there).

The clock/sleep/wall callables are injectable: tests and bench.py's
headline probe drive a plan through a virtual clock in microseconds;
the harness uses the real ones.
"""

from __future__ import annotations

import threading
from time import monotonic, sleep as _real_sleep, time as _wall_clock

from .plan import FaultPlan

# Sleep in short slices so stop() is observed promptly even mid-wait.
_MAX_SLICE_S = 0.2


class PlanRunner:
    def __init__(self, plan: FaultPlan, injector, clock=monotonic,
                 sleep=_real_sleep, wall=_wall_clock):
        self._plan = plan
        self._injector = injector
        self._clock = clock
        self._sleep = sleep
        self._wall = wall
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._executed: list[dict] = []
        self._lock = threading.Lock()

    def start(self, t0: float | None = None):
        """Begin executing; event times are offsets from ``t0`` (default:
        now)."""
        assert self._thread is None, "runner already started"
        base = self._clock() if t0 is None else t0
        self._thread = threading.Thread(
            target=self._run, args=(base,), daemon=True, name="chaos-runner")
        self._thread.start()

    def stop(self):
        """Skip any not-yet-due events (run window over)."""
        self._stop.set()

    def join(self, timeout: float | None = None):
        if self._thread is not None:
            self._thread.join(timeout)

    def events(self) -> list:
        """Executed events (JSON-safe dicts): the plan fields plus the
        wall-clock ``wall`` stamp recovery latency is measured from, and
        ``ok``/``error`` for the injection itself.  Skipped events (a
        stop() before their time) are absent."""
        with self._lock:
            return [dict(e) for e in self._executed]

    def all_ok(self) -> bool:
        with self._lock:
            return all(e["ok"] for e in self._executed)

    # -- internals ----------------------------------------------------------

    def _run(self, base: float):
        for event in self._plan.events:
            due = base + event.t
            while not self._stop.is_set():
                left = due - self._clock()
                if left <= 0:
                    break
                self._sleep(min(left, _MAX_SLICE_S))
            if self._stop.is_set():
                return
            record = event.to_json()
            # The wall stamp is taken BEFORE the injection so recovery
            # latency includes the injection's own cost (a sidecar
            # restart's boot time is part of what the fault costs).
            record["wall"] = self._wall()
            try:
                self._injector.apply(event)
                record["ok"] = True
            except Exception as e:  # noqa: BLE001 — recorded, never raised
                record["ok"] = False
                record["error"] = f"{e!r:.200}"
            with self._lock:
                self._executed.append(record)
