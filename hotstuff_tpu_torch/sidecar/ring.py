"""The cadence ring: the port of hotstuff_tpu/sidecar/ring.py, a
continuous-batching verify loop on the engine thread.

The staged engine (service.VerifyEngine._run_staged) is request-driven:
coalesce, pack, launch, fetch, with at most ``PIPELINE_DEPTH`` = 2
launches in flight.  The ring instead ticks at a load-adaptive cadence
and keeps up to k launches in flight, so each tick re-dispatches one of
the shapes the warm-up ran instead of waiting on a request:

  * :class:`CadenceRing` is a ring of slots (the staged pipeline's depth
    2 generalised to a trained k).  Each tick it collects the oldest
    in-flight verdict when it must (ring full, or nothing new), then
    arms one free slot with the scheduler's per-tick quota
    (``Scheduler.next_tick``, pad-filled from the bulk backlog like the
    staged coalesce).  Launches go through the engine's own ``_pack``
    (the same routes, dedup and verdict cache as the staged loop, so the
    masks are the same); on a mesh a per-signature slot is armed at the
    ring's fixed shard-aligned row count
    (``parallel.sharded_verify.ring_slot_pack``).

  * Generation tags: every slot carries a counter bumped on each arm and
    each invalidation (expiry, wedge fallback).  A flight's verdict is
    applied only if its generation still matches its slot's; anything
    else is counted as a generation drop and discarded, so a stale fetch
    never answers a re-armed slot.  Each arm's tensors are allocated
    fresh by the pack, so a late fetch of a dropped generation reads its
    own buffers, never a re-armed slot's.

  * :class:`RingDepth` trains k in {2, 4, 8} from measured dispatch
    overhead against device walls.  The JAX package seeds it from its
    compile manifest; the port has none, so ``serve()`` seeds it with
    the walls of warm calls that ``service.warmup`` measures.

  * :class:`CadenceStats` is the OP_STATS ``cadence`` section: tick
    rate, occupancy histogram, pad-fill ratio, generation drops and
    queue-wait p50/p99, with the JAX package's keys.

Supervision: every dispatch and fetch is a guarded launch under the
``tick:`` deadline class (guard.LaunchDeadlines.TICK_CLASS_PREFIX: the
ring only launches shapes the warm-up ran, so an unobserved tick key
gets the warm grace).  The tick body waits on nothing outside a guarded
thunk: the pack's future and the fetch's copy to the host both run
inside it.  A WedgedLaunch takes the engine's degradation ladder for the
wedged batch, re-resolves every other flight on the host, and ``run()``
returns with ``enabled`` false: ``VerifyEngine._run`` then runs the
staged loop.  The staged loop stays the default; the ring runs behind
``--cadence`` / ``HOTSTUFF_TPU_CADENCE``.

One departure from the JAX package, the engine's own: a launch that
raises is answered OP_BUSY (``engine._fail_batch``), never a verdict
nobody computed.
"""

from __future__ import annotations

import logging
import os
import threading
from collections import deque
from time import monotonic

from . import sched as vsched
from .guard import BusyReply, WedgedLaunch

log = logging.getLogger("sidecar.ring")

ENV_CADENCE = "HOTSTUFF_TPU_CADENCE"          # "1"/"true"/"on" => ring
ENV_DEPTH = "HOTSTUFF_TPU_CADENCE_DEPTH"      # pin k (else trained)
ENV_TICK_S = "HOTSTUFF_TPU_CADENCE_TICK_S"    # pin tick interval


def cadence_enabled(default: bool = False) -> bool:
    """True iff the environment opts the sidecar into the cadence ring."""
    raw = os.environ.get(ENV_CADENCE)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "on", "yes")


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * (len(sorted_vals) - 1))))
    return float(sorted_vals[idx])


class RingDepth:
    """Trains the ring depth k in {2, 4, 8} from measured host dispatch
    overhead against device walls.

    With overhead o and device wall w, the device stays busy iff k - 1
    launches execute while the host stages the next, so k is about
    1 + o/w, rounded up to a supported depth.  Until MIN_OBSERVATIONS of
    each exist the trainer answers the conservative minimum (2)."""

    DEPTHS = (2, 4, 8)
    MIN_OBSERVATIONS = 8
    SAMPLES_CAP = 256

    def __init__(self, pinned: int | None = None):
        if pinned is None:
            raw = os.environ.get(ENV_DEPTH)
            if raw:
                try:
                    pinned = int(raw)
                except ValueError:
                    pinned = None
        self.pinned = self._clamp(pinned) if pinned else None
        self._lock = threading.Lock()
        self._dispatch: deque = deque(maxlen=self.SAMPLES_CAP)
        self._walls: deque = deque(maxlen=self.SAMPLES_CAP)

    @classmethod
    def _clamp(cls, k: int) -> int:
        for d in cls.DEPTHS:
            if k <= d:
                return d
        return cls.DEPTHS[-1]

    def seed(self, walls: dict) -> None:
        """Add device-wall evidence: ``{shape: wall_s}`` (non-positive or
        non-numeric walls are ignored; an empty dict keeps the
        conservative start)."""
        with self._lock:
            for w in walls.values():
                if isinstance(w, (int, float)) and w > 0:
                    self._walls.append(float(w))

    def observe(self, dispatch_s: float, wall_s: float) -> None:
        """One completed flight: host-side dispatch overhead (guarded
        pack wait + dispatch call) and the device wall it overlapped."""
        with self._lock:
            if dispatch_s > 0:
                self._dispatch.append(float(dispatch_s))
            if wall_s > 0:
                self._walls.append(float(wall_s))

    def depth(self) -> int:
        if self.pinned:
            return self.pinned
        with self._lock:
            if len(self._dispatch) < self.MIN_OBSERVATIONS or \
                    len(self._walls) < self.MIN_OBSERVATIONS:
                return self.DEPTHS[0]
            o = _percentile(sorted(self._dispatch), 0.5)
            w = _percentile(sorted(self._walls), 0.5)
        if w <= 0:
            return self.DEPTHS[0]
        return self._clamp(1 + int(o / w + 0.999))

    def snapshot(self) -> dict:
        k = self.depth()  # takes the lock itself
        with self._lock:
            return {
                "k": k,
                "pinned": bool(self.pinned),
                "dispatch_samples": len(self._dispatch),
                "wall_samples": len(self._walls),
            }


class CadenceStats:
    """The OP_STATS ``cadence`` section.  Counters are written by the
    ring (engine thread) and read by connection threads, so every touch
    takes the lock.  Queue waits (admission to cadence dispatch) keep a
    bounded reservoir."""

    WAIT_SAMPLES_CAP = 4096

    def __init__(self, clock=monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self.ticks = 0
        self.dispatch_ticks = 0
        self.idle_ticks = 0
        self.occupancy_hist: dict = {}
        self.launched_sigs = 0
        self.pad_fill_sigs = 0
        self.generation_drops = 0
        self.expiries = 0
        self.expired_sigs = 0
        self.fallbacks = 0
        self._waits: deque = deque(maxlen=self.WAIT_SAMPLES_CAP)
        self._first_tick_t: float | None = None
        self._last_tick_t: float | None = None

    def note_tick(self, occupied: int, armed: bool) -> None:
        with self._lock:
            now = self._clock()
            if self._first_tick_t is None:
                self._first_tick_t = now
            self._last_tick_t = now
            self.ticks += 1
            if armed:
                self.dispatch_ticks += 1
            else:
                self.idle_ticks += 1
            self.occupancy_hist[occupied] = \
                self.occupancy_hist.get(occupied, 0) + 1

    def note_dispatch(self, total_sigs: int, fill_sigs: int,
                      waits) -> None:
        with self._lock:
            self.launched_sigs += total_sigs
            self.pad_fill_sigs += fill_sigs
            self._waits.extend(waits)

    def note_generation_drop(self) -> None:
        with self._lock:
            self.generation_drops += 1

    def note_expiry(self, sigs: int) -> None:
        with self._lock:
            self.expiries += 1
            self.expired_sigs += sigs

    def note_fallback(self) -> None:
        with self._lock:
            self.fallbacks += 1

    def snapshot(self, *, enabled: bool, depth: int) -> dict:
        with self._lock:
            span = 0.0
            if self._first_tick_t is not None and self.ticks > 1:
                span = self._last_tick_t - self._first_tick_t
            waits = sorted(self._waits)
            return {
                "enabled": enabled,
                "depth": depth,
                "ticks": self.ticks,
                "dispatch_ticks": self.dispatch_ticks,
                "idle_ticks": self.idle_ticks,
                "tick_rate_hz": round((self.ticks - 1) / span, 3)
                if span > 0 else 0.0,
                "occupancy_hist": {str(k): v for k, v
                                   in sorted(self.occupancy_hist.items())},
                "pad_fill": {
                    "sigs": self.pad_fill_sigs,
                    "launched_sigs": self.launched_sigs,
                    "ratio": round(self.pad_fill_sigs / self.launched_sigs,
                                   4) if self.launched_sigs else 0.0,
                },
                "generation": {
                    "drops": self.generation_drops,
                    "expiries": self.expiries,
                    "expired_sigs": self.expired_sigs,
                },
                "fallbacks": self.fallbacks,
                "queue_wait": {
                    "n": len(waits),
                    "p50_ms": round(_percentile(waits, 0.5) * 1e3, 3),
                    "p99_ms": round(_percentile(waits, 0.99) * 1e3, 3),
                },
            }


class RingSlot:
    """One position of the ring.  ``generation`` is bumped on every arm
    and every invalidation; a flight's verdict applies only on an exact
    match (slot reuse, the ring cycling back to index 0, is the case the
    tag exists for)."""

    __slots__ = ("index", "generation")

    def __init__(self, index: int):
        self.index = index
        self.generation = 0


class _Flight:
    """An armed launch: the slot and generation it was armed under, the
    batch, and the fetch closure (run under the guard)."""

    __slots__ = ("slot", "generation", "batch", "fetch", "key",
                 "dispatched_at", "dispatch_s", "sigs")

    def __init__(self, slot, generation, batch, fetch, key,
                 dispatched_at, dispatch_s, sigs):
        self.slot = slot
        self.generation = generation
        self.batch = batch
        self.fetch = fetch
        self.key = key
        self.dispatched_at = dispatched_at
        self.dispatch_s = dispatch_s
        self.sigs = sigs


class CadenceRing:
    """The cadence loop.  It runs on the engine thread
    (``VerifyEngine._run`` calls :meth:`run` before the staged loop), so
    the engine's invariants (one consumer, one reply per request, the
    pack worker's order) carry over.

    Tick body (:meth:`_tick_once`):

      1. expire: a flight uncollected past its window is re-resolved on
         the host and its generation invalidated, so its late device
         verdict is discarded;
      2. collect: when the ring is full (or nothing new arrived), the
         oldest flight's verdict is fetched under the guard and applied
         iff its generation still matches;
      3. arm: a free slot takes the scheduler's per-tick quota through
         the engine's pack worker, dispatched under the ``tick:`` class.

    Pacing is load-adaptive between MIN_TICK_S and MAX_TICK_S: armed or
    backlogged ticks run at MIN_TICK_S, idle ticks back off
    exponentially, and a fully idle ring parks inside
    ``Scheduler.next_tick``'s bounded wait, so a new request wakes it at
    once."""

    MIN_TICK_S = 0.002
    MAX_TICK_S = 0.25
    # A flight uncollected this many multiples of its guard deadline is
    # expired (host re-resolve + generation bump).  The guard bounds the
    # fetch; expiry bounds the verdict of a flight the loop never got
    # back to.
    EXPIRY_DEADLINES = 2.0
    DEFAULT_EXPIRY_S = 30.0

    def __init__(self, engine, *, depth: RingDepth | None = None,
                 tick_s: float | None = None,
                 expiry_s: float | None = None,
                 clock=monotonic, wait=None):
        self.engine = engine
        self.depth = depth if depth is not None else RingDepth()
        if tick_s is None:
            raw = os.environ.get(ENV_TICK_S)
            if raw:
                try:
                    tick_s = float(raw)
                except ValueError:
                    tick_s = None
        self.pinned_tick_s = tick_s
        self.expiry_s = expiry_s
        self.stats = CadenceStats(clock=clock)
        self.enabled = True
        self._clock = clock
        self._wait = wait if wait is not None else engine._stopped.wait
        self._slots = [RingSlot(i) for i in range(max(RingDepth.DEPTHS))]
        self._next_slot = 0
        self._pending: deque = deque()  # _Flight, oldest first
        self._idle_streak = 0

    # -- public --------------------------------------------------------------

    def snapshot(self) -> dict:
        out = self.stats.snapshot(enabled=self.enabled,
                                  depth=self.depth.depth())
        out["depth_trainer"] = self.depth.snapshot()
        return out

    def run(self) -> None:
        """The cadence loop; returns on engine stop (after collecting
        every in-flight verdict) or on wedge fallback (``enabled`` false,
        every generation answered: the staged loop takes over with no
        reply outstanding)."""
        engine = self.engine
        log.info("cadence: ring engaged (depth %d)", self.depth.depth())
        while self.enabled and not engine._stopped.is_set():
            t0 = self._clock()
            armed = self._tick_once(t0)
            occupied = len(self._pending)
            self.stats.note_tick(occupied, armed)
            self._note_occupancy(occupied)
            if not self.enabled or engine._stopped.is_set():
                break
            interval = self._interval(armed, occupied)
            elapsed = self._clock() - t0
            if occupied == 0 and not armed:
                # Fully idle: park in the scheduler's bounded wait so a
                # new offer wakes the ring at once.
                launch = engine._sched.next_tick(self._quota_sigs(),
                                                 timeout=interval)
                if launch is not None and self._take_launch(launch):
                    # The park-path arm is a dispatch tick too.
                    self.stats.note_tick(len(self._pending), True)
                    self._note_occupancy(len(self._pending))
            elif interval > elapsed:
                self._wait(interval - elapsed)
        if self.enabled:
            # Clean stop: every accepted request still gets its reply.
            while self._pending:
                self._collect_oldest()
        log.info("cadence: ring disengaged (%s)",
                 "stopped" if self.enabled else "wedge fallback")

    # -- tick body -----------------------------------------------------------

    def _tick_once(self, now: float) -> bool:
        """One cadence tick; True iff a slot was armed."""
        self._expire_overdue(now)
        if not self.enabled:
            return False
        k = self.depth.depth()
        if len(self._pending) >= k:
            self._collect_oldest()
        if not self.enabled:
            return False
        armed = False
        if len(self._pending) < k:
            launch = self.engine._sched.next_tick(self._quota_sigs())
            if launch is not None:
                armed = self._take_launch(launch)
        if not armed and self._pending:
            # Nothing new arrived: collect the oldest verdict, so light
            # load sees one tick of reply latency, not k.
            self._collect_oldest()
        return armed

    def _quota_sigs(self) -> int:
        return self.engine._shapes.launch_cap

    def _take_launch(self, launch) -> bool:
        """Route one per-tick quota: a BLS request runs inline after a
        full drain (one pairing check, nothing to keep in flight); an
        Ed25519 quota arms a ring slot."""
        engine = self.engine
        engine._trace_queue_waits(launch)
        if launch.kind == "bls":
            while self._pending:
                self._collect_oldest()
                if not self.enabled:
                    return False
            (item,) = launch.items
            engine._run_bls(item)
            return True
        return self._arm(launch)

    def _arm(self, launch) -> bool:
        """Arm the next slot with this launch: the batch goes through the
        engine's pack worker, the pack wait and the dispatch run under
        one ``tick:`` deadline, and the flight takes the slot's new
        generation."""
        engine = self.engine
        batch = launch.items
        key = self._tick_key(batch)
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % max(RingDepth.DEPTHS)
        slot.generation += 1
        gen = slot.generation
        fut = engine._pack_pool.submit(engine._pack, batch)
        t0 = self._clock()
        try:
            fetch = engine._guarded(key, lambda: fut.result()())
        except WedgedLaunch:
            slot.generation += 1  # invalidate before the ladder answers
            self._fallback(batch, key, stage="dispatch")
            return False
        except Exception:
            slot.generation += 1
            engine._fail_batch(batch, "cadence pack/dispatch")
            return False
        dispatch_s = self._clock() - t0
        sigs = sum(len(p.request.msgs) for p in batch)
        self._pending.append(_Flight(slot, gen, batch, fetch, key,
                                     self._clock(), dispatch_s, sigs))
        fill = batch[len(batch) - launch.fill_count:]
        now = self._clock()
        self.stats.note_dispatch(
            sigs, sum(len(p.request.msgs) for p in fill),
            [now - p.enqueued_at for p in batch])
        if engine._tracer.enabled:
            engine._tracer.event("dispatch", reqs=len(batch),
                                 cadence=True)
        return True

    def _collect_oldest(self) -> None:
        """Fetch the oldest flight's verdict under the guard and apply it
        iff its generation still matches (stale: a counted drop and no
        reply, since whoever bumped the generation already answered)."""
        engine = self.engine
        fl = self._pending.popleft()
        try:
            mask = engine._guarded(fl.key, fl.fetch)
        except WedgedLaunch:
            if fl.generation == fl.slot.generation:
                fl.slot.generation += 1
                self._fallback(fl.batch, fl.key, stage="fetch")
            else:
                self.stats.note_generation_drop()
            return
        except Exception:
            if fl.generation != fl.slot.generation:
                self.stats.note_generation_drop()
                return
            fl.slot.generation += 1
            engine._fail_batch(fl.batch, "cadence launch")
            return
        if fl.generation != fl.slot.generation:
            # Re-armed or expired since dispatch: stale by tag, whatever
            # the device computed.
            self.stats.note_generation_drop()
            return
        wall = self._clock() - fl.dispatched_at
        self.depth.observe(fl.dispatch_s, wall)
        if engine._tracer.enabled:
            engine._tracer.event("device", dur_ms=wall * 1e3,
                                 reqs=len(fl.batch), sigs=fl.sigs,
                                 cadence=True)
        off = 0
        for p in fl.batch:
            n = len(p.request.msgs)
            p.reply_fn([bool(b) for b in mask[off:off + n]])
            off += n
        engine._trace_replies(fl.batch)

    # -- expiry / fallback ---------------------------------------------------

    def _flight_expiry_s(self, fl) -> float:
        if self.expiry_s is not None:
            return self.expiry_s
        guard = self.engine._guard
        if guard is not None:
            return self.EXPIRY_DEADLINES * guard.deadlines.deadline_s(fl.key)
        return self.DEFAULT_EXPIRY_S

    def _expire_overdue(self, now: float) -> None:
        """Re-resolve on the host every flight uncollected past its
        window and invalidate its generation: its late fetch becomes a
        counted drop, never a second reply."""
        for fl in list(self._pending):
            if fl.generation != fl.slot.generation:
                continue  # already invalidated; drops at collect
            if now - fl.dispatched_at <= self._flight_expiry_s(fl):
                continue
            fl.slot.generation += 1
            self.stats.note_expiry(fl.sigs)
            log.warning("cadence: flight %s expired uncollected; "
                        "re-resolving on host", fl.key)
            self._host_resolve(fl.batch)

    def _host_resolve(self, batch) -> None:
        """Answer a batch without the device: latency requests get the
        host reference's masks (equal to the device's), bulk requests
        OP_BUSY with the retry-after."""
        from ..crypto import ref_ed25519 as ref

        engine = self.engine
        for p in batch:
            if p.cls == vsched.BULK:
                p.reply_fn(BusyReply(engine.retry_after_ms(vsched.BULK)))
                continue
            p.reply_fn([bool(ref.verify(pk, m, s))
                        for m, pk, s in zip(p.request.msgs, p.request.pks,
                                            p.request.sigs)])
        engine._trace_replies(batch)

    def _fallback(self, batch, key: str, stage: str) -> None:
        """A cadence launch wedged: the engine's ladder answers the
        wedged batch (host masks / OP_BUSY, quarantine, crash-only
        reboot), every other live flight is re-resolved on the host, and
        the ring disengages: VerifyEngine._run runs the staged loop."""
        self.stats.note_fallback()
        self.enabled = False
        self.engine._wedge_ladder(batch, key, stage=stage)
        for fl in list(self._pending):
            if fl.generation == fl.slot.generation:
                fl.slot.generation += 1
                self._host_resolve(fl.batch)
        # Every reply is out exactly once; the flights' device results
        # are dropped with them.
        self._pending.clear()

    # -- pacing --------------------------------------------------------------

    def _interval(self, armed: bool, occupied: int) -> float:
        if self.pinned_tick_s is not None:
            return self.pinned_tick_s
        sched = self.engine._sched
        backlog = sched.queued_sigs(vsched.LATENCY) + \
            sched.queued_sigs(vsched.BULK)
        if armed or occupied or backlog:
            self._idle_streak = 0
            return self.MIN_TICK_S
        self._idle_streak += 1
        return min(self.MAX_TICK_S,
                   self.MIN_TICK_S * (2 ** min(self._idle_streak, 10)))

    # -- helpers -------------------------------------------------------------

    def _tick_key(self, batch) -> str:
        """A tick's guard deadline key: the staged key's deduped
        power-of-two bucket under the ``tick:`` prefix, so an unobserved
        key gets the warm grace (the ring launches only warmed shapes)."""
        staged = self.engine._guard_key(batch)
        return "tick:" + staged.split(":", 1)[1]

    def _note_occupancy(self, occupied: int) -> None:
        adm = getattr(self.engine._sched, "admission", None)
        if adm is not None:
            adm.note_ring_occupancy(occupied, self.depth.depth())
