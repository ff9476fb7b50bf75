"""The port's cadence ring (hotstuff_tpu_torch/sidecar/ring.py, the
engine's ``cadence`` hooks, ``parallel/sharded_verify.ring_slot_pack``)
against the JAX package's (hotstuff_tpu/sidecar/ring.py) on the CPU, on
the same seeded inputs: mirrors tests/test_ring.py case for case.

* the env opt-in, ``RingDepth`` (clamp, conservative start, training,
  pin, the seed from warm-up walls), ``CadenceStats`` and the ``tick:``
  deadline class give the same results through both packages;
* ``Scheduler.next_tick`` caps, pad-fills, idles and parks the same;
* the generation-tag lifecycle on a virtual clock: the same sequence
  through the reference's ring and the port's, each on a ``FakeEngine``
  of its own package, leaves the same trace (replies, stats, slot
  generations, ladder calls);
* through an engine: masks equal ``ref_ed25519``'s and every launch
  supervised under ``tick:`` (``use_host`` and ``device="cpu"``); the
  wedge drill falls back to the staged loop with one reply per request;
  the OP_STATS ``cadence`` section round-trips through the reference's
  ``LogParser.note_sidecar_stats``; the ring lint reports nothing on the
  port's ring;
* the mesh ring slot on four CPU shards equals
  ``verify_batch_sharded_pack`` and ``ref_ed25519``, and the engine arms
  its ladder slices there at the ring's fixed rows;
* ``python -m hotstuff_tpu_torch.sidecar --host-crypto --cadence``
  serves with the ring engaged.

Expectations come from ``ref_ed25519``; CPU launches get a 10 s grace
and no assertion rests on a tight wall clock.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from hotstuff_tpu.crypto import ref_ed25519 as jref
from hotstuff_tpu.obs.spans import Tracer as JTracer
from hotstuff_tpu.sidecar import guard as jguard
from hotstuff_tpu.sidecar import protocol as jproto
from hotstuff_tpu.sidecar import ring as jring
from hotstuff_tpu.sidecar import sched as jsched
from hotstuff_tpu_torch.crypto import eddsa as peddsa
from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
from hotstuff_tpu_torch.obs.spans import Tracer as PTracer
from hotstuff_tpu_torch.parallel import sharded_verify as pshv
from hotstuff_tpu_torch.parallel.mesh import virtual_mesh
from hotstuff_tpu_torch.sidecar import guard as pguard
from hotstuff_tpu_torch.sidecar import protocol as proto
from hotstuff_tpu_torch.sidecar import ring as pring
from hotstuff_tpu_torch.sidecar import sched as psched
from hotstuff_tpu_torch.sidecar import service
from hotstuff_tpu_torch.sidecar.client import SidecarClient

from conftest import REPO, free_port


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The plain versions are thousands of small operators; one thread
    # each keeps parallel test workers (pytest-xdist) from
    # oversubscribing the CPU.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

PKGS = {
    "reference": dict(ring=jring, guard=jguard, sched=jsched, proto=jproto,
                      ref=jref, tracer=JTracer),
    "port": dict(ring=pring, guard=pguard, sched=psched, proto=proto,
                 ref=ref, tracer=PTracer),
}

# CPU launches (the kernels' plain versions, or host verifies on a loaded
# machine) get room: 10 s warm grace, as tests/test_torch_guard.py.
CPU = dict(warm_boot=True, compile_budget_s=120.0, warm_grace_s=10.0,
           min_deadline_s=0.05)


def _sigs(n, tamper=(), seed=7):
    rng = np.random.default_rng(seed)
    msgs, pks, sigs = [], [], []
    for i in range(n):
        sk = rng.bytes(32)
        _, pk = ref.generate_keypair(sk)
        msg = rng.bytes(32)
        sig = ref.sign(sk, msg)
        if i in tamper:
            sig = sig[:1] + bytes([sig[1] ^ 0xFF]) + sig[2:]
        msgs.append(msg)
        pks.append(pk)
        sigs.append(sig)
    return msgs, pks, sigs


def _expect(msgs, pks, sigs):
    return [bool(ref.verify(pk, m, s)) for m, pk, s in zip(msgs, pks, sigs)]


def _wait(pred, timeout=120.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _collector():
    """Keeps every reply per rid: the one-reply assertions read the
    list lengths."""
    done = {}
    cond = threading.Condition()

    def reply_to(rid):
        def _reply(mask):
            with cond:
                done.setdefault(rid, []).append(mask)
                cond.notify_all()
        return _reply

    def wait_for(*rids, timeout=120.0):
        with cond:
            return cond.wait_for(lambda: all(r in done for r in rids),
                                 timeout=timeout)
    return done, reply_to, wait_for


def _norm(reply):
    """A reply, comparable across the packages (BusyReply is each
    package's own class)."""
    if isinstance(reply, (jguard.BusyReply, pguard.BusyReply)):
        return ("busy", reply.retry_after_ms)
    return reply


# ---------------------------------------------------------------------------
# env opt-in + depth trainer
# ---------------------------------------------------------------------------

def test_cadence_env_opt_in(monkeypatch):
    monkeypatch.delenv(pring.ENV_CADENCE, raising=False)
    assert pring.ENV_CADENCE == jring.ENV_CADENCE
    for pkg in (jring, pring):
        assert not pkg.cadence_enabled()
        assert pkg.cadence_enabled(default=True)
    for raw, want in (("1", True), ("true", True), ("ON", True),
                      ("yes", True), ("0", False), ("off", False),
                      ("garbage", False)):
        monkeypatch.setenv(pring.ENV_CADENCE, raw)
        assert pring.cadence_enabled() is want is jring.cadence_enabled()


def test_ring_depth_clamps_to_supported_depths():
    for pkg in (jring, pring):
        assert [pkg.RingDepth._clamp(k) for k in (1, 3, 8, 9)] == \
            [2, 4, 8, 8]
        assert pkg.RingDepth(pinned=3).depth() == 4


def test_ring_depth_conservative_until_trained():
    for pkg in (jring, pring):
        d = pkg.RingDepth(pinned=None)
        assert d.depth() == 2
        for _ in range(pkg.RingDepth.MIN_OBSERVATIONS - 1):
            d.observe(0.01, 0.002)
        assert d.depth() == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_depth_trains_from_dispatch_vs_wall(seed):
    """The same random observations through both trainers give the same
    depth and snapshot after every one; and the reference test's fixed
    cases (o/w 5 -> 8, 3 -> 4, below one wall -> 2)."""
    rng = np.random.default_rng(seed)
    ds = {pkg: pkg.RingDepth(pinned=None) for pkg in (jring, pring)}
    for _ in range(40):
        o, w = (float(v) for v in rng.uniform(0.0005, 0.02, 2))
        for d in ds.values():
            d.observe(o, w)
        assert ds[pring].depth() == ds[jring].depth()
        assert ds[pring].snapshot() == ds[jring].snapshot()
    for o, w, k in ((0.010, 0.002, 8), (0.009, 0.003, 4),
                    (0.001, 0.010, 2)):
        d = pring.RingDepth(pinned=None)
        for _ in range(pring.RingDepth.MIN_OBSERVATIONS):
            d.observe(o, w)
        assert d.depth() == k
    json.dumps(d.snapshot())


def test_ring_depth_env_pin(monkeypatch):
    for raw, pinned in (("3", 4), ("not-a-number", None), ("9", 8)):
        monkeypatch.setenv(pring.ENV_DEPTH, raw)
        assert pring.RingDepth().pinned == pinned == jring.RingDepth().pinned


def test_ring_depth_seeds_from_warmup_walls(monkeypatch):
    """The port seeds the trainer with service.warmup's walls (the JAX
    package reads them from its compile manifest) through the
    reference's own ``seed``: same walls, same snapshot; bad walls are
    ignored and an empty seed keeps depth 2.  warmup times a repeat of
    its first call (the kernel build) and the later calls as they run."""
    walls = {"per_sig:1": 0.004, "rlc:16": 0.006, "bad": "x", "zero": 0.0}
    ds = [pkg.RingDepth(pinned=None) for pkg in (jring, pring)]
    for d in ds:
        d.seed(walls)
    assert ds[0].snapshot() == ds[1].snapshot()
    assert ds[1].snapshot()["wall_samples"] == 2
    empty = pring.RingDepth(pinned=None)
    empty.seed({})
    assert empty.depth() == 2 and empty.snapshot()["wall_samples"] == 0

    calls = []

    def fake_verify(msgs, pks, sigs):
        calls.append(("per_sig", len(msgs)))
        return np.ones((len(msgs),), bool)

    def fake_rlc(msgs, pks, sigs, device=None):
        calls.append(("rlc", len(msgs)))
        return [True] * len(msgs)

    monkeypatch.setattr(peddsa, "verify_batch_rlc", fake_rlc)
    eng = service.VerifyEngine(device="cpu")
    try:
        monkeypatch.setattr(eng, "_verify", fake_verify)
        got = service.warmup(eng)
    finally:
        eng.stop()
    assert calls == [("per_sig", 1), ("per_sig", 1), ("rlc", 16)]
    assert sorted(got) == ["per_sig:1", "rlc:16"]
    assert all(w > 0 for w in got.values())


def test_serve_seeds_the_ring_with_the_warmup_walls(monkeypatch):
    """serve(cadence=True): the engine runs the ring and its trainer
    holds the warm-up's walls; the socket never serves here."""
    walls = {"per_sig:1": 0.004, "rlc:16": 0.006}
    seen = {}

    class Engine(service.VerifyEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["engine"] = self

    monkeypatch.setattr(service, "VerifyEngine", Engine)
    monkeypatch.setattr(service, "warmup", lambda engine, warm_max: walls)
    monkeypatch.setattr(service.SidecarServer, "serve_forever",
                        lambda self, poll_interval=0.5: None)
    service.serve(port=free_port(), device="cpu", cadence=True)
    ring = seen["engine"]._ring
    assert isinstance(ring, pring.CadenceRing)
    assert ring.depth.snapshot()["wall_samples"] == 2


# ---------------------------------------------------------------------------
# scheduler per-tick quota, through both packages
# ---------------------------------------------------------------------------

def _sched(pkg, use_host=True):
    s = PKGS[pkg]["sched"]
    return s.Scheduler(shapes=s.ShapeRegistry(use_host=use_host),
                       latency_cap_sigs=4096, bulk_cap_sigs=4096)


def _offer(pkg, sched, rid, n, cls="latency", reply=None, seed=None):
    msgs, pks, sigs = _sigs(n, seed=seed if seed is not None else rid)
    p = PKGS[pkg]["proto"]
    assert sched.offer(p.VerifyRequest(rid, msgs, pks, sigs),
                       reply if reply is not None else (lambda m: None),
                       cls=cls)


def _summary(launch):
    if launch is None:
        return None
    return (launch.kind, launch.cls, launch.fill_count,
            [p.request.request_id for p in launch.items])


def test_next_tick_caps_the_coalesce_run():
    out = {}
    for pkg in PKGS:
        sched = _sched(pkg)
        for rid in range(1, 6):
            _offer(pkg, sched, rid, 4)
        launch = sched.next_tick(8)
        out[pkg] = (_summary(launch), sched.queued_sigs("latency"))
    assert out["port"] == out["reference"]
    assert out["port"][1] == 12


def test_next_tick_pad_fills_from_bulk_backlog():
    out = {}
    for pkg in PKGS:
        sched = _sched(pkg, use_host=False)
        _offer(pkg, sched, 1, 3)
        _offer(pkg, sched, 2, 1, cls="bulk")
        out[pkg] = _summary(sched.next_tick(64))
    assert out["port"] == out["reference"]
    assert out["port"][2] >= 1 and out["port"][1] == "latency"


def test_next_tick_idle_semantics():
    for pkg in PKGS:
        sched = _sched(pkg)
        assert sched.next_tick(64) is None
        t0 = time.monotonic()
        assert sched.next_tick(64, timeout=0.05) is None
        assert time.monotonic() - t0 < 5.0


def test_next_tick_timeout_park_wakes_on_offer():
    for pkg in PKGS:
        sched = _sched(pkg)
        got = []
        t = threading.Thread(
            target=lambda: got.append(sched.next_tick(64, timeout=10.0)),
            daemon=True)
        t.start()
        time.sleep(0.05)
        _offer(pkg, sched, 1, 4)
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert got and got[0] is not None and got[0].total_sigs == 4


# ---------------------------------------------------------------------------
# the ``tick:`` guard deadline class
# ---------------------------------------------------------------------------

def test_tick_class_gets_warm_grace_even_on_cold_boot():
    for g in (jguard, pguard):
        d = g.LaunchDeadlines(warm_boot=False, compile_budget_s=180.0,
                              warm_grace_s=30.0)
        assert d.deadline_s("tick:64") == 30.0
        assert d.deadline_s("launch:64") == 180.0


def test_tick_class_trained_p99_wins():
    for g in (jguard, pguard):
        d = g.LaunchDeadlines(warm_boot=False, warm_grace_s=30.0,
                              p99_multiple=8.0, min_deadline_s=0.5)
        for _ in range(g.LaunchDeadlines.MIN_OBSERVATIONS):
            d.observe("tick:64", 0.25)
        assert d.deadline_s("tick:64") == pytest.approx(2.0)
        assert d.deadline_s("tick:512") == 30.0


# ---------------------------------------------------------------------------
# CadenceStats
# ---------------------------------------------------------------------------

def test_cadence_stats_snapshots_equal_the_reference():
    rng = np.random.default_rng(3)
    clocks = {pkg: [10.0] for pkg in (jring, pring)}
    st = {pkg: pkg.CadenceStats(clock=lambda c=clocks[pkg]: c[0])
          for pkg in (jring, pring)}
    for i in range(60):
        op = int(rng.integers(0, 5))
        for pkg, s in st.items():
            clocks[pkg][0] += 0.003
            if op == 0:
                s.note_tick(i % 9, bool(i % 2))
            elif op == 1:
                s.note_dispatch(64, i % 7, [0.001 * i, 0.0005 * i])
            elif op == 2:
                s.note_generation_drop()
            elif op == 3:
                s.note_expiry(i)
            else:
                s.note_fallback()
        assert st[pring].snapshot(enabled=bool(i % 3), depth=4) == \
            st[jring].snapshot(enabled=bool(i % 3), depth=4)


# ---------------------------------------------------------------------------
# generation-tag lifecycle on a virtual clock (FakeEngine-driven)
# ---------------------------------------------------------------------------

class FakeEngine:
    """What CadenceRing touches of an engine, with host-mask packs and a
    scriptable guard, built on one package's scheduler and reference
    verify so the same script runs through either ring."""

    def __init__(self, pkg: str):
        mods = PKGS[pkg]
        self.pkg = pkg
        self._ref = mods["ref"]
        self._stopped = threading.Event()
        self._shapes = mods["sched"].ShapeRegistry(use_host=True)
        self._sched = mods["sched"].Scheduler(shapes=self._shapes,
                                              latency_cap_sigs=4096,
                                              bulk_cap_sigs=4096)
        self._pack_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="test-pack")
        self._tracer = mods["tracer"].disabled()
        self._guard = None
        self._wedged = mods["guard"].WedgedLaunch
        self.wedge_next_guarded = False
        self.laddered = []  # (rids, key, stage) from _wedge_ladder

    def _pack(self, batch):
        recs = [r for p in batch for r in zip(p.request.msgs, p.request.pks,
                                              p.request.sigs)]

        def dispatch():
            def fetch():
                return [bool(self._ref.verify(pk, m, s))
                        for m, pk, s in recs]
            return fetch
        return dispatch

    def _guarded(self, key, thunk):
        if self.wedge_next_guarded:
            self.wedge_next_guarded = False
            raise self._wedged(key, 0.0)
        return thunk()

    def _guard_key(self, batch):
        return "launch:%d" % max(
            1, sum(len(p.request.msgs) for p in batch))

    def retry_after_ms(self, cls):
        return 50

    def _wedge_ladder(self, batch, key, stage):
        self.laddered.append(([p.request.request_id for p in batch], key,
                              stage))
        for p in batch:
            p.reply_fn([False] * len(p.request.msgs))

    def _fail_batch(self, batch, what):
        for p in batch:
            p.reply_fn(None)

    def _run_bls(self, item):
        raise AssertionError("no BLS request in these scripts")

    def _trace_queue_waits(self, launch):
        pass

    def _trace_replies(self, batch):
        pass

    def close(self):
        self._pack_pool.shutdown(wait=False)


def _fake_ring(pkg, **kw):
    now = [100.0]
    engine = FakeEngine(pkg)
    mod = PKGS[pkg]["ring"]
    kw.setdefault("expiry_s", 1.0)
    ring = mod.CadenceRing(engine, depth=mod.RingDepth(pinned=2),
                           clock=lambda: now[0], wait=lambda t: False, **kw)
    return engine, ring, now


def _trace(engine, ring, done):
    stats = ring.stats.snapshot(enabled=ring.enabled, depth=2)
    # Queue waits run from each request's admission on the real clock to
    # its dispatch on the ring's virtual one: only their count compares.
    stats["queue_wait"] = stats["queue_wait"]["n"]
    return {
        "replies": {rid: [_norm(r) for r in rs]
                    for rid, rs in sorted(done.items())},
        "stats": stats,
        "generations": [s.generation for s in ring._slots],
        "pending": len(ring._pending),
        "enabled": ring.enabled,
        "laddered": engine.laddered,
    }


def _run_both(script):
    """Run ``script(engine, ring, now, done, reply_to, pkg)`` through the
    reference's ring and the port's; both traces must be equal.
    Returns the port's."""
    traces = {}
    for pkg in PKGS:
        engine, ring, now = _fake_ring(pkg)
        done, reply_to, _ = _collector()
        try:
            script(engine, ring, now, done, reply_to, pkg)
            traces[pkg] = _trace(engine, ring, done)
        finally:
            engine.close()
    assert traces["port"] == traces["reference"]
    return traces["port"]


def _submit(engine, pkg, rid, msgs, pks, sigs, reply, cls="latency"):
    assert engine._sched.offer(
        PKGS[pkg]["proto"].VerifyRequest(rid, msgs, pks, sigs), reply,
        cls=cls)


def test_expiry_re_resolves_once_then_drops_the_late_fetch():
    msgs, pks, sigs = _sigs(5, tamper={2}, seed=11)
    expect = _expect(msgs, pks, sigs)
    mid = {}

    def script(engine, ring, now, done, reply_to, pkg):
        _submit(engine, pkg, 1, msgs, pks, sigs, reply_to(1))
        assert ring._arm(engine._sched.next_tick(ring._quota_sigs()))
        now[0] += 2.0
        ring._expire_overdue(now[0])
        mid[pkg] = ring.stats.snapshot(enabled=True, depth=2)["generation"]
        assert done[1] == [expect]
        ring._collect_oldest()

    tr = _run_both(script)
    assert mid["port"] == mid["reference"]
    assert mid["port"] == {"drops": 0, "expiries": 1, "expired_sigs": 5}
    assert tr["replies"] == {1: [expect]}
    assert tr["stats"]["generation"]["drops"] == 1 and tr["pending"] == 0


def test_expiry_answers_bulk_with_busy():
    msgs, pks, sigs = _sigs(3, seed=12)

    def script(engine, ring, now, done, reply_to, pkg):
        _submit(engine, pkg, 7, msgs, pks, sigs, reply_to(7), cls="bulk")
        assert ring._arm(engine._sched.next_tick(ring._quota_sigs()))
        now[0] += 2.0
        ring._expire_overdue(now[0])
        ring._collect_oldest()

    tr = _run_both(script)
    assert tr["replies"] == {7: [("busy", 50)]}


def test_slot_wraparound_keeps_generations_straight():
    """20 arms over 8 slots: every slot is reused and every verdict still
    lands exactly once."""
    reqs = {}
    for rid in range(1, 21):
        msgs, pks, sigs = _sigs(2, tamper={rid % 2}, seed=rid)
        reqs[rid] = (msgs, pks, sigs, _expect(msgs, pks, sigs))

    def script(engine, ring, now, done, reply_to, pkg):
        for rid, (msgs, pks, sigs, _) in reqs.items():
            _submit(engine, pkg, rid, msgs, pks, sigs, reply_to(rid))
            ring._tick_once(now[0])
            now[0] += 0.01
        while ring._pending:
            ring._collect_oldest()

    tr = _run_both(script)
    assert tr["replies"] == {rid: [r[3]] for rid, r in reqs.items()}
    assert tr["stats"]["generation"]["drops"] == 0
    assert tr["stats"]["generation"]["expiries"] == 0
    assert max(tr["generations"]) >= 2


def test_wedged_fetch_invalidates_and_rides_the_ladder():
    msgs, pks, sigs = _sigs(4, seed=13)

    def script(engine, ring, now, done, reply_to, pkg):
        _submit(engine, pkg, 1, msgs, pks, sigs, reply_to(1))
        assert ring._arm(engine._sched.next_tick(ring._quota_sigs()))
        engine.wedge_next_guarded = True
        ring._collect_oldest()

    tr = _run_both(script)
    assert tr["enabled"] is False
    assert tr["laddered"] == [([1], "tick:4", "fetch")]
    assert tr["replies"] == {1: [[False] * 4]}
    assert tr["stats"]["fallbacks"] == 1


def test_wedged_dispatch_re_resolves_the_other_flights():
    """A wedge at the second arm: the wedged batch rides the ladder, the
    first flight is answered from the host, both exactly once."""
    a = _sigs(3, tamper={0}, seed=14)
    b = _sigs(2, seed=15)

    def script(engine, ring, now, done, reply_to, pkg):
        _submit(engine, pkg, 1, *a, reply_to(1))
        assert ring._arm(engine._sched.next_tick(ring._quota_sigs()))
        _submit(engine, pkg, 2, *b, reply_to(2))
        engine.wedge_next_guarded = True
        assert not ring._arm(engine._sched.next_tick(ring._quota_sigs()))

    tr = _run_both(script)
    assert tr["replies"] == {1: [_expect(*a)], 2: [[False] * 2]}
    assert tr["laddered"] == [([2], "tick:2", "dispatch")]
    assert tr["pending"] == 0 and not tr["enabled"]


def test_clean_stop_drains_every_inflight_verdict():
    reqs = {rid: _sigs(3, tamper={rid}, seed=20 + rid) for rid in (1, 2)}

    def script(engine, ring, now, done, reply_to, pkg):
        for rid, r in reqs.items():
            _submit(engine, pkg, rid, *r, reply_to(rid))
            assert ring._arm(engine._sched.next_tick(ring._quota_sigs()))
        assert len(ring._pending) == 2
        engine._stopped.set()
        ring.run()

    tr = _run_both(script)
    assert tr["replies"] == {rid: [_expect(*r)] for rid, r in reqs.items()}
    assert tr["pending"] == 0


def test_idle_interval_backs_off_and_resets():
    for pkg in PKGS:
        engine, ring, _ = _fake_ring(pkg)
        try:
            cls = PKGS[pkg]["ring"].CadenceRing
            seq = [ring._interval(False, 0) for _ in range(21)]
            seq += [ring._interval(True, 1), ring._interval(False, 0)]
        finally:
            engine.close()
        assert seq[0] == pytest.approx(2 * cls.MIN_TICK_S)
        assert seq[20] == cls.MAX_TICK_S
        assert seq[21] == cls.MIN_TICK_S
        assert seq[22] == pytest.approx(2 * cls.MIN_TICK_S)
        if pkg == "reference":
            want = seq
        else:
            assert seq == want


def test_pinned_tick_interval_wins():
    for pkg in PKGS:
        engine, ring, _ = _fake_ring(pkg, tick_s=0.033)
        try:
            assert ring._interval(True, 1) == 0.033
            assert ring._interval(False, 0) == 0.033
        finally:
            engine.close()


def test_tick_key_rides_the_staged_bucket():
    msgs, pks, sigs = _sigs(3, seed=30)
    for pkg in PKGS:
        engine, ring, _ = _fake_ring(pkg)
        try:
            s = PKGS[pkg]
            batch = [s["sched"].Pending(
                s["proto"].VerifyRequest(1, msgs, pks, sigs),
                lambda m: None, "latency")]
            assert ring._tick_key(batch) == "tick:3"
        finally:
            engine.close()
    # The port engine's staged key is the deduped power-of-two bucket.
    eng = service.VerifyEngine(use_host=True,
                               ring_factory=lambda e: pring.CadenceRing(e))
    try:
        batch = [psched.Pending(proto.VerifyRequest(1, msgs, pks, sigs),
                                lambda m: None, "latency")]
        assert eng._ring._tick_key(batch) == "tick:8"
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# the engine: masks, wedge fallback, OP_STATS round trip, the lint
# ---------------------------------------------------------------------------

def _cadence_engine(deadlines=CPU, **kw):
    g = pguard.LaunchGuard(deadlines=pguard.LaunchDeadlines(**deadlines))
    kw.setdefault("use_host", True)
    engine = service.VerifyEngine(
        guard=g,
        ring_factory=lambda e: pring.CadenceRing(
            e, depth=pring.RingDepth(pinned=2)), **kw)
    return engine, g


@pytest.mark.parametrize("where", ["host", "cpu"])
def test_cadence_engine_masks_bit_identical_and_supervised(where):
    """Ring verdicts equal ref_ed25519's masks through the engine (host
    crypto, and the kernels' plain versions on device="cpu", 8
    signatures), every launch supervised under ``tick:``, and the
    OP_STATS cadence section reports the traffic."""
    kw = {"use_host": True} if where == "host" else \
        {"use_host": False, "device": "cpu"}
    engine, g = _cadence_engine(**kw)
    rids = range(1, 6) if where == "host" else (1,)
    try:
        done, reply_to, wait_for = _collector()
        expects = {}
        for rid in rids:
            msgs, pks, sigs = _sigs(8, tamper={3}, seed=40 + rid)
            expects[rid] = _expect(msgs, pks, sigs)
            assert engine.submit(proto.VerifyRequest(rid, msgs, pks, sigs),
                                 reply_to(rid))
        assert wait_for(*expects)
        for rid, expect in expects.items():
            assert done[rid] == [expect], f"rid {rid}"
        cad = engine.stats_snapshot()["cadence"]
        assert cad["enabled"] and cad["depth"] == 2
        assert cad["ticks"] >= 1 and cad["dispatch_ticks"] >= 1
        assert cad["queue_wait"]["n"] >= len(expects)
        assert cad["generation"]["drops"] == 0
        json.dumps(cad)
        assert any(k.startswith("tick:") and v["n"] >= 1
                   for k, v in g.snapshot()["deadlines"].items())
        assert not any(k.startswith("launch:")
                       for k in g.snapshot()["deadlines"])
    finally:
        engine.stop()
        g.close()


def test_cadence_wedge_falls_back_to_staged_no_double_reply():
    """A wedged cadence launch is answered through the ladder with the
    host's mask, the ring disengages, the reboot completes, and the
    staged loop serves the next request: one reply per rid throughout."""
    chaos = service.ChaosState()
    engine, g = _cadence_engine(
        deadlines=dict(CPU, warm_grace_s=3.0), chaos=chaos)
    try:
        msgs, pks, sigs = _sigs(8, tamper={3}, seed=5)
        expect = _expect(msgs, pks, sigs)
        done, reply_to, wait_for = _collector()
        assert engine.submit(proto.VerifyRequest(1, msgs, pks, sigs),
                             reply_to(1))
        assert wait_for(1) and done[1] == [expect]
        chaos.configure({"wedge": 1})
        assert engine.submit(proto.VerifyRequest(2, msgs, pks, sigs),
                             reply_to(2))
        assert wait_for(2) and done[2] == [expect]
        assert engine._ring.enabled is False
        cad = engine.stats_snapshot()["cadence"]
        assert cad["fallbacks"] == 1 and not cad["enabled"]
        assert _wait(lambda: engine._device_ok and not engine._rebooting)
        assert engine.stats_snapshot()["guard"]["reboots"] == 1
        m3, p3, s3 = _sigs(4, tamper={0}, seed=6)
        assert engine.submit(proto.VerifyRequest(3, m3, p3, s3),
                             reply_to(3))
        assert wait_for(3) and done[3] == [_expect(m3, p3, s3)]
        assert all(len(v) == 1 for v in done.values())
    finally:
        engine.stop()
        g.close()


def test_cadence_stats_round_trip_wire_to_parser():
    """The port's OP_STATS ``cadence`` section, through JSON, into the
    reference harness's LogParser: the CONFIG note and
    ``parser.cadence``."""
    from hotstuff_tpu.harness import LogParser
    from test_ring import GOLDEN_CLIENT, GOLDEN_NODE

    engine, g = _cadence_engine()
    try:
        msgs, pks, sigs = _sigs(6, tamper={1}, seed=55)
        done, reply_to, wait_for = _collector()
        assert engine.submit(proto.VerifyRequest(1, msgs, pks, sigs),
                             reply_to(1))
        assert wait_for(1)
        stats = engine.stats_snapshot()
        assert stats["launches"] >= 1
        wire = json.loads(json.dumps(stats))
        parser = LogParser([GOLDEN_CLIENT], [GOLDEN_NODE], faults=0)
        parser.note_sidecar_stats(wire)
        note = next(n for n in parser.notes
                    if n.startswith("Sidecar cadence ring:"))
        assert "depth 2" in note
        assert "tick(s)" in note and "queue wait p50" in note
        assert "FELL BACK TO STAGED" not in note
        assert parser.cadence == wire["cadence"]
    finally:
        engine.stop()
        g.close()


def test_cadence_fallback_note_names_the_disengage():
    """A port ring's snapshot after a fallback and a generation drop
    gives the reference parser's disengage note."""
    from hotstuff_tpu.harness import LogParser
    from test_ring import GOLDEN_CLIENT, GOLDEN_NODE

    engine, ring, _ = _fake_ring("port")
    try:
        ring.stats.note_tick(1, True)
        ring.stats.note_dispatch(128, 16, [0.0004])
        ring.stats.note_generation_drop()
        ring.stats.note_expiry(8)
        ring.stats.note_fallback()
        ring.enabled = False
        cad = json.loads(json.dumps(ring.snapshot()))
    finally:
        engine.close()
    parser = LogParser([GOLDEN_CLIENT], [GOLDEN_NODE], faults=0)
    parser.note_sidecar_stats({"launches": 3, "cadence": cad})
    note = next(n for n in parser.notes
                if n.startswith("Sidecar cadence ring:"))
    assert "FELL BACK TO STAGED" in note
    assert "1 generation drop(s)" in note


def test_ring_lint_reports_nothing_on_the_port():
    """The reference's ring checker (no unbounded wait outside a guarded
    thunk, no self-bucketed verify entry in a tick body) on the port's
    ring: no finding.  It does fire on a planted bare wait."""
    from hotstuff_tpu.analysis import ringlint

    assert ringlint.check(
        REPO, targets=("hotstuff_tpu_torch/sidecar/ring.py",)) == []
    with open(f"{REPO}/hotstuff_tpu_torch/sidecar/ring.py") as f:
        src = f.read()
    planted = src.replace(
        "fetch = engine._guarded(key, lambda: fut.result()())",
        "fetch = fut.result()()")
    assert planted != src
    found = ringlint.check_sources({"ring.py": planted})
    assert [f.rule for f in found] == ["blocking-call-in-ring-tick"]


# ---------------------------------------------------------------------------
# the mesh ring slot
# ---------------------------------------------------------------------------

def test_ring_slot_pack_equals_the_sharded_per_signature_mask():
    """3 records on four CPU shards at the ring's pinned 16 rows (4 a
    shard; the batch's own bucket is 8): the same mask as
    verify_batch_sharded_pack and ref_ed25519, the pad rows dead."""
    msgs, pks, sigs = _sigs(3, tamper={1}, seed=60)
    mesh = virtual_mesh(4, "cpu")
    prep = peddsa.prepare_batch(msgs, pks, sigs)
    ring_mask = pshv.ring_slot_pack(mesh, prep, 16)()()
    staged = pshv.verify_batch_sharded_pack(mesh, prep)()()
    assert list(ring_mask) == list(staged) == _expect(msgs, pks, sigs)


def test_mesh_engine_arms_ladder_slices_in_the_ring_slot(monkeypatch):
    """A mesh engine with the ring engaged packs a ladder-routed request
    through ring_slot_pack at the ring's fixed rows (the ladder cap's
    shard-aligned count) and records that per-shard bucket; the staged
    engine packs the batch's own bucket."""
    seen = []

    def spy(name):
        def pack(mesh, prep, rows=None):
            n = prep["packed"].shape[0]
            seen.append((name, n, rows))
            ok = np.asarray(prep["host_ok"], bool)
            return lambda: (lambda: ok[:n])
        return pack

    monkeypatch.setattr(pshv, "ring_slot_pack", spy("ring"))
    monkeypatch.setattr(pshv, "verify_batch_sharded_pack", spy("staged"))
    msgs, pks, sigs = _sigs(3, seed=61)
    for cadence in (True, False):
        engine = service.VerifyEngine(mesh=virtual_mesh(4, "cpu"),
                                      committee=1000, cadence=cadence)
        try:
            done, reply_to, wait_for = _collector()
            assert engine.submit(proto.VerifyRequest(1, msgs, pks, sigs),
                                 reply_to(1))
            assert wait_for(1) and done[1] == [[True] * 3]
            snap = engine.stats_snapshot()
            assert snap["paths"] == {"ladder_sharded": 1}
            assert ("cadence" in snap) is cadence
            hist = snap["mesh"]["shard_buckets"]
        finally:
            engine.stop()
        if cadence:
            cap = engine._shapes.ladder_cap()
            rows = pshv.shard_aligned_rows(cap, 4)
            assert seen.pop() == ("ring", 3, rows)
            assert hist == {str(rows // 4): 1}
        else:
            assert seen.pop() == ("staged", 3, None)
            assert hist == {"2": 1}
    assert not seen


# ---------------------------------------------------------------------------
# the module entry
# ---------------------------------------------------------------------------

def test_module_entry_serves_with_the_ring(tmp_path):
    """``--host-crypto --cadence``: a QC verifies through the ring and
    OP_STATS carries the ``cadence`` section."""
    port = free_port()
    log_path = tmp_path / "sidecar.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "hotstuff_tpu_torch.sidecar", "--port",
             str(port), "--host-crypto", "--cadence"], cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 180
        while True:
            try:
                with SidecarClient(port=port, timeout=10) as c:
                    assert c.ping()
                break
            except (ConnectionError, OSError):
                assert proc.poll() is None, log_path.read_text()
                assert time.monotonic() < deadline, log_path.read_text()
                time.sleep(0.2)
        msgs, pks, sigs = _sigs(5, tamper={2}, seed=4)
        with SidecarClient(port=port, timeout=60) as c:
            assert c.verify_batch(msgs, pks, sigs) == _expect(msgs, pks,
                                                              sigs)
            stats = c.stats()
        cad = stats["cadence"]
        assert cad["enabled"] and cad["dispatch_ticks"] >= 1
        assert cad["pad_fill"]["launched_sigs"] == 5
        assert "cadence: ring engaged" in log_path.read_text()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
