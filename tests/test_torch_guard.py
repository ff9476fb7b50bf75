"""The port's launch guard, chaos hook and supervised engine
(hotstuff_tpu_torch/sidecar/guard.py and service.py) against the JAX
package's (hotstuff_tpu/sidecar/guard.py, service.py) on the CPU, on the
same seeded inputs, with tolerance 0: mirrors tests/test_guard.py.

* ``LaunchDeadlines`` gives the same deadline series for the same
  observations and environment knobs; ``from_build`` is warm on the CPU
  and when the current kernel library is loaded;
* ``Quarantine`` and ``bisect_poison`` make the same probe sequence and
  give the same result (the probe budget included); ``GuardStats`` and
  ``LaunchGuard`` snapshots have the same keys; a wedge is declared
  within its deadline, exceptions propagate, a late completion is
  discarded;
* ``ChaosState.configure`` gives the same results and ValueError cases;
  OP_CHAOS, OP_BUSY (a shed) and a malformed chaos spec get the
  reference's bytes (a close for the last);
* ``_wedge_ladder`` on one mixed batch gives the same masks, BusyReply
  set and guard counters through the reference engine (``use_host``) and
  the port's (``device="cpu"``, whose canary runs the kernels' plain
  versions);
* the chaos drill over the wire on the port (``device="cpu"``): the
  host-answered mask, OP_BUSY for bulk during the reboot, the canary,
  device routing again; a BLS wedge answers transient and caches
  nothing; a repeat wedge triggers bisection; the re-warm reaches the
  device path while live traffic is host-routed; the staged pipeline
  hides a pack behind a launch in flight;
* ``python -m hotstuff_tpu_torch.sidecar --host-crypto --chaos --tcp``
  serves OP_CHAOS and verifies on both listeners.

Every wait is bounded; no assertion rests on a tight wall clock.
"""

from __future__ import annotations

import json
import logging
import socket
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import pytest

from hotstuff_tpu.sidecar import guard as jguard
from hotstuff_tpu.sidecar import protocol as jproto
from hotstuff_tpu.sidecar import service as jservice
from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
from hotstuff_tpu_torch.offchain import bls12381 as bls
from hotstuff_tpu_torch.ops.kern import build
from hotstuff_tpu_torch.sidecar import guard as pguard
from hotstuff_tpu_torch.sidecar import protocol as proto
from hotstuff_tpu_torch.sidecar import sched as psched
from hotstuff_tpu_torch.sidecar import service as pservice
from hotstuff_tpu_torch.sidecar.client import (SidecarClient,
                                               SidecarOverloaded)

from conftest import REPO, free_port

GUARDS = {"reference": jguard, "port": pguard}

# The reference's test deadlines: the monitor must preempt a hung
# thread, so launches get a 0.15 s warm grace.
FAST = dict(warm_boot=True, compile_budget_s=2.0, warm_grace_s=0.15,
            min_deadline_s=0.05)
# A port engine on device="cpu" runs the kernels' plain versions, ~1 s
# for 8 signatures on an idle core: its canary and probes (compile
# class) and its launches (warm grace) get room for a loaded machine.
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
    return [ref.verify(pk, m, s) for m, pk, s in zip(msgs, pks, sigs)]


def _wait(pred, timeout=120.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _collector():
    done = {}
    cond = threading.Condition()

    def reply_to(rid):
        def _reply(mask):
            with cond:
                done[rid] = mask
                cond.notify_all()
        return _reply

    def wait_for(*rids, timeout=120.0):
        with cond:
            return cond.wait_for(lambda: all(r in done for r in rids),
                                 timeout=timeout)
    return done, reply_to, wait_for


def _recovered(engine):
    return engine._device_ok and not engine._rebooting


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,env", [
    ({"warm_boot": False, "compile_budget_s": 180.0, "warm_grace_s": 30.0},
     {}),
    ({"warm_boot": True, "compile_budget_s": 180.0, "warm_grace_s": 30.0},
     {}),
    ({"warm_boot": True, "warm_grace_s": 30.0, "p99_multiple": 8.0,
      "min_deadline_s": 0.5}, {}),
    ({"warm_boot": True}, {"HOTSTUFF_TPU_GUARD_COMPILE_BUDGET_S": "77",
                           "HOTSTUFF_TPU_GUARD_WARM_GRACE_S": "11",
                           "HOTSTUFF_TPU_GUARD_P99_MULTIPLE": "3",
                           "HOTSTUFF_TPU_GUARD_MIN_DEADLINE_S": "0.02"}),
    ({"warm_boot": False}, {"HOTSTUFF_TPU_GUARD_COMPILE_BUDGET_S": "x",
                            "HOTSTUFF_TPU_GUARD_WARM_GRACE_S": "-4"}),
])
def test_deadline_series_equals_the_reference(monkeypatch, kw, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(len(env) * 10 + len(kw))
    keys = ["launch:8", "launch:64", "launch:1024", "canary:8",
            "poison-probe:3", "tick:64", "bls:votes:128"]
    deadlines = {pkg: g.LaunchDeadlines(**kw) for pkg, g in GUARDS.items()}
    series = {pkg: [] for pkg in GUARDS}
    for step in range(300):
        key = keys[rng.integers(0, len(keys))]
        dur = float(rng.lognormal(-4, 1.5))
        for pkg, d in deadlines.items():
            d.observe(key, dur)
            series[pkg].append([d.deadline_s(k) for k in keys])
    for pkg, d in deadlines.items():
        series[pkg].append(d.snapshot())
    assert series["port"] == series["reference"]
    assert pguard.LaunchDeadlines.COMPILE_CLASS_PREFIXES == \
        jguard.LaunchDeadlines.COMPILE_CLASS_PREFIXES
    assert pguard.LaunchDeadlines.TICK_CLASS_PREFIX == \
        jguard.LaunchDeadlines.TICK_CLASS_PREFIX


def test_deadlines_from_build(monkeypatch):
    """Warm on the CPU (nothing to build) and when the current kernel
    library is loaded; cold for the card before that, or with a library
    of other sources."""
    assert pguard.LaunchDeadlines.from_build("cpu").warm_boot
    assert not build.loaded()
    assert not pguard.LaunchDeadlines.from_build("cuda").warm_boot
    monkeypatch.setattr(build, "_lib", object())
    monkeypatch.setattr(build, "_lib_hash", build.source_hash())
    assert pguard.LaunchDeadlines.from_build("cuda").warm_boot
    monkeypatch.setattr(build, "_lib_hash", "0" * 16)
    assert not pguard.LaunchDeadlines.from_build("cuda",
                                                 warm_grace_s=5).warm_boot


# ---------------------------------------------------------------------------
# the guard itself
# ---------------------------------------------------------------------------

@pytest.fixture(params=list(GUARDS))
def guard(request):
    g = GUARDS[request.param].LaunchGuard(
        deadlines=GUARDS[request.param].LaunchDeadlines(**FAST))
    yield g
    g.close()


def test_guard_returns_result_and_observes(guard):
    assert guard.call("k", lambda: 41 + 1) == 42
    assert guard.deadlines.snapshot()["k"]["n"] == 1


def test_guard_wedges_a_hung_launch_within_deadline(guard):
    release = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(Exception) as err:
        guard.call("k", release.wait)
    assert type(err.value).__name__ == "WedgedLaunch"
    assert err.value.deadline_s == 0.15 and err.value.key == "k"
    assert time.monotonic() - t0 < 30.0     # bounded, not a tight bar
    assert guard.stats.snapshot()["wedges"] == 1
    release.set()


def test_guard_logs_the_launch_threads_stack_at_the_overrun(caplog):
    """The port's guard names where an abandoned launch thread stood when
    its deadline ran out (the reference logs nothing here)."""
    g = pguard.LaunchGuard(deadlines=pguard.LaunchDeadlines(**FAST))
    release = threading.Event()

    def parked_launch():
        release.wait()

    try:
        with caplog.at_level(logging.ERROR, logger="sidecar.guard"):
            with pytest.raises(pguard.WedgedLaunch):
                g.call("k", parked_launch)
    finally:
        release.set()
        g.close()
    (text,) = [r.getMessage() for r in caplog.records
               if r.name == "sidecar.guard"]
    assert text.startswith("guard: launch k overran its 0.15s deadline; "
                           "its thread at the overrun:\n")
    assert "in parked_launch" in text and "release.wait()" in text


def test_guard_propagates_exceptions(guard):
    with pytest.raises(RuntimeError, match="boom"):
        guard.call("k", lambda: (_ for _ in ()).throw(RuntimeError("boom")))


def test_guard_late_completion_is_discarded(guard):
    release = threading.Event()
    finished = threading.Event()

    def thunk():
        release.wait()
        finished.set()
        return "late"

    with pytest.raises(Exception):
        guard.call("k", thunk)
    release.set()
    assert finished.wait(30.0)
    assert _wait(lambda: guard.stats.snapshot()["late_completions"] == 1)
    assert guard.call("k", lambda: "fresh") == "fresh"


def test_guard_snapshots_have_the_reference_keys():
    snaps = {}
    for pkg, g in GUARDS.items():
        guard = g.LaunchGuard(deadlines=g.LaunchDeadlines(**FAST))
        try:
            guard.call("launch:8", lambda: 1)
            with pytest.raises(g.WedgedLaunch):
                guard.call("launch:8", threading.Event().wait)
            stats = guard.stats
            stats.note_reboot(1.25)
            stats.note_rewarm(0.5)
            stats.note_canary(True)
            stats.note_canary(False)
            stats.note_host_fallback(8)
            stats.note_busy()
            stats.note_poison_host(2)
            guard.quarantine.note_wedged([("m", "p", "s")] * 2)
            snap = guard.snapshot()
            json.dumps(snap)
            del snap["deadlines"]["launch:8"]["deadline_s"]
            snaps[pkg] = snap
        finally:
            guard.close()
    assert snaps["port"] == snaps["reference"]
    assert (pguard.LaunchGuard(max_reboots=None).max_reboots,
            pguard.LaunchGuard().max_bisect_probes) == \
        (jguard.LaunchGuard().max_reboots,
         jguard.LaunchGuard().max_bisect_probes)


# ---------------------------------------------------------------------------
# quarantine + bisection
# ---------------------------------------------------------------------------

def test_quarantine_flow_equals_the_reference():
    rng = np.random.default_rng(5)
    recs = [(b"m%d" % i, b"p", b"s") for i in range(40)]
    out = {}
    for pkg, g in GUARDS.items():
        q, trace = g.Quarantine(), []
        r = np.random.default_rng(5)
        for _ in range(30):
            pick = [recs[i] for i in r.choice(40, size=6, replace=False)]
            trace.append(q.note_wedged(pick))
            if r.random() < 0.3:
                pending = q.pending()
                trace.append(q.resolve(pending[: len(pending) // 2]))
            trace.append(q.snapshot())
        trace.append(sorted(r for r in recs if q.is_poisoned(r)))
        out[pkg] = trace
    assert out["port"] == out["reference"]
    assert rng is not None and out["port"][-1]


@pytest.mark.parametrize("n,poison,budget", [
    (8, {5}, 64), (8, {1, 6}, 64), (2, "pair", 64), (16, {3}, 1),
    (33, {0, 17, 32}, 64), (64, {7, 8, 40}, 9), (1, {0}, 64), (5, set(), 64),
])
def test_bisect_poison_probe_sequence_equals_the_reference(n, poison,
                                                            budget):
    recs = list(range(n))
    seqs, results = {}, {}
    for pkg, g in GUARDS.items():
        probes = []

        def probe(subset):
            probes.append(list(subset))
            if poison == "pair":
                return not {0, 1} <= set(subset)
            return not (poison & set(subset))

        results[pkg] = sorted(g.bisect_poison(recs, probe,
                                              max_probes=budget))
        seqs[pkg] = probes
    assert seqs["port"] == seqs["reference"]
    assert results["port"] == results["reference"]
    if budget == 1:
        assert results["port"] == recs      # unprobed leftovers stay


# ---------------------------------------------------------------------------
# the chaos hook and its wire bytes
# ---------------------------------------------------------------------------

def test_chaos_configure_equals_the_reference():
    specs = [{"wedge": 2}, {"delay_ms": 5000}, {"shed": 1, "drop": 2},
             {"clear": True}, {"delay_ms": 0}, {"wedge": 1, "clear": 1},
             {"wedge": -1}, {"wedge": True}, {"delay_ms": 1.5},
             {"bogus": 1}, {"shed": "3"}, {}, {"drop": 0}]
    out = {}
    for pkg, mod in (("reference", jservice), ("port", pservice)):
        c, trace = mod.ChaosState(), []
        for spec in specs:
            try:
                trace.append(c.configure(dict(spec)))
            except ValueError as e:
                trace.append(("ValueError", str(e)))
            trace.append([c.take_wedge() for _ in range(3)])
            trace.append([c.verify_action() for _ in range(3)])
        out[pkg] = trace
    assert out["port"] == out["reference"]
    assert pservice.ChaosState.MAX_DELAY_MS == 750


def _serve(server):
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    return thread


@pytest.fixture
def chaos_servers():
    """The port's and the reference's host engines, each behind a server
    with a chaos state."""
    servers = []
    for mod in (pservice, jservice):
        chaos = mod.ChaosState()
        srv = mod.SidecarServer(("127.0.0.1", 0),
                                mod.VerifyEngine(use_host=True),
                                chaos=chaos)
        servers.append((srv, _serve(srv)))
    yield [srv for srv, _ in servers]
    for srv, thread in servers:
        srv.shutdown()
        srv.server_close()
        srv.engine.stop()
        thread.join(timeout=10)


def _exchange(server, *frames) -> list:
    """Send frames on one connection; one reply frame each, or b"" once
    the sidecar closes the connection."""
    out = []
    with socket.create_connection(server.server_address, timeout=60) as s:
        for frame in frames:
            s.sendall(frame)
            try:
                out.append(proto.read_frame(s))
            except (ConnectionError, OSError):
                out.append(b"")
    return out


def test_chaos_and_busy_replies_are_the_reference_bytes(chaos_servers):
    msgs, pks, sigs = _sigs(3, seed=2)
    frames = [proto.encode_chaos_request(1, {"shed": 1}),
              proto.encode_request(2, msgs, pks, sigs),
              proto.encode_chaos_request(3, {"shed": 1}),
              proto.encode_request(4, msgs, pks, sigs,
                                   opcode=proto.OP_VERIFY_BULK),
              proto.encode_request(5, msgs, pks, sigs),
              proto.encode_ping(6),
              proto.encode_chaos_request(7, {"drop": 1}),
              proto.encode_request(8, msgs, pks, sigs)]
    got, want = (_exchange(srv, *frames) for srv in chaos_servers)
    assert got == want
    assert got[0] == proto.encode_reply(proto.OP_CHAOS, 1, [1])[4:]
    assert got[1] == proto.encode_busy_reply(2, 50)[4:]     # latency: 50
    assert got[3] == proto.encode_busy_reply(4, 250)[4:]    # bulk: 250
    assert got[4] == proto.encode_reply(proto.OP_VERIFY_BATCH, 5,
                                        [True] * 3)[4:]
    assert got[7] == b""                                    # dropped
    bad = proto.encode_chaos_request(9, {"wedge": -1})
    for srv in chaos_servers:
        assert _exchange(srv, bad, proto.encode_ping(10)) == [b"", b""]
    assert jproto.OP_BUSY == proto.OP_BUSY


def test_delayed_reply_lets_a_pipelined_ping_through(chaos_servers):
    srv = chaos_servers[0]
    msgs, pks, sigs = _sigs(2, seed=3)
    with socket.create_connection(srv.server_address, timeout=60) as s:
        s.sendall(proto.encode_chaos_request(1, {"delay_ms": 300}))
        assert proto.read_frame(s) == \
            proto.encode_reply(proto.OP_CHAOS, 1, [1])[4:]
        s.sendall(proto.encode_request(2, msgs, pks, sigs)
                  + proto.encode_ping(3))
        first = proto.decode_reply_raw(proto.read_frame(s))
        second = proto.decode_reply_raw(proto.read_frame(s))
    assert (first[0], first[1]) == (proto.OP_PING, 3)
    assert (second[0], second[1]) == (proto.OP_VERIFY_BATCH, 2)


# ---------------------------------------------------------------------------
# the engine's ladder, reboot and canary
# ---------------------------------------------------------------------------

def _ladder(pkg):
    """_wedge_ladder on one mixed batch: the masks, the BusyReply set and
    the guard's counters after the reboot."""
    msgs, pks, sigs = _sigs(6, tamper={1, 4}, seed=3)
    if pkg == "reference":
        g = jguard.LaunchGuard(deadlines=jguard.LaunchDeadlines(**FAST))
        engine = jservice.VerifyEngine(use_host=True, guard=g)
        sched = jservice.vsched
    else:
        g = pguard.LaunchGuard(deadlines=pguard.LaunchDeadlines(**CPU))
        engine = pservice.VerifyEngine(device="cpu", guard=g)
        sched = psched
    try:
        done, reply_to, wait_for = _collector()
        batch = [sched.Pending(proto.VerifyRequest(1, msgs[:3], pks[:3],
                                                   sigs[:3]),
                               reply_to(1), sched.LATENCY),
                 sched.Pending(proto.VerifyRequest(2, msgs[3:], pks[3:],
                                                   sigs[3:]),
                               reply_to(2), sched.BULK)]
        engine._wedge_ladder(batch, "launch:8", stage="test")
        assert wait_for(1, 2)
        snap = dict(engine.stats_snapshot()["guard"])
        assert _wait(lambda: _recovered(engine))
        after = engine.stats_snapshot()["guard"]
        busy = done[2]
        return (done[1], type(busy).__name__, busy.retry_after_ms,
                {k: snap[k] for k in ("host_fallback_records",
                                      "busy_replies", "suspect_records",
                                      "wedges")},
                {k: after[k] for k in ("reboots", "canary_passes",
                                       "canary_failures", "device_ok",
                                       "rebooting")})
    finally:
        engine.stop()
        g.close()


def test_wedge_ladder_equals_the_reference():
    want = _ladder("reference")
    got = _ladder("port")
    assert got == want
    msgs, pks, sigs = _sigs(6, tamper={1, 4}, seed=3)
    assert got[0] == _expect(msgs, pks, sigs)[:3]
    assert got[1:3] == ("BusyReply", 250)


def test_guard_key_uses_deduped_record_count():
    g = pguard.LaunchGuard(deadlines=pguard.LaunchDeadlines(**FAST))
    jg = jguard.LaunchGuard(deadlines=jguard.LaunchDeadlines(**FAST))
    engine = pservice.VerifyEngine(use_host=True, guard=g)
    jengine = jservice.VerifyEngine(use_host=True, guard=jg)
    try:
        for n, copies in ((8, 4), (3, 1), (9, 2), (600, 3)):
            msgs = [b"%8d" % i for i in range(n)]
            pks, sigs = [b"p" * 32] * n, [b"s" * 64] * n
            batches = [[mod.vsched.Pending(proto.VerifyRequest(
                rid, msgs, pks, sigs), None, mod.vsched.LATENCY)
                for rid in range(copies)] for mod in (pservice, jservice)]
            assert engine._guard_key(batches[0]) == \
                jengine._guard_key(batches[1])
        assert engine._guard_key(batches[0]) == "launch:1024"
        for name, args in (
                ("BlsVotesRequest", (1, b"m", [b"k"] * 67, [b"s"])),
                ("BlsAggRequest", (2, b"m", b"a", [b"k"] * 3)),
                ("BlsMultiRequest", (3, [b"m"], [b"k"] * 100, [b"s"])),
                ("BlsSignRequest", (4, b"m", b"k"))):
            assert engine._bls_guard_key(getattr(proto, name)(*args)) == \
                jengine._bls_guard_key(getattr(jproto, name)(*args))
    finally:
        for e, gg in ((engine, g), (jengine, jg)):
            e.stop()
            gg.close()


def test_chaos_drill_over_the_wire_on_the_port():
    """OP_CHAOS wedge -> the ladder's host mask -> OP_BUSY for bulk
    during the reboot -> re-warm and canary on the kernels' plain
    versions -> a fresh QC on the device path."""
    chaos = pservice.ChaosState()
    g = pguard.LaunchGuard(deadlines=pguard.LaunchDeadlines(**CPU))
    rewarmed = threading.Event()
    gate = threading.Event()

    def rewarm():
        rewarmed.set()
        gate.wait(60)       # hold the reboot open while bulk is offered

    engine = pservice.VerifyEngine(device="cpu", guard=g, chaos=chaos,
                                   rewarm_fn=rewarm)
    srv = pservice.SidecarServer(("127.0.0.1", 0), engine, chaos=chaos)
    thread = _serve(srv)
    try:
        msgs, pks, sigs = _sigs(8, tamper={3}, seed=5)
        with SidecarClient(port=srv.server_address[1],
                           timeout=120) as client:
            assert client.chaos(wedge=1)
            assert client.verify_batch(msgs, pks, sigs) == \
                _expect(msgs, pks, sigs)
            assert rewarmed.wait(60)
            with pytest.raises(SidecarOverloaded) as err:
                client.verify_batch(msgs, pks, sigs, bulk=True)
            assert err.value.retry_after_ms >= 0
            gate.set()
            assert _wait(lambda: _recovered(engine))
            before = client.stats()
            guard = before["guard"]
            assert guard["wedges"] == 1 and guard["reboots"] == 1
            assert guard["canary_passes"] >= 1 and guard["device_ok"]
            assert guard["host_fallback_records"] == 8
            assert guard["busy_replies"] >= 1
            assert guard["deadlines"]["canary:8"]["n"] >= 1
            m2, p2, s2 = _sigs(6, tamper={2}, seed=6)
            assert client.verify_batch(m2, p2, s2) == _expect(m2, p2, s2)
            after = client.stats()
        assert after["paths"]["per_sig"] == before["paths"]["per_sig"] + 1
        assert "host" not in after["paths"]
        assert set(before) >= {"guard", "pipeline", "dedup", "tenant_caps",
                               "surge", "queue_wait", "ingress"}
    finally:
        gate.set()
        srv.shutdown()
        srv.server_close()
        engine.stop()
        g.close()
        thread.join(timeout=10)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_bls_wedge_answers_transient_and_caches_nothing(pkg):
    mod, g, wire = (jservice, jguard, jproto) if pkg == "reference" \
        else (pservice, pguard, proto)
    from hotstuff_tpu.offchain import bls12381 as jbls

    chaos = mod.ChaosState()
    guard = g.LaunchGuard(deadlines=g.LaunchDeadlines(**FAST))
    engine = mod.VerifyEngine(use_host=True, guard=guard, chaos=chaos)
    try:
        msg = b"qc digest under bls".ljust(32, b"\0")
        keys = [jbls.key_gen(bytes([i]) * 32) for i in range(1, 4)]
        pks = [bls.g1_encode(pk) for _, pk in keys]
        sigs = [bls.g2_encode(bls.sign(sk, msg)) for sk, _ in keys]
        done, reply_to, wait_for = _collector()
        chaos.configure({"wedge": 1})
        assert engine.submit(wire.BlsVotesRequest(1, msg, pks, sigs),
                             reply_to(1), is_bls=True)
        assert wait_for(1)
        assert done[1] is None
        assert engine.stats_snapshot()["guard"]["wedges_by_key"] == \
            {"bls:votes:4": 1}
        assert _wait(lambda: _recovered(engine))
        assert engine.stats_snapshot()["guard"]["reboots"] == 1
        assert not engine._verdicts
        msgs, vpks, vsigs = _sigs(4, tamper={2}, seed=9)
        assert engine.submit(wire.VerifyRequest(2, msgs, vpks, vsigs),
                             reply_to(2))
        assert wait_for(2)
        assert done[2] == _expect(msgs, vpks, vsigs)
    finally:
        engine.stop()
        guard.close()


def test_repeat_wedge_triggers_poison_bisection():
    """A record that wedges every launch carrying it: the second wedge
    makes it a bisection candidate, the bisection isolates exactly it,
    and later batches verify it on the host poison lane, no third
    wedge (tests/test_guard.py's case on the port; a 2 s grace, so a
    slow host verify on a loaded machine is not a wedge)."""
    guard = pguard.LaunchGuard(deadlines=pguard.LaunchDeadlines(
        **dict(FAST, warm_grace_s=2.0)))
    engine = pservice.VerifyEngine(use_host=True, guard=guard)
    msgs, pks, sigs = _sigs(6, tamper={2}, seed=9)
    cursed = (msgs[2], pks[2], sigs[2])
    real_submit = pservice.VerifyEngine._verify_submit

    def hang_on_cursed(self, m, p, s, force_device=False):
        if cursed[0] in m:
            return lambda: threading.Event().wait()
        return real_submit(self, m, p, s, force_device=force_device)

    engine._verify_submit = hang_on_cursed.__get__(engine)
    try:
        expect = _expect(msgs, pks, sigs)
        done, reply_to, wait_for = _collector()
        for rid in (1, 2):
            assert engine.submit(proto.VerifyRequest(rid, msgs, pks, sigs),
                                 reply_to(rid), cls="latency")
            assert wait_for(rid)
            assert done[rid] == expect
            assert _wait(lambda: _recovered(engine))
        snap = engine.stats_snapshot()["guard"]
        assert snap["poisoned_records"] == 1
        assert guard.quarantine.is_poisoned(cursed)
        wedges = snap["wedges"]
        assert engine.submit(proto.VerifyRequest(3, msgs, pks, sigs),
                             reply_to(3), cls="latency")
        assert wait_for(3)
        assert done[3] == expect
        snap = engine.stats_snapshot()["guard"]
        assert snap["wedges"] == wedges   # the poison lane held
        assert snap["poison_host_verified"] >= 1 and snap["device_ok"]
    finally:
        engine.stop()
        guard.close()


def test_rewarm_runs_on_the_device_path():
    """While the reboot re-warms, the reboot thread's verifies reach the
    device path (the kernels' plain versions here) and live traffic on
    other threads stays on the host."""
    g = pguard.LaunchGuard(deadlines=pguard.LaunchDeadlines(**CPU))
    seen, host_routed = [], []

    def rewarm():
        m, p, s = _sigs(4, seed=25)
        assert engine._rewarm_tls.active
        with mock.patch.object(
                ref, "verify",
                side_effect=AssertionError("rewarm took the host path")):
            seen.append([bool(b) for b in engine._verify(m, p, s)])

        def probe_live():
            with mock.patch.object(ref, "verify",
                                   wraps=ref.verify) as spy:
                engine._verify_submit(m, p, s)()
            host_routed.append(spy.call_count == 4)

        t = threading.Thread(target=probe_live)
        t.start()
        t.join(120)

    from hotstuff_tpu_torch.ops import ed25519, field25519, field381

    engine = pservice.VerifyEngine(device="cpu", guard=g, rewarm_fn=rewarm)
    try:
        engine._verify(*_sigs(2, seed=26))     # places the device tables
        tables = [ed25519._comb_device, field25519._constants,
                  field381._constants]
        assert tables[0]
        engine._wedge_ladder([], "launch:8", stage="test")
        assert _wait(lambda: _recovered(engine))
        assert seen == [[True] * 4] and host_routed == [True]
        # The teardown rebound every table cache (the re-warm filled the
        # new ones); the old dicts were left as they were.
        assert all(new is not old for new, old in zip(
            [ed25519._comb_device, field25519._constants,
             field381._constants], tables))
        assert tables[0] and ed25519._comb_device
        assert not getattr(engine._rewarm_tls, "active", False)
        assert engine.stats_snapshot()["guard"]["canary_passes"] == 1
    finally:
        engine.stop()
        g.close()


def test_engine_without_guard_is_unchanged():
    engine = pservice.VerifyEngine(use_host=True)
    try:
        msgs, pks, sigs = _sigs(4, tamper={1}, seed=13)
        done, reply_to, wait_for = _collector()
        assert engine.submit(proto.VerifyRequest(1, msgs, pks, sigs),
                             reply_to(1))
        assert wait_for(1)
        assert done[1] == [True, False, True, True]
        assert "guard" not in engine.stats_snapshot()
    finally:
        engine.stop()


def test_stats_sections_have_the_reference_keys():
    """OP_STATS over the wire: the guard, pipeline, dedup and
    tenant_caps sections carry the reference's keys (the port adds the
    device and its kernel launch counts; the reference's XLA compile
    tracker has no counterpart)."""
    snaps = []
    for mod, g in ((pservice, pguard), (jservice, jguard)):
        guard = g.LaunchGuard(deadlines=g.LaunchDeadlines(**FAST))
        engine = mod.VerifyEngine(use_host=True, guard=guard)
        srv = mod.SidecarServer(("127.0.0.1", 0), engine)
        thread = _serve(srv)
        try:
            guard.stats.note_wedge("launch:8")
            msgs, pks, sigs = _sigs(3, seed=1)
            with SidecarClient(port=srv.server_address[1],
                               timeout=60) as c:
                c.hello("t1")
                c.verify_batch(msgs, pks, sigs)
                c.verify_batch(msgs, pks, sigs, bulk=True)
                snaps.append(c.stats())
        finally:
            srv.shutdown()
            srv.server_close()
            engine.stop()
            guard.close()
            thread.join(timeout=10)
    port, want = snaps
    assert set(port) - set(want) == {"device", "kernels"}
    assert set(want) - set(port) <= {"compile"}
    for section in ("guard", "pipeline", "dedup", "tenant_caps", "surge",
                    "queue_wait", "ingress", "mesh", "scan"):
        assert set(port[section]) == set(want[section]), section
    for key in ("dedup", "tenant_caps", "admitted", "launches_by_class",
                "paths", "ingress", "queue_caps"):
        assert port[key] == want[key], key
    assert port["guard"]["wedges"] == 1 and port["guard"]["device_ok"]
    assert set(port["tenants"]) == set(want["tenants"]) == {"t1"}


def test_staged_pipeline_hides_a_pack_behind_a_launch():
    """A latency launch and a bulk one queued together: the bulk batch's
    pack runs while the latency launch is in flight (its fetch is held
    until that pack has run), and OP_STATS ``pipeline`` counts it
    hidden and the latency batch's pack open."""
    packed = threading.Event()

    class Engine(pservice.VerifyEngine):
        def _pack(self, batch):
            dispatch = super()._pack(batch)
            if batch[0].cls == "bulk":
                packed.set()
                return dispatch

            def held_dispatch():
                fetch = dispatch()

                def held_fetch():
                    assert packed.wait(120)
                    return fetch()
                return held_fetch
            return held_dispatch

    engine = Engine(device="cpu")
    try:
        done, reply_to, wait_for = _collector()
        m1, p1, s1 = _sigs(16, seed=31)
        m2, p2, s2 = _sigs(16, tamper={5}, seed=32)
        with engine._sched._cond:
            assert engine.submit(proto.VerifyRequest(1, m1, p1, s1),
                                 reply_to(1))
            assert engine.submit(proto.VerifyRequest(2, m2, p2, s2),
                                 reply_to(2), cls="bulk")
        assert wait_for(1, 2)
        assert done[1] == _expect(m1, p1, s1)
        assert done[2] == _expect(m2, p2, s2)
        snap = engine.stats_snapshot()
        assert snap["launches_by_class"] == {"latency": 1, "bulk": 1}
        # Lifetime totals: on a loaded machine the first pack can age out
        # of the section's 30 s rolling window.
        pipe = snap["pipeline"]
        assert 0 < pipe["pack_hidden_ms"]
        assert 0 < pipe["lifetime_overlap_ratio"] < 1
    finally:
        engine.stop()


def test_module_entry_serves_chaos_and_tcp(tmp_path):
    """``--host-crypto --chaos --tcp HOST:PORT``: OP_CHAOS answers [1]
    and a QC verifies on both listeners, which share one engine."""
    port, tcp_port = free_port(), free_port()
    log_path = tmp_path / "sidecar.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "hotstuff_tpu_torch.sidecar", "--port",
             str(port), "--host-crypto", "--chaos", "--tcp",
             f"127.0.0.1:{tcp_port}"], cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 180
        while True:
            try:
                with SidecarClient(port=tcp_port, timeout=10) as c:
                    assert c.ping()
                break
            except (ConnectionError, OSError):
                assert proc.poll() is None, log_path.read_text()
                assert time.monotonic() < deadline, log_path.read_text()
                time.sleep(0.2)
        msgs, pks, sigs = _sigs(5, tamper={2}, seed=4)
        for p in (port, tcp_port):
            with SidecarClient(port=p, timeout=60) as c:
                assert c.chaos(delay_ms=0) is True
                assert c.verify_batch(msgs, pks, sigs) == \
                    _expect(msgs, pks, sigs)
                stats = c.stats()
        assert stats["guard"]["warm_boot"] and stats["device"] == "host"
        # One engine: the second request was answered from the cache.
        assert stats["launches"] == 1 and stats["dedup"]["cache_hits"] == 5
    finally:
        proc.terminate()
        proc.wait(timeout=30)
