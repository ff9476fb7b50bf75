"""The port's local fault injector (hotstuff_tpu_torch/harness/faults.py)
and LocalBench's fault-plan hooks against the reference's
(hotstuff_tpu/harness): the signal plumbing on live process groups, the
leader cascade, a ``sidecar wedge`` through OP_CHAOS into the port's
guarded host-mode engine, and the executed-events record.  Ported from
tests/test_chaos.py and tests/test_guard.py; dummy processes stand in for
replicas, so nothing here needs native/ or a card."""

from __future__ import annotations

import base64
import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from hotstuff_tpu_torch.chaos import parse_plan
from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
from hotstuff_tpu_torch.harness.faults import InjectionError, \
    LocalFaultInjector
from hotstuff_tpu_torch.harness.local import LocalBench
from hotstuff_tpu_torch.harness.utils import PathMaker

PKGS = ("hotstuff_tpu", "hotstuff_tpu_torch")


def _spawn():
    return subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"],
        preexec_fn=os.setsid)


def _reap(procs):
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGKILL)
            except ProcessLookupError:
                pass
        p.wait(timeout=10)


def _state(proc) -> str:
    with open(f"/proc/{proc.pid}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0]


def _bare_bench(bench_cls, procs):
    bench = bench_cls.__new__(bench_cls)
    bench._procs = []
    bench._node_procs = procs
    bench._node_cmds = {}
    bench._sidecar_proc = None
    return bench


def test_local_fault_injector_signals_real_process_groups():
    """Kill really SIGKILLs the group, pause really SIGSTOPs it (resume
    undoes), restart re-runs the recorded boot command in append mode,
    and cleanup un-pauses stragglers."""
    procs = {0: _spawn(), 1: _spawn()}
    bench = _bare_bench(LocalBench, procs)
    restarted = []

    def background_run(cmd, log, append=False):
        restarted.append((cmd, log, append))
        return _spawn()

    bench._background_run = background_run
    bench._node_cmds = {0: ("cmd0", "log0"), 1: ("cmd1", "log1")}
    injector = LocalFaultInjector(bench)
    plan = parse_plan("0 node:0 kill; 0 node:0 restart; 0 node:1 pause")
    killed = procs[0]
    try:
        injector.apply(plan.events[0])   # kill node 0
        assert killed.poll() is not None
        injector.apply(plan.events[1])   # restart node 0
        assert restarted == [("cmd0", "log0", True)]
        assert bench._node_procs[0].poll() is None
        injector.apply(plan.events[2])   # pause node 1
        time.sleep(0.1)
        assert _state(bench._node_procs[1]) == "T"
        injector.cleanup()               # SIGCONT the straggler
        time.sleep(0.1)
        assert _state(bench._node_procs[1]) in ("S", "R")
        with pytest.raises(InjectionError):
            injector.apply(parse_plan("0 node:5 kill").events[0])
    finally:
        _reap([killed, *bench._node_procs.values()])


def test_local_fault_injector_cascade_kills_upcoming_leaders(
        tmp_path, monkeypatch):
    """The cascade estimates the live round from the node logs' tails,
    maps the next k round-robin leader slots (sorted-key order) to boot
    indices and SIGKILLs exactly those groups, skipping dead slots and
    failing only when no live leader remains."""
    procs = {i: _spawn() for i in range(4)}
    bench = _bare_bench(LocalBench, procs)
    # Names whose decoded bytes sort in boot order: leader(r) = r % 4.
    bench._node_names = [base64.b64encode(bytes([i]) * 32).decode()
                         for i in range(4)]
    monkeypatch.setattr(
        PathMaker, "node_log_file",
        staticmethod(lambda i: str(tmp_path / f"node-{i}.log")))
    # Round 10 committed -> estimate 11 -> k=2 kills rounds 12 and 13's
    # leaders, nodes 0 and 1.
    (tmp_path / "node-0.log").write_text(
        "[2026-07-29T14:54:57.000Z INFO consensus::core] Committed B10\n")
    injector = LocalFaultInjector(bench)
    try:
        injector.apply(parse_plan("0 leader-cascade kill k=2").events[0])
        procs[0].wait(timeout=10)
        procs[1].wait(timeout=10)
        assert procs[2].poll() is None and procs[3].poll() is None
        injector.apply(parse_plan("0 leader-cascade kill k=3").events[0])
        procs[2].wait(timeout=10)
        assert procs[3].poll() is None
        _reap([procs[3]])
        with pytest.raises(InjectionError) as exc:
            injector.apply(
                parse_plan("0 leader-cascade kill k=2").events[0])
        assert "no live leader" in str(exc.value)
    finally:
        _reap(procs.values())


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


def _wait(pred, timeout=20.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.005)
    return False


def test_local_injector_drives_wedge_through_opchaos():
    """'sidecar wedge' -> OP_CHAOS -> the port's engine's next launch
    wedges, and the client still gets the reference's mask (the ladder's
    host answer is transparent on the wire); a sidecar without --chaos
    refuses, which is an injection failure."""
    from hotstuff_tpu_torch.chaos.plan import FaultEvent
    from hotstuff_tpu_torch.sidecar.client import SidecarClient
    from hotstuff_tpu_torch.sidecar.guard import LaunchDeadlines, LaunchGuard
    from hotstuff_tpu_torch.sidecar.service import ChaosState, \
        SidecarServer, VerifyEngine

    servers = []
    for chaos in (ChaosState(), None):
        guard = LaunchGuard(deadlines=LaunchDeadlines(
            warm_boot=True, compile_budget_s=2.0, warm_grace_s=0.15,
            min_deadline_s=0.05))
        engine = VerifyEngine(use_host=True, guard=guard, chaos=chaos)
        srv = SidecarServer(("127.0.0.1", 0), engine, chaos=chaos)
        threading.Thread(target=srv.serve_forever,
                         kwargs=dict(poll_interval=0.1), daemon=True).start()
        servers.append((srv, engine, guard))
    try:
        port = servers[0][0].server_address[1]
        LocalFaultInjector(SimpleNamespace(SIDECAR_PORT=port)).apply(
            FaultEvent(0.0, "sidecar", "wedge", {"n": 1}))
        msgs, pks, sigs = _sigs(5, tamper={2}, seed=21)
        with SidecarClient(port=port, timeout=30.0) as client:
            mask = client.verify_batch(msgs, pks, sigs)
        assert mask == [ref.verify(pk, m, s)
                        for m, pk, s in zip(msgs, pks, sigs)] == \
            [True, True, False, True, True]
        assert _wait(lambda: servers[0][1].stats_snapshot()
                     ["guard"]["wedges"] >= 1)
        bare = LocalFaultInjector(
            SimpleNamespace(SIDECAR_PORT=servers[1][0].server_address[1]))
        with pytest.raises(InjectionError) as exc:
            bare.apply(FaultEvent(0.0, "sidecar", "wedge", {"n": 1}))
        assert "without --chaos" in str(exc.value)
    finally:
        for srv, engine, guard in servers:
            srv.shutdown()
            engine.stop()
            guard.close()
            srv.server_close()


class _Runner:
    """A PlanRunner stand-in: ``events`` of its plan, the first
    ``executed`` of them run."""

    def __init__(self, plan, executed):
        self.plan, self.executed = plan, executed

    def stop(self):
        pass

    def join(self, timeout=None):
        pass

    def events(self):
        return [{"t": e.t, "target": e.target, "action": e.action,
                 "wall": 100.0 + e.t, "ok": True}
                for e in self.plan.events[:self.executed]]


@pytest.mark.parametrize("executed", [3, 2])
def test_finish_fault_plan_records_events_as_the_reference(
        executed, tmp_path, monkeypatch):
    """``_finish_fault_plan`` writes the executed events where the parser
    reads them, and a plan the window cut short fails the run with the
    reference's BenchError."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("logs")
    out = []
    for pkg in PKGS:
        local = importlib.import_module(f"{pkg}.harness.local")
        chaos = importlib.import_module(f"{pkg}.chaos")
        utils = importlib.import_module(f"{pkg}.harness.utils")
        bench = _bare_bench(local.LocalBench, {})
        bench.fault_plan = chaos.parse_plan(
            "4 node:3 kill; 8 node:3 restart; 11 sidecar wedge")
        bench._injector = SimpleNamespace(cleanup=lambda: None)
        try:
            bench._finish_fault_plan(_Runner(bench.fault_plan, executed))
            err = None
        except utils.BenchError as e:
            err = str(e)
        with open(utils.PathMaker.chaos_events_file()) as f:
            out.append((json.load(f), err))
    assert out[1] == out[0]
    assert len(out[0][0]) == executed
    assert (out[0][1] is None) == (executed == 3)


def test_no_plan_starts_no_runner():
    """Without a plan no runner starts, and finishing writes nothing
    (the reference's contract)."""
    bench = _bare_bench(LocalBench, {})
    bench.fault_plan = None
    assert bench._start_fault_plan(4) is None
    assert bench._finish_fault_plan(None) is None
    assert not os.path.exists(PathMaker.chaos_events_file())
