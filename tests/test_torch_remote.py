"""The port's remote harness (hotstuff_tpu_torch/harness/remote.py,
faults.RemoteFaultInjector, plot.py) on a fake transport: the reference's
tests (tests/test_remote.py) run on the port's modules, and each
orchestration scenario's commands are held equal to the reference's
(hotstuff_tpu/harness), but for the sidecar module the port names.  No
real ssh is performed: the RemoteRunner is either stubbed to record
commands or pointed at a local ``sh -c`` transport that executes them.
"""

import json
import shlex
import subprocess

import pytest

from hotstuff_tpu_torch.harness.remote import Bench, ExecutionError, \
    RemoteRunner
from hotstuff_tpu_torch.harness.settings import Settings, SettingsError


SETTINGS = {
    "testbed": "t",
    "key": {"name": "k", "path": "/tmp/k.pem"},
    "ports": {"consensus": 8000, "mempool": 7000, "front": 6000},
    "repo": {"name": "repo", "url": "https://x/r.git", "branch": "main"},
    "instances": {"type": "m5d.8xlarge", "regions": ["us-east-1"]},
    "hosts": ["10.0.0.1", "10.0.0.2", "10.0.0.3", "10.0.0.4"],
}


@pytest.fixture
def settings(tmp_path):
    path = tmp_path / "settings.json"
    path.write_text(json.dumps(SETTINGS))
    return Settings.load(str(path))


def test_settings_load_and_validation(settings, tmp_path):
    assert settings.base_port == 8000
    assert settings.repo_name == "repo"
    assert settings.aws_regions == ["us-east-1"]
    with pytest.raises(SettingsError):
        Settings.load(str(tmp_path / "missing.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(SettingsError):
        Settings.load(str(bad))


class RecordingRunner(RemoteRunner):
    """Records every command instead of ssh-ing (kwargs mirror the real
    signatures so orchestration code can pass timeouts/append)."""

    def __init__(self):
        super().__init__("ubuntu", "/tmp/k.pem")
        self.commands = []   # (host, command)
        self.uploads = []    # (host, local, remote)

    def run(self, host, command, check=True, hide=True, timeout=None):
        self.commands.append((host, command))

    def run_background(self, host, command, log_file, append=False,
                       timeout=None):
        tag = "BGA" if append else "BG"
        self.commands.append((host, f"{tag}[{log_file}] {command}"))
        self.last_background_timeout = timeout

    def put(self, host, local, remote, timeout=None):
        self.uploads.append((host, local, remote))

    def get(self, host, remote, local, timeout=None):
        pass


class LocalShellRunner(RemoteRunner):
    """Fake ssh transport that really executes: `_ssh_base` resolves to
    a local ``sh -c`` instead of an ssh argv, so the quoting/timeout
    behavior of run/run_background is tested against a real shell."""

    def __init__(self):
        super().__init__("nobody", "/dev/null")

    def _ssh_base(self, host):
        return ["sh", "-c"]


# ---------------------------------------------------------------------------
# RemoteRunner transport discipline (quoting + timeouts)
# ---------------------------------------------------------------------------


def test_run_background_quoting_survives_single_quotes(tmp_path):
    """The graftwan regression: boot commands legitimately carry single
    quotes (pkill patterns, --nodes lists); the old ``sh -c '{cmd}'``
    wrapper broke on every one.  Through a REAL shell, the quoted
    wrapper must execute the command verbatim."""
    runner = LocalShellRunner()
    out = tmp_path / "out.log"
    runner.run_background(
        "h", f"printf '%s' \"it's quoted\"", str(out))
    deadline = __import__("time").monotonic() + 5
    while __import__("time").monotonic() < deadline:
        if out.exists() and out.read_text() == "it's quoted":
            break
        __import__("time").sleep(0.05)
    assert out.read_text() == "it's quoted"


def test_run_background_append_mode_preserves_prior_log(tmp_path):
    """Fault-plan restarts reboot on the same log in APPEND mode: the
    pre-fault log is parser evidence and must survive."""
    runner = LocalShellRunner()
    out = tmp_path / "node.log"
    out.write_text("before-fault\n")
    runner.run_background("h", "echo after-fault", str(out), append=True)
    deadline = __import__("time").monotonic() + 5
    while __import__("time").monotonic() < deadline:
        if "after-fault" in (out.read_text() if out.exists() else ""):
            break
        __import__("time").sleep(0.05)
    assert out.read_text() == "before-fault\nafter-fault\n"


def test_run_times_out_on_hung_remote_command():
    """ssh ConnectTimeout bounds the dial, not a hung remote command;
    the subprocess timeout must surface a wedged host as an error."""
    runner = LocalShellRunner()
    with pytest.raises(ExecutionError) as exc:
        runner.run("h", "sleep 30", timeout=0.2)
    assert "hung past" in str(exc.value)
    # A healthy command inside the bound returns its result.
    result = runner.run("h", "echo ok")
    assert result.returncode == 0 and "ok" in result.stdout


def test_run_background_wrapper_is_shell_parseable():
    """The wrapped background command must stay ONE well-formed shell
    word list even for hostile payloads (quotes, globs, redirects)."""

    class WrapperRecorder(RemoteRunner):
        """Real run_background wrapper; only the transport is stubbed."""

        def __init__(self):
            super().__init__("ubuntu", "/tmp/k.pem")
            self.commands = []

        def run(self, host, command, check=True, hide=True, timeout=None):
            self.commands.append((host, command))

    runner = WrapperRecorder()
    cmd = "pkill -f './node run' && echo \"done\" ; ls *"
    runner.run_background("h", cmd, "/tmp/l.log")
    _, wrapped = runner.commands[-1]
    # Strip only the TRAILING backgrounding '&' (the payload's own '&&'
    # must survive inside the quoted argv element), then shlex round
    # trip: the command is a single sh -c argument, bit-identical.
    assert wrapped.rstrip().endswith("&")
    words = shlex.split(wrapped.rstrip().rstrip("&"))
    assert words[0] == "nohup" and words[3] == "-c"
    assert words[4] == cmd


# ---------------------------------------------------------------------------
# Bench orchestration
# ---------------------------------------------------------------------------


def test_install_and_update_commands(settings):
    bench = Bench(settings, SETTINGS["hosts"])
    bench.runner = runner = RecordingRunner()
    bench.install()
    assert len(runner.commands) == 4
    assert all("apt-get" in c and "git clone" in c
               for _, c in runner.commands)
    runner.commands.clear()
    bench.update()
    assert all("git checkout -f main" in c and "cmake" in c
               for _, c in runner.commands)


class FakeCommittee:
    def __init__(self, hosts):
        self.hosts = hosts

    def front_addresses(self):
        return [f"{h}:6000" for h in self.hosts]


def test_run_single_spawns_nodes_and_clients(settings, tmp_path, monkeypatch):
    """One node + one client per alive host; faulty hosts run nothing;
    clients wait only on alive fronts (remote.py:179-225 analogue)."""
    monkeypatch.chdir(tmp_path)
    hosts = SETTINGS["hosts"]
    bench = Bench(settings, hosts)
    bench.runner = runner = RecordingRunner()

    import hotstuff_tpu_torch.harness.remote as remote_mod
    monkeypatch.setattr(remote_mod, "sleep", lambda s: None)

    bench._run_single(hosts, FakeCommittee(hosts), rate=1000, tx_size=512,
                      faults=1, duration=0, timeout=5_000)
    bg = [c for _, c in runner.commands if c.startswith("BG")]
    node_cmds = [c for c in bg if "./node run" in c]
    client_cmds = [c for c in bg if "./client " in c]
    assert len(node_cmds) == 3 and len(client_cmds) == 3  # 4 hosts - 1 fault
    # Clients split the rate over alive nodes (ceil(1000/3) = 334) and wait
    # only on alive fronts.
    assert all("--rate 334" in c for c in client_cmds)
    assert all("10.0.0.4" not in c for c in client_cmds)
    # The kill sweep hits every host, including the faulty one.
    kills = [h for h, c in runner.commands if "pkill" in c]
    assert set(kills) == set(hosts)


def test_run_single_executes_fault_plan_and_wan(settings, tmp_path,
                                                monkeypatch):
    """graftwan ordering: tc shaping installs BEFORE any node boots,
    plan events run inside the run window (after boot, before the kill
    sweep), executed events come back for the log step, and teardown
    clears the qdiscs even though the plan faulted a link mid-run."""
    monkeypatch.chdir(tmp_path)
    hosts = SETTINGS["hosts"]
    bench = Bench(settings, hosts,
                  fault_plan="0.05 node:1 kill; 0.1 link:ab partition; "
                             "0.15 link:ab heal",
                  wan="node:0>node:1 latency_ms=40 name=ab")
    bench.runner = runner = RecordingRunner()

    import hotstuff_tpu_torch.harness.remote as remote_mod
    real_sleep = __import__("time").sleep
    monkeypatch.setattr(remote_mod, "sleep",
                        lambda s: real_sleep(min(s, 0.6)))

    events = bench._run_single(hosts, FakeCommittee(hosts), rate=1000,
                               tx_size=512, faults=0, duration=1,
                               timeout=100)
    assert [e["action"] for e in events] == ["kill", "partition", "heal"]
    assert all(e["ok"] for e in events), events
    cmds = [c for _, c in runner.commands]

    def first(pred, start=0):
        return next(i for i, c in enumerate(cmds) if i >= start and pred(c))

    setup_tc = first(lambda c: "tc qdisc add" in c and "netem" in c)
    first_boot = first(lambda c: c.startswith("BG") and "./node run" in c)
    plan_kill = first(lambda c: "pkill -KILL" in c)
    partition = first(lambda c: "tc qdisc change" in c and "loss 100%" in c)
    heal = first(lambda c: "tc qdisc change" in c and "delay 40ms" in c)
    # setup itself opens with a best-effort del; the teardown we want is
    # the sweep-time one AFTER the heal.
    teardown_tc = first(lambda c: "tc qdisc del" in c, start=heal + 1)
    sweep = first(lambda c: "pkill -f '[.]/node run'" in c, start=heal + 1)
    assert setup_tc < first_boot < plan_kill < partition < heal
    assert heal < teardown_tc and heal < sweep
    # The plan's node kill targeted node 1's host, and only it.
    kill_hosts = [h for h, c in runner.commands if "pkill -KILL" in c]
    assert kill_hosts == ["10.0.0.2"]


def test_check_fault_plan_rejects_unexecutable_matrix(settings):
    """The LocalBench contract on the fleet: a scripted scenario the
    deployment cannot deliver fails BEFORE any host is touched."""
    from hotstuff_tpu_torch.harness.utils import BenchError

    hosts = SETTINGS["hosts"]

    def check(plan=None, wan=None, duration=30, faults=0):
        bench = Bench(settings, hosts, fault_plan=plan, wan=wan)
        bench._check_fault_plan(hosts, duration, 5_000, faults=faults)

    check(plan="5 node:1 kill")  # executable: passes
    with pytest.raises(BenchError) as exc:
        check(plan="5 node:3 kill", faults=1)
    assert "crash-fault hosts run nothing" in str(exc.value)
    with pytest.raises(BenchError) as exc:
        check(plan="29 node:1 kill", duration=30)
    assert "headroom" in str(exc.value)
    with pytest.raises(BenchError) as exc:
        check(plan="5 sidecar kill; 8 sidecar restart")
    assert "local-harness only" in str(exc.value)
    with pytest.raises(BenchError) as exc:
        check(plan="5 link:xx partition; 8 link:xx heal",
              wan="node:0>node:1 latency_ms=10 name=ab")
    assert "does not name" in str(exc.value)
    with pytest.raises(BenchError):
        Bench(settings, hosts, fault_plan="nonsense")
    with pytest.raises(BenchError):
        Bench(settings, hosts, wan="nonsense")
    with pytest.raises(BenchError):
        Bench(settings, hosts, slos="warp-drive=1")


def test_check_wan_rejects_unrealizable_endpoints(settings):
    """tc shapes only node:<i> egress on the fleet; a spec naming
    sidecar/client (or a replica that will not boot) would compile to
    zero commands yet still be recorded as WAN-shaped (wan.json +
    parser notes) — a clean-LAN run published as a shaped measurement.
    The pre-flight must reject it before any host is touched."""
    from hotstuff_tpu_torch.harness.utils import BenchError

    hosts = SETTINGS["hosts"]

    def check(wan, faults=0):
        Bench(settings, hosts, wan=wan)._check_wan(hosts, faults=faults)

    check("node:0>node:1 latency_ms=40 name=ab")  # realizable: passes
    check("*>node:1 latency_ms=40 name=wild")     # wildcard src is fine
    with pytest.raises(BenchError) as exc:
        check("node:0>sidecar latency_ms=100 name=sc")
    assert "local-harness only" in str(exc.value)
    with pytest.raises(BenchError):
        check("client>node:0 latency_ms=100 name=cl")
    with pytest.raises(BenchError) as exc:  # dst beyond the alive fleet
        check("node:0>node:3 latency_ms=40 name=dead", faults=1)
    assert "node:0..node:2" in str(exc.value)


def test_run_keeps_matrix_going_and_evidence_when_plan_stalls(
        settings, monkeypatch):
    """A stalled fault plan in one cell must not abort the whole
    matrix, and the under-executed run's logs are STILL downloaded —
    the partial chaos-events.json is the diagnosis evidence."""
    from hotstuff_tpu_torch.harness.config import BenchParameters, \
        NodeParameters

    hosts = SETTINGS["hosts"]
    bench = Bench(settings, hosts, fault_plan="1 node:0 kill")
    bench.runner = RecordingRunner()
    calls = {"run_single": 0, "logs": 0, "printed": 0}

    def fake_run_single(*a, **k):
        calls["run_single"] += 1
        return []  # plan stalled: 0 of 1 events executed

    class FakeParser:
        def print(self, filename):
            calls["printed"] += 1

    def fake_logs(hosts, faults, chaos_events=None):
        calls["logs"] += 1
        assert chaos_events == []  # the partial evidence is persisted
        return FakeParser()

    monkeypatch.setattr(bench, "_config",
                        lambda hosts, params: FakeCommittee(hosts))
    monkeypatch.setattr(bench, "_run_single", fake_run_single)
    monkeypatch.setattr(bench, "_logs", fake_logs)
    bench_params = BenchParameters({
        "nodes": [4], "rate": [1_000, 2_000], "tx_size": 512,
        "faults": 0, "duration": 30})
    node_params = NodeParameters({
        "consensus": {"timeout_delay": 1_000, "sync_retry_delay": 5_000},
        "mempool": {"gc_depth": 50, "sync_retry_delay": 5_000,
                    "sync_retry_nodes": 3, "batch_size": 100,
                    "max_batch_delay": 100}})
    bench.run(bench_params, node_params)  # must NOT raise
    # Both rate cells ran despite the first one's stalled plan, every
    # cell's logs were downloaded before the verdict — and NO result
    # file was published (a run whose scenario never finished must not
    # aggregate as a passing chaos cell).
    assert calls == {"run_single": 2, "logs": 2, "printed": 0}


def test_logs_persists_chaos_context(settings, tmp_path, monkeypatch):
    """The downloaded logs dir gets the same on-disk contract the local
    harness writes (chaos-events.json / wan.json / slo.json), and the
    parser judges the fleet run through it — recovery latencies AND SLO
    verdicts from golden logs."""
    from test_harness import GOLDEN_CLIENT, GOLDEN_NODE
    from datetime import datetime, timezone

    monkeypatch.chdir(tmp_path)
    hosts = SETTINGS["hosts"][:1]
    bench = Bench(settings, hosts,
                  wan="node:0>node:1 latency_ms=40 name=ab",
                  slos={"node-kill": 9_000})

    class GetRunner(RecordingRunner):
        def get(self, host, remote, local, timeout=None):
            content = GOLDEN_NODE if "node" in local else GOLDEN_CLIENT
            with open(local, "w") as f:
                f.write(content)

    bench.runner = GetRunner()
    wall = datetime(2026, 7, 29, 14, 54, 57, 0,
                    tzinfo=timezone.utc).timestamp() - 0.1
    events = [{"t": 5.0, "target": "node:0", "action": "kill",
               "wall": wall, "ok": True}]
    parser = bench._logs(hosts, faults=0, chaos_events=events)
    out = parser.result()
    assert "Chaos SLO node-kill" in out and "PASS" in out
    assert "WAN: 1 shaped link(s)" in out
    assert json.load(open("logs/chaos-events.json")) == events
    assert json.load(open("logs/wan.json"))["links"][0]["name"] == "ab"
    assert json.load(open("logs/slo.json"))["node-kill"] == 9_000


# ---------------------------------------------------------------------------
# RemoteFaultInjector
# ---------------------------------------------------------------------------


def _injector(runner, wan=None, **kwargs):
    from hotstuff_tpu_torch.chaos import parse_wan
    from hotstuff_tpu_torch.harness.faults import RemoteFaultInjector

    hosts = SETTINGS["hosts"]
    return RemoteFaultInjector(
        runner, hosts, "repo",
        {i: (f"./node run --keys .node-{i}.json", f"repo/logs/node-{i}.log")
         for i in range(len(hosts))},
        wan=parse_wan(wan) if wan else None,
        peers={f"node:{i}": h for i, h in enumerate(hosts)}, **kwargs)


def _ev(target, action, params=None):
    from hotstuff_tpu_torch.chaos.plan import FaultEvent

    return FaultEvent(t=0.0, target=target, action=action,
                      params=params or {})


def test_remote_injector_node_signals_and_restart():
    runner = RecordingRunner()
    inj = _injector(runner)
    inj.apply(_ev("node:2", "kill"))
    inj.apply(_ev("node:1", "pause"))
    inj.apply(_ev("node:0", "restart"))
    cmds = dict(host=[h for h, _ in runner.commands],
                text=[c for _, c in runner.commands])
    # The bracketed-dot pattern must never match the ssh wrapper
    # shell's own cmdline (a -STOP that hits the wrapper parks the
    # ssh session until the transport timeout).
    assert ("10.0.0.3", "pkill -KILL -f '[.]/node run'") in runner.commands
    assert ("10.0.0.2", "pkill -STOP -f '[.]/node run'") in runner.commands
    import re

    for _, c in runner.commands:
        if "pkill" in c:
            pat = c.split("-f ", 1)[1].strip("'")
            assert not re.search(pat, c), f"self-matching pkill: {c}"
    # restart re-runs the recorded boot in APPEND mode on its own host,
    # under the injection bound — never the transport's install-sized
    # default (a wedged host must fail the EVENT, not park the runner).
    assert any(h == "10.0.0.1" and c.startswith("BGA[repo/logs/node-0.log]")
               for h, c in runner.commands)
    assert runner.last_background_timeout == inj.INJECT_TIMEOUT_S
    # cleanup SIGCONTs the paused straggler
    inj.cleanup()
    assert ("10.0.0.2", "pkill -CONT -f '[.]/node run'") in runner.commands


def test_remote_injector_failures_are_injection_errors():
    from hotstuff_tpu_torch.harness.faults import InjectionError

    class FailingRunner(RecordingRunner):
        def run(self, host, command, check=True, hide=True, timeout=None):
            raise ExecutionError(f"[{host}] boom")

    inj = _injector(FailingRunner())
    with pytest.raises(InjectionError):
        inj.apply(_ev("node:0", "kill"))
    with pytest.raises(InjectionError):  # out-of-fleet index
        _injector(RecordingRunner()).apply(_ev("node:9", "kill"))
    with pytest.raises(InjectionError):  # restart without a boot record
        from hotstuff_tpu_torch.harness.faults import RemoteFaultInjector

        RemoteFaultInjector(RecordingRunner(), ["10.0.0.1"], "repo",
                            {}).apply(_ev("node:0", "restart"))


def test_remote_injector_link_partition_heal_compiles_tc():
    runner = RecordingRunner()
    inj = _injector(runner, wan="node:0>node:1 latency_ms=40 name=ab")
    inj.apply(_ev("link:ab", "partition"))
    # Only node 0's egress carries the directed link.
    assert runner.commands == [
        ("10.0.0.1", "sudo tc qdisc change dev eth0 parent 1:4 "
                     "handle 40: netem loss 100%")]
    runner.commands.clear()
    inj.apply(_ev("link:ab", "heal"))
    assert runner.commands == [
        ("10.0.0.1", "sudo tc qdisc change dev eth0 parent 1:4 "
                     "handle 40: netem delay 40ms")]


def test_remote_injector_link_and_sidecar_need_configuration():
    from hotstuff_tpu_torch.harness.faults import InjectionError

    inj = _injector(RecordingRunner())  # no wan, no sidecar host
    with pytest.raises(InjectionError) as exc:
        inj.apply(_ev("link:ab", "partition"))
    assert "shapes no WAN" in str(exc.value)
    with pytest.raises(InjectionError) as exc:
        inj.apply(_ev("sidecar", "kill"))
    assert "runs none" in str(exc.value)

    runner = RecordingRunner()
    inj = _injector(runner, sidecar_host="10.0.0.9",
                    sidecar_boot=("python -m hotstuff_tpu_torch.sidecar",
                                  "repo/logs/sidecar.log"))
    inj.apply(_ev("sidecar", "kill"))
    inj.apply(_ev("sidecar", "restart"))
    inj.apply(_ev("sidecar", "degrade", {"delay_ms": 100}))
    texts = [c for _, c in runner.commands]
    assert any("pkill -KILL" in c for c in texts)
    assert any(c.startswith("BGA[repo/logs/sidecar.log]") for c in texts)
    # the chaos RPC originates next to the sidecar, on its host
    rpc = [c for h, c in runner.commands if h == "10.0.0.9"
           and "SidecarClient" in c]
    assert rpc and "delay_ms" in rpc[0]


# ---------------------------------------------------------------------------
# plots
# ---------------------------------------------------------------------------


def test_plot_matrix_draws_from_matrix_json(tmp_path, monkeypatch):
    matplotlib = pytest.importorskip("matplotlib")  # noqa: F841
    from hotstuff_tpu_torch.harness.plot import Ploter, PlotError

    monkeypatch.chdir(tmp_path)
    with pytest.raises(PlotError):
        Ploter().plot_matrix()  # no aggregate yet
    (tmp_path / "plots").mkdir()
    (tmp_path / "plots" / "matrix.json").write_text(json.dumps({
        "0-512": {"faults": 0, "tx_size": 512, "nodes": [4, 10],
                  "rates": [1000], "cells": {
                      "4-1000": {"tps": 900, "latency_ms": 50},
                      "10-1000": {"tps": 700, "latency_ms": 90,
                                  "chaos": {"slo_pass": 1, "slo_fail": 0,
                                            "runs_with_chaos": 1,
                                            "wan": None}}}}}))
    Ploter().plot_matrix()
    assert (tmp_path / "plots" / "matrix.png").exists()
    assert (tmp_path / "plots" / "matrix.pdf").exists()


# ---------------------------------------------------------------------------
# grafttrace: per-host clock offsets through the ssh transport
# ---------------------------------------------------------------------------


def test_clock_offsets_probed_and_persisted(tmp_path, monkeypatch):
    """_clock_offsets: one RTT-midpoint probe per alive host through the
    runner, persisted keyed by log file name for the trace merger."""
    import os
    import time

    monkeypatch.chdir(tmp_path)
    os.makedirs("logs")
    skew = 2.0

    class FakeRunner:
        def run(self, host, command, timeout=None):
            assert command == "date +%s.%N"
            assert timeout is not None  # transport discipline holds

            class R:
                stdout = f"{time.time() + skew:.9f}\n"

            return R()

    bench = Bench.__new__(Bench)
    bench.runner = FakeRunner()
    bench._clock_offsets(["10.0.0.1", "10.0.0.2"])
    with open("logs/clock-offsets.json") as f:
        offsets = json.load(f)
    assert set(offsets) == {"node-0.log", "node-1.log"}
    assert all(1.5 < v < 2.5 for v in offsets.values())


def test_clock_offsets_tolerates_dead_hosts(tmp_path, monkeypatch):
    import os

    monkeypatch.chdir(tmp_path)
    os.makedirs("logs")

    class DeadRunner:
        def run(self, host, command, timeout=None):
            raise ExecutionError("unreachable")

    bench = Bench.__new__(Bench)
    bench.runner = DeadRunner()
    bench._clock_offsets(["10.0.0.1"])  # must not raise
    assert not os.path.exists("logs/clock-offsets.json")


# ---------------------------------------------------------------------------
# parity: each scenario's commands equal the reference's
# ---------------------------------------------------------------------------


def _recorder(pkg):
    """A command-recording runner built on ``pkg``'s RemoteRunner."""
    import importlib

    base = importlib.import_module(f"{pkg}.harness.remote").RemoteRunner

    class Recorder(base):
        def __init__(self):
            super().__init__("ubuntu", "/tmp/k.pem")
            self.commands = []

        def run(self, host, command, check=True, hide=True, timeout=None):
            self.commands.append((host, command))

        def run_background(self, host, command, log_file, append=False,
                           timeout=None):
            self.commands.append(
                (host, f"{'BGA' if append else 'BG'}[{log_file}] {command}"))

        def put(self, host, local, remote, timeout=None):
            self.commands.append((host, f"PUT {local} {remote}"))

        def get(self, host, remote, local, timeout=None):
            pass

    return Recorder()


def _bench_commands(pkg, settings_path, scenario, monkeypatch):
    import importlib

    remote = importlib.import_module(f"{pkg}.harness.remote")
    cfg = importlib.import_module(f"{pkg}.harness.settings")
    settings = cfg.Settings.load(settings_path)
    hosts = SETTINGS["hosts"]
    monkeypatch.setattr(remote, "sleep", lambda s: None)
    if scenario == "install":
        bench = remote.Bench(settings, hosts)
        bench.runner = _recorder(pkg)
        bench.install()
        bench.update()
        bench.kill()
        return bench.runner.commands
    bench = remote.Bench(settings, hosts)
    bench.runner = _recorder(pkg)
    bench._run_single(hosts, FakeCommittee(hosts), rate=1000, tx_size=512,
                      faults=1, duration=0, timeout=5_000)
    return bench.runner.commands


@pytest.mark.parametrize("scenario", ["install", "run_single"])
def test_fleet_commands_equal_the_reference(scenario, tmp_path, monkeypatch):
    path = tmp_path / "settings.json"
    path.write_text(json.dumps(SETTINGS))
    monkeypatch.chdir(tmp_path)
    ref = _bench_commands("hotstuff_tpu", str(path), scenario, monkeypatch)
    port = _bench_commands("hotstuff_tpu_torch", str(path), scenario,
                           monkeypatch)
    assert ref and port == ref


@pytest.mark.parametrize("event", [
    ("node:2", "kill", {}), ("node:1", "pause", {}), ("node:1", "resume", {}),
    ("node:0", "restart", {}), ("link:ab", "partition", {}),
    ("link:ab", "heal", {}), ("sidecar", "kill", {}),
    ("sidecar", "restart", {}), ("sidecar", "degrade", {"delay_ms": 100}),
    ("sidecar", "wedge", {"n": 2}),
])
def test_remote_injector_commands_equal_the_reference(event):
    """The same event through both injectors sends the same commands to
    the same hosts, but for the sidecar module each package names (its
    pkill pattern and its OP_CHAOS one-liner)."""
    import importlib

    hosts = SETTINGS["hosts"]
    out = []
    for pkg in ("hotstuff_tpu", "hotstuff_tpu_torch"):
        faults = importlib.import_module(f"{pkg}.harness.faults")
        plan = importlib.import_module(f"{pkg}.chaos.plan")
        parse_wan = importlib.import_module(f"{pkg}.chaos").parse_wan
        runner = _recorder(pkg)
        inj = faults.RemoteFaultInjector(
            runner, hosts, "repo",
            {i: (f"./node run --keys .node-{i}.json",
                 f"repo/logs/node-{i}.log") for i in range(len(hosts))},
            wan=parse_wan("node:0>node:1 latency_ms=40 name=ab"),
            peers={f"node:{i}": h for i, h in enumerate(hosts)},
            sidecar_host="10.0.0.9",
            sidecar_boot=(f"python -m {pkg}.sidecar",
                          "repo/logs/sidecar.log"))
        target, action, params = event
        inj.apply(plan.FaultEvent(t=0.0, target=target, action=action,
                                  params=params))
        out.append([(h, c.replace("hotstuff_tpu_torch", "hotstuff_tpu"))
                    for h, c in runner.commands])
    assert out[0] and out[1] == out[0]
