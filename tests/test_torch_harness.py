"""The port's harness/ (configs, commands, the log parser and aggregator,
LocalBench's boot path, the CLI) against the JAX package's: the same
inputs through both, the same JSON, command strings, summaries and
notes.  Where the port departs from the reference (the sidecar module,
no degrade to host crypto, the stale-process sweep, the unported
commands) the test pins the port's behaviour.

Host code only; one test boots the port's ``--host-crypto`` sidecar
(no card, no kernel build) for an OP_STATS snapshot and its spans.
"""

import copy
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

import hotstuff_tpu.harness as R
import hotstuff_tpu_torch.harness as P
from hotstuff_tpu.harness import __main__ as R_main
from hotstuff_tpu.harness import aggregate as R_agg
from hotstuff_tpu.harness import commands as R_cmd
from hotstuff_tpu.harness import config as R_cfg
from hotstuff_tpu.harness import local as R_local
from hotstuff_tpu.harness import settings as R_settings
from hotstuff_tpu.harness import utils as R_utils
from hotstuff_tpu_torch.harness import __main__ as P_main
from hotstuff_tpu_torch.harness import aggregate as P_agg
from hotstuff_tpu_torch.harness import commands as P_cmd
from hotstuff_tpu_torch.harness import config as P_cfg
from hotstuff_tpu_torch.harness import local as P_local
from hotstuff_tpu_torch.harness import settings as P_settings
from hotstuff_tpu_torch.harness import utils as P_utils
from test_harness import GOLDEN_CLIENT, GOLDEN_NODE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden_logs")
PORT_MODULE = "hotstuff_tpu_torch.sidecar"
REF_MODULE = "hotstuff_tpu.sidecar"


def _as_ref(cmd: str) -> str:
    """A port command with the reference's sidecar module in it."""
    return cmd.replace(PORT_MODULE, REF_MODULE)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

NODE_PARAMS = [
    {},
    {"tpu_sidecar": "127.0.0.1:7100"},
    {"tpu_sidecar": "127.0.0.1:7100", "scheme": "bls"},
    {"tpu_sidecar": ["127.0.0.1:7100", "127.0.0.1:7101"], "tenant": "node"},
    {"chain": 3, "dag": True},
]


@pytest.mark.parametrize("kw", NODE_PARAMS)
def test_node_parameters_json_equal(tmp_path, kw):
    r = R_cfg.NodeParameters.default(**kw)
    p = P_cfg.NodeParameters.default(**kw)
    assert p.json == r.json and p.timeout_delay == r.timeout_delay
    r.print(str(tmp_path / "r.json"))
    p.print(str(tmp_path / "p.json"))
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "r.json").read_text()


@pytest.mark.parametrize("key,bad", [
    ("timeout_backoff_factor_pct", 50), ("timeout_jitter_pct", 101),
    ("timeout_backoff_cap", 0), ("timeout_future_horizon", 0),
    ("chain_depth", 9), ("timeout_delay", "soon"),
])
def test_node_parameters_rejections_agree(key, bad):
    out = []
    for cfg in (R_cfg, P_cfg):
        data = cfg.NodeParameters.default().json
        data["consensus"][key] = bad
        with pytest.raises(cfg.ConfigError) as exc:
            cfg.NodeParameters(data)
        out.append(str(exc.value))
    assert out[1] == out[0]


BENCH_PARAMS = [
    {"faults": 1, "nodes": 4, "rate": [10_000], "tx_size": 512,
     "duration": 20},
    {"faults": 0, "nodes": [4], "rate": 100_000, "tx_size": 512,
     "duration": 20, "tpu_sidecar": True, "sidecar_warm_rlc": True,
     "scheme": "ed25519"},
    {"faults": 0, "nodes": [4], "rate": 100_000, "tx_size": 512,
     "duration": 20, "tpu_sidecar": True, "scheme": "bls"},
    {"faults": 0, "nodes": [20], "rate": 50_000, "tx_size": 512,
     "duration": 30, "sidecar_host_crypto": True, "sidecar_fleet": 2,
     "verify_ingress": True, "forge_pct": 5, "client_shards": 2},
]


@pytest.mark.parametrize("params", BENCH_PARAMS)
def test_bench_parameters_equal(params):
    r = R_cfg.BenchParameters(copy.deepcopy(params))
    p = P_cfg.BenchParameters(copy.deepcopy(params))
    assert vars(p) == vars(r)


@pytest.mark.parametrize("params", [
    {"faults": 4, "nodes": 4, "rate": 1000, "tx_size": 512, "duration": 20},
    {"faults": 0, "nodes": 4, "rate": 1000, "tx_size": 512, "duration": 20,
     "sidecar_fleet": 2},
    {"faults": 0, "nodes": 4, "rate": 1000, "duration": 20},
])
def test_bench_parameters_rejections_agree(params):
    out = []
    for cfg in (R_cfg, P_cfg):
        with pytest.raises(cfg.ConfigError) as exc:
            cfg.BenchParameters(copy.deepcopy(params))
        out.append(str(exc.value))
    assert out[1] == out[0]


@pytest.mark.parametrize("scheme", ["ed25519", "bls"])
def test_committee_and_keys_equal(tmp_path, monkeypatch, scheme):
    """The committee file of both packages, and under scheme=bls the
    BLS keys each writes into the key files, from the same randomness."""
    import secrets

    names = [f"name{i}=" for i in range(4)]
    out = []
    for tag, cfg in (("r", R_cfg), ("p", P_cfg)):
        d = tmp_path / tag
        d.mkdir()
        draws = iter(range(1, 100))
        monkeypatch.setattr(secrets, "randbelow",
                            lambda n: next(draws) * 7919 % n)
        pubkeys = None
        if scheme == "bls":
            files = []
            for i, name in enumerate(names):
                f = d / f"key-{i}.json"
                f.write_text(json.dumps({"name": name, "secret": "s="}))
                files.append(str(f))
            pubkeys = cfg.add_bls_keys(files, names)
        committee = cfg.LocalCommittee(names, 9000, bls_pubkeys=pubkeys)
        committee.print(str(d / "committee.json"))
        twin = cfg.twin_committee(committee, 0, 9900)
        out.append(({f.name: f.read_text() for f in sorted(d.iterdir())},
                    twin))
    assert out[1] == out[0]
    assert len(out[1][0]) == (5 if scheme == "bls" else 1)


def test_key_file_and_settings_read_alike(tmp_path):
    key = tmp_path / "key.json"
    key.write_text(json.dumps({"name": "abc=", "secret": "xyz="}))
    r, p = R_cfg.Key.from_file(str(key)), P_cfg.Key.from_file(str(key))
    assert (p.name, p.secret) == (r.name, r.secret)
    settings = os.path.join(REPO, "settings.json")
    assert vars(P_settings.Settings.load(settings)) == \
        vars(R_settings.Settings.load(settings))
    for bad in (str(tmp_path / "absent.json"), str(key)):
        errs = []
        for mod in (R_settings, P_settings):
            with pytest.raises(mod.SettingsError) as exc:
                mod.Settings.load(bad)
            errs.append(str(exc.value))
        assert errs[1] == errs[0]


# ---------------------------------------------------------------------------
# commands and paths
# ---------------------------------------------------------------------------

def test_path_maker_equal():
    names = [n for n in dir(R_utils.PathMaker) if not n.startswith("_")]
    assert names == [n for n in dir(P_utils.PathMaker)
                     if not n.startswith("_")]
    for name in names:
        r, p = getattr(R_utils.PathMaker, name), getattr(P_utils.PathMaker,
                                                         name)
        value = {"type": "tps", "name": "latency", "ext": "pdf", "i": 3,
                 "j": 1, "faults": 1, "nodes": 4, "rate": 1000,
                 "tx_size": 512, "chain": 3, "max_latency": 3000}
        params = r.__code__.co_varnames[:r.__code__.co_argcount]
        args = [value[a] for a in params]
        assert p(*args) == r(*args), name
        if r.__defaults__:
            short = args[:len(args) - len(r.__defaults__)]
            assert p(*short) == r(*short), name


@pytest.mark.parametrize("call", [
    ("cleanup",), ("clean_logs",), ("compile",), ("kill",),
    ("generate_key", ".node-0.json"),
    ("run_node", ".node-0.json", ".committee.json", ".db-0",
     ".parameters.json"),
    ("run_node", ".node-1.json", ".committee.json", ".db-1",
     ".parameters.json", True),
    ("run_client", "127.0.0.1:9004", 512, 25_000, 1000),
    ("run_client", "127.0.0.1:9004", 512, 25_000, 1000,
     ["127.0.0.1:9004", "127.0.0.1:9005"], 1000, 7, True, 2.5, 1 << 24,
     1 << 32),
    ("alias_binaries", "native/build"),
])
def test_command_strings_equal(call):
    name, *args = call
    assert getattr(P_cmd.CommandMaker, name)(*args) == \
        getattr(R_cmd.CommandMaker, name)(*args)


def test_sidecar_command_differs_only_by_module():
    r = R_cmd.CommandMaker.run_sidecar(7100, "logs/sidecar.log")
    p = P_cmd.CommandMaker.run_sidecar(7100, "logs/sidecar.log")
    assert PORT_MODULE in p and _as_ref(p) == r


# ---------------------------------------------------------------------------
# LocalBench's sidecar boot
# ---------------------------------------------------------------------------

BOOTS = [
    ("ed25519 device rlc", {"tpu_sidecar": True, "sidecar_warm_rlc": True},
     False),
    ("ed25519 host", {"sidecar_host_crypto": True}, True),
    ("bls device", {"tpu_sidecar": True, "scheme": "bls"}, False),
    ("bls host, 20 nodes", {"scheme": "bls", "sidecar_host_crypto": True,
                            "nodes": 20}, True),
    ("mesh", {"tpu_sidecar": True, "sidecar_mesh": 4}, False),
    ("fleet", {"sidecar_host_crypto": True, "sidecar_fleet": 2}, True),
    ("wan sidecar link", {"sidecar_host_crypto": True,
                          "wan": "node:0>sidecar latency_ms=40"}, True),
]


def _local(module, extra):
    params = {"faults": 0, "nodes": 4, "rate": 100_000, "tx_size": 512,
              "duration": 20, **extra}
    return module.LocalBench(module_cfg(module).BenchParameters(params))


def module_cfg(module):
    return R_cfg if module is R_local else P_cfg


def _boot(module, extra, host_crypto):
    bench = _local(module, extra)
    booted = []
    bench._background_run = \
        lambda cmd, log, append=False: booted.append((cmd, log, append))
    bench._wait_sidecar_ready = lambda deadline_s, index=None: None
    bench._boot_sidecars(host_crypto=host_crypto)
    return bench, booted


@pytest.mark.parametrize("name,extra,host_crypto", BOOTS,
                         ids=[b[0] for b in BOOTS])
def test_boot_commands_differ_only_by_module(name, extra, host_crypto):
    r_bench, r_booted = _boot(R_local, extra, host_crypto)
    p_bench, p_booted = _boot(P_local, extra, host_crypto)
    assert p_bench.node_parameters.json == r_bench.node_parameters.json
    assert len(p_booted) == len(r_booted) >= 1
    for (p_cmd, p_log, _), (r_cmd, r_log, _) in zip(p_booted, r_booted):
        assert p_cmd.startswith(f"python -m {PORT_MODULE} ")
        assert _as_ref(p_cmd) == r_cmd and p_log == r_log
        assert re.search(P_local.LocalBench.SIDECAR_SWEEP, p_cmd)
        assert not re.search(r"hotstuff_tpu\.sidecar", p_cmd)
    assert {ix: (_as_ref(cmd), log)
            for ix, (cmd, log) in p_bench._sidecar_cmds.items()} == \
        r_bench._sidecar_cmds


def test_device_sidecar_that_never_answers_fails_without_degrading(
        monkeypatch):
    """No degrade: a device sidecar that never answers a PING is killed
    and the run fails with BenchError naming the sidecar's log; no
    --host-crypto sidecar is booted in its place (the reference boots
    one, tests/test_harness.py::test_sidecar_boot_degrades_to_host_crypto)."""
    from conftest import free_port

    for extra in ({"tpu_sidecar": True}, {"scheme": "bls"}):
        bench = _local(P_local, extra)
        booted, kills = [], []
        bench._background_run = \
            lambda cmd, log, append=False: booted.append(cmd)
        bench._kill_nodes = lambda: kills.append(True)
        bench.SIDECAR_PORT = free_port()      # nothing listens there
        bench.DEVICE_READY_S = {"ed25519": 1, "bls": 1}
        with pytest.raises(P_utils.BenchError) as exc:
            bench._boot_sidecars(host_crypto=False)
        assert str(exc.value) == \
            f"Verify sidecar failed to become ready; see " \
            f"{P_utils.PathMaker.sidecar_log_file()}"
        assert len(booted) == 1 and "--host-crypto" not in booted[0]
        assert kills, "the unready sidecar was not swept"

    # the fleet: every member booted once, none rebooted in host mode
    bench = _local(P_local, {"tpu_sidecar": True, "sidecar_fleet": 2})
    booted, kills = [], []
    bench._background_run = lambda cmd, log, append=False: booted.append(cmd)
    bench._kill_nodes = lambda: kills.append(True)

    def never_ready(deadline_s, index=None):
        raise P_utils.BenchError("not ready")

    bench._wait_sidecar_ready = never_ready
    with pytest.raises(P_utils.BenchError):
        bench._boot_sidecars(host_crypto=False)
    assert len(booted) == 2 and kills
    assert not any("--host-crypto" in cmd for cmd in booted)


@pytest.mark.parametrize("extra,budget", [
    ({"tpu_sidecar": True}, P_local.LocalBench.DEVICE_READY_S["ed25519"]),
    ({"scheme": "bls"}, P_local.LocalBench.DEVICE_READY_S["bls"]),
    ({"tpu_sidecar": True, "sidecar_mesh": 4},
     P_local.LocalBench.MESH_READY_S),
])
def test_readiness_budgets(extra, budget):
    bench = _local(P_local, extra)
    assert bench._sidecar_deadline_s(True) == 120
    assert bench._sidecar_deadline_s(False) == budget


def test_teardown_stops_the_replicas_before_the_sidecar(tmp_path,
                                                        monkeypatch):
    """A replica signalled after its sidecar logs an ERROR for its
    in-flight BLS sign request; the port's teardown waits for the
    replicas' and clients' process groups to exit, then stops the
    sidecar.  The stand-ins record the order in which they exit."""
    order = tmp_path / "order"
    sweeps = []
    monkeypatch.setattr(P_local, "_sweep_stale",
                        lambda patterns, root: sweeps.append((patterns, root)))
    bench = _local(P_local, {"tpu_sidecar": True})
    bench._background_run(
        f"python -c 'import signal, sys, time; signal.signal("
        f"signal.SIGTERM, lambda *a: (open(\"{order}\", \"a\").write("
        f"\"sidecar\\n\"), sys.exit(0))); time.sleep(60)'",
        str(tmp_path / "sidecar.log"))
    bench._background_run(
        f"sh -c 'trap \"sleep 0.3; echo node >> {order}; exit 0\" TERM; "
        f"while :; do sleep 0.05; done'", str(tmp_path / "node.log"))
    time.sleep(1.0)   # both stand-ins have installed their handlers
    bench._kill_nodes()
    deadline = time.monotonic() + 10
    while order.read_text().count("\n") < 2 if order.exists() else True:
        assert time.monotonic() < deadline, "a stand-in never exited"
        time.sleep(0.05)
    assert order.read_text() == "node\nsidecar\n"
    assert [(tuple(p for p, _ in patterns), root)
            for patterns, root in sweeps] == [
        ((r"\./node run", r"\./client 127",
          P_local.LocalBench.SIDECAR_SWEEP), os.getcwd())]
    assert [sig for _, sig in P_local.LocalBench.SWEEPS] == [
        signal.SIGTERM, signal.SIGTERM, signal.SIGKILL]


def _stand_in(cwd, cmd: str):
    """A sleeping process in ``cwd`` whose command line carries ``cmd``."""
    os.makedirs(cwd, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)", *cmd.split()],
        cwd=cwd)


def _gone(proc, wait_s: float = 10.0) -> bool:
    try:
        proc.wait(timeout=wait_s)
        return True
    except subprocess.TimeoutExpired:
        return False


def test_sweep_pattern_matches_the_port_sidecar_process(tmp_path):
    """The stale-process sweep's pattern (an extended regex over the
    command line) kills a process whose command line is the port's
    sidecar boot, and the reference's pattern does not: the port sweeps
    its own module.  The stand-in runs in a directory of its own, so
    the sweeps reach nothing else on the machine."""
    cmd = f"python -m {PORT_MODULE} --port 7100 --committee 4"
    proc = _stand_in(tmp_path / "bench", cmd)
    try:
        time.sleep(0.5)   # the stand-in has exec'd its command line
        P_local._sweep_stale([(r"hotstuff_tpu\.sidecar", signal.SIGKILL)],
                             str(tmp_path / "bench"))
        assert not _gone(proc, 1.0), "the reference's pattern matched"
        P_local._sweep_stale(
            [(P_local.LocalBench.SIDECAR_SWEEP, signal.SIGKILL)],
            str(tmp_path / "bench"))
        assert _gone(proc), "the port's pattern did not sweep its sidecar"
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_sweep_spares_processes_outside_the_bench_cwd(tmp_path,
                                                      monkeypatch):
    """A bench's teardown sweeps the stale replicas, clients and sidecar
    that run in its own cwd, and none that run elsewhere: another
    checkout's committee and sidecar on the same machine live on."""
    cmds = (f"python -m {PORT_MODULE} --port 7100 --committee 4",
            "./node run --keys .node-0.json",
            "./client 127.0.0.1:9004 --size 512")
    mine = [_stand_in(tmp_path / "bench", cmd) for cmd in cmds]
    other = [_stand_in(tmp_path / "other", cmd) for cmd in cmds]
    try:
        time.sleep(0.5)
        monkeypatch.chdir(tmp_path / "bench")
        _local(P_local, {"tpu_sidecar": True})._kill_nodes()
        assert all(_gone(p) for p in mine), "a stale process was missed"
        assert not any(_gone(p, 0.5) for p in other), \
            "the sweep reached another directory's process"
    finally:
        for p in mine + other:
            p.kill()
            p.wait(timeout=10)


# ---------------------------------------------------------------------------
# the log parser
# ---------------------------------------------------------------------------

def test_parsers_agree_on_golden_logs():
    r = R.LogParser.process(GOLDEN_DIR, faults=0)
    p = P.LogParser.process(GOLDEN_DIR, faults=0)
    assert p.result() == r.result()
    assert p.commits and p._end_to_end_latency() > 0


@pytest.mark.parametrize("faults", [0, 1])
def test_parsers_agree_on_golden_strings(faults):
    r = R.LogParser([GOLDEN_CLIENT], [GOLDEN_NODE], faults=faults)
    p = P.LogParser([GOLDEN_CLIENT], [GOLDEN_NODE], faults=faults)
    assert p.result() == r.result()
    assert p.notes == r.notes


@pytest.mark.parametrize("bad", [
    ("client", "[2026-07-29T14:55:00.000Z ERROR client] exploded\n"),
    ("client", "[2026-07-29T14:55:00.000Z WARN client] Failed to send "
               "transaction\n"),
    ("node", "[2026-07-29T14:55:00.000Z ERROR node::main] uncaught\n"),
])
def test_parsers_reject_alike(bad):
    which, line = bad
    client = GOLDEN_CLIENT + (line if which == "client" else "")
    node = GOLDEN_NODE + (line if which == "node" else "")
    errs = []
    for mod in (R, P):
        with pytest.raises(mod.ParseError) as exc:
            mod.LogParser([client], [node], faults=0)
        errs.append(str(exc.value))
    assert errs[1] == errs[0]


@pytest.fixture(scope="module")
def port_sidecar_run(tmp_path_factory):
    """The port's --host-crypto sidecar with the harness's flags and a
    span file: a HELLO tenant's QC, ingress- and offchain-fed bulk, a
    repeated (deduplicated) QC; its OP_STATS snapshot and spans."""
    from conftest import free_port

    from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
    from hotstuff_tpu_torch.sidecar.client import SidecarClient
    from hotstuff_tpu_torch.sidecar.service import INGRESS_CTX

    d = tmp_path_factory.mktemp("port-sidecar")
    port = free_port()
    spans = d / "sidecar-spans.jsonl"
    with open(d / "sidecar.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", PORT_MODULE, "--port", str(port),
             "--committee", "4", "--client-rate", "1000", "--host-crypto",
             "--trace", str(spans)],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=log)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                with SidecarClient(port=port, timeout=2.0) as c:
                    c.ping()
                break
            except OSError:
                assert proc.poll() is None, (d / "sidecar.log").read_text()
                assert time.monotonic() < deadline, "sidecar never ready"
                time.sleep(0.2)
        keys = [ref.generate_keypair(bytes([i]) * 32) for i in range(1, 10)]

        def signed(tag, n):
            msgs = [b"%s-%d" % (tag, i) for i in range(n)]
            return (msgs, [keys[i][1] for i in range(n)],
                    [ref.sign(keys[i][0], m) for i, m in enumerate(msgs)])

        with SidecarClient(port=port, timeout=30.0) as c:
            c.hello("node")
            qc = signed(b"qc", 3)
            assert c.verify_batch(*qc) == [True] * 3
            assert c.verify_batch(*qc) == [True] * 3
        with SidecarClient(port=port, timeout=30.0) as c:
            assert c.verify_batch(*signed(b"tx", 4), bulk=True,
                                  ctx=INGRESS_CTX) == [True] * 4
            assert c.verify_batch(*signed(b"off", 2), bulk=True) == \
                [True] * 2
            stats = c.stats()
    finally:
        proc.kill()
        proc.wait(timeout=10)
    return stats, str(spans)


def test_sidecar_stats_fold_alike(port_sidecar_run):
    """note_sidecar_stats of both parsers on the port's own snapshot:
    every key the reference's parser reads is there (paths, dedup,
    tenants, the ingress feed mix, guard)."""
    stats, _ = port_sidecar_run
    for key in ("launches", "launches_by_class", "paths", "queue_wait",
                "bulk_fill_sigs", "pad_waste_sigs", "guard", "queue_full",
                "dedup", "tenants", "ingress", "surge", "pipeline"):
        assert key in stats, key
    assert stats["paths"] == {"host": stats["launches"]}
    assert stats["guard"]["device_ok"] is True
    r = R.LogParser([GOLDEN_CLIENT], [GOLDEN_NODE], faults=0)
    p = P.LogParser([GOLDEN_CLIENT], [GOLDEN_NODE], faults=0)
    r.note_sidecar_stats(copy.deepcopy(stats))
    p.note_sidecar_stats(copy.deepcopy(stats))
    assert p.notes == r.notes and p.result() == r.result()
    text = "\n".join(p.notes)
    assert f"Sidecar verify paths: host={stats['launches']}" in text
    assert "Sidecar dedup: 3 cache hit(s)" in text
    assert "Sidecar tenants (2): default admitted" in text
    assert "node admitted 1" in text
    assert "Sidecar bulk lane: 1 ingress-fed request(s) (4 sigs, 67% of " \
        "bulk), 1 offchain-fed (2 sigs)" in text


def test_sidecar_spans_break_down_alike(port_sidecar_run):
    from hotstuff_tpu.obs import parse_spans as r_parse
    from hotstuff_tpu.obs.trace import sidecar_breakdown as r_breakdown
    from hotstuff_tpu_torch.obs import parse_spans as p_parse
    from hotstuff_tpu_torch.obs.trace import sidecar_breakdown as \
        p_breakdown

    _, path = port_sidecar_run
    with open(path) as f:
        text = f.read()
    r_spans, p_spans = r_parse(text), p_parse(text)
    assert p_spans == r_spans
    out = p_breakdown(p_spans[0])
    assert out == r_breakdown(r_spans[0])
    assert {"queue", "pack", "device", "reply"} <= set(out)


def test_stats_file_and_sample_fallback_read_alike(tmp_path,
                                                   port_sidecar_run):
    stats, _ = port_sidecar_run
    out = []
    for name, mod in (("r", R), ("p", P)):
        d = tmp_path / name
        d.mkdir()
        for f in os.listdir(GOLDEN_DIR):
            (d / f).write_text(open(os.path.join(GOLDEN_DIR, f)).read())
        (d / "sidecar-stats.json").write_text(json.dumps(
            dict(stats, _from_sample_at=1785751201.0)))
        out.append(mod.LogParser.process(str(d), faults=0).result())
    assert out[1] == out[0]
    assert "Sidecar stats from last sample @" in out[1]


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------

def test_aggregators_agree_on_one_results_directory(tmp_path, monkeypatch,
                                                    capsys):
    summary = (
        "-----------------------------------------\n"
        " SUMMARY:\n"
        "-----------------------------------------\n"
        " + CONFIG:\n"
        " Faults: 0 nodes\n"
        " Committee size: {n} nodes\n"
        " Input rate: {rate} tx/s\n"
        " Transaction size: 512 B\n"
        " Execution time: 60 s\n"
        " + RESULTS:\n"
        " End-to-end TPS: {tps} tx/s\n"
        " End-to-end BPS: 1 B/s\n"
        " End-to-end latency: {lat} ms\n")
    out = []
    for name, agg_mod in (("r", R_agg), ("p", P_agg)):
        d = tmp_path / name
        (d / "results").mkdir(parents=True)
        (d / "results" / "bench-0-100-1600-512.txt").write_text(
            summary.format(n=100, rate="1,600", tps="1,189", lat="19,000")
            + summary.format(n=100, rate="1,600", tps="703", lat="45,000"))
        (d / "results" / "bench-0-4-1000-512.txt").write_text(
            summary.format(n=4, rate="1,000", tps="998", lat="2,100"))
        P.LogParser.process(GOLDEN_DIR, faults=0).print(
            str(d / "results" / "bench-0-2-2000-512.txt"))
        monkeypatch.chdir(d)
        capsys.readouterr()
        agg = agg_mod.LogAggregator(max_latencies=[60_000])
        agg.print()
        agg.print_matrix()
        agg.print_bands()
        printed = capsys.readouterr().out
        files = {f: (d / "plots" / f).read_text()
                 for f in sorted(os.listdir(d / "plots"))}
        out.append((printed, files, agg.bands(), sorted(
            (str(k), str(v)) for k, v in agg.records.items())))
    assert out[1] == out[0]
    assert "matrix.json" in out[1][1] and out[1][2]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["local"],
    ["local", "--nodes", "20", "--tpu-sidecar", "--warm-rlc", "--rate",
     "50000", "--duration", "20", "--scheme", "bls", "--chain", "3"],
    ["local", "--sidecar-host-crypto", "--sidecar-mesh", "4", "--twins",
     "--wan", "node:0>sidecar latency_ms=5", "--slo", "node-kill=8000"],
    ["aggregate", "--max-latency", "1000", "4000"],
    ["logs", "some/dir", "--faults", "1"],
])
def test_cli_parses_alike(monkeypatch, argv):
    out = []
    for mod in (R_main, P_main):
        seen = []
        for name in ("cmd_local", "cmd_aggregate", "cmd_logs"):
            monkeypatch.setattr(mod, name, seen.append)
        mod.main(list(argv))
        (args,) = seen
        out.append({k: v for k, v in vars(args).items() if k != "func"})
    assert out[1] == out[0]


@pytest.mark.parametrize("argv", [
    ["plot"], ["remote", "--nodes", "4", "10", "--rate", "1000"],
    ["install", "--hosts", "a", "b"], ["kill"], ["create", "--instances",
                                                 "3"], ["info"],
])
def test_unported_commands_name_roadmap(monkeypatch, argv):
    """The commands that once named ROADMAP.md Queue A (plot, remote,
    install, kill, the cloud actions) now parse as the reference's do and
    reach the same command function."""
    names = ("cmd_plot", "cmd_remote", "cmd_install", "cmd_kill",
             "cmd_cloud")
    out = []
    for mod in (R_main, P_main):
        seen = []
        for name in names:
            monkeypatch.setattr(mod, name,
                                lambda a, name=name: seen.append((name, a)))
        mod.main(list(argv))
        ((name, args),) = seen
        out.append((name, {k: v for k, v in vars(args).items()
                           if k != "func"}))
    assert out[1] == out[0]


def test_local_fault_plan_exits_naming_roadmap(tmp_path, monkeypatch,
                                               capsys):
    """``local --fault-plan`` runs the reference's pre-boot check: a plan
    the window cannot hold exits 1 with the reference's message before
    anything is built or booted."""
    msgs = []
    for mod in (R_main, P_main):
        monkeypatch.chdir(tmp_path)
        with pytest.raises(SystemExit) as exc:
            mod.main(["local", "--sidecar-host-crypto", "--duration", "20",
                      "--fault-plan", "19 node:1 kill"])
        assert exc.value.code == 1
        msgs.append(capsys.readouterr().out)
    assert msgs[1] == msgs[0] and "headroom" in msgs[0]
    assert os.listdir(tmp_path) == []      # nothing booted, nothing built
