"""The port's chaos/ (fault plans, WAN specs, recovery SLOs, the plan
runner, WanProxy) against the JAX package's: the same specs and inputs
through both, the same plans, verdicts, tc strings and error messages.

Pure host code, no device, no JAX: the specs are the reference tests'
(tests/test_chaos.py, tests/test_wan.py).  WanProxy runs over loopback.
"""

import copy
import json
import socket
import threading
import time

import pytest

import hotstuff_tpu.chaos as R
import hotstuff_tpu.chaos.netem as R_netem
import hotstuff_tpu.chaos.plan as R_plan
import hotstuff_tpu_torch.chaos as P
import hotstuff_tpu_torch.chaos.netem as P_netem
import hotstuff_tpu_torch.chaos.plan as P_plan


def _both(fn_r, fn_p, *args):
    """The two packages' results on deep copies of the same inputs."""
    return fn_r(*copy.deepcopy(args)), fn_p(*copy.deepcopy(args))


def _error(fn, exc, *args):
    with pytest.raises(exc) as info:
        fn(*copy.deepcopy(args))
    return str(info.value)


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

PLANS = [
    "10 sidecar restart; 5 sidecar kill; 3 node:1 pause; 6 node:1 resume",
    "1 sidecar degrade delay_ms=50 drop=1",
    [{"t": 1, "target": "sidecar", "action": "degrade",
      "params": {"delay_ms": 100, "shed": 2}},
     {"t": 2, "target": "sidecar", "action": "degrade",
      "params": {"clear": True}}],
    [{"t": 5, "target": "sidecar", "action": "kill"},
     {"t": 10, "target": "sidecar", "action": "restart"}],
    "5 leader-cascade kill k=3",
    "5 leader-cascade kill",
    "5 leader-cascade kill k=1; 20 leader-cascade kill k=2; "
    "2 sidecar degrade shed=1",
    "0.01 sidecar kill; 0.03 sidecar restart",
]


@pytest.mark.parametrize("spec", PLANS)
def test_plans_parse_alike(spec):
    r, p = _both(R.parse_plan, P.parse_plan, spec)
    assert p.to_json() == r.to_json()
    assert p.node_indices() == r.node_indices()
    assert p.sidecar_indices() == r.sidecar_indices()
    assert p.link_names() == r.link_names()
    assert p.max_time() == r.max_time()
    assert P.parse_plan(p.to_json()).to_json() == p.to_json()
    assert [P.cascade_k(e.params) for e in p.events] == \
        [R.cascade_k(e.params) for e in r.events]


def test_plan_file_parses_alike(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"events": PLANS[3]}))
    r, p = _both(R.parse_plan, P.parse_plan, str(path))
    assert p.to_json() == r.to_json()
    path.write_text("{not json")
    assert _error(P.parse_plan, P.PlanError, str(path)) == \
        _error(R.parse_plan, R.PlanError, str(path))


@pytest.mark.parametrize("spec", [
    "5 sidecar explode", "5 moon:1 kill", "-1 sidecar kill",
    "5 sidecar restart", "5 node:0 resume", "5 node:0 kill; 6 node:0 kill",
    "5 node:0 kill; 6 node:0 pause", "5 sidecar kill; 6 sidecar degrade "
    "shed=1", "5 sidecar pause", "5 node:0 degrade",
    "5 sidecar degrade zap=1", "5 sidecar degrade delay_ms=oops",
    "5 sidecar degrade shed=-3", "5 node:0 kill extra=1",
    "5 leader-cascade restart", "5 leader-cascade kill k=0",
    "5 leader-cascade kill k=oops", "5 leader-cascade kill zap=2",
    "5 leader-cascade kill k=2; 8 node:1 kill",
    "2 node:1 pause; 5 leader-cascade kill; 8 node:1 resume",
    "nonsense", "",
])
def test_plan_rejections_read_alike(spec):
    assert _error(P.parse_plan, P.PlanError, spec) == \
        _error(R.parse_plan, R.PlanError, spec)


@pytest.mark.parametrize("target", [
    "node:3", "sidecar", "sidecar:2", "client:1", "link:ab",
    "leader-cascade", "moon"])
def test_plan_target_helpers_agree(target):
    for name in ("node_index", "sidecar_index", "client_index", "link_name"):
        assert getattr(P_plan, name)(target) == \
            getattr(R_plan, name)(target), name


class _Recorder:
    def __init__(self, fail_on=()):
        self.applied = []
        self.fail_on = set(fail_on)

    def apply(self, event):
        if event.action in self.fail_on:
            raise RuntimeError(f"boom on {event.action}")
        self.applied.append((event.t, event.target, event.action))


def _run_virtual(pkg, spec, fail_on=()):
    now = [0.0]
    rec = _Recorder(fail_on)
    runner = pkg.PlanRunner(
        pkg.parse_plan(spec), rec, clock=lambda: now[0],
        sleep=lambda dt: now.__setitem__(0, now[0] + dt),
        wall=lambda: 1000.0 + now[0])
    runner.start(t0=0.0)
    runner.join(timeout=30.0)
    assert not runner._thread.is_alive()
    return rec.applied, runner.events(), runner.all_ok()


@pytest.mark.parametrize("spec,fail_on", [
    ("2 sidecar kill; 1 node:0 pause; 3 node:0 resume", ()),
    ("1 sidecar kill; 2 sidecar restart", ("kill",)),
])
def test_runner_executes_alike_on_a_virtual_clock(spec, fail_on):
    assert _run_virtual(P, spec, fail_on) == _run_virtual(R, spec, fail_on)


@pytest.mark.parametrize("events,commits", [
    ([{"t": 5, "target": "sidecar", "action": "kill", "wall": 100.0,
       "ok": True},
      {"t": 10, "target": "sidecar", "action": "restart", "wall": 105.0,
       "ok": True}], [99.0, 100.8, 104.0, 105.4]),
    ([{"t": 5, "action": "kill", "target": "node:2", "wall": 100.0,
       "ok": False, "error": "no such pid"},
      {"t": 9, "action": "restart", "target": "node:2", "wall": 104.0,
       "ok": True}], [99.0, 101.0]),
    ([{"t": 5, "target": "leader-cascade", "action": "kill",
       "params": {"k": 2}, "wall": 100.0, "ok": True}], [99.0, 112.0]),
])
def test_recovery_and_slo_verdicts_agree(events, commits):
    r, p = _both(R.summarize_recovery, P.summarize_recovery, events, commits)
    assert p == r
    assert P.judge(p) == R.judge(r)
    assert P.judge(p, {"view-change": 5_000.0}) == \
        R.judge(r, {"view-change": 5_000.0})


# ---------------------------------------------------------------------------
# WAN specs and tc compilation
# ---------------------------------------------------------------------------

WANS = [
    "node:0>node:1 latency_ms=200 loss_pct=0.5 name=wan01; "
    "*>sidecar latency_ms=20 jitter_ms=5 name=sc; default latency_ms=50",
    "node:0>sidecar latency_ms=10; sidecar>node:0 loss_pct=100",
    {"links": [{"src": "node:0", "dst": "node:1", "latency_ms": 40,
                "name": "ab"}],
     "default": {"latency_ms": 80, "rate_mbit": 100}},
    [{"src": "node:0", "dst": "node:1", "latency_ms": 40, "name": "ab"}],
    "node:0>node:1 latency_ms=40 name=ab; "
    "node:1>node:0 latency_ms=40 loss_pct=1 name=ba",
]


@pytest.mark.parametrize("spec", WANS)
def test_wan_specs_parse_and_compile_alike(spec):
    r, p = _both(R.parse_wan, P.parse_wan, spec)
    assert p.to_json() == r.to_json()
    assert p.link_names() == r.link_names()
    peers = {"node:0": "10.0.0.1", "node:1": "10.0.0.2",
             "node:2": "10.0.0.3", "sidecar": "10.0.0.9"}
    for host in ("node:0", "node:1", "sidecar"):
        assert P_netem.tc_setup_commands(p, host, peers) == \
            R_netem.tc_setup_commands(r, host, peers)
        for name in p.link_names():
            assert P_netem.tc_partition_commands(p, name, host, peers) == \
                R_netem.tc_partition_commands(r, name, host, peers)
            assert P_netem.tc_heal_commands(p, name, host, peers) == \
                R_netem.tc_heal_commands(r, name, host, peers)


def test_tc_bands_and_netem_args_agree():
    spec = "default latency_ms=10"
    peers = {f"node:{i}": f"10.0.0.{i + 1}" for i in range(11)}
    assert P_netem.tc_setup_commands(P.parse_wan(spec), "node:0", peers) == \
        R_netem.tc_setup_commands(R.parse_wan(spec), "node:0", peers)
    shape = dict(latency_ms=40, jitter_ms=5, loss_pct=1, rate_mbit=100)
    assert P_netem.netem_args(P_netem.LinkShape(**shape)) == \
        R_netem.netem_args(R_netem.LinkShape(**shape))
    assert P_netem.tc_teardown_command() == R_netem.tc_teardown_command()
    too_many = {f"node:{i}": f"10.0.0.{i + 1}" for i in range(15)}
    assert _error(P_netem.host_links, P.WanError, P.parse_wan(spec),
                  "node:0", too_many) == \
        _error(R_netem.host_links, R.WanError, R.parse_wan(spec),
               "node:0", too_many)


@pytest.mark.parametrize("spec", [
    "", "node:0 latency_ms=5", "node:0>node:0 latency_ms=5",
    "node:0>* latency_ms=5", "oven:0>node:1 latency_ms=5",
    "node:0>node:1 latency_ms=-5", "node:0>node:1 loss_pct=150",
    "node:0>node:1 jitter_ms=5", "node:0>node:1 warp=9",
    "node:0>node:1 name=x; node:1>node:0 name=x",
    "node:0>node:1 latency_ms=5 name=a; node:0>node:1 loss_pct=1 name=b",
    "node:0>sidecar latency_ms=5 name=a; *>sidecar loss_pct=1 name=b",
    {"links": "nope"}, {"flinks": []}, {"links": []},
])
def test_wan_rejections_read_alike(spec):
    assert _error(P.parse_wan, P.WanError, spec) == \
        _error(R.parse_wan, R.WanError, spec)


# ---------------------------------------------------------------------------
# SLO tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    None, "node-kill=8000; link-heal=3000", {"node-pause": 12000}])
def test_slo_tables_agree(spec):
    r, p = _both(R.parse_slos, P.parse_slos, spec)
    assert p == r and P.DEFAULT_SLO_MS == R.DEFAULT_SLO_MS


def test_slo_file_and_rejections_agree(tmp_path):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"node-pause": 12000}))
    assert P.parse_slos(str(path)) == R.parse_slos(str(path))
    for bad in ("warp-drive=1", "node-kill=zero", "node-kill=-5",
                "node-kill", "", 42):
        assert _error(P.parse_slos, P.SloError, bad) == \
            _error(R.parse_slos, R.SloError, bad)


def test_fault_classes_and_judge_agree():
    for event in ({"target": "node:3", "action": "kill"},
                  {"target": "sidecar", "action": "degrade"},
                  {"target": "link:ab", "action": "heal"},
                  {"target": "leader-cascade", "action": "kill"},
                  {"target": "client:0", "action": "surge"}):
        assert P.fault_class(event) == R.fault_class(event)
    summary = {"events": [
        {"target": "node:0", "action": "kill", "t": 5.0, "ok": True,
         "recovered": True, "recovery_ms": 800.0},
        {"target": "link:ab", "action": "heal", "t": 9.0, "ok": True,
         "recovered": True, "recovery_ms": 9_000.0},
        {"target": "node:1", "action": "pause", "t": 11.0, "ok": True,
         "recovered": False, "recovery_ms": None},
        {"target": "sidecar", "action": "kill", "t": 13.0, "ok": False,
         "error": "ssh died", "recovered": False, "recovery_ms": None},
    ]}
    r, p = _both(R.judge, P.judge, summary, {"link-heal": 3_000.0})
    assert p == r and not p["ok"]
    samples = [{"t": 100.0 + i, "ok": True,
                "stats": {"launches": 10 * i, "sigs_launched": 100 * i}}
               for i in range(8)]
    assert P.throughput_series(samples) == R.throughput_series(samples)
    events = [{"t": 2, "target": "sidecar", "action": "kill",
               "wall": 102.5, "ok": True}]
    r, p = _both(R.judge_baseline_recovery, P.judge_baseline_recovery,
                 samples, events, R.parse_slos(None))
    assert p == r


# ---------------------------------------------------------------------------
# WanProxy over loopback
# ---------------------------------------------------------------------------

def _echo_server():
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    srv.settimeout(0.25)
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(5.0)

            def pump(c=conn):
                try:
                    while True:
                        data = c.recv(65536)
                        if not data:
                            return
                        c.sendall(data)
                except OSError:
                    pass
                finally:
                    c.close()

            threading.Thread(target=pump, daemon=True).start()

    threading.Thread(target=loop, daemon=True).start()
    return srv.getsockname()[1], lambda: (stop.set(), srv.close())


def _roundtrip(port, payload=b"ping", timeout=5.0):
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall(payload)
        got = b""
        while len(got) < len(payload):
            chunk = s.recv(65536)
            if not chunk:
                break
            got += chunk
        return got


def test_wanproxy_forwards_pays_latency_partitions_and_heals():
    port, stop_srv = _echo_server()
    proxy = P.WanProxy(("127.0.0.1", port),
                       shape=P_netem.LinkShape(latency_ms=60))
    try:
        proxy.start()
        assert proxy.wait_ready(5.0)
        t0 = time.monotonic()
        assert _roundtrip(proxy.port, b"payload-xyz") == b"payload-xyz"
        # both pump directions pay the shape: >= 2 x 60 ms a round trip
        assert time.monotonic() - t0 >= 0.12
        proxy.partition()
        with pytest.raises((OSError, AssertionError)):
            assert _roundtrip(proxy.port, timeout=1.0) == b"ping"
        proxy.heal()
        proxy.set_shape(P_netem.LinkShape())
        assert _roundtrip(proxy.port, b"\x07" * 50_000) == b"\x07" * 50_000
    finally:
        proxy.stop()
        stop_srv()


# ---------------------------------------------------------------------------
# the harness's chaos checks, before anything boots
# ---------------------------------------------------------------------------

def _bench(pkg_harness, params):
    from importlib import import_module

    config = import_module(pkg_harness + ".config")
    local = import_module(pkg_harness + ".local")
    return local.LocalBench(config.BenchParameters(dict(params)))


@pytest.mark.parametrize("plan,extra", [
    ("5 node:3 kill", {}),
    ("5 sidecar kill; 8 sidecar restart", {}),
    ("55 node:0 kill", {}),
    ("5 sidecar kill; 10 sidecar restart; 12 node:1 pause; "
     "15 node:1 resume", {"sidecar_host_crypto": True}),
    ("5 leader-cascade kill k=2", {"faults": 0}),
    ("5 link:ab partition; 8 link:ab heal", {}),
])
def test_fault_plan_preflight_reads_alike(plan, extra):
    """The copied pre-boot check rejects what the reference rejects,
    with the same message."""
    params = {"faults": 1, "nodes": 4, "rate": 1000, "tx_size": 512,
              "duration": 60, **extra}
    out = []
    for pkg, chaos in (("hotstuff_tpu.harness", R),
                       ("hotstuff_tpu_torch.harness", P)):
        bench = _bench(pkg, params)
        bench.fault_plan = chaos.parse_plan(plan)
        try:
            bench._check_fault_plan()
            out.append(None)
        except Exception as e:  # noqa: BLE001 - compared across packages
            out.append((type(e).__name__, str(e)))
    assert out[1] == out[0]


def test_port_refuses_a_fault_plan_until_the_injector_is_ported():
    """With the injector ported the port takes a plan as the reference
    does: a valid one is parsed into the same events, a malformed one
    raises the same BenchError."""
    from hotstuff_tpu_torch.harness.utils import BenchError

    params = {"faults": 0, "nodes": 4, "rate": 1000, "tx_size": 512,
              "duration": 60, "fault_plan": "4 node:3 kill; 8 node:3 "
                                            "restart; 11 sidecar wedge"}
    ref = _bench("hotstuff_tpu.harness", params)
    port = _bench("hotstuff_tpu_torch.harness", params)
    assert [vars(e) for e in port.fault_plan.events] == \
        [vars(e) for e in ref.fault_plan.events]
    with pytest.raises(BenchError) as exc:
        port._check_fault_plan()      # a sidecar event, and no sidecar
    assert "boots none" in str(exc.value)
    params["tpu_sidecar"] = True
    _bench("hotstuff_tpu_torch.harness", params)._check_fault_plan()
    params["fault_plan"] = "5 nonsense"
    with pytest.raises(BenchError) as exc:
        _bench("hotstuff_tpu_torch.harness", params)
    assert str(exc.value) == "Invalid fault plan"


@pytest.mark.parametrize("wan,extra", [
    ("node:0>node:1 latency_ms=40", {}),
    ("client>node:0 latency_ms=40", {}),
    ("node:1>node:0 latency_ms=40", {}),
    ("node:0>sidecar latency_ms=40", {"sidecar_host_crypto": True}),
    ("node:0>sidecar latency_ms=40", {}),
    ("node:0>sidecar latency_ms=40 name=a; node:1>sidecar latency_ms=9 "
     "name=b", {"sidecar_host_crypto": True}),
    ("node:0>sidecar latency_ms=40",
     {"sidecar_host_crypto": True, "sidecar_fleet": 2}),
])
def test_wan_preflight_reads_alike(wan, extra):
    params = {"faults": 0, "nodes": 4, "rate": 1000, "tx_size": 512,
              "duration": 30, "wan": wan, **extra}
    out = []
    for pkg in ("hotstuff_tpu.harness", "hotstuff_tpu_torch.harness"):
        try:
            bench = _bench(pkg, params)
            bench._check_wan()
            out.append(("ok", bench.node_parameters.json.get("tpu_sidecar")))
        except Exception as e:  # noqa: BLE001 - compared across packages
            out.append((type(e).__name__, str(e)))
    assert out[1] == out[0]
