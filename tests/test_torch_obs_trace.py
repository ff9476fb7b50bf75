"""The port's obs/trace.py and obs/sampler.py against the JAX package's:
the same node TRACE lines, sidecar spans, probes and OP_STATS samples
through both, the same critical paths, joins, breakdowns, Chrome traces,
run-directory artifacts, sample files and recovery curves.

Host code only: no device, no JAX, no sleeps beyond thread joins.  The
inputs are the reference tests' (tests/test_obs.py).
"""

import copy
import json
import threading

import pytest

import hotstuff_tpu.obs as R
import hotstuff_tpu.obs.trace as R_trace
import hotstuff_tpu_torch.obs as P
import hotstuff_tpu_torch.obs.trace as P_trace


def _both(name, *args, module="obs", **kw):
    """``name`` of both packages on deep copies of the same inputs."""
    r = getattr(R_trace if module == "trace" else R, name)
    p = getattr(P_trace if module == "trace" else P, name)
    return (r(*copy.deepcopy(args), **copy.deepcopy(kw)),
            p(*copy.deepcopy(args), **copy.deepcopy(kw)))


def _trace_line(sec, stage, block="aaa=", rnd=2, ms="000"):
    return (f"[2026-08-03T12:00:{sec:02d}.{ms}Z INFO consensus::core] "
            f"TRACE stage={stage} block={block} round={rnd}")


def _full_block(block, rnd, t0, host="node-0.log"):
    return [{"host": host, "stage": stage, "t": t0 + dt, "block": block,
             "round": rnd}
            for stage, dt in (("proposal", 0.0), ("verify_submit", 0.010),
                              ("verify_reply", 0.030), ("commit", 0.050))]


def _chain(block, t0):
    """One verify request's sidecar span chain for ``block``."""
    return [
        {"stage": "admit", "t": t0, "rid": 7, "cls": "latency",
         "ctx": block},
        {"stage": "queue", "t": t0, "dur_ms": 1.0, "rid": 7,
         "cls": "latency", "ctx": block},
        {"stage": "pack", "t": t0 + 0.001, "dur_ms": 2.0, "ctxs": [block]},
        {"stage": "device", "t": t0 + 0.003, "dur_ms": 12.0,
         "ctxs": [block]},
        {"stage": "reply", "t": t0 + 0.015, "dur_ms": 0.5, "rid": 7,
         "cls": "latency", "ctx": block},
    ]


BLOCKS = {
    "one": _full_block("a=", 2, 100.0),
    "dropped reply": _full_block("a=", 2, 100.0) + [
        s for s in _full_block("b=", 3, 101.0)
        if s["stage"] != "verify_reply"],
    "two replicas": _full_block("a=", 2, 100.0, host="node-0.log")
    + _full_block("a=", 2, 100.020, host="node-1.log"),
    "no verify": [s for s in _full_block("b=", 3, 101.0)
                  if s["stage"] in ("proposal", "commit")],
    "two blocks": _full_block("a=", 2, 100.0)
    + _full_block("c=", 4, 102.0),
}

SPANS = {
    "none": [],
    "chain a": _chain("a=", 100.012),
    "chain b": _chain("b=", 101.0),
    "shared launch": [{"stage": "device", "t": 100.02, "dur_ms": 9.0,
                       "ctxs": ["a=", "b="]}],
    "percentiles": [{"stage": "queue", "t": 1.0, "dur_ms": d}
                    for d in (1.0, 2.0, 3.0, 100.0)]
    + [{"stage": "device", "t": 1.0, "dur_ms": 20.0},
       {"stage": "reply", "t": 1.0}],
}


def test_parse_node_trace_agrees():
    log = "\n".join([
        "[2026-08-03T12:00:01.000Z INFO node::node] Node abc= booted",
        _trace_line(1, "proposal"),
        _trace_line(1, "verify_submit", ms="010"),
        _trace_line(1, "bogus_stage"),
        _trace_line(2, "commit"),
        "[2026-08-03T12:00:03.000Z INFO consensus::core] TRACE stage=comm",
    ])
    r, p = _both("parse_node_trace", log, host="node-0.log")
    assert p == r and [s["stage"] for s in p] == \
        ["proposal", "verify_submit", "commit"]


def test_clock_offsets_agree():
    probes = [(t, t + 0.005 + 2.5, t + 0.010) for t in (10.0, 11.0, 12.0)]
    probes.append((2.0, 2.9 + 2.5, 3.8))
    for args in ([probes], [[]]):
        r, p = _both("estimate_offset", *args, module="trace")
        assert p == r
    r, p = _both("clock_offset", 0.0, 5.05, 0.1)
    assert p == r
    spans = _full_block("x=", 4, 102.7, host="b")
    r, p = _both("apply_offset", spans, 2.5, module="trace")
    assert p == r

    def probe(module):
        local = [50.0]

        def clock():
            local[0] += 0.002
            return local[0]

        def run_fn(host, command):
            return f"{local[0] + 0.002 + 0.75:.9f}\n"

        return module.probe_host_offset(run_fn, "host-b", clock, samples=3)

    assert probe(P_trace) == probe(R_trace)


@pytest.mark.parametrize("blocks", sorted(BLOCKS))
def test_stitching_and_critical_path_agree(blocks):
    r, p = _both("stitch_blocks", BLOCKS[blocks])
    assert p == r
    r_cp, p_cp = _both("critical_path", r)
    assert p_cp == r_cp


@pytest.mark.parametrize("blocks,spans", [
    ("two blocks", "chain a"), ("no verify", "chain b"),
    ("dropped reply", "shared launch"), ("one", "none"),
])
def test_join_and_device_subsegment_agree(blocks, spans):
    traces = R.stitch_blocks(BLOCKS[blocks])
    r_chains, p_chains = _both("chain_spans", SPANS[spans])
    assert p_chains == r_chains
    (r_join, r_joined), (p_join, p_joined) = _both(
        "join_blocks", traces, r_chains)
    assert p_join == r_join and p_joined == r_joined
    r, p = _both("device_subsegment", r_joined, module="trace")
    assert p == r


@pytest.mark.parametrize("spans", sorted(SPANS))
def test_sidecar_breakdown_and_chrome_trace_agree(spans):
    r, p = _both("sidecar_breakdown", SPANS[spans], module="trace")
    assert p == r
    for blocks in ("one", "two blocks"):
        traces = R.stitch_blocks(BLOCKS[blocks])
        r, p = _both("chrome_trace", traces, SPANS[spans])
        assert json.dumps(p, sort_keys=True) == \
            json.dumps(r, sort_keys=True)


def _run_dir(path, with_spans=True):
    log0 = "\n".join([_trace_line(1, "proposal"),
                      _trace_line(1, "verify_submit", ms="010"),
                      _trace_line(1, "verify_reply", ms="030"),
                      _trace_line(1, "commit", ms="050"),
                      _trace_line(2, "proposal", block="xxx=", rnd=3),
                      _trace_line(2, "verify_submit", block="xxx=", rnd=3,
                                  ms="010"),
                      _trace_line(2, "verify_reply", block="xxx=", rnd=3,
                                  ms="030"),
                      _trace_line(2, "commit", block="xxx=", rnd=3,
                                  ms="050")])
    log1 = "\n".join([_trace_line(1, "proposal", ms="200"),
                      _trace_line(1, "commit", ms="250")])
    path.mkdir()
    (path / "node-0.log").write_text(log0 + "\n")
    (path / "node-1.log").write_text(log1 + "\n")
    (path / "clock-offsets.json").write_text(json.dumps({"node-1.log": 0.2}))
    if with_spans:
        (path / "sidecar-spans.jsonl").write_text(
            "\n".join(json.dumps(s) for s in _chain("aaa=", 1785751201.0))
            + "\ntorn lin")
    return str(path)


@pytest.mark.parametrize("with_spans", [True, False])
def test_run_trace_directory_agrees(tmp_path, with_spans):
    out = []
    for name, mod in (("ref", R), ("port", P)):
        d = _run_dir(tmp_path / name, with_spans)
        summary, chrome = mod.build_run_trace(d)
        written = mod.write_run_trace(d)
        trace_json = None
        if (tmp_path / name / "trace.json").exists():
            trace_json = json.loads((tmp_path / name / "trace.json")
                                    .read_text())
        out.append((summary, chrome, written, trace_json))
    assert json.dumps(out[1], sort_keys=True) == \
        json.dumps(out[0], sort_keys=True)
    if with_spans:
        assert out[1][0]["join"]["joined"] == 1


# ---------------------------------------------------------------------------
# the metrics sampler
# ---------------------------------------------------------------------------

class _FlakySidecar:
    """fetch(): healthy, dead from call ``fail_from`` to ``fail_until``
    (a sidecar kill), healthy again (its restart)."""

    def __init__(self, fail_from, fail_until):
        self.calls = 0
        self.fail_from = fail_from
        self.fail_until = fail_until

    def __call__(self):
        self.calls += 1
        if self.fail_from <= self.calls <= self.fail_until:
            raise ConnectionRefusedError("sidecar down")
        return {"launches": self.calls, "sigs_launched": 100 * self.calls}


def _sample_run(mod, path, ticks, fail_from, fail_until):
    now = [1000.0]
    sampler = mod.MetricsSampler(_FlakySidecar(fail_from, fail_until),
                                 str(path), interval_s=1.0,
                                 wall=lambda: now[0])
    for _ in range(ticks):
        sampler.sample_once()
        now[0] += 1.0
    sampler.stop()
    return (path.read_text(), sampler.samples, sampler.ok_samples,
            sampler.last)


@pytest.mark.parametrize("ticks,fail_from,fail_until", [
    (6, 3, 4), (5, 1, 2), (4, 5, 5), (8, 2, 7)])
def test_sampler_kill_restart_gap_agrees(tmp_path, ticks, fail_from,
                                         fail_until):
    """On a virtual clock, both samplers write the same series across a
    sidecar kill/restart: the same failed ticks, the same last good
    snapshot, the same recovery curve of the gap."""
    r = _sample_run(R, tmp_path / "r.jsonl", ticks, fail_from, fail_until)
    p = _sample_run(P, tmp_path / "p.jsonl", ticks, fail_from, fail_until)
    assert p == r
    r_samples, p_samples = (R.read_samples(str(tmp_path / "r.jsonl")),
                            P.read_samples(str(tmp_path / "p.jsonl")))
    assert p_samples == r_samples
    kill_at = 1000.0 + fail_from - 1.5
    assert P.recovery_curve(p_samples[0], kill_at) == \
        R.recovery_curve(r_samples[0], kill_at)


def test_sampler_thread_and_persistent_fetch():
    """The real thread path, and one dial serving every healthy tick."""
    ticked = threading.Event()

    class Conn:
        def __init__(self):
            self.closed = False
            self.broken = False
            self.calls = 0

        def stats(self):
            self.calls += 1
            ticked.set()
            if self.broken:
                raise ConnectionResetError("sidecar died mid-call")
            return {"launches": self.calls}

        def close(self):
            self.closed = True

    conns = []

    def dial():
        conns.append(Conn())
        return conns[-1]

    fetch = P.persistent_fetch(dial)
    sampler = P.MetricsSampler(fetch, "/dev/null", interval_s=0.01)
    sampler.start()
    assert ticked.wait(5.0)
    sampler.stop()
    # one dial served every tick; stop() closed it
    assert sampler.last is not None and len(conns) == 1 and conns[0].closed
    assert fetch() == {"launches": 1} and len(conns) == 2
    conns[1].broken = True
    with pytest.raises(ConnectionResetError):
        fetch()
    assert conns[1].closed
    assert fetch() == {"launches": 1} and len(conns) == 3
    fetch.close()
    assert conns[2].closed


def _metrics_line(sec, commits, rate, busy=0, breaker="closed"):
    return (f"[2026-08-03T12:00:{sec:02d}.000Z INFO node::metrics] "
            f"METRICS commits={commits} commit_rate={rate} "
            f"ingress_tx=5 ingress_bytes=2048 busy={busy} "
            f"breaker={breaker}")


def test_node_metrics_series_agree(tmp_path):
    log = "\n".join([
        _metrics_line(1, 10, "5.0"),
        _metrics_line(2, 15, "5.0", busy=3, breaker="open"),
        "[2026-08-03T12:00:03.000Z INFO node::metrics] METRICS commi",
        _metrics_line(4, 20, "2.5")])
    r, p = _both("parse_node_metrics", log, host="node-0.log")
    assert p == r and len(p) == 3
    out = []
    for name, mod in (("r", R), ("p", P)):
        d = tmp_path / name
        d.mkdir()
        for i, rate in enumerate(("5.0", "4.5", "1.0")):
            (d / f"node-{i}.log").write_text(
                _metrics_line(1, 10, rate) + "\n")
        (d / "metrics.jsonl").write_text(
            json.dumps({"t": 1.0, "ok": True, "stats": {}}) + "\n"
            + "{\"t\": 2.0, \"ok\"\ngarbage\n")
        merged = mod.merge_node_series(str(d))
        again = mod.merge_node_series(str(d))
        samples, malformed = mod.read_samples(str(d / "metrics.jsonl"))
        sidecar, node = mod.split_samples(samples)
        out.append((merged, again, malformed, sidecar, node,
                    mod.commit_rate_divergence(node, threshold=0.7)))
    assert out[1] == out[0]
    assert out[1][0] == 3 and out[1][1] == 0
    assert [s["host"] for s in out[1][5]["stragglers"]] == ["node-2.log"]
