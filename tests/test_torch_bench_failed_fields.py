"""chip_smoke.py's phase 15 on a made-up last line of the bench: each bar
is read from its field, and when the bench fails every failing field is
printed whole, the fleet field's bar by part (masks, rehome, host
fallbacks, goodput, dedup, the flood verdict with its reason and its
two p99s)."""

from __future__ import annotations

import copy
import importlib.util
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shards(kernel):
    return {str(i): {kernel: 1} for i in range(8)}


FLEET = {"endpoints": 2, "live_goodput_sigs_per_s": 9958.9,
         "failover_goodput_sigs_per_s": 17938.6, "rehome_ms": 164.4,
         "rehomes": 1, "host_fallbacks": 0, "active_endpoint": 1,
         "masks_bit_identical": True,
         "dedup": {"cache_hits": 14352, "hit_rate": 0.9934},
         "flood": {"victim": "victim", "starvation": 0,
                   "pre_p99_ms": 180.1, "post_p99_ms": 180.1,
                   "judged": True, "ok": True},
         "ok": True}
FLOOD_FAILED = {
    "ok": False,
    "error": "ParseError('tenant isolation violated under greedy flood: "
             "victim queue-wait p99 338.541 ms exceeds 2x pre-flood "
             "156.283 ms')",
    "verdict": {"victim": "victim", "starvation": 0, "pre_p99_ms": 156.283,
                "post_p99_ms": 338.541, "judged": True, "ok": False,
                "reason": "victim queue-wait p99 338.541 ms exceeds 2x "
                          "pre-flood 156.283 ms"}}

LINE = {
    "viewchange": {"ok": True}, "surge": {"ok": True},
    "guard": {"ok": True}, "users": {"ok": True},
    "chaos": {"recovered": True, "slo": {"ok": True},
              "wan": {"roundtrip_ok": True, "partition_enforced": True,
                      "healed": True}},
    "trace": {"roundtrip_ok": True}, "sched": {"paths": {"host": 2}},
    "cadence": {"ok": True, "mesh_ring_slot": {
        "bit_identical": True,
        "launches_per_shard": _shards("point_ladder")}},
    "mesh_rlc": {n: {"launches_per_shard": {
        "per_sig_sharded": _shards("point_ladder"),
        "rlc_sharded": _shards("msm_window_accum")}}
        for n in ("n64", "n256", "n1024")},
    "committee_scale": {n: {"launches_per_shard": {
        "per_sig_sharded": _shards("point_ladder"),
        "rlc_sharded": _shards("msm_window_accum"),
        "scan": _shards("point_ladder")}}
        for n in ("N100", "N300", "N1000")},
    "fleet": FLEET}


def test_every_bar_holds_on_a_passing_line(smoke, capsys):
    bars = smoke.bench_bars(LINE)
    assert all(ok is True for ok, _ in bars.values()), bars
    assert smoke.print_failed_fields(LINE, "") == []
    assert capsys.readouterr().out == ""


def test_a_failed_flood_prints_the_fleet_field_and_its_bar(smoke, capsys):
    line = copy.deepcopy(LINE)
    line["fleet"]["flood"] = FLOOD_FAILED
    line["fleet"]["ok"] = False
    names = smoke.print_failed_fields(line,
                                      "bench: failed fields: fleet\n")
    assert names == ["fleet"]
    captured = capsys.readouterr()
    out = captured.out.splitlines()
    assert captured.err.splitlines() == out
    field = json.loads(out[0].split("bench failed field fleet: ", 1)[1])
    assert field == line["fleet"]
    bar = json.loads(out[1].split("bench fleet bar: ", 1)[1])
    assert bar["flood"] is False and bar["reason"].startswith("ParseError")
    assert all(bar[p] for p in ("masks", "rehome", "no_host_fallback",
                                "goodput", "dedup"))


def test_a_judged_flood_gives_its_reason_and_both_p99s(smoke):
    fleet = copy.deepcopy(FLEET)
    fleet["flood"].update(ok=False, post_p99_ms=400.0,
                          reason="victim queue-wait p99 400 ms exceeds 2x "
                                 "pre-flood 180.1 ms")
    bar = smoke.fleet_bar_parts(fleet)
    assert (bar["flood"], bar["pre_p99_ms"], bar["post_p99_ms"]) == (
        False, 180.1, 400.0)
    assert bar["reason"].endswith("pre-flood 180.1 ms")


def test_fields_named_on_stderr_and_failed_bars_both_print(smoke, capsys):
    line = copy.deepcopy(LINE)
    line["surge"]["ok"] = False
    line["mesh_rlc"]["n256"] = {"error": "RuntimeError('x')"}
    line["fleet"] = {"error": "OSError('refused')"}
    names = smoke.print_failed_fields(
        line, "bench: failed fields: guard, fleet\n")
    assert names == ["guard", "fleet", "surge", "mesh_rlc"]
    out = capsys.readouterr().out
    assert "bench failed field mesh_rlc: " in out
    bar = json.loads(out.split("bench fleet bar: ", 1)[1].splitlines()[0])
    assert bar["reason"] == "OSError('refused')" and not bar["masks"]
