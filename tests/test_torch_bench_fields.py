"""The port's bench fields ``mesh_rlc``, ``cadence`` and ``fleet``
(hotstuff_tpu_torch/bench.py) against the root bench.py, on the CPU at
tiny sizes: eight shards of the CPU (``virtual_mesh(8, "cpu")``), each
field's keys equal to the root bench's, plus the port's launches per
shard and its note, and each field's bar.  The root bench's probes are
read from its source (their JAX mesh programs compile for minutes on
this CPU) and are not run.  A sharded per-signature call of 4 votes on
eight CPU shards takes ~7 s here, which sizes the cases."""

from __future__ import annotations

import ast
import os

import pytest

from hotstuff_tpu_torch import bench as pbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = {str(i) for i in range(8)} | {"lead"}


def _ref_fn(name):
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _keys_stored(name, var) -> set:
    """Constant keys a root-bench function stores into ``var[...]``, an
    f-string key as its source text."""
    out = set()
    for node in ast.walk(_ref_fn(name)):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == var:
                    key = tgt.slice
                    out.add(key.value if isinstance(key, ast.Constant)
                            else ast.unparse(key))
    return out


def _dict_keys(name, having) -> set:
    """Keys of the dict literal of a root-bench function that holds the
    key ``having``."""
    for node in ast.walk(_ref_fn(name)):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant)}
            if having in keys:
                return keys
    raise AssertionError(f"{name} has no dict with {having!r}")


def test_mesh_rlc_on_eight_cpu_shards():
    """Both routes verify every vote (a wrong mask raises), the stats of
    a size are the root bench's keys plus the launches per shard of one
    call of each route, and the field says what eight shards of one
    device show."""
    field = pbench.mesh_rlc_probe((4,), repeats=1, device="cpu")
    assert set(field) == {"n4", "note"}
    assert "not" in field["note"] and "scale" in field["note"]
    stats = field["n4"]
    assert set(stats) == _stored_per_size("mesh_rlc_probe") | {
        "launches_per_shard"}
    assert stats["per_sig_sharded_sigs_per_s"] > 0
    assert stats["rlc_sharded_sigs_per_s"] > 0 and stats["speedup"] > 0
    launches = stats["launches_per_shard"]
    assert set(launches) == {"per_sig_sharded", "rlc_sharded"}
    assert all(set(v) == SHARDS for v in launches.values())


def _stored_per_size(name) -> set:
    """The keys mesh_rlc_probe stores into a size's ``stats``, its one
    f-string key as its two route names give it."""
    keys = _keys_stored(name, "stats")
    fkeys = {k for k in keys if k.startswith("f")}
    assert fkeys == {"f'{name}_sigs_per_s'"}
    return (keys - fkeys) | {f"{r}_sigs_per_s"
                             for r in ("per_sig_sharded", "rlc_sharded")}


@pytest.mark.parametrize("probe,key", [
    (lambda: pbench.mesh_rlc_probe((4, 8), budget_s=0.0, device="cpu"),
     "n"),
    (lambda: pbench.committee_scale_probe((4, 10), budget_s=0.0,
                                          device="cpu"), "N"),
])
def test_a_size_past_the_budget_is_skipped(probe, key):
    """The root bench's budget rule: a size the budget cannot fit reports
    skipped (a committee keeps its quorum), and nothing is measured."""
    field = probe()
    sizes = {k: v for k, v in field.items() if k != "note"}
    assert len(sizes) == 2 and all(k.startswith(key) for k in sizes)
    for k, v in sizes.items():
        assert v.get("skipped") is True
        assert set(v) <= {"skipped", "quorum"}
    if key == "N":
        assert sizes["N4"]["quorum"] == 3 and sizes["N10"]["quorum"] == 7


def test_cadence_on_the_cpu_meets_the_bar():
    """Host-mode engine legs and the mesh ring slot on eight CPU shards:
    the root bench's keys and bar, the slot bit-identical to
    verify_batch with its launches per shard."""
    field = pbench.cadence_probe(device="cpu")
    want = (_keys_stored("cadence_probe", "out") - {"f'ring_k{k}'"}) | {
        f"ring_k{k}" for k in (2, 4, 8)} | {"n_devices"}
    assert set(field) == want
    assert field["ok"] is True and field["n_devices"] == 8
    assert field["staged_default"] and field["masks_bit_identical"]
    assert field["tick_launches_supervised"]
    for k in (2, 4, 8):
        assert set(field[f"ring_k{k}"]) == _dict_keys(
            "cadence_probe", "guard_tick_launches")
        assert field[f"ring_k{k}"]["sigs_per_s"] > 0
    assert set(field["surge_wait"]) == _dict_keys("cadence_probe",
                                                  "accepted_reqs")
    slot = field["mesh_ring_slot"]
    assert set(slot) == _dict_keys("cadence_probe", "bit_identical") | {
        "note", "launches_per_shard"}
    assert slot["bit_identical"] is True and slot["rows"] == 16
    assert set(slot["launches_per_shard"]) == SHARDS


def test_fleet_failover_and_flood_meet_the_bar():
    """The failover and the flood: the root bench's keys, every mask
    bit-identical, one re-home and no host rung, the survivor's verdict
    cache shared across tenants, the flood judged.  The flood's verdict
    (no starvation, the victim's queue-wait p99 within 2x) is a timing
    verdict, which a loaded CPU can miss: a miss is the parser's strict
    error, and ``ok`` follows the flood's."""
    field = pbench.fleet_headline_probe(window_s=0.3)
    assert set(field) == _dict_keys("fleet_headline_probe", "rehome_ms")
    assert field["rehomes"] == 1 and field["host_fallbacks"] == 0
    assert field["active_endpoint"] == 1 and field["masks_bit_identical"]
    assert field["dedup"]["hit_rate"] > 0
    flood = field["flood"]
    assert flood.get("verdict", flood)["judged"] is True, flood
    assert flood["ok"] or "tenant isolation violated" in flood["error"]
    assert field["ok"] is flood["ok"]
