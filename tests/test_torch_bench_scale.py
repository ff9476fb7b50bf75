"""The port's ``committee_scale`` bench field (hotstuff_tpu_torch/
bench.py) against the root bench.py's, on eight CPU shards
(``virtual_mesh(8, "cpu")``) at committee 4: the same quorum and scan
shape, the root bench's keys plus the launches per shard of each route,
every route verifying every vote (a wrong mask raises).  Its own file so
that the ~35 s of sharded plain-version calls run beside the other bench
tests in a parallel run."""

from __future__ import annotations

import ast
import os

import bench as rbench
from hotstuff_tpu_torch import bench as pbench
from hotstuff_tpu_torch.parallel.shard_shapes import shard_bucket
from hotstuff_tpu_torch.sidecar.sched.shapes import quorum_sigs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_stats_keys() -> set:
    """Constant keys the root bench's committee_scale_probe stores into
    a committee's ``stats``, its dict literal's included; the f-string
    key as its three route names give it."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "committee_scale_probe")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", None) == "stats":
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and \
                        getattr(tgt.value, "id", None) == "stats":
                    if isinstance(tgt.slice, ast.Constant):
                        keys.add(tgt.slice.value)
                    else:
                        keys |= {f"{r}_sigs_per_s_chip" for r in
                                 ("per_sig_sharded", "rlc_sharded", "scan")}
    return keys


def test_committee_scale_on_eight_cpu_shards():
    src = open(os.path.join(REPO, "bench.py")).read()
    assert "SCAN_CHUNKS = 4" in src and pbench.SCAN_CHUNKS == 4
    field = pbench.committee_scale_probe((4,), repeats=1, device="cpu")
    assert set(field) == {"N4", "note"}
    stats = field["N4"]
    assert stats["quorum"] == quorum_sigs(4) == 3
    assert set(stats) == _ref_stats_keys() | {"launches_per_shard"}
    # A CPU shard verifies ~0.05 votes/s here, which rounds to 0.0 or
    # 0.1; the speedup is a ratio of the unrounded rates.
    for route in ("per_sig_sharded", "rlc_sharded", "scan"):
        assert stats[f"{route}_sigs_per_s_chip"] >= 0
    assert stats["rlc_speedup"] > 0
    shards = {str(i) for i in range(8)} | {"lead"}
    assert set(stats["launches_per_shard"]) == {"per_sig_sharded",
                                                "rlc_sharded", "scan"}
    assert all(set(v) == shards
               for v in stats["launches_per_shard"].values())
    # The scan's per-shard chunk rows follow the root bench's rule.
    assert shard_bucket(-(-3 // pbench.SCAN_CHUNKS), 8) == 1
    assert hasattr(rbench, "committee_scale_probe")
