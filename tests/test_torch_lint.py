"""The JAX package's own checkers (hotstuff_tpu/analysis), run on the
port's counterparts of their default targets: every one reports no
finding, and the port carries the reference's ``# graftlint:``
annotations, line for line, in the files that mirror it.  AST and regex
only: nothing here imports a checked module.

Every default target of the JAX package has its counterpart in the
port (``threads`` scans ``harness/faults.py`` too).  Where the names
differ:

- ``padshape``, ``hotpath``: the JAX package's ``ops/kern`` Pallas
  modules have counterparts of other names (``ops/kern/*.py`` wrappers
  over ``csrc/``), scanned under the same directory target.
- ``obsgrammar``: its targets are fixed to ``hotstuff_tpu/obs/``; its
  ``check_sources`` takes the port's files under those names instead.
"""

from __future__ import annotations

import glob
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Checkers that take ``targets=``, with the module attribute naming their
# default targets.
CHECKERS = ("guardlint", "threads", "sockets", "tenantlint", "obsspan",
            "padshape", "hotpath", "ingress", "taint")

def _port_targets(targets) -> tuple:
    """The port's counterpart of each default target (C++ targets stay
    as they are); every one must exist."""
    out = []
    for t in targets:
        if not t.startswith("hotstuff_tpu/"):
            out.append(t)
            continue
        p = "hotstuff_tpu_torch/" + t[len("hotstuff_tpu/"):]
        assert glob.glob(os.path.join(REPO, p)), \
            f"{t} has no counterpart {p}"
        out.append(p)
    return tuple(out)


@pytest.mark.parametrize("name", CHECKERS)
def test_checker_reports_nothing_on_the_port(name):
    import importlib

    mod = importlib.import_module(f"hotstuff_tpu.analysis.{name}")
    targets = _port_targets(mod.DEFAULT_TARGETS)
    assert any(t.startswith("hotstuff_tpu_torch/") for t in targets)
    assert mod.check(REPO, targets=targets) == []


def test_new_modules_are_under_their_checkers():
    """Ported modules are targets of the checkers that scan their
    reference twins (ingress: loadgen; taint: txsign; threads: the fault
    injector)."""
    from hotstuff_tpu.analysis import ingress, taint, threads

    assert "hotstuff_tpu_torch/harness/loadgen.py" in \
        _port_targets(ingress.DEFAULT_TARGETS)
    assert "hotstuff_tpu_torch/crypto/txsign.py" in \
        _port_targets(taint.PY_TARGETS)
    assert "hotstuff_tpu_torch/harness/faults.py" in \
        _port_targets(threads.DEFAULT_TARGETS)


def _read(rel: str) -> str:
    with open(os.path.join(REPO, rel)) as f:
        return f.read()


def test_obsgrammar_holds_the_port_obs_to_the_node():
    """The node's TRACE and METRICS emit sites (native/) against the
    port's miners (obs/trace.py, obs/sampler.py), under the names the
    checker anchors on."""
    from hotstuff_tpu.analysis import obsgrammar as og

    sources = {og.TRACE_PY: _read("hotstuff_tpu_torch/obs/trace.py"),
               og.METRICS_PY: _read("hotstuff_tpu_torch/obs/sampler.py"),
               og.TRACE_CPP: _read(og.TRACE_CPP),
               og.METRICS_CPP: _read(og.METRICS_CPP)}
    assert og.check_sources(sources) == []
    # ...and it does fire on a miner that drifted from the node.
    bad = dict(sources)
    bad[og.TRACE_PY] = sources[og.TRACE_PY].replace(
        'r"stage=(\\w+) block=', 'r"stg=(\\w+) block=', 1)
    assert bad[og.TRACE_PY] != sources[og.TRACE_PY]
    assert og.check_sources(bad) != []


_ANNOTATION = re.compile(r"#\s*graftlint:\s*(.*\S)")


def _annotations(rel: str) -> list:
    return [m.group(1) for line in _read(rel).splitlines()
            for m in [_ANNOTATION.search(line)] if m]


# The files the port mirrors that carry annotations in the reference.
# The reference's other annotated files (ops/ed25519.py's
# nondonated-buffer, ops/kern/backend.py's pallas-interpret-in-prod,
# sidecar/sched/shapes.py's shard-misaligned-launch) name JAX-only
# rules whose sites the port does not have.
ANNOTATED = ("sidecar/service.py", "sidecar/guard.py", "sidecar/protocol.py")


@pytest.mark.parametrize("rel", ANNOTATED)
def test_graftlint_annotations_equal_the_reference(rel):
    ref = _annotations(f"hotstuff_tpu/{rel}")
    assert ref
    assert _annotations(f"hotstuff_tpu_torch/{rel}") == ref


def test_no_annotation_outside_the_mirrored_files():
    found = {}
    for path in glob.glob(os.path.join(REPO, "hotstuff_tpu_torch", "**",
                                       "*.py"), recursive=True):
        rel = os.path.relpath(path, os.path.join(REPO, "hotstuff_tpu_torch"))
        if _annotations(f"hotstuff_tpu_torch/{rel}"):
            found[rel] = len(_annotations(f"hotstuff_tpu_torch/{rel}"))
    assert set(found) == set(ANNOTATED)
    # The ten annotations that L1 restored, and protocol.py's three.
    assert found == {"sidecar/service.py": 8, "sidecar/guard.py": 2,
                     "sidecar/protocol.py": 3}


def test_a_dropped_annotation_is_found():
    """The checkers are live on the port: removing one restored
    annotation brings its finding back."""
    from hotstuff_tpu.analysis import guardlint

    rel = "hotstuff_tpu_torch/sidecar/guard.py"
    src = _read(rel)
    planted = src.replace(
        "        # graftlint: disable=unsupervised-launch\n", "", 1)
    assert planted != src
    found = guardlint.check_sources({rel: planted})
    assert [f.rule for f in found] == ["unsupervised-launch"]
