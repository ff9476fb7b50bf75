"""The port's headline bench (hotstuff_tpu_torch/bench.py) against the
root bench.py, on the CPU at small sizes: the same triples, line shape,
operation model and probe schemas, and the departures it makes (no
degraded or cached line, the card's roofline rate, no
``msm_window_chunk``, the mesh fields in process).  The root bench is
imported as the oracle, and none of its functions that compile a JAX
program is called: the port's verdicts are held to the pure-Python
verifiers of both packages instead.  A plain per-signature verify of 8
rows takes ~1.2 s here, which sizes the device cases (G = 2, N = 8, one
round)."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

import bench as rbench
from hotstuff_tpu.crypto import ref_ed25519 as rref
from hotstuff_tpu_torch import bench as pbench
from hotstuff_tpu_torch.crypto import ref_ed25519 as pref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The root bench's field the port does not measure, for good: the port's
# K3 has no window-chunk constant.
NOT_MEASURED = {"msm_window_chunk"}


def _ref_tree():
    with open(os.path.join(REPO, "bench.py")) as f:
        return ast.parse(f.read())


def _ref_fn(name):
    return next(n for n in _ref_tree().body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _return_keys(name) -> set:
    """Keys of the dict literal a root-bench function returns last."""
    fn = _ref_fn(name)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)
           and isinstance(n.value, ast.Dict)][-1]
    return {k.value for k in ret.value.keys}


def _ref_line_keys() -> set:
    """The root bench's final line: emit()'s four keys and the keyword
    fields of main()'s last emit_final call."""
    emit = _ref_fn("emit")
    base = next(n.value for n in ast.walk(emit) if isinstance(n, ast.Assign)
                and isinstance(n.value, ast.Dict))
    calls = [n for n in ast.walk(_ref_fn("main")) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "emit_final"]
    final = max(calls, key=lambda c: len(c.keywords))
    return {k.value for k in base.keys} | {k.arg for k in final.keywords}


@pytest.fixture
def tmp_records(tmp_path, monkeypatch):
    """The bench's cache and last-line files in a scratch directory."""
    monkeypatch.setattr(pbench, "CACHE_PATH",
                        str(tmp_path / "headline_cache.json"))
    monkeypatch.setattr(pbench, "_LINE_CACHE_PATH",
                        str(tmp_path / "last_line.json"))
    monkeypatch.setattr(pbench, "_LAST_LINE", None)
    return tmp_path


def test_constants_and_budget_names_equal_the_reference():
    assert (pbench.N, pbench.G, pbench.ROUNDS, pbench.TRIALS) == \
        (rbench.N, rbench.G, rbench.ROUNDS, rbench.TRIALS)
    import hotstuff_tpu_torch.crypto.eddsa as peddsa

    assert pbench.N == peddsa.MAX_SUBBATCH
    with open(os.path.join(REPO, "hotstuff_tpu_torch", "bench.py")) as f:
        src = f.read()
    with open(os.path.join(REPO, "bench.py")) as f:
        ref_src = f.read()
    names = set(re.findall(r"HOTSTUFF_TPU_[A-Z_]+", src))
    assert names <= set(re.findall(r"HOTSTUFF_TPU_[A-Z_]+", ref_src))
    # The tunnel's probe retries and the degraded path's knobs went.
    assert not names & {"HOTSTUFF_TPU_PROBE_ATTEMPTS",
                        "HOTSTUFF_TPU_PROBE_WINDOW",
                        "HOTSTUFF_TPU_XFER_STREAMS"}


def test_make_batch_equals_the_reference(monkeypatch):
    monkeypatch.setattr(rbench, "G", 2)
    monkeypatch.setattr(rbench, "N", 3)
    assert pbench.make_batch(2, 3) == rbench.make_batch()
    msgs, pks, sigs = pbench.make_batch(1, 4)
    assert len(set(pks)) == 4
    assert all(pref.verify(p, m, s) and rref.verify(p, m, s)
               for m, p, s in zip(msgs, pks, sigs))
    assert pbench.cpu_baseline(msgs, pks, sigs) > 0


def test_ref_sigs_equal_the_reference():
    assert pbench._make_ref_sigs(3, seed=23) == rbench._make_ref_sigs(3,
                                                                     seed=23)


def test_emit_line_and_the_kill_handler(tmp_records, capfd):
    pbench.emit(1234.56, 2.5, device={"name": "x"})
    out = capfd.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line == {"metric": "ed25519-batch-verify", "value": 1234.6,
                    "unit": "sigs/sec", "vs_baseline": 2.5,
                    "device": {"name": "x"}}
    with open(pbench._LINE_CACHE_PATH) as f:
        assert json.load(f) == line
    # A kill re-prints the live line marked killed, and exits 1.
    codes = []
    handler = pbench.install_kill_handlers(exit=codes.append, signums=())
    handler(15, None)
    assert codes == [1]
    killed = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert killed == dict(line, killed="SIGTERM")


def test_no_cached_number_stands_in_for_a_run(tmp_records, capfd,
                                              monkeypatch):
    """A best on record rides beside a lower live value, never in its
    place; killed before any emit, the handler prints an error line,
    not the cached best (the root bench prints the cached one)."""
    monkeypatch.setattr(pbench, "kernel_fingerprint", lambda: "k1")
    pbench.save_cache(5000.0, 5.0, 1000.0)
    pbench.emit_final(4000.0, 1000.0, rlc={})
    line = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 4000.0 and line["vs_baseline"] == 4.0
    assert line["best_on_record"] == 5000.0
    assert line["best_vs_baseline"] == 5.0
    # Another kernel build: the record does not apply.
    monkeypatch.setattr(pbench, "kernel_fingerprint", lambda: "k2")
    pbench.emit_final(4000.0, 1000.0)
    assert "best_on_record" not in json.loads(
        capfd.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(pbench, "kernel_fingerprint", lambda: "k1")
    monkeypatch.setattr(pbench, "_LAST_LINE", None)
    codes = []
    pbench.install_kill_handlers(exit=codes.append, signums=())(14, None)
    line = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert codes == [1]
    assert line["value"] == 0 and line["killed"] == "SIGALRM"
    assert "error" in line and "source" not in line
    # Nor a subprocess on a forced-host mesh: the mesh fields run in
    # process (their probes keep the root bench's names).
    for name in ("emit_cached", "emit_cached_or_fail", "run_degraded",
                 "msm_chunk_sweep", "mesh_rlc_headline",
                 "committee_scale_headline", "cadence_headline",
                 "_forced_host_mesh_headline"):
        assert hasattr(rbench, name) and not hasattr(pbench, name)
    for name in ("mesh_rlc_probe", "committee_scale_probe",
                 "cadence_probe", "fleet_headline_probe"):
        assert hasattr(rbench, name) and hasattr(pbench, name)


def test_run_line_keys_are_the_reference_less_five_plus_device(
        tmp_records, capsys, monkeypatch):
    """run() on the CPU with every stage stubbed: the final line's keys
    are the root bench's, less the field not measured
    (``msm_window_chunk``), plus ``device``; a failed field is named and
    returned."""
    stub = {"ok": True}
    for name in ("rlc_compare", "roofline_headline", "viewchange_headline",
                 "sched_headline_probe", "chaos_headline_probe",
                 "trace_headline_probe", "surge_headline_probe",
                 "users_headline_probe", "mesh_rlc_probe",
                 "committee_scale_probe", "cadence_probe",
                 "fleet_headline_probe"):
        monkeypatch.setattr(pbench, name, lambda *a, **k: dict(stub))
    monkeypatch.setattr(pbench, "guard_headline_probe",
                        lambda *a, **k: {"ok": False})
    monkeypatch.setattr(pbench, "make_batch",
                        lambda g, n: (["m"] * (g * n),) * 3)
    monkeypatch.setattr(pbench, "cpu_baseline", lambda *a: 100.0)

    def fake_throughput(msgs, pks, sigs, on_trial, **kw):
        on_trial(150.0)
        return 200.0

    monkeypatch.setattr(pbench, "device_throughput", fake_throughput)
    failed = pbench.run("cpu", g=1, n=4)
    assert failed == ["guard"]
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [x["value"] for x in lines] == [150.0, 200.0]
    final = lines[-1]
    ref_keys = _ref_line_keys()
    assert NOT_MEASURED <= ref_keys
    assert set(final) == (ref_keys - NOT_MEASURED) | {"device"}
    assert final["vs_baseline"] == 2.0
    dev = final["device"]
    assert dev["name"] == "cpu" and dev["power_limit"] is None
    assert set(dev["launches"]) == set(pbench.DEVICE_STAGES)


def test_the_cli_raises_without_a_card():
    """No card: the CLI exits non-zero before printing any line (no CPU
    route, no cached number, no degraded line)."""
    proc = subprocess.run(
        [sys.executable, "-m", "hotstuff_tpu_torch.bench"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not [x for x in proc.stdout.splitlines() if x.startswith("{")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbench.probe_device()
    pbench.probe_device("cpu")


def test_roofline_model_equals_the_reference(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_TPU_CHIP_INT_OPS", "1.9e12")
    monkeypatch.setenv("HOTSTUFF_TPU_CHIP", "v5e")
    ref = rbench.roofline_estimate()
    port = pbench.roofline_estimate("cpu")
    assert {k: port[k] for k in ref} == ref
    assert port["chip_int_ops_source"] == "HOTSTUFF_TPU_CHIP_INT_OPS"
    monkeypatch.setenv("HOTSTUFF_TPU_CHIP_INT_OPS", "16.727e12")
    port = pbench.roofline_estimate("cpu")
    assert port["roofline_sigs_per_s_chip"] == round(
        16.727e12 / ref["int_ops_per_sig"], 1)
    # The field: one route, the card named, budget-skipped sizes.
    field = pbench.roofline_headline(budget_s=0, device="cpu")
    assert field["skipped"] and field["route"] == "cpu"
    assert field["card"] == "v5e" and "kern_default" not in field
    # Without an override the rate is the card's: none on the CPU.
    monkeypatch.delenv("HOTSTUFF_TPU_CHIP_INT_OPS")
    with pytest.raises(RuntimeError, match="no card rate"):
        pbench.card_int_ops("cpu")


def _tamper(sig: bytes) -> bytes:
    return sig[:1] + bytes([sig[1] ^ 0xFF]) + sig[2:]


def test_device_throughput_on_the_cpu():
    """G = 2 sub-batches of N = 8 through verify_packed_chunked on the
    kernels' plain versions: a positive rate, one program call for the
    warm-up and one a round; a tampered signature raises, as the root
    bench's assertion does."""
    msgs, pks, sigs = pbench.make_batch(2, 8)
    calls, trials = [], []
    rate = pbench.device_throughput(msgs, pks, sigs, trials.append,
                                    device="cpu", g=2, n=8, rounds=1,
                                    trials=1, calls=calls)
    assert rate > 0 and trials == [rate] and len(calls) == 2
    bad = list(sigs)
    bad[11] = _tamper(bad[11])
    assert not pref.verify(pks[11], msgs[11], bad[11])
    with pytest.raises(RuntimeError, match="must verify"):
        pbench.device_throughput(msgs, pks, bad, device="cpu", g=2, n=8,
                                 rounds=1, trials=1)


def test_rlc_compare_at_four_on_the_cpu():
    """The rlc field at n = 4: both programs' masks are all true (each
    call is checked inside), as both reference verifiers say."""
    out = pbench.rlc_compare((4,), repeats=1, device="cpu")
    assert set(out) == {"n4"}
    assert set(out["n4"]) == {"per_sig_sigs_per_s", "rlc_sigs_per_s",
                              "speedup"}
    assert out["n4"]["per_sig_sigs_per_s"] > 0
    msgs, pks, sigs = pbench._make_ref_sigs(4, seed=7)
    assert (msgs, pks, sigs) == rbench._make_ref_sigs(4, seed=7)
    assert all(pref.verify(p, m, s) and rref.verify(p, m, s)
               for m, p, s in zip(msgs, pks, sigs))
    assert pbench.rlc_compare((4,), budget_s=-1, device="cpu") == \
        {"n4": {"skipped": True}}


def test_viewchange_eject_at_committee_four_on_the_cpu():
    out = pbench.viewchange_headline((4,), repeats=1, device="cpu")
    assert set(out) == {"committees", "n4", "eject", "ok"}
    assert out["ok"] is True
    assert set(out["n4"]) == {"quorum", "batched_ms", "per_sig_ms",
                              "batched_sigs_per_s", "per_sig_sigs_per_s",
                              "speedup"}
    assert out["n4"]["quorum"] == 3
    # The same votes through both reference verifiers: exactly the
    # tampered signer is ejected.
    import numpy as np

    rng = np.random.default_rng(37)
    shared = rng.bytes(32)
    pks, sigs = [], []
    for _ in range(3):
        sk = rng.bytes(32)
        pks.append(rref.generate_keypair(sk)[1])
        sigs.append(rref.sign(sk, shared))
    eject = out["eject"]
    sigs[eject["tampered_index"]] = _tamper(sigs[eject["tampered_index"]])
    want = [i for i in range(3) if not rref.verify(pks[i], shared, sigs[i])]
    assert want == [i for i in range(3)
                    if not pref.verify(pks[i], shared, sigs[i])]
    assert eject == {"tampered_index": 1, "batch_rejected": True,
                     "ejected": want, "match_per_sig": True}


def test_trace_and_surge_equal_the_reference():
    """Deterministic probes (synthetic logs; a virtual clock): the same
    dicts as the root bench's."""
    assert pbench.trace_headline_probe() == rbench.trace_headline_probe()
    assert pbench.surge_headline_probe() == rbench.surge_headline_probe()


@pytest.mark.parametrize("plan,wan,slo,link", [
    (None, None, None, "probe-link"),
    ("0.01 sidecar kill; 0.03 sidecar restart",
     "node:0>sidecar latency_ms=2 name=l2", "sidecar-kill=100", "l2")])
def test_chaos_equals_the_reference_but_the_proxy_time(plan, wan, slo,
                                                       link):
    """The default plan, and --fault-plan / --wan / --slo specs (a kill
    judged against a 100 ms SLO it misses): the same fields as the root
    bench's."""
    port = pbench.chaos_headline_probe(plan, wan, slo)
    ref = rbench.chaos_headline_probe(plan, wan, slo)
    pw, rw = port.pop("wan"), ref.pop("wan")
    assert port == ref
    assert set(pw) == set(rw)
    pw.pop("proxy_roundtrip_ms")
    rw.pop("proxy_roundtrip_ms")
    assert pw == rw == {"links": [link], "tc_commands": 4,
                        "roundtrip_ok": True, "partition_enforced": True,
                        "healed": True}
    assert port["slo"]["ok"] is (slo is None)


def test_sched_and_guard_probes():
    """Host-mode engines: the sched field is an OP_STATS snapshot after
    one latency QC and one bulk batch; the guard field has the root
    bench's keys and passes its bar (its expected mask from the
    per-signature program's plain version)."""
    sched = pbench.sched_headline_probe()
    assert sched["paths"] == {"host": 2}
    assert sched["admitted"] == {"bulk": 1, "latency": 1}
    guard = pbench.guard_headline_probe("cpu")
    assert set(guard) == _return_keys("guard_headline_probe")
    assert guard["ok"] is True, guard
    for name in ("trace_headline_probe", "surge_headline_probe",
                 "chaos_headline_probe", "wan_headline_probe"):
        assert getattr(pbench, name).__doc__
