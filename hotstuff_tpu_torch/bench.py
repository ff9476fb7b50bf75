"""Headline benchmark of the port: Ed25519 batch verification throughput
on one NVIDIA card, the counterpart of the repository's root
``bench.py`` (the JAX package's).

    python -m hotstuff_tpu_torch.bench [--fault-plan P] [--wan W] [--slo S]

Prints ONE JSON line, re-printed as each timed trial improves; the last
line is the result:

  {"metric": "ed25519-batch-verify", "value": <sigs/sec on the card>,
   "unit": "sigs/sec", "vs_baseline": <card / single-core OpenSSL>,
   "rlc": ..., "roofline": ..., "viewchange": ..., "sched": ...,
   "chaos": ..., "trace": ..., "surge": ..., "guard": ..., "users": ...,
   "device": {"name": ..., "power_limit": ..., "launches": ...}}

The baseline is the same machine's single core verifying the same
signatures one by one through the ``cryptography`` library (OpenSSL's
Ed25519), measured fresh in every run.  The headline verifies rounds of
G = 16 sub-batches of N = 1024 distinct triples (the sidecar's largest
bulk launch) through ``ops/ed25519.verify_packed_chunked`` on (16, 1024)
tensors on the card; host preparation and the host-to-device copy of
round i+1 run on helper threads while the card runs round i, and the
verdicts (one all-reduced flag a round) are read after the last round.
Best of ``TRIALS`` trials of ``ROUNDS`` rounds.

The fields after the headline are the root bench's, measured by the
same procedures on the port:

  rlc         per-signature against RLC verify at n in {4, 16, 64, 256}
              (``HOTSTUFF_TPU_RLC_BUDGET`` s, default 300);
  roofline    RLC sigs/s at n in {64, 256, 1024} beside an int32
              operation roofline of the card
              (``HOTSTUFF_TPU_ROOFLINE_BUDGET``, default 300);
  viewchange  one batched launch against one host verify per sender for
              a TC's quorum at committees {20, 100, 300}, and the eject
              contract (``HOTSTUFF_TPU_VIEWCHANGE_BUDGET``, default 240);
  sched, guard, users
              host-mode ``VerifyEngine`` exercises of the scheduler's
              OP_STATS round trip, the wedge -> reboot -> canary ladder
              and the signed-ingress tier (``HOTSTUFF_TPU_USERS_BUDGET``,
              default 240);
  surge       the scheduler and its admission controller on a virtual
              clock under 4x a modeled drain;
  chaos, trace
              a fault plan (``--fault-plan``, ``--wan``, ``--slo`` or
              their ``HOTSTUFF_TPU_*`` variables) and synthetic replica
              logs through the real parsers and runners.

The control-plane probes prove the pipeline, not verification: the
card's work is in the headline, ``rlc``, ``roofline`` and ``viewchange``.
``device`` names the card as ``nvidia-smi --query-gpu=name,power.limit``
gives it (``name``, ``power_limit``), the baseline's library and rate,
each stage's seconds, the headline's program calls (the warm-up and one
a round), and the kernel launches of each stage that reaches the card
(``ops/kern.counting_to``), so a run shows its path went through the
kernels.  ``HOTSTUFF_TPU_BENCH_DEADLINE`` (default 3000 s) bounds the
whole run: past it the process re-prints its last line with ``killed``
and exits 1.

Departures from the root bench, each pinned by tests/test_torch_bench.py:

- No degraded mode and no cached number.  Without a card every entry
  raises (``device="cpu"`` runs the kernels' plain versions, for tests);
  a failed stage is named in its field and the run exits non-zero after
  its line.  The best line on record (``results/torch_headline_cache.
  json``, namespaced by ``ops/kern/build.source_hash()``) rides beside a
  live value as ``best_on_record`` and never replaces it.
- The roofline's rate is the card's: SMs x 64 int32 operations a clock
  x the maximum SM clock (``HOTSTUFF_TPU_CHIP_INT_OPS`` still
  overrides), and the field measures the port's one route.
- No ``msm_window_chunk`` field: the port's K3 has no window-chunk
  constant (two grids per MSM).
- ``mesh_rlc``, ``committee_scale``, ``cadence`` and ``fleet`` are not
  measured yet (ROADMAP.md Queue A).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from .crypto import eddsa, ref_ed25519 as ref
from .ops import ed25519 as E
from .ops import kern
from .utils.device import resolve

_BENCH_T0 = time.monotonic()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_budget_s() -> float:
    raw = os.environ.get("HOTSTUFF_TPU_BENCH_DEADLINE", "").strip()
    try:
        return float(raw) if raw else 3000.0
    except ValueError:
        return 3000.0


def budget_left_s(now=time.monotonic) -> float:
    """Seconds of the outer budget left (can go negative)."""
    return bench_budget_s() - (now() - _BENCH_T0)


def _env_budget(name: str, default: float) -> float:
    return float(os.environ.get(name, str(default)))


N = 1024          # sub-batch size: eddsa.MAX_SUBBATCH, the sidecar's cap
G = 16            # sub-batches a round
ROUNDS = 20       # timed pipelined rounds a trial
TRIALS = 4        # best of

CACHE_PATH = os.path.join(REPO, "results", "torch_headline_cache.json")
_LINE_CACHE_PATH = os.path.join(REPO, "results", "torch_last_line.json")


def kernel_fingerprint() -> str:
    """The kernels' source hash (the build directory's name): a best on
    record only ever stands beside a run of the same kernels."""
    from .ops.kern import build

    return build.source_hash()


def load_cache():
    try:
        with open(CACHE_PATH) as f:
            c = json.load(f)
        if c.get("value", 0) > 0 and \
                c.get("kernel") == kernel_fingerprint():
            return c
    except (OSError, ValueError):
        pass
    return None


def save_cache(value: float, vs_baseline: float, cpu: float):
    cached = load_cache()
    if cached and cached["value"] >= value:
        return
    # A contended host starves the single-core baseline and inflates the
    # ratio: never store a ratio whose baseline is far below the best
    # baseline on record.
    if cached and cpu < 0.8 * cached.get("cpu_baseline", 0):
        return
    os.makedirs(os.path.dirname(CACHE_PATH), exist_ok=True)
    tmp = CACHE_PATH + ".tmp"
    with open(tmp, "w") as f:
        json.dump({
            "metric": "ed25519-batch-verify",
            "value": round(value, 1),
            "unit": "sigs/sec",
            "vs_baseline": round(vs_baseline, 3),
            "cpu_baseline": round(cpu, 1),
            "kernel": kernel_fingerprint(),
            "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
        }, f)
    os.replace(tmp, CACHE_PATH)


# Every emitted line is kept in-process and written to disk before
# stdout, so a kill mid-print still leaves the last line measured.
_LAST_LINE = None


def emit(value: float, vs_baseline: float, **extra):
    global _LAST_LINE
    line = {"metric": "ed25519-batch-verify", "value": round(value, 1),
            "unit": "sigs/sec", "vs_baseline": round(vs_baseline, 3)}
    line.update(extra)
    _LAST_LINE = line
    try:
        os.makedirs(os.path.dirname(_LINE_CACHE_PATH), exist_ok=True)
        tmp = _LINE_CACHE_PATH + ".tmp"
        with open(tmp, "w") as f:
            json.dump(line, f)
        os.replace(tmp, _LINE_CACHE_PATH)
    except OSError:
        pass  # the disk copy is a convenience, never fatal
    print(json.dumps(line), flush=True)


def install_kill_handlers(exit=os._exit, signums=None):
    """SIGTERM/SIGALRM -> re-print the last line THIS run emitted with
    ``killed`` set (or an error line when it emitted none), then exit 1:
    a cut run is a failed run, and no cached number stands in for it.
    ``exit`` is injectable for the tests; returns the handler."""
    import signal as _signal

    def _handler(signum, frame):
        name = _signal.Signals(signum).name
        if _LAST_LINE is not None:
            out = dict(_LAST_LINE)
            out["killed"] = name
        else:
            out = {"metric": "ed25519-batch-verify", "value": 0,
                   "unit": "sigs/sec", "vs_baseline": 0, "killed": name,
                   "error": f"killed by {name} before any measurement"}
        # One write of pre-encoded bytes with a leading newline: the
        # signal may have cut a print mid-line.
        try:
            os.write(1, ("\n" + json.dumps(out) + "\n").encode("utf-8"))
        except OSError:
            pass
        exit(1)

    if signums is None:
        signums = (_signal.SIGTERM, _signal.SIGALRM)
    for s in signums:
        _signal.signal(s, _handler)
    return _handler


def emit_final(value: float, cpu: float, **extra):
    """The last line: the live measurement is ``value``; a higher best on
    record for these kernels rides beside it, never in its place."""
    cached = load_cache()
    if cached and cached["value"] > round(value, 1):
        emit(value, value / cpu,
             best_on_record=cached["value"],
             best_vs_baseline=cached["vs_baseline"],
             best_measured_at=cached.get("measured_at", "unknown"),
             note="live run below the best on record for these kernels",
             **extra)
    else:
        emit(value, value / cpu, **extra)


def card_info(device=None) -> dict:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it
    ({"name", "power_limit"}); on the CPU {"name": "cpu", ...: None}."""
    dev = resolve(device)
    if dev.type == "cpu":
        return {"name": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    lines = smi.stdout.strip().splitlines()
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    name, limit = (p.strip() for p in lines[index].split(",", 1))
    return {"name": name, "power_limit": limit}


def probe_device(device=None) -> None:
    """Launch the probe kernel K0 once on ``device`` and check x + 1;
    raises without a card (unless ``device="cpu"``) or on a wrong
    answer.  No retries: the card is local."""
    from .ops.kern.probe import probe

    dev = resolve(device)
    x = torch.arange(8 * 128, dtype=torch.int32).reshape(8, 128)
    got = probe(x.to(dev)).cpu()
    if not torch.equal(got, x + 1):
        raise RuntimeError(f"probe kernel K0 is wrong on {dev}")


def _make_ref_sigs(n: int, seed: int = 11):
    """n distinct (msg, pk, sig) triples from the pure-Python reference
    signer (the root bench's, byte for byte)."""
    rng = np.random.default_rng(seed)
    msgs, pks, sigs = [], [], []
    for _ in range(n):
        sk = rng.bytes(32)
        msg = rng.bytes(32)
        _, pk = ref.generate_keypair(sk)
        msgs.append(msg)
        pks.append(pk)
        sigs.append(ref.sign(sk, msg))
    return msgs, pks, sigs


def _best_sigs_per_s(fn, m, p, s, repeats: int, what: str) -> float:
    """Warm-up call and correctness guard, then the best of ``repeats``
    timed calls of ``fn`` (every signature valid)."""
    n = len(m)
    if not fn(m, p, s).all():
        raise RuntimeError(f"{what} verify failed at n={n}")
    best = 0.0
    for _ in range(repeats):
        t = time.perf_counter()
        mask = fn(m, p, s)
        dt = time.perf_counter() - t
        if not mask.all():
            raise RuntimeError(f"{what} verify failed at n={n}")
        best = max(best, n / dt)
    return best


def rlc_compare(sizes=(4, 16, 64, 256), repeats: int = 2,
                budget_s: float | None = None, device=None) -> dict:
    """Per-signature against RLC batch verify at quorum sizes n -> the
    ``rlc`` field: {"nN": {"per_sig_sigs_per_s", "rlc_sigs_per_s",
    "speedup"}} or {"skipped": true} past ``budget_s``.  Each size's
    first call of each program is its warm-up and correctness guard,
    outside the timed calls."""
    dev = resolve(device)
    t0 = time.perf_counter()
    msgs, pks, sigs = _make_ref_sigs(max(sizes), seed=7)
    progs = (("per_sig", lambda m, p, s: eddsa.verify_batch(
                  m, p, s, device=dev)),
             ("rlc", lambda m, p, s: eddsa.verify_batch_rlc(
                  m, p, s, device=dev)))
    out = {}
    for n in sizes:
        if budget_s is not None and time.perf_counter() - t0 > budget_s:
            out[f"n{n}"] = {"skipped": True}
            continue
        stats = {}
        for name, fn in progs:
            stats[f"{name}_sigs_per_s"] = round(_best_sigs_per_s(
                fn, msgs[:n], pks[:n], sigs[:n], repeats, name), 1)
        stats["speedup"] = round(
            stats["rlc_sigs_per_s"] / stats["per_sig_sigs_per_s"], 3)
        out[f"n{n}"] = stats
    return out


# An SM of compute capability 9.0 retires 64 32-bit integer operations a
# clock (CUDA C++ Programming Guide, arithmetic instruction throughput).
INT32_OPS_PER_SM_CLOCK = 64


def card_int_ops(device=None) -> tuple[str, float, str]:
    """(chip name, int32 operations a second, where the rate came from).
    ``HOTSTUFF_TPU_CHIP_INT_OPS`` (and ``HOTSTUFF_TPU_CHIP``) override,
    as in the root bench; else the card's properties: SMs x 64 x the
    maximum SM clock.  On the CPU there is no card rate to read."""
    dev = resolve(device)
    raw = os.environ.get("HOTSTUFF_TPU_CHIP_INT_OPS", "").strip()
    if raw:
        name = os.environ.get("HOTSTUFF_TPU_CHIP") or (
            torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
        return name, float(raw), "HOTSTUFF_TPU_CHIP_INT_OPS"
    if dev.type != "cuda":
        raise RuntimeError("no card rate on the CPU: set "
                           "HOTSTUFF_TPU_CHIP_INT_OPS")
    props = torch.cuda.get_device_properties(dev)
    clock_khz = props.clock_rate
    rate = (props.multi_processor_count * INT32_OPS_PER_SM_CLOCK
            * clock_khz * 1e3)
    source = (f"{props.multi_processor_count} SMs x "
              f"{INT32_OPS_PER_SM_CLOCK} x {clock_khz / 1e3:.0f} MHz")
    return os.environ.get("HOTSTUFF_TPU_CHIP") or props.name, rate, source


def roofline_estimate(device=None) -> dict:
    """Arithmetic int-op roofline for one card: the root bench's
    per-signature operation model of the RLC verify path (one field mul
    = 32x63 multiply-add pairs + the wrap-38 fold + 4 carry steps over 32
    limbs; ~265 muls per decompressed point x 2; the MSM's 16-entry
    tables and 64 windows of ~1 tree add a point x 2 points a
    signature), over the card's int32 rate (``card_int_ops``).  An
    estimate with stated knobs, not a measurement."""
    ops_per_mul = 32 * 63 * 2 + 63 + 4 * 32 * 4          # ~4.6e3
    muls_decompress = 2 * 265                            # A and R
    muls_table = 2 * (14 * 8 + 16)
    muls_windows = 2 * 64 * (8 + 4)  # tree add + amortized cached/horner
    muls_per_sig = muls_decompress + muls_table + muls_windows
    int_ops_per_sig = muls_per_sig * ops_per_mul
    chip, chip_int_ops, source = card_int_ops(device)
    return {
        "model": "rlc-straus int-op estimate",
        "field_muls_per_sig": muls_per_sig,
        "int_ops_per_sig": int_ops_per_sig,
        "chip": chip,
        "chip_int_ops_per_s": chip_int_ops,
        "chip_int_ops_source": source,
        "roofline_sigs_per_s_chip": round(chip_int_ops / int_ops_per_sig,
                                          1),
    }


def roofline_headline(sizes=(64, 256, 1024), repeats: int = 2,
                      budget_s: float | None = None, device=None) -> dict:
    """The ``roofline`` field: measured RLC sigs/s on the card at quorum
    sizes n beside ``roofline_estimate``.  The port has one route (the
    kernels, on a CUDA tensor), so each size has one entry
    {"sigs_per_s_chip", "pct_of_roofline"}, or {"skipped": true} past
    ``budget_s``."""
    dev = resolve(device)
    if budget_s is None:
        budget_s = _env_budget("HOTSTUFF_TPU_ROOFLINE_BUDGET", 300)
    est = roofline_estimate(dev)
    out = {"est": est, "chips": 1, "route": dev.type,
           "card": est["chip"]}
    if budget_s <= 0:
        out["skipped"] = True
        return out
    t0 = time.perf_counter()
    msgs, pks, sigs = _make_ref_sigs(max(sizes), seed=29)
    roof = est["roofline_sigs_per_s_chip"]

    def rlc(m, p, s):
        return eddsa.verify_batch_rlc(m, p, s, device=dev)

    for n in sizes:
        if time.perf_counter() - t0 > budget_s:
            out[f"n{n}"] = {"skipped": True}
            continue
        best = _best_sigs_per_s(rlc, msgs[:n], pks[:n], sigs[:n],
                                repeats, "RLC")
        out[f"n{n}"] = {"sigs_per_s_chip": round(best, 1),
                        "pct_of_roofline": round(100.0 * best / roof, 2)}
    return out


def viewchange_headline(committees=(20, 100, 300), repeats: int = 2,
                        budget_s: float | None = None, device=None) -> dict:
    """The ``viewchange`` field: batched against per-signature TC
    assembly latency at committee sizes N.  The quorum's (2N/3+1)
    timeout votes over one shared digest are verified as one
    ``eddsa.verify_batch`` launch on the card and one at a time through
    the pure-Python reference verifier (the per-sender host path).  The
    eject contract, once a run: a tampered candidate fails the batch, and
    the batch mask names exactly the signers that per-signature
    verification rejects.  Committees past ``budget_s`` report
    {"skipped": true}."""
    from .sidecar.sched.shapes import quorum_sigs

    dev = resolve(device)
    if budget_s is None:
        budget_s = _env_budget("HOTSTUFF_TPU_VIEWCHANGE_BUDGET", 240)
    out = {"committees": list(committees)}
    if budget_s <= 0:
        out["skipped"] = True
        return out
    t0 = time.perf_counter()
    rng = np.random.default_rng(37)
    shared = rng.bytes(32)
    max_q = quorum_sigs(max(committees))
    pks, sigs = [], []
    for _ in range(max_q):
        sk = rng.bytes(32)
        _, pk = ref.generate_keypair(sk)
        pks.append(pk)
        sigs.append(ref.sign(sk, shared))

    def batched(m, p, s):
        return eddsa.verify_batch(m, p, s, device=dev)

    for n in committees:
        if time.perf_counter() - t0 > budget_s:
            out[f"n{n}"] = {"skipped": True}
            continue
        q = quorum_sigs(n)
        m, p, s = [shared] * q, pks[:q], sigs[:q]
        batched_ms = q / _best_sigs_per_s(batched, m, p, s, repeats,
                                          "batched TC") * 1e3
        t = time.perf_counter()
        for mi, pi, si in zip(m, p, s):
            if not ref.verify(pi, mi, si):
                raise RuntimeError(f"per-sig TC verify failed at q={q}")
        per_sig_ms = (time.perf_counter() - t) * 1e3
        out[f"n{n}"] = {
            "quorum": q,
            "batched_ms": round(batched_ms, 2),
            "per_sig_ms": round(per_sig_ms, 2),
            "batched_sigs_per_s": round(q / (batched_ms / 1e3), 1),
            "per_sig_sigs_per_s": round(q / (per_sig_ms / 1e3), 1),
            "speedup": round(per_sig_ms / batched_ms, 3),
        }

    q = quorum_sigs(min(committees))
    bad_i = q // 2
    bad_sigs = list(sigs[:q])
    bad_sigs[bad_i] = bad_sigs[bad_i][:1] + \
        bytes([bad_sigs[bad_i][1] ^ 0xFF]) + bad_sigs[bad_i][2:]
    mask = [bool(b) for b in batched([shared] * q, pks[:q], bad_sigs)]
    per_sig = [ref.verify(pk, shared, sg)
               for pk, sg in zip(pks[:q], bad_sigs)]
    out["eject"] = {
        "tampered_index": bad_i,
        "batch_rejected": not all(mask),
        "ejected": [i for i, ok in enumerate(mask) if not ok],
        "match_per_sig": mask == per_sig,
    }
    measured = [v for k, v in out.items()
                if k.startswith("n") and isinstance(v, dict)
                and "speedup" in v]
    out["ok"] = bool(measured) and out["eject"]["match_per_sig"] and \
        out["eject"]["batch_rejected"]
    return out


def trace_headline_probe() -> dict:
    """The headline's ``trace`` field: prove the grafttrace pipeline end
    to end without booting a committee.  Synthetic replica logs with a
    KNOWN clock skew run through the REAL node-TRACE parser
    (obs/trace.py — the exact regex that mines live node logs), the
    RTT-midpoint offset estimator, per-block stitching (one block's
    trace is deliberately partial: a dropped span must degrade the
    sample count, not the breakdown), the critical-path percentiles,
    the graftscope ctx join (block aaa= carries a full sidecar chain,
    block ccc= verifies but has none — join_rate must come out 0.5 and
    the device sub-segment must appear), and a Chrome-trace JSON
    serialization round trip.  Keys: blocks, complete, segments
    ({name: {n, p50_ms, p99_ms}}), join ({committed, with_verify,
    joined, rate}), join_rate, chrome_events, offset_applied_ms,
    roundtrip_ok."""
    import json as _json

    from .obs import trace as obstrace

    def line(sec, stage, block, rnd):
        return (f"[2026-08-03T12:00:{sec:06.3f}Z INFO consensus::core] "
                f"TRACE stage={stage} block={block} round={rnd}")

    # Replica 0: the reference clock.  Block bbb='s trace is partial
    # (no verify stages — the cached-certificate path); block ccc=
    # verifies but its sidecar chain is deliberately MISSING (every
    # replica answered from the verdict-cache fast path), so the join
    # rate must degrade, not the trace.
    log_a = "\n".join([
        line(1.000, "proposal", "aaa=", 2),
        line(1.010, "verify_submit", "aaa=", 2),
        line(1.034, "verify_reply", "aaa=", 2),
        line(1.050, "commit", "aaa=", 2),
        line(1.100, "proposal", "bbb=", 3),
        line(1.180, "commit", "bbb=", 3),
        line(1.200, "proposal", "ccc=", 4),
        line(1.210, "verify_submit", "ccc=", 4),
        line(1.230, "verify_reply", "ccc=", 4),
        line(1.260, "commit", "ccc=", 4),
    ])
    # Replica 1: same events observed later, stamped by a clock running
    # a known skew AHEAD — alignment must bring them back onto (not
    # before) the reference observations.
    skew_s = 0.125
    log_b = "\n".join([
        line(1.020 + skew_s, "proposal", "aaa=", 2),
        line(1.060 + skew_s, "commit", "aaa=", 2),
    ])
    spans = obstrace.parse_node_trace(log_a, host="node-0.log")
    spans_b = obstrace.parse_node_trace(log_b, host="node-1.log")
    # Offset probe with synthetic stamps: local sends at t, the skewed
    # host answers mid-flight, local receives at t + rtt.
    rtt = 0.004
    probes = [(t, t + rtt / 2 + skew_s, t + rtt) for t in (5.0, 6.0, 7.0)]
    offset = obstrace.estimate_offset(probes)
    spans += obstrace.apply_offset(spans_b, offset)
    traces = obstrace.stitch_blocks(spans)
    summary = obstrace.critical_path(traces)
    # Sidecar chain for block aaa= only: per-request spans tagged ctx,
    # the launch-level device span tagged ctxs — the protocol-v5 schema
    # the live sidecar emits.
    sidecar_spans = [
        {"stage": "admit", "t": 1785751201.005, "dur_ms": 0.0, "rid": 1,
         "cls": "latency", "ctx": "aaa="},
        {"stage": "queue", "t": 1785751201.01, "dur_ms": 1.5, "rid": 1,
         "cls": "latency", "ctx": "aaa="},
        {"stage": "device", "t": 1785751201.02, "dur_ms": 18.0, "rid": 1,
         "ctxs": ["aaa="]},
        {"stage": "reply", "t": 1785751201.04, "dur_ms": 0.0, "rid": 1,
         "cls": "latency", "ctx": "aaa="},
    ]
    join, joined = obstrace.join_blocks(
        traces, obstrace.chain_spans(sidecar_spans))
    if joined:
        summary["segments"][obstrace.DEVICE_SEGMENT] = \
            obstrace.device_subsegment(joined)
    chrome = obstrace.chrome_trace(traces, sidecar_spans, joined=joined)
    decoded = _json.loads(_json.dumps(chrome))
    events = decoded.get("traceEvents", [])
    roundtrip_ok = (
        len(events) == len(chrome["traceEvents"])
        and all(e.get("ph") in ("X", "M") for e in events)
        and all(isinstance(e.get("ts", 0), (int, float)) for e in events)
        # the joined chain must land nested in the block's row
        and any(e.get("name") == "sidecar:device"
                and e.get("args", {}).get("block") == "aaa="
                for e in events))
    return {
        "blocks": summary["blocks"],
        "complete": summary["complete"],
        "segments": summary["segments"],
        "join": join,
        "join_rate": join["rate"],
        "chrome_events": len(events),
        "offset_applied_ms": round(offset * 1e3, 3),
        "roundtrip_ok": roundtrip_ok,
    }


def sched_headline_probe() -> dict:
    """Round-trip the verifysched STATS counters through the wire
    encoding and return the decoded snapshot for the headline's "sched"
    field: a host-mode VerifyEngine verifies one latency-class QC and one
    bulk-class batch through the real scheduler, then the snapshot goes
    protocol.encode_stats_reply -> decode_reply_raw -> decode_stats_body
    — the exact bytes a sidecar client would see."""
    import threading

    from .sidecar import protocol as proto
    from .sidecar import sched as vsched
    from .sidecar.service import VerifyEngine

    msgs, pks, sigs = _make_ref_sigs(6, seed=23)
    engine = VerifyEngine(use_host=True)
    try:
        done = []
        cond = threading.Condition()

        def reply(mask):
            with cond:
                done.append(mask)
                cond.notify()

        engine.submit(proto.VerifyRequest(1, msgs[:4], pks[:4], sigs[:4]),
                      reply, cls=vsched.LATENCY)
        engine.submit(proto.VerifyRequest(2, msgs[4:], pks[4:], sigs[4:]),
                      reply, cls=vsched.BULK)
        with cond:
            cond.wait_for(lambda: len(done) == 2, timeout=60.0)
        frame = proto.encode_stats_reply(7, engine.stats_snapshot())
        opcode, rid, body = proto.decode_reply_raw(frame[4:])
        if (opcode, rid) != (proto.OP_STATS, 7):
            raise RuntimeError("stats reply framing mismatch")
        return proto.decode_stats_body(body)
    finally:
        engine.stop()


# Miniature default plan for the headline probe: one of every fault
# class — including a graftsurge flash crowd — timed inside a tenth of
# a (virtual) second.
_DEFAULT_CHAOS_SPEC = ("0.01 sidecar kill; 0.04 sidecar restart; "
                       "0.02 node:1 pause; 0.05 node:1 resume; "
                       "0.06 sidecar degrade shed=1; "
                       "0.07 client:0 surge x5 for 0.02")

# Miniature default WAN spec for the headline probe: one shaped
# node->sidecar link, small enough that the loopback proxy round trip
# stays in the tens of milliseconds.
_DEFAULT_WAN_SPEC = "node:0>sidecar latency_ms=5 name=probe-link"


def wan_headline_probe(wan_spec=None) -> dict:
    """The ``chaos.wan`` sub-field: prove the graftwan pipeline end to
    end without a committee or root.  The spec (--wan, or a miniature
    default) runs through the REAL parser, is compiled to the per-host
    ``tc netem`` command list a fleet run would install, and is then
    realized by a real loopback WanProxy: a byte round-trips through the
    shaped link (paying its latency both ways), ``partition()`` must
    black-hole a fresh connection, and ``heal()`` must restore it — the
    exact executors a live ``--wan`` run uses, local and remote."""
    import socket as _socket
    import threading as _threading

    from .chaos import WanProxy, parse_wan
    from .chaos.netem import tc_setup_commands

    spec = parse_wan(wan_spec if wan_spec else _DEFAULT_WAN_SPEC)
    peers = {"node:0": "10.0.0.10", "node:1": "10.0.0.11",
             "sidecar": "10.0.0.99"}
    tc_commands = sum(
        len(tc_setup_commands(spec, f"node:{i}", peers)) for i in range(2))

    # Loopback echo server the proxy forwards to.
    server = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    server.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
    server.bind(("127.0.0.1", 0))
    server.listen(4)
    server.settimeout(10.0)

    def _echo():
        try:
            while True:
                conn, _ = server.accept()
                conn.settimeout(10.0)
                try:
                    data = conn.recv(64)
                    if data:
                        conn.sendall(data)
                finally:
                    conn.close()
        except OSError:
            pass

    _threading.Thread(target=_echo, daemon=True).start()
    shape = spec.links[0].shape if spec.links else None
    proxy = WanProxy(server.getsockname(), shape=shape)
    proxy.start()
    try:
        if not proxy.wait_ready(10.0):
            raise RuntimeError("WanProxy readiness gate never passed")
        def _roundtrip():
            with _socket.create_connection(("127.0.0.1", proxy.port),
                                           timeout=10.0) as c:
                c.settimeout(10.0)
                c.sendall(b"ping")
                return c.recv(64)

        def _try_roundtrip(attempts=5):
            # A lossy shape DROPS connections by design (see WanProxy);
            # a dialing peer just reconnects, so the probe does too.  A
            # spec lossy enough to defeat every attempt reports
            # ok/healed False rather than erroring the whole sub-field.
            # Returns the RTT of the one SUCCESSFUL attempt (None if
            # all fail): timing the whole retry loop would fold failed
            # dials and dropped attempts into the published number.
            for _ in range(attempts):
                try:
                    t0 = time.perf_counter()
                    if _roundtrip() == b"ping":
                        return (time.perf_counter() - t0) * 1e3
                except OSError:
                    pass
            return None

        rtt_ms = _try_roundtrip()
        proxy.partition()
        try:
            partitioned = _roundtrip() != b"ping"
        except OSError:
            partitioned = True  # dropped connection IS the black-hole
        proxy.heal()
        healed = _try_roundtrip() is not None
        return {
            "links": spec.link_names(),
            "tc_commands": tc_commands,
            "proxy_roundtrip_ms": round(rtt_ms, 3)
            if rtt_ms is not None else None,
            "roundtrip_ok": rtt_ms is not None,
            "partition_enforced": partitioned,
            "healed": healed,
        }
    finally:
        proxy.stop()
        server.close()


def chaos_headline_probe(plan_spec=None, wan_spec=None,
                         slo_spec=None) -> dict:
    """The headline's ``chaos`` field: prove the graftchaos pipeline end
    to end without booting a committee.  The fault plan (the passed
    ``--fault-plan``, or a miniature default) runs through the REAL
    parser and PlanRunner against a recording injector on a virtual
    clock (instant, regardless of the plan's timescale); the executed
    events round-trip through the JSON contract the harness writes to
    logs/chaos-events.json; and recovery latencies come from the same
    ``summarize_recovery`` the LogParser folds into a live run summary —
    commits are synthesized 250 ms after each event, so a healthy
    pipeline reports ``recovered: true`` with per-event latencies.

    graftwan: the recoveries are additionally judged against the
    per-fault-class SLO table (``slo`` sub-field, chaos/slo.judge — the
    same verdicts the LogParser raises on), and the WAN link-shape
    pipeline is proven by ``wan_headline_probe`` (``wan`` sub-field)."""
    import json as _json

    from .chaos import PlanRunner, judge, parse_plan, \
        parse_slos, summarize_recovery

    plan = parse_plan(plan_spec if plan_spec else _DEFAULT_CHAOS_SPEC)

    class _NullInjector:
        def apply(self, event):
            pass  # the probe measures the pipeline, not real processes

    base_wall = 1_700_000_000.0
    now = [0.0]

    def clock():
        return now[0]

    def sleep(dt):
        now[0] += dt

    runner = PlanRunner(plan, _NullInjector(), clock=clock, sleep=sleep,
                        wall=lambda: base_wall + now[0])
    runner.start(t0=0.0)
    runner.join(timeout=60.0)
    # The on-disk/wire contract: what the harness persists is what the
    # parser reads back.
    events = _json.loads(_json.dumps(runner.events()))
    commits = [e["wall"] + 0.25 for e in events]
    summary = summarize_recovery(events, commits)
    slo_verdict = judge(summary, parse_slos(slo_spec))
    try:
        wan = wan_headline_probe(wan_spec)
    except Exception as e:  # noqa: BLE001 — sub-probe isolation
        wan = {"error": f"{e!r:.120}"}
    return {
        "plan_events": len(plan.events),
        "executed": len(events),
        "recovered": summary["recovered"],
        "injected_ok": summary["injected_ok"],
        "max_recovery_ms": summary["max_recovery_ms"],
        "events": summary["events"],
        "slo": slo_verdict,
        "wan": wan,
    }


def surge_headline_probe(offered_x: float = 4.0,
                         seconds: float = 3.0) -> dict:
    """The headline's ``surge`` field: prove the graftsurge overload
    pipeline end to end without booting a committee.

    A seeded heavy-tailed multi-user generator (harness/loadgen.py, the
    python twin of the C++ client's UserLoadModel) offers ``offered_x``
    times a modeled drain capacity of BULK verify work, plus a steady
    consensus-class stream, into the REAL verifysched scheduler with its
    REAL surge admission controller on a virtual clock.  Shed bulk
    requests feed BUSY backoff hints back into the generator — the full
    backpressure loop.  The probe then proves the OP_BUSY wire round
    trip (protocol v4 encode -> decode -> SidecarOverloaded with the
    retry hint attached) and the metrics-driven recovery-to-baseline SLO
    judge on a synthetic sampled series with a blackout.

    The acceptance bar rides in ``ok``: at >= 3x offered overload the
    consensus-class wait p99 stays bounded (no queue collapse), sheds
    are bulk-before-latency (zero latency sheds, zero fairness
    violations), and the surge event is judged PASS by the
    recovery-to-baseline judge."""
    from .chaos import judge_baseline_recovery
    from .harness.loadgen import UserLoad
    from .sidecar import protocol as proto
    from .sidecar import sched as vsched
    from .sidecar.client import SidecarClient, \
        SidecarOverloaded

    TICK_S = 0.01
    CAP_SIGS_PER_TICK = 128       # modeled device drain per tick
    QC_SIGS = 16                  # one consensus verify
    LAT_PER_TICK = 2              # consensus offers per tick (well
                                  # under capacity: it must never shed)
    BULK_REQ_SIGS = 32
    cap_sigs_per_s = CAP_SIGS_PER_TICK / TICK_S
    bulk_req_rate = offered_x * cap_sigs_per_s / BULK_REQ_SIGS

    sched = vsched.Scheduler(latency_cap_sigs=4 * 1024,
                             bulk_cap_sigs=8 * 1024)
    # Coalesce at the modeled per-tick drain so launch granularity and
    # drain capacity speak the same units (the real engine's cap is the
    # compiled-shape budget; here the "device" IS the tick budget).
    sched.shapes.launch_cap = CAP_SIGS_PER_TICK
    adm = sched.admission
    load = UserLoad(rate=bulk_req_rate, users=200, seed=11)

    rid = [0]

    def request(n):
        rid[0] += 1
        recs = [rid[0].to_bytes(6, "big") + i.to_bytes(2, "big")
                for i in range(n)]
        return proto.VerifyRequest(rid[0], recs, recs, recs)

    offered_at = {}
    lat_waits = []
    lat_offered = bulk_offered = 0
    ticks = int(round(seconds / TICK_S))
    for k in range(1, ticks + 1):
        t = k * TICK_S
        for _ in range(LAT_PER_TICK):
            req = request(QC_SIGS)
            offered_at[req.request_id] = t
            lat_offered += 1
            sched.offer(req, lambda m: None, cls=vsched.LATENCY)
        for _ in range(load.arrivals(t)):
            bulk_offered += 1
            if not sched.offer(request(BULK_REQ_SIGS), lambda m: None,
                               cls=vsched.BULK):
                # The generator honors the BUSY hint: per-user backoff.
                load.busy(t, sched.retry_after_ms(vsched.BULK) / 1e3)
        budget = CAP_SIGS_PER_TICK
        while budget > 0:
            launch = sched.next_launch(block=False)
            if launch is None:
                break
            for p in launch.items:
                if p.cls == vsched.LATENCY:
                    lat_waits.append(
                        (t - offered_at.pop(p.request.request_id, t))
                        * 1e3)
            budget -= launch.total_sigs
            # Pipeline evidence for the derate controller: a tick whose
            # offered load exceeds drain capacity packs in the open
            # (overlap collapsed) — exactly the surge regime.
            adm.note_pack(0.001, hidden=offered_x <= 1.0)
    snap = adm.snapshot()
    lat_waits.sort()
    wait_p99 = lat_waits[int(0.99 * (len(lat_waits) - 1))] \
        if lat_waits else 0.0

    # OP_BUSY wire round trip: server encode -> client decode -> the
    # typed overload error with the retry hint attached.
    frame = proto.encode_busy_reply(9, 137)
    opcode, brid, body = proto.decode_reply_raw(frame[4:])
    try:
        SidecarClient._unwrap(opcode, body)
        busy_ok, hint = False, None
    except SidecarOverloaded as e:
        hint = e.retry_after_ms
        busy_ok = brid == 9 and hint == 137

    # Metrics-driven recovery-to-baseline judge on a synthetic series:
    # steady 1000 sigs/s, a surge-window blackout, then recovery.
    base_wall = 1_700_000_000.0
    samples = []
    launched = 0
    for s in range(31):
        t = base_wall + s
        if 10 <= s < 13:
            samples.append({"t": t, "ok": False, "error": "surge"})
            continue
        launched += 1000
        samples.append({"t": t, "ok": True,
                        "stats": {"sigs_launched": launched}})
    surge_event = {"t": 10.0, "target": "client:0", "action": "surge",
                   "wall": base_wall + 10, "ok": True,
                   "params": {"x": 5, "for": 3}}
    baseline = judge_baseline_recovery(samples, [surge_event])

    ok = (offered_x >= 3.0
          and wait_p99 <= 3 * TICK_S * 1e3
          and snap["shed"].get(vsched.LATENCY, 0) == 0
          and snap["shed"].get(vsched.BULK, 0) > 0
          and snap["fairness_violations"] == 0
          and busy_ok
          and baseline["ok"] and baseline["judged"] == 1)
    return {
        "offered_x": offered_x,
        "ticks": ticks,
        "latency": {
            "offered": lat_offered,
            "shed": snap["shed"].get(vsched.LATENCY, 0),
            "wait_p99_ms": round(wait_p99, 3),
        },
        "bulk": {
            "offered": bulk_offered,
            "admitted": snap["admitted"].get(vsched.BULK, 0),
            "shed": snap["shed"].get(vsched.BULK, 0),
            "deferred_by_busy": load.deferred,
        },
        "fairness_violations": snap["fairness_violations"],
        "bulk_before_latency": snap["shed"].get(vsched.LATENCY, 0) == 0,
        "derate": snap["derate"],
        "busy_roundtrip": {"ok": busy_ok, "retry_after_ms": hint},
        "baseline_slo": baseline,
        "ok": ok,
    }


def users_headline_probe(populations=(100_000, 1_000_000),
                         txs_per_point: int = 96,
                         budget_s: float | None = None) -> dict:
    """The headline ``users`` field (graftingress): the signed ingress
    tier at user-population scale, end to end in process.

    Per population U the seeded generator names which user each arrival
    belongs to (``UserLoad.arrivals(out_users=...)`` — the same contract
    the C++ client's UserLoadModel grew), the probe derives that user's
    Ed25519 keypair on FIRST arrival through the bounded
    ``txsign.UserKeyring`` LRU, builds version-2 signed frames with a
    seeded ~1% forgery mix (at least one forged frame per point, so the
    rejection rate is always a measured number), turns each frame into
    its admission (digest, pk, sig) record, and submits QC-shaped
    batches to a host-mode VerifyEngine as INGRESS_CTX-tagged bulk
    requests — the exact class + ctx tag the mempool admission-verify
    stage uses, so the engine's OP_STATS ``ingress`` section must report
    the lane 100% ingress-fed.  Key generation and signing run OUTSIDE
    the timed region; ``verified_goodput_sigs_per_s`` times only the
    verify drive (host-mode reference verify: honest relative to the
    other points, never comparable to device throughput).

    Populations that miss ``budget_s`` report ``{"skipped": true}``.
    Acceptance bar in ``ok``: every forged frame rejected, every honest
    frame verified, goodput positive, and the bulk lane fully
    ingress-fed on every completed point."""
    import random
    import threading

    from .crypto import txsign
    from .harness.loadgen import UserLoad
    from .sidecar import protocol as proto
    from .sidecar import sched as vsched
    from .sidecar.service import VerifyEngine

    if budget_s is None:
        budget_s = float(
            os.environ.get("HOTSTUFF_TPU_USERS_BUDGET", "240"))
    t0 = time.perf_counter()
    out = {"mix_forge_pct": 1.0, "txs_per_point": txs_per_point}
    BATCH = 32

    for pop in populations:
        key = f"u{pop}"
        if time.perf_counter() - t0 > budget_s:
            out[key] = {"skipped": True}
            continue
        # Arrival stream on a virtual clock: with U users at a fixed
        # aggregate rate, a short window touches ~txs_per_point DISTINCT
        # users (per-user gaps are U/rate seconds) — the population knob
        # stresses the key-derivation path, not the verify path.
        load = UserLoad(rate=64.0, users=pop, seed=13)
        arrivals: list = []
        tick = 0
        while len(arrivals) < txs_per_point and tick < 4096:
            tick += 1
            load.arrivals(tick * 0.025, arrivals)
        arrivals = arrivals[:txs_per_point]
        keyring = txsign.UserKeyring(seed=7, capacity=4096)
        mix = random.Random(2024 + pop)
        frames, forged = [], []
        for i, user in enumerate(arrivals):
            forge = mix.random() < 0.01
            marker = (txsign.TX_MARKER_FORGED if forge
                      else txsign.TX_MARKER_FILLER)
            frames.append(txsign.build_signed_tx(
                keyring.get(user), nonce=i,
                payload=txsign.build_payload(marker, i),
                flip_sig_bit=forge))
            forged.append(forge)
        if not any(forged):  # seeded mix, floored at one forged frame
            frames[-1] = txsign.build_signed_tx(
                keyring.get(arrivals[-1]), nonce=len(arrivals) - 1,
                payload=txsign.build_payload(
                    txsign.TX_MARKER_FORGED, len(arrivals) - 1),
                flip_sig_bit=True)
            forged[-1] = True
        records = [txsign.admission_record(f) for f in frames]

        masks: dict = {}
        cond = threading.Condition()

        def reply_to(rid, masks=masks, cond=cond):
            def _reply(mask):
                with cond:
                    masks[rid] = mask
                    cond.notify_all()
            return _reply

        eng = VerifyEngine(use_host=True)
        busy_rejected = 0
        try:
            t_drive = time.perf_counter()
            rids = []
            for b in range(0, len(records), BATCH):
                chunk = records[b:b + BATCH]
                rid = 1 + b // BATCH
                req = proto.VerifyRequest(
                    rid,
                    [r[0] for r in chunk], [r[1] for r in chunk],
                    [r[2] for r in chunk], ctx=txsign.INGRESS_CTX)
                for attempt in range(8):
                    if eng.submit(req, reply_to(rid), cls=vsched.BULK):
                        rids.append(rid)
                        break
                    busy_rejected += 1
                    time.sleep(eng.retry_after_ms(vsched.BULK) / 1e3)
            with cond:
                cond.wait_for(
                    lambda: all(r in masks for r in rids), timeout=120.0)
            dt = time.perf_counter() - t_drive
            snap = eng.stats_snapshot().get("ingress", {})
        finally:
            eng.stop()

        flat = []
        for rid in rids:
            flat.extend(masks.get(rid) or [])
        answered = len(flat)
        verified = sum(1 for ok, f in zip(flat, forged) if ok and not f)
        forged_sent = sum(forged)
        forged_rejected = sum(
            1 for ok, f in zip(flat, forged) if f and not ok)
        honest = len(frames) - forged_sent
        total_bulk_sigs = (snap.get("bulk_sigs", 0)
                           + snap.get("offchain_sigs", 0))
        out[key] = {
            "users": pop,
            "txs": len(frames),
            "distinct_users": len(set(arrivals)),
            "key_derivations": keyring.derivations,
            "keyring_capacity": keyring.capacity,
            "forged_sent": forged_sent,
            "forged_rejected": forged_rejected,
            "forgery_rejection_rate": round(
                forged_rejected / forged_sent, 3) if forged_sent else 0.0,
            "verified": verified,
            "verified_goodput_sigs_per_s": round(verified / dt, 1)
            if dt > 0 else 0.0,
            "busy_rejected": busy_rejected,
            "bulk_ingress_requests": snap.get("bulk_requests", 0),
            "bulk_ingress_sigs": snap.get("bulk_sigs", 0),
            "bulk_ingress_share": round(
                snap.get("bulk_sigs", 0) / total_bulk_sigs, 3)
            if total_bulk_sigs else 0.0,
            "answered": answered,
            "point_ok": (answered == len(frames)
                         and verified == honest
                         and forged_rejected == forged_sent
                         and snap.get("bulk_sigs", 0) == total_bulk_sigs
                         > 0),
        }
    done = [v for k, v in out.items()
            if k.startswith("u") and isinstance(v, dict)
            and not v.get("skipped")]
    out["ok"] = bool(done) and all(v["point_ok"] for v in done)
    return out


def guard_headline_probe(device=None) -> dict:
    """The ``guard`` field: the wedge -> recover ladder end to end.

    A host-mode VerifyEngine runs under a real LaunchGuard with tight
    deadlines, and the chaos hook's ``wedge`` knob hangs the next launch
    as a ``sidecar wedge`` fault-plan event does over OP_CHAOS.  The
    probe asserts the ladder: the wedged latency batch is answered with
    a mask bit-identical to ``eddsa.verify_batch`` on ``device`` (one
    tampered signature pins the comparison), bulk offered during the
    crash-only reboot is shed to BUSY with a retry-after hint, the
    injected rewarm runs, the canary passes, and routing resumes with the
    guard's counters accounting for all of it.  The bar rides in
    ``ok``."""
    import threading

    from .sidecar import protocol as proto
    from .sidecar import sched as vsched
    from .sidecar.guard import LaunchDeadlines, LaunchGuard
    from .sidecar.service import ChaosState, VerifyEngine

    dev = resolve(device)
    msgs, pks, sigs = _make_ref_sigs(8, seed=31)
    sigs = list(sigs)
    sigs[3] = sigs[3][:1] + bytes([sigs[3][1] ^ 0xFF]) + sigs[3][2:]
    chaos = ChaosState()
    # Warm launch deadlines at 0.2 s (the injected hang is infinite, so
    # any deadline catches it); the compile-class budget, which the
    # reboot canary always gets, stays generous so a contended host
    # cannot false-wedge the recovery the probe asserts on.
    guard = LaunchGuard(deadlines=LaunchDeadlines(
        warm_boot=True, compile_budget_s=5.0, warm_grace_s=0.2,
        min_deadline_s=0.05))
    rewarmed = []

    def rewarm():
        rewarmed.append(1)
        time.sleep(0.2)  # an observable reboot window for the BUSY leg

    engine = VerifyEngine(use_host=True, guard=guard, chaos=chaos,
                          rewarm_fn=rewarm)
    try:
        done = {}
        cond = threading.Condition()

        def reply_to(rid):
            def _reply(mask):
                with cond:
                    done[rid] = mask
                    cond.notify_all()
            return _reply

        expect = [bool(b) for b in
                  eddsa.verify_batch(msgs, pks, sigs, device=dev)]
        chaos.configure({"wedge": 1})
        engine.submit(proto.VerifyRequest(1, msgs, pks, sigs),
                      reply_to(1), cls=vsched.LATENCY)
        with cond:
            cond.wait_for(lambda: 1 in done, timeout=30.0)
        # Bulk offered while the engine re-warms must shed to BUSY.
        busy_shed = None
        t0 = time.monotonic()
        while time.monotonic() - t0 < 5.0:
            if engine._rebooting:
                busy_shed = not engine.submit(
                    proto.VerifyRequest(2, msgs, pks, sigs),
                    reply_to(2), cls=vsched.BULK)
                break
            time.sleep(0.002)
        retry_ms = engine.retry_after_ms(vsched.BULK)
        t0 = time.monotonic()
        while (engine._rebooting or not engine._device_ok) \
                and time.monotonic() - t0 < 20.0:
            time.sleep(0.01)
        engine.submit(proto.VerifyRequest(3, msgs, pks, sigs),
                      reply_to(3), cls=vsched.LATENCY)
        with cond:
            cond.wait_for(lambda: 3 in done, timeout=30.0)
        snap = engine.stats_snapshot().get("guard", {})
        masks_ok = done.get(1) == expect and done.get(3) == expect
        recovered = bool(snap.get("device_ok")) \
            and not snap.get("rebooting")
        ok = (masks_ok and busy_shed is True and bool(rewarmed)
              and snap.get("wedges", 0) >= 1
              and snap.get("reboots", 0) >= 1
              and snap.get("canary_passes", 0) >= 1
              and snap.get("suspect_records", 0) >= 1
              and recovered)
        return {
            "wedges": snap.get("wedges", 0),
            "reboots": snap.get("reboots", 0),
            "canary_passes": snap.get("canary_passes", 0),
            "quarantined_records": snap.get("suspect_records", 0),
            "poisoned_records": snap.get("poisoned_records", 0),
            "host_fallback_records": snap.get("host_fallback_records", 0),
            "busy_during_reboot": busy_shed,
            "busy_retry_after_ms": retry_ms,
            "masks_bit_identical": masks_ok,
            "rewarmed": bool(rewarmed),
            "reboot_wall_ms": round(
                snap.get("last_reboot_wall_s", 0.0) * 1e3, 1),
            "recovered": recovered,
            "ok": ok,
        }
    finally:
        engine.stop()
        guard.close()


def make_batch(g: int = G, n: int = N):
    """g*n distinct (key, message, signature) triples through OpenSSL
    (the ``cryptography`` library; deterministic Ed25519), the root
    bench's bytes for the same g*n.  Raises ImportError without it: the
    pure-Python signer is no stand-in at this size."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding, PublicFormat,
    )

    rng = np.random.default_rng(2024)
    msgs, pks, sigs = [], [], []
    for _ in range(g * n):
        key = Ed25519PrivateKey.from_private_bytes(rng.bytes(32))
        pk = key.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
        msg = rng.bytes(64)
        msgs.append(msg)
        pks.append(pk)
        sigs.append(key.sign(msg))
    return msgs, pks, sigs


def baseline_library() -> str:
    """The library the baseline measures, as ``cryptography <version>
    (<OpenSSL version>)``."""
    import cryptography
    from cryptography.hazmat.backends.openssl import backend

    return (f"cryptography {cryptography.__version__} "
            f"({backend.openssl_version_text()})")


def cpu_baseline(msgs, pks, sigs) -> float:
    """Single-core verifies/s through OpenSSL, one by one, best of 3."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PublicKey,
    )

    keys = [Ed25519PublicKey.from_public_bytes(pk) for pk in pks]
    keys[0].verify(sigs[0], msgs[0])  # warm-up
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        for k, m, s in zip(keys, msgs, sigs):
            k.verify(s, m)
        dt = time.perf_counter() - t0
        best = max(best, len(msgs) / dt)
    return best


def device_throughput(msgs, pks, sigs, on_trial=None, *, device=None,
                      g: int = G, n: int = N, rounds: int = ROUNDS,
                      trials: int = TRIALS, calls: list | None = None
                      ) -> float:
    """End-to-end pipelined verifies/s of ``verify_packed_chunked`` on
    (g, n, 128) tensors on ``device``.  Every timed round pays the full
    host preparation and the host-to-device copy of its g*n signatures:
    preparation runs on one helper thread and the copy (pinned memory, a
    side stream, an event the compute stream waits on) on another, so
    both overlap the card's previous round.  Each round's (g, n) mask is
    all-reduced on the card to one flag, and the flags are read after the
    last round; any false flag raises.  ``calls`` (a list) receives one
    entry per program call, the warm-up's included."""
    from concurrent.futures import ThreadPoolExecutor

    dev = resolve(device)
    if n > eddsa.MAX_SUBBATCH or len(msgs) != g * n:
        raise ValueError(f"need g*n triples with n <= "
                         f"{eddsa.MAX_SUBBATCH}, got {len(msgs)} for "
                         f"g={g}, n={n}")
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def prep_round():
        rows = []
        for i in range(g):
            sl = slice(i * n, (i + 1) * n)
            prep = eddsa.prepare_batch(msgs[sl], pks[sl], sigs[sl])
            if not prep["host_ok"].all():
                raise RuntimeError("benchmark signatures must pass the "
                                   "host checks")
            rows.append(prep["packed"])
        host = torch.from_numpy(np.stack(rows))
        return host.pin_memory() if copy_stream is not None else host

    def to_device(prep_future):
        host = prep_future.result()
        if copy_stream is None:
            return host, None, host
        with torch.cuda.device(dev), torch.cuda.stream(copy_stream):
            x = host.to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return x, ready, host

    def verify_all(staged):
        x, ready, _host = staged
        if ready is not None:
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(ready)
            x.record_stream(compute)
        if calls is not None:
            calls.append(1)
        return E.verify_packed_chunked(x).all()

    best = 0.0
    with ThreadPoolExecutor(1) as prep_pool, \
            ThreadPoolExecutor(1) as xfer_pool:
        first = xfer_pool.submit(to_device, prep_pool.submit(prep_round))
        if not bool(verify_all(first.result())):   # warm-up
            raise RuntimeError("benchmark signatures must verify")
        for _ in range(trials):
            t0 = time.perf_counter()
            preps = [prep_pool.submit(prep_round) for _ in range(2)]
            devs = [xfer_pool.submit(to_device, preps[0])]
            verdicts = []
            for r in range(rounds):
                if r + 2 < rounds:
                    preps.append(prep_pool.submit(prep_round))
                if r + 1 < rounds:
                    devs.append(xfer_pool.submit(to_device, preps[r + 1]))
                verdicts.append(verify_all(devs[r].result()))
            oks = [bool(v) for v in verdicts]   # reads the flags
            dt = time.perf_counter() - t0
            if not all(oks):
                raise RuntimeError("benchmark signatures must verify")
            best = max(best, g * n * rounds / dt)
            if on_trial:
                on_trial(best)
    return best


# The stages whose kernel launches the line's ``device`` field carries.
DEVICE_STAGES = ("probe", "headline", "rlc", "roofline", "viewchange",
                 "guard")


def _has_error(v) -> bool:
    if isinstance(v, dict):
        return "error" in v or any(_has_error(x) for x in v.values())
    return False


def _failed(fields: dict) -> list:
    """Names of the fields that carry an error at any depth, or a false
    ``ok``."""
    return [k for k, v in fields.items() if isinstance(v, dict)
            and (_has_error(v) or v.get("ok") is False)]


def run(device=None, *, g: int = G, n: int = N, rounds: int = ROUNDS,
        trials: int = TRIALS, rlc_sizes=(4, 16, 64, 256),
        roofline_sizes=(64, 256, 1024), committees=(20, 100, 300),
        populations=(100_000, 1_000_000), fault_plan=None, wan=None,
        slo=None) -> list:
    """Measure everything and emit the lines (one as each trial
    improves, then the final one); returns the names of the failed
    fields.  The headline's own steps raise; each later field runs
    alone, a failure named in its field.  ``device="cpu"`` with small
    sizes runs the whole bench on the kernels' plain versions;
    ``fault_plan``, ``wan`` and ``slo`` go to the chaos probe."""
    dev = resolve(device)
    card = card_info(dev)
    tallies = {stage: {} for stage in DEVICE_STAGES}
    stage_s = {}

    def timed(stage, fn, *args, **kwargs):
        t0 = time.perf_counter()
        tally = tallies.get(stage)
        try:
            with kern.counting_to(tally) if tally is not None \
                    else contextlib.nullcontext():
                return fn(*args, **kwargs)
        finally:
            stage_s[stage] = round(time.perf_counter() - t0, 3)

    def isolated(stage, fn, *args, **kwargs):
        try:
            return timed(stage, fn, *args, **kwargs)
        except Exception as e:  # noqa: BLE001 — named in the field
            traceback.print_exc()
            return {"error": f"{e!r:.200}"}

    def boot():
        from .ops import field25519

        probe_device(dev)
        field25519.mul_selfcheck(device=dev)

    timed("probe", boot)
    msgs, pks, sigs = timed("batch", make_batch, g, n)
    cpu = timed("cpu_baseline", cpu_baseline, msgs, pks, sigs)
    calls = []

    baseline = {"library": baseline_library(), "cores": 1,
                "sigs_per_s": round(cpu, 1)}

    def device_field():
        return dict(card, torch_device=str(dev), baseline=baseline,
                    stage_s=dict(stage_s), headline_calls=len(calls),
                    launches=tallies)

    def on_trial(best):
        save_cache(best, best / cpu, cpu)
        emit(best, best / cpu, device=device_field())

    value = timed("headline", device_throughput, msgs, pks, sigs,
                  on_trial, device=dev, g=g, n=n, rounds=rounds,
                  trials=trials, calls=calls)
    save_cache(value, value / cpu, cpu)
    fields = {}
    fields["rlc"] = isolated(
        "rlc", rlc_compare, rlc_sizes, device=dev,
        budget_s=_env_budget("HOTSTUFF_TPU_RLC_BUDGET", 300))
    fields["roofline"] = isolated(
        "roofline", roofline_headline, roofline_sizes, device=dev,
        budget_s=min(_env_budget("HOTSTUFF_TPU_ROOFLINE_BUDGET", 300),
                     max(0.0, budget_left_s())))
    fields["viewchange"] = isolated(
        "viewchange", viewchange_headline, committees, device=dev,
        budget_s=min(_env_budget("HOTSTUFF_TPU_VIEWCHANGE_BUDGET", 240),
                     max(0.0, budget_left_s())))
    fields["sched"] = isolated("sched", sched_headline_probe)
    fields["chaos"] = isolated("chaos", chaos_headline_probe, fault_plan,
                               wan, slo)
    fields["trace"] = isolated("trace", trace_headline_probe)
    fields["surge"] = isolated("surge", surge_headline_probe)
    fields["guard"] = isolated("guard", guard_headline_probe, dev)
    fields["users"] = isolated(
        "users", users_headline_probe, populations,
        budget_s=min(_env_budget("HOTSTUFF_TPU_USERS_BUDGET", 240),
                     max(0.0, budget_left_s())))
    emit_final(value, cpu, **fields, device=device_field())
    return _failed(fields)


def main(argv=None) -> int:
    """The CLI: the card only (``resolve(None)`` raises without one)."""
    import argparse
    import signal

    install_kill_handlers()
    ap = argparse.ArgumentParser(
        prog="python -m hotstuff_tpu_torch.bench",
        description="Ed25519 batch-verify throughput on the card against "
                    "single-core OpenSSL, and the root bench's fields")
    ap.add_argument("--fault-plan", default=None)
    ap.add_argument("--wan", default=None)
    ap.add_argument("--slo", default=None)
    known, _ = ap.parse_known_args(argv)
    # The outer budget: SIGALRM re-prints the last line and exits 1.
    signal.alarm(max(1, int(budget_left_s())))
    failed = run(
        fault_plan=known.fault_plan
        or os.environ.get("HOTSTUFF_TPU_FAULT_PLAN") or None,
        wan=known.wan or os.environ.get("HOTSTUFF_TPU_WAN") or None,
        slo=known.slo or os.environ.get("HOTSTUFF_TPU_SLO") or None)
    signal.alarm(0)
    if failed:
        print(f"bench: failed fields: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
