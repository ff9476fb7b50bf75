"""Collector/merger: per-process spans -> per-block commit traces.

Inputs (all best-effort; a run that produced no spans yields ``None``):

  * node logs (``node-*.log``) carrying the C++ node's machine-parseable
    ``TRACE stage=<s> block=<digest> round=<r>`` lines (emitted behind
    the parameters-file ``trace`` flag at the consensus hot-path stages:
    ``proposal`` received, ``verify_submit`` to the sidecar,
    ``verify_reply`` from it, block ``commit``);
  * sidecar spans (``sidecar-spans.jsonl``, the obs.spans schema) tagged
    rid + scheduler class;
  * per-host clock offsets (``clock-offsets.json``; absent = one host,
    offset 0), estimated RTT-midpoint style — the harness's existing
    ssh transport answers the probe on remote runs.

Outputs:

  * per-block commit traces (stage -> earliest wall stamp across logs,
    the same earliest-occurrence merge the LogParser's commit metrics
    use) and the **critical-path breakdown**: p50/p99 per consecutive
    stage segment, which LogParser surfaces as "Commit critical path"
    notes and bench.py as the headline ``trace`` field;
  * a Chrome-trace-event JSON artifact (``logs/trace.json``) loadable
    in Perfetto / ``chrome://tracing``.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from glob import glob
from re import findall
from statistics import median

from .spans import parse_spans

# Consensus hot-path stage chain, in commit order.  Segment names pair
# consecutive stages; blocks missing the verify stages (cached
# certificates, host-path verifies) still contribute to the total.
NODE_STAGES = ("proposal", "verify_submit", "verify_reply", "commit")
SEGMENTS = tuple(f"{a}->{b}" for a, b in zip(NODE_STAGES, NODE_STAGES[1:]))
TOTAL_SEGMENT = "proposal->commit"
# graftscope: the named device sub-segment of verify — the sidecar's
# ctx-joined device span durations, reported next to the node segments
# so "where did verify time go" has a device answer.
DEVICE_SEGMENT = "verify:device"

# The frozen node log grammar (common/log.hpp) around the TRACE payload
# emitted by consensus/core.cpp: timestamp, level, module, then
# "TRACE stage=<s> block=<digest> round=<r>".
_NODE_TRACE_RE = (r"\[(\S+Z) \w+ [^\]]+\] TRACE "
                  r"stage=(\w+) block=(\S+) round=(\d+)")


def _to_posix(ts: str) -> float:
    return datetime.fromisoformat(ts.replace("Z", "+00:00")).timestamp()


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an ascending list (empty -> 0), the
    sched/stats.py convention."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


# -- node spans --------------------------------------------------------------


def parse_node_trace(log: str, host: str = "node") -> list:
    """One node log -> TRACE span dicts
    ``{"host", "stage", "t", "block", "round"}`` (invalid stages and
    torn fragments simply don't match the regex — tolerance for free)."""
    spans = []
    for ts, stage, block, rnd in findall(_NODE_TRACE_RE, log):
        if stage not in NODE_STAGES:
            continue
        try:
            t = _to_posix(ts)
        except ValueError:
            continue
        spans.append({"host": host, "stage": stage, "t": t,
                      "block": block, "round": int(rnd)})
    return spans


# -- clock alignment ---------------------------------------------------------


def clock_offset(t_send: float, t_remote: float, t_recv: float) -> float:
    """RTT-midpoint offset estimate for one probe: the remote stamp is
    assumed taken halfway through the round trip, so
    ``offset = t_remote - (t_send + t_recv) / 2`` and
    ``local = remote - offset``.  Error is bounded by RTT/2 plus path
    asymmetry — low milliseconds on the fleets this harness drives."""
    return t_remote - (t_send + t_recv) / 2.0


def estimate_offset(probes) -> float:
    """Median offset over ``(t_send, t_remote, t_recv)`` probe triples
    (median discards the odd delayed round trip)."""
    if not probes:
        return 0.0
    return median(clock_offset(*p) for p in probes)


def probe_host_offset(run_fn, host: str, clock, samples: int = 5) -> float:
    """Estimate one remote host's clock offset through a transport.

    ``run_fn(host, command)`` must execute the command remotely and
    return its stdout (the harness's ssh RemoteRunner satisfies this
    with ``lambda h, c: runner.run(h, c, timeout=...).stdout``);
    ``clock`` is the local wall clock.  Probes that fail to parse are
    skipped — an unreachable host estimates as offset 0 rather than
    killing the trace."""
    probes = []
    for _ in range(samples):
        t_send = clock()
        try:
            out = run_fn(host, "date +%s.%N")
            t_remote = float(str(out).strip().splitlines()[-1])
        except (ValueError, IndexError, OSError, RuntimeError,
                AttributeError, TypeError):
            # Includes transports that answer with nothing (a stubbed
            # or wedged runner): a probe that cannot parse is a skip.
            # A host that has never answered is almost certainly down —
            # stop after ONE failed dial instead of paying the transport
            # timeout `samples` times for a best-effort artifact.
            if not probes:
                break
            continue
        probes.append((t_send, t_remote, clock()))
    return estimate_offset(probes)


def apply_offset(spans, offset_s: float):
    """Shift spans from a skewed host onto the reference clock
    (``local = remote - offset``); returns new dicts, input untouched."""
    if not offset_s:
        return list(spans)
    return [dict(s, t=s["t"] - offset_s) for s in spans]


# -- stitching + critical path -----------------------------------------------


def stitch_blocks(spans) -> dict:
    """Aligned node spans -> ``{(block, round): {stage: t}}`` with the
    earliest stamp winning per stage (the LogParser's merge convention:
    N replicas trace the same block; the fastest observation is the
    committee's critical path, stragglers are their own problem)."""
    traces: dict = {}
    for s in spans:
        key = (s["block"], s["round"])
        stages = traces.setdefault(key, {})
        t = s["t"]
        if s["stage"] not in stages or stages[s["stage"]] > t:
            stages[s["stage"]] = t
    return traces


def critical_path(traces: dict) -> dict:
    """Per-block stage segments -> p50/p99 breakdown::

        {"blocks": N, "complete": M,     # all four stages present
         "segments": {"proposal->commit": {"n", "p50_ms", "p99_ms"},
                      "proposal->verify_submit": {...}, ...}}

    A dropped/partial span (a stage some block never logged) only
    removes that block from the segments needing the stage — every
    segment whose two endpoints exist still counts, so a chaos-killed
    replica degrades the sample count, not the breakdown."""
    seg_samples: dict = {name: [] for name in SEGMENTS + (TOTAL_SEGMENT,)}
    complete = 0
    for stages in traces.values():
        if all(s in stages for s in NODE_STAGES):
            complete += 1
        for name, (a, b) in zip(SEGMENTS, zip(NODE_STAGES,
                                              NODE_STAGES[1:])):
            if a in stages and b in stages:
                seg_samples[name].append((stages[b] - stages[a]) * 1e3)
        if "proposal" in stages and "commit" in stages:
            seg_samples[TOTAL_SEGMENT].append(
                (stages["commit"] - stages["proposal"]) * 1e3)
    segments = {}
    for name, vals in seg_samples.items():
        vals.sort()
        segments[name] = {
            "n": len(vals),
            "p50_ms": round(_percentile(vals, 0.50), 3),
            "p99_ms": round(_percentile(vals, 0.99), 3),
        }
    return {"blocks": len(traces), "complete": complete,
            "segments": segments}


# -- graftscope: per-block node<->sidecar joins ------------------------------


def chain_spans(sidecar_spans) -> dict:
    """ctx-tagged sidecar spans -> ``{block_digest_b64: [spans]}``.

    The sidecar tags per-request spans (admit/queue/reply) with ``ctx``
    and per-launch spans (pack/dispatch/device) with a ``ctxs`` list —
    both carry the protocol-v5 context tag as the SAME base64 string the
    C++ node logs in ``block=`` (common/bytes.hpp base64_encode), so the
    join is plain string equality.  A launch coalescing several blocks'
    requests contributes its spans to every one of their chains."""
    chains: dict = {}
    for s in sidecar_spans:
        tags = []
        ctx = s.get("ctx")
        if isinstance(ctx, str):
            tags.append(ctx)
        ctxs = s.get("ctxs")
        if isinstance(ctxs, (list, tuple)):
            tags.extend(c for c in ctxs if isinstance(c, str))
        for c in tags:
            chains.setdefault(c, []).append(s)
    return chains


def join_blocks(traces: dict, chains: dict):
    """Per-block traces + ctx chains -> ``(join, joined)``.

    ``join`` is the machine-readable accounting::

        {"committed": N,     # blocks with a commit stage
         "with_verify": M,   # of those, blocks whose verify segment
                             # (verify_submit AND verify_reply) traced
         "joined": J,        # of those, blocks whose digest has a
                             # sidecar chain with a device span
         "rate": J / M}      # None when no block traced a verify

    ``joined`` maps ``(block, round) -> chain spans`` for the blocks
    that joined — what the Chrome exporter nests inside the block's
    verify segment.  A block whose chain is missing (fast-path cache
    answer on every replica, a torn span file) degrades the rate, never
    the trace."""
    committed = sum(1 for st in traces.values() if "commit" in st)
    with_verify = 0
    joined: dict = {}
    for key, stages in traces.items():
        if "commit" not in stages:
            continue
        if "verify_submit" not in stages or "verify_reply" not in stages:
            continue
        with_verify += 1
        chain = chains.get(key[0])
        if chain and any(s.get("stage") == "device" for s in chain):
            joined[key] = chain
    rate = round(len(joined) / with_verify, 4) if with_verify else None
    return ({"committed": committed, "with_verify": with_verify,
             "joined": len(joined), "rate": rate}, joined)


def device_subsegment(joined: dict) -> dict:
    """Joined chains -> the ``verify:device`` sub-segment percentiles
    (per-block device milliseconds: the sum of the chain's device span
    durations — one block's QC verify can split across launches)."""
    vals = []
    for chain in joined.values():
        ms = sum(float(s.get("dur_ms") or 0.0) for s in chain
                 if s.get("stage") == "device")
        vals.append(ms)
    vals.sort()
    return {"n": len(vals),
            "p50_ms": round(_percentile(vals, 0.50), 3),
            "p99_ms": round(_percentile(vals, 0.99), 3)}


def sidecar_breakdown(spans) -> dict:
    """Sidecar JSONL spans -> per-stage duration percentiles (same
    shape as the critical-path segments, keyed by span stage)."""
    by_stage: dict = {}
    for s in spans:
        dur = s.get("dur_ms")
        if isinstance(dur, (int, float)):
            by_stage.setdefault(s["stage"], []).append(float(dur))
    out = {}
    for stage, vals in sorted(by_stage.items()):
        vals.sort()
        out[stage] = {"n": len(vals),
                      "p50_ms": round(_percentile(vals, 0.50), 3),
                      "p99_ms": round(_percentile(vals, 0.99), 3)}
    return out


# -- Chrome trace export -----------------------------------------------------

_PID_CONSENSUS = 1
_PID_SIDECAR = 2


def chrome_trace(traces: dict, sidecar_spans=(), joined=None) -> dict:
    """Per-block traces + sidecar spans -> a Chrome trace-event JSON
    object (Perfetto-loadable: complete events, microsecond stamps
    normalized to the earliest span, process-name metadata).

    ``joined`` (graftscope, from :func:`join_blocks`) nests each joined
    block's sidecar stage chain INSIDE that block's row on the consensus
    process: the chain's spans are re-emitted at ``pid`` consensus /
    ``tid`` round (cat ``sidecar``, block in args), so opening a block
    in Perfetto shows device time as a sub-segment of its verify
    segment.  The flat sidecar-process timeline is kept too — it still
    carries the un-joined spans (bulk traffic, zero-tag requests)."""
    events = []
    t0_candidates = [min(stages.values()) for stages in traces.values()
                     if stages]
    t0_candidates += [s["t"] for s in sidecar_spans]
    t_base = min(t0_candidates) if t0_candidates else 0.0

    def us(t):
        return round((t - t_base) * 1e6, 1)

    for (block, rnd), stages in sorted(traces.items(),
                                       key=lambda kv: kv[0][1]):
        for name, (a, b) in zip(SEGMENTS, zip(NODE_STAGES,
                                              NODE_STAGES[1:])):
            if a in stages and b in stages:
                events.append({
                    "name": name, "ph": "X", "cat": "consensus",
                    "ts": us(stages[a]),
                    "dur": max(0.0, us(stages[b]) - us(stages[a])),
                    "pid": _PID_CONSENSUS, "tid": rnd,
                    "args": {"block": block, "round": rnd},
                })
    for (block, rnd), chain in sorted((joined or {}).items(),
                                      key=lambda kv: kv[0][1]):
        for s in chain:
            events.append({
                "name": f"sidecar:{s['stage']}", "ph": "X",
                "cat": "sidecar",
                "ts": us(s["t"]),
                "dur": max(0.0, float(s.get("dur_ms") or 0.0) * 1e3),
                "pid": _PID_CONSENSUS, "tid": rnd,
                "args": {"block": block, "round": rnd,
                         "rid": s.get("rid")},
            })
    for s in sidecar_spans:
        args = {k: v for k, v in s.items()
                if k not in ("stage", "t", "dur_ms")}
        events.append({
            "name": s["stage"], "ph": "X", "cat": "sidecar",
            "ts": us(s["t"]),
            "dur": max(0.0, float(s.get("dur_ms") or 0.0) * 1e3),
            "pid": _PID_SIDECAR, "tid": 0,
            "args": args,
        })
    for pid, name in ((_PID_CONSENSUS, "consensus (merged replicas)"),
                      (_PID_SIDECAR, "verify sidecar")):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": name}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"t_base_s": round(t_base, 6)}}


# -- directory-level entry points (the harness contract) ---------------------


def build_run_trace(directory: str):
    """Mine one logs directory -> ``(summary, chrome)`` or
    ``(None, None)`` when the run traced nothing (trace flag off, or
    pre-grafttrace logs).

    Reads ``node-*.log`` TRACE lines, ``sidecar-spans.jsonl``, and
    ``clock-offsets.json`` (``{"node-3.log": seconds, ...}`` keyed by
    log file name; missing entries are offset 0)."""
    offsets = {}
    try:
        with open(os.path.join(directory, "clock-offsets.json")) as f:
            loaded = json.load(f)
        if isinstance(loaded, dict):
            offsets = {k: float(v) for k, v in loaded.items()
                       if isinstance(v, (int, float))}
    except (OSError, ValueError):
        pass
    node_spans = []
    for path in sorted(glob(os.path.join(directory, "node-*.log"))):
        name = os.path.basename(path)
        with open(path, "r", errors="replace") as f:
            spans = parse_node_trace(f.read(), host=name)
        node_spans.extend(apply_offset(spans, offsets.get(name, 0.0)))
    sc_spans, malformed = [], 0
    try:
        with open(os.path.join(directory, "sidecar-spans.jsonl"),
                  errors="replace") as f:
            sc_spans, malformed = parse_spans(f.read())
    except OSError:
        pass
    sc_spans = apply_offset(sc_spans,
                            offsets.get("sidecar-spans.jsonl", 0.0))
    if not node_spans and not sc_spans:
        return None, None
    traces = stitch_blocks(node_spans)
    summary = critical_path(traces)
    summary["sidecar"] = sidecar_breakdown(sc_spans)
    summary["malformed_spans"] = malformed
    # graftscope: join the ctx-tagged sidecar chains onto their blocks —
    # device time becomes the verify:device sub-segment and join_rate
    # says what fraction of verify-traced committed blocks carried one.
    join, joined = join_blocks(traces, chain_spans(sc_spans))
    summary["join"] = join
    if joined:
        summary["segments"][DEVICE_SEGMENT] = device_subsegment(joined)
    chrome = chrome_trace(traces, sc_spans, joined=joined)
    summary["chrome_events"] = len(chrome["traceEvents"])
    return summary, chrome


def write_run_trace(directory: str):
    """Build and persist ``<directory>/trace.json``; returns the
    summary (``None`` when the run traced nothing — no file is written,
    so downstream tooling can tell "no trace" from "empty trace")."""
    summary, chrome = build_run_trace(directory)
    if summary is None:
        return None
    tmp = os.path.join(directory, "trace.json.tmp")
    with open(tmp, "w") as f:
        json.dump(chrome, f)
    os.replace(tmp, os.path.join(directory, "trace.json"))
    return summary
