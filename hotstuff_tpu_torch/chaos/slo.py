"""Per-fault-class recovery SLOs: pass/fail verdicts over the recovery
summary instead of the bare "commits resume" assertion.

A fault class is the target kind plus the action (``node-kill``,
``sidecar-degrade``, ``link-heal``, ...), and the SLO is the maximum
recovery latency — first commit after the event — the class is allowed
to cost.  ``judge`` turns ``summarize_recovery`` output into per-event
verdicts the LogParser surfaces as notes (and raises on, under the
strict testbed assertion) and bench.py folds into the ``chaos``
headline, so "recovered" always means "recovered fast enough", not
merely "eventually".

Defaults are deliberately generous multiples of the local testbed's
view-change budget (timeout_delay defaults to 5 s and a kill can
legitimately cost a couple of view changes plus the node-side circuit
breaker's probe backoff); deployments with tighter targets override
per class via ``--slo`` (file / dict / inline ``"node-kill=8000;
link-heal=3000"``).
"""

from __future__ import annotations

import json
import os
import re

from .plan import LEADER_CASCADE, SIDECAR, client_index, link_name, \
    node_index, sidecar_index

# class -> max recovery_ms (the table --slo overlays).
DEFAULT_SLO_MS = {
    "node-kill": 30_000.0,
    "node-restart": 20_000.0,
    "node-pause": 30_000.0,
    "node-resume": 20_000.0,
    "sidecar-kill": 15_000.0,
    "sidecar-restart": 15_000.0,
    "sidecar-degrade": 10_000.0,
    # graftguard: a scripted launch wedge rides the in-sidecar
    # supervisor — host-fallback replies keep consensus committing
    # immediately, so the budget covers one ladder execution plus the
    # async crash-only reboot's BUSY window, not a breaker timeout.
    "sidecar-wedge": 20_000.0,
    # graftfleet: killing ONE endpoint of a --sidecar-fleet run must
    # re-home verify traffic to the next healthy sidecar — an in-flight
    # resubmit plus at most a breaker trip, nowhere near the
    # single-sidecar kill's breaker-then-host-path budget.  The parser's
    # strict companion assertion (zero host-path verifies while a
    # healthy secondary exists) rides on the same events.
    "sidecar-failover": 10_000.0,
    "link-partition": 30_000.0,
    "link-heal": 20_000.0,
    # graftsurge: a flash crowd ends at t + for; the system must be back
    # at its pre-surge baseline within this budget of the window CLOSING
    # (the commit-scalar verdict measures from the injection like every
    # other class; the metrics verdict below measures from the end).
    "client-surge": 30_000.0,
    # graftview: a leader-cascade kill k drill — k chained view changes,
    # each costing one backed-off timeout (default schedule: 5 s, 10 s,
    # 20 s, ... capped) plus batched TC assembly, before a live leader
    # proposes.  The budget covers a depth-3 cascade under the default
    # pacemaker; deeper drills override per run.
    "view-change": 60_000.0,
}

# Metrics-driven recovery-to-baseline defaults (judge_baseline_recovery):
# the pre-event baseline is the median sampled throughput over this
# window before the event, and "recovered" means the sampled curve is
# back to at least this fraction of it.
BASELINE_WINDOW_S = 10.0
BASELINE_FRACTION = 0.7
# Fewer good samples than this before the event -> not judged (a verdict
# off two points would be noise presented as policy).
BASELINE_MIN_SAMPLES = 3


class SloError(ValueError):
    """Malformed SLO table spec."""


def fault_class(event: dict) -> str:
    """Executed-event dict (PlanRunner.events shape) -> fault class."""
    target = str(event.get("target", ""))
    if target == LEADER_CASCADE:
        # The drill IS the view change: one class regardless of action,
        # per the graftview acceptance grammar.
        return "view-change"
    if target == SIDECAR or sidecar_index(target) is not None:
        # graftfleet: a kill aimed at ONE indexed endpoint is judged as
        # a failover (re-home to the next healthy sidecar), not as the
        # single-sidecar kill class (breaker-then-host-path budget).
        if sidecar_index(target) is not None and \
                event.get("action") == "kill":
            return "sidecar-failover"
        kind = "sidecar"
    elif node_index(target) is not None:
        kind = "node"
    elif link_name(target) is not None:
        kind = "link"
    elif client_index(target) is not None:
        kind = "client"
    else:
        kind = "unknown"
    return f"{kind}-{event.get('action')}"


def event_window_end(event: dict) -> float | None:
    """Wall time a fault's ACTIVE window closes: the injection stamp,
    plus the surge duration for surge events (recovery-to-baseline is
    only meaningful once the extra load is gone).  The surge duration
    default is plan.surge_window_s — the SAME default the validator and
    the injector apply, so an omitted ``for`` means one thing at every
    layer."""
    from .plan import surge_window_s

    wall = event.get("wall")
    if not isinstance(wall, (int, float)):
        return None
    end = float(wall)
    if event.get("action") == "surge":
        end += surge_window_s(event.get("params"))
    return end


def throughput_series(samples) -> list:
    """Sampled OP_STATS series (obs/sampler.py JSONL records) ->
    ``[(t, sigs_per_s)]`` from consecutive good samples' cumulative
    ``sigs_launched`` deltas.  A sidecar restart resets the counter —
    a negative delta clamps to 0 (an honest gap) rather than poisoning
    the curve."""
    good = [(s["t"], s["stats"].get("sigs_launched"))
            for s in samples
            if s.get("ok") and isinstance(s.get("stats"), dict)
            and isinstance(s["stats"].get("sigs_launched"), (int, float))]
    out = []
    for (t0, v0), (t1, v1) in zip(good, good[1:]):
        dt = t1 - t0
        if dt <= 0:
            continue
        out.append((t1, max(0.0, (v1 - v0)) / dt))
    return out


def judge_baseline_recovery(samples, events, slos: dict | None = None,
                            window_s: float = BASELINE_WINDOW_S,
                            fraction: float = BASELINE_FRACTION) -> dict:
    """Metrics-driven recovery verdicts: judge each
    fault off the SAMPLED throughput curve returning to its pre-event
    baseline, not just off the first commit after the injection.

    Per event: baseline = median throughput over ``window_s`` before the
    injection; the event recovers when the curve first reaches
    ``fraction`` x baseline AFTER the event's active window closes
    (surges: after t + for).  The recovery budget is the event's fault
    class SLO from the same table ``judge`` uses.  Events without
    enough pre-event telemetry are reported ``judged: false`` and do
    not fail the run — absence of evidence is surfaced, not punished.

    Returns ``{"verdicts": [...], "ok": bool, "judged": int}``.
    """
    from statistics import median

    table = parse_slos(None)
    if slos:
        table.update(slos)
    series = throughput_series(samples)
    verdicts = []
    judged = 0
    for e in events:
        cls = fault_class(e)
        wall = e.get("wall")
        end = event_window_end(e)
        v = {"label": f"t={e.get('t')}s {e.get('action')} "
                      f"{e.get('target')}", "class": cls,
             "judged": False, "ok": True,
             "baseline_sigs_per_s": None, "recovered_ms": None}
        if wall is None or end is None:
            v["reason"] = "no wall stamp"
            verdicts.append(v)
            continue
        base_pts = [r for t, r in series if wall - window_s <= t < wall]
        if len(base_pts) < BASELINE_MIN_SAMPLES:
            v["reason"] = (f"insufficient pre-event telemetry "
                           f"({len(base_pts)} sample(s))")
            verdicts.append(v)
            continue
        baseline = median(base_pts)
        v["baseline_sigs_per_s"] = round(baseline, 1)
        if baseline <= 0:
            v["reason"] = "pre-event baseline is zero"
            verdicts.append(v)
            continue
        slo_ms = table.get(cls)
        target = fraction * baseline
        recovered_ms = None
        for t, r in series:
            if t > end and r >= target:
                recovered_ms = round((t - end) * 1e3, 1)
                break
        if recovered_ms is None:
            # Fail only when the sampled series actually COVERS the
            # recovery budget: a run whose sampler stopped before the
            # SLO elapsed gave the event no fair chance — that is
            # absence of evidence (surfaced, unjudged), not a breach.
            last_t = series[-1][0]
            horizon = end + (slo_ms / 1e3 if slo_ms else 0.0)
            if last_t < horizon:
                v["reason"] = ("sampled series ends "
                               f"{(horizon - last_t):.1f} s before the "
                               "recovery budget elapsed")
                verdicts.append(v)
                continue
        judged += 1
        v["judged"] = True
        v["recovered_ms"] = recovered_ms
        v["slo_ms"] = slo_ms
        if recovered_ms is None:
            v.update(ok=False,
                     reason=f"throughput never returned to "
                            f"{fraction:.0%} of baseline "
                            f"({target:.1f} sigs/s)")
        elif slo_ms is not None and recovered_ms > slo_ms:
            v.update(ok=False,
                     reason=f"baseline recovery {recovered_ms:g} ms > "
                            f"SLO {slo_ms:g} ms")
        else:
            v["reason"] = ""
        verdicts.append(v)
    return {
        "verdicts": verdicts,
        "ok": all(v["ok"] for v in verdicts),
        "judged": judged,
    }


def parse_slos(spec) -> dict:
    """Full SLO table (defaults overlaid with the spec's overrides) from
    None / a dict / a JSON file path / an inline ``"class=ms;..."``
    string.  Unknown classes and non-positive values fail here, not as a
    silently never-matching verdict."""
    table = dict(DEFAULT_SLO_MS)
    if spec is None:
        return table
    if isinstance(spec, str):
        if os.path.isfile(spec):
            try:
                with open(spec, encoding="utf-8") as f:
                    spec = json.load(f)
            except (OSError, ValueError) as e:
                raise SloError(f"cannot read SLO table {spec!r}: {e}")
        else:
            entries = [e for e in re.split(r"[;\n]", spec) if e.strip()]
            if not entries:
                raise SloError("empty SLO spec")
            parsed = {}
            for entry in entries:
                if "=" not in entry:
                    raise SloError(f"bad SLO entry {entry!r} "
                                   "(want class=ms)")
                k, v = entry.split("=", 1)
                parsed[k.strip()] = v.strip()
            spec = parsed
    if not isinstance(spec, dict):
        raise SloError(f"unsupported SLO spec type {type(spec).__name__}")
    for cls, raw in spec.items():
        if cls not in DEFAULT_SLO_MS:
            raise SloError(
                f"unknown fault class {cls!r} (have "
                f"{', '.join(sorted(DEFAULT_SLO_MS))})")
        try:
            ms = float(raw)
        except (TypeError, ValueError):
            raise SloError(f"SLO for {cls} must be a number (got {raw!r})")
        if not ms > 0 or ms != ms or ms == float("inf"):
            raise SloError(f"SLO for {cls} must be finite > 0 (got {ms:g})")
        table[cls] = ms
    return table


def judge(summary: dict, slos: dict | None = None) -> dict:
    """``summarize_recovery`` output + SLO table -> JSON-safe verdicts::

        {"verdicts": [{"label", "class", "recovery_ms", "slo_ms",
                       "ok", "reason"}, ...],
         "ok": bool,                 # every event inside its SLO
         "worst_headroom_ms": float} # min(slo - recovery); negative = miss

    A failed injection or an unrecovered event fails its verdict (an SLO
    cannot be met by a fault that never resolved), so ``ok`` subsumes
    the old bare liveness assertion.
    """
    from .recovery import event_label

    table = parse_slos(None)
    if slos:
        table.update(slos)
    verdicts = []
    worst = None
    for e in summary.get("events", []):
        cls = fault_class(e)
        slo_ms = table.get(cls)
        v = {"label": event_label(e), "class": cls,
             "recovery_ms": e.get("recovery_ms"), "slo_ms": slo_ms}
        if slo_ms is None:
            v.update(ok=False, reason=f"no SLO for class {cls!r}")
        elif not e.get("ok", True):
            v.update(ok=False, reason="injection failed")
        elif not e.get("recovered"):
            v.update(ok=False, reason="no commit after event")
        else:
            headroom = slo_ms - e["recovery_ms"]
            worst = headroom if worst is None else min(worst, headroom)
            v.update(ok=e["recovery_ms"] <= slo_ms,
                     reason="" if e["recovery_ms"] <= slo_ms else
                     f"recovery {e['recovery_ms']:g} ms > SLO "
                     f"{slo_ms:g} ms")
        verdicts.append(v)
    return {
        "verdicts": verdicts,
        "ok": all(v["ok"] for v in verdicts),
        "worst_headroom_ms": worst if worst is not None else 0.0,
    }
