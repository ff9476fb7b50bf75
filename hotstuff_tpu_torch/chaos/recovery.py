"""Per-fault recovery latency from executed events + the commit timeline.

Recovery of a fault is the first commit (merged earliest-commit view
across the committee, the LogParser's ``commits`` map) strictly after
the event's wall-clock injection stamp: HotStuff's liveness argument
promises exactly that commits resume after the view-change timeout, so
the gap between the injection and the next commit *is* the price of the
fault.  Every event is measured — including restarts/resumes — because
re-integration has its own recovery cost (a rebooting replica can steal
a leader slot and force another view change).

Shared by the harness LogParser (run-summary notes + strict assertion)
and bench.py's ``chaos`` headline field, so the two never disagree on
what "recovered" means.
"""

from __future__ import annotations

from bisect import bisect_right


def summarize_recovery(events, commit_times) -> dict:
    """``events``: executed-event dicts (PlanRunner.events() shape, or the
    ``logs/chaos-events.json`` round trip).  ``commit_times``: iterable of
    posix commit timestamps.  Returns a JSON-safe summary::

        {"events": [{t, target, action, wall, ok, recovery_ms,
                     recovered}, ...],
         "recovered": bool,        # every event saw a later commit
         "injected_ok": bool,      # every injection itself succeeded
         "max_recovery_ms": float,
         "unrecovered": [labels]}
    """
    commits = sorted(float(t) for t in commit_times)
    out_events = []
    unrecovered = []
    injected_ok = True
    max_ms = 0.0
    for e in events:
        rec = {
            "t": e.get("t"),
            "target": e.get("target"),
            "action": e.get("action"),
            "wall": e.get("wall"),
            "ok": bool(e.get("ok", True)),
        }
        if e.get("params"):
            rec["params"] = e["params"]
        if not rec["ok"]:
            injected_ok = False
            rec["error"] = e.get("error", "injection failed")
        wall = rec["wall"]
        recovery_ms = None
        if wall is not None and commits:
            i = bisect_right(commits, float(wall))
            if i < len(commits):
                recovery_ms = round((commits[i] - float(wall)) * 1e3, 1)
        rec["recovery_ms"] = recovery_ms
        rec["recovered"] = recovery_ms is not None
        if not rec["recovered"]:
            unrecovered.append(event_label(rec))
        else:
            max_ms = max(max_ms, recovery_ms)
        out_events.append(rec)
    return {
        "events": out_events,
        "recovered": not unrecovered,
        "injected_ok": injected_ok,
        "max_recovery_ms": max_ms,
        "unrecovered": unrecovered,
    }


def event_label(rec: dict) -> str:
    """One spelling for an event across the summary: the 'unrecovered'
    list here and the LogParser's per-event Chaos notes both use it."""
    t = rec.get("t")
    t_str = f"t={t:g}s" if isinstance(t, (int, float)) else "t=?"
    return f"{t_str} {rec.get('action')} {rec.get('target')}"
