"""Fault-plan model: a validated, time-ordered list of fault events.

A plan is declarative — *what* happens *when* — and carries no process
knowledge; the runner hands each due event to an injector (the harness's
``LocalFaultInjector``, or a stub in tests/bench probes).

Targets
    ``sidecar``      the verify sidecar process
    ``sidecar:<i>``  sidecar i of a graftfleet (``--sidecar-fleet k``)
                     run — same actions as ``sidecar``; index 0 is the
                     primary every node dials first.  A plan must pick
                     ONE naming: mixing bare ``sidecar`` with indexed
                     ``sidecar:<i>`` events is rejected (index 0 and the
                     bare name are the same process, which the
                     per-target state machine cannot merge).
    ``node:<i>``     replica i of the local committee (boot order index)
    ``link:<name>``  a directed WAN link by its graftwan spec label
                     (chaos/netem.py) — requires a WAN spec on the run
    ``client:<i>``   the load generator aimed at replica i (graftsurge)

Actions (per target)
    node:     ``kill`` (SIGKILL), ``restart`` (reboot on the same store),
              ``pause`` / ``resume`` (SIGSTOP/SIGCONT — a cheap
              network-partition proxy: the process holds its sockets but
              answers nothing, exactly what a partitioned peer looks
              like to the committee)
    sidecar:  ``kill``, ``restart``, ``degrade`` — the protocol v3
              ``OP_CHAOS`` hook (bounded reply delay, connection drops,
              forced queue-full sheds) for testing client-side handling
              without process murder (``degrade`` params ride in the
              event's ``params`` dict, see sidecar/service.ChaosState) —
              and ``wedge`` (graftguard): the next ``n`` device launches
              hang past their guard deadline, driving the in-sidecar
              supervisor ladder (host-fallback replies, quarantine,
              crash-only reboot, canary) end to end.  DSL:
              ``"5 sidecar wedge"`` or ``"5 sidecar wedge n=2"``.
    link:     ``partition`` (the link black-holes: netem ``loss 100%``
              remotely, a dropped WanProxy locally) and ``heal``
              (restore the spec shape) — the netem partition-heal fault
              class, measured like every other event.
    client:   ``surge`` — a flash crowd (graftsurge): the offered load
              aimed at that replica multiplies by ``x`` for ``for``
              seconds, then returns to baseline.  DSL sugar:
              ``"10 client:0 surge x5 for 20"`` (also accepted as
              ``x=5 for=20``).  Injectors realize it as an extra
              load-generator process at ``(x-1)``× the client's rate,
              killed when the window closes.
    leader-cascade: ``kill`` with ``k=<n>`` (graftview) — the view-change
              storm drill: SIGKILL the leader of each of the next ``k``
              rounds (round-robin election over the sorted committee, the
              C++ LeaderElector's rule), so the committee must survive k
              chained view changes — timeout broadcast, batched TC
              assembly, backoff pacemaker — before a live leader
              proposes again.  DSL: ``"10 leader-cascade kill k=3"``.
              Judged by the ``view-change`` SLO class and the parser's
              TC-formed / round-jump notes.  Which node indices die is a
              runtime decision (it depends on the round the committee
              has reached), so the per-target state machine does not
              track them: mixing leader-cascade with ANY node:<i>
              event in one plan is rejected.

Validation is a per-target state machine over the time-ordered events:
``restart`` must follow ``kill``, ``resume`` must follow ``pause``,
``heal`` must follow ``partition``, ``degrade`` needs a live sidecar,
and surges on one client must not overlap — a plan that cannot
physically execute fails at parse time, not five seconds into a
thirty-second bench.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

ACTIONS = ("kill", "restart", "pause", "resume", "degrade",
           "partition", "heal", "surge", "wedge")
SIDECAR = "sidecar"
LEADER_CASCADE = "leader-cascade"

_NODE_RE = re.compile(r"^node:(\d+)$")
_LINK_RE = re.compile(r"^link:(\S+)$")
_CLIENT_RE = re.compile(r"^client:(\d+)$")
_SIDECAR_IX_RE = re.compile(r"^sidecar:(\d+)$")


def node_index(target: str):
    """``"node:<i>"`` -> i, else None (the one place the target grammar
    is parsed; the injector and plan validation both route through it)."""
    m = _NODE_RE.match(target)
    return int(m.group(1)) if m else None


def link_name(target: str):
    """``"link:<name>"`` -> the graftwan link label, else None."""
    m = _LINK_RE.match(target)
    return m.group(1) if m else None


def client_index(target: str):
    """``"client:<i>"`` -> i, else None (graftsurge load targets)."""
    m = _CLIENT_RE.match(target)
    return int(m.group(1)) if m else None


def sidecar_index(target: str):
    """``"sidecar:<i>"`` -> i (graftfleet indexed sidecar), else None.
    The bare ``"sidecar"`` target is NOT an index — callers route it
    via the SIDECAR constant (it aliases fleet index 0 at injection
    time, and plans may not mix the two namings)."""
    m = _SIDECAR_IX_RE.match(target)
    return int(m.group(1)) if m else None


# Surge parameter defaults — ONE definition shared by validation, the
# injectors, the window math (max_time), the SLO judge, and the parser's
# goodput notes, so a plan omitting a param means the same thing at
# every layer.
SURGE_DEFAULT_X = 2.0
SURGE_DEFAULT_FOR_S = 10.0


def surge_window_s(params) -> float:
    """The surge's active-window length in seconds (default applied)."""
    try:
        return float((params or {}).get("for", SURGE_DEFAULT_FOR_S))
    except (TypeError, ValueError):
        return SURGE_DEFAULT_FOR_S


# graftview: default cascade depth — ONE definition shared by validation,
# the injector, the harness pre-flight quorum check, and the parser's
# client-death tolerance, so an omitted ``k`` means the same thing at
# every layer.
CASCADE_DEFAULT_K = 1


def cascade_k(params) -> int:
    """A leader-cascade event's kill depth (default applied)."""
    try:
        return int((params or {}).get("k", CASCADE_DEFAULT_K))
    except (TypeError, ValueError):
        return CASCADE_DEFAULT_K

# Actions each target kind accepts (sidecar pause would stop the shared
# verify engine for EVERY replica at once — use degrade for that class
# of fault instead, it is observable and bounded).
_NODE_ACTIONS = {"kill", "restart", "pause", "resume"}
_SIDECAR_ACTIONS = {"kill", "restart", "degrade", "wedge"}
_LINK_ACTIONS = {"partition", "heal"}
_CLIENT_ACTIONS = {"surge"}
_CASCADE_ACTIONS = {"kill"}

# degrade params the sidecar's ChaosState accepts (mirrored there; the
# plan validates early so a typo fails at parse time).
DEGRADE_KEYS = ("delay_ms", "shed", "drop", "clear")


class PlanError(ValueError):
    """Malformed or physically unexecutable fault plan."""


@dataclass(frozen=True)
class FaultEvent:
    t: float                    # seconds from the start of the run window
    target: str                 # "sidecar" or "node:<i>"
    action: str
    params: dict = field(default_factory=dict)

    def label(self) -> str:
        return f"t={self.t:g}s {self.action} {self.target}"

    def to_json(self) -> dict:
        out = {"t": self.t, "target": self.target, "action": self.action}
        if self.params:
            out["params"] = dict(self.params)
        return out


@dataclass(frozen=True)
class FaultPlan:
    events: tuple

    def to_json(self) -> list:
        return [e.to_json() for e in self.events]

    def node_indices(self) -> set:
        out = set()
        for e in self.events:
            i = node_index(e.target)
            if i is not None:
                out.add(i)
        return out

    def sidecar_indices(self) -> set:
        """Every graftfleet sidecar index the plan faults (validated
        against the run's fleet size by the harness before boot)."""
        out = set()
        for e in self.events:
            i = sidecar_index(e.target)
            if i is not None:
                out.add(i)
        return out

    def link_names(self) -> set:
        """Every graftwan link the plan faults (validated against the
        run's WAN spec by the harness before anything boots)."""
        out = set()
        for e in self.events:
            name = link_name(e.target)
            if name is not None:
                out.add(name)
        return out

    def max_time(self) -> float:
        """Latest event activity: a surge occupies ``[t, t + for]``, so
        its END is what run-window headroom must clear."""
        out = 0.0
        for e in self.events:
            end = e.t
            if e.action == "surge":
                end += surge_window_s(e.params)
            out = max(out, end)
        return out


def _event_from_dict(obj: dict) -> FaultEvent:
    unknown = set(obj) - {"t", "target", "action", "params"}
    if unknown:
        raise PlanError(f"unknown event key(s) {sorted(unknown)}")
    try:
        t = float(obj["t"])
        target = str(obj["target"])
        action = str(obj["action"])
    except (KeyError, TypeError, ValueError) as e:
        raise PlanError(f"event needs numeric 't', 'target', 'action': {e}")
    params = obj.get("params", {})
    if not isinstance(params, dict):
        raise PlanError(f"{action} {target}: params must be an object")
    return FaultEvent(t, target, action, dict(params))


def _event_from_text(entry: str) -> FaultEvent:
    """``"<t> <target> <action> [k=v ...]"`` -> event (the inline DSL).

    Surge sugar: ``"10 client:0 surge x5 for 20"`` — an ``xN`` token is
    the multiplier, ``for N`` the window seconds (both also accepted in
    k=v form)."""
    toks = entry.split()
    if len(toks) < 3:
        raise PlanError(
            f"bad plan entry {entry!r}: want '<t> <target> <action>'")
    t_raw = toks[0][:-1] if toks[0].endswith("s") else toks[0]
    try:
        t = float(t_raw)
    except ValueError:
        raise PlanError(f"bad event time {toks[0]!r} in {entry!r}")
    params = {}
    rest = list(toks[3:])
    i = 0
    while i < len(rest):
        tok = rest[i]
        if toks[2] == "surge" and re.fullmatch(r"x\d+(\.\d+)?", tok):
            params["x"] = float(tok[1:])
            i += 1
            continue
        if toks[2] == "surge" and tok == "for" and i + 1 < len(rest):
            try:
                params["for"] = float(rest[i + 1])
            except ValueError:
                raise PlanError(
                    f"bad surge duration {rest[i + 1]!r} in {entry!r}")
            i += 2
            continue
        if "=" not in tok:
            raise PlanError(f"bad param {tok!r} in {entry!r} (want k=v)")
        k, v = tok.split("=", 1)
        try:
            params[k] = int(v)
        except ValueError:
            try:
                params[k] = float(v)
            except ValueError:
                params[k] = v
        i += 1
    return FaultEvent(t, toks[1], toks[2], params)


def _validate(events) -> FaultPlan:
    # Per-target liveness state machine over the time-ordered sequence.
    state: dict[str, str] = {}
    surge_until: dict[str, float] = {}
    ordered = sorted(events, key=lambda e: e.t)
    for e in ordered:
        if not (e.t >= 0.0 and e.t == e.t and e.t != float("inf")):
            raise PlanError(f"{e.label()}: event time must be finite >= 0")
        if e.action not in ACTIONS:
            raise PlanError(f"{e.label()}: unknown action (have "
                            f"{', '.join(ACTIONS)})")
        if e.target == SIDECAR or _SIDECAR_IX_RE.match(e.target):
            allowed = _SIDECAR_ACTIONS
        elif e.target == LEADER_CASCADE:
            allowed = _CASCADE_ACTIONS
        elif _NODE_RE.match(e.target):
            allowed = _NODE_ACTIONS
        elif _LINK_RE.match(e.target):
            allowed = _LINK_ACTIONS
        elif _CLIENT_RE.match(e.target):
            allowed = _CLIENT_ACTIONS
        else:
            raise PlanError(f"{e.label()}: target must be 'sidecar', "
                            "'sidecar:<i>', 'leader-cascade', 'node:<i>', "
                            "'link:<name>', or 'client:<i>'")
        if e.action not in allowed:
            raise PlanError(f"{e.label()}: {e.target} does not support "
                            f"{e.action} (allowed: {', '.join(sorted(allowed))})")
        if e.params and e.action not in ("degrade", "surge", "wedge") \
                and e.target != LEADER_CASCADE:
            raise PlanError(f"{e.label()}: only degrade, surge, wedge, "
                            "and leader-cascade take params")
        if e.target == LEADER_CASCADE:
            bad = set(e.params) - {"k"}
            if bad:
                raise PlanError(f"{e.label()}: unknown leader-cascade "
                                f"param(s) {sorted(bad)} (have k)")
            k = e.params.get("k", CASCADE_DEFAULT_K)
            if not isinstance(k, int) or isinstance(k, bool) or k < 1:
                raise PlanError(
                    f"{e.label()}: leader-cascade k must be an int >= 1 "
                    f"(got {k!r})")
        if e.action == "wedge":
            bad = set(e.params) - {"n"}
            if bad:
                raise PlanError(f"{e.label()}: unknown wedge param(s) "
                                f"{sorted(bad)} (have n)")
            n = e.params.get("n", 1)
            if not isinstance(n, int) or isinstance(n, bool) or n < 1:
                raise PlanError(
                    f"{e.label()}: wedge n must be an int >= 1 "
                    f"(got {n!r})")
        if e.action == "surge":
            bad = set(e.params) - {"x", "for"}
            if bad:
                raise PlanError(f"{e.label()}: unknown surge param(s) "
                                f"{sorted(bad)} (have x, for)")
            x = e.params.get("x", SURGE_DEFAULT_X)
            dur = e.params.get("for", SURGE_DEFAULT_FOR_S)
            for key, v, lo in (("x", x, 1.0), ("for", dur, 0.0)):
                if not isinstance(v, (int, float)) or isinstance(v, bool) \
                        or v != v or v == float("inf") or not v > lo:
                    raise PlanError(
                        f"{e.label()}: surge {key} must be a finite "
                        f"number > {lo:g} (got {v!r})")
            if e.t < surge_until.get(e.target, -1.0):
                raise PlanError(
                    f"{e.label()}: overlaps the previous surge on "
                    f"{e.target} (still running until "
                    f"t={surge_until[e.target]:g}s)")
            surge_until[e.target] = e.t + float(dur)
        if e.action == "degrade":
            bad = set(e.params) - set(DEGRADE_KEYS)
            if bad:
                raise PlanError(f"{e.label()}: unknown degrade param(s) "
                                f"{sorted(bad)} (have "
                                f"{', '.join(DEGRADE_KEYS)})")
            # Mirror ChaosState.configure's value rules so a typo'd value
            # fails here, not as a mid-run injection failure that costs
            # the whole bench window.
            for key in ("delay_ms", "shed", "drop"):
                v = e.params.get(key)
                if v is not None and (not isinstance(v, int)
                                      or isinstance(v, bool) or v < 0):
                    raise PlanError(
                        f"{e.label()}: degrade {key} must be an int >= 0 "
                        f"(got {v!r})")
        if e.target == LEADER_CASCADE:
            # Which node indices die is a runtime decision, so the
            # per-target state machine cannot track a cascade; keep it
            # stateless (two cascades in one plan are legal).
            continue
        cur = state.get(e.target, "up")
        if e.action == "kill" and cur == "down":
            raise PlanError(f"{e.label()}: target is already down")
        if e.action == "restart" and cur != "down":
            raise PlanError(f"{e.label()}: restart must follow a kill")
        if e.action == "pause" and cur != "up":
            raise PlanError(f"{e.label()}: pause needs a live target")
        if e.action == "resume" and cur != "paused":
            raise PlanError(f"{e.label()}: resume must follow a pause")
        if e.action in ("degrade", "wedge") and cur != "up":
            raise PlanError(
                f"{e.label()}: {e.action} needs a live sidecar")
        if e.action == "partition" and cur != "up":
            raise PlanError(f"{e.label()}: link is already partitioned")
        if e.action == "heal" and cur != "partitioned":
            raise PlanError(f"{e.label()}: heal must follow a partition")
        state[e.target] = {"kill": "down", "restart": "up",
                           "pause": "paused", "resume": "up",
                           "degrade": "up", "partition": "partitioned",
                           "heal": "up", "surge": "up",
                           "wedge": "up"}[e.action]
    # A cascade kills nodes the state machine cannot name, so ANY
    # explicit node:<i> event in the same plan could operate on a
    # replica the cascade already murdered — a later restart/resume
    # would fail at runtime, and a paused replica reads as live to the
    # cascade (poll() is None under SIGSTOP) so even pause/resume pairs
    # can have their second half invalidated.  Unexecutable: reject.
    if any(e.target == LEADER_CASCADE for e in ordered) and \
            any(node_index(e.target) is not None for e in ordered):
        raise PlanError(
            "a plan mixing leader-cascade with node:<i> events cannot "
            "be validated (the cascade's victims are chosen at "
            "runtime); use separate plans")
    # Bare "sidecar" and indexed "sidecar:0" name the SAME process, but
    # the state machine above tracked them as independent targets — a
    # mixed plan could validate and then double-kill at runtime.
    if any(e.target == SIDECAR for e in ordered) and \
            any(sidecar_index(e.target) is not None for e in ordered):
        raise PlanError(
            "a plan mixing the bare 'sidecar' target with indexed "
            "'sidecar:<i>' targets cannot be validated (the bare name "
            "aliases fleet index 0); pick one naming")
    return FaultPlan(tuple(ordered))


def parse_plan(spec) -> FaultPlan:
    """Parse + validate a fault plan from any accepted shape:

    * a ``FaultPlan`` (returned as-is),
    * a list of event dicts (or of DSL strings),
    * a path to a JSON file (a list, or ``{"events": [...]}``),
    * an inline DSL string: ``";"``/newline-separated
      ``"<t> <target> <action> [k=v ...]"`` entries, e.g.
      ``"5 sidecar kill; 10 sidecar restart; 12 node:1 pause; 15 node:1 resume"``.

    Raises :class:`PlanError` on anything malformed or unexecutable.
    """
    if isinstance(spec, FaultPlan):
        return spec
    if isinstance(spec, str):
        if os.path.isfile(spec):
            try:
                with open(spec, encoding="utf-8") as f:
                    obj = json.load(f)
            except (OSError, ValueError) as e:
                raise PlanError(f"cannot read fault plan {spec!r}: {e}")
            if isinstance(obj, dict):
                obj = obj.get("events")
            if not isinstance(obj, list):
                raise PlanError(f"{spec!r}: want a JSON list of events "
                                "(or {'events': [...]})")
            spec = obj
        else:
            spec = [entry for entry in
                    re.split(r"[;\n]", spec) if entry.strip()]
            if not spec:
                raise PlanError("empty fault plan")
    if not isinstance(spec, (list, tuple)):
        raise PlanError(f"unsupported fault-plan spec type "
                        f"{type(spec).__name__}")
    events = []
    for entry in spec:
        if isinstance(entry, FaultEvent):
            events.append(entry)
        elif isinstance(entry, dict):
            events.append(_event_from_dict(entry))
        elif isinstance(entry, str):
            events.append(_event_from_text(entry.strip()))
        else:
            raise PlanError(f"bad plan entry {entry!r}")
    return _validate(events)
