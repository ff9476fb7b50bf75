"""Span records + the JSONL tracer the sidecar's stages write through:
a copy of hotstuff_tpu/obs/spans.py, so the port's ``--trace`` file is
the reference's format (``hotstuff_tpu.obs.parse_spans`` and
obs/trace.py read it unchanged).

One span = one JSON object on its own line::

    {"stage": "pack", "t": 1722600000.123, "dur_ms": 4.2,
     "rid": 17, "cls": "latency", ...}

``t`` is the span's START as wall-clock seconds (the merger aligns
wall clocks across hosts; monotonic stamps cannot be merged), ``dur_ms``
its duration; instantaneous marks carry ``dur_ms: 0``.  Everything else
is free-form tags -- the sidecar tags ``rid`` (request id) and ``cls``
(scheduler class) so a request can be followed admit -> queue -> pack ->
dispatch -> device -> reply.

Discipline:

  * a ``begin_span`` must reach its ``end_span`` on every return path --
    use the ``span()`` context manager, or pair them in a ``finally``;
  * timestamps come from the INJECTED clock only (``clock=`` at
    construction), never an inline ``time.time()`` -- virtual-clock
    tests and the trace merger's offset math both depend on one
    substitutable time source per process.

Telemetry is best-effort by contract: a tracer whose sink fails (disk
full, path unwritable) disables itself and the engine keeps verifying --
spans must never take the data plane down with them.
"""

from __future__ import annotations

import json
import threading
from time import time as _wall_clock


class SpanError(ValueError):
    """Malformed span record (parse-side only; writers never raise)."""


class Tracer:
    """Thread-safe append-only JSONL span writer.

    ``Tracer(None)`` (or ``Tracer.disabled()``) is the null tracer:
    every call is a cheap no-op, so instrumented code needs no
    ``if tracing:`` guards at the call sites.
    """

    def __init__(self, path: str | None, clock=_wall_clock):
        self._path = path
        self._clock = clock
        self._lock = threading.Lock()
        self._file = None
        self.enabled = path is not None
        self.dropped = 0  # spans lost to sink failures (telemetry)

    @classmethod
    def disabled(cls) -> "Tracer":
        return cls(None)

    # -- recording -----------------------------------------------------------

    def begin_span(self, stage: str, **tags) -> dict:
        """Open a span; the returned token MUST reach :meth:`end_span`
        on every return path (use :meth:`span` where control flow
        allows)."""
        if not self.enabled:
            return {}
        token = {"stage": stage, "t": self._clock()}
        token.update(tags)
        return token

    def end_span(self, token: dict, **tags):
        """Close a span begun by :meth:`begin_span` and write it."""
        if not self.enabled or not token:
            return
        rec = dict(token)
        rec.update(tags)
        rec["dur_ms"] = round((self._clock() - rec["t"]) * 1e3, 3)
        self._write(rec)

    def span(self, stage: str, **tags):
        """``with tracer.span("pack", rid=7): ...`` — begin/end pairing
        the interpreter guarantees."""
        return _SpanCtx(self, stage, tags)

    def event(self, stage: str, dur_ms: float | None = None, **tags):
        """One-shot record: an instantaneous mark, or a span whose
        duration was measured elsewhere (cross-thread stages carry a
        start stamp in their bookkeeping instead of an open token)."""
        if not self.enabled:
            return
        rec = {"stage": stage, "t": self._clock(),
               "dur_ms": round(dur_ms, 3) if dur_ms is not None else 0.0}
        rec.update(tags)
        self._write(rec)

    def now(self) -> float:
        """The tracer's clock (for cross-thread duration bookkeeping —
        the one sanctioned way instrumented code reads time)."""
        return self._clock()

    # -- sink ----------------------------------------------------------------

    def _write(self, rec: dict):
        try:
            line = json.dumps(rec, sort_keys=True)
        except (TypeError, ValueError):
            self.dropped += 1
            return
        with self._lock:
            if not self.enabled:
                return
            try:
                if self._file is None:
                    self._file = open(self._path, "a", encoding="utf-8")
                self._file.write(line + "\n")
                self._file.flush()
            except OSError:
                # Sink gone: disable forever, never stall the engine.
                self.enabled = False
                self.dropped += 1
                try:
                    if self._file is not None:
                        self._file.close()
                except OSError:
                    pass
                self._file = None

    def close(self):
        with self._lock:
            self.enabled = False
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


class _SpanCtx:
    __slots__ = ("_tracer", "_stage", "_tags", "_token")

    def __init__(self, tracer: Tracer, stage: str, tags: dict):
        self._tracer = tracer
        self._stage = stage
        self._tags = tags
        self._token = {}

    def __enter__(self):
        self._token = self._tracer.begin_span(self._stage, **self._tags)
        return self._token

    def __exit__(self, exc_type, exc, tb):
        self._tracer.end_span(self._token,
                              **({"error": True} if exc_type else {}))
        return False


def parse_jsonl(text: str, valid):
    """JSONL text -> ``(records, malformed)`` with ``valid(rec)`` as the
    per-record predicate (records are always dicts by the time it runs).

    This is THE torn-line tolerance contract for the whole obs package
    (spans and metrics share it): concurrent writers, or a chaos SIGKILL
    mid-line, can tear lines; torn/garbage lines are skipped and
    counted, never raised — the same contract as the LogParser's log
    sanitizer."""
    records = []
    malformed = 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            malformed += 1
            continue
        if not isinstance(rec, dict) or not valid(rec):
            malformed += 1
            continue
        records.append(rec)
    return records, malformed


def parse_spans(text: str):
    """JSONL span text -> ``(spans, malformed)`` (torn lines skipped and
    counted; see :func:`parse_jsonl`)."""
    return parse_jsonl(
        text,
        lambda rec: "stage" in rec and isinstance(rec.get("t"),
                                                  (int, float)))
