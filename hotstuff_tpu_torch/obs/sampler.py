"""Live metrics sampler: OP_STATS as a time series, not a teardown shot.

The harness used to fetch ONE scheduler-telemetry snapshot at teardown —
so a chaos-killed sidecar lost its stats entirely, and nothing could
show throughput/queue-wait/breaker behavior *over time*.  The sampler
polls a fetch callable at a fixed interval for the whole run window and
appends one JSONL sample per tick to ``logs/metrics.jsonl``::

    {"t": <wall s>, "ok": true,  "stats": {<OP_STATS snapshot>}}
    {"t": <wall s>, "ok": false, "error": "<why>"}

Failed ticks are RECORDED, not skipped: a sidecar kill shows up as a
run of ``ok: false`` samples and the restart as the samples resuming —
that visible gap is how chaos SLO verdicts cite the recovery curve.
The last good snapshot stays available (``last``) so teardown can fall
back to it when the sidecar died before the final fetch.

The connection is PERSISTENT with reconnect-on-failure
(:func:`persistent_fetch`): one dial serves every healthy tick — the
1 Hz series stops paying (and accidentally measuring) a TCP dial per
sample — and a dead socket fails exactly one tick (recorded ``ok:
false``, connection dropped) before the next tick re-dials.  A sampler
pinned to one socket forever would die with the first kill and miss
the restart it exists to show; re-dialing only after failure keeps the
kill/restart gap semantics byte-identical to the old dial-per-tick
behavior (regression-tested).

graftscope adds the NODE side of the series: the C++ node emits 1 Hz
machine-parseable ``METRICS`` lines into its own log (common/metrics.cpp,
behind the ``trace`` parameter), and :func:`merge_node_series` mines
``node-*.log`` post-run and appends per-replica records next to the
sidecar samples::

    {"t": <wall s>, "ok": true, "node": "node-0.log",
     "metrics": {"commits": N, "commit_rate": f, "ingress_tx": N,
                 "ingress_bytes": N, "busy": N, "breaker": "closed"}}

``split_samples`` keeps the two sub-series apart for consumers that
reason about the sidecar only (recovery curves, SLO judges), and
``commit_rate_divergence`` turns the per-replica curves into straggler
evidence for the LogParser.

Clocks are injected (``clock``/``wall``/``wait``) — the virtual-clock
tests drive ticks manually, and graftlint's span checker keeps inline
``time.time()`` out of this package.
"""

from __future__ import annotations

import json
import threading
from time import time as _wall_clock


def persistent_fetch(dial, call=None, close=None):
    """Wrap a connection factory into the sampler's ``fetch`` contract
    with ONE reused connection.

    ``dial()`` opens a connection (raises on a dead sidecar — that tick
    records ``ok: false`` and the NEXT tick re-dials); ``call(conn)``
    fetches one snapshot (default: ``conn.stats()``, the SidecarClient
    surface); ``close(conn)`` releases it (default: ``conn.close()``).
    Any ``call`` failure drops the connection before re-raising, so a
    kill mid-run shows the same failed-tick gap a dial-per-tick sampler
    showed, minus the per-tick dial cost on every healthy sample.  The
    returned callable exposes ``.close()`` for teardown; the sampler's
    own ``stop()`` calls it."""
    call = call if call is not None else (lambda conn: conn.stats())
    close = close if close is not None else (lambda conn: conn.close())
    state = {"conn": None}

    def _drop():
        conn, state["conn"] = state["conn"], None
        if conn is not None:
            try:
                close(conn)
            except (OSError, ValueError):
                pass

    def fetch():
        conn = state["conn"]
        if conn is None:
            conn = dial()
            state["conn"] = conn
        try:
            return call(conn)
        except BaseException:
            _drop()
            raise

    fetch.close = _drop
    return fetch


class MetricsSampler:
    def __init__(self, fetch, path: str, interval_s: float = 1.0,
                 wall=_wall_clock, wait=None):
        """``fetch()`` returns one JSON-safe stats snapshot dict (and may
        raise OSError/ConnectionError/ValueError on a dead or garbled
        sidecar); ``wait(seconds) -> bool`` returns True when the
        sampler should stop (default: the stop event's own ``wait``,
        which a test replaces with a virtual clock).

        graftfleet: ``fetch`` may instead be a LIST of ``(endpoint,
        fetch)`` pairs — one per fleet sidecar.  Each tick then writes
        one record per endpoint, tagged ``"endpoint": "<host:port>"``,
        so a kill of sidecar i reads as ok-false ticks on that endpoint
        while the rest of the fleet's series keeps flowing.  ``last``
        still tracks the newest good sample overall; ``last_by_endpoint``
        keeps the per-endpoint fallback teardown needs."""
        if isinstance(fetch, list):
            self._fetches = list(fetch)
        else:
            self._fetches = [(None, fetch)]
        self._fetch = fetch  # kept for the stop()-time closer probe
        self._path = path
        self._interval_s = interval_s
        self._wall = wall
        self._stop = threading.Event()
        self._wait = wait if wait is not None else self._stop.wait
        self._lock = threading.Lock()
        self._file = None
        self._thread = None
        self.samples = 0
        self.ok_samples = 0
        self.last = None  # (wall_ts, snapshot) of the last GOOD sample
        self.last_by_endpoint = {}  # endpoint -> (wall_ts, snapshot)

    # -- one tick (the unit tests drive this directly) -----------------------

    def sample_once(self):
        """Fetch + record one sample per endpoint; returns the record
        written (single-fetch sampler, the legacy contract) or the list
        of records (endpoint list).  None / None entries mean the sink
        failed — telemetry never raises."""
        records = []
        for endpoint, fetch in self._fetches:
            t = self._wall()
            try:
                snap = fetch()
                if not isinstance(snap, dict):
                    raise ValueError(f"snapshot is {type(snap).__name__}, "
                                     "not a dict")
                rec = {"t": t, "ok": True, "stats": snap}
                self.last = (t, snap)
                if endpoint is not None:
                    self.last_by_endpoint[endpoint] = (t, snap)
                self.ok_samples += 1
            except (OSError, ConnectionError, ValueError, RuntimeError) as e:
                rec = {"t": t, "ok": False, "error": f"{e!r:.200}"}
            if endpoint is not None:
                rec["endpoint"] = endpoint
            self.samples += 1
            records.append(rec if self._write(rec) else None)
        if len(self._fetches) == 1 and self._fetches[0][0] is None:
            return records[0]
        return records

    def _write(self, rec: dict) -> bool:
        with self._lock:
            try:
                if self._file is None:
                    self._file = open(self._path, "a", encoding="utf-8")
                self._file.write(json.dumps(rec, sort_keys=True) + "\n")
                self._file.flush()
                return True
            except (OSError, TypeError, ValueError):
                return False

    # -- thread lifecycle ----------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="metrics-sampler")
        self._thread.start()
        return self

    def _run(self):
        while True:
            self.sample_once()
            if self._wait(self._interval_s):
                return

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        for _, fetch in self._fetches:
            closer = getattr(fetch, "close", None)
            if closer is not None:
                try:
                    closer()
                except (OSError, ValueError):
                    pass
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


def read_samples(path: str):
    """``metrics.jsonl`` -> ``(samples, malformed)`` with torn lines
    skipped and counted (a SIGKILLed harness can cut a line short;
    spans.parse_jsonl is the shared tolerance contract)."""
    from .spans import parse_jsonl

    try:
        with open(path, errors="replace") as f:
            text = f.read()
    except OSError:
        return [], 0
    return parse_jsonl(
        text,
        lambda rec: isinstance(rec.get("t"), (int, float))
        and "ok" in rec)


# -- graftscope: the C++ node's METRICS series -------------------------------

# The FROZEN node METRICS line grammar (common/metrics.cpp emit_sample;
# graftlint's obsgrammar checker cross-checks the two sides): the log
# prefix is the node's standard grammar, the payload is append-only
# key=value.  Torn fragments simply don't match — tolerance for free,
# the parse_node_trace convention.
# The graftingress admission-verify suffix (verified/forged/vq) is an
# optional group so logs from pre-signed-ingress builds keep parsing.
_NODE_METRICS_RE = (r"\[(\S+Z) \w+ [^\]]+\] METRICS "
                    r"commits=(\d+) commit_rate=([0-9.]+) "
                    r"ingress_tx=(\d+) ingress_bytes=(\d+) "
                    r"busy=(\d+) breaker=(\w+)"
                    r"(?: verified=(\d+) forged=(\d+) vq=(\d+))?")


def parse_node_metrics(log: str, host: str = "node") -> list:
    """One node log -> metrics.jsonl-shaped records (see module doc)."""
    import re

    from .trace import _to_posix

    records = []
    for (ts, commits, rate, itx, ibytes, busy, breaker,
         verified, forged, vq) in re.findall(_NODE_METRICS_RE, log):
        try:
            t = _to_posix(ts)
            metrics = {"commits": int(commits),
                       "commit_rate": float(rate),
                       "ingress_tx": int(itx),
                       "ingress_bytes": int(ibytes),
                       "busy": int(busy),
                       "breaker": breaker}
            if verified:
                metrics["verified"] = int(verified)
                metrics["forged"] = int(forged)
                metrics["vq"] = int(vq)
        except ValueError:
            continue
        records.append({"t": t, "ok": True, "node": host,
                        "metrics": metrics})
    return records


def collect_node_series(directory: str) -> list:
    """Mine every ``node-*.log`` in a logs directory -> node records,
    sorted by wall stamp."""
    import os
    from glob import glob

    records = []
    for path in sorted(glob(os.path.join(directory, "node-*.log"))):
        try:
            with open(path, errors="replace") as f:
                log = f.read()
        except OSError:
            continue
        records.extend(parse_node_metrics(log, host=os.path.basename(path)))
    records.sort(key=lambda r: r["t"])
    return records


def merge_node_series(directory: str, path: str | None = None) -> int:
    """Append the mined node series into ``<directory>/metrics.jsonl``
    (creating it when only the node side traced) so the one artifact
    carries per-replica series next to the sidecar's.  Idempotent: if
    the file already holds node records (a re-parse of the same logs
    dir), nothing is appended.  Returns the record count appended —
    best-effort, 0 on any failure (telemetry never raises)."""
    import os

    target = path or os.path.join(directory, "metrics.jsonl")
    try:
        existing, _ = read_samples(target)
        if any("node" in s for s in existing):
            return 0
        records = collect_node_series(directory)
        if not records:
            return 0
        with open(target, "a", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return len(records)
    except (OSError, TypeError, ValueError):
        return 0


def split_samples(samples):
    """One mixed metrics.jsonl series -> ``(sidecar, node)`` sub-series.
    Consumers that reason about the sidecar (recovery curves, baseline
    SLO judges, the throughput plot) must not see node records — a
    replica's ok=true tick would otherwise read as sidecar telemetry
    resuming."""
    sidecar = [s for s in samples if "node" not in s]
    node = [s for s in samples if "node" in s]
    return sidecar, node


def replica_commit_rates(node_samples) -> dict:
    """Node records -> ``{host: mean sampled commit rate}`` over the run
    window (the straggler-detection input)."""
    by_host: dict = {}
    for s in node_samples:
        metrics = s.get("metrics") or {}
        rate = metrics.get("commit_rate")
        if isinstance(rate, (int, float)):
            by_host.setdefault(s["node"], []).append(float(rate))
    return {host: sum(v) / len(v) for host, v in by_host.items() if v}


def commit_rate_divergence(node_samples, threshold: float = 0.7) -> dict:
    """Straggler detection over the sampled per-replica commit rates::

        {"median": <committee median mean-rate>,
         "rates": {host: mean_rate},
         "stragglers": [{"host", "rate", "ratio"}]}   # ratio < threshold

    A replica whose mean sampled commit rate falls below ``threshold``
    of the committee median diverges — it commits, but late enough that
    its view of the chain lags the committee (the LogParser surfaces
    this as a note; strict mode is unaffected, divergence is evidence,
    not failure)."""
    from statistics import median

    rates = replica_commit_rates(node_samples)
    if len(rates) < 2:
        return {"median": None, "rates": rates, "stragglers": []}
    med = median(rates.values())
    stragglers = []
    if med > 0:
        for host, rate in sorted(rates.items()):
            ratio = rate / med
            if ratio < threshold:
                stragglers.append({"host": host,
                                   "rate": round(rate, 3),
                                   "ratio": round(ratio, 3)})
    return {"median": round(med, 3), "rates":
            {h: round(r, 3) for h, r in rates.items()},
            "stragglers": stragglers}


def recovery_curve(samples, event_wall: float) -> dict:
    """What the sampled time series says about one fault event::

        {"resumed": bool,        # a good sample exists after the event
         "resume_ms": float,     # event -> first good sample after
         "failed_ticks": int,    # ok=false samples after the event,
                                 # before telemetry resumed
         "samples_after": int}

    This is the curve behind an SLO verdict: "recovered in 2.1 s" plus
    "telemetry blacked out for 3 failed ticks" tells the reader the
    sidecar actually died and came back, where the commit-only scalar
    could not distinguish a kill from a hiccup."""
    after = sorted((s for s in samples if s["t"] > event_wall),
                   key=lambda s: s["t"])
    failed = 0
    for s in after:
        if s.get("ok"):
            return {"resumed": True,
                    "resume_ms": round((s["t"] - event_wall) * 1e3, 3),
                    "failed_ticks": failed,
                    "samples_after": len(after)}
        failed += 1
    return {"resumed": False, "resume_ms": None,
            "failed_ticks": failed, "samples_after": len(after)}
