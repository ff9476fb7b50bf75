"""Harness utilities: file-layout conventions, colored printing, progress.

Capability mirror of the reference's benchmark/benchmark/utils.py:12-134
(PathMaker / Print / progress_bar), with the same on-disk naming scheme so
results remain comparable across harnesses.
"""

from __future__ import annotations

import sys
from os.path import join


class BenchError(Exception):
    def __init__(self, message, error=None):
        super().__init__(message)
        self.message = message
        self.cause = error


class PathMaker:
    @staticmethod
    def binary_path():
        return join("native", "build")

    @staticmethod
    def node_crate_path():
        return "native"

    @staticmethod
    def committee_file():
        return ".committee.json"

    @staticmethod
    def parameters_file():
        return ".parameters.json"

    @staticmethod
    def key_file(i):
        assert isinstance(i, int) and i >= 0
        return f".node-{i}.json"

    @staticmethod
    def db_path(i):
        assert isinstance(i, int) and i >= 0
        return f".db-{i}"

    @staticmethod
    def logs_path():
        return "logs"

    @staticmethod
    def node_log_file(i):
        assert isinstance(i, int) and i >= 0
        return join(PathMaker.logs_path(), f"node-{i}.log")

    @staticmethod
    def client_log_file(i):
        assert isinstance(i, int) and i >= 0
        return join(PathMaker.logs_path(), f"client-{i}.log")

    @staticmethod
    def shard_client_log_file(i, j):
        """graftingress client shard j of node i.  INSIDE the
        client-*.log glob on purpose: shards are the baseline load,
        split across processes, and each must parse as a benchmark
        client (per-shard fairness rides on the per-log accounting)."""
        assert isinstance(i, int) and i >= 0
        assert isinstance(j, int) and j >= 0
        return join(PathMaker.logs_path(), f"client-{i}-{j}.log")

    @staticmethod
    def surge_client_log_file(i):
        """graftsurge flash-crowd generator aimed at replica i.  OUTSIDE
        the client-*.log glob on purpose: surge load is offered on top
        of the baseline, and its (killed) generator must not parse as a
        failed benchmark client or inflate the input rate."""
        assert isinstance(i, int) and i >= 0
        return join(PathMaker.logs_path(), f"surge-client-{i}.log")

    @staticmethod
    def sidecar_log_file(i=None):
        """graftfleet: sidecar i of a fleet logs to sidecar-<i>.log; the
        single-sidecar run keeps the legacy un-indexed name so existing
        tooling and result diffs stay comparable."""
        if i is None:
            return join(PathMaker.logs_path(), "sidecar.log")
        assert isinstance(i, int) and i >= 0
        return join(PathMaker.logs_path(), f"sidecar-{i}.log")

    @staticmethod
    def sidecar_stats_file(i=None):
        """verifysched OP_STATS snapshot, fetched at teardown (JSON);
        per-endpoint sidecar-stats-<i>.json under graftfleet."""
        if i is None:
            return join(PathMaker.logs_path(), "sidecar-stats.json")
        assert isinstance(i, int) and i >= 0
        return join(PathMaker.logs_path(), f"sidecar-stats-{i}.json")

    @staticmethod
    def sidecar_spans_file():
        """grafttrace sidecar span JSONL (obs/spans.py schema), written
        live by the sidecar behind --trace; obs/trace.py merges it into
        the run's trace.json."""
        return join(PathMaker.logs_path(), "sidecar-spans.jsonl")

    @staticmethod
    def metrics_file():
        """Live OP_STATS time series (obs/sampler.py JSONL), appended
        at a fixed interval DURING the run window."""
        return join(PathMaker.logs_path(), "metrics.jsonl")

    @staticmethod
    def trace_file():
        """Chrome-trace-event / Perfetto-loadable artifact built from
        the run's merged spans (obs/trace.write_run_trace)."""
        return join(PathMaker.logs_path(), "trace.json")

    @staticmethod
    def clock_offsets_file():
        """Per-log-file clock offsets in seconds (obs/trace.py), probed
        over the ssh transport on remote runs; absent locally."""
        return join(PathMaker.logs_path(), "clock-offsets.json")

    @staticmethod
    def chaos_events_file():
        """graftchaos executed-event record (JSON list, PlanRunner.events
        shape); written after the run window, read back by LogParser for
        the per-fault recovery-latency summary."""
        return join(PathMaker.logs_path(), "chaos-events.json")

    @staticmethod
    def wan_file():
        """graftwan spec snapshot (chaos/netem.WanSpec.to_json); written
        by the harness when a run shapes links so the parser can note
        what WAN the numbers were measured under."""
        return join(PathMaker.logs_path(), "wan.json")

    @staticmethod
    def slo_file():
        """Per-fault-class recovery SLO table (chaos/slo schema) the
        parser judges chaos events against; absent = defaults."""
        return join(PathMaker.logs_path(), "slo.json")

    @staticmethod
    def twin_log_file(i):
        """Log of a Twins equivocating replica — named OUTSIDE the
        node-*.log glob so twin commits never pollute the committee
        metrics (they only feed the safety assertion)."""
        assert isinstance(i, int) and i >= 0
        return join(PathMaker.logs_path(), f"twin-{i}.log")

    @staticmethod
    def twin_committee_file():
        """Committee view booted into a Twins replica: identical address
        book except the twin's own entry binds fresh ports."""
        return ".committee-twin.json"

    @staticmethod
    def twin_db_path():
        return ".db-twin"

    @staticmethod
    def results_path():
        return "results"

    @staticmethod
    def result_file(faults, nodes, rate, tx_size, chain=2):
        tag = "" if chain == 2 else f"{chain}chain-"
        return join(
            PathMaker.results_path(),
            f"bench-{tag}{faults}-{nodes}-{rate}-{tx_size}.txt",
        )

    @staticmethod
    def plot_path():
        return "plots"

    @staticmethod
    def agg_file(type, faults, nodes, rate, tx_size, max_latency=None):
        name = f"{type}-{faults}-{nodes}-{rate}-{tx_size}"
        if max_latency is not None:
            name += f"-{max_latency}"
        return join(PathMaker.plot_path(), f"{name}.txt")

    @staticmethod
    def plot_file(name, ext):
        return join(PathMaker.plot_path(), f"{name}.{ext}")


class Color:
    HEADER = "\033[95m"
    OK_BLUE = "\033[94m"
    OK_GREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    END = "\033[0m"
    BOLD = "\033[1m"


class Print:
    @staticmethod
    def heading(message):
        assert isinstance(message, str)
        print(f"{Color.OK_GREEN}{message}{Color.END}")

    @staticmethod
    def info(message):
        assert isinstance(message, str)
        print(message)

    @staticmethod
    def warn(message):
        assert isinstance(message, str)
        print(f"{Color.BOLD}{Color.WARNING}WARN{Color.END}: {message}")

    @staticmethod
    def error(e):
        assert isinstance(e, BenchError)
        print(f"\n{Color.BOLD}{Color.FAIL}ERROR{Color.END}: {e}\n")
        if e.cause is not None:
            print(f"Caused by: \n{e.cause}\n")


def progress_bar(it, prefix="", size=30, file=sys.stdout):
    count = len(it)

    def show(j):
        x = int(size * j / max(count, 1))
        file.write(f"{prefix}[{'#' * x}{'.' * (size - x)}] {j}/{count}\r")
        file.flush()

    show(0)
    for i, item in enumerate(it):
        yield item
        show(i + 1)
    file.write("\n")
    file.flush()
