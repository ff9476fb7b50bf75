"""Tracing and metrics for the port's sidecar and harness: the port's
copy of hotstuff_tpu/obs.

``spans``
    The span records and the JSONL tracer the sidecar's stages write
    through (admit -> queue -> pack -> dispatch -> device -> reply).

``trace``
    The collector/merger over the C++ node's ``TRACE`` lines and the
    sidecar's spans: clock offsets, per-block commit traces, the
    critical-path breakdown, and the Chrome-trace export.

``sampler``
    The live OP_STATS sampler of the run window (``logs/metrics.jsonl``)
    and the C++ node's ``METRICS`` line reader.
"""

from __future__ import annotations

from .sampler import (
    MetricsSampler,
    commit_rate_divergence,
    merge_node_series,
    parse_node_metrics,
    persistent_fetch,
    read_samples,
    recovery_curve,
    split_samples,
)
from .spans import SpanError, Tracer, parse_spans
from .trace import (
    build_run_trace,
    chain_spans,
    chrome_trace,
    clock_offset,
    critical_path,
    join_blocks,
    parse_node_trace,
    stitch_blocks,
    write_run_trace,
)

__all__ = [
    "MetricsSampler",
    "SpanError",
    "Tracer",
    "build_run_trace",
    "chain_spans",
    "chrome_trace",
    "clock_offset",
    "commit_rate_divergence",
    "critical_path",
    "join_blocks",
    "merge_node_series",
    "parse_node_metrics",
    "parse_node_trace",
    "parse_spans",
    "persistent_fetch",
    "read_samples",
    "recovery_curve",
    "split_samples",
    "stitch_blocks",
    "write_run_trace",
]
