"""Tracing for the port's sidecar: the span records and the JSONL tracer
(``spans``), copied from hotstuff_tpu/obs."""

from .spans import Tracer, parse_spans  # noqa: F401
