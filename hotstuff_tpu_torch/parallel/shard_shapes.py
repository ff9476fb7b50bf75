"""The shard-alignment rule: how a global batch size maps onto per-shard
row counts on an n-device mesh (the port of
hotstuff_tpu/parallel/shard_shapes.py, copied exactly).

Every mesh launch pads its batch so each shard gets the same
power-of-two row count (a per-shard "bucket").  The JAX package warms
exactly those per-shard shapes; the port compiles nothing per shape, but
its registry routes on the same buckets, so the two packages take the
same path for the same marks.  The mesh verifiers
(parallel/sharded_verify), the scheduler's shape registry
(sidecar/sched/shapes) and the warm-up (sidecar/service) all route
through here.

Pure integer arithmetic.
"""

from __future__ import annotations

from ..crypto.eddsa import _MIN_BUCKET, MAX_SUBBATCH
from ..utils.intmath import next_pow2


def shard_bucket(n: int, n_devices: int,
                 max_subbatch: int = MAX_SUBBATCH) -> int:
    """Per-shard padded row count for a global batch of ``n`` records.

    Power-of-two bucket of ceil(n / n_devices), floored at the smallest
    per-shard shape the warm-up runs (_MIN_BUCKET / n_devices rows:
    warmed global sizes start at _MIN_BUCKET) and capped at
    ``max_subbatch``; beyond the cap the shard runs as whole
    ``max_subbatch`` chunks, so the bucket grows in power-of-two
    multiples of ``max_subbatch`` instead.
    """
    if n_devices < 1:
        raise ValueError(f"need a positive device count, got {n_devices}")
    per_shard = -(-max(n, 1) // n_devices)
    if per_shard <= max_subbatch:
        lo = max(1, _MIN_BUCKET // n_devices)
        return min(next_pow2(per_shard, lo), max_subbatch)
    g = next_pow2(-(-per_shard // max_subbatch))
    return g * max_subbatch


def shard_aligned_rows(n: int, n_devices: int,
                       max_subbatch: int = MAX_SUBBATCH) -> int:
    """Global padded row count of an ``n``-record mesh launch: the
    per-shard bucket times the device count, so divisible by
    ``n_devices``; the capacity pad-fill may use without growing any
    shard's shape."""
    return n_devices * shard_bucket(n, n_devices, max_subbatch)


def mesh_chunk_count(n: int, n_devices: int, rows: int) -> int:
    """Chunk count g of a whole-backlog mesh scan
    (parallel/sharded_verify.verify_sharded_chunked): each shard runs g
    chunks of ``rows`` rows, so an ``n``-record backlog pads to
    ``n_devices * g * rows`` rows.

    ``rows`` is the per-shard chunk row count of the warmed scan shapes
    (the warm-up's top per-shard bucket, a power of two); g is the power
    of two that covers ceil(n / n_devices) rows per shard.  Whenever
    per-shard demand exceeds ``rows``, ``g * rows == shard_bucket(n)``:
    3000 records on 8 devices at rows=128 scan as g=4 chunks, 512 rows a
    shard, the 8 x 512 that ``shard_aligned_rows`` gives.
    """
    if n_devices < 1:
        raise ValueError(f"need a positive device count, got {n_devices}")
    if rows < 1 or rows & (rows - 1):
        raise ValueError(f"scan chunk rows must be a power of two, "
                         f"got {rows}")
    per_shard = -(-max(n, 1) // n_devices)
    return next_pow2(-(-per_shard // rows))
