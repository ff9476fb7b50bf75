"""hotstuff_tpu_torch.parallel.shard_shapes, the shard-alignment rule,
held to the JAX package's copy over a sweep of batch sizes and mesh
sizes, and the mesh shape registry's routes to the reference
registry's for the same marks.  Pure Python: no device program runs."""

from __future__ import annotations

import pytest

from hotstuff_tpu.parallel import shard_shapes as ref
from hotstuff_tpu.sidecar import sched as jsched
from hotstuff_tpu_torch.parallel import shard_shapes as port
from hotstuff_tpu_torch.sidecar import sched as psched

N_DEVICES = (1, 2, 3, 4, 8)
# Every n up to 2,100, then a stride to 20,000 that keeps crossing
# bucket edges.
SIZES = list(range(0, 2101)) + list(range(2101, 20001, 37)) + [
    4095, 4096, 4097, 8191, 8192, 8193, 16383, 16384, 16385, 20000]


@pytest.mark.parametrize("n_devices", N_DEVICES)
def test_shard_bucket_and_aligned_rows_equal_the_reference(n_devices):
    for n in SIZES:
        assert port.shard_bucket(n, n_devices) == \
            ref.shard_bucket(n, n_devices), n
        assert port.shard_aligned_rows(n, n_devices) == \
            ref.shard_aligned_rows(n, n_devices), n
    for cap in (2, 4, 64):
        for n in range(0, 600, 7):
            assert port.shard_bucket(n, n_devices, cap) == \
                ref.shard_bucket(n, n_devices, cap), (n, cap)


@pytest.mark.parametrize("n_devices", N_DEVICES)
def test_mesh_chunk_count_equals_the_reference(n_devices):
    for rows in (1, 2, 4, 128, 256, 1024):
        for n in SIZES[::3]:
            assert port.mesh_chunk_count(n, n_devices, rows) == \
                ref.mesh_chunk_count(n, n_devices, rows), (n, rows)


@pytest.mark.parametrize("fn,args", [
    ("shard_bucket", (8, 0)), ("shard_aligned_rows", (8, 0)),
    ("mesh_chunk_count", (100, 0, 4)), ("mesh_chunk_count", (100, 8, 3)),
    ("mesh_chunk_count", (100, 8, 0))])
def test_bad_arguments_raise_as_the_reference(fn, args):
    for mod in (ref, port):
        with pytest.raises(ValueError):
            getattr(mod, fn)(*args)


def _marked(pkg, n_devices, committee, rlc_top, scan_chunks):
    """A mesh registry with the marks a warm-up of the reference's
    order makes: per-signature buckets 8 .. 1024, sharded RLC buckets
    from the smallest per-shard bucket to ``rlc_top``'s, scan chunks 2 ..
    ``scan_chunks`` of that top bucket, then the launch-cap raise."""
    reg = pkg.ShapeRegistry(n_devices=n_devices, committee=committee)
    n = 8
    while n <= 1024:
        reg.mark_bucket(n)
        n *= 2
    per = port.shard_bucket(1, n_devices)
    top = port.shard_bucket(rlc_top, n_devices)
    while per <= top:
        reg.mark_bucket(n_devices * per)
        reg.mark_rlc_sharded(n_devices * per)
        per *= 2
    g = 2
    while g <= scan_chunks:
        reg.mark_mesh_chunks(g, top)
        g *= 2
    reg.enable_bulk(16 * 1024)
    return reg


@pytest.mark.parametrize("n_devices,committee,rlc_top,scan_chunks", [
    (2, None, 1024, 16), (4, 1000, 1024, 16), (4, None, 64, 4),
    (8, 100, 256, 8), (3, None, 1024, 2)])
def test_mesh_routes_equal_the_reference_for_the_same_marks(
        n_devices, committee, rlc_top, scan_chunks):
    refreg = _marked(jsched, n_devices, committee, rlc_top, scan_chunks)
    reg = _marked(psched, n_devices, committee, rlc_top, scan_chunks)
    for n in list(range(1, 1200)) + list(range(1200, 20000, 61)):
        assert reg.route(n) == refreg.route(n), n
        assert reg.bucket_capacity(n) == refreg.bucket_capacity(n), n
        assert reg.scan_shape_of(n) == refreg.scan_shape_of(n), n
        assert reg.shard_bucket_of(n) == refreg.shard_bucket_of(n), n
    assert reg.launch_cap == refreg.launch_cap
    assert reg.ladder_cap() == refreg.ladder_cap()
    assert reg.scan_capacity() == refreg.scan_capacity()
    assert reg.qc_sigs == refreg.qc_sigs
    want = refreg.snapshot()
    for key in ("buckets", "chunks", "rlc_buckets"):
        want.pop(key)       # the one-card marks, which the port has not
    assert reg.snapshot() == want
