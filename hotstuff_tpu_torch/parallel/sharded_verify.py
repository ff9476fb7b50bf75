"""Ed25519 verification sharded over a mesh of cards: the port of
hotstuff_tpu/parallel/sharded_verify.py.

The JAX package runs each mesh program as one ``shard_map``: every chip
verifies its shard of the batch and the chips agree through a ``psum``
of counts and an ``all_gather`` of a few KB over ICI.  Here one process
drives the mesh (parallel/mesh.py): each shard's kernels launch under
its own device, and the collectives are copies to the lead (shard 0) on
the shard's current stream, so they are ordered after its kernels and
nothing synchronizes before ``fetch``.

Three programs, each behind the staged contract of crypto/eddsa's
``*_pack`` entries (the pack runs on the caller's thread: padding to the
shard-aligned row count and the host-to-device copies of every shard;
``dispatch()`` launches; ``fetch()`` copies the mask to the host):

  per signature   every shard runs the per-signature program on its rows
                  (shards over ``max_subbatch`` as whole chunks), masks
                  it with ``present`` and counts its bad rows; the lead
                  sums the counts;
  whole backlog   every shard runs g chunks of ``rows`` rows
                  (verify_packed_chunked) in one dispatch;
  one-MSM RLC     every shard computes its RLC partials (decompression,
                  the scalar kernels, K3's window sums); the lead sums
                  the bad counts and the scalar limb sums, gathers the
                  (n_dev, 64, 4, 32) window sums, pads them to a power
                  of two with identity points, tree-sums them and runs
                  the Horner / comb / compare tail; a failed check
                  bisects with fresh coefficients, each half re-padded
                  through the alignment rule, down to the per-signature
                  floor.

Masks equal the one-card programs' and the JAX package's row for row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.eddsa import MAX_SUBBATCH, RLC_MIN_MSM, _rlc_coeffs, \
    split_packed_rows
from ..ops import ed25519 as E
from ..utils.intmath import next_pow2
from .mesh import Mesh
from .shard_shapes import mesh_chunk_count, shard_aligned_rows, \
    shard_bucket


# ---------------------------------------------------------------------------
# Placement and collectives
# ---------------------------------------------------------------------------

def _shard_put(mesh: Mesh, arr: np.ndarray) -> list:
    """Host array whose leading axis divides by the mesh size -> one
    tensor per shard (contiguous row blocks, the batch-axis sharding),
    each copied to its shard's device: the pack stage's host-to-device
    copies."""
    per = arr.shape[0] // mesh.size
    return [torch.from_numpy(np.ascontiguousarray(arr[i * per:(i + 1) * per]))
            .to(dev) for i, dev in enumerate(mesh.devices)]


def _gather(mesh: Mesh, parts) -> torch.Tensor:
    """all_gather onto the lead: the shards' tensors stacked there."""
    return torch.stack([p.to(mesh.lead) for p in parts])


def _psum(mesh: Mesh, parts) -> torch.Tensor:
    """psum onto the lead: the shards' int32 tensors summed there."""
    return _gather(mesh, parts).sum(0, dtype=torch.int32)


def _pad_rows(arr: np.ndarray, m: int) -> np.ndarray:
    n = arr.shape[0]
    if m == n:
        return arr
    return np.pad(arr, [(0, m - n)] + [(0, 0)] * (arr.ndim - 1))


def _pack_rows_present(mesh: Mesh, prep: dict, m: int):
    """Packed rows and the present mask (host_ok: 0 for host-rejected
    rows and padding) padded to ``m`` rows and sent to the shards."""
    packed = _pad_rows(np.asarray(prep["packed"]), m)
    present = _pad_rows(prep["host_ok"].astype(np.int32), m)
    return _shard_put(mesh, packed), _shard_put(mesh, present)


def _masked(mask: torch.Tensor, present: torch.Tensor):
    """A shard's mask ANDed with ``present``, and its count of present
    rows that failed on the device."""
    live = present > 0
    mask = mask & live
    return mask, torch.sum(live & ~mask, dtype=torch.int32)


def _finish_masks(mesh: Mesh, outs):
    """Per-shard (mask, bad) -> (mask on the lead, psum'd bad count)."""
    with mesh.on("lead"):
        return (torch.cat([m.to(mesh.lead) for m, _ in outs]),
                _psum(mesh, [b for _, b in outs]))


def _mask_fetch(mask: torch.Tensor, n: int):
    return lambda: mask.cpu().numpy()[:n]


# ---------------------------------------------------------------------------
# Per signature
# ---------------------------------------------------------------------------

def _launch_per_sig(mesh: Mesh, rows: list, present: list,
                    max_subbatch: int):
    """Every shard verifies its rows (shards over ``max_subbatch`` as
    whole chunks of it, one after another); -> (mask, bad total)."""
    outs = []
    for i in range(mesh.size):
        with mesh.on(i):
            bs = rows[i].shape[0]
            if bs > max_subbatch:
                g = bs // max_subbatch
                mask = E.verify_packed_chunked(
                    rows[i].reshape(g, max_subbatch, 128)).reshape(bs)
            else:
                mask = E.verify_packed(rows[i])
            outs.append(_masked(mask, present[i]))
    return _finish_masks(mesh, outs)


def _per_sig_pack(mesh: Mesh, prep: dict, m: int, max_subbatch: int):
    n = prep["packed"].shape[0]
    rows, present = _pack_rows_present(mesh, prep, m)

    def dispatch():
        mask, _bad = _launch_per_sig(mesh, rows, present, max_subbatch)
        return _mask_fetch(mask, n)

    return dispatch


def verify_batch_sharded_pack(mesh: Mesh, prep: dict, *,
                              max_subbatch: int = MAX_SUBBATCH):
    """Pack stage of a sharded per-signature launch: the shard-aligned
    padding (shard_shapes.shard_aligned_rows) and every shard's copies
    happen here.  Returns ``dispatch() -> fetch() -> (N,) bool mask``."""
    m = shard_aligned_rows(prep["packed"].shape[0], mesh.size, max_subbatch)
    return _per_sig_pack(mesh, prep, m, max_subbatch)


def ring_slot_pack(mesh: Mesh, prep: dict, rows: int, *,
                   max_subbatch: int = MAX_SUBBATCH):
    """Pack stage of one cadence-ring slot: the sharded per-signature
    launch of :func:`verify_batch_sharded_pack` (the same ``dispatch()
    -> fetch()`` contract and masks) with the padded row count pinned to
    ``rows``, the ring's shard-aligned tick shape, instead of the batch's
    own bucket; the slack rows carry ``present`` = 0.  Each arm's tensors
    are allocated here, fresh, so a late fetch of a dropped generation
    reads its own buffers.  A batch larger than ``rows`` (the tick quota
    caps the coalesce, so only defensively) takes its own shard-aligned
    bucket."""
    m = max(int(rows), shard_aligned_rows(prep["packed"].shape[0],
                                          mesh.size, max_subbatch))
    return _per_sig_pack(mesh, prep, m, max_subbatch)


def verify_batch_sharded(mesh: Mesh, prep: dict, *, return_bad_total=False,
                         max_subbatch: int = MAX_SUBBATCH):
    """Run a host-prepared batch (crypto/eddsa.prepare_batch) across the
    mesh -> (N,) bool mask, and with ``return_bad_total`` the count of
    present rows that failed on the device (host rejections and padding
    excluded)."""
    n = prep["packed"].shape[0]
    m = shard_aligned_rows(n, mesh.size, max_subbatch)
    rows, present = _pack_rows_present(mesh, prep, m)
    mask, bad = _launch_per_sig(mesh, rows, present, max_subbatch)
    mask = mask.cpu().numpy()[:n]
    if return_bad_total:
        return mask, int(bad)
    return mask


# ---------------------------------------------------------------------------
# Whole-backlog scan: g chunks of ``rows`` rows a shard in one dispatch
# ---------------------------------------------------------------------------

def _launch_chunked(mesh: Mesh, packed: list, present: list, g: int,
                    rows: int):
    outs = []
    for i in range(mesh.size):
        with mesh.on(i):
            mask = E.verify_packed_chunked(
                packed[i].reshape(g, rows, 128)).reshape(g * rows)
            outs.append(_masked(mask, present[i]))
    return _finish_masks(mesh, outs)


def _scan_shape(mesh: Mesh, n: int, rows, max_subbatch: int):
    if rows is None:
        rows = min(shard_bucket(n, mesh.size, max_subbatch), max_subbatch)
    return mesh_chunk_count(n, mesh.size, rows), rows


def verify_sharded_chunked_pack(mesh: Mesh, prep: dict, *,
                                rows: int | None = None,
                                max_subbatch: int = MAX_SUBBATCH):
    """Pack stage of a whole-backlog mesh scan; returns ``dispatch() ->
    fetch() -> (N,) bool mask`` (the per-signature mask, batched into
    one dispatch).  ``rows`` is the per-shard chunk row count (the
    registry's ``scan_rows``; default: the batch's own per-shard bucket,
    capped at ``max_subbatch``), and g comes from
    shard_shapes.mesh_chunk_count."""
    n = prep["packed"].shape[0]
    g, rows = _scan_shape(mesh, n, rows, max_subbatch)
    packed, present = _pack_rows_present(mesh, prep, mesh.size * g * rows)

    def dispatch():
        mask, _bad = _launch_chunked(mesh, packed, present, g, rows)
        return _mask_fetch(mask, n)

    return dispatch


def verify_sharded_chunked(mesh: Mesh, prep: dict, *,
                           rows: int | None = None,
                           return_bad_total: bool = False,
                           max_subbatch: int = MAX_SUBBATCH):
    """Eager twin of :func:`verify_sharded_chunked_pack` that can also
    return the psum'd count of present rows that failed."""
    n = prep["packed"].shape[0]
    g, rows = _scan_shape(mesh, n, rows, max_subbatch)
    packed, present = _pack_rows_present(mesh, prep, mesh.size * g * rows)
    mask, bad = _launch_chunked(mesh, packed, present, g, rows)
    mask = mask.cpu().numpy()[:n]
    if return_bad_total:
        return mask, int(bad)
    return mask


# ---------------------------------------------------------------------------
# One-MSM RLC across the mesh
# ---------------------------------------------------------------------------

def gather_window_sums(mesh: Mesh, wsums) -> torch.Tensor:
    """The shards' (64, 4, 32) window sums -> (next_pow2(n_dev), 64, 4,
    32) on the lead, padded with identity points (run under
    ``mesh.on("lead")``)."""
    allw = _gather(mesh, wsums)
    n_pad = next_pow2(mesh.size)
    if n_pad != mesh.size:
        allw = torch.cat([allw, E.identity_ext(
            (n_pad - mesh.size, 64), mesh.lead)], dim=0)
    return allw


def _launch_rlc(mesh: Mesh, packed: list, z: list) -> torch.Tensor:
    """Every shard's RLC partials, combined on the lead -> () bool."""
    parts = []
    for i in range(mesh.size):
        with mesh.on(i):
            parts.append(E.rlc_partials(packed[i], z[i]))
    with mesh.on("lead"):
        bad_total = _psum(mesh, [p[2] for p in parts])
        u_total = _psum(mesh, [p[1] for p in parts])
        combined = E._tree_sum(gather_window_sums(mesh, [p[0] for p in parts]))
        return E.rlc_finish(combined, u_total, bad_total)


def _pack_rlc_rows(mesh: Mesh, packed: np.ndarray, idx: np.ndarray,
                   n: int, m: int, salt: bytes):
    """Coefficient rows (zero outside the host-canonical rows ``idx``, so
    padding and rejected rows are excluded on every shard), padding of
    ``packed[:n]`` to ``m`` rows, and the copies to the shards."""
    z = np.zeros((m, 32), np.uint8)
    if len(idx):
        z[idx] = _rlc_coeffs(np.ascontiguousarray(packed[idx]), salt)
    return _shard_put(mesh, _pad_rows(packed, m)), _shard_put(mesh, z)


def verify_rlc_sharded_pack(mesh: Mesh, prep: dict, *, salt: bytes = b"",
                            on_bisect=None):
    """Pack stage of a sharded one-MSM RLC launch; returns ``dispatch()
    -> fetch() -> (N,) bool mask``, equal to
    :func:`verify_batch_sharded`'s.  When the combined check passes the
    mask is host_ok; otherwise ``fetch`` bisects (``on_bisect`` fires
    once) down to RLC_MIN_MSM, below which the per-signature sharded
    program pinpoints each bad vote.  Fewer than RLC_MIN_MSM canonical
    rows, or a per-shard bucket past MAX_SUBBATCH, dispatch the
    per-signature sharded program instead."""
    n = prep["packed"].shape[0]
    host_ok = prep["host_ok"]
    if n == 0:
        return lambda: (lambda: np.zeros((0,), bool))
    idx = np.nonzero(host_ok)[0]
    if len(idx) < RLC_MIN_MSM or shard_bucket(n, mesh.size) > MAX_SUBBATCH:
        return verify_batch_sharded_pack(mesh, prep)
    packed = np.asarray(prep["packed"])
    dev_rows, dev_z = _pack_rlc_rows(
        mesh, packed, idx, n, shard_aligned_rows(n, mesh.size), salt)

    def dispatch():
        ok_dev = _launch_rlc(mesh, dev_rows, dev_z)

        def fetch():
            if bool(ok_dev.cpu()):
                return host_ok.copy()
            if on_bisect is not None:
                on_bisect()
            mask = np.zeros((n,), bool)
            mid = len(idx) // 2
            _rlc_sharded_resolve(mesh, packed, idx[:mid], mask, salt + b"L")
            _rlc_sharded_resolve(mesh, packed, idx[mid:], mask, salt + b"R")
            return mask

        return fetch

    return dispatch


def _rlc_sharded_resolve(mesh: Mesh, packed: np.ndarray,
                         indices: np.ndarray, out: np.ndarray,
                         salt: bytes) -> None:
    """Resolve ``out[indices]`` for host-canonical rows across the mesh:
    the combined sharded check first, bisection with fresh coefficients
    on failure, the per-signature sharded floor below RLC_MIN_MSM.  Each
    sub-batch is gathered and re-padded through the alignment rule."""
    n = len(indices)
    if n == 0:
        return
    rows = np.ascontiguousarray(packed[indices])
    if n < RLC_MIN_MSM:
        out[indices] = verify_batch_sharded_pack(
            mesh, split_packed_rows(rows))()()
        return
    dev_rows, dev_z = _pack_rlc_rows(
        mesh, rows, np.arange(n), n, shard_aligned_rows(n, mesh.size), salt)
    if bool(_launch_rlc(mesh, dev_rows, dev_z).cpu()):
        out[indices] = True
        return
    mid = n // 2
    _rlc_sharded_resolve(mesh, packed, indices[:mid], out, salt + b"L")
    _rlc_sharded_resolve(mesh, packed, indices[mid:], out, salt + b"R")


def verify_rlc_sharded(mesh: Mesh, prep: dict, *,
                       salt: bytes = b"") -> np.ndarray:
    """Run a host-prepared batch through the sharded RLC check -> (N,)
    bool mask, equal to verify_batch_sharded's (pack, dispatch and fetch
    in one call)."""
    return verify_rlc_sharded_pack(mesh, prep, salt=salt)()()
