"""K1 redesigned for the card: the field multiply runs inside three fused
point-chain kernels (csrc/point_chain.cu), one launch per chain.

  point_ladder     acc <- [2^ndbl] acc + table[digit] over S steps from
                   the identity: the per-signature ladder, both combs and
                   Horner (ed25519.verify_prepared, comb_mul_base,
                   msm_horner), on csrc/field25519_lanes.cuh: four
                   8-lane groups of one warp run each formula phase's
                   four independent multiplies at once, a lane holding
                   4 limbs
  decompress       the whole of ed25519.decompress_t, on
                   csrc/field25519_lanes.cuh too: one row a group of 8
                   lanes, four rows a warp, with a dedicated squaring
  point_multiples  the 16-entry table 0P..15P, extended (msm_table) or
                   cached (the per-signature ladder's table of -A), on
                   csrc/field25519_lanes.cuh too: point_ladder's four
                   lane groups a warp, one row a warp

Each wrapper launches its kernel on a CUDA tensor and runs its plain
version on a CPU one.  The plain versions are the reference's loops
with K1's plain multiply, so on the card they launch no kernel.  Kernel
and plain version keep the reference's op order and carry schedule, so
both give its limbs exactly.
"""

from __future__ import annotations

import torch

from . import (build, check_int32, check_launch, count_launch, on_card,
                stream_of)
from .field_mul import field_mul_plain

NLIMBS = 32
MULTIPLES = 16
LADDER_NDBL = (0, 4)   # the combs; the per-signature ladder and Horner


def _check_points(name: str, t: torch.Tensor, lead: int) -> None:
    if t.dim() != lead + 2 or tuple(t.shape[-2:]) != (4, NLIMBS):
        raise ValueError(f"{name}: expected (..., 4, {NLIMBS}) points with "
                         f"{lead} leading axes, got {tuple(t.shape)}")
    check_int32(name, t, t.shape)


# ---------------------------------------------------------------------------
# point_ladder
# ---------------------------------------------------------------------------

def point_ladder_plain(table: torch.Tensor, digits: torch.Tensor,
                       ndbl: int) -> torch.Tensor:
    """The plain PyTorch version of point_ladder: the reference's loop."""
    # ed25519 imports this module, so its formulas are imported here.
    from ..ed25519 import _pack, _unpack, add_t, dbl_t, identity_t

    b, steps = digits.shape
    rows = torch.arange(b, device=table.device)
    trow = rows if table.shape[0] != 1 else torch.zeros_like(rows)
    acc = identity_t((b,), table.device)
    for s in range(steps):
        if ndbl:
            for _ in range(ndbl - 1):
                acc = dbl_t(acc, with_t=False, mul=field_mul_plain)
            acc = dbl_t(acc, mul=field_mul_plain)  # the add reads T
        entry = table[trow, s if table.shape[1] != 1 else 0,
                      digits[:, s].long()]
        acc = add_t(acc, _unpack(entry), mul=field_mul_plain)
    return _pack(*acc)


def point_ladder(table: torch.Tensor, digits: torch.Tensor,
                 ndbl: int) -> torch.Tensor:
    """(B, 4, 32) int32 extended points: from the identity, S steps of
    ``ndbl`` (0 or 4) doublings, the last one with T, and one addition
    of the cached point ``table[b, s, digits[b, s]]``.

    ``table`` is (Bt, J, K, 4, 32) int32 cached points: Bt 1 (one table
    for every row) or B (one per row), J 1 (one table for every step)
    or S (one per step); ``digits`` is (B, S) int32 in [0, K).  The
    kernel on a CUDA tensor, the plain version on a CPU one."""
    _check_points("point_ladder table", table, 3)
    check_int32("point_ladder digits", digits, digits.shape)
    if digits.dim() != 2:
        raise ValueError(f"point_ladder digits must be (B, S), got "
                         f"{tuple(digits.shape)}")
    bt, j, k = table.shape[:3]
    b, steps = digits.shape
    if bt not in (1, b) or j not in (1, steps) or k < 1:
        raise ValueError(f"point_ladder table {tuple(table.shape)} does not "
                         f"fit digits {tuple(digits.shape)}")
    if ndbl not in LADDER_NDBL:
        raise ValueError(f"point_ladder ndbl must be one of {LADDER_NDBL}, "
                         f"got {ndbl}")
    if not on_card(table, digits):
        return point_ladder_plain(table, digits, ndbl)
    if table.data_ptr() % 16:
        raise ValueError("point_ladder table must be 16-byte aligned")
    out = torch.empty((b, 4, NLIMBS), dtype=torch.int32, device=table.device)
    if b == 0:
        return out
    check_launch("point_ladder", build.load().hk_point_ladder(
        table.data_ptr(), digits.data_ptr(), out.data_ptr(), b, steps, k,
        int(bt != 1), int(j != 1), ndbl, stream_of(table)))
    count_launch("point_ladder")
    return out


# ---------------------------------------------------------------------------
# decompress
# ---------------------------------------------------------------------------

def decompress_plain(y_limbs: torch.Tensor, sign_bit: torch.Tensor):
    """The plain PyTorch version of decompress: ed25519.decompress_t."""
    from ..ed25519 import _pack, decompress_t

    pt, ok = decompress_t(y_limbs, sign_bit, mul=field_mul_plain)
    return _pack(*pt), ok


def decompress(y_limbs: torch.Tensor, sign_bit: torch.Tensor):
    """(B, 32) int32 y limbs + (B,) int32 sign bits -> ((B, 4, 32) int32
    extended points, (B,) bool ok): RFC 8032 x-recovery in one launch on
    a CUDA tensor, the plain version on a CPU one."""
    if y_limbs.dim() != 2 or y_limbs.shape[1] != NLIMBS:
        raise ValueError(f"decompress: y limbs must be (B, {NLIMBS}), got "
                         f"{tuple(y_limbs.shape)}")
    check_int32("decompress y", y_limbs, y_limbs.shape)
    check_int32("decompress sign", sign_bit, y_limbs.shape[:1])
    if not on_card(y_limbs, sign_bit):
        return decompress_plain(y_limbs, sign_bit)
    b = y_limbs.shape[0]
    out = torch.empty((b, 4, NLIMBS), dtype=torch.int32,
                      device=y_limbs.device)
    ok = torch.empty((b,), dtype=torch.bool, device=y_limbs.device)
    if b == 0:
        return out, ok
    check_launch("decompress", build.load().hk_decompress(
        y_limbs.data_ptr(), sign_bit.data_ptr(), out.data_ptr(),
        ok.data_ptr(), b, stream_of(y_limbs)))
    count_launch("decompress")
    return out, ok


# ---------------------------------------------------------------------------
# point_multiples
# ---------------------------------------------------------------------------

def point_multiples_plain(points: torch.Tensor, cached: bool,
                          negate: bool) -> torch.Tensor:
    """The plain PyTorch version of point_multiples: the reference's
    table loop."""
    from .. import field25519 as F
    from ..ed25519 import _pack, _unpack, add_t, identity_t, to_cached_t

    x, y, z, t = _unpack(points)
    p = (F.neg(x), y, z, F.neg(t)) if negate else (x, y, z, t)
    pc = to_cached_t(p, mul=field_mul_plain)
    entries = [identity_t(points.shape[:-2], points.device), p]
    for _ in range(2, MULTIPLES):
        entries.append(add_t(entries[-1], pc, mul=field_mul_plain))
    if cached:
        entries = [to_cached_t(e, mul=field_mul_plain) for e in entries]
    return torch.stack([_pack(*e) for e in entries], dim=-3)


def point_multiples(points: torch.Tensor, cached: bool = False,
                    negate: bool = False) -> torch.Tensor:
    """(B, 4, 32) int32 extended points P -> (B, 16, 4, 32) int32 table
    of 0P..15P, entry i = entry i-1 + cached(P) from entry 1 = P;
    extended, or cached with ``cached``; built from -P with ``negate``.
    The kernel on a CUDA tensor, the plain version on a CPU one."""
    _check_points("point_multiples points", points, 1)
    if not on_card(points):
        return point_multiples_plain(points, cached, negate)
    b = points.shape[0]
    out = torch.empty((b, MULTIPLES, 4, NLIMBS), dtype=torch.int32,
                      device=points.device)
    if b == 0:
        return out
    check_launch("point_multiples", build.load().hk_point_multiples(
        points.data_ptr(), out.data_ptr(), b, int(cached), int(negate),
        stream_of(points)))
    count_launch("point_multiples")
    return out
