"""K3: the Straus MSM window accumulator.

``msm_window_accum`` launches csrc/msm_accum.cu on a CUDA tensor and
runs ``msm_window_accum_plain`` on a CPU one.  Both compute the
reference's window sums limb for limb: for each of the 64 MSB-first
nibble windows, select ``table[row, digit]`` per row, then reduce the
rows by the binary tree of ``ed25519._tree_sum`` (pts[:m] +
cached(pts[m:]), m halving) with complete additions of 8 multiplies.
The kernel cuts the tree in at most two grids: one folds each window's
B points down to ``min(B, PARTIALS)`` partial points, the other reduces
those to the window sum.
"""

from __future__ import annotations

import torch

from . import (build, check_int32, check_launch, count_launch, on_card,
                stream_of)
from .field_mul import field_mul_plain

WINDOWS = 64
PARTIALS = 64   # partial points per window between the kernel's grids


def msm_window_accum_plain(table: torch.Tensor,
                           digits: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3: every window at once, one tree
    level per step, field multiplies by K1's plain version."""
    # ed25519 imports this module for K3, so its point formulas are
    # imported here, at call time.
    from ..ed25519 import _pack, _unpack, add_t, to_cached_t

    b = table.shape[0]
    rows = torch.arange(b, device=table.device).unsqueeze(1)
    pts = table[rows, digits.long()].transpose(0, 1)       # (64, B, 4, 32)
    m = b
    while m > 1:
        m //= 2
        qc = to_cached_t(_unpack(pts[:, m:]), mul=field_mul_plain)
        pts = _pack(*add_t(_unpack(pts[:, :m]), qc, mul=field_mul_plain))
    return pts[:, 0].contiguous()


def msm_window_accum(table: torch.Tensor,
                     digits: torch.Tensor) -> torch.Tensor:
    """(64, 4, 32) int32 MSB-first window sums from a (B, 16, 4, 32)
    int32 table (entry 0 the identity) and (B, 64) int32 digits in
    [0, 16), B a power of two: K3 on a CUDA tensor, the plain version on
    a CPU one.  On the card B must be at least 2 (the RLC program's MSMs
    have 16 points or more)."""
    b = table.shape[0]
    if b < 1 or b & (b - 1):
        raise ValueError(
            f"msm_window_accum batch must be a power of two, got {b}")
    check_int32("msm_window_accum table", table, (b, 16, 4, 32))
    check_int32("msm_window_accum digits", digits, (b, WINDOWS))
    if not on_card(table, digits):
        return msm_window_accum_plain(table, digits)
    if b < 2:
        raise ValueError("msm_window_accum on the card needs at least 2 "
                         "points: a single point's window sums are its "
                         "table entries, with no tree to reduce")
    out = torch.empty((WINDOWS, 4, 32), dtype=torch.int32,
                      device=table.device)
    m = min(b, PARTIALS)
    partials = None if m == b else torch.empty(
        (WINDOWS, m, 4, 32), dtype=torch.int32, device=table.device)
    check_launch("msm_window_accum", build.load().hk_msm_window_accum(
        table.data_ptr(), digits.data_ptr(),
        None if partials is None else partials.data_ptr(), out.data_ptr(),
        b, m, stream_of(table)))
    # The entry launches the fold grid only when B > m, then the finish.
    count_launch("msm_window_accum", 1 if partials is None else 2)
    return out
