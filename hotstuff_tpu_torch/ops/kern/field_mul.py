"""K1: batched GF(2^255 - 19) multiply on weak (..., 32) int32 limbs.

``field_mul`` launches csrc/field_mul.cu on a CUDA tensor and runs
``field_mul_plain`` on a CPU one.  Both compute the reference's
``field25519.mul`` exactly: the 32x32 schoolbook product (63
coefficients), the x38 fold of the high half, four parallel carry steps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from . import (build, check_int32, check_launch, count_launch, on_card,
                stream_of)

NLIMBS = 32


def schoolbook(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact product coefficients of same-batch limb vectors:
    (..., wa) x (..., wb) -> (..., wa + wb - 1) int32, no carrying.

    The outer product's anti-diagonals are summed by a skew: each row of
    the (wa, wb) outer product is padded to wa + wb and the whole read
    back as rows of wa + wb - 1, which shifts row i right by i.  Integer
    multiplies and adds only (no float, no matmul), so it is exact on
    both devices."""
    wa, wb = a.shape[-1], b.shape[-1]
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)            # (..., wa, wb)
    batch = outer.shape[:-2]
    w = wa + wb
    skew = nnf.pad(outer, (0, wa)).reshape(*batch, wa * w)[..., :wa * (w - 1)]
    return skew.reshape(*batch, wa, w - 1).sum(dim=-2, dtype=torch.int32)


def carry_step(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry step: every limb keeps its low byte, its high
    bits move one limb up, and limb 31's carry wraps to limb 0 times 38
    (2^256 = 38 mod p)."""
    hi = x >> 8
    return (x & 0xFF) + torch.cat([hi[..., -1:] * 38, hi[..., :-1]], dim=-1)


def field_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K1 (same-shape weak limb inputs)."""
    coeffs = schoolbook(a, b)                             # (..., 63)
    x = coeffs[..., :NLIMBS] + 38 * nnf.pad(coeffs[..., NLIMBS:], (0, 1))
    for _ in range(4):
        x = carry_step(x)
    return x


def field_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p for same-shape contiguous (..., 32) int32 weak limbs
    (callers broadcast first): K1 on a CUDA tensor, the plain version on
    a CPU one."""
    if a.shape[-1:] != (NLIMBS,):
        raise ValueError(f"field_mul: limb axis must be {NLIMBS}, "
                         f"got shape {tuple(a.shape)}")
    check_int32("field_mul a", a, a.shape)
    check_int32("field_mul b", b, a.shape)
    if not on_card(a, b):
        return field_mul_plain(a, b)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    check_launch("field_mul", build.load().hk_field_mul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // NLIMBS,
        stream_of(a)))
    count_launch("field_mul")
    return out
