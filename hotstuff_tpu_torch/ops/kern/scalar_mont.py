"""K2: batched Montgomery product mod L at R = 2^256 on canonical
(..., 32) int32 bytes.

``scalar_mont_mul`` launches csrc/scalar_mont.cu on a CUDA tensor and
runs ``scalar_mont_mul_plain`` on a CPU one.  Both compute the
reference's ``scalar25519.mont_mul`` byte for byte: T = a*b, m = (T mod
R) * L' mod R, U = T + m*L, U / R, one conditional subtract of L, with
the same ripple carries and the same dropped final carries.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from ...utils.intmath import L
from . import (build, check_int32, check_launch, count_launch, on_card,
                stream_of)
from .field_mul import schoolbook

NLIMBS = 32
R = 1 << 256
LPRIME = (-pow(L, -1, R)) % R      # -L^-1 mod R


def digits(x: int) -> list[int]:
    return [(x >> (8 * i)) & 0xFF for i in range(NLIMBS)]


_L_DIGITS = digits(L)
_LPRIME_DIGITS = digits(LPRIME)


def carry_bytes(x: torch.Tensor, width: int) -> torch.Tensor:
    """Exact ripple carry of non-negative int32 coefficients into
    ``width`` canonical bytes; the final carry out is dropped (callers
    size ``width`` so that it is zero)."""
    if width > x.shape[-1]:
        x = nnf.pad(x, (0, width - x.shape[-1]))
    limbs = []
    carry = torch.zeros_like(x[..., 0])
    for i in range(width):
        t = x[..., i] + carry
        limbs.append(t & 0xFF)
        carry = t >> 8
    return torch.stack(limbs, dim=-1)


def cond_sub(x: torch.Tensor, modulus: list[int]) -> torch.Tensor:
    """x - m if x >= m else x, for canonical 32-byte x and a 32-byte
    modulus given as digits (a borrow chain)."""
    limbs = []
    borrow = torch.zeros_like(x[..., 0])
    for i in range(NLIMBS):
        d = x[..., i] - modulus[i] - borrow
        borrow = (d < 0).to(torch.int32)
        limbs.append(d + (borrow << 8))
    keep = (borrow > 0).unsqueeze(-1)   # borrow out => x < m => keep x
    return torch.where(keep, x, torch.stack(limbs, dim=-1))


def _digits_tensor(values: list[int], like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32,
                        device=like.device).expand(*like.shape[:-1], NLIMBS)


def scalar_mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K2 (same-shape inputs)."""
    t = carry_bytes(schoolbook(a, b), 64)
    m = carry_bytes(
        schoolbook(t[..., :NLIMBS], _digits_tensor(_LPRIME_DIGITS, a))
        [..., :NLIMBS], NLIMBS)
    u = carry_bytes(
        nnf.pad(schoolbook(m, _digits_tensor(_L_DIGITS, a)), (0, 1)) + t, 64)
    return cond_sub(u[..., NLIMBS:], _L_DIGITS)


def scalar_mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod L for same-shape contiguous (..., 32) int32
    canonical bytes with a*b < R*L (callers broadcast first): K2 on a
    CUDA tensor, the plain version on a CPU one.  Returns bytes < L."""
    if a.shape[-1:] != (NLIMBS,):
        raise ValueError(f"scalar_mont_mul: limb axis must be {NLIMBS}, "
                         f"got shape {tuple(a.shape)}")
    check_int32("scalar_mont_mul a", a, a.shape)
    check_int32("scalar_mont_mul b", b, a.shape)
    if not on_card(a, b):
        return scalar_mont_mul_plain(a, b)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    check_launch("scalar_mont_mul", build.load().hk_scalar_mont_mul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // NLIMBS,
        stream_of(a)))
    count_launch("scalar_mont_mul")
    return out
