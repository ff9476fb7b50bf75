"""Flat Fq12 chains in fused kernels (csrc/fq12_chain.cu, on the
Montgomery field of csrc/field381.cuh), for ops/bls381's flat Fq12
functions that mirror the JAX package's (fq12_mul, fq12_inv,
fq12_pow_const, final_exponentiate).  A pairing check runs none of them:
it is miller_accumulate and final_exp on the word tower of
fq12_tower.py.

  fq12_mul           (rows, 12, 48) x (rows, 12, 48) -> (rows, 12, 48):
                     bls381.fq12_mul, for the products outside the loops
  fq12_pow           (rows, 12, 48) -> x^e for a static exponent e: the
                     4-bit windowed loop of field381.pow_windowed over
                     Fq12 (bls381.fq12_pow_const)
  fq_pow             (rows, 48) -> x^e over Fq, the same loop (field381.inv,
                     e = q - 2), on an input first brought below 0.27 R
                     when its top limb is 224 or more (``STABLE_TOP``)

The JAX package has no Pallas kernel here: it runs the whole check as one
XLA program (hotstuff_tpu/ops/bls381.py:217 ``pairings_check_jit``).
Eager PyTorch dispatches each operator from the host, and one plain
``fq12_mul`` is ~200 operators, so a check of ~2,000 of them takes
seconds; each kernel runs its whole loop in one launch instead.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
version on a CPU one.  The plain versions are the reference's functions
on field381's plain operators, so on the card they launch no kernel, and
kernel and plain version give the reference's limbs exactly.
"""

from __future__ import annotations

import torch

from .. import field381 as F
from . import (build, check_int32, check_launch, count_launch, on_card,
                stream_of)

NLIMBS = F.NLIMBS
FQ12 = 12

# fq_pow first brings a row whose top limb is at least this back below
# 0.27 R (one Montgomery product by the Montgomery one: same residue).
# A Montgomery product of values a, b < 0.8805 R is below
# ab/R + q < 0.8805 R (q < 0.1016 R), so from a top limb below 224
# (value < 223/256 R + 0.0092 R for weak limbs) every value of the
# exponentiation stays there and every limb weak.  From a larger value
# (the Fq12 products' reduce_sum leaves values up to ~2 R) the squarings
# grow the top limb without bound: the reference's f32 products then
# lose exactness and its inverse is wrong (ROADMAP Queue C).
STABLE_TOP = 224


def fq12_one_like(x: torch.Tensor) -> torch.Tensor:
    """The Montgomery Fq12 one, broadcast to x's (..., 12, 48) shape."""
    one = F.cached("fq12_one", [F._R_MOD_Q_LIMBS] + [[0] * NLIMBS] * 11,
                   x.device)
    return one.expand(x.shape)


# ---------------------------------------------------------------------------
# Plain versions: the reference's functions, vectorised
# ---------------------------------------------------------------------------

def fq12_mul_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(..., 12, 48) x (..., 12, 48): the reference's fq12_mul.  All 144
    coefficient products, the anti-diagonal sums each through
    reduce_sum, the fold of degrees 22..12 with w^12 = 2w^6 - 2, and
    reduce_sum of the 12 results.

    The reference folds d = 22, 21, ..., 12 one at a time; step d reads
    coefficient d and updates d - 6 and d - 12, so the steps split into
    six independent chains (d mod 6) of at most two steps, and the fold
    runs as two vectorised rounds (d = 22..17, then d = 16..12) that
    apply every chain's steps in the reference's order."""
    prod = F.mont_mul(x[..., :, None, :], y[..., None, :, :])  # (.., i, j, 48)
    # coeff[k] = sum_{i+j=k} prod[i, j]: skew row i right by i (pad to 24
    # rows of j, flatten, drop 12, read as 12 x 23), then sum over i.
    lead = prod.shape[:-3]
    flat = torch.nn.functional.pad(prod, (0, 0, 0, FQ12)).reshape(
        *lead, FQ12 * 2 * FQ12, NLIMBS)
    skew = flat[..., :FQ12 * (2 * FQ12 - 1), :].reshape(
        *lead, FQ12, 2 * FQ12 - 1, NLIMBS)
    c = F.reduce_sum(skew.sum(dim=-3, dtype=torch.int32))      # (..., 23, 48)
    for top, n in ((17, 6), (12, 5)):
        c2 = F.add(c[..., top:top + n, :], c[..., top:top + n, :])
        c[..., top - 6:top - 6 + n, :] = F.add(
            c[..., top - 6:top - 6 + n, :], c2)
        c[..., top - 12:top - 12 + n, :] = F.sub(
            c[..., top - 12:top - 12 + n, :], c2)
    return F.reduce_sum(c[..., :FQ12, :])


def fq12_pow_plain(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """x^exponent over Fq12: field381.pow_windowed with fq12_mul."""
    return F.pow_windowed(x, exponent, fq12_mul_plain, fq12_one_like(x))


def fq_pow_plain(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """x^exponent over Fq: field381.pow_const, after a row whose top limb
    is at least ``STABLE_TOP`` is multiplied by the Montgomery one.  A
    row below it gets the reference's limbs exactly."""
    one = F.mont_constant(1, x.device)
    x = torch.where(x[..., -1:] >= STABLE_TOP, F.mont_mul(x, one), x)
    return F.pow_const(x, exponent)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_rows(name: str, t: torch.Tensor, tail: tuple) -> int:
    if t.dim() != 1 + len(tail) or tuple(t.shape[1:]) != tail:
        raise ValueError(f"{name}: expected (rows, "
                         f"{', '.join(map(str, tail))}), got "
                         f"{tuple(t.shape)}")
    check_int32(name, t, t.shape)
    return t.shape[0]


def _digits(exponent: int, device) -> torch.Tensor:
    if exponent < 0:
        raise ValueError("exponent must be nonnegative")
    return F.cached(("digits", exponent), F.exponent_digits(exponent),
                    device)


def fq12_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(rows, 12, 48) int32 Montgomery Fq12 x the same -> their product:
    the kernel on a CUDA tensor, the plain version on a CPU one."""
    rows = _check_rows("fq12_mul x", x, (FQ12, NLIMBS))
    check_int32("fq12_mul y", y, x.shape)
    if not on_card(x, y):
        return fq12_mul_plain(x, y)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    check_launch("fq12_mul", build.load().hk_fq12_mul(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), rows, stream_of(x)))
    count_launch("fq12_mul")
    return out


def fq12_pow(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """(rows, 12, 48) int32 Montgomery Fq12 -> x^exponent for a static
    exponent: the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    rows = _check_rows("fq12_pow x", x, (FQ12, NLIMBS))
    digits = _digits(exponent, x.device)
    if not on_card(x):
        return fq12_pow_plain(x, exponent)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    check_launch("fq12_pow", build.load().hk_fq12_pow(
        x.data_ptr(), digits.data_ptr(), out.data_ptr(), rows,
        digits.numel(), stream_of(x)))
    count_launch("fq12_pow")
    return out


def fq_pow(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """(..., 48) int32 Montgomery Fq -> x^exponent for a static exponent:
    the kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.dim() < 1 or x.shape[-1] != NLIMBS:
        raise ValueError(f"fq_pow: expected (..., {NLIMBS}), got "
                         f"{tuple(x.shape)}")
    digits = _digits(exponent, x.device)
    if not on_card(x):
        return fq_pow_plain(x, exponent)
    flat = x.reshape(-1, NLIMBS).contiguous()
    check_int32("fq_pow x", flat, flat.shape)
    out = torch.empty_like(flat)
    if flat.shape[0] == 0:
        return out.reshape(x.shape)
    check_launch("fq_pow", build.load().hk_fq_pow(
        flat.data_ptr(), digits.data_ptr(), out.data_ptr(), flat.shape[0],
        digits.numel(), stream_of(x)))
    count_launch("fq_pow")
    return out.reshape(x.shape)
