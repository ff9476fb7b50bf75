"""K2 redesigned for the card: the RLC program's scalar work mod L in two
fused kernels (csrc/scalar_rlc.cu).

  rlc_scalars  (z, k, S) rows -> the MSM digits of [w_lift; z_lift] and
               u = z S mod L: both mul_mod_l products, the torsion lifts
               and the nibble split of ed25519.rlc_partials
  rlc_reduce   (..., 32) limb sums -> canonical value mod L:
               scalar25519.reduce_limbsum_mod_l, for rlc_finish

Each wrapper launches its kernel on a CUDA tensor and runs its plain
version on a CPU one.  The plain versions compose K2's plain Montgomery
product with the reference's byte ripples, so on the card they launch
no kernel, and both routes give the reference's bytes exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from ...utils.intmath import L
from . import (build, check_int32, check_launch, count_launch, on_card,
                stream_of)
from .scalar_mont import NLIMBS, R, carry_bytes, cond_sub, digits
from .scalar_mont import scalar_mont_mul_plain

R2 = (R * R) % L
MOD_SMALL = (8 * L, 4 * L, 2 * L, L)   # reduces a value < 2^256 (< 16L)


def _const(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(digits(value), dtype=torch.int32,
                        device=like.device).expand(*like.shape[:-1], NLIMBS)


def _mul_mod_l_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return scalar_mont_mul_plain(scalar_mont_mul_plain(a, b), _const(R2, a))


def _lift(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return carry_bytes(x + t.unsqueeze(-1) * _const(L, x), NLIMBS)


def rlc_scalars_plain(z: torch.Tensor, k: torch.Tensor,
                      s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of rlc_scalars: the reference's
    rlc_partials scalar steps with K2's plain Montgomery product."""
    # ed25519 imports this module, so its nibble split is imported here.
    from ..ed25519 import unpack_nibbles_msb

    w = _mul_mod_l_plain(z, k)          # z_i * k_i mod L  (A_i scalars)
    u = _mul_mod_l_plain(z, s)          # z_i * S_i mod L
    present = torch.any(z != 0, dim=-1).to(torch.int32)
    t_w = (5 * ((k[..., 0] & 7) - (w[..., 0] & 7))) % 8 * present
    t_z = (5 * (1 - (z[..., 0] & 7))) % 8 * present
    lifted = torch.cat([_lift(w, t_w), _lift(z, t_z)], dim=0)
    return unpack_nibbles_msb(lifted), u


def rlc_scalars(z: torch.Tensor, k: torch.Tensor,
                s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-row scalar work of the RLC check, from (B, 32) int32
    canonical bytes of the coefficients z, the challenges k and S:

      digits (2B, 64) int32  MSB-first nibbles of [w_lift; z_lift], where
                             w = z k mod L lifted to w' = w (mod L), w' =
                             k (mod 8), and z lifted to z' = 1 (mod 8);
                             an all-zero z row keeps scalar 0 in both
      u      (B, 32) int32   canonical bytes of z S mod L

    One launch on a CUDA tensor, the plain version on a CPU one."""
    b = z.shape[0]
    for name, t in (("z", z), ("k", k), ("s", s)):
        check_int32(f"rlc_scalars {name}", t, (b, NLIMBS))
    if not on_card(z, k, s):
        return rlc_scalars_plain(z, k, s)
    out_digits = torch.empty((2 * b, 64), dtype=torch.int32, device=z.device)
    u = torch.empty((b, NLIMBS), dtype=torch.int32, device=z.device)
    if b == 0:
        return out_digits, u
    check_launch("rlc_scalars", build.load().hk_rlc_scalars(
        z.data_ptr(), k.data_ptr(), s.data_ptr(), out_digits.data_ptr(),
        u.data_ptr(), b, stream_of(z)))
    count_launch("rlc_scalars")
    return out_digits, u


def rlc_reduce_plain(sums: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of rlc_reduce: the reference's
    reduce_limbsum_mod_l with K2's plain Montgomery product."""
    wide = carry_bytes(sums, 36)
    lo = wide[..., :NLIMBS]
    hi = nnf.pad(wide[..., NLIMBS:], (0, NLIMBS - 4))
    hi = scalar_mont_mul_plain(hi, _const(R2, hi))     # hi * 2^256 mod L
    for m in MOD_SMALL:
        lo = cond_sub(lo, digits(m))
    return cond_sub(carry_bytes(hi + lo, NLIMBS), digits(L))


def rlc_reduce(sums: torch.Tensor) -> torch.Tensor:
    """(..., 32) int32 limb-wise sums of canonical scalars (limbs in [0,
    2^24)) -> (..., 32) int32 canonical bytes of their value mod L.  One
    launch on a CUDA tensor, the plain version on a CPU one."""
    if sums.dim() < 1 or sums.shape[-1] != NLIMBS:
        raise ValueError(f"rlc_reduce: limb axis must be {NLIMBS}, got "
                         f"shape {tuple(sums.shape)}")
    check_int32("rlc_reduce sums", sums, sums.shape)
    if not on_card(sums):
        return rlc_reduce_plain(sums)
    out = torch.empty_like(sums)
    if out.numel() == 0:
        return out
    check_launch("rlc_reduce", build.load().hk_rlc_reduce(
        sums.data_ptr(), out.data_ptr(), sums.numel() // NLIMBS,
        stream_of(sums)))
    count_launch("rlc_reduce")
    return out
