"""BLS12-381 pairing verification on the card: the port of
hotstuff_tpu/ops/bls381.py, name for name.

Work split (the reference's host/device boundary):
* HOST (python bigints, offchain/bls12381.py): point decode and
  validation, hash-to-G2, public-key aggregation, and the Miller loop's
  line values (``miller_lines``).
* DEVICE: the Miller accumulation f <- f^2 l_i over the 63 BLS_X bits
  and the final exponentiation of the Miller values' product, on the
  Fq12 tower over 32-bit words (ops/kern/fq12_tower.py), whose outputs
  are canonical limbs: a pairing check is two launches,
  miller_accumulate and final_exp.

An Fq12 element is a (..., 12, 48) int32 tensor: a flat degree-12
polynomial over Fq (modulus w^12 - 2w^6 + 2, as in the host reference)
with Montgomery-form coefficient limbs.  Frobenius maps are precomputed
12x12 Fq matrices.

Routing follows the tensors: on a CUDA tensor ``pairings_check`` and
``miller_accumulate`` launch the kernels of ops/kern/fq12_tower.py; on a
CPU tensor they run those kernels' plain versions.  The flat Fq12
functions that mirror the JAX package's (``fq12_mul``, ``fq12_inv``,
``fq12_frobenius``, ``fq12_pow_const``, ``final_exponentiate``,
``is_one``) keep its meaning and stay off the check's path: they launch
ops/kern/fq12_chain.py's kernels (and fq12_hard_pow) on a CUDA tensor,
with plain PyTorch operators for the Frobenius maps, fq12_inv's last Fq
product and ``is_one``, as the JAX package computes them with jnp.
There is no fallback: a kernel that fails raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field381 as F
from .kern import fq12_chain as K
from .kern import fq12_tower as T
from ..offchain import bls12381 as host
from ..utils.device import resolve

Q = host.Q
BLS_X = host.BLS_X

# Miller schedule: per bit of BLS_X (after the leading 1), a doubling line
# and, on set bits, an addition line.
_BITS = [int(b) for b in bin(BLS_X)[3:]]
N_STEPS = len(_BITS)


# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------

def host_fq12_to_mont_limbs(x) -> np.ndarray:
    """Host Fq12 tuple (12 ints) -> (12, 48) Montgomery limb array."""
    return np.stack([F.to_limbs(c * F.R % Q) for c in x])


def miller_lines(p_g1, q_g2) -> np.ndarray:
    """Run the host Miller loop recording line values: (N_STEPS, 2, 12, 48)
    Montgomery limbs.  Slot 0 is the doubling line, slot 1 the addition
    line (identity 1 on clear bits so the device body is uniform).

    The reference walks the loop on the twisted point in Fq12, with an
    Fq12 inversion in each line and each point step.  Here the loop
    runs on the twist in Fq2 (``line_coeffs``, which depends on Q only)
    and each line is then evaluated at P (``lines_at``): the same field
    elements, so the same limbs (a departure of the code, not of the
    result)."""
    return lines_at(line_coeffs(q_g2), p_g1)


# The twist (offchain/bls12381._twist) sends (x, y) over Fq2 to
# (e(x) w^-2, e(y) w^-3), where e(a0 + a1 u) = (a0 - a1) + a1 w^6 is a
# field embedding of Fq2 into Fq12 (e(u)^2 = -1).  A line through twisted
# points with slope m = e(lam) w^-1 (lam the slope on the twist), taken
# at P = (xP, yP) in Fq, is
#     l = xP e(lam) w^-1 + e(y1 - lam x1) w^-3 - yP,
# and a vertical one l = xP - e(x1) w^-2.  _EMBED[k][j] is the Fq12
# element e(u^j) w^-k in Montgomery form (times R mod q).
def _embed_consts():
    w = tuple(1 if i == 1 else 0 for i in range(12))
    w_inv = host.fq12_inv(w)
    out = {}
    for k in (1, 2, 3):
        wk = host.FQ12_ONE
        for _ in range(k):
            wk = host.fq12_mul(wk, w_inv)
        out[k] = []
        for e in (host.FQ12_ONE,
                  tuple(Q - 1 if i == 0 else (1 if i == 6 else 0)
                        for i in range(12))):
            out[k].append(tuple(c * F.R % Q
                                for c in host.fq12_mul(e, wk)))
    return out


_EMBED = _embed_consts()
_ONE_MONT = b"".join((F.R_MOD_Q if i == 0 else 0).to_bytes(48, "little")
                     for i in range(12))


def _line_step(p1, p2):
    """The line through p1 and p2 on the twist (tangent when equal) and
    their sum, as offchain/bls12381._linefunc and _add take them in
    Fq12: ``((0, lam, y1 - lam x1), p1 + p2)``, or ``((1, x1, None),
    None)`` for a vertical line."""
    x1, y1 = p1
    x2, y2 = p2
    if x1 != x2:
        lam = host.fq2_mul(host.fq2_sub(y2, y1),
                           host.fq2_inv(host.fq2_sub(x2, x1)))
    elif y1 == y2:
        lam = host.fq2_mul(host._fq2.scalar(host.fq2_mul(x1, x1), 3),
                           host.fq2_inv(host._fq2.scalar(y1, 2)))
    else:
        return (1, x1, None), None
    nu = host.fq2_sub(y1, host.fq2_mul(lam, x1))
    nx = host.fq2_sub(host.fq2_sub(host.fq2_mul(lam, lam), x1), x2)
    ny = host.fq2_sub(host.fq2_mul(lam, host.fq2_sub(x1, nx)), y1)
    return (0, lam, nu), (nx, ny)


def line_coeffs(q_g2) -> list:
    """The Miller loop's lines for Q, before P: 2 x N_STEPS slots in
    ``miller_lines``' order, each ``_line_step``'s line or None (the
    addition slot of a clear bit, the identity)."""
    rpt = q_g2
    out = []
    for bit in _BITS:
        line, rpt = _line_step(rpt, rpt)
        out.append(line)
        if bit:
            line, rpt = _line_step(rpt, q_g2)
            out.append(line)
        else:
            out.append(None)
    return out


def lines_at(coeffs, p_g1) -> np.ndarray:
    """``line_coeffs``' lines evaluated at the G1 point P: the (N_STEPS,
    2, 12, 48) Montgomery limbs of ``miller_lines``."""
    xp, yp = p_g1
    yp_r = yp * F.R % Q
    xp_r = xp * F.R % Q
    e1, e2, e3 = _EMBED[1], _EMBED[2], _EMBED[3]
    out = bytearray()
    for line in coeffs:
        if line is None:
            out += _ONE_MONT
            continue
        kind, a, b = line
        if kind == 0:
            for k in range(12):
                v = xp * (a[0] * e1[0][k] + a[1] * e1[1][k]) \
                    + b[0] * e3[0][k] + b[1] * e3[1][k]
                if k == 0:
                    v -= yp_r
                out += (v % Q).to_bytes(48, "little")
        else:
            for k in range(12):
                v = -(a[0] * e2[0][k] + a[1] * e2[1][k])
                if k == 0:
                    v += xp_r
                out += (v % Q).to_bytes(48, "little")
    return np.frombuffer(bytes(out), np.uint8).astype(np.int32).reshape(
        N_STEPS, 2, 12, F.NLIMBS)


# Frobenius matrices: FROB[k][i] = (w^i)^(q^k) as a host Fq12 element, so
# f^(q^k) = sum_i f_i * FROB[k][i] (coefficients of Fq are Frobenius-fixed).
def _frob_matrices():
    w = tuple(1 if i == 1 else 0 for i in range(12))
    w_q = host.fq12_pow(w, Q)  # one 381-bit host exponentiation
    mats = {}
    basis = [w]
    for i in range(2, 12):
        basis.append(host.fq12_mul(basis[-1], w))
    basis = [tuple(1 if j == 0 else 0 for j in range(12))] + basis  # w^0..w^11

    def apply_frob(x, wq_pows):
        acc = tuple(0 for _ in range(12))
        for i, c in enumerate(x):
            if c:
                acc = host.fq12_add(acc, host.fq12_scalar(wq_pows[i], c))
        return acc

    wq_pows = [tuple(1 if j == 0 else 0 for j in range(12))]
    for i in range(1, 12):
        wq_pows.append(host.fq12_mul(wq_pows[-1], w_q))

    cur = basis
    for k in range(1, 12):
        cur = [apply_frob(b, wq_pows) for b in cur]
        mats[k] = np.stack([host_fq12_to_mont_limbs(row) for row in cur])
    return mats  # mats[k]: (12, 12, 48) -- row i = (w^i)^(q^k)


_FROB = _frob_matrices()

# Final-exponentiation hard part: (q^4 - q^2 + 1) / r.
_HARD_EXP = (Q ** 4 - Q ** 2 + 1) // host.R
assert (Q ** 12 - 1) % host.R == 0
assert (Q ** 6 - 1) * (Q ** 2 + 1) * _HARD_EXP == (Q ** 12 - 1) // host.R
assert _HARD_EXP == T.HARD_EXP


# ---------------------------------------------------------------------------
# Fq12 arithmetic
# ---------------------------------------------------------------------------

def fq12_one(batch_shape=(), device="cpu") -> torch.Tensor:
    one = torch.zeros((12, F.NLIMBS), dtype=torch.int32, device=device)
    return K.fq12_one_like(one).expand(*batch_shape, 12, F.NLIMBS)


def _rows(fn, *xs: torch.Tensor) -> torch.Tensor:
    """Run a (rows, 12, 48) chain op on (..., 12, 48) operands that
    broadcast against each other."""
    xs = torch.broadcast_tensors(*xs)
    lead = xs[0].shape[:-2]
    out = fn(*(x.reshape(-1, 12, F.NLIMBS).contiguous() for x in xs))
    return out.reshape(*lead, 12, F.NLIMBS)


def fq12_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(..., 12, 48) x (..., 12, 48): all 144 coefficient products,
    anti-diagonal accumulation, the w^12 = 2w^6 - 2 fold
    (fq12_chain.fq12_mul: the kernel on the card)."""
    return _rows(K.fq12_mul, x, y)


def fq12_sqr(x: torch.Tensor) -> torch.Tensor:
    return fq12_mul(x, x)


def _frobenius(x: torch.Tensor, ks) -> torch.Tensor:
    """f^(q^k) for each k of ``ks`` at once: (len(ks), ..., 12, 48)."""
    mat = F.cached(("frob", tuple(ks)), np.stack([_FROB[k] for k in ks]),
                   x.device)                            # (K, 12i, 12j, 48)
    mat = mat.reshape(len(ks), *([1] * (x.dim() - 2)), 12, 12, F.NLIMBS)
    prod = F.mont_mul(x[..., :, None, :], mat)          # (K, ..., i, j, 48)
    return F.reduce_sum(prod.sum(dim=-3, dtype=torch.int32))


def fq12_frobenius(x: torch.Tensor, k: int) -> torch.Tensor:
    """f^(q^k) via the precomputed basis-image matrix (plain operators)."""
    return _frobenius(x, (k,))[0]


def fq12_inv(x: torch.Tensor) -> torch.Tensor:
    """Field-norm inversion: g = prod_{k=1..11} f^(q^k); N = f*g lies in
    Fq (its 0-coefficient), so f^{-1} = g * N^{-1}.  The 11 Frobenius
    maps are independent, so they run as one batch of plain operators
    (elementwise ops: the same limbs as one at a time)."""
    frobs = _frobenius(x, range(1, 12))
    g = frobs[0]
    for k in range(2, 12):
        g = fq12_mul(g, frobs[k - 1])
    n = fq12_mul(x, g)
    n0_inv = F.inv(n[..., 0, :])
    return F.mont_mul(g, n0_inv[..., None, :])


def fq12_pow_const(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """x^exponent, static exponent: field381.pow_windowed over Fq12 with
    a 4-bit window (fq12_chain.fq12_pow: the kernel on the card)."""
    return _rows(lambda r: K.fq12_pow(r, exponent), x)


# ---------------------------------------------------------------------------
# Pairing pieces
# ---------------------------------------------------------------------------

def miller_accumulate(lines: torch.Tensor) -> torch.Tensor:
    """lines (..., N_STEPS, 2, 12, 48) -> Miller value (without the BLS_X
    sign conjugation -- it cancels in the == 1 check after final exp), in
    canonical limbs (fq12_tower.miller_accumulate: the kernel on the
    card)."""
    lead = lines.shape[:-4]
    flat = lines.reshape(-1, *lines.shape[-4:]).contiguous()
    return T.miller_accumulate(flat).reshape(*lead, 12, F.NLIMBS)


def final_exponentiate(f: torch.Tensor) -> torch.Tensor:
    """f^((q^12-1)/r): easy part via Frobenius + norm-inversion, hard part
    f2^((q^4 - q^2 + 1)/r) as the exact chain in x of
    fq12_tower.fq12_hard_pow (the kernel on the card; f2 is in the
    cyclotomic subgroup, where that chain is the power).  The result is
    in canonical limbs."""
    f1 = fq12_mul(fq12_frobenius(f, 6), fq12_inv(f))      # f^(q^6 - 1)
    f2 = fq12_mul(fq12_frobenius(f1, 2), f1)              # ^(q^2 + 1)
    return _rows(T.fq12_hard_pow, f2)


def is_one(f: torch.Tensor) -> torch.Tensor:
    """(..., 12, 48) Montgomery Fq12 -> (...,) bool: f == 1."""
    canon = F.from_mont(f)
    one = torch.zeros_like(canon)
    one[..., 0, 0] = 1
    return torch.all(torch.all(canon == one, dim=-1), dim=-1)


def pairings_check(lines: torch.Tensor) -> torch.Tensor:
    """lines (..., P, N_STEPS, 2, 12, 48): P pairings multiplied under ONE
    final exponentiation -> (...,) bool (product == 1): the Miller values
    (fq12_tower.miller_accumulate), then their product's final
    exponentiation and the test for one (fq12_tower.final_exp)."""
    lead, p = lines.shape[:-5], lines.shape[-5]
    fs = miller_accumulate(lines)                        # (..., P, 12, 48)
    ok, _ = T.final_exp(fs.reshape(-1, p, 12, F.NLIMBS))
    return ok.reshape(lead)


def selfcheck(device=None) -> None:
    """The BLS path's exactness check at boot (the sidecar's BLS
    warm-up, the off-chain bench): ``field381.mul_selfcheck``, then one
    ``fq12_mul`` (the fq12_chain kernel on the card) on the JAX
    package's seed-17 inputs against the host bigints' product.  Raises
    AssertionError on any mismatch."""
    dev = resolve(device)
    F.mul_selfcheck(device=dev)
    rng = np.random.default_rng(17)
    x = tuple(int.from_bytes(rng.bytes(48), "little") % Q for _ in range(12))
    y = tuple(int.from_bytes(rng.bytes(48), "little") % Q for _ in range(12))
    dx = torch.from_numpy(host_fq12_to_mont_limbs(x))[None].to(dev)
    dy = torch.from_numpy(host_fq12_to_mont_limbs(y))[None].to(dev)
    got = F.from_mont(fq12_mul(dx, dy)).cpu().numpy()[0]
    if tuple(F.from_limbs(r) for r in got) != host.fq12_mul(x, y):
        raise AssertionError(f"fq12 multiply is not exact on {dev}")


# ---------------------------------------------------------------------------
# Aggregate verification (host preparation + device check)
# ---------------------------------------------------------------------------

def _check(rows, device) -> bool:
    lines = torch.from_numpy(np.stack(rows)).to(resolve(device))
    return bool(pairings_check(lines).item())


def verify_aggregate_common(pks, msg: bytes, agg_sig, device=None) -> bool:
    """Same-message aggregate verify (the QC shape: 2f+1 votes on one
    digest): e(apk, H(m)) * e(-g1, agg_sig) == 1, pairing math on the
    device.  pks: list of host G1 points; agg_sig: host G2 point."""
    dev = resolve(device)
    # Same input validation as the host reference: a malformed signature
    # must reject, not crash the Miller-line precomputation.
    if agg_sig is None or not host.g2_on_curve(agg_sig):
        return False
    apk = None
    for pk in pks:
        if pk is None or not host.g1_on_curve(pk):
            return False
        apk = pk if apk is None else host.g1_add(apk, pk)
    if apk is None:
        return False
    h = host.hash_to_g2(msg)
    neg_g1 = host.g1_neg(host.g1_generator())
    return _check([miller_lines(apk, h), miller_lines(neg_g1, agg_sig)], dev)


def multi_pairing_rows(pks, msgs, agg_sig):
    """Validate a distinct-message aggregate statement and build its n+1
    Miller-line rows (votes + the -g1/agg row).  Returns None if any
    input is malformed."""
    if len(pks) != len(msgs) or not pks:
        return None
    if agg_sig is None or not host.g2_on_curve(agg_sig):
        return None
    rows = []
    for pk, msg in zip(pks, msgs):
        if pk is None or not host.g1_on_curve(pk):
            return None
        rows.append(miller_lines(pk, host.hash_to_g2(msg)))
    rows.append(miller_lines(host.g1_neg(host.g1_generator()), agg_sig))
    return rows


def verify_aggregate_multi(pks, msgs, agg_sig, device=None) -> bool:
    """Distinct-message aggregate verify (the TC shape: 2f+1 timeout votes
    over per-round digests): prod e(pk_i, H(m_i)) * e(-g1, agg) == 1, all
    n+1 Miller loops in one launch under ONE final exponentiation on the
    device.  No shape needs warming: every vote count runs the same
    kernels."""
    dev = resolve(device)
    rows = multi_pairing_rows(pks, msgs, agg_sig)
    if rows is None:
        return False
    return _check(rows, dev)
