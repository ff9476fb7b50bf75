"""GF(q) arithmetic for BLS12-381, batched, in PyTorch: the port of
hotstuff_tpu/ops/field381.py, the base layer of the pairing check
(ops/bls381.py).

Elements live in Montgomery form x~ = x * R mod q, R = 2^384, as
(..., 48) int32 radix-2^8 limbs in weak form (limbs < ~2^9, value
< ~2^385; the representation of a residue is not unique).  Every op
keeps the reference's carry schedule -- the step counts 3 / 3 / 3 / 1 in
``mont_mul`` and 3 / 2 / 1 in ``reduce_sum``, the top limb's overflow
kept in place by ``weak_carry`` and dropped by ``trunc_carry`` -- so the
limbs equal the JAX package's limb for limb, not only modulo q.

The arithmetic is exact integer arithmetic throughout.  The reference's
f32 grouped convolution becomes an int32 schoolbook (``_schoolbook``;
every coefficient is below 2^24), and its f32 recovery of the low
half's carry-out in ``mont_mul`` becomes an exact int64 ceiling over the
top four low limbs (``_low_carry``).  ``from_mont``'s sequential ripple
and conditional subtract become carry-lookahead passes, which give the
same canonical bytes (canonical digits of an exact value are unique).

These functions are the plain PyTorch versions: on a CUDA tensor they
run as PyTorch operators, and the Fq12 chains built on them go to the
kernels of ops/kern/fq12_chain.py.  ``inv`` routes: the ``fq_pow``
kernel on a CUDA tensor, its plain version on a CPU one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

NLIMBS = 48
LIMB_BITS = 8
LIMB_MASK = 255

Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 1 << 384
R_MOD_Q = R % Q
R2_MOD_Q = R * R % Q
# q' = -q^{-1} mod R (Montgomery constant)
QPRIME = (-pow(Q, -1, R)) % R


def to_limbs(x: int, n: int = NLIMBS) -> np.ndarray:
    return np.array([(int(x) >> (8 * i)) & 0xFF for i in range(n)],
                    dtype=np.int32)


def from_limbs(limbs) -> int:
    limbs = np.asarray(limbs, dtype=np.int64).reshape(-1)
    return sum(int(v) << (8 * i) for i, v in enumerate(limbs))


_Q_LIMBS = to_limbs(Q)
_QPRIME_LIMBS = to_limbs(QPRIME)
# 64q bias for subtraction: every limb dominates a weak limb (< 2^9), and
# the value is a multiple of q, invisible to Montgomery arithmetic.
_BIAS = [(64 * Q >> (8 * i)) & 0xFF for i in range(NLIMBS)]
_BIAS[NLIMBS - 1] += (64 * Q >> (8 * NLIMBS)) << 8  # fold spill into limb 47
# Spread so every limb >= 511: borrow units of 256 from the limb above,
# ascending so fixed limbs stay fixed.
for _i in range(NLIMBS - 1):
    while _BIAS[_i] < 511:
        _BIAS[_i] += 256
        _BIAS[_i + 1] -= 1
_BIAS_ARR = np.asarray(_BIAS, dtype=np.int32)
assert (_BIAS_ARR >= 511).all(), "subtraction bias must dominate weak limbs"
assert sum(int(v) << (8 * i) for i, v in enumerate(_BIAS_ARR)) == 64 * Q

_R_MOD_Q_LIMBS = to_limbs(R_MOD_Q)           # fold weight of limb 48
_P385_LIMBS = to_limbs((1 << 385) % Q)       # fold weight of limb 47 bit 9+
_R2_LIMBS = to_limbs(R2_MOD_Q)

_constants: dict = {}


def drop_device_tables() -> None:
    """Forget the device copies of the constants: the next call places
    fresh ones.  The dict is rebound, not cleared, so a launch still
    holding the old tensors never shares them with the next one (the
    sidecar's crash-only reboot)."""
    global _constants
    _constants = {}


def cached(key, values, device) -> torch.Tensor:
    """A small int32 constant tensor, made once per device (the ops run
    thousands of times per check; a fresh host-to-device copy each time
    would dominate)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _constants.get((key, dev))
    if t is None:
        t = torch.as_tensor(np.asarray(values, np.int32), device=dev)
        _constants[(key, dev)] = t
    return t


def mont_constant(x: int, device) -> torch.Tensor:
    """Constant in Montgomery form."""
    return cached(("mont", x % Q), to_limbs(x * R % Q), device)


# ---------------------------------------------------------------------------
# Carries
# ---------------------------------------------------------------------------

def _carry_step(x: torch.Tensor, keep_top: bool) -> torch.Tensor:
    """One parallel carry step: every limb keeps its low byte and takes
    the high bits of the limb below.  With ``keep_top`` the top limb
    keeps its own overflow in place (weight 256 per unit: its mask is
    all ones); without, the overflow is dropped (arithmetic mod
    2^(8 * nlimbs))."""
    n = x.shape[-1]
    mask = cached(("carry_mask", n, keep_top),
                  [LIMB_MASK] * (n - 1) + [-1 if keep_top else LIMB_MASK],
                  x.device)
    return (x & mask) + TF.pad(x[..., :-1] >> LIMB_BITS, (1, 0))


def weak_carry(x: torch.Tensor, steps: int = 3) -> torch.Tensor:
    """Bring limbs below ~2^9 (inputs < 2^24-ish need 3 steps).  The top
    limb's overflow is kept in place, so the value is preserved when the
    caller's bounds keep it inside the array."""
    for _ in range(steps):
        x = _carry_step(x, keep_top=True)
    return x


def trunc_carry(x: torch.Tensor, steps: int = 3) -> torch.Tensor:
    """Carry steps that drop the overflow out of the top limb, i.e.
    arithmetic mod 2^(8 * nlimbs).  Used for m = T * q' mod R."""
    for _ in range(steps):
        x = _carry_step(x, keep_top=False)
    return x


# ---------------------------------------------------------------------------
# Schoolbook limb product (exact int32)
# ---------------------------------------------------------------------------

def _schoolbook(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n) x (..., m) limb arrays of one shape prefix -> (..., n+m-1)
    coefficients, coefficient k = sum_{i+j=k} a_i b_j, exact in int32
    (weak limbs < 2^11, at most 48 terms: every sum < 2^24).

    b padded by n - 1 zeros on each side, read as its n + m - 1 windows
    of n limbs (a strided view, no copy): window k holds b_{k-n+1..k},
    and coefficient k is its dot product with a reversed."""
    n = a.shape[-1]
    windows = TF.pad(b, (n - 1, n - 1)).unfold(-1, n, 1)   # (..., n+m-1, n)
    return (windows * a.flip(-1).unsqueeze(-2)).sum(-1, dtype=torch.int32)


def _by_const(a: torch.Tensor, key: str, limbs: np.ndarray) -> torch.Tensor:
    """(..., n) weak limbs times a fixed 48-limb constant."""
    c = cached(key, limbs, a.device).expand(*a.shape[:-1], NLIMBS)
    return _schoolbook(a, c)


def _low_carry(t2: torch.Tensor) -> torch.Tensor:
    """The carry out of limbs 0..47 into limb 48, exactly.

    (T + m q) is divisible by R, so V = sum_{i<48} t2_i 2^(8i) is c 2^384
    for a small integer c.  With every limb nonnegative and below 2^32,
    the limbs below 44 contribute less than 2^(352+32), hence
    c = ceil(H / 2^32) for H = sum_{44<=i<48} t2_i 2^(8(i-44)), in int64.
    The reference recovers the same c with an f32 dot and round."""
    top = t2[..., 44:48].to(torch.int64)
    h = (top[..., 0] + (top[..., 1] << 8) + (top[..., 2] << 16)
         + (top[..., 3] << 24))
    return ((h + ((1 << 32) - 1)) >> 32).to(torch.int32)


# ---------------------------------------------------------------------------
# Montgomery multiply / add / sub
# ---------------------------------------------------------------------------

def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """REDC(a*b): both in Montgomery weak form -> Montgomery weak form.
    Inputs broadcast against each other (the Fq12 tower relies on it)."""
    a, b = torch.broadcast_tensors(a, b)
    t = _schoolbook(a, b)                                    # 95 coeffs < 2^24
    t = weak_carry(TF.pad(t, (0, 1)), 3)
    m = trunc_carry(
        _by_const(t[..., :NLIMBS], "qprime", _QPRIME_LIMBS)[..., :NLIMBS], 3)
    mq = _by_const(m, "q", _Q_LIMBS)                        # 95 coeffs
    t2 = weak_carry(t + TF.pad(mq, (0, 1)), 3)
    c = _low_carry(t2)
    hi = t2[..., NLIMBS:]
    hi = torch.cat([(hi[..., 0] + c).unsqueeze(-1), hi[..., 1:]], dim=-1)
    return weak_carry(hi, 1)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain limb add + one carry step (weak in, weak out)."""
    return weak_carry(a + b, 1)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b + 64q (the bias keeps limbs nonnegative; the value changes
    by a multiple of q)."""
    return weak_carry(a + cached("bias", _BIAS_ARR, a.device) - b, 2)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Tame a (..., 48) digit array with limbs <= ~2^14 and value
    <= ~2^390 back to weak form (same residue mod q): widen by one limb,
    carry (limb 48 absorbs the overflow), fold limb 48 back via
    2^384 mod q, carry again (limb 47 absorbs), fold limb 47's excess
    beyond 9 bits via 2^385 mod q, one last carry."""
    x = weak_carry(TF.pad(x, (0, 1)), 3)
    spill = x[..., NLIMBS:]
    x = x[..., :NLIMBS] + spill * cached("r_mod_q", _R_MOD_Q_LIMBS, x.device)
    x = weak_carry(x, 2)
    excess = x[..., 47:] >> 9
    x = torch.cat([x[..., :47], x[..., 47:] & 511], dim=-1)
    x = x + excess * cached("p385", _P385_LIMBS, x.device)
    return weak_carry(x, 1)


# ---------------------------------------------------------------------------
# Conversion / canonicalization
# ---------------------------------------------------------------------------

def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Canonical limbs -> Montgomery form (multiply by R^2 then REDC)."""
    return mont_mul(a, cached("r2", _R2_LIMBS, a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery weak form -> canonical limbs in [0, q)."""
    one = cached("one", to_limbs(1), a.device)
    x = mont_mul(a, one)          # == a * R^{-1} mod q, value < q + eps
    return _cond_sub_q(_ripple(x))


def canonical(a: torch.Tensor) -> torch.Tensor:
    """Nonnegative limbs (each below 2^16, so the schoolbooks stay exact
    in int32) -> the canonical limbs of the same residue: each limb below
    256, the value in [0, q).  A Montgomery form stays a Montgomery form
    of the same element; this is the representative the word kernels
    (ops/kern/fq12_tower.py) return.  mont_mul by R^2 mod q gives a R mod
    q below ~2.5 R for any such input, and from_mont's REDC by 1 then
    takes it back to a mod q, ripple and one conditional subtraction."""
    return from_mont(mont_mul(a, cached("r2", _R2_LIMBS, a.device)))


def _incoming(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Carry-lookahead: (..., n) bool generate / propagate flags per limb
    -> (..., n) int32 carry into each limb.  The carry into limb i is the
    generate flag of the nearest limb j < i that does not propagate (0 if
    every limb below propagates)."""
    n = gen.shape[-1]
    idx = torch.arange(n, device=gen.device).expand(gen.shape)
    stop = torch.where(prop, torch.full_like(idx, -1), idx)
    last = torch.cummax(stop, dim=-1).values                # stop at <= i
    below = TF.pad(last[..., :-1], (1, 0), value=-1)        # stop at < i
    carry = torch.gather(gen, -1, below.clamp(min=0)) & (below >= 0)
    return carry.to(torch.int32)


def _ripple(x: torch.Tensor) -> torch.Tensor:
    """Canonical byte digits of the value mod 2^384 of nonnegative limbs
    below ~2^11: the reference's sequential carry.  Two parallel steps
    leave limbs in [0, 256]; the remaining 0/1 carries resolve by
    lookahead (a limb of 256 generates one, a limb of 255 propagates)."""
    x = trunc_carry(x, 2)
    carry = _incoming(x > LIMB_MASK, x == LIMB_MASK)
    return (x + carry) & LIMB_MASK


def _cond_sub_q(x: torch.Tensor) -> torch.Tensor:
    """x - q if x >= q, else x, for canonical byte digits: the borrow
    chain by lookahead (a digit below q's generates a borrow, an equal
    one propagates)."""
    q = cached("q", _Q_LIMBS, x.device)
    borrow = _incoming(x < q, x == q)
    d = x - q - borrow
    out_borrow = (d[..., -1:] < 0)                          # x < q
    return torch.where(out_borrow, x, d & LIMB_MASK)


# ---------------------------------------------------------------------------
# Exponentiation
# ---------------------------------------------------------------------------

def exponent_digits(exponent: int, window: int = 4) -> list[int]:
    """The window digits of a static exponent, most significant first
    (the reference's scan schedule)."""
    assert exponent >= 0
    nbits = max(1, exponent.bit_length())
    nsteps = -(-nbits // window)
    return [(exponent >> (window * (nsteps - 1 - i))) & ((1 << window) - 1)
            for i in range(nsteps)]


def pow_windowed(x, exponent: int, mul, one, window: int = 4):
    """Left-to-right windowed exponentiation over a static python
    exponent, shared by Fq (here) and the Fq12 tower: the reference's
    scan, unrolled.  The table is one, x, x*x, ... (entry i = mul(entry
    i-1, x)), and a zero digit multiplies by the table's ``one`` like any
    other, so the limbs follow the reference's.  ``mul`` is the group
    law, ``one`` the identity broadcast to x's shape."""
    entries = [one, x]
    for _ in range(2, 1 << window):
        entries.append(mul(entries[-1], x))
    acc = one
    for digit in exponent_digits(exponent, window):
        for _ in range(window):
            acc = mul(acc, acc)
        acc = mul(acc, entries[digit])
    return acc


def pow_const(x: torch.Tensor, exponent: int, window: int = 4) -> torch.Tensor:
    """x^exponent in Montgomery form, static exponent, plain operators."""
    one = mont_constant(1, x.device).expand(x.shape)
    return pow_windowed(x, exponent, mont_mul, one, window)


def mul_selfcheck(batch: int = 64, seed: int = 0, device=None) -> None:
    """Check ``mont_mul`` on ``device`` exact against host bigints for
    ``batch`` seeded products (the JAX package's inputs: random 62-bit
    values to the 7th power mod q); raises AssertionError on any
    mismatch."""
    from ..utils.device import resolve

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    xs = [int(rng.integers(0, 2**62)) ** 7 % Q for _ in range(batch)]
    ys = [int(rng.integers(0, 2**62)) ** 7 % Q for _ in range(batch)]
    a = torch.from_numpy(np.stack([to_limbs(x * R % Q) for x in xs]))
    b = torch.from_numpy(np.stack([to_limbs(y * R % Q) for y in ys]))
    got = from_mont(mont_mul(a.to(dev), b.to(dev))).cpu().numpy()
    for i, (x, y) in enumerate(zip(xs, ys)):
        if from_limbs(got[i]) != x * y % Q:
            raise AssertionError(
                f"field381 mont_mul mismatch at row {i} on {dev}")


def inv(x: torch.Tensor) -> torch.Tensor:
    """Fermat inverse (0 -> 0), Montgomery form in and out: the fq_pow
    kernel on a CUDA tensor, its plain version on a CPU one.  Both first
    bring an input whose top limb is 224 or more below 0.27 R
    (fq12_chain.STABLE_TOP), where the reference's chain would leave its
    exact range; below that they give the reference's limbs."""
    from .kern.fq12_chain import fq_pow

    return fq_pow(x, Q - 2)
