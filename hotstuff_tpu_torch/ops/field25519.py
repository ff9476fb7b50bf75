"""GF(2^255 - 19) arithmetic, batched, in PyTorch: the port of
hotstuff_tpu/ops/field25519.py.

A field element is 32 radix-2^8 limbs stored as int32, shape (..., 32),
little-endian.  Weak-normal form: limbs in [0, 2^9), the value only
meaningful mod p; ``canonical`` gives bytes with value in [0, p).  Every
op keeps the reference's carry schedule, so results equal the JAX
package's limb for limb.  The arithmetic is exact integer arithmetic
throughout: ``mul`` goes to kernel K1 (ops/kern/field_mul) on a CUDA
tensor and to its plain version on a CPU one.
"""

from __future__ import annotations

import numpy as np
import torch

from .kern.field_mul import carry_step as _carry_step
from .kern.field_mul import field_mul as _field_mul

NLIMBS = 32
LIMB_BITS = 8
LIMB_MASK = (1 << LIMB_BITS) - 1
P = 2**255 - 19

# Canonical base-256 digits of p (little-endian): [237, 255*30, 127].
_P_DIGITS = [(P >> (8 * i)) & 0xFF for i in range(NLIMBS)]

# Subtraction bias: 8p spread over limbs so every limb dominates any weak
# limb (< 2^9): [1896, 2040 x30, 1016].
_SUB_BIAS = [8 * d for d in _P_DIGITS]


# ---------------------------------------------------------------------------
# Host <-> limb conversion helpers (numpy / python ints)
# ---------------------------------------------------------------------------

def to_limbs(x: int) -> np.ndarray:
    """Python int (mod p not required) -> (32,) int32 canonical byte limbs."""
    x = int(x) % (1 << 256)
    return np.array([(x >> (8 * i)) & 0xFF for i in range(NLIMBS)],
                    dtype=np.int32)


def from_limbs(limbs) -> int:
    """(32,) limbs (any magnitude) -> python int value."""
    limbs = np.asarray(limbs).reshape(NLIMBS)
    return sum(int(v) << (8 * i) for i, v in enumerate(limbs))


def batch_to_limbs(xs) -> np.ndarray:
    """Iterable of python ints -> (N, 32) int32 limbs."""
    return np.stack([to_limbs(x) for x in xs])


def batch_from_limbs(limbs) -> list[int]:
    limbs = np.asarray(limbs, dtype=np.int64)
    return [sum(int(v) << (8 * i) for i, v in enumerate(row))
            for row in limbs.reshape(-1, NLIMBS)]


_constants: dict = {}


def drop_device_tables() -> None:
    """Forget the device copies of the constants: the next call places
    fresh ones.  The dict is rebound, not cleared, so a launch still
    holding the old tensors never shares them with the next one (the
    sidecar's crash-only reboot)."""
    global _constants
    _constants = {}


def _cached_tensor(key, values, device) -> torch.Tensor:
    """A small constant tensor, made once per device (the ops run
    thousands of times per verify; a fresh host-to-device copy each
    time would dominate)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _constants.get((key, dev))
    if t is None:
        t = torch.as_tensor(np.asarray(values, np.int32), device=dev)
        _constants[(key, dev)] = t
    return t


def constant(x: int, device) -> torch.Tensor:
    """(32,) int32 limbs of x mod p on ``device`` (cached)."""
    return _cached_tensor(("const", int(x) % P), to_limbs(x % P), device)


# ---------------------------------------------------------------------------
# Carry propagation (``_carry_step`` is K1's plain-version helper)
# ---------------------------------------------------------------------------

def weak_normalize(x: torch.Tensor, steps: int) -> torch.Tensor:
    for _ in range(steps):
        x = _carry_step(x)
    return x


# ---------------------------------------------------------------------------
# Field ops (weak-normal in, weak-normal out; shapes (..., 32) int32)
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b: limbs < 2^10 -> one carry step -> < 2^9."""
    return _carry_step(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (mod p) without negative intermediates: add the 8p bias,
    then two carry steps restore < 2^9."""
    return _carry_step(_carry_step(
        a + _cached_tensor("sub_bias", _SUB_BIAS, a.device) - b))


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p (weak): kernel K1 on the card, its plain version on
    the CPU.  Inputs broadcast against each other."""
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    return _field_mul(a.contiguous(), b.contiguous())


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_selfcheck(batch: int = 256, seed: int = 0, device=None) -> None:
    """Check the field multiply on ``device`` (K1 on the card, its plain
    version on the CPU) exact for adversarial full-range weak limbs
    (< 2^9, the first row all 511) against host bigints; raises
    AssertionError on any mismatch.  Cheap (one launch); the off-chain
    bench runs it before its sweep, so a wrong build fails at once
    instead of giving wrong verdicts."""
    from ..utils.device import resolve

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 512, (batch, NLIMBS))
    b = rng.integers(0, 512, (batch, NLIMBS))
    a[0, :] = 511
    b[0, :] = 511
    ta = torch.as_tensor(a, dtype=torch.int32, device=dev)
    tb = torch.as_tensor(b, dtype=torch.int32, device=dev)
    got = batch_from_limbs(canonical(mul(ta, tb)).cpu().numpy())
    want = [(x * y) % P for x, y in zip(batch_from_limbs(a),
                                        batch_from_limbs(b))]
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        raise AssertionError(f"field25519 multiply is not exact on {dev} "
                             f"(first wrong row {bad})")


# ---------------------------------------------------------------------------
# Canonicalization and comparison
# ---------------------------------------------------------------------------

def _sequential_carry(x: torch.Tensor):
    """Exact ripple carry over the 32 limbs.  Returns (limbs in [0,256),
    carry_out)."""
    limbs = []
    carry = torch.zeros_like(x[..., 0])
    for i in range(NLIMBS):
        t = x[..., i] + carry
        limbs.append(t & LIMB_MASK)
        carry = t >> LIMB_BITS
    return torch.stack(limbs, dim=-1), carry


def _add_limb0(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[..., :1] + v.unsqueeze(-1), x[..., 1:]], dim=-1)


def _cond_sub_p(x: torch.Tensor) -> torch.Tensor:
    """If x >= p (x < 2^256, limbs canonical bytes), subtract p."""
    limbs = []
    borrow = torch.zeros_like(x[..., 0])
    for i in range(NLIMBS):
        d = x[..., i] - _P_DIGITS[i] - borrow
        borrow = (d < 0).to(torch.int32)
        limbs.append(d + (borrow << LIMB_BITS))
    keep = (borrow > 0).unsqueeze(-1)  # borrow out => x < p => keep x
    return torch.where(keep, x, torch.stack(limbs, dim=-1))


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Weak element -> canonical limbs (bytes, value in [0, p))."""
    # Value < 2^257.01 -> first carry_out <= 2.
    x, carry = _sequential_carry(x)
    x = _add_limb0(x, 38 * carry)
    # Now value < 2^256 + 77; second pass carry_out <= 1.
    x, carry = _sequential_carry(x)
    x = _add_limb0(x, 38 * carry)
    return _cond_sub_p(_cond_sub_p(x))


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field equality of weak elements -> bool shape (...,)."""
    return torch.all(canonical(a) == canonical(b), dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonical(a) == 0, dim=-1)


def parity(a: torch.Tensor) -> torch.Tensor:
    """Low bit of the canonical value (the Ed25519 'sign' of x)."""
    return canonical(a)[..., 0] & 1


# ---------------------------------------------------------------------------
# Exponentiation by fixed public exponents
# ---------------------------------------------------------------------------

def pow_const(x: torch.Tensor, exponent: int, window: int = 4) -> torch.Tensor:
    """x ** exponent mod p for a python-int exponent: left-to-right
    windowed square-and-multiply over the exponent's digit schedule,
    each step ``window`` squarings and one multiply by a table entry
    (x^0 .. x^(2^w - 1))."""
    if exponent < 0:
        raise ValueError("pow_const needs a non-negative exponent")
    nbits = max(1, exponent.bit_length())
    nsteps = -(-nbits // window)
    digits = [(exponent >> (window * (nsteps - 1 - i))) & ((1 << window) - 1)
              for i in range(nsteps)]
    one = constant(1, x.device).expand_as(x)
    table = [one, x]
    for _ in range(2, 1 << window):
        table.append(mul(table[-1], x))
    acc = one
    for digit in digits:
        for _ in range(window):
            acc = sqr(acc)
        acc = mul(acc, table[digit])
    return acc


def inv(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2): Fermat inverse (x=0 -> 0)."""
    return pow_const(x, P - 2)


def _pow_2k(x: torch.Tensor, k: int, mul=mul) -> torch.Tensor:
    """x^(2^k): k squarings."""
    for _ in range(k):
        x = mul(x, x)
    return x


def pow_p58(x: torch.Tensor, mul=mul) -> torch.Tensor:
    """x^((p-5)/8) = x^(2^252 - 3), the x-recovery exponent, by the
    ref10 addition chain (251 squarings + 11 multiplies).  ``mul`` is
    the field multiply (the decompress kernel's plain version passes
    K1's plain version)."""
    x2 = mul(mul(x, x), x)                    # x^(2^2 - 1)
    x4 = mul(_pow_2k(x2, 2, mul), x2)         # x^(2^4 - 1)
    x5 = mul(mul(x4, x4), x)                  # x^(2^5 - 1)
    x10 = mul(_pow_2k(x5, 5, mul), x5)        # x^(2^10 - 1)
    x20 = mul(_pow_2k(x10, 10, mul), x10)     # x^(2^20 - 1)
    x40 = mul(_pow_2k(x20, 20, mul), x20)     # x^(2^40 - 1)
    x50 = mul(_pow_2k(x40, 10, mul), x10)     # x^(2^50 - 1)
    x100 = mul(_pow_2k(x50, 50, mul), x50)    # x^(2^100 - 1)
    x200 = mul(_pow_2k(x100, 100, mul), x100)  # x^(2^200 - 1)
    x250 = mul(_pow_2k(x200, 50, mul), x50)   # x^(2^250 - 1)
    return mul(_pow_2k(x250, 2, mul), x)      # x^(2^252 - 3)
