"""BLS12-381 pairing and BLS signatures in pure Python bigints: the
port's copy of hotstuff_tpu/offchain/bls12381.py.

Roles in the port: the sidecar's host preparation for a BLS verify
(decoding with the on-curve and subgroup tests, public-key and signature
aggregation, hash-to-G2, the Miller loop's line values that
ops/bls381.miller_lines records), the signer behind OP_BLS_SIGN, the
host reference (``verify_aggregate*``) that the tests and chip_smoke.py
hold the card's verdicts to, and the off-chain suite's BLS scheme
(``key_gen``, ``sign``, ``verify``, ``pairing``; offchain/bench.py).

Fq/Fq2/Fq12 tower (Fq12 as a flat degree-12 polynomial modulo
w^12 - 2w^6 + 2), G1/G2 curves, optimal-ate pairing with the sextic
twist embedding, filecoin's group assignment (public keys in G1,
signatures in G2), encoded uncompressed (96-byte G1, 192-byte G2).
Decoding enforces on-curve and prime-order subgroup membership.
Verification batches all Miller loops under one final exponentiation.
"""

from __future__ import annotations

import functools
import hashlib
import secrets

# Field / curve parameters
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS_X = 15132376222941642752  # |x|; the BLS parameter is -x

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)


# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 1): elements are (a, b) = a + b u
# ---------------------------------------------------------------------------

def fq2_add(x, y):
    return ((x[0] + y[0]) % Q, (x[1] + y[1]) % Q)


def fq2_sub(x, y):
    return ((x[0] - y[0]) % Q, (x[1] - y[1]) % Q)


def fq2_mul(x, y):
    a = x[0] * y[0] % Q
    b = x[1] * y[1] % Q
    c = (x[0] + x[1]) * (y[0] + y[1]) % Q
    return ((a - b) % Q, (c - a - b) % Q)


def fq2_neg(x):
    return ((-x[0]) % Q, (-x[1]) % Q)


def fq2_inv(x):
    norm = (x[0] * x[0] + x[1] * x[1]) % Q
    ninv = pow(norm, -1, Q)
    return (x[0] * ninv % Q, (-x[1]) * ninv % Q)


FQ2_ONE = (1, 0)
FQ2_ZERO = (0, 0)


# ---------------------------------------------------------------------------
# Fq12 = Fq[w] / (w^12 - 2 w^6 + 2): elements are 12-tuples of Fq coeffs.
# (The py_ecc-style direct degree-12 representation; the sextic twist of
# G2 into this ring is _twist below.)
# ---------------------------------------------------------------------------

FQ12_MOD = (2, 0, 0, 0, 0, 0, -2, 0, 0, 0, 0, 0)  # w^12 = -2 + 2 w^6
FQ12_ONE = (1,) + (0,) * 11
FQ12_ZERO = (0,) * 12


def fq12_add(x, y):
    return tuple((a + b) % Q for a, b in zip(x, y))


def fq12_sub(x, y):
    return tuple((a - b) % Q for a, b in zip(x, y))


def fq12_neg(x):
    return tuple((-a) % Q for a in x)


def fq12_scalar(x, k):
    return tuple(a * k % Q for a in x)


def fq12_mul(x, y):
    prod = [0] * 23
    for i, a in enumerate(x):
        if a == 0:
            continue
        for j, b in enumerate(y):
            if b:
                prod[i + j] += a * b
    # reduce degrees 22..12 with w^12 = 2 w^6 - 2
    for d in range(22, 11, -1):
        c = prod[d]
        if c:
            prod[d] = 0
            prod[d - 6] += 2 * c
            prod[d - 12] -= 2 * c
    return tuple(c % Q for c in prod[:12])


def fq12_inv(x):
    # Extended Euclid over Fq[w] modulo the degree-12 modulus.
    lm, hm = [1] + [0] * 12, [0] * 13
    low = list(x) + [0]
    high = [(-c) % Q for c in FQ12_MOD] + [1]
    # high = modulus polynomial coefficients (monic, degree 12)
    high = [2 % Q, 0, 0, 0, 0, 0, (-2) % Q, 0, 0, 0, 0, 0, 1]

    def deg(p):
        for i in range(len(p) - 1, -1, -1):
            if p[i]:
                return i
        return 0

    def poly_rounded_div(a, b):
        dega, degb = deg(a), deg(b)
        temp = list(a)
        out = [0] * len(a)
        inv_lead = pow(b[degb], -1, Q)
        for i in range(dega - degb, -1, -1):
            out[i] = out[i] + temp[degb + i] * inv_lead
            for c in range(degb + 1):
                temp[c + i] = (temp[c + i] - out[i] * b[c])
        return [c % Q for c in out[:deg(out) + 1]]

    while deg(low):
        r = poly_rounded_div(high, low)
        r += [0] * (13 - len(r))
        nm = list(hm)
        new = list(high)
        for i in range(13):
            for j in range(13 - i):
                nm[i + j] -= lm[i] * r[j]
                new[i + j] -= low[i] * r[j]
        nm = [c % Q for c in nm]
        new = [c % Q for c in new]
        lm, low, hm, high = nm, new, lm, low
    inv_low0 = pow(low[0], -1, Q)
    return tuple(c * inv_low0 % Q for c in lm[:12])


def fq12_pow(x, n):
    result = FQ12_ONE
    base = x
    while n:
        if n & 1:
            result = fq12_mul(result, base)
        base = fq12_mul(base, base)
        n >>= 1
    return result


# ---------------------------------------------------------------------------
# Curves. G1 over Fq: y^2 = x^3 + 4. G2 over Fq2: y^2 = x^3 + 4(u+1).
# Points are (x, y) or None for infinity; generic over the field ops.
# ---------------------------------------------------------------------------

class _Ops:
    """Field operation bundle so one point-arithmetic works over Fq, Fq2
    and Fq12."""

    def __init__(self, add, sub, mul, neg, inv, one, zero, b):
        self.add, self.sub, self.mul, self.neg, self.inv = \
            add, sub, mul, neg, inv
        self.one, self.zero, self.b = one, zero, b

    def scalar(self, x, k):
        if isinstance(x, tuple):
            return tuple(c * k % Q for c in x)
        return x * k % Q


_fq = _Ops(lambda a, b: (a + b) % Q, lambda a, b: (a - b) % Q,
           lambda a, b: a * b % Q, lambda a: (-a) % Q,
           lambda a: pow(a, -1, Q), 1, 0, 4)
_fq2 = _Ops(fq2_add, fq2_sub, fq2_mul, fq2_neg, fq2_inv, FQ2_ONE, FQ2_ZERO,
            fq2_mul((4, 0), (1, 1)))
_fq12 = _Ops(fq12_add, fq12_sub, fq12_mul, fq12_neg, fq12_inv, FQ12_ONE,
             FQ12_ZERO, None)


def _double(pt, ops):
    if pt is None:
        return None
    x, y = pt
    if y == ops.zero:
        return None
    lam = ops.mul(ops.scalar(ops.mul(x, x), 3), ops.inv(ops.scalar(y, 2)))
    nx = ops.sub(ops.mul(lam, lam), ops.scalar(x, 2))
    ny = ops.sub(ops.mul(lam, ops.sub(x, nx)), y)
    return (nx, ny)


def _add(p1, p2, ops):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return _double(p1, ops)
        return None
    lam = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
    nx = ops.sub(ops.sub(ops.mul(lam, lam), x1), x2)
    ny = ops.sub(ops.mul(lam, ops.sub(x1, nx)), y1)
    return (nx, ny)


def _mul(pt, k, ops):
    result = None
    addend = pt
    while k:
        if k & 1:
            result = _add(result, addend, ops)
        addend = _double(addend, ops)
        k >>= 1
    return result


def g1_generator():
    return (G1_X, G1_Y)


def g2_generator():
    return (G2_X, G2_Y)


def g1_add(p1, p2):
    return _add(p1, p2, _fq)


def g1_mul(pt, k):
    return _jac_mul(pt, k % R, _fq)


def g1_neg(pt):
    return None if pt is None else (pt[0], (-pt[1]) % Q)


def g2_add(p1, p2):
    return _add(p1, p2, _fq2)


def g2_mul(pt, k):
    return _jac_mul(pt, k % R, _fq2)


def g2_neg(pt):
    return None if pt is None else (pt[0], fq2_neg(pt[1]))


def _jac_double(P, ops):
    """Jacobian doubling on y^2 = x^3 + b (a = 0): 2M + 5S, no inversion."""
    X, Y, Z = P
    mul, sub, sc = ops.mul, ops.sub, ops.scalar
    A = mul(X, X)
    B = mul(Y, Y)
    C = mul(B, B)
    D = sc(sub(sub(mul(ops.add(X, B), ops.add(X, B)), A), C), 2)
    E = sc(A, 3)
    X3 = sub(mul(E, E), sc(D, 2))
    Y3 = sub(mul(E, sub(D, X3)), sc(C, 8))
    Z3 = sc(mul(Y, Z), 2)
    return (X3, Y3, Z3)


def _jac_add_affine(P, q, ops):
    """Mixed Jacobian + affine addition; returns None for the identity."""
    X1, Y1, Z1 = P
    x2, y2 = q
    mul, sub = ops.mul, ops.sub
    Z1Z1 = mul(Z1, Z1)
    U2 = mul(x2, Z1Z1)
    S2 = mul(y2, mul(Z1, Z1Z1))
    H = sub(U2, X1)
    r = sub(S2, Y1)
    if H == ops.zero:
        if r == ops.zero:
            return _jac_double(P, ops)
        return None
    HH = mul(H, H)
    HHH = mul(H, HH)
    V = mul(X1, HH)
    X3 = sub(sub(mul(r, r), HHH), ops.scalar(V, 2))
    Y3 = sub(mul(r, sub(V, X3)), mul(Y1, HHH))
    Z3 = mul(Z1, H)
    return (X3, Y3, Z3)


def _jac_mul(pt, k, ops):
    """Affine [k]pt via Jacobian left-to-right double-and-add: one field
    inversion total instead of one per bit — this is what makes the [R]P
    subgroup membership test affordable in pure python."""
    if pt is None or k == 0:
        return None
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = _jac_double(acc, ops)
            if acc[2] == ops.zero:
                acc = None
        if bit == "1":
            acc = (pt[0], pt[1], ops.one) if acc is None \
                else _jac_add_affine(acc, pt, ops)
    if acc is None or acc[2] == ops.zero:
        return None
    zinv = ops.inv(acc[2])
    zinv2 = ops.mul(zinv, zinv)
    return (ops.mul(acc[0], zinv2), ops.mul(acc[1], ops.mul(zinv2, zinv)))


def g1_in_subgroup(pt) -> bool:
    """Prime-order subgroup membership ([R]P == identity). The filecoin
    bls-signatures crate the reference benches against enforces this on
    every deserialize (off-chain-benchmarking/production/Cargo.toml:10);
    aggregate verification over cofactor-component points is undefined."""
    return pt is None or (g1_on_curve(pt) and _jac_mul(pt, R, _fq) is None)


def g2_in_subgroup(pt) -> bool:
    return pt is None or (g2_on_curve(pt) and _jac_mul(pt, R, _fq2) is None)


def g1_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + 4)) % Q == 0


def g2_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return fq2_sub(fq2_mul(y, y),
                   fq2_add(fq2_mul(fq2_mul(x, x), x), _fq2.b)) == FQ2_ZERO


# ---------------------------------------------------------------------------
# Pairing
# ---------------------------------------------------------------------------

_W2 = (0, 0) + (1,) + (0,) * 9   # w^2
_W3 = (0, 0, 0) + (1,) + (0,) * 8  # w^3
_W2_INV = fq12_inv(_W2)
_W3_INV = fq12_inv(_W3)


def _twist(pt):
    """Embed a G2 point (over Fq2, basis 1,u) into E(Fq12): coefficients
    re-expressed in the (1, w^6) basis (u = w^6 - 1), then untwisted by
    w^-2 / w^-3 — the G2 curve's b = 4(u+1) equals 4w^6 in this basis, so
    dividing lands exactly on G1's curve y^2 = x^3 + 4 over Fq12."""
    if pt is None:
        return None
    x, y = pt
    nx = tuple(((x[0] - x[1]) % Q if i == 0 else (x[1] if i == 6 else 0))
               for i in range(12))
    ny = tuple(((y[0] - y[1]) % Q if i == 0 else (y[1] if i == 6 else 0))
               for i in range(12))
    return (fq12_mul(nx, _W2_INV), fq12_mul(ny, _W3_INV))


def _cast_g1_fq12(pt):
    if pt is None:
        return None
    x, y = pt
    return ((x,) + (0,) * 11, (y,) + (0,) * 11)


def _linefunc(p1, p2, t):
    """Evaluate the line through p1,p2 at t (all over Fq12)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    if y1 == y2:
        m = fq12_mul(fq12_scalar(fq12_mul(x1, x1), 3),
                     fq12_inv(fq12_scalar(y1, 2)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    return fq12_sub(xt, x1)


def miller_loop(q_twisted, p_fq12):
    """Miller loop over the BLS parameter (ate pairing, untwisted inputs).

    q_twisted: G2 point already embedded in E(Fq12); p_fq12: G1 point cast
    into Fq12 coordinates. Result needs final_exponentiate."""
    if q_twisted is None or p_fq12 is None:
        return FQ12_ONE
    rpt = q_twisted
    f = FQ12_ONE
    for bit in bin(BLS_X)[3:]:
        f = fq12_mul(fq12_mul(f, f), _linefunc(rpt, rpt, p_fq12))
        rpt = _add(rpt, rpt, _fq12)
        if bit == "1":
            f = fq12_mul(f, _linefunc(rpt, q_twisted, p_fq12))
            rpt = _add(rpt, q_twisted, _fq12)
    # BLS parameter is negative: conjugate/invert
    return fq12_inv(f)


_FINAL_EXP = (Q**12 - 1) // R


def final_exponentiate(f):
    return fq12_pow(f, _FINAL_EXP)


def pairing(p_g1, q_g2):
    """e(P in G1, Q in G2) -> Fq12 element of order dividing r."""
    return final_exponentiate(
        miller_loop(_twist(q_g2), _cast_g1_fq12(p_g1)))


def multi_pairing(pairs):
    """prod e(P_i, Q_i) with ONE final exponentiation — the shape every
    BLS verify below uses (2 pairings -> 1 final exp; n-message aggregate
    -> n+1 Miller loops, 1 final exp)."""
    f = FQ12_ONE
    for p_g1, q_g2 in pairs:
        f = fq12_mul(f, miller_loop(_twist(q_g2), _cast_g1_fq12(p_g1)))
    return final_exponentiate(f)


# ---------------------------------------------------------------------------
# Encoding (uncompressed here; sizes follow the filecoin convention the
# reference's production bench uses: G1 pk, G2 sig)
# ---------------------------------------------------------------------------

def g1_encode(pt) -> bytes:
    if pt is None:
        return b"\x40" + b"\x00" * 95
    return pt[0].to_bytes(48, "big") + pt[1].to_bytes(48, "big")


def _g1_decode_uncached(data: bytes):
    if data[0] == 0x40:
        return None
    x = int.from_bytes(data[:48], "big")
    y = int.from_bytes(data[48:], "big")
    pt = (x, y)
    if not g1_on_curve(pt):
        raise ValueError("not on G1")
    if _jac_mul(pt, R, _fq) is not None:
        raise ValueError("G1 point not in the prime-order subgroup")
    return pt


def g1_decode(data: bytes):
    """Decode + validate (on-curve AND prime-order subgroup, matching
    filecoin bls-signatures deserialize semantics). Cached: committee
    public keys repeat on every verify, and the [R]P membership test is
    the expensive part of decoding."""
    return _g1_decode_cached(bytes(data))


@functools.lru_cache(maxsize=4096)
def _g1_decode_cached(data: bytes):
    return _g1_decode_uncached(data)


def g2_encode(pt) -> bytes:
    if pt is None:
        return b"\x40" + b"\x00" * 191
    x, y = pt
    return (x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big")
            + y[1].to_bytes(48, "big") + y[0].to_bytes(48, "big"))


def g2_decode_lax(data: bytes):
    """Decode with the on-curve check only (no subgroup test).  For callers
    aggregating many fresh signatures who subgroup-check the single
    aggregate instead: the verified pairing statement depends only on the
    aggregate, so that costs one [R]P ladder instead of N."""
    if data[0] == 0x40:
        return None
    x = (int.from_bytes(data[48:96], "big"),
         int.from_bytes(data[:48], "big"))
    y = (int.from_bytes(data[144:192], "big"),
         int.from_bytes(data[96:144], "big"))
    pt = (x, y)
    if not g2_on_curve(pt):
        raise ValueError("not on G2")
    return pt


def g2_decode(data: bytes):
    pt = g2_decode_lax(data)
    if pt is not None and _jac_mul(pt, R, _fq2) is not None:
        raise ValueError("G2 point not in the prime-order subgroup")
    return pt


# ---------------------------------------------------------------------------
# Hash-to-G2 (try-and-increment; benchmarking-grade, not RFC 9380)
# ---------------------------------------------------------------------------

# G2 lives on a sextic twist E'/Fq2. With base trace t = x + 1 (x the
# negative BLS parameter), the Fq2 trace is t2 = t^2 - 2q, the CM part f2
# satisfies t2^2 - 4q^2 = -3 f2^2, and the sextic twists have orders
# q^2 + 1 - (±3 f2 ± t2)/2. The right twist is the r-divisible one; its
# cofactor clears arbitrary curve points into G2. Computed (not hardcoded)
# so a parameter slip fails loudly at import.
def _g2_cofactor():
    t = -BLS_X + 1
    t2 = t * t - 2 * Q
    f2_sq, rem = divmod(4 * Q * Q - t2 * t2, 3)
    assert rem == 0
    import math

    f2 = math.isqrt(f2_sq)
    assert f2 * f2 == f2_sq
    for trace in ((3 * f2 + t2) // 2, (3 * f2 - t2) // 2,
                  (-3 * f2 + t2) // 2, (-3 * f2 - t2) // 2):
        order = Q * Q + 1 - trace
        if order % R == 0:
            return order // R
    raise AssertionError("no r-divisible sextic twist order")


_G2_COFACTOR = _g2_cofactor()


def _fq2_sqrt(a):
    """Square root in Fq2 (q^2 = 9 mod 16 branch handled via the generic
    Tonelli-style candidates)."""
    # candidate a^((q^2+7)/16) times one of the 8th roots of unity
    c = _fq2_pow(a, (Q * Q + 7) // 16)
    for mul in _SQRT_CANDS:
        cand = fq2_mul(c, mul)
        if fq2_mul(cand, cand) == a:
            return cand
    return None


def _fq2_pow(x, n):
    result = FQ2_ONE
    base = x
    while n:
        if n & 1:
            result = fq2_mul(result, base)
        base = fq2_mul(base, base)
        n >>= 1
    return result


# 8th roots of unity in Fq2 (candidates for sqrt adjustment)
_SQRT_CANDS = [
    (1, 0),
    _fq2_pow((1, 1), (Q * Q - 1) // 8) if Q else (1, 0),
]
_SQRT_CANDS.append(fq2_mul(_SQRT_CANDS[1], _SQRT_CANDS[1]))
_SQRT_CANDS.append(fq2_mul(_SQRT_CANDS[2], _SQRT_CANDS[1]))


def hash_to_g2(msg: bytes):
    """Deterministic map msg -> G2 subgroup point (try-and-increment +
    cofactor clearing).  Memoized by the message bytes: a committee
    signs and checks one digest several times a round (each replica's
    OP_BLS_SIGN, then the QC), and the cofactor multiplication is most
    of a call.  The point is immutable and a pure function of the bytes,
    so a hit returns the same point.  (The reference computes it every
    call: a departure of the code, not of the result.)"""
    return _hash_to_g2_cached(bytes(msg))


@functools.lru_cache(maxsize=4096)
def _hash_to_g2_cached(msg: bytes):
    return _hash_to_g2_uncached(msg)


def _hash_to_g2_uncached(msg: bytes):
    counter = 0
    while True:
        h = hashlib.sha512(b"BLS_H2G2" + counter.to_bytes(4, "big")
                           + msg).digest()
        x0 = int.from_bytes(h[:32], "big") % Q
        x1 = int.from_bytes(h[32:], "big") % Q
        x = (x0, x1)
        y2 = fq2_add(fq2_mul(fq2_mul(x, x), x), _fq2.b)
        y = _fq2_sqrt(y2)
        if y is not None:
            pt = _jac_mul((x, y), _G2_COFACTOR, _fq2)
            if pt is not None:
                return pt
        counter += 1


# ---------------------------------------------------------------------------
# BLS signatures (pk in G1, sig in G2 — the reference's production bench
# convention, off-chain-benchmarking/production/src/main.rs)
# ---------------------------------------------------------------------------

def key_gen(seed: bytes | None = None):
    if seed is None:
        sk = secrets.randbelow(R - 1) + 1
    else:
        sk = int.from_bytes(hashlib.sha512(seed).digest(), "big") % (R - 1) + 1
    return sk, g1_mul(g1_generator(), sk)


def sign(sk: int, msg: bytes):
    return g2_mul(hash_to_g2(msg), sk)


def verify(pk, msg: bytes, sig) -> bool:
    """e(g1, sig) == e(pk, H(m))  <=>  e(-g1, sig) * e(pk, H(m)) == 1."""
    if sig is None or not g2_on_curve(sig):
        return False
    f = multi_pairing([
        (g1_neg(g1_generator()), sig),
        (pk, hash_to_g2(msg)),
    ])
    return f == FQ12_ONE


def aggregate(sigs):
    agg = None
    for sig in sigs:
        agg = g2_add(agg, sig)
    return agg


def verify_aggregate(pks, msgs, agg_sig) -> bool:
    """Distinct messages: prod e(pk_i, H(m_i)) == e(g1, agg)."""
    if len(pks) != len(msgs):
        return False  # zip would silently verify a different statement
    if agg_sig is None or not g2_on_curve(agg_sig):
        return False
    pairs = [(g1_neg(g1_generator()), agg_sig)]
    pairs += [(pk, hash_to_g2(msg)) for pk, msg in zip(pks, msgs)]
    return multi_pairing(pairs) == FQ12_ONE


def verify_aggregate_common(pks, msg: bytes, agg_sig) -> bool:
    """Common message: aggregate the public keys first — 2 Miller loops
    regardless of signer count (the fast path the reference's bls branch
    uses for QC verification)."""
    if agg_sig is None or not g2_on_curve(agg_sig):
        return False
    apk = None
    for pk in pks:
        apk = g1_add(apk, pk)
    f = multi_pairing([
        (g1_neg(g1_generator()), agg_sig),
        (apk, hash_to_g2(msg)),
    ])
    return f == FQ12_ONE
