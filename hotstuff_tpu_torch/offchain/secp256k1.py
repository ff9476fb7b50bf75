"""secp256k1 curve arithmetic + ECDSA + Schnorr (host reference): the
port's copy of hotstuff_tpu/offchain/secp256k1.py.

The reference's off-chain suite benchmarks "EdDSA"/Schnorr/ECDSA over
petlib's EcGroup(714) = secp256k1 (off-chain-benchmarking/eddsa.py:7,
schnorr.py, ecdsa.py). petlib is not in this image, so this module is the
self-contained arithmetic those schemes run on: Jacobian point ops over the
256-bit prime field, ECDSA with RFC 6979-style deterministic nonces, and a
hash-challenge Schnorr matching the reference's scheme shape
(off-chain-benchmarking/schnorr.py: R = kG, e = H(R||P||m), s = k + e*d).
"""

from __future__ import annotations

import hashlib
import hmac

# Curve: y^2 = x^3 + 7 over F_p
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B = 7

# Affine points are (x, y) tuples; None is the identity.


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def point_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def point_mul(k: int, p=None):
    """k*P via Jacobian double-and-add (affine in/out)."""
    if p is None:
        p = (GX, GY)
    k %= N
    if k == 0:
        return None
    # Jacobian coordinates: (X, Y, Z), x = X/Z^2, y = Y/Z^3
    def jdbl(q):
        X, Y, Z = q
        if Y == 0:
            return (0, 1, 0)
        S = 4 * X * Y * Y % P
        M = 3 * X * X % P
        X2 = (M * M - 2 * S) % P
        Y2 = (M * (S - X2) - 8 * Y * Y * Y * Y) % P
        Z2 = 2 * Y * Z % P
        return (X2, Y2, Z2)

    def jadd(q, a):  # q jacobian, a affine
        X1, Y1, Z1 = q
        if Z1 == 0:
            return (a[0], a[1], 1)
        x2, y2 = a
        Z1Z1 = Z1 * Z1 % P
        U2 = x2 * Z1Z1 % P
        S2 = y2 * Z1Z1 * Z1 % P
        if U2 == X1:
            if S2 != Y1:
                return (0, 1, 0)
            return jdbl(q)
        H = (U2 - X1) % P
        HH = H * H % P
        I = 4 * HH % P
        J = H * I % P
        r = 2 * (S2 - Y1) % P
        V = X1 * I % P
        X3 = (r * r - J - 2 * V) % P
        Y3 = (r * (V - X3) - 2 * Y1 * J) % P
        Z3 = 2 * Z1 * H % P
        return (X3, Y3, Z3)

    acc = (0, 1, 0)
    for bit in bin(k)[2:]:
        acc = jdbl(acc)
        if bit == "1":
            acc = jadd(acc, p)
    X, Y, Z = acc
    if Z == 0:
        return None
    zinv = _inv(Z, P)
    z2 = zinv * zinv % P
    return (X * z2 % P, Y * z2 * zinv % P)


def on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B) % P == 0


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def point_encode(p) -> bytes:
    """SEC1 compressed (33 bytes)."""
    if p is None:
        return b"\x00"
    x, y = p
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def point_decode(data: bytes):
    if data == b"\x00":
        return None
    if len(data) != 33 or data[0] not in (2, 3):
        raise ValueError("bad point encoding")
    x = int.from_bytes(data[1:], "big")
    if x >= P:
        raise ValueError("x out of range")
    y2 = (pow(x, 3, P) + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("not on curve")
    if (y & 1) != (data[0] & 1):
        y = P - y
    return (x, y)


# ---------------------------------------------------------------------------
# key generation
# ---------------------------------------------------------------------------

def key_gen(seed: bytes | None = None):
    """-> (sk int, pk point). Deterministic from seed when given."""
    if seed is None:
        import secrets

        d = secrets.randbelow(N - 1) + 1
    else:
        d = int.from_bytes(hashlib.sha512(seed).digest(), "big") % (N - 1) + 1
    return d, point_mul(d)


def _hash_int(*parts: bytes) -> int:
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "big")


# ---------------------------------------------------------------------------
# ECDSA (off-chain-benchmarking/ecdsa.py capability)
# ---------------------------------------------------------------------------

def _rfc6979_k(d: int, h1: bytes) -> int:
    """Deterministic nonce (RFC 6979, SHA-256)."""
    V = b"\x01" * 32
    K = b"\x00" * 32
    x = d.to_bytes(32, "big")
    K = hmac.new(K, V + b"\x00" + x + h1, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    K = hmac.new(K, V + b"\x01" + x + h1, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    while True:
        V = hmac.new(K, V, hashlib.sha256).digest()
        k = int.from_bytes(V, "big")
        if 1 <= k < N:
            return k
        K = hmac.new(K, V + b"\x00", hashlib.sha256).digest()
        V = hmac.new(K, V, hashlib.sha256).digest()


def ecdsa_sign(d: int, msg: bytes):
    h1 = hashlib.sha256(msg).digest()
    z = int.from_bytes(h1, "big") % N
    while True:
        k = _rfc6979_k(d, h1)
        R = point_mul(k)
        r = R[0] % N
        if r == 0:
            continue
        s = _inv(k, N) * (z + r * d) % N
        if s == 0:
            continue
        if s > N // 2:  # low-s normalization
            s = N - s
        return (r, s)


def ecdsa_verify(pk, msg: bytes, sig) -> bool:
    r, s = sig
    if not (1 <= r < N and 1 <= s < N) or pk is None or not on_curve(pk):
        return False
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % N
    w = _inv(s, N)
    u1, u2 = z * w % N, r * w % N
    pt = point_add(point_mul(u1), point_mul(u2, pk))
    return pt is not None and pt[0] % N == r


def ecdsa_sig_to_der(sig) -> bytes:
    """DER encoding (for cross-checks against OpenSSL)."""
    def int_der(v):
        b = v.to_bytes((v.bit_length() + 8) // 8 or 1, "big")
        return b"\x02" + bytes([len(b)]) + b

    body = int_der(sig[0]) + int_der(sig[1])
    return b"\x30" + bytes([len(body)]) + body


# ---------------------------------------------------------------------------
# Schnorr (off-chain-benchmarking/schnorr.py capability; also what that
# repo's "eddsa.py" actually implements over secp256k1)
# ---------------------------------------------------------------------------

def schnorr_sign(d: int, msg: bytes, nonce_seed: bytes | None = None):
    """R = kG, e = H(R || P || m), s = k + e*d  ->  (R point, s int)."""
    pk = point_mul(d)
    seed = nonce_seed or (d.to_bytes(32, "big") + msg)
    k = int.from_bytes(hashlib.sha512(seed).digest(), "big") % (N - 1) + 1
    R = point_mul(k)
    e = _hash_int(point_encode(R), point_encode(pk), msg) % N
    s = (k + e * d) % N
    return (R, s)


def schnorr_verify(pk, msg: bytes, sig) -> bool:
    R, s = sig
    if R is None or not on_curve(R) or not (0 <= s < N):
        return False
    if pk is None or not on_curve(pk):
        return False
    e = _hash_int(point_encode(R), point_encode(pk), msg) % N
    # sG == R + eP
    return point_mul(s) == point_add(R, point_mul(e, pk))
