"""Ed25519 curve operations and batched signature verification in
PyTorch: the port of hotstuff_tpu/ops/ed25519.py.

The device receives raw scalar and point bytes (hashing and encoding
checks stay on the host, crypto/eddsa.py) and returns a per-signature
validity mask (the per-signature program) or one verdict for a whole
batch (the random-linear-combination program).  Points are dense
(..., 4, 32) int32 tensors, extended (X, Y, Z, T) or cached
(Y+X, Y-X, Z, 2dT), and every formula keeps the reference's op order,
so intermediate limbs equal the JAX package's.

The check [S]B - [k]A == R splits into a fixed-base comb for [S]B (32
additions against a host-built table) and a 4-bit windowed ladder for
[k](-A) (64 steps of four doublings and one addition).  The RLC check
collapses a batch to one multi-scalar multiply whose window sums run in
kernel K3 (ops/kern/msm_accum), and its scalar work mod L in the two
scalar_rlc kernels (ops/kern/scalar_rlc).  Each whole loop (ladder,
comb, Horner, decompression, the 16-entry tables) is one launch of a
point-chain kernel (ops/kern/point_chain); the formulas below are their
plain versions' building blocks and serve the few operations left
outside.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field25519 as F
from ..utils.intmath import BX, BY, D, L, P, SQRT_M1, next_pow2
from .kern import point_chain as PC
from .kern.msm_accum import msm_window_accum
from .kern.scalar_rlc import rlc_reduce, rlc_scalars

K2D = (2 * D) % P


def _const(x: int, like: torch.Tensor) -> torch.Tensor:
    return F.constant(x, like.device)


# ---------------------------------------------------------------------------
# Point representation helpers
# ---------------------------------------------------------------------------

def _pack(x, y, z, t):
    return torch.stack([x, y, z, t], dim=-2)


def _unpack(p):
    return p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]


def identity_ext(batch_shape=(), device="cpu") -> torch.Tensor:
    one, zero = F.constant(1, device), F.constant(0, device)
    return _pack(zero, one, one, zero).expand(*batch_shape, 4, F.NLIMBS)


def basepoint_ext(device="cpu") -> torch.Tensor:
    c = lambda v: F.constant(v, device)  # noqa: E731
    return _pack(c(BX), c(BY), c(1), c(BX * BY % P))


def to_cached(p: torch.Tensor) -> torch.Tensor:
    return _pack(*to_cached_t(_unpack(p)))


def point_add(p: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
    """Complete unified addition, ext + cached -> ext (8 field muls;
    add-2008-hwcd-3 for a = -1)."""
    return _pack(*add_t(_unpack(p), _unpack(qc)))


def point_dbl(p: torch.Tensor, with_t: bool = True) -> torch.Tensor:
    """Dedicated doubling (dbl-2008-hwcd, a = -1): 4M + 4S; with_t=False
    skips the T output (legal when the next consumer is a doubling) and
    returns T as zeros."""
    x1, y1, z1, _ = _unpack(p)
    out = dbl_t((x1, y1, z1), with_t=with_t)
    if with_t:
        return _pack(*out)
    return _pack(*out, torch.zeros_like(x1))


# ---------------------------------------------------------------------------
# Decompression (x-recovery)
# ---------------------------------------------------------------------------

def decompress_t(y_limbs: torch.Tensor, sign_bit: torch.Tensor, mul=F.mul):
    """(..., 32) canonical y limbs + (...,) sign bit ->
    ((x, y, z, t) tuple, ok mask): RFC 8032 section 5.1.3 x-recovery,
    x = u v^3 (u v^7)^((p-5)/8) with u = y^2 - 1, v = d y^2 + 1.
    ``mul`` as in ``to_cached_t``; the verify programs run this as the
    decompress kernel (``decompress``)."""
    one = _const(1, y_limbs).expand_as(y_limbs)
    dd = _const(D, y_limbs).expand_as(y_limbs)
    y2 = mul(y_limbs, y_limbs)
    u = F.sub(y2, one)
    v = F.add(mul(dd, y2), one)
    v3 = mul(mul(v, v), v)
    v7 = mul(mul(v3, v3), v)
    x = mul(mul(u, v3), F.pow_p58(mul(u, v7), mul=mul))
    vxx = mul(v, mul(x, x))
    ok_direct = F.eq(vxx, u)
    ok_twist = F.eq(vxx, F.neg(u))
    x = torch.where(ok_twist.unsqueeze(-1),
                    mul(x, _const(SQRT_M1, x).expand_as(x)), x)
    ok = ok_direct | ok_twist
    # sign adjustment; x == 0 with sign 1 is invalid
    x_zero = F.is_zero(x)
    flip = (F.parity(x) != sign_bit) & ~x_zero
    x = torch.where(flip.unsqueeze(-1), F.neg(x), x)
    ok = ok & ~(x_zero & (sign_bit == 1))
    t = mul(x, y_limbs)
    z = one
    return (x, y_limbs, z, t), ok


def decompress(y_limbs: torch.Tensor, sign_bit: torch.Tensor):
    """(B, 32) y limbs + (B,) sign bits -> ((B, 4, 32) ext, (B,) ok):
    decompress_t in one launch of the decompress kernel."""
    return PC.decompress(y_limbs.contiguous(),
                         sign_bit.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# Tuple-layout point ops
# ---------------------------------------------------------------------------

def identity_t(batch_shape=(), device="cpu"):
    one = F.constant(1, device).expand(*batch_shape, F.NLIMBS)
    zero = F.constant(0, device).expand(*batch_shape, F.NLIMBS)
    return (zero, one, one, zero)


def to_cached_t(p, mul=F.mul):
    """(x, y, z, t) -> cached (y+x, y-x, z, 2d*t).  ``mul`` is the field
    multiply: the plain versions of K3 and the point-chain kernels pass
    K1's plain version, so that they launch no kernel on the card."""
    x, y, z, t = p
    k2d = _const(K2D, t).expand_as(t)
    return (F.add(y, x), F.sub(y, x), z, mul(t, k2d))


def add_t(p, qc, mul=F.mul):
    """Complete unified addition on tuples: ext + cached -> ext (8 muls);
    ``mul`` as in ``to_cached_t``."""
    x1, y1, z1, t1 = p
    ypx2, ymx2, z2, t2d2 = qc
    a = mul(F.sub(y1, x1), ymx2)
    b = mul(F.add(y1, x1), ypx2)
    c = mul(t1, t2d2)
    zz = mul(z1, z2)
    d = F.add(zz, zz)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return (mul(e, f), mul(g, h), mul(f, g), mul(e, h))


def dbl_t(p, with_t: bool = True, mul=F.mul):
    """Doubling on tuples (dbl-2008-hwcd, a = -1): 4M+4S (3M+4S without
    T).  Accepts (x, y, z) or (x, y, z, t); returns a 3-tuple when
    with_t=False.  ``mul`` as in ``to_cached_t``."""
    x1, y1, z1 = p[0], p[1], p[2]
    a = mul(x1, x1)
    b = mul(y1, y1)
    zz = mul(z1, z1)
    c = F.add(zz, zz)
    s = F.add(x1, y1)
    e = F.sub(F.sub(mul(s, s), a), b)   # 2*X1*Y1
    g = F.sub(b, a)
    f = F.sub(g, c)
    h = F.neg(F.add(a, b))
    if with_t:
        return (mul(e, f), mul(g, h), mul(f, g), mul(e, h))
    return (mul(e, f), mul(g, h), mul(f, g))


# ---------------------------------------------------------------------------
# Fixed-base comb table for S*B (host-built, cached per device)
# ---------------------------------------------------------------------------

_COMB_POSITIONS = 32  # one comb position per S byte
COMB_SHAPE = (_COMB_POSITIONS, 256, 4, F.NLIMBS)

_comb_host: np.ndarray | None = None
_comb_device: dict = {}


def drop_device_tables() -> None:
    """Forget the device copies of the comb tables: the next call places
    fresh ones.  The dict is rebound, not cleared, so a launch still
    holding the old tensors never shares them with the next one (the
    sidecar's crash-only reboot)."""
    global _comb_device
    _comb_device = {}


def _host_pt_add(p, q):
    """Extended-coordinate add on python ints (table generation only)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def comb_table() -> np.ndarray:
    """(32, 256, 4, 32) int32 on the host: COMB[j][d] = cached affine form
    of d*(256^j)*B.  S*B = sum_j COMB[j][S_byte_j], 31 additions and no
    doublings.  Built once (~8k python point adds and one batched
    inversion)."""
    global _comb_host
    if _comb_host is not None:
        return _comb_host
    base = (BX, BY, 1, BX * BY % P)
    entries = []  # flat ext points, position-major
    for _ in range(_COMB_POSITIONS):
        acc = (0, 1, 1, 0)
        for _ in range(256):
            entries.append(acc)
            acc = _host_pt_add(acc, base)
        base = acc  # 256^{j+1} * B
    # Batch affine normalization: one modular inverse total.
    zs = [e[2] for e in entries]
    prefix = [1]
    for z in zs:
        prefix.append(prefix[-1] * z % P)
    inv_all = pow(prefix[-1], P - 2, P)
    invs = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        invs[i] = prefix[i] * inv_all % P
        inv_all = inv_all * zs[i] % P
    out = np.zeros(COMB_SHAPE, np.int32)
    for idx, ((x, y, _, _), zi) in enumerate(zip(entries, invs)):
        xa, ya = x * zi % P, y * zi % P
        j, d = divmod(idx, 256)
        out[j, d, 0] = F.to_limbs((ya + xa) % P)
        out[j, d, 1] = F.to_limbs((ya - xa) % P)
        out[j, d, 2] = F.to_limbs(1)
        out[j, d, 3] = F.to_limbs(K2D * xa * ya % P)
    _comb_host = out
    return out


def _device_key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def comb_table_from_numpy(arr, device) -> torch.Tensor:
    """Install a comb table built elsewhere (the JAX package's
    ``comb_table()`` array) as this device's table, and return it."""
    arr = np.asarray(arr)
    if arr.shape != COMB_SHAPE:
        raise ValueError(f"comb table must be {COMB_SHAPE}, got {arr.shape}")
    dev = _device_key(device)
    t = torch.as_tensor(arr.astype(np.int32), device=dev)
    _comb_device[dev] = t
    return t


def comb_table_on(device) -> torch.Tensor:
    """The comb table as a tensor on ``device`` (copied there once)."""
    dev = _device_key(device)
    t = _comb_device.get(dev)
    if t is None:
        t = comb_table_from_numpy(comb_table(), dev)
    return t


# ---------------------------------------------------------------------------
# Batched verification: the per-signature program
# ---------------------------------------------------------------------------

def unpack_nibbles_msb(k_bytes: torch.Tensor) -> torch.Tensor:
    """(B, 32) little-endian scalar bytes -> (B, 64) int32 MSB-first
    4-bit digits."""
    b = k_bytes.to(torch.int32).flip(-1)  # big-endian byte order
    return torch.stack([b >> 4, b & 0xF], dim=-1).reshape(
        *b.shape[:-1], 64)


def split_y_sign(y_bytes: torch.Tensor):
    """(B, 32) compressed point bytes -> ((B, 32) int32 y limbs with bit
    255 cleared, (B,) int32 x-sign bit)."""
    y = y_bytes.to(torch.int32)
    sign = y[..., 31] >> 7
    y = torch.cat([y[..., :31], y[..., 31:] & 0x7F], dim=-1)
    return y, sign


def verify_compact(a_bytes: torch.Tensor, r_bytes: torch.Tensor,
                   s_bytes: torch.Tensor, k_bytes: torch.Tensor):
    """Verification from raw bytes (all (B, 32) uint8): compressed A,
    compressed R, S little-endian, and the host-hashed challenge
    k = SHA512(R||A||M) mod L.  Returns the (B,) bool mask (host-side
    canonicality checks are ANDed by the caller)."""
    ay, a_sign = split_y_sign(a_bytes)
    ry, r_sign = split_y_sign(r_bytes)
    s_digits = s_bytes.to(torch.int32)  # little-endian bytes = comb digits
    k_digits = unpack_nibbles_msb(k_bytes)
    return verify_prepared(ay, a_sign, ry, r_sign, s_digits, k_digits)


def verify_packed(packed: torch.Tensor) -> torch.Tensor:
    """(B, 128) uint8 rows of A || R || S || k -> (B,) bool mask."""
    return verify_compact(packed[..., 0:32], packed[..., 32:64],
                          packed[..., 64:96], packed[..., 96:128])


def verify_packed_chunked(packed_g: torch.Tensor) -> torch.Tensor:
    """(G, B, 128) uint8 -> (G, B) bool: G sub-batches verified one after
    another."""
    return torch.stack([verify_packed(chunk) for chunk in packed_g])


def verify_prepared(ay, a_sign, ry, r_sign, s_digits, k_digits):
    """[S]B - [k]A == R over a batch: one joint decompression of A and
    R, the windowed ladder for [k](-A), the comb for [S]B, one combining
    addition and a projective compare against R.

    Args: ay, ry (B, 32) int32 canonical y limbs; a_sign, r_sign (B,)
    int32 x-parity bits; s_digits (B, 32) int32 base-256 digits of S;
    k_digits (B, 64) int32 MSB-first base-16 digits of k.
    Returns the (B,) bool validity mask."""
    n = ay.shape[0]
    both_pt, ok_both = decompress(torch.cat([ay, ry], dim=0),
                                  torch.cat([a_sign, r_sign], dim=0))
    ok_a, ok_r = ok_both[:n], ok_both[n:]

    # -- variable-base half: [k](-A), 4-bit windows -------------------------
    # The cached 16-entry table of d*(-A), then 64 steps of four
    # doublings and one addition: one launch each.
    table = PC.point_multiples(both_pt[:n], cached=True, negate=True)
    ka_pt = PC.point_ladder(table.unsqueeze(1),
                            k_digits.to(torch.int32).contiguous(), 4)

    # -- fixed-base half: [S]B via the comb ---------------------------------
    sb_pt = PC.point_ladder(comb_table_on(ay.device).unsqueeze(0),
                            s_digits.to(torch.int32).contiguous(), 0)

    lhs = point_add(sb_pt, to_cached(ka_pt))
    x3, y3, z3, _ = _unpack(lhs)
    rx, ry_, rz, _ = _unpack(both_pt[n:])

    # -- projective equality: all four cross-products in one multiply ------
    cross = F.canonical(F.mul(_pack(x3, rx, y3, ry_),
                              _pack(rz, z3, rz, z3)))
    ok_eq = torch.all(cross[..., 0, :] == cross[..., 1, :], dim=-1) & \
        torch.all(cross[..., 2, :] == cross[..., 3, :], dim=-1)
    return ok_a & ok_r & ok_eq


# ---------------------------------------------------------------------------
# Random-linear-combination batch verification: one multi-scalar multiply
# ---------------------------------------------------------------------------
#
# With random coefficients z_i the batch collapses to one equation,
#
#     [sum z_i S_i mod L] B  ==  sum [z_i] R_i  +  sum [z_i k_i mod L] A_i,
#
# whose right side is a 2n-point MSM (Straus, shared 4-bit windows):
# per-point 16-entry tables, per-window selection and a binary-tree fold
# (kernel K3), a 64-step Horner combination and the comb for [c]B.

def msm_table(points: torch.Tensor) -> torch.Tensor:
    """(B, 4, 32) ext points -> (B, 16, 4, 32) ext table of 0..15
    multiples (entry 0 is the identity), in one launch."""
    return PC.point_multiples(points.contiguous())


def _tree_sum(pts: torch.Tensor, mul=F.mul) -> torch.Tensor:
    """(M, ..., 4, 32) ext -> (..., 4, 32): binary tree of point adds over
    the leading axis (M a power of two; identity entries make padding
    free), in the reference's halving order, so the limbs equal its.
    The mesh's RLC program combines the shards' window sums with it;
    ``mul`` as in ``to_cached_t`` (K1's plain version makes this the
    plain version)."""
    m = pts.shape[0]
    while m > 1:
        m //= 2
        pts = _pack(*add_t(_unpack(pts[:m]),
                           to_cached_t(_unpack(pts[m:]), mul), mul))
    return pts[0]


def msm_window_sums(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Per-window sums of a Straus MSM: (64, 4, 32) ext points W_j with
    sum_i [s_i]P_i = sum_j 16^(63-j) W_j (windows MSB-first).  B is
    padded to a power of two with identity points."""
    b = points.shape[0]
    b_pad = next_pow2(b)
    if b_pad != b:
        points = torch.cat(
            [points, identity_ext((b_pad - b,), points.device)], dim=0)
        digits = torch.nn.functional.pad(digits, (0, 0, 0, b_pad - b))
    table = msm_table(points).contiguous()           # (B, 16, 4, 32)
    return msm_window_accum(table, digits.to(torch.int32).contiguous())


def msm_horner(wsums: torch.Tensor) -> torch.Tensor:
    """(64, 4, 32) MSB-first window sums -> (4, 32) ext total: 64 steps
    of 4 doublings + 1 addition at batch 1, in one ladder launch whose
    table holds one cached window sum per step (to_cached of all 64 at
    once gives the limbs that 64 separate calls would)."""
    table = to_cached(wsums).reshape(1, 64, 1, 4, F.NLIMBS)
    digits = torch.zeros((1, 64), dtype=torch.int32, device=wsums.device)
    return PC.point_ladder(table, digits, 4)[0]


def comb_mul_base(c_digits: torch.Tensor) -> torch.Tensor:
    """[c]B for one scalar given as (32,) int32 base-256 little-endian
    digits: the fixed-base comb at batch 1, in one ladder launch."""
    return PC.point_ladder(comb_table_on(c_digits.device).unsqueeze(0),
                           c_digits.to(torch.int32).reshape(1, -1), 0)[0]


def rlc_partials(packed: torch.Tensor, z: torch.Tensor):
    """The per-row half of the RLC check.

    Args:
      packed: (B, 128) uint8 rows of A || R || S || k.
      z:      (B, 32) uint8 canonical coefficient rows; an all-zero row
              is excluded (bucket padding, host-rejected votes).
    Returns (wsums (64, 4, 32), u_sum (32,) int32 limb-wise sum of the
    z_i*S_i mod L terms, bad () int32 count of included rows whose A or
    R failed decompression)."""
    ay, a_sign = split_y_sign(packed[..., 0:32])
    ry, r_sign = split_y_sign(packed[..., 32:64])
    s_l = packed[..., 64:96].to(torch.int32).contiguous()
    k_l = packed[..., 96:128].to(torch.int32).contiguous()
    z_l = z.to(torch.int32).contiguous()

    present = torch.any(z_l != 0, dim=-1)
    # A points first, R points second, matching the digit order of
    # rlc_scalars.
    pts, ok = decompress(torch.cat([ay, ry], dim=0),
                         torch.cat([a_sign, r_sign], dim=0))
    present2 = torch.cat([present, present], dim=0)
    bad = torch.sum(~ok & present2).to(torch.int32)

    # w = z k mod L and u = z S mod L, then the torsion-exact CRT lift to
    # the full-group exponent 8L: A's scalar to w' = w (mod L), w' = k
    # (mod 8); R's to z' = z (mod L), z' = 1 (mod 8), so every row's
    # torsion defect enters the sum with the coefficient the
    # per-signature equation uses (L = 5 mod 8, and 5 is its own inverse
    # mod 8; excluded rows keep scalar 0).  One launch: digits of
    # [w'; z'] for the MSM, and u.
    digits, u = rlc_scalars(z_l, k_l, s_l)
    wsums = msm_window_sums(pts, digits)
    return wsums, torch.sum(u, dim=-2, dtype=torch.int32), bad


def rlc_finish(wsums: torch.Tensor, u_limbsum: torch.Tensor,
               bad: torch.Tensor) -> torch.Tensor:
    """Combine RLC partials into the () bool verdict: Horner-fold the
    window sums, comb [c]B from the reduced scalar sum, compare
    projectively, and veto on any bad point."""
    c = rlc_reduce(u_limbsum)
    msm = msm_horner(wsums)            # sum [w_i]A_i + [z_i]R_i
    cb = comb_mul_base(c)              # [c]B

    x1, y1, z1, _ = _unpack(cb)
    x2, y2, z2, _ = _unpack(msm)
    cross = F.canonical(F.mul(_pack(x1, x2, y1, y2),
                              _pack(z2, z1, z2, z1)))
    eq = torch.all(cross[..., 0, :] == cross[..., 1, :], dim=-1) & \
        torch.all(cross[..., 2, :] == cross[..., 3, :], dim=-1)
    return (bad == 0) & eq


def verify_rlc_packed(packed: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(B, 128) uint8 rows + (B, 32) uint8 coefficient rows -> () bool:
    the whole batch passes the combined check (vacuously True when every
    row is excluded)."""
    return rlc_finish(*rlc_partials(packed, z))
