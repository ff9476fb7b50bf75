"""The BLS12-381 check on the Fq12 tower, in fused kernels
(csrc/fq12_tower.cu, on csrc/fq12w.cuh and the 32-bit-word field of
csrc/fq381w.cuh); a pairing check is miller_accumulate, then final_exp:

  final_exp          (rows, P, 12, 48) Miller values -> the verdicts
                     (rows,) (their product raised to (q^12 - 1) / r is
                     one) and that power (rows, 12, 48): the P - 1
                     products, the easy part with its inverse taken down
                     the tower to one Fq inversion, the hard part's chain
                     and the test for one, in one launch
  fq12_hard_pow      (rows, 12, 48) -> f^((q^4 - q^2 + 1) / r) for f in
                     the cyclotomic subgroup: the final exponentiation's
                     hard part as the exact chain in x = -BLS_X
  miller_accumulate  (rows, S, 2, 12, 48) Miller lines -> (rows, 12, 48):
                     all S steps of f <- f^2 l0 l1 from f = 1, a line
                     equal to one skipped, a sparse one taken by the
                     sparse product
  fq12_product       (n, 12, 48) -> (12, 48): the product of n values,
                     final_exp's first stage alone (a mesh shard's fold
                     of its Miller values before one element crosses to
                     the lead)

Inputs are the reference's flat Fq12 elements (bls381: sum a_k w^k
modulo w^12 - 2w^6 + 2, Montgomery limbs in any weak form with
nonnegative limbs); outputs are the same residues in canonical limbs
(each below 256, value below q), the representative the word kernels
produce.  So the plain version and the kernel compare limb for limb, and
against the JAX package the comparison is field381.canonical of its
output.

The tower is Fq2 = Fq[u]/(u^2 + 1), Fq6 = Fq2[v]/(v^3 - (1 + u)), Fq12
= Fq6[w]/(w^2 - v); Fq value 6i + 2j + l of an element is the u^l part of
the v^j coefficient of w^i, and the flat basis maps in by additions (u =
w^6 - 1, v = w^2).  Each of its products is bilinear -- K Fq products of
signed sums of the inputs, then 12 signed sums of the products -- so the
tower formulas below run once, on symbols, at import, and leave three
integer matrices per product (``OPS``): the Karatsuba product (54
products), the complex square (36), the product by a sparse Miller line
(42), the two Frobenius maps (18 and 12 products by constants), and the
two steps of the Fq6 inverse (18 and 9), and the cyclotomic square of
the hard part (18, whose outputs also take terms of the input).
The kernel evaluates those matrices from a table (``PROGRAM``), and the
plain version applies the same matrices with field381's plain operators,
so the two run the same algorithm.  final_exp and fq12_hard_pow run the
hard part on csrc/fq12_lanes.cuh, each Fq product of its steps split
across a group of lanes; miller_accumulate and fq12_product run every
step on csrc/fq12w.cuh, one product a thread.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
version on a CPU one.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import field381 as F
from ...offchain import bls12381 as host
from . import (build, check_int32, check_launch, count_launch, on_card,
                stream_of)
from .fq12_chain import fq_pow_plain

Q = F.Q
BLS_X = host.BLS_X           # |x|; the BLS parameter is x = -BLS_X
NLIMBS = F.NLIMBS
FQ12 = 12

# ---------------------------------------------------------------------------
# The chain's exponents
# ---------------------------------------------------------------------------

# (q^4 - q^2 + 1) / r = ((x - 1)^2 / 3) (x + q) (x^2 + q^2 - 1) + 1 with
# x = -BLS_X: the hard part as powers by |x|, Frobenius maps and
# conjugations (which invert in the cyclotomic subgroup), exactly -- not
# its cube, whose verdict is the same but whose value is not.
HARD_EXP = (Q ** 4 - Q ** 2 + 1) // host.R
_X = -BLS_X
assert (_X - 1) ** 2 % 3 == 0
E1 = (_X - 1) ** 2 // 3
assert E1 * (_X + Q) * (_X * _X + Q * Q - 1) + 1 == HARD_EXP
assert (Q ** 4 - Q ** 2 + 1) % host.R == 0
E1_WIDTH = 4
E1_DIGITS = F.exponent_digits(E1, E1_WIDTH)      # 32 digits, 126 bits
X_DIGITS = F.exponent_digits(BLS_X, 1)           # 64 bits, 6 set

# ---------------------------------------------------------------------------
# The tower formulas, generic over a base type with +, - and *
# ---------------------------------------------------------------------------


def _f2(op, a, b):
    return tuple(op(x, y) for x, y in zip(a, b))


def _add(a, b):
    return _f2(lambda x, y: x + y, a, b)


def _sub(a, b):
    return _f2(lambda x, y: x - y, a, b)


def _fq2_mul(a, b):
    """Karatsuba: 3 products."""
    v0, v1 = a[0] * b[0], a[1] * b[1]
    return (v0 - v1, (a[0] + a[1]) * (b[0] + b[1]) - v0 - v1)


def _fq2_nr(a):
    """Times the non-residue xi = 1 + u."""
    return (a[0] - a[1], a[0] + a[1])


def _fq2_conj(a):
    return (a[0], -a[1])


def _fq6_add(a, b):
    return tuple(_add(x, y) for x, y in zip(a, b))


def _fq6_sub(a, b):
    return tuple(_sub(x, y) for x, y in zip(a, b))


def _fq6_by_v(a):
    return (_fq2_nr(a[2]), a[0], a[1])


def _fq6_mul(a, b):
    """Karatsuba over Fq2 (v^3 = xi): 6 Fq2 products."""
    v0, v1, v2 = (_fq2_mul(a[i], b[i]) for i in range(3))
    c0 = _add(v0, _fq2_nr(_sub(_sub(
        _fq2_mul(_add(a[1], a[2]), _add(b[1], b[2])), v1), v2)))
    c1 = _add(_sub(_sub(_fq2_mul(_add(a[0], a[1]), _add(b[0], b[1])), v0),
                   v1), _fq2_nr(v2))
    c2 = _add(_sub(_sub(_fq2_mul(_add(a[0], a[2]), _add(b[0], b[2])), v0),
                   v2), v1)
    return (c0, c1, c2)


def _fq12_mul(a, b):
    """Karatsuba over Fq6 (w^2 = v): 3 Fq6 products, 54 Fq products."""
    v0, v1 = _fq6_mul(a[0], b[0]), _fq6_mul(a[1], b[1])
    c1 = _fq6_sub(_fq6_sub(_fq6_mul(_fq6_add(a[0], a[1]),
                                    _fq6_add(b[0], b[1])), v0), v1)
    return (_fq6_add(v0, _fq6_by_v(v1)), c1)


def _fq12_sqr(a, b):
    """Complex squaring of a = b (b: the same element, named as the
    second operand, so every product's left factor comes from a and its
    right one from b): 2 Fq6 products, 36 Fq products."""
    p0 = _fq6_mul(a[0], b[1])
    p1 = _fq6_mul(_fq6_add(a[0], a[1]), _fq6_add(b[0], _fq6_by_v(b[1])))
    return (_fq6_sub(_fq6_sub(p1, p0), _fq6_by_v(p0)), _fq6_add(p0, p0))


def _fq2_sqr(a, b):
    """Complex squaring in Fq2 of a = b: (a0 + a1)(a0 - a1) + 2 a0 a1 u,
    2 products."""
    m = a[0] * b[1]
    return ((a[0] + a[1]) * (b[0] - b[1]), m + m)


def _fq4_sqr(ax, bx, ay, by):
    """(a + b s)^2 in Fq4 = Fq2[s]/(s^2 - xi), for a + b s given once from
    each operand: (a^2 + xi b^2, (a + b)^2 - a^2 - b^2), 3 Fq2 squares."""
    t0, t1 = _fq2_sqr(ax, ay), _fq2_sqr(bx, by)
    t2 = _fq2_sqr(_add(ax, bx), _add(ay, by))
    return _add(_fq2_nr(t1), t0), _sub(_sub(t2, t0), t1)


def _fq12_cyc_sqr(x, y):
    """The square of x = y in the cyclotomic subgroup (Granger and Scott,
    PKC 2010): Fq12 as three Fq4 = Fq2[s]/(s^2 - xi) elements (z0, z1),
    (z2, z3), (z4, z5), each squared with 3 Fq2 squares, 18 Fq products;
    each output is 3 t -+ 2 z, so it takes its own input value as a term.
    Equal to the square only in that subgroup."""
    def zs(f):
        return f[0][0], f[1][1], f[1][0], f[0][2], f[0][1], f[1][2]

    zx, zy = zs(x), zs(y)

    def k(c, a):
        return tuple(c * v for v in a)

    t0, t1 = _fq4_sqr(zx[0], zx[1], zy[0], zy[1])
    z0, z1 = _sub(k(3, t0), k(2, zx[0])), _add(k(3, t1), k(2, zx[1]))
    t0, t1 = _fq4_sqr(zx[2], zx[3], zy[2], zy[3])
    t2, t3 = _fq4_sqr(zx[4], zx[5], zy[4], zy[5])
    z4, z5 = _sub(k(3, t0), k(2, zx[4])), _add(k(3, t1), k(2, zx[5]))
    z2 = _add(k(3, _fq2_nr(t3)), k(2, zx[2]))
    z3 = _sub(k(3, t2), k(2, zx[3]))
    return ((z0, z4, z3), (z2, z1, z5))


def _fq12_mul_line(f, l00, l11, l12):
    """f times a line whose only nonzero Fq2 coefficients are c0.0, c1.1
    and c1.2 (flat w^0, w^3, w^5, w^9, w^11): 14 Fq2 products."""
    f0, (x0, x1, x2) = f
    v0 = tuple(_fq2_mul(c, l00) for c in f0)
    t11, t22 = _fq2_mul(x1, l11), _fq2_mul(x2, l12)
    m = _sub(_sub(_fq2_mul(_add(x1, x2), _add(l11, l12)), t11), t22)
    v1 = (_fq2_nr(m), _add(_fq2_mul(x0, l11), _fq2_nr(t22)),
          _add(_fq2_mul(x0, l12), t11))
    v2 = _fq6_mul(_fq6_add(f0, f[1]), (l00, l11, l12))
    return (_fq6_add(v0, _fq6_by_v(v1)), _fq6_sub(_fq6_sub(v2, v0), v1))


def _inv6_abc(c, d):
    """For N = c0 + c1 v + c2 v^2 in Fq6 (c = d = N): (A, B, C) = (c0^2 -
    xi c1 c2, xi c2^2 - c0 c1, c1^2 - c0 c2), N's adjugate, so that N
    (A, B, C) = F, the norm below: 18 Fq products."""
    c0, c1, c2 = c
    d0, d1, d2 = d
    return (_sub(_fq2_mul(c0, d0), _fq2_nr(_fq2_mul(c1, d2))),
            _sub(_fq2_nr(_fq2_mul(c2, d2)), _fq2_mul(c0, d1)),
            _sub(_fq2_mul(c1, d1), _fq2_mul(c0, d2)))


def _inv6_norm(c, abc):
    """N's norm to Fq2, F = c0 A + xi (c2 B + c1 C): 9 Fq products."""
    a, b, cc = abc
    return _add(_fq2_mul(c[0], a), _fq2_nr(_add(_fq2_mul(c[2], b),
                                                 _fq2_mul(c[1], cc))))


def _fq2_index(k: int) -> tuple:
    """Flat Fq2 coefficient k (of w^k, k < 6) -> its tower place (i, j)."""
    return k % 2, k // 2


def _fq12_frob1(f, c):
    """f^q: the Fq2 coefficient of w^k becomes conj(g) xi^(k(q-1)/6);
    c[2k], c[2k+1] hold that constant."""
    out = [[None] * 3 for _ in range(2)]
    for k in range(6):
        i, j = _fq2_index(k)
        out[i][j] = _fq2_mul(_fq2_conj(f[i][j]), (c[2 * k], c[2 * k + 1]))
    return tuple(tuple(r) for r in out)


def _fq12_frob2(f, c):
    """f^(q^2): the coefficient of w^k times xi^(k(q^2-1)/6), an Fq
    constant held in c[2k]."""
    out = [[None] * 3 for _ in range(2)]
    for k in range(6):
        i, j = _fq2_index(k)
        out[i][j] = (f[i][j][0] * c[2 * k], f[i][j][1] * c[2 * k])
    return tuple(tuple(r) for r in out)


def _split(v):
    """12 base values in tower order -> the nested tower element."""
    return tuple(tuple((v[6 * i + 2 * j], v[6 * i + 2 * j + 1])
                       for j in range(3)) for i in range(2))


def _join(t):
    return [t[i][j][l] for i in range(2) for j in range(3) for l in range(2)]


# ---------------------------------------------------------------------------
# The formulas on symbols -> the bilinear matrices
# ---------------------------------------------------------------------------

class _Sym:
    """A signed integer sum of named values: of inputs ('x', i) and ('y',
    i) before a product, of products ('p', k) after one.  Multiplying two
    input sums records a product."""

    def __init__(self, terms: dict, products: list):
        self.terms = {k: v for k, v in terms.items() if v}
        self.products = products

    def __add__(self, other):
        terms = dict(self.terms)
        for k, v in other.terms.items():
            terms[k] = terms.get(k, 0) + v
        return _Sym(terms, self.products)

    def __neg__(self):
        return _Sym({k: -v for k, v in self.terms.items()}, self.products)

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, other):
        assert not any(k[0] == "p" for k in (*self.terms, *other.terms))
        self.products.append((self.terms, other.terms))
        return _Sym({("p", len(self.products) - 1): 1}, self.products)

    def __rmul__(self, c: int):
        return _Sym({k: c * v for k, v in self.terms.items()}, self.products)


class Bilinear:
    """K products of the sums ``ma`` @ x and ``mb`` @ y, then 12 outputs
    ``mc`` @ products + ``mx`` @ x: integer matrices of shapes (K, 12),
    (K, 12), (12, K) and (12, 12).  Only the cyclotomic square's outputs
    take input terms, each output j at most x_j (so the kernel may write
    an output over the input it reads)."""

    def __init__(self, formula):
        products: list = []
        x = [_Sym({("x", i): 1}, products) for i in range(12)]
        y = [_Sym({("y", i): 1}, products) for i in range(12)]
        out = formula(x, y)
        k = len(products)
        self.ma = np.zeros((k, 12), np.int64)
        self.mb = np.zeros((k, 12), np.int64)
        for p, (a, b) in enumerate(products):
            for (name, i), c in a.items():
                assert name == "x"
                self.ma[p, i] = c
            for (name, i), c in b.items():
                assert name == "y"
                self.mb[p, i] = c
        self.mc = np.zeros((12, k), np.int64)
        self.mx = np.zeros((12, 12), np.int64)
        for j, o in enumerate(out):
            for (name, p), c in o.terms.items():
                assert name in ("p", "x")
                (self.mc if name == "p" else self.mx)[j, p] = c
        assert not (self.mx - np.diag(np.diag(self.mx))).any()
        # The kernel enters each operand unreduced: at most 8 values below
        # q each, so below 8q < 2^384.
        assert np.abs(self.ma).sum(1).max() <= 8
        assert np.abs(self.mb).sum(1).max() <= 8
        assert 8 * Q < F.R

    @property
    def products(self) -> int:
        return self.ma.shape[0]


def _line_formula(x, y):
    t = _split(y)
    return _join(_fq12_mul_line(_split(x), t[0][0], t[1][1], t[1][2]))


def _low(values, x):
    """Values in the first places of a tower element, zero in the rest
    (an Fq6 or Fq2 element inside Fq12)."""
    zero = x[0] - x[0]
    return list(values) + [zero] * (12 - len(values))


def _abc_formula(x, y):
    return _low([v for c in _inv6_abc(_split(x)[0], _split(y)[0])
                 for v in c], x)


def _norm_formula(x, y):
    return _low(_inv6_norm(_split(x)[0], _split(y)[0]), x)


# The order is the kernel's (fq12w.cuh, enum Op).
OPS = {
    "mul": Bilinear(lambda x, y: _join(_fq12_mul(_split(x), _split(y)))),
    "sqr": Bilinear(lambda x, y: _join(_fq12_sqr(_split(x), _split(y)))),
    "line": Bilinear(_line_formula),
    "frob1": Bilinear(lambda x, y: _join(_fq12_frob1(_split(x), y))),
    "frob2": Bilinear(lambda x, y: _join(_fq12_frob2(_split(x), y))),
    "inv6_abc": Bilinear(_abc_formula),
    "inv6_norm": Bilinear(_norm_formula),
    "cyc": Bilinear(lambda x, y: _join(_fq12_cyc_sqr(_split(x), _split(y)))),
}
assert [OPS[k].products for k in OPS] == [54, 36, 42, 18, 12, 18, 9, 18]


MAX_PRODUCTS = 54            # fq12w.cuh kMaxProducts
# Each record's K, LA, LB, LO and LI as fq12w.cuh's Shape<Op> fixes them
# at compile time (the forms are padded to these lengths).
RECORD_SHAPES = {"mul": (54, 8, 8, 36, 0), "sqr": (36, 8, 8, 23, 0),
                 "line": (42, 8, 4, 21, 0), "frob1": (18, 2, 2, 3, 0),
                 "frob2": (12, 1, 1, 1, 0), "inv6_abc": (18, 2, 2, 6, 0),
                 "inv6_norm": (9, 2, 2, 7, 0), "cyc": (18, 4, 4, 6, 1)}


def _program() -> np.ndarray:
    """The kernel's table: [offset of each record, records].  A record
    is K forms of LA terms over x, K of LB over y, 12 of LO over the
    products and 12 of LI over x (K, LA, LB, LO, LI from RECORD_SHAPES;
    LI is 0 but for the cyclotomic square); a term is |coef| << 8 |
    index, where a negative coefficient takes the value's negation
    (index + 12 over the inputs, + MAX_PRODUCTS over the products), and
    0 pads a form to its record's length."""

    def forms(m, negated, width):
        rows = [[(abs(int(c)) << 8) | (i + (negated if c < 0 else 0))
                 for i, c in enumerate(r) if c] for r in m]
        assert max(len(r) for r in rows) == width
        return [r + [0] * (width - len(r)) for r in rows]

    records = []
    for name, op in OPS.items():
        k, la, lb, lo, li = RECORD_SHAPES[name]
        assert k == op.products
        fa = forms(op.ma, 12, la)
        fb = forms(op.mb, 12, lb)
        fo = forms(op.mc, MAX_PRODUCTS, lo)
        fi = forms(op.mx, 12, li) if li else []
        rec = []
        for block in (fa, fb, fo, fi):
            for r in block:
                rec.extend(r)
        records.append(rec)
    offsets = np.cumsum([len(records)] + [len(r) for r in records[:-1]])
    return np.asarray([*offsets.tolist(), *[t for r in records for t in r]],
                      np.int32)


# ---------------------------------------------------------------------------
# Constants: the Frobenius maps' coefficients and the flat <-> tower maps
# ---------------------------------------------------------------------------

_XI = (1, 1)
_FROB1 = [host._fq2_pow(_XI, k * (Q - 1) // 6) for k in range(6)]
_FROB2 = [host._fq2_pow(_XI, k * (Q * Q - 1) // 6) for k in range(6)]
assert (Q - 1) % 6 == 0 and all(g[1] == 0 for g in _FROB2)
# The y of records frob1 and frob2: 12 Fq values each, c[2k], c[2k+1].
FROB_CONSTS = [c for g in _FROB1 for c in g] + [g[0] for g in _FROB2
                                                 for _ in (0, 1)]


def _mont_limbs(values) -> np.ndarray:
    return np.stack([F.to_limbs(v * F.R % Q) for v in values])


def _mont_words(values) -> np.ndarray:
    """Montgomery forms as 12 little-endian 32-bit words each, as int32
    (the bits of the kernel's uint32_t)."""
    out = np.array([[(v * F.R % Q >> (32 * i)) & 0xFFFFFFFF
                     for i in range(12)] for v in values], np.uint32)
    return out.view(np.int32)


# flat -> tower: value 6i + 2j of the Fq2 coefficient of w^k (k = 2j + i)
# is a_k + a_{k+6}, value 6i + 2j + 1 is a_{k+6}; tower -> flat inverts
# it (a_{k+6} = b1, a_k = b0 - b1); conjugation negates c1.
_TO_TOWER = np.zeros((12, 12), np.int64)
_TO_FLAT = np.zeros((12, 12), np.int64)
for _k in range(6):
    _i, _j = _fq2_index(_k)
    _t = 6 * _i + 2 * _j
    _TO_TOWER[_t, _k] = _TO_TOWER[_t, _k + 6] = _TO_TOWER[_t + 1, _k + 6] = 1
    _TO_FLAT[_k + 6, _t + 1] = 1
    _TO_FLAT[_k, _t] = 1
    _TO_FLAT[_k, _t + 1] = -1
_CONJ = np.diag([1] * 6 + [-1] * 6)


# ---------------------------------------------------------------------------
# Plain versions: the same matrices on field381's plain operators
# ---------------------------------------------------------------------------

# Rows through each branch of miller_accumulate_plain (a line equal to
# one, a sparse line, any other), counted over every call.
BRANCHES = {"skip": 0, "sparse": 0, "dense": 0}


# The matrices of the plain sums, split once into their positive and
# negative parts and the bias that keeps every limb nonnegative (the
# plain versions run thousands of sums; nothing is rebuilt per call).
_LIN_PARTS: dict = {}


def _lin(name: str, m: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    """(..., n, 48) nonnegative limbs -> (..., rows of m, 48) limbs of
    the signed sums m @ v: the positive terms, minus the negative ones,
    plus one 64q bias (every limb at least 511, above any limb of v) per
    unit of negative coefficient, so every limb stays nonnegative."""
    parts = _LIN_PARTS.get(name)
    if parts is None:
        neg = np.maximum(-m, 0)
        parts = _LIN_PARTS[name] = (np.maximum(m, 0), neg,
                                    neg.sum(1)[:, None] * F._BIAS_ARR[None])
    pos, neg, bias = (F.cached(("lin", name, i), part, v.device)
                      for i, part in enumerate(parts))
    vv = v.unsqueeze(-3)                                   # (..., 1, n, 48)
    return ((pos[:, :, None] * vv).sum(-2, dtype=torch.int32) + bias
            - (neg[:, :, None] * vv).sum(-2, dtype=torch.int32))


def bilinear_plain(op: str, x: torch.Tensor, y: torch.Tensor
                   ) -> torch.Tensor:
    """(..., 12, 48) canonical tower elements (y: the line or the
    constants) -> the canonical tower element of OPS[op](x, y)."""
    b = OPS[op]
    a_sum = F.canonical(_lin(op + ".a", b.ma, x))
    b_sum = F.canonical(_lin(op + ".b", b.mb, y))
    prods = F.mont_mul(a_sum, b_sum)
    if not b.mx.any():
        return F.canonical(_lin(op + ".c", b.mc, prods))
    return F.canonical(_lin(op + ".c", np.hstack([b.mc, b.mx]),
                            torch.cat([prods, x], -2)))


def flat_to_tower_plain(x: torch.Tensor) -> torch.Tensor:
    return F.canonical(_lin("to_tower", _TO_TOWER, x))


def tower_to_flat_plain(t: torch.Tensor) -> torch.Tensor:
    return F.canonical(_lin("to_flat", _TO_FLAT, t))


def conj_plain(t: torch.Tensor) -> torch.Tensor:
    """x^(q^6), the inverse in the cyclotomic subgroup: negate c1."""
    return F.canonical(_lin("conj", _CONJ, t))


_TOWER_ONE = _mont_limbs([1] + [0] * 11)
_FROB_LIMBS = _mont_limbs(FROB_CONSTS)


def _tower_one(shape, device) -> torch.Tensor:
    one = F.cached("tower_one", _TOWER_ONE, device)
    return one.expand(*shape, FQ12, NLIMBS)


def _frob_consts(device) -> tuple:
    c = F.cached("frob_consts", _FROB_LIMBS, device)
    return c[:12], c[12:]


def pow_digits_plain(x: torch.Tensor, digits, width: int) -> torch.Tensor:
    """x^e for x in the cyclotomic subgroup and e's digits in base
    2^width, most significant first (the first nonzero): the kernel's
    pow_digits (fq12_lanes.cuh).  The table holds x^1 .. x^(2^width - 1);
    each later digit takes width cyclotomic squares and, when nonzero,
    one product by the table."""
    table = [x]
    for _ in range(2, 1 << width):
        table.append(bilinear_plain("mul", table[-1], x))
    assert digits[0] > 0
    acc = table[digits[0] - 1]
    for d in digits[1:]:
        for _ in range(width):
            acc = bilinear_plain("cyc", acc, acc)
        if d:
            acc = bilinear_plain("mul", acc, table[d - 1])
    return acc


def _hard_pow_tower_plain(f: torch.Tensor) -> torch.Tensor:
    """The hard part's chain on canonical tower elements (the kernel's
    hard_pow_tower, fq12_lanes.cuh), its squarings cyclotomic."""
    c1, c2 = _frob_consts(f.device)
    a = pow_digits_plain(f, E1_DIGITS, E1_WIDTH)
    t = conj_plain(pow_digits_plain(a, X_DIGITS, 1))
    b = bilinear_plain("mul", t, bilinear_plain("frob1", a, c1))
    t = pow_digits_plain(pow_digits_plain(b, X_DIGITS, 1), X_DIGITS, 1)
    t = bilinear_plain("mul", t, bilinear_plain("frob2", b, c2))
    t = bilinear_plain("mul", t, conj_plain(b))
    return bilinear_plain("mul", t, f)


def fq12_hard_pow_plain(x: torch.Tensor) -> torch.Tensor:
    """(..., 12, 48) flat Fq12 in the cyclotomic subgroup -> canonical
    limbs of x^((q^4 - q^2 + 1) / r), by the kernel's chain: a =
    f^((x - 1)^2 / 3), b = conj(a^|x|) a^q, c = (b^|x|)^|x| b^(q^2)
    conj(b), out = c f, every squaring a cyclotomic square.  Outside the
    subgroup neither conjugation is the inverse nor the cyclotomic
    square the square, and the result is not the power."""
    return tower_to_flat_plain(_hard_pow_tower_plain(flat_to_tower_plain(x)))


def fq2_inv_plain(a: torch.Tensor) -> torch.Tensor:
    """(..., 2, 48) canonical Montgomery Fq2 -> its canonical inverse
    (0 -> 0): conj(a) / (a0^2 + a1^2), the one Fq inverse by
    fq12_chain's plain Fermat power (the kernel's fqw::fq2_inv takes it
    by a binary extended Euclid: an inverse mod q is unique, so the two
    agree on the canonical residue)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    n = F.canonical(F.add(F.mont_mul(a0, a0), F.mont_mul(a1, a1)))
    n_inv = F.canonical(fq_pow_plain(n, Q - 2))
    return torch.stack([F.canonical(F.mont_mul(a0, n_inv)),
                        F.canonical(F.neg(F.mont_mul(a1, n_inv)))], -2)


def tower_inv_plain(t: torch.Tensor) -> torch.Tensor:
    """(..., 12, 48) canonical tower elements -> their canonical inverses
    (0 -> 0), down the tower as the kernel's tower_inv: N = f conj(f) in
    Fq6, its adjugate (A, B, C) and Fq2 norm F, F^-1, then f^-1 =
    conj(f) (A, B, C) F^-1."""
    cf = conj_plain(t)
    n = bilinear_plain("mul", t, cf)
    abc = bilinear_plain("inv6_abc", n, n)
    norm = bilinear_plain("inv6_norm", n, abc)
    f_inv = torch.cat([fq2_inv_plain(norm[..., :2, :]),
                       torch.zeros_like(norm[..., 2:, :])], -2)
    return bilinear_plain("mul", cf, bilinear_plain("mul", abc, f_inv))


def final_exp_plain(fs: torch.Tensor) -> tuple:
    """(rows, P, 12, 48) flat Miller values (P >= 1) -> ((rows,) bool
    verdicts, (rows, 12, 48) canonical limbs of p^((q^12 - 1) / r)) for
    p the product of each row's P values, by the kernel's algorithm: the
    P - 1 Karatsuba products, f^(q^6 - 1) = conj(f) f^-1, its q^2 power
    times itself (in the cyclotomic subgroup from here on), the hard
    part's chain with cyclotomic squares, the test for one."""
    t = flat_to_tower_plain(fs)
    f = t[:, 0]
    for i in range(1, t.shape[1]):
        f = bilinear_plain("mul", f, t[:, i])
    _, c2 = _frob_consts(fs.device)
    f = bilinear_plain("mul", conj_plain(f), tower_inv_plain(f))
    f = bilinear_plain("mul", bilinear_plain("frob2", f, c2), f)
    out = _hard_pow_tower_plain(f)
    ok = (out == _tower_one((), fs.device)).all(-1).all(-1)
    return ok, tower_to_flat_plain(out)


def fq12_product_plain(x: torch.Tensor) -> torch.Tensor:
    """(n, 12, 48) flat Fq12 values, n >= 1 -> canonical limbs (12, 48)
    of their product, by the kernel's algorithm: into the tower, then
    the n - 1 Karatsuba products in input order."""
    t = flat_to_tower_plain(x)
    f = t[0]
    for i in range(1, t.shape[0]):
        f = bilinear_plain("mul", f, t[i])
    return tower_to_flat_plain(f)


def line_branches(tower_lines: torch.Tensor) -> tuple:
    """(..., 12, 48) canonical tower lines -> (is one, is sparse) bool
    masks of shape (...): the kernel's run-time tests."""
    one = (tower_lines == _tower_one((), tower_lines.device)).all(-1).all(-1)
    sparse = (tower_lines[..., 2:8, :] == 0).all(-1).all(-1)
    return one, sparse


def miller_accumulate_plain(lines: torch.Tensor) -> torch.Tensor:
    """(rows, S, 2, 12, 48) flat lines -> canonical Miller values: from f
    = 1, per step f <- f^2 (complex squaring), then for each line: skip
    it when it equals one, else the sparse product when its Fq2
    coefficients c0.1, c0.2, c1.0 vanish, else the dense product (rows
    grouped by branch; ``BRANCHES`` counts them)."""
    rows, steps = lines.shape[:2]
    tl = flat_to_tower_plain(lines)
    one, sparse = line_branches(tl)
    f = _tower_one((rows,), lines.device).clone()
    for s in range(steps):
        f = bilinear_plain("sqr", f, f)
        for slot in (0, 1):
            l = tl[:, s, slot]
            for name, mask, op in (
                    ("sparse", ~one[:, s, slot] & sparse[:, s, slot], "line"),
                    ("dense", ~one[:, s, slot] & ~sparse[:, s, slot], "mul")):
                idx = mask.nonzero().flatten()
                if idx.numel():
                    f = f.index_copy(0, idx, bilinear_plain(
                        op, f.index_select(0, idx),
                        l.index_select(0, idx)))
                BRANCHES[name] += int(idx.numel())
            BRANCHES["skip"] += int(one[:, s, slot].sum())
    return tower_to_flat_plain(f)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

PROGRAM = _program()
_FROB_WORDS = _mont_words(FROB_CONSTS)


def _tables(device) -> tuple:
    """The kernels' constant inputs on ``device``: the program, the
    Frobenius constants as words, the digits of (x - 1)^2 / 3 and |x|."""
    return (F.cached("tower_program", PROGRAM, device),
            F.cached("tower_frob_words", _FROB_WORDS, device),
            F.cached("tower_e1_digits", E1_DIGITS, device),
            F.cached("tower_x_digits", X_DIGITS, device))


def fq12_hard_pow(x: torch.Tensor) -> torch.Tensor:
    """(rows, 12, 48) int32 flat Fq12 Montgomery limbs, each row in the
    cyclotomic subgroup (an easy-part output) -> canonical limbs of
    x^((q^4 - q^2 + 1) / r): the kernel on a CUDA tensor, the plain
    version on a CPU one."""
    if x.dim() != 3 or tuple(x.shape[1:]) != (FQ12, NLIMBS):
        raise ValueError(f"fq12_hard_pow: expected (rows, {FQ12}, "
                         f"{NLIMBS}), got {tuple(x.shape)}")
    check_int32("fq12_hard_pow x", x, x.shape)
    if not on_card(x):
        return fq12_hard_pow_plain(x)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    prog, consts, d1, dx = _tables(x.device)
    check_launch("fq12_hard_pow", build.load().hk_fq12_hard_pow(
        x.data_ptr(), prog.data_ptr(), prog.numel(), consts.data_ptr(),
        d1.data_ptr(),
        d1.numel(), dx.data_ptr(), dx.numel(), out.data_ptr(), x.shape[0],
        stream_of(x)))
    count_launch("fq12_hard_pow")
    return out


def final_exp(fs: torch.Tensor) -> tuple:
    """(rows, P, 12, 48) int32 flat Montgomery Miller values, P >= 1 ->
    ((rows,) bool: the product of each row's values raised to (q^12 - 1)
    / r is one, (rows, 12, 48) canonical limbs of that power): the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if fs.dim() != 4 or tuple(fs.shape[2:]) != (FQ12, NLIMBS) \
            or fs.shape[1] < 1:
        raise ValueError(f"final_exp: expected (rows, P >= 1, {FQ12}, "
                         f"{NLIMBS}), got {tuple(fs.shape)}")
    check_int32("final_exp fs", fs, fs.shape)
    if not on_card(fs):
        return final_exp_plain(fs)
    rows, p = fs.shape[:2]
    out = torch.empty((rows, FQ12, NLIMBS), dtype=torch.int32,
                      device=fs.device)
    ok = torch.empty((rows,), dtype=torch.int32, device=fs.device)
    if rows == 0:
        return ok.bool(), out
    prog, consts, d1, dx = _tables(fs.device)
    check_launch("final_exp", build.load().hk_final_exp(
        fs.data_ptr(), p, prog.data_ptr(), prog.numel(), consts.data_ptr(),
        d1.data_ptr(), d1.numel(), dx.data_ptr(), dx.numel(),
        out.data_ptr(), ok.data_ptr(), rows, stream_of(fs)))
    count_launch("final_exp")
    return ok.bool(), out


def fq12_product(x: torch.Tensor) -> torch.Tensor:
    """(n, 12, 48) int32 flat Montgomery Fq12 values, n >= 1 -> (12, 48)
    canonical limbs of their product: the kernel on a CUDA tensor (one
    block), the plain version on a CPU one."""
    if x.dim() != 3 or tuple(x.shape[1:]) != (FQ12, NLIMBS) \
            or x.shape[0] < 1:
        raise ValueError(f"fq12_product: expected (n >= 1, {FQ12}, "
                         f"{NLIMBS}), got {tuple(x.shape)}")
    check_int32("fq12_product x", x, x.shape)
    if not on_card(x):
        return fq12_product_plain(x)
    out = torch.empty((FQ12, NLIMBS), dtype=torch.int32, device=x.device)
    prog = _tables(x.device)[0]
    check_launch("fq12_product", build.load().hk_fq12_product(
        x.data_ptr(), x.shape[0], prog.data_ptr(), prog.numel(),
        out.data_ptr(), stream_of(x)))
    count_launch("fq12_product")
    return out


def miller_accumulate(lines: torch.Tensor) -> torch.Tensor:
    """(rows, S, 2, 12, 48) int32 flat Montgomery Miller lines -> (rows,
    12, 48) canonical Miller values: the kernel on a CUDA tensor, the
    plain version on a CPU one."""
    if lines.dim() != 5 or tuple(lines.shape[2:]) != (2, FQ12, NLIMBS):
        raise ValueError(f"miller_accumulate: expected (rows, S, 2, {FQ12}, "
                         f"{NLIMBS}) lines, got {tuple(lines.shape)}")
    check_int32("miller_accumulate lines", lines, lines.shape)
    if not on_card(lines):
        return miller_accumulate_plain(lines)
    rows, steps = lines.shape[:2]
    out = torch.empty((rows, FQ12, NLIMBS), dtype=torch.int32,
                      device=lines.device)
    if rows == 0:
        return out
    if lines.data_ptr() % 16:
        lines = lines.clone()        # the kernel copies 16-byte pieces
    prog = _tables(lines.device)[0]
    check_launch("miller_accumulate", build.load().hk_miller_accumulate(
        lines.data_ptr(), prog.data_ptr(), prog.numel(), out.data_ptr(),
        rows, steps,
        stream_of(lines)))
    count_launch("miller_accumulate")
    return out
