"""final_exp's split step (hotstuff_tpu_torch/ops/kern/csrc/fq12_lanes.cuh)
on the CPU:

* the cyclotomic square (record ``cyc`` of fq12_tower.py, Granger and
  Scott's 18 Fq products), applied by the plain version, against the JAX
  package's host bigints (hotstuff_tpu/offchain/bls12381.py fq12_mul):
  equal to the square on easy-part outputs, one and zero, and not equal
  on a generic Fq12 (the record holds only in the cyclotomic subgroup);
* a model of the split Montgomery product as the kernel's lanes run it
  (a group of 12 / W lanes, digit l of W words in lane l, the round's m
  broadcast from lane 0, each lane's low digit shuffled one lane down,
  the redundant digits carried once at the end), word for word and with
  every intermediate inside its word width, against a b R^-1 mod q and
  against the CIOS value (a b + M q) / R that fqw::mont_mul reduces;
* the header's constant -q^-1 mod 2^384 against Python integers.

The kernel's own C++ (the split product, the split steps and
final_exp_row built with g++) is held to these in
tests/test_torch_bls381_tower.py.  numpy seeds, one torch thread, every
comparison exact.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hotstuff_tpu.offchain import bls12381 as ref
from hotstuff_tpu_torch.ops import bls381 as D
from hotstuff_tpu_torch.ops import field381 as F
from hotstuff_tpu_torch.ops.kern import fq12_tower as T

Q = F.Q
R = F.R
MASK = (1 << 32) - 1
CSRC = Path(T.__file__).resolve().parent / "csrc"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host_elems(rng, n):
    return [tuple(int.from_bytes(rng.bytes(48), "little") % Q
                  for _ in range(12)) for _ in range(n)]


def _mont(vals) -> torch.Tensor:
    return torch.from_numpy(np.stack([D.host_fq12_to_mont_limbs(v)
                                      for v in vals]))


def _values(x) -> list:
    """(n, 12, 48) Montgomery limbs -> host Fq12 tuples."""
    c = F.from_mont(torch.as_tensor(x)).numpy()
    return [tuple(F.from_limbs(r) for r in row) for row in c]


# ---------------------------------------------------------------------------
# The cyclotomic record
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def easy():
    """Three seeded easy-part outputs f^((q^6 - 1)(q^2 + 1)), then one
    and zero: the hard part's domain and its two edge values."""
    f = _mont(_host_elems(np.random.default_rng(71), 3))
    f1 = D.fq12_mul(D.fq12_frobenius(f, 6), D.fq12_inv(f))
    f2 = D.fq12_mul(D.fq12_frobenius(f1, 2), f1)
    return torch.cat([f2, _mont([ref.FQ12_ONE, (0,) * 12])]).contiguous()


def _square(x: torch.Tensor, name: str) -> list:
    t = T.flat_to_tower_plain(x)
    return _values(T.tower_to_flat_plain(T.bilinear_plain(name, t, t)))


def test_cyclotomic_record_squares_the_cyclotomic_subgroup(easy):
    vals = _values(easy)
    # The inputs are in the subgroup: f^(q^6 + 1) = 1 (zero aside).
    for v in vals[:4]:
        assert ref.fq12_mul(ref.fq12_pow(v, Q ** 6), v) == ref.FQ12_ONE
    want = [ref.fq12_mul(v, v) for v in vals]
    assert _square(easy, "cyc") == want
    assert _square(easy, "sqr") == want


def test_cyclotomic_record_differs_off_the_subgroup():
    vals = _host_elems(np.random.default_rng(72), 2)
    x = _mont(vals)
    want = [ref.fq12_mul(v, v) for v in vals]
    assert _square(x, "sqr") == want
    got = _square(x, "cyc")
    assert all(g != w for g, w in zip(got, want))


def test_cyclotomic_record_shape():
    """18 products, operands of at most 4 terms, each output's only input
    term its own value (so the kernel may write an output over it)."""
    op = T.OPS["cyc"]
    assert op.products == 18
    assert T.RECORD_SHAPES["cyc"] == (18, 4, 4, 6, 1)
    assert np.abs(op.ma).sum(1).max() <= 8
    assert np.abs(op.mb).sum(1).max() <= 8
    assert not (op.mx - np.diag(np.diag(op.mx))).any()
    assert sorted(set(np.diag(op.mx).tolist())) == [-2, 2]
    assert not any(T.OPS[n].mx.any() for n in T.OPS if n != "cyc")


# ---------------------------------------------------------------------------
# The split Montgomery product, lane by lane
# ---------------------------------------------------------------------------

QINV = -pow(Q, -1, R) % R
Q_TOP_RECIP = (1 << 64) // ((Q >> 352) + 1)      # fqw::kQTopRecip


def _words(v: int, n: int) -> list:
    return [(v >> (32 * i)) & MASK for i in range(n)]


def _fits(v: int, words: int = 1) -> int:
    assert 0 <= v < 1 << (32 * words)
    return v


def _mac_cols(col, x, y, w):
    """fq12_lanes.cuh mac_cols: the halves of the W x W products into
    64-bit columns."""
    for j in range(w):
        for k in range(w):
            if j + k >= len(col):
                continue
            p = _fits(x[j] * y[k], 2)
            col[j + k] = _fits(col[j + k] + (p & MASK), 2)
            if j + k + 1 < len(col):
                col[j + k + 1] = _fits(col[j + k + 1] + (p >> 32), 2)


def _carry_cols(col):
    d, c = [], 0
    for v in col:
        s = _fits(v + c, 2)
        d.append(s & MASK)
        c = s >> 32
    return d, _fits(c)


def _lookahead(gen, prop):
    """The carry (or borrow) into each lane and out of the last: bit l of
    ((gen << 1) + prop) ^ prop, as the kernel's two ballots give it."""
    gm = sum(1 << l for l, b in enumerate(gen) if b)
    pm = sum(1 << l for l, b in enumerate(prop) if b)
    assert not gm & pm
    return ((gm << 1) + pm) ^ pm


class Lanes:
    """A group of G lanes holding a value as digits of W words (digit l
    in lane l, zero in lanes from 12 / W on): lists indexed by lane stand
    for the lanes' registers, a read of another lane's entry for a
    shuffle, a bit mask of the lanes' flags for a ballot."""

    def __init__(self, w: int):
        self.w, self.lanes = w, 12 // w
        self.group = 1 << (self.lanes - 1).bit_length()

    def digits(self, v: int) -> list:
        ws = _words(v, 12)
        return [ws[self.w * l:self.w * l + self.w] if l < self.lanes
                else [0] * self.w for l in range(self.group)]

    def value(self, d) -> int:
        return sum(x << (32 * (self.w * l + k)) for l in range(self.lanes)
                   for k, x in enumerate(d[l]))

    def resolve(self, d, c):
        """fq12_lanes.cuh resolve: returns the exact digits and the part
        above them (lane L - 1's)."""
        w, n = self.w, self.lanes
        gen, prop, e = [], [], []
        for l in range(self.group):
            s = c[l - 1] if 0 < l < n else 0
            out = []
            for x in d[l]:
                s = _fits(s + x, 2)
                out.append(s & MASK)
                s >>= 32
            e.append(out)
            gen.append(s != 0)
            prop.append(all(x == MASK for x in out) and l < n)
        k = _lookahead(gen, prop)
        for l in range(self.group):
            s = (k >> l) & 1
            for i in range(w):
                s = e[l][i] + s
                e[l][i], s = s & MASK, s >> 32
        return e, c[n - 1] + ((k >> n) & 1)

    def borrow(self, d, gen):
        n = self.lanes
        prop = [not any(x) and l < n for l, x in enumerate(d)]
        k = _lookahead(gen, prop)
        for l in range(self.group):
            b = (k >> l) & 1
            for i in range(self.w):
                s = d[l][i] - b
                d[l][i], b = s & MASK, int(s < 0)
        return bool((k >> n) & 1)

    def sub(self, d, e):
        out, gen = [], []
        for x, y in zip(d, e):
            b, o = 0, []
            for xi, yi in zip(x, y):
                s = xi - yi - b
                o.append(s & MASK)
                b = int(s < 0)
            out.append(o)
            gen.append(bool(b))
        return out, gen

    def reduce(self, d, top):
        """fq12_lanes.cuh reduce: V = digits + top 2^384 < 2^400 -> V mod
        q, its quotient estimate from lane L - 1's top 64 bits."""
        assert top < 1 << 16
        qhat = _fits((((top << 32) | d[self.lanes - 1][-1]) * Q_TOP_RECIP)
                     >> 64)
        qd = self.digits(Q)
        s, c = [], []
        for l in range(self.group):
            row, cc = [], 0
            for x in qd[l]:
                p = _fits(qhat * x + cc, 2)
                row.append(p & MASK)
                cc = p >> 32
            s.append(row)
            c.append(cc)
        s, _ = self.resolve(s, c)
        r, gen = self.sub(d, s)
        self.borrow(r, gen)
        assert self.value(r) < 2 * Q
        u, gen = self.sub(r, qd)
        below_q = self.borrow(u, gen)
        return r if below_q else u


def _add_product(u, x, y, w):
    """fq12_lanes.cuh add_product: u += x y into 2W + 1 words."""
    col = list(u)
    _mac_cols(col, x, y, w)
    out, c = _carry_cols(col)
    assert c == 0
    return out


def split_mont_mul(a: int, b: int, w: int) -> list:
    """a b R^-1 mod q as 12 words, by fq12_lanes.cuh mont_split with W =
    w, every intermediate inside its word width."""
    g = Lanes(w)
    n, group = g.lanes, g.group
    ad, bd, qd, qi = g.digits(a), g.digits(b), g.digits(Q), _words(QINV, w)
    beta = 1 << (32 * w)
    t = [[0] * (w + 1) for _ in range(group)]
    for i in range(n):
        u, m = [], []
        for l in range(group):
            ul = _add_product(t[l] + [0] * w, ad[l], bd[i], w)
            ml = [0] * w                         # mul_low: u q' mod beta
            _mac_cols(ml, ul[:w], qi, w)
            u.append(ul)
            m.append(_carry_cols(ml)[0])
        for l in range(group):                   # m from lane 0
            u[l] = _add_product(u[l], m[0], qd[l], w)
        assert u[0][:w] == [0] * w               # 0 mod beta
        for l in range(group):                   # the low digit one lane down
            up = u[(l + 1) % group][:w] if l + 1 < n else [0] * w
            s, nt = 0, []
            for k in range(w):
                s = _fits(u[l][w + k] + up[k] + s, 2)
                nt.append(s & MASK)
                s >>= 32
            nt.append(_fits(u[l][2 * w] + s))
            assert sum(x << (32 * k) for k, x in enumerate(nt)) <= 3 * beta - 2
            t[l] = nt
    d, top = g.resolve([x[:w] for x in t], [x[w] for x in t])
    value = g.value(d) + (top << 384)
    assert value == (a * b + (-a * b * pow(Q, -1, R) % R) * Q) // R
    assert value < R + Q                         # fqw::mont_mul's CIOS value
    out = g.reduce(d, top)
    return [x for l in range(n) for x in out[l]]


@pytest.mark.parametrize("w", [2, 3, 4])
def test_split_product_model_equals_redc(w):
    rng = np.random.default_rng(73 + w)
    a = [R - 1, 8 * Q - 1, Q - 1, 0, 1, 8 * Q - 1] + \
        [int.from_bytes(rng.bytes(48), "little") for _ in range(24)]
    b = [R - 1, 8 * Q - 1, 1, R - 1, R - 1, 3] + \
        [int.from_bytes(rng.bytes(48), "little") % (8 * Q)
         for _ in range(24)]
    rinv = pow(R, -1, Q)
    for x, y in zip(a, b):
        assert split_mont_mul(x, y, w) == _words(x * y * rinv % Q, 12)


def test_header_montgomery_constant():
    src = (CSRC / "fq12_lanes.cuh").read_text()
    body = re.search(r"kQInvR\[kWords\] = \{([^}]*)\}", src).group(1)
    words = [int(x, 16) for x in re.findall(r"0x[0-9a-f]+", body)]
    assert words == _words(QINV, 12)
    assert (Q * QINV + 1) % R == 0
