"""decompress's Hopper layout (csrc/field25519_lanes.cuh, point_chain.cu
``decompress_groups_kernel``) on the CPU: numpy models of the lane-group
squaring's schedule, of the kernel's pow_p58 chain (its step table read
from the header) and of the group canonical form, each held limb for
limb to the JAX package; the header itself built with the host's C++
compiler, a warp's 32 lanes as 32 threads that meet at every shuffle and
ballot, its squaring, canonical form and whole decompress row held to
the JAX package and to decompress's plain version; the plain version
(what the kernel is held to on the card) held to the JAX package's
decompress on the edge rows of ``chip_smoke.py`` phase 4, y >= p
included; and the wrapper's CPU route.  Exact: tolerance 0.

The models follow the header line by line: lane l of a group of 8 lanes
holds limbs 4l .. 4l + 3.  The squaring fetches the blocks floor(l/2) +
s (s = -4 .. 3) one limb a shuffle, scales those whose index goes below
0 by 38, takes the blocks ceil(l/2) + s of an odd lane by a select from
the next one, and sums for q = 0 .. 3 the low products of blocks
(floor(l/2) - q, ceil(l/2) + q) and the high products of blocks
(floor((l-1)/2) - q, floor(l/2) + q), doubled unless the pair is one
block, then block floor(l/2) + 4 squared (one factor scaled): its low
four coefficients on an even lane, its high three on an odd one; four
carry steps.  The canonical form walks each carry
and borrow over the 8 lanes, one shuffle a lane, each lane's block
rippled for every carry in at once.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hotstuff_tpu.ops import ed25519 as JE  # noqa: E402
from hotstuff_tpu.ops import field25519 as JF  # noqa: E402
from hotstuff_tpu_torch.ops import ed25519 as E  # noqa: E402
from hotstuff_tpu_torch.ops import kern  # noqa: E402
from hotstuff_tpu_torch.ops.kern import point_chain as PC  # noqa: E402
from hotstuff_tpu_torch.ops.kern.field_mul import field_mul_plain  # noqa: E402

import torch_lanes_harness as lanes_harness  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "hotstuff_tpu_torch", "ops", "kern", "csrc")
SOURCE = os.path.join(CSRC, "field25519_lanes.cuh")
L, G = 4, 8
P = 2**255 - 19


class _Group:
    """The 8 lanes of a group in lockstep over n rows: ``shfl`` is one
    warp shuffle of one word a lane (counted), ``note`` keeps the largest
    value any lane holds."""

    def __init__(self):
        self.shuffles = 0
        self.largest = 0

    def shfl(self, words, src):
        self.shuffles += 1
        return [words[s] for s in src]

    def note(self, x):
        self.largest = max(self.largest, int(np.abs(x).max()))
        return x

    def fetch(self, blocks, src):
        """The block of lane src[l] for each lane l: two packed words
        (limbs 2w, 2w + 1 in word w), each one shuffle."""
        words = [[blk[:, 2 * w] | (blk[:, 2 * w + 1] << 16) for blk in blocks]
                 for w in range(L // 2)]
        got = [self.shfl(words[w], src) for w in range(L // 2)]
        out = []
        for lane in range(G):
            blk = np.empty_like(blocks[0])
            for w in range(L // 2):
                word = self.note(got[w][lane])
                blk[:, 2 * w], blk[:, 2 * w + 1] = word & 0xFFFF, word >> 16
            out.append(blk)
        return out

    def carry_step(self, x):
        below = self.shfl([blk[:, L - 1] for blk in x],
                          [(lane - 1) % G for lane in range(G)])
        out = []
        for lane, blk in enumerate(x):
            r = np.empty_like(blk)
            up = below[lane] >> 8
            r[:, 0] = (blk[:, 0] & 0xFF) + up * (38 if lane == 0 else 1)
            for v in range(1, L):
                r[:, v] = (blk[:, v] & 0xFF) + (blk[:, v - 1] >> 8)
            out.append(self.note(r))
        return out

    def carry_in(self, outs):
        """The short serial pass: outs[lane][k] is the carry out of the
        lane's block for a carry k in; returns each lane's carry in and
        the carry out of lane 7."""
        cin = np.zeros_like(outs[0][0])
        mine = [None] * G
        for i in range(G):
            mine[i] = cin
            nxt = [np.choose(cin, outs[lane]) for lane in range(G)]
            cin = self.shfl(nxt, [i] * G)[0]
        return mine, cin


def _split(a):
    return [a[:, L * lane:L * lane + L].astype(np.int64) for lane in range(G)]


def _join(blocks):
    return np.concatenate(blocks, axis=1)


def _sqr_schedule(lane):
    """The products lane ``lane`` sums: (block of the first factor,
    position, block of the second, position, output v, factor)."""
    c, odd = lane >> 1, lane & 1
    terms = []
    for q in range(G // 2):
        m, n = c - q, (c + odd) + q
        f = (38 if q > c else 1) * (1 if q == 0 and not odd else 2)
        for v in range(L):
            for k in range(v + 1):
                terms.append((m % G, k, n % G, v - k, v, f))
        m, n = c - (1 - odd) - q, c + q
        f = (38 if q > c - (1 - odd) else 1) * (1 if q == 0 and odd else 2)
        for v in range(L - 1):
            for k in range(v + 1, L):
                terms.append((m % G, k, n % G, L + v - k, v, f))
    x = (c + G // 2) % G
    for s in range(2 * L - 1):
        if (s < L) == (not odd):
            v = s if not odd else s - L
            for k in range(L):
                if 0 <= s - k < L and k <= s - k:
                    terms.append((x, k, x, s - k, v, 38 * (1 if 2 * k == s
                                                          else 2)))
    return terms


def test_sqr_schedule_takes_each_pair_once_at_its_weight():
    """Every unordered limb pair {i, k} lands on the lane that owns
    i + k mod 32 and on no other, its factors summing to 2 (1 when
    i = k), times 38 when i + k >= 32: mul(a, a)'s coefficients exactly.
    A lane sums 64 products of block pairs (a self pair's both orders,
    each once) and its half of the last block's square, whose 10
    products every lane forms: 74 a lane."""
    factor, owner = {}, {}
    for lane in range(G):
        terms = _sqr_schedule(lane)
        assert len(terms) == 64 + (4 if lane & 1 else 6)
        for m, u, n, w, v, f in terms:
            i, k = L * m + u, L * n + w
            assert (i + k) % 32 == L * lane + v
            key = (min(i, k), max(i, k))
            assert owner.setdefault(key, lane) == lane
            factor[key] = factor.get(key, 0) + f
    assert len(factor) == 32 * 33 // 2
    for (i, k), f in factor.items():
        assert f == (1 if i == k else 2) * (38 if i + k >= 32 else 1)


def _lanes_sqr_model(a: np.ndarray):
    """(n, 32) weak limbs -> (a^2 by the header's sqr, the largest value
    any lane held, the warp shuffles one squaring took)."""
    grp = _Group()
    own = _split(a)
    # u[s + 4] = block floor(l/2) + s, s = -4 .. 3, one limb a shuffle;
    # u[8] = u[0] unscaled; then the blocks with c + s < 0 times 38.
    u = []
    for s in range(-G // 2, G // 2):
        src = [((lane >> 1) + s) % G for lane in range(G)]
        got = [grp.shfl([blk[:, v] for blk in own], src) for v in range(L)]
        u.append([np.stack([got[v][lane] for v in range(L)], axis=1)
                  for lane in range(G)])
    u.append([blk.copy() for blk in u[0]])
    for s in range(-G // 2, 0):
        for lane in range(G):
            if (lane >> 1) + s < 0:
                u[s + G // 2][lane] = grp.note(38 * u[s + G // 2][lane])
    out = []
    for lane in range(G):
        odd = lane & 1
        acc = np.zeros((a.shape[0], L), np.int64)
        dbl = np.zeros_like(acc)
        for q in range(G // 2):
            x, y = u[G // 2 - q][lane], u[G // 2 + q + odd][lane]
            z, h = u[G // 2 + q][lane], u[G // 2 - q - (1 - odd)][lane]
            for v in range(L):
                s = sum(x[:, k] * y[:, v - k] for k in range(v + 1))
                if q == 0:
                    acc[:, v] += (2 if odd else 1) * grp.note(s)
                else:
                    dbl[:, v] += s
            for v in range(L - 1):
                s = sum(h[:, k] * z[:, L + v - k] for k in range(v + 1, L))
                if q == 0:
                    acc[:, v] += (1 if odd else 2) * grp.note(s)
                else:
                    dbl[:, v] += s
            grp.note(acc)
            grp.note(dbl)
        xs, x = u[0][lane], u[G][lane]
        sq = [sum(xs[:, k] * x[:, s - k] for k in range(L) if 0 <= s - k < L)
              for s in range(2 * L - 1)]
        for v in range(L):
            if odd:
                acc[:, v] += sq[v + L] if v + L < 2 * L - 1 else 0
            else:
                acc[:, v] += sq[v]
        out.append(grp.note(acc + 2 * dbl))
    for _ in range(4):
        out = grp.carry_step(out)
    return _join(out).astype(np.int32), grp.largest, grp.shuffles


@pytest.fixture(scope="module")
def jax_sqr():
    return jax.jit(JF.sqr)


@pytest.mark.parametrize("case", ["seeded", "all511", "low9"])
def test_lanes_sqr_model_equals_jax_sqr_limb_for_limb(jax_sqr, case):
    rng = np.random.default_rng(181)
    a = {"seeded": rng.integers(0, 512, (96, 32)),
         "all511": np.full((1, 32), 511),
         "low9": np.concatenate([np.zeros((1, 32)), np.eye(32) * 511,
                                 rng.integers(0, 2, (8, 32)) * 511])}[case]
    a = a.astype(np.int32)
    got, largest, shuffled = _lanes_sqr_model(a)
    assert np.array_equal(got, np.asarray(jax_sqr(jnp.asarray(a))))
    assert largest < 2**31
    assert shuffled == 36      # 32 limbs for the blocks, 4 for the carries


# ---------------------------------------------------------------------------
# The kernel's pow_p58 chain
# ---------------------------------------------------------------------------

def _pow_steps():
    """kPowSteps from point_chain.cu: (squarings, slot taken, slot kept)."""
    with open(SOURCE) as f:
        text = f.read()
    body = re.search(r"kPowSteps\[(\d+)\] = \{(.*?)\};", text, re.S)
    steps = [tuple(int(v) for v in m.groups()) for m in re.finditer(
        r"\{\s*(-?\d+),\s*(-?\d+),\s*(-?\d+)\s*\}", body.group(2))]
    assert len(steps) == int(body.group(1))
    return steps


def test_pow_steps_are_the_reference_chain():
    steps = _pow_steps()
    assert sum(k for k, _, _ in steps) == 251 and len(steps) == 11
    # As exponents: slot values and the running value are x^e.
    slots, acc = [1] * 7, 1
    for k, take, keep in steps:
        acc = acc * 2**k + slots[take]
        if keep >= 0:
            slots[keep] = acc
    assert acc == (P - 5) // 8 == 2**252 - 3


@pytest.fixture(scope="module")
def jax_pow_p58():
    return jax.jit(JF.pow_p58)


def test_pow_chain_model_equals_jax_pow_p58(jax_pow_p58):
    """The step table run with the squaring model and the plain multiply
    gives the JAX package's pow_p58 limb for limb."""
    rng = np.random.default_rng(182)
    x = np.concatenate([rng.integers(0, 512, (6, 32)),
                        np.full((1, 32), 511)]).astype(np.int32)
    slots = [x] * 7
    acc = x
    for k, take, keep in _pow_steps():
        for _ in range(k):
            acc = _lanes_sqr_model(acc)[0]
        acc = field_mul_plain(torch.from_numpy(acc),
                              torch.from_numpy(slots[take])).numpy()
        if keep >= 0:
            slots[keep] = acc
    assert np.array_equal(acc, np.asarray(jax_pow_p58(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# The group canonical form
# ---------------------------------------------------------------------------

P_DIGITS = [(P >> (8 * i)) & 0xFF for i in range(32)]


def _ripple(grp, x):
    outs = []
    for blk in x:
        row = []
        for k in range(3):
            t = np.full(blk.shape[0], k, np.int64)
            for v in range(L):
                t = (blk[:, v] + t) >> 8
            row.append(t)
        outs.append(row)
    mine, last = grp.carry_in(outs)
    res = []
    for lane, blk in enumerate(x):
        t, r = mine[lane].copy(), np.empty_like(blk)
        for v in range(L):
            t = t + blk[:, v]
            r[:, v], t = t & 0xFF, t >> 8
        res.append(r)
    return res, last


def _cond_sub_p(grp, x):
    outs = []
    for lane, blk in enumerate(x):
        row = []
        for k in range(2):
            b = np.full(blk.shape[0], k, np.int64)
            for v in range(L):
                b = (blk[:, v] - P_DIGITS[L * lane + v] - b < 0).astype(
                    np.int64)
            row.append(b)
        outs.append(row + [row[1]])
    mine, last = grp.carry_in(outs)
    res = []
    for lane, blk in enumerate(x):
        b, r = mine[lane].copy(), np.empty_like(blk)
        for v in range(L):
            d = blk[:, v] - P_DIGITS[L * lane + v] - b
            b = (d < 0).astype(np.int64)
            r[:, v] = d + (b << 8)
        res.append(np.where(last[:, None] > 0, blk, r))
    return res


def _canonical_model(a):
    grp = _Group()
    x = _split(a)
    for _ in range(2):
        x, c = _ripple(grp, x)
        x[0][:, 0] += 38 * c
    x = _cond_sub_p(grp, _cond_sub_p(grp, x))
    return _join(x).astype(np.int32), grp.shuffles


@pytest.fixture(scope="module")
def jax_canonical():
    return jax.jit(JF.canonical)


def test_canonical_model_equals_jax_canonical(jax_canonical):
    rng = np.random.default_rng(183)
    edge = [P - 1, P, P + 1, 2 * P - 1, 2 * P, 2 * P + 37, 2**255 - 1,
            2**256 - 1, 0, 1, 19]
    rows = [np.array([(v >> (8 * i)) & 0xFF for i in range(32)])
            for v in edge]
    # Weak forms at the top: all 511, and 511 limbs over p's bytes.
    rows += [np.full(32, 511), np.array(P_DIGITS) + 256,
             np.array(P_DIGITS) + 255]
    a = np.concatenate([np.stack(rows), rng.integers(0, 512, (64, 32))])
    a = a.astype(np.int32)
    got, shuffled = _canonical_model(a)
    assert np.array_equal(got, np.asarray(jax_canonical(jnp.asarray(a))))
    assert shuffled == 4 * G       # two ripples and two borrow chains


# ---------------------------------------------------------------------------
# decompress's plain version on phase 4's rows, and the CPU route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_decompress_plain_equals_jax_on_the_edge_rows(smoke):
    """Phase 4's 16-row shape: two real encodings, two random rows and
    every edge row (y = 0, 1, p - 1 with either sign, 2, and y >= p:
    p, p + 1, 2^255 - 1), points and ok mask exact; the CPU route
    launches nothing."""
    y, sign = smoke.decompress_inputs(np.random.default_rng(184), 16, "cpu")
    assert y.shape == (16, 32)
    edge_y = [sum(int(v) << (8 * i) for i, v in enumerate(row))
              for row in y[-len(smoke.DECOMPRESS_EDGE_ROWS):].tolist()]
    assert [(v, int(s)) for v, s in zip(
        edge_y, sign[-len(edge_y):].tolist())] == list(
        smoke.DECOMPRESS_EDGE_ROWS)
    before = dict(kern.LAUNCHES)
    pts, ok = PC.decompress(y, sign)
    assert kern.LAUNCHES == before
    jpts, jok = jax.jit(JE.decompress)(jnp.asarray(y.numpy()),
                                       jnp.asarray(sign.numpy()))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert np.array_equal(pts.numpy(), np.asarray(jpts))
    want_ok = {(0, 0): True, (0, 1): True, (1, 0): True, (1, 1): False,
               (2, 0): False}
    for (v, s), got in zip(smoke.DECOMPRESS_EDGE_ROWS,
                           ok[-len(edge_y):].tolist()):
        if (v, s) in want_ok:
            assert got == want_ok[(v, s)], (v, s)
    assert bool(ok[:2].all())          # the real encodings


# ---------------------------------------------------------------------------
# The header on the host: a warp's lanes as threads
# ---------------------------------------------------------------------------

_ENTRY_POINTS = r"""
// Each warp of four rows as 32 threads, the kernel's row mapping: group g
// of warp w runs row 4w + g, an idle group the last row without storing.
template <class F>
void warps(long long rows, F body) {
  std::barrier<> b(32);
  warp_barrier = &b;
  for (long long w = 0; w * hl::kRowsPerWarp < rows; ++w) {
    std::vector<std::thread> lanes;
    for (int t = 0; t < 32; ++t) {
      lanes.emplace_back([&, t, w] {
        lane_id = t;
        const int g = t / hl::G, l = t % hl::G;
        const long long row = w * hl::kRowsPerWarp + g;
        body(row < rows ? row : rows - 1, row < rows, g, l);
      });
    }
    for (auto& th : lanes) th.join();
  }
}

extern "C" void hh_sqr(const int* a, int* out, long long rows) {
  warps(rows, [&](long long r, bool live, int, int l) {
    const hl::Fe x = hl::sqr(hl::load_limbs(a + r * 32, l), l);
    if (live) hl::store_fe(out + r * 32, x, l);
  });
}

extern "C" void hh_canonical(const int* a, int* out, long long rows) {
  warps(rows, [&](long long r, bool live, int, int l) {
    const hl::Fe x = hl::canonical(hl::load_limbs(a + r * 32, l), l);
    if (live) hl::store_fe(out + r * 32, x, l);
  });
}

extern "C" void hh_pow_p58(const int* a, int* out, long long rows) {
  warps(rows, [&](long long r, bool live, int, int l) {
    const hl::Fe x = hl::pow_p58(hl::load_limbs(a + r * 32, l), l);
    if (live) hl::store_fe(out + r * 32, x, l);
  });
}

extern "C" void hh_decompress(const int* y, const int* sign, const int* d,
                              const int* sqrt_m1, int* out,
                              unsigned char* ok, long long rows) {
  warps(rows, [&](long long r, bool live, int g, int l) {
    hl::decompress_row(y + r * 32, sign[r], d, sqrt_m1, out + r * 128,
                       ok + r, live, g, l);
  });
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """field25519_lanes.cuh built with the host's C++ compiler into a
    ctypes library: the code the card runs, a warp's lanes as threads."""
    return lanes_harness.build(tmp_path_factory, "lanes_harness",
                               _ENTRY_POINTS)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _host(fn, a: np.ndarray) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(a, np.int32))
    out = torch.zeros_like(x)
    fn(_ptr(x), _ptr(out), ctypes.c_longlong(x.shape[0]))
    return out.numpy()


def _weak_rows(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([np.full((1, 32), 511), np.zeros((1, 32)),
                           rng.integers(0, 512, (n - 2, 32))]).astype(
                               np.int32)


def test_header_sqr_on_the_host_equals_jax_sqr(harness, jax_sqr):
    a = _weak_rows(185, 10)          # two warps, the second half idle
    assert np.array_equal(_host(harness.hh_sqr, a),
                          np.asarray(jax_sqr(jnp.asarray(a))))


def test_header_canonical_on_the_host_equals_jax_canonical(harness,
                                                           jax_canonical):
    edge = [P - 1, P, P + 1, 2 * P - 1, 2**255 - 1, 2**256 - 1]
    rows = [[(v >> (8 * i)) & 0xFF for i in range(32)] for v in edge]
    rows += [(np.array(P_DIGITS) + 256).tolist()]
    a = np.concatenate([np.array(rows), _weak_rows(186, 9)]).astype(np.int32)
    assert np.array_equal(_host(harness.hh_canonical, a),
                          np.asarray(jax_canonical(jnp.asarray(a))))


def test_header_pow_p58_on_the_host_equals_jax(harness, jax_pow_p58):
    a = _weak_rows(187, 4)
    assert np.array_equal(_host(harness.hh_pow_p58, a),
                          np.asarray(jax_pow_p58(jnp.asarray(a))))


def _source_limbs(name: str) -> list:
    with open(os.path.join(CSRC, "point_chain.cu")) as f:
        body = re.search(name + r"\[32\] = \{(.*?)\};", f.read(), re.S)
    return [int(v) for v in body.group(1).replace("\n", " ").split(",")]


def test_kernel_constants_are_d_and_sqrt_m1():
    d = -121665 * pow(121666, P - 2, P) % P
    sqrt_m1 = pow(2, (P - 1) // 4, P)
    for name, value in (("kD", d), ("kSqrtM1", sqrt_m1)):
        assert _source_limbs(name) == [(value >> (8 * i)) & 0xFF
                                       for i in range(32)], name


@pytest.mark.parametrize("n", [16, 19])
def test_header_decompress_on_the_host_equals_plain(harness, smoke, n):
    """The whole row (decompress_row, as decompress_groups_kernel runs
    it) on phase 4's rows: 16, and 19 (an idle group in the last warp)."""
    y, sign = smoke.decompress_inputs(np.random.default_rng(188 + n), n,
                                      "cpu")
    y, sign = y.contiguous(), sign.contiguous()
    d = torch.tensor(_source_limbs("kD"), dtype=torch.int32)
    sqrt_m1 = torch.tensor(_source_limbs("kSqrtM1"), dtype=torch.int32)
    out = torch.zeros((n, 4, 32), dtype=torch.int32)
    ok = torch.zeros(n, dtype=torch.uint8)
    harness.hh_decompress(_ptr(y), _ptr(sign), _ptr(d), _ptr(sqrt_m1),
                          _ptr(out), _ptr(ok), ctypes.c_longlong(n))
    want_pts, want_ok = PC.decompress_plain(y, sign)
    assert torch.equal(out, want_pts)
    assert torch.equal(ok.bool(), want_ok)
