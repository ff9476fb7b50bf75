"""point_multiples' Hopper layout (csrc/field25519_lanes.cuh
``multiples_row``, point_chain.cu ``point_multiples_kernel``) on the CPU:
the header built with the host's C++ compiler, a warp's 32 lanes as 32
threads that meet at every shuffle, its row loop run for 1, 3 and 8 rows
and held limb for limb to the JAX package (the extended table to
``msm_table``, the cached table of -P to the per-signature ladder's
table of -A) and, in all four forms, to point_multiples' plain version;
and the warp shuffles a row that the layout implies, counted from its
functions and held to the shuffles the header runs (the machine code may
run fewer: nvcc shares the cached form's fetches of the constant 2d).
Exact: tolerance 0.

The layout is point_ladder's: one warp a row in four groups of 8 lanes,
lane l of a group holding limbs 4l .. 4l + 3 of every coordinate.  Group
g takes coordinate g ^ 1 of cached(P), the factor of its first product
in each addition; the 14 additions keep the reference's order (entry i =
entry i - 1 + cached(P) from entry 1 = P); group g stores coordinate g
of each entry.  The cached form's Y+X and Y-X come from every group, its
T * 2d from four group-split products after the loop (group g
multiplies the T of entries 4s + g).
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
from hotstuff_tpu_torch.ops import kern  # noqa: E402
from hotstuff_tpu_torch.ops.kern import point_chain as PC  # noqa: E402

import torch_lanes_harness as lanes_harness  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "hotstuff_tpu_torch", "ops", "kern", "csrc")
P = 2**255 - 19
D = -121665 * pow(121666, P - 2, P) % P

# The three cases of 1, 3 and 8 rows, as slices of one 12-row input
# (chip_smoke.multiples_inputs: 8 real points, one row of random weak
# limbs, then the identity, all-511 and all-0 rows): a real point alone,
# the three edge rows, and the other seven real points with the random
# row.
CASES = {1: slice(0, 1), 3: slice(9, 12), 8: slice(1, 9)}
FORMS = [(False, False), (True, True), (True, False), (False, True)]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def points(smoke):
    pts = smoke.multiples_inputs(np.random.default_rng(191), 12, "cpu")
    assert pts.shape == (12, 4, 32)
    return pts


@pytest.fixture(scope="module")
def jax_tables(points):
    """The JAX package's two tables of the 12 rows: ``msm_table`` and the
    per-signature ladder's cached table of -A, built as
    hotstuff_tpu/ops/ed25519.py builds it in ``verify_prepared``."""
    def ladder_table(pts):
        x, y, z, t = JE._unpack(pts)
        neg_a = (JF.neg(x), y, z, JF.neg(t))
        neg_a_cached = JE.to_cached_t(neg_a)
        entries = [JE.identity_t(pts.shape[:-2]), neg_a]
        for _ in range(2, 16):
            entries.append(JE.add_t(entries[-1], neg_a_cached))
        return jnp.stack([JE._pack(*JE.to_cached_t(e)) for e in entries],
                         axis=-3)

    p = jnp.asarray(points.numpy())
    return (np.asarray(jax.jit(JE.msm_table)(p)),
            np.asarray(jax.jit(ladder_table)(p)))


# ---------------------------------------------------------------------------
# The header on the host: a warp's lanes as threads
# ---------------------------------------------------------------------------

_ENTRY_POINTS = r"""
// Each row on one warp of 32 threads, as point_multiples_kernel runs it;
// returns the shuffles of the last row.
extern "C" long long hh_multiples(const int* pts, int* out, long long rows,
                                  int cached, int negate, const int* k2d) {
  std::barrier<> b(32);
  warp_barrier = &b;
  for (long long r = 0; r < rows; ++r) {
    shuffles = 0;
    std::vector<std::thread> lanes;
    for (int t = 0; t < 32; ++t) {
      lanes.emplace_back([&, t, r] {
        lane_id = t;
        const hl::Lane ln{t / hl::G, t % hl::G};
        if (cached) {
          hl::multiples_row<true>(pts + r * 128, out + r * 16 * 128,
                                  negate != 0, k2d, ln);
        } else {
          hl::multiples_row<false>(pts + r * 128, out + r * 16 * 128,
                                   negate != 0, k2d, ln);
        }
      });
    }
    for (auto& th : lanes) th.join();
  }
  return shuffles;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """field25519_lanes.cuh built with the host's C++ compiler into a
    ctypes library: the code the card runs, a warp's lanes as threads."""
    so = lanes_harness.build(tmp_path_factory, "multiples_harness",
                             _ENTRY_POINTS)
    so.hh_multiples.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p]
    so.hh_multiples.restype = ctypes.c_longlong
    return so


def _k2d_limbs() -> list:
    """2d from the kernel's source (field25519.cuh ``kK2D``)."""
    with open(os.path.join(CSRC, "field25519.cuh")) as f:
        body = re.search(r"kK2D\[32\] = \{(.*?)\};", f.read(), re.S)
    return [int(v) for v in body.group(1).replace("\n", " ").split(",")]


def test_kernel_constant_is_2d():
    assert _k2d_limbs() == [(2 * D % P >> (8 * i)) & 0xFF for i in range(32)]


def _run(harness, pts: torch.Tensor, cached: bool, negate: bool):
    """The header's table of ``pts`` and the shuffles of its last row."""
    pts = pts.contiguous()
    out = torch.full((pts.shape[0], 16, 4, 32), -1, dtype=torch.int32)
    k2d = torch.tensor(_k2d_limbs(), dtype=torch.int32)
    n = harness.hh_multiples(pts.data_ptr(), out.data_ptr(), pts.shape[0],
                             int(cached), int(negate), k2d.data_ptr())
    return out, n


@pytest.fixture(scope="module")
def header_tables(harness, points):
    """(rows, form) -> (table, shuffles of its last row), from the header."""
    return {(rows, form): _run(harness, points[sl], *form)
            for rows, sl in CASES.items() for form in FORMS}


@pytest.mark.parametrize("rows", sorted(CASES))
def test_header_extended_table_equals_jax_msm_table(header_tables,
                                                    jax_tables, rows):
    got, _ = header_tables[(rows, (False, False))]
    assert np.array_equal(got.numpy(), jax_tables[0][CASES[rows]])


@pytest.mark.parametrize("rows", sorted(CASES))
def test_header_cached_table_of_minus_p_equals_jax_ladder_table(
        header_tables, jax_tables, rows):
    got, _ = header_tables[(rows, (True, True))]
    assert np.array_equal(got.numpy(), jax_tables[1][CASES[rows]])


@pytest.mark.parametrize("form", FORMS,
                         ids=["extended", "cached-negated", "cached",
                              "extended-negated"])
@pytest.mark.parametrize("rows", sorted(CASES))
def test_header_table_equals_plain(header_tables, points, rows, form):
    got, _ = header_tables[(rows, form)]
    before = dict(kern.LAUNCHES)
    want = PC.point_multiples(points[CASES[rows]].contiguous(), *form)
    assert kern.LAUNCHES == before          # the CPU route: plain version
    assert torch.equal(got, want)
    assert torch.equal(want, PC.point_multiples_plain(
        points[CASES[rows]].contiguous(), *form))


def test_identity_entry_goes_through_the_ops(header_tables):
    """Entry 0 of the cached table is the identity's cached form as the
    ops leave it: Y - X = sub(1, 0) is 1 + 8p carried twice, weak limbs
    worth 1 mod p but not the limb 1; T * 2d = 0."""
    got, _ = header_tables[(3, (True, False))]
    ypx, ymx, z, t2d = got[0, 0].tolist()
    assert ypx == [1] + [0] * 31 and z == [1] + [0] * 31
    assert t2d == [0] * 32
    assert ymx != [1] + [0] * 31
    assert sum(v << (8 * i) for i, v in enumerate(ymx)) % P == 1


# ---------------------------------------------------------------------------
# Warp shuffles a row
# ---------------------------------------------------------------------------

# A lane holds L = 4 limbs, a group G = 8 lanes.  Each function's warp
# shuffles, as field25519_lanes.cuh runs them: a carry step shuffles one
# word; add is one carry step, sub (and neg) two; mul fetches b's top
# block and block 0 (two packed words a block), then in steps 1-7 the a
# block of another lane and, in steps 1-6, a b block (block 7 is the top
# it kept), and runs four carry steps; mul4 adds the exchange of the
# four products, two words from each group.
L, G = 4, 8
WORDS = L // 2
OPS = ("add", "sub", "mul", "mul4")
MUL = (1 + 1 + (G - 1) + (G - 2)) * WORDS + 4
SHFL = np.array([1, 2, MUL, MUL + 4 * WORDS])
# Ops a formula runs, in the order of OPS: add_cached is two mul4 phases,
# four adds and three subs; a cached entry's Y+X and Y-X one add, one sub.
ADD_CACHED = np.array([4, 3, 0, 2])
CACHED_ENTRY = np.array([1, 1, 0, 0])


def shuffles_a_row(cached: bool) -> int:
    """The layout's warp shuffles for one row: the two negations (always
    formed; ``negate`` selects), to_cached(P) (add, sub, mul) and the 14
    additions; cached, also each of the 16 entries' Y+X and Y-X and each
    group's four T * 2d products."""
    ops = np.array([1, 3, 1, 0]) + 14 * ADD_CACHED
    if cached:
        ops = ops + 16 * CACHED_ENTRY + np.array([0, 0, 4, 0])
    return int(ops @ SHFL)


def test_shuffle_count_of_the_layout():
    assert dict(zip(OPS, SHFL.tolist())) == {"add": 1, "sub": 2, "mul": 34,
                                             "mul4": 42}
    assert int(ADD_CACHED @ SHFL) == 94
    assert shuffles_a_row(False) == 1357
    assert shuffles_a_row(True) == 1541


@pytest.mark.parametrize("form", FORMS,
                         ids=["extended", "cached-negated", "cached",
                              "extended-negated"])
def test_header_runs_the_counted_shuffles(header_tables, form):
    """The header's shuffles a row (lane 0's, counted by the harness)
    equal the count above, in every form and at every row count."""
    for rows in CASES:
        _, n = header_tables[(rows, form)]
        assert n == shuffles_a_row(form[0])
