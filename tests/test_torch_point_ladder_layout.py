"""point_ladder's Hopper layout (csrc/field25519_lanes.cuh) on the CPU:
the wrapper's CPU route, a numpy model of the lane-group multiply's
schedule held limb for limb to the JAX package's multiply, and
point_ladder's plain version (what the kernel is held to on the card)
held to the JAX package's ladder at the committee's 3 rows and on a
table of weak-form extremes.  Exact: tolerance 0.

The model follows the header line by line: lane l of a group of 8 lanes
holds limbs 4l .. 4l + 3, packs them two to a word, and in step t takes
the a block of lane (l - t) mod 8, times 38 where the step wraps
(t > l), and the b window of blocks t - 1 and t; each of its four carry
steps takes one shuffle.
"""

from __future__ import annotations

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


def test_point_ladder_runs_its_plain_version_on_the_cpu():
    rng = np.random.default_rng(30)
    table = PC.point_multiples(E.basepoint_ext("cpu").expand(2, 4, 32)
                               .contiguous(), cached=True).unsqueeze(1)
    digits = torch.from_numpy(rng.integers(0, 16, (2, 3)).astype(np.int32))
    before = dict(kern.LAUNCHES)
    want = PC.point_ladder_plain(table, digits, 4)
    assert torch.equal(PC.point_ladder(table, digits, 4), want)
    assert kern.LAUNCHES == before
    with pytest.raises(ValueError, match="ndbl"):
        PC.point_ladder(table, digits, 2)


# ---------------------------------------------------------------------------
# The lane-group multiply's schedule
# ---------------------------------------------------------------------------

class _Group:
    """The 8 lanes of a group run in lockstep over n operand rows:
    ``shfl`` is one warp shuffle of one word a lane (counted), and
    ``note`` keeps the largest value any lane holds."""

    L, G = 4, 8

    def __init__(self):
        self.shuffles = 0
        self.largest = 0

    def shfl(self, words, src):
        self.shuffles += 1
        return [words[s] for s in src]

    def note(self, x):
        self.largest = max(self.largest, int(np.abs(x).max()))
        return x

    def pack(self, blocks):      # limbs 2w, 2w + 1 of a block in word w
        return [[blk[:, 2 * w] | (blk[:, 2 * w + 1] << 16)
                 for w in range(self.L // 2)] for blk in blocks]

    def fetch(self, words, src):     # the block of lane src[l], per lane
        got = [self.shfl([wl[w] for wl in words], src)
               for w in range(self.L // 2)]
        out = []
        for lane in range(self.G):
            blk = np.empty((got[0][0].shape[0], self.L), np.int64)
            for w in range(self.L // 2):
                word = self.note(got[w][lane])
                blk[:, 2 * w], blk[:, 2 * w + 1] = word & 0xFFFF, word >> 16
            out.append(blk)
        return out

    def carry_step(self, x):
        """One parallel carry step; x is per lane (n, L).  Each lane
        takes the top limb of the lane below (one shuffle), lane 0 that
        of lane 7, times 38."""
        below = self.shfl([blk[:, self.L - 1] for blk in x],
                          [(lane - 1) % self.G for lane in range(self.G)])
        out = []
        for lane, blk in enumerate(x):
            r = np.empty_like(blk)
            up = below[lane] >> 8
            r[:, 0] = (blk[:, 0] & 0xFF) + up * (38 if lane == 0 else 1)
            for v in range(1, self.L):
                r[:, v] = (blk[:, v] & 0xFF) + (blk[:, v - 1] >> 8)
            out.append(self.note(r))
        return out


def _lanes_mul_model(a: np.ndarray, b: np.ndarray):
    """(n, 32) weak limbs -> (a * b by the header's mul schedule, the
    largest value any lane held, the warp shuffles one multiply took)."""
    grp = _Group()
    L, G = grp.L, grp.G
    own_a = [a[:, L * lane:L * lane + L].astype(np.int64)
             for lane in range(G)]
    own_b = [b[:, L * lane:L * lane + L].astype(np.int64)
             for lane in range(G)]
    aw, bw = grp.pack(own_a), grp.pack(own_b)
    top = grp.fetch(bw, [G - 1] * G)
    cur = grp.fetch(bw, [0] * G)
    acc = []
    for lane in range(G):            # t = 0: the own a block
        blk = np.zeros((a.shape[0], L), np.int64)
        for v in range(L):
            for u in range(L):
                blk[:, v] += grp.note(
                    own_a[lane][:, u] * cur[lane][:, v - u] if u <= v else
                    grp.note(38 * own_a[lane][:, u])
                    * top[lane][:, L + v - u])
                grp.note(blk[:, v])
        acc.append(blk)
    prev = cur
    for t in range(1, G):
        cur = top if t == G - 1 else grp.fetch(bw, [t] * G)
        am = grp.fetch(aw, [(lane - t) % G for lane in range(G)])
        for lane in range(G):
            blk_a = grp.note(am[lane] * (1 if t <= lane else 38))
            for v in range(L):
                for u in range(L):
                    acc[lane][:, v] += grp.note(
                        blk_a[:, u] * (cur[lane][:, v - u] if u <= v
                                       else prev[lane][:, L + v - u]))
                    grp.note(acc[lane][:, v])
        prev = cur
    x = acc
    for _ in range(4):
        x = grp.carry_step(x)
    return (np.concatenate(x, axis=1).astype(np.int32), grp.largest,
            grp.shuffles)


@pytest.fixture(scope="module")
def jax_mul():
    return jax.jit(JF.mul)


def _operands(case):
    """Seeded weak limbs, or rows of the weak form's extremes."""
    rng = np.random.default_rng(31)
    full = np.full((1, 32), 511, np.int32)
    zero = np.zeros((1, 32), np.int32)
    return {"seeded": (rng.integers(0, 512, (64, 32)).astype(np.int32),
                       rng.integers(0, 512, (64, 32)).astype(np.int32)),
            "all511": (full, full),
            "all0": (zero, zero),
            "mixed": (np.concatenate([full, zero]),
                      np.concatenate([zero, full]))}[case]


@pytest.mark.parametrize("case", ["seeded", "all511", "all0", "mixed"])
def test_lanes_mul_model_equals_jax_mul_limb_for_limb(jax_mul, case):
    a, b = _operands(case)
    got, largest, shuffled = _lanes_mul_model(a, b)
    want = np.asarray(jax_mul(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want)
    assert largest < 2**31
    assert shuffled == 34     # 30 for the products, 4 for the carries


# ---------------------------------------------------------------------------
# point_ladder's plain version against the JAX package's ladder
# ---------------------------------------------------------------------------

def _jax_ladder(table, digits):
    """verify_prepared's per-signature ladder (the tuple branch), on the
    JAX package's own formulas: per-row cached tables (B, 16, 4, 32)."""
    table_t = tuple(table[:, :, c, :] for c in range(4))

    def body(p, digit_row):
        p = JE.dbl_t(p, with_t=False)
        p = JE.dbl_t(p, with_t=False)
        p = JE.dbl_t(p, with_t=False)
        p = JE.dbl_t(p)
        idx = digit_row[:, None, None]
        return JE.add_t(p, tuple(jnp.take_along_axis(tc, idx, axis=1)[:, 0]
                                 for tc in table_t)), None

    acc, _ = jax.lax.scan(body, JE.identity_t(digits.shape[:1]),
                          jnp.moveaxis(digits, -1, 0))
    return JE._pack(*acc)


@pytest.fixture(scope="module")
def jax_ladder():
    return jax.jit(_jax_ladder)


@pytest.mark.parametrize("case", ["real", "all511"])
def test_point_ladder_plain_at_3_rows_equals_jax_ladder(jax_ladder, case):
    rng = np.random.default_rng(32)
    if case == "real":
        pts = PC.point_multiples(E.basepoint_ext("cpu").expand(1, 4, 32)
                                 .contiguous())[0, 1:4].contiguous()
        table = PC.point_multiples(pts, cached=True, negate=True)
    else:
        table = torch.full((3, 16, 4, 32), 511, dtype=torch.int32)
    digits = rng.integers(0, 16, (3, 64)).astype(np.int32)
    digits[0, :8] = 0
    digits[1, :8] = 15
    got = PC.point_ladder_plain(table.unsqueeze(1), torch.from_numpy(digits),
                                4)
    want = np.asarray(jax_ladder(jnp.asarray(table.numpy()),
                                 jnp.asarray(digits)))
    assert np.array_equal(got.numpy(), want)
