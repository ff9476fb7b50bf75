"""The RLC program's fused scalar kernels (hotstuff_tpu_torch.ops.kern.
scalar_rlc), their plain versions held to the JAX package's composition
(ops/ed25519.rlc_partials' scalar steps, scalar25519.reduce_limbsum_mod_l)
and to Python integers, on the same numpy-seeded inputs.  Exact: integer
arithmetic, tolerance 0.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hotstuff_tpu.ops import ed25519 as JE  # noqa: E402
from hotstuff_tpu.ops import scalar25519 as JS  # noqa: E402
from hotstuff_tpu_torch.ops.kern import scalar_rlc as SR  # noqa: E402
from hotstuff_tpu_torch.utils.intmath import L  # noqa: E402

R = 1 << 256


def _rows(vals) -> np.ndarray:
    return np.array([[(v >> (8 * i)) & 0xFF for i in range(32)]
                     for v in vals], np.int32)


def _value(row) -> int:
    return sum(int(b) << (8 * i) for i, b in enumerate(row))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


@jax.jit
def _jax_rlc_scalars(z_l, k_l, s_l):
    """The JAX package's scalar steps of rlc_partials
    (hotstuff_tpu/ops/ed25519.py:797-819), on int32 rows."""
    present = jnp.any(z_l != 0, axis=-1)
    w = JS.mul_mod_l(z_l, k_l)
    u = JS.mul_mod_l(z_l, s_l)
    present_i = present.astype(jnp.int32)
    t_w = (5 * ((k_l[..., 0] & 7) - (w[..., 0] & 7))) % 8 * present_i
    t_z = (5 * (1 - (z_l[..., 0] & 7))) % 8 * present_i
    w_lift = JS.add_small_multiple_of_l(w, t_w)
    z_lift = JS.add_small_multiple_of_l(z_l, t_z)
    digits = JE.unpack_nibbles_msb(jnp.concatenate([w_lift, z_lift], axis=0))
    return digits, u


@pytest.fixture(scope="module")
def scalar_case():
    """24 rows: random z, k < L and S < 2^256, then boundary rows (an
    all-zero z, z = 1 with k = S = L - 1, z = k = S = L - 1, S = 2^256 - 1)
    and z and k over every low 3-bit value."""
    rng = np.random.default_rng(31)

    def rand(bound, n=24):
        return [int.from_bytes(rng.bytes(32), "little") % bound
                for _ in range(n)]

    zv, kv, sv = rand(L), rand(L), rand(R)
    zv[0] = 0
    zv[1], kv[1], sv[1] = 1, L - 1, L - 1
    zv[2], kv[2], sv[2] = L - 1, L - 1, L - 1
    sv[3] = R - 1
    for i in range(8):
        zv[4 + i] = (zv[4 + i] & ~7) | i
        kv[4 + i] = (kv[4 + i] & ~7) | (7 - i)
        kv[12 + i] = (kv[12 + i] & ~7) | i
    return _rows(zv), _rows(kv), _rows(sv)


def test_rlc_scalars_plain_matches_jax_composition(scalar_case):
    z, k, s = scalar_case
    jdigits, ju = (np.asarray(x) for x in _jax_rlc_scalars(
        jnp.asarray(z), jnp.asarray(k), jnp.asarray(s)))
    digits, u = SR.rlc_scalars_plain(_t(z), _t(k), _t(s))
    assert digits.shape == (2 * len(z), 64) and u.shape == z.shape
    assert np.array_equal(digits.numpy(), jdigits)
    assert np.array_equal(u.numpy(), ju)
    # The wrapper on a CPU tensor is the plain version.
    wd, wu = SR.rlc_scalars(_t(z), _t(k), _t(s))
    assert torch.equal(wd, digits) and torch.equal(wu, u)


def test_rlc_scalars_plain_matches_python_ints(scalar_case):
    z, k, s = scalar_case
    digits, u = SR.rlc_scalars_plain(_t(z), _t(k), _t(s))
    n = len(z)
    for i in range(n):
        zi, ki, si = _value(z[i]), _value(k[i]), _value(s[i])
        assert _value(u[i].numpy()) == zi * si % L
        nib = digits.numpy()
        w_lift = sum(int(d) << (4 * (63 - j)) for j, d in enumerate(nib[i]))
        z_lift = sum(int(d) << (4 * (63 - j))
                     for j, d in enumerate(nib[n + i]))
        if zi == 0:
            assert w_lift == z_lift == 0      # an excluded row
            continue
        assert w_lift % L == zi * ki % L and w_lift % 8 == ki % 8
        assert z_lift % L == zi and z_lift % 8 == 1
        assert w_lift < 8 * L and z_lift < 8 * L


@pytest.mark.parametrize("rows", [1, 2, 64, 1024])
def test_rlc_reduce_plain_matches_jax_and_ints(rows):
    rng = np.random.default_rng(rows)
    vals = [int.from_bytes(rng.bytes(32), "little") % L
            for _ in range(rows)]
    vals[0] = L - 1
    u = _rows(vals)
    cases = [u.sum(axis=0, dtype=np.int32),           # a real limb sum
             _rows([L - 1])[0] * rows]                # rows copies of L - 1
    want_ints = [sum(vals) % L, (L - 1) * rows % L]
    sums = np.stack(cases)
    got = SR.rlc_reduce_plain(_t(sums)).numpy()
    assert np.array_equal(got, np.asarray(
        JS.reduce_limbsum_mod_l(jnp.asarray(sums))))
    assert [_value(r) for r in got] == want_ints
    assert torch.equal(SR.rlc_reduce(_t(sums[0])), _t(got[0]))


def test_rlc_reduce_plain_at_the_limb_bound():
    rng = np.random.default_rng(5)
    sums = rng.integers(0, 1 << 24, (16, 32)).astype(np.int32)
    sums[0] = (1 << 24) - 1
    sums[1] = 0
    got = SR.rlc_reduce_plain(_t(sums)).numpy()
    assert np.array_equal(got, np.asarray(
        JS.reduce_limbsum_mod_l(jnp.asarray(sums))))
    assert [_value(r) for r in got] == [
        sum(int(v) << (8 * i) for i, v in enumerate(row)) % L
        for row in sums]


def test_scalar_rlc_wrappers_reject_bad_inputs():
    z = torch.zeros((4, 32), dtype=torch.int32)
    with pytest.raises(TypeError):
        SR.rlc_scalars(z.long(), z, z)
    with pytest.raises(ValueError):
        SR.rlc_scalars(z, z[:3], z)
    with pytest.raises(ValueError):
        SR.rlc_scalars(z, z, z.t().contiguous().t())
    with pytest.raises(ValueError):
        SR.rlc_reduce(z[:, :16].contiguous())
    with pytest.raises(TypeError):
        SR.rlc_reduce(z.float())


def test_scalar_rlc_kernel_constants_match_the_group_order():
    """The byte tables compiled into csrc/scalar_rlc.cu equal L, its
    multiples and its Montgomery constants at R = 2^256."""
    src = (Path(SR.__file__).parent / "csrc" / "scalar_rlc.cu").read_text()
    tables = {name: [int(v) for v in body.replace("\n", " ").split(",")]
              for name, body in re.findall(
                  r"__constant__ int (\w+)\[32\] = \{([^}]*)\};", src)}
    want = {"kL": L, "kLPrime": (-pow(L, -1, R)) % R, "kR2": R * R % L,
            "k2L": 2 * L, "k4L": 4 * L, "k8L": 8 * L}
    assert {n: _value(v) for n, v in tables.items()} == want
