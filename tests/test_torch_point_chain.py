"""The point-chain kernels' plain versions (hotstuff_tpu_torch.ops.kern.
point_chain: point_ladder, decompress, point_multiples), held to the JAX
package on the same numpy-seeded inputs, and the per-signature ladder
to python-int scalar multiplication.  Exact: integer arithmetic,
tolerance 0, limb for limb (the python-int oracle compares affine
coordinates).

Every JAX function runs at one shape, jitted once, at a tiny size.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hotstuff_tpu.ops import ed25519 as JE  # noqa: E402
from hotstuff_tpu.ops import field25519 as JF  # noqa: E402
from hotstuff_tpu_torch.crypto import ref_ed25519 as ref  # noqa: E402
from hotstuff_tpu_torch.ops import ed25519 as E  # noqa: E402
from hotstuff_tpu_torch.ops import field25519 as F  # noqa: E402
from hotstuff_tpu_torch.ops import kern  # noqa: E402
from hotstuff_tpu_torch.ops.kern import point_chain as PC  # noqa: E402
from hotstuff_tpu_torch.utils.intmath import L, P  # noqa: E402


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.array(x)))


def _keys(n, tag):
    return [ref.generate_keypair(bytes([tag]) * 31 + bytes([i + 1]))
            for i in range(n)]


def _affine(pt) -> tuple[int, int]:
    """(4, 32) ext limbs -> affine (x, y) as python ints."""
    x, y, z = (F.from_limbs(np.asarray(pt[c])) for c in range(3))
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


@pytest.fixture(scope="module")
def points():
    """(6, 4, 32) ext points of six real public keys (the plain
    decompression), and the keys' python-int points."""
    pks = [pk for _, pk in _keys(6, 3)]
    y, s = E.split_y_sign(_t(np.stack([np.frombuffer(pk, np.uint8)
                                       for pk in pks])))
    pts, ok = PC.decompress_plain(y, s)
    assert bool(ok.all())
    return pts, [ref.decode_point(pk) for pk in pks]


def test_decompress_plain_matches_jax_on_valid_nonsquare_and_x0():
    rng = np.random.default_rng(11)
    enc = [np.frombuffer(pk, np.uint8) for _, pk in _keys(4, 4)]
    # x = 0 (y = 1 with either sign, and y = -1), a non-square y, y = 0,
    # then random y and sign bits (about half of them non-square).
    special = [1, 1 | (1 << 255), P - 1, 2, 0, 5 | (1 << 255)]
    enc += [np.frombuffer(v.to_bytes(32, "little"), np.uint8)
            for v in special]
    enc += list(rng.integers(0, 256, (14, 32)).astype(np.uint8))
    arr = np.stack(enc)
    jy, js = JE.split_y_sign(jnp.asarray(arr))
    jpts, jok = jax.jit(JE.decompress)(jy, js)
    y, s = E.split_y_sign(_t(arr))
    pts, ok = PC.decompress(y, s)
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert np.array_equal(pts.numpy(), np.asarray(jpts))
    assert ok.dtype == torch.bool and ok[:4].all() and ok[4] and not ok[5]
    assert not ok[7]                             # 2 is not a square
    # Valid rows decode to the python-int point.
    for i in np.flatnonzero(ok.numpy()):
        want = ref.decode_point(arr[i].tobytes())
        assert _affine(pts[i]) == (want[0], want[1])


def test_point_multiples_plain_matches_jax_msm_table(points):
    pts, _ = points
    got = PC.point_multiples(pts)
    assert got.shape == (6, 16, 4, 32)
    assert np.array_equal(got.numpy(), np.asarray(
        jax.jit(JE.msm_table)(jnp.asarray(pts.numpy()))))


def _jax_neg_cached_table(p):
    """The JAX per-signature program's table: cached 0..15 * (-A)."""
    ax, ay, az, at = JE._unpack(p)
    neg_a = (JF.neg(ax), ay, az, JF.neg(at))
    nac = JE.to_cached_t(neg_a)
    entries = [JE.identity_t(p.shape[:-2]), neg_a]
    for _ in range(2, 16):
        entries.append(JE.add_t(entries[-1], nac))
    return jnp.stack([JE._pack(*JE.to_cached_t(e)) for e in entries],
                     axis=-3)


def test_point_multiples_cached_negated_matches_jax_ladder_table(points):
    pts, _ = points
    got = PC.point_multiples(pts, cached=True, negate=True)
    assert np.array_equal(got.numpy(), np.asarray(
        jax.jit(_jax_neg_cached_table)(jnp.asarray(pts.numpy()))))


def test_point_ladder_as_per_signature_ladder_matches_python_ints(points):
    pts, host = points
    rng = np.random.default_rng(12)
    ks = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(6)]
    ks[0], ks[1] = 0, L - 1
    k_bytes = _t(np.stack([np.frombuffer(k.to_bytes(32, "little"), np.uint8)
                           for k in ks]))
    table = PC.point_multiples(pts, cached=True, negate=True)
    got = PC.point_ladder(table.unsqueeze(1),
                          E.unpack_nibbles_msb(k_bytes), 4)
    for row, k, (x, y, z, t) in zip(got, ks, host):
        want = ref.scalar_mult(k, ((-x) % P, y, z, (-t) % P))
        zi = pow(want[2], P - 2, P)
        assert _affine(row) == (want[0] * zi % P, want[1] * zi % P)


def test_point_ladder_as_horner_matches_jax_msm_horner(points):
    pts, _ = points
    rng = np.random.default_rng(13)
    # 64 window sums: real points' multiples, some the identity.
    table = PC.point_multiples(pts).reshape(-1, 4, 32)
    wsums = table[torch.from_numpy(rng.integers(0, table.shape[0], 64))]
    got = E.msm_horner(wsums.contiguous())
    assert got.shape == (4, 32)
    assert np.array_equal(got.numpy(), np.asarray(
        jax.jit(JE.msm_horner)(jnp.asarray(wsums.numpy()))))


def test_point_ladder_as_comb_matches_jax_comb_mul_base():
    rng = np.random.default_rng(14)
    c = rng.integers(0, 256, (3, 32)).astype(np.int32)
    c[1, 31] = 0x0F
    jcomb = jax.jit(JE.comb_mul_base)
    got = [E.comb_mul_base(_t(row)) for row in c]
    for row, g in zip(c, got):
        assert np.array_equal(g.numpy(), np.asarray(jcomb(jnp.asarray(row))))
    # The per-signature program's comb: the same table for every row.
    rows = PC.point_ladder(E.comb_table_on("cpu").unsqueeze(0), _t(c), 0)
    assert np.array_equal(rows.numpy(), np.stack([g.numpy() for g in got]))


def test_point_ladder_shared_and_per_row_tables_agree(points):
    pts, _ = points
    rng = np.random.default_rng(15)
    table = PC.point_multiples(pts[:1], cached=True)        # (1, 16, 4, 32)
    digits = _t(rng.integers(0, 16, (3, 5)).astype(np.int32))
    shared = PC.point_ladder(table.unsqueeze(1), digits, 4)  # Bt 1, J 1
    per_row = PC.point_ladder(table.unsqueeze(1).expand(3, 1, 16, 4, 32)
                              .contiguous(), digits, 4)      # Bt B
    per_step = PC.point_ladder(table.unsqueeze(1).expand(1, 5, 16, 4, 32)
                               .contiguous(), digits, 4)     # J S
    assert torch.equal(shared, per_row) and torch.equal(shared, per_step)
    # Zero steps leave the identity.
    empty = PC.point_ladder(table.unsqueeze(1), digits[:, :0], 4)
    assert torch.equal(empty, E.identity_ext((3,)))


def test_point_chain_wrappers_check_inputs_and_count_nothing_on_cpu(points):
    pts, _ = points
    before = dict(kern.LAUNCHES)
    table = PC.point_multiples(pts[:2], cached=True).unsqueeze(1)
    digits = torch.zeros((2, 4), dtype=torch.int32)
    PC.point_ladder(table, digits, 4)
    assert kern.LAUNCHES == before          # the plain route counts nothing
    with pytest.raises(TypeError):
        PC.point_ladder(table, digits.long(), 4)
    with pytest.raises(ValueError):
        PC.point_ladder(table[:, :, :, :3], digits, 4)
    with pytest.raises(ValueError, match="does not fit"):
        PC.point_ladder(table, torch.zeros((3, 4), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="ndbl"):
        PC.point_ladder(table, digits, 9)
    y = torch.zeros((2, 32), dtype=torch.int32)
    with pytest.raises(ValueError):
        PC.decompress(y[:, :31].contiguous(), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        PC.decompress(y, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        PC.point_multiples(pts.unsqueeze(0))
    with pytest.raises(ValueError, match="contiguous"):
        PC.point_multiples(pts.transpose(0, 1).contiguous().transpose(0, 1))
