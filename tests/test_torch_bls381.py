"""hotstuff_tpu_torch/ops/bls381.py against the JAX package's
hotstuff_tpu/ops/bls381.py on the CPU, limb for limb (tolerance zero),
on numpy-seeded Fq12 elements: the Fq12 product, the Frobenius maps for
k = 1, 2, 6, the norm inversion, is_one, the Miller accumulation over
real 63-step Miller lines (two pairings, the QC check's shape; as
residues: the port returns canonical limbs), and the
host tables (``_FROB``, ``_HARD_EXP``, ``miller_lines``) byte for byte.
The kernel wrappers of ops/kern/fq12_chain.py run their plain versions
here.  The windowed power is in test_torch_bls381_pow.py, the whole
pairing check in test_torch_bls_verify.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotstuff_tpu.offchain import bls12381 as jhost
from hotstuff_tpu.ops import bls381 as JD
from hotstuff_tpu_torch.offchain import bls12381 as host
from hotstuff_tpu_torch.ops import bls381 as D
from hotstuff_tpu_torch.ops import field381 as F
from hotstuff_tpu_torch.ops import kern
from hotstuff_tpu_torch.ops.kern import fq12_chain as FC


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The plain Fq12 chains are thousands of small operators; one thread
    # each keeps parallel test workers (pytest-xdist) from
    # oversubscribing the CPU.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fq12(rng, n):
    """(n, 12, 48) Montgomery forms of random Fq12 elements."""
    return np.stack([D.host_fq12_to_mont_limbs(
        [int.from_bytes(rng.bytes(48), "little") % F.Q for _ in range(12)])
        for _ in range(n)])


def _canon(x) -> list:
    """(n, 12, 48) Montgomery limbs -> host Fq12 tuples."""
    c = F.from_mont(torch.as_tensor(np.asarray(x))).numpy()
    return [tuple(F.from_limbs(r) for r in row) for row in c]


@pytest.fixture(scope="module")
def elems():
    rng = np.random.default_rng(41)
    return _fq12(rng, 4), _fq12(rng, 4)


def test_fq12_mul_equals_reference(elems):
    x, y = elems
    got = D.fq12_mul(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.array_equal(got, np.asarray(JD.fq12_mul(jnp.asarray(x),
                                                      jnp.asarray(y))))
    assert _canon(got) == [host.fq12_mul(a, b)
                           for a, b in zip(_canon(x), _canon(y))]


def test_fq12_mul_broadcasts_like_the_reference(elems):
    x, y = elems
    got = D.fq12_mul(torch.from_numpy(x[:, None]), torch.from_numpy(y[None]))
    want = JD.fq12_mul(jnp.asarray(x[:, None]), jnp.asarray(y[None]))
    assert got.shape == (4, 4, 12, 48)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 2, 6])
def test_fq12_frobenius_equals_reference(elems, k):
    x = elems[0]
    got = D.fq12_frobenius(torch.from_numpy(x), k).numpy()
    assert np.array_equal(got, np.asarray(JD.fq12_frobenius(jnp.asarray(x),
                                                            k)))
    assert _canon(got) == [host.fq12_pow(a, F.Q ** k) for a in _canon(x)]


@pytest.fixture(scope="module")
def lines():
    """Real Miller lines: (pk, H(m)) and (-g1, sig) for one signature."""
    sk, pk = host.key_gen(b"\x05" * 32)
    msg = b"\x33" * 32
    return np.stack([D.miller_lines(pk, host.hash_to_g2(msg)),
                     D.miller_lines(host.g1_neg(host.g1_generator()),
                                    host.sign(sk, msg))])


@pytest.fixture(scope="module")
def by_norm():
    """24 random Fq12 elements split by the top limb of fq12_inv's norm
    N = f * prod_k f^(q^k): (below fq12_chain.STABLE_TOP, at or above)."""
    x = _fq12(np.random.default_rng(9), 24)
    xt = torch.from_numpy(x)
    g = D.fq12_frobenius(xt, 1)
    for k in range(2, 12):
        g = D.fq12_mul(g, D.fq12_frobenius(xt, k))
    high = (D.fq12_mul(xt, g)[:, 0, -1] >= FC.STABLE_TOP).numpy()
    return x[~high], x[high]


def test_fq12_inv_equals_reference(by_norm):
    """Rows whose norm's top limb is below fq12_chain.STABLE_TOP follow
    the reference limb for limb."""
    x = by_norm[0][:4]
    assert len(x) == 4
    got = D.fq12_inv(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(JD.fq12_inv(jnp.asarray(x))))
    assert all(host.fq12_mul(a, b) == host.FQ12_ONE
               for a, b in zip(_canon(x), _canon(got)))


def test_fq12_inv_is_right_where_the_norm_is_near_2_385(by_norm):
    """A norm N = f * g whose weak form is near 2^385 (its top limb at
    least STABLE_TOP) would grow past int32 and f32 exactness in the
    inversion's squarings; fq_pow brings it down first, so the inverse
    is right.  These seeds give such norms."""
    x = by_norm[1]
    assert len(x) >= 3
    got = D.fq12_inv(torch.from_numpy(x)).numpy()
    assert all(host.fq12_mul(a, b) == host.FQ12_ONE
               for a, b in zip(_canon(x), _canon(got)))


def test_is_one_and_fq12_one():
    one = D.fq12_one((3,))
    assert np.array_equal(one.numpy(), np.asarray(JD.fq12_one((3,))))
    assert D.is_one(one).tolist() == [True] * 3
    x = _fq12(np.random.default_rng(2), 2)
    assert D.is_one(torch.from_numpy(x)).tolist() == [False, False]
    assert np.array_equal(D.is_one(torch.from_numpy(x)).numpy(),
                          np.asarray(JD.is_one(jnp.asarray(x))))


def test_miller_accumulate_equals_reference(lines):
    """The port's Miller values are canonical limbs (the tower kernel's
    output); the reference's are weak, so they compare as residues:
    field381.canonical of the reference's, limb for limb."""
    before = dict(kern.LAUNCHES)
    got = D.miller_accumulate(torch.from_numpy(lines)).numpy()
    assert kern.LAUNCHES == before          # the plain route counts nothing
    want = np.array(jax.jit(JD.miller_accumulate)(jnp.asarray(lines)))
    assert got.shape == (2, 12, 48)
    assert np.array_equal(got, F.canonical(torch.from_numpy(want)).numpy())
    # The host Miller loop returns the inverse (the BLS_X sign).
    sk, pk = host.key_gen(b"\x05" * 32)
    f = host.miller_loop(host._twist(host.hash_to_g2(b"\x33" * 32)),
                         host._cast_g1_fq12(pk))
    assert host.fq12_mul(_canon(got)[0], f) == host.FQ12_ONE


def test_host_tables_are_byte_identical(lines):
    assert sorted(D._FROB) == sorted(JD._FROB) == list(range(1, 12))
    for k in range(1, 12):
        assert D._FROB[k].dtype == JD._FROB[k].dtype
        assert D._FROB[k].tobytes() == JD._FROB[k].tobytes()
    assert D._HARD_EXP == JD._HARD_EXP and D.N_STEPS == JD.N_STEPS == 63
    sk, pk = jhost.key_gen(b"\x05" * 32)
    msg = b"\x33" * 32
    want = np.stack([JD.miller_lines(pk, jhost.hash_to_g2(msg)),
                     JD.miller_lines(jhost.g1_neg(jhost.g1_generator()),
                                     jhost.sign(sk, msg))])
    assert lines.dtype == want.dtype and lines.tobytes() == want.tobytes()
    v = tuple(range(12))
    assert (D.host_fq12_to_mont_limbs(v).tobytes()
            == JD.host_fq12_to_mont_limbs(v).tobytes())


def test_kernel_wrappers_take_the_plain_route_on_the_cpu(elems):
    x, y = (torch.from_numpy(a) for a in elems)
    before = dict(kern.LAUNCHES)
    assert torch.equal(FC.fq12_mul(x, y), FC.fq12_mul_plain(x, y))
    assert torch.equal(FC.fq12_pow(x[:1], 77), FC.fq12_pow_plain(x[:1], 77))
    assert torch.equal(FC.fq_pow(x[:, 0], 77), FC.fq_pow_plain(x[:, 0], 77))
    assert kern.LAUNCHES == before
    with pytest.raises(ValueError):
        FC.fq12_mul(x[:, :6].contiguous(), y[:, :6].contiguous())
    with pytest.raises(TypeError):
        FC.fq12_mul(x.long(), y.long())
