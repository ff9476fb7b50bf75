"""hotstuff_tpu_torch/ops/field381.py against the JAX package's
hotstuff_tpu/ops/field381.py on the CPU, limb for limb (tolerance zero:
the weak form of a residue is not unique, so equal limbs mean the same
carry schedule), on numpy-seeded batches: the Montgomery product, add,
sub, neg, reduce_sum, the conversions, a 64-deep chain, inversion, and
the constant tables byte for byte.  Also the Fq-power kernel wrapper's
plain route, which departs from the reference only where the reference's
chain leaves its exact range (inputs with a top limb of
fq12_chain.STABLE_TOP or more), and there gives the right values.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotstuff_tpu.ops import field381 as JF
from hotstuff_tpu_torch.ops import field381 as F
from hotstuff_tpu_torch.ops import kern
from hotstuff_tpu_torch.ops.kern import fq12_chain as FC

BATCH = 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The plain field ops are many small operators; one thread each keeps
    # parallel test workers (pytest-xdist) from oversubscribing the CPU.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weak(rng, n=BATCH):
    """(n, 48) weak-form limbs: random in [0, 512), with the all-511 and
    all-zero extremes, and Montgomery forms of random residues."""
    x = rng.integers(0, 512, (n, F.NLIMBS)).astype(np.int32)
    x[0] = 511
    x[1] = 0
    for i in range(2, n // 2):
        v = int.from_bytes(rng.bytes(48), "little") % F.Q
        x[i] = F.to_limbs(v * F.R % F.Q)
    return x


def _residues(rng, n=BATCH):
    """(n, 48) Montgomery forms of random residues (values below q)."""
    return np.stack([F.to_limbs(int.from_bytes(rng.bytes(48), "little")
                                % F.Q * F.R % F.Q) for _ in range(n)])


def _port(fn, *xs):
    return fn(*(torch.from_numpy(x) for x in xs)).numpy()


def _ref(fn, *xs):
    return np.asarray(fn(*(jnp.asarray(x) for x in xs)))


@pytest.mark.parametrize("name", ["mont_mul", "add", "sub"])
def test_binary_ops_equal_reference(name):
    rng = np.random.default_rng(1)
    a, b = _weak(rng), _weak(rng)
    assert np.array_equal(_port(getattr(F, name), a, b),
                          _ref(getattr(JF, name), a, b))


@pytest.mark.parametrize("name", ["neg", "to_mont", "from_mont"])
def test_unary_ops_equal_reference(name):
    a = _weak(np.random.default_rng(2))
    assert np.array_equal(_port(getattr(F, name), a),
                          _ref(getattr(JF, name), a))


def test_reduce_sum_equals_reference():
    """Digit arrays as the Fq12 tower feeds them: sums of up to 12 weak
    elements (limbs < 2^13), and after the fold's add and biased sub."""
    rng = np.random.default_rng(3)
    sums = sum(_weak(rng) for _ in range(12))
    folded = sums + 2 * _weak(rng) + F._BIAS_ARR
    for x in (sums, folded):
        assert np.array_equal(_port(F.reduce_sum, x), _ref(JF.reduce_sum, x))


def test_broadcasting_mont_mul_equals_reference():
    rng = np.random.default_rng(4)
    a = _weak(rng, 4)[:, None, :]
    b = _weak(rng, 3)[None, :, :]
    assert np.array_equal(_port(F.mont_mul, a, b), _ref(JF.mont_mul, a, b))


def test_64_deep_chain_equals_reference():
    """Limb bounds hold over long mixed chains: acc <- (acc - b) * b
    from any weak acc, with b a residue below q (as every operand of the
    pairing check is; a multiplier near 2^385 would grow the top limb
    each step, past the reference's exact f32 range)."""
    rng = np.random.default_rng(5)
    a, b = _weak(rng), _residues(rng)

    def chain(M, x, y):
        for _ in range(64):
            x = M.mont_mul(M.sub(x, y), y)
        return x

    got = chain(F, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax.jit(lambda x, y: chain(JF, x, y))(
        jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want)
    # and the values are right
    for g, x, y in zip(F.from_mont(torch.from_numpy(got)).numpy(), a, b):
        want_v = F.from_limbs(x) * pow(F.R, -1, F.Q) % F.Q
        yv = F.from_limbs(y) * pow(F.R, -1, F.Q) % F.Q
        for _ in range(64):
            want_v = (want_v - yv) * yv % F.Q
        assert F.from_limbs(g) == want_v


def _stable(rng, n=BATCH):
    """(n, 48) weak limbs whose top limb is below fq12_chain.STABLE_TOP:
    residues, zero, and random weak limbs."""
    x = _weak(rng, n)
    x[0] = 0
    x[1:n // 2] = _residues(rng, n // 2 - 1)
    x[:, -1] %= FC.STABLE_TOP
    return x


def _inverse_ok(got, a):
    canon = F.from_mont(torch.from_numpy(got)).numpy()
    for g, x in zip(canon, a):
        v = F.from_limbs(x) * pow(F.R, -1, F.Q) % F.Q
        assert F.from_limbs(g) == (pow(v, -1, F.Q) if v else 0)


def test_inv_equals_reference_and_leaves_the_kernels_alone():
    a = _stable(np.random.default_rng(6))
    before = dict(kern.LAUNCHES)
    got = _port(F.inv, a)
    assert kern.LAUNCHES == before          # the plain route counts nothing
    assert np.array_equal(got, _ref(JF.inv, a))
    _inverse_ok(got, a)


def test_inv_is_right_for_values_near_2_385():
    """A weak form whose top limb is STABLE_TOP or more (values up to
    ~2^385, as reduce_sum leaves them) would grow in the inversion's
    squarings past every exact range; the port brings it below 0.27 R
    first, so the inverse is right (the reference's is not: ROADMAP
    Queue C)."""
    a = _weak(np.random.default_rng(8))
    a[:, -1] = np.maximum(a[:, -1], FC.STABLE_TOP)
    a[1, -1] = 2 * FC.STABLE_TOP
    _inverse_ok(_port(F.inv, a), a)


def test_fq_pow_plain_route_equals_reference_pow_const():
    a = _stable(np.random.default_rng(7), 8)
    for e in (0, 1, 16, 0xDEADBEEF):
        assert np.array_equal(_port(lambda x: FC.fq_pow(x, e), a),
                              _ref(lambda x: JF.pow_const(x, e), a))


def test_exponent_digits_follow_the_reference_schedule():
    for e in (0, 1, 15, 16, F.Q - 2):
        digits = F.exponent_digits(e)
        assert sum(d << (4 * i) for i, d in enumerate(reversed(digits))) == e
        assert len(digits) == -(-max(1, e.bit_length()) // 4)


@pytest.mark.parametrize("name", ["_Q_LIMBS", "_QPRIME_LIMBS", "_BIAS_ARR",
                                  "_R_MOD_Q_LIMBS", "_P385_LIMBS"])
def test_constant_tables_are_byte_identical(name):
    mine, theirs = getattr(F, name), getattr(JF, name)
    assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
    assert mine.tobytes() == theirs.tobytes()


def test_constants_and_limb_helpers_match():
    for name in ("Q", "R", "R_MOD_Q", "R2_MOD_Q", "QPRIME"):
        assert getattr(F, name) == getattr(JF, name)
    x = 0x1234567890ABCDEF << 300
    assert F.to_limbs(x).tobytes() == JF.to_limbs(x).tobytes()
    assert F.from_limbs(F.to_limbs(x)) == JF.from_limbs(JF.to_limbs(x)) == x
    assert np.array_equal(F.mont_constant(5, "cpu").numpy(),
                          np.asarray(JF.mont_constant(5)))
