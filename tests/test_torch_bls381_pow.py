"""The windowed Fq12 power of hotstuff_tpu_torch/ops/bls381.py (the final
exponentiation's loop) against the JAX package's fq12_pow_const on the
CPU, limb for limb (tolerance zero), with a short exponent.  On the CPU
the kernel wrapper of ops/kern/fq12_chain.py runs its plain version.
The JAX program compiles a lax.scan body of five Fq12 products, about a
minute on this CPU, so it has a file of its own.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotstuff_tpu.ops import bls381 as JD
from hotstuff_tpu_torch.offchain import bls12381 as host
from hotstuff_tpu_torch.ops import bls381 as D
from hotstuff_tpu_torch.ops import field381 as F


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The plain Fq12 chains are thousands of small operators; one thread
    # each keeps parallel test workers (pytest-xdist) from
    # oversubscribing the CPU.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _canon(x) -> list:
    """(n, 12, 48) Montgomery limbs -> host Fq12 tuples."""
    c = F.from_mont(torch.as_tensor(np.asarray(x))).numpy()
    return [tuple(F.from_limbs(r) for r in row) for row in c]


def test_fq12_pow_const_equals_reference():
    rng = np.random.default_rng(43)
    x = np.stack([D.host_fq12_to_mont_limbs(
        [int.from_bytes(rng.bytes(48), "little") % F.Q for _ in range(12)])
        for _ in range(2)])
    e = 0x9A3
    got = D.fq12_pow_const(torch.from_numpy(x), e).numpy()
    want = np.asarray(JD.fq12_pow_const(jnp.asarray(x), e))
    assert np.array_equal(got, want)
    assert _canon(got) == [host.fq12_pow(a, e) for a in _canon(x)]
