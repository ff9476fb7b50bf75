"""hotstuff_tpu_torch.ops.ed25519's one-MSM RLC program held to the JAX
package's at one small bucket (B = 8): the combined verdict on an
all-valid batch, on a batch with forged rows, and on an all-excluded
batch, and the partials feeding it (window sums limb for limb, the
limb-wise scalar sum, the bad-point count).  Exact.

The JAX programs take tens of seconds to compile on the CPU; every case
runs at one shape, so each compiles once.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hotstuff_tpu.crypto import eddsa as JD  # noqa: E402
from hotstuff_tpu.ops import ed25519 as JE  # noqa: E402
from hotstuff_tpu_torch.crypto import ref_ed25519 as ref  # noqa: E402
from hotstuff_tpu_torch.ops import ed25519 as E  # noqa: E402


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def verify_case():
    """Eight prepared rows (the JAX package's host preparation), and a
    copy with a forged S, a wrong-message challenge and a
    non-decompressible R."""
    keys = [ref.generate_keypair(bytes([9]) * 31 + bytes([i + 1]))
            for i in range(8)]
    msgs = [bytes([9, i]) * 16 for i in range(8)]
    sigs = [ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    good = JD.prepare_batch(msgs, [pk for _, pk in keys], sigs)["packed"]
    bad = good.copy()
    bad[2, 64] ^= 1                        # forged S
    bad[4, 96:128] = bad[5, 96:128]        # challenge of another row
    bad[6, 32:64] = np.frombuffer((2).to_bytes(32, "little"), np.uint8)
    return good, bad


def _cases(good, bad):
    z = JD._rlc_coeffs(good, b"")
    zero = np.zeros_like(z)
    skip_bad = z.copy()
    skip_bad[[2, 4, 6]] = 0                # all-zero rows are excluded
    return [(good, z), (bad, z), (good, zero), (bad, skip_bad)]


_jpartials = jax.jit(JE.rlc_partials)


def test_rlc_partials_match_jax(verify_case):
    good, bad = verify_case
    counts = []
    for packed, z in _cases(good, bad):
        jw, ju, jbad = (np.asarray(x) for x in _jpartials(
            jnp.asarray(packed), jnp.asarray(z)))
        wsums, u_sum, n_bad = E.rlc_partials(_t(packed), _t(z))
        assert np.array_equal(wsums.numpy(), jw)
        assert np.array_equal(u_sum.numpy(), ju)
        assert int(n_bad) == int(jbad)
        counts.append(int(n_bad))
    # The forged batch's bad R counts once; excluding its row clears it.
    assert counts == [0, 1, 0, 0]


def test_verify_rlc_packed_verdicts_match_jax(verify_case):
    good, bad = verify_case
    jit = JE.verify_rlc_packed_jit
    cases = _cases(good, bad)
    jverdicts = [bool(np.asarray(jit(jnp.asarray(p), jnp.asarray(c))))
                 for p, c in cases]
    assert jverdicts == [True, False, True, True]
    assert [bool(E.verify_rlc_packed(_t(p), _t(c))) for p, c in cases] == \
        jverdicts
