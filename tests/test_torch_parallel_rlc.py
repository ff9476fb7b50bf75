"""hotstuff_tpu_torch.parallel.sharded_verify's one-MSM RLC mesh program
on virtual_mesh(8, "cpu") held to the JAX package's
(hotstuff_tpu.parallel.sharded_verify on make_mesh(8) of the conftest's
8 CPU devices): the combined verdict of a valid batch and of one with a
forged vote, and the bisected mask (with a host-rejected row and the
per-signature floor).  Exact.

Eight signatures on eight shards: one row a shard, so the JAX package
compiles two programs (the sharded RLC one and its per-signature
floor), each once, in a module-scoped fixture.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from hotstuff_tpu.crypto import eddsa as JD  # noqa: E402
from hotstuff_tpu.parallel import sharded_verify as JS  # noqa: E402
from hotstuff_tpu.parallel.mesh import make_mesh  # noqa: E402
from hotstuff_tpu_torch.crypto import eddsa as D  # noqa: E402
from hotstuff_tpu_torch.crypto import ref_ed25519 as ref  # noqa: E402
from hotstuff_tpu_torch.parallel import sharded_verify as S  # noqa: E402
from hotstuff_tpu_torch.parallel.mesh import virtual_mesh  # noqa: E402
from hotstuff_tpu_torch.utils.intmath import L  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches():
    """Eight numpy-seeded signatures, and a copy with a vote over
    another message (row 1) and a non-canonical S (row 6)."""
    rng = np.random.default_rng(64)
    msgs, pks, sigs, sks = [], [], [], []
    for _ in range(8):
        sk = rng.bytes(32)
        _, pk = ref.generate_keypair(sk)
        msg = rng.bytes(32)
        msgs.append(msg)
        pks.append(pk)
        sigs.append(ref.sign(sk, msg))
        sks.append(sk)
    bad = list(sigs)
    bad[1] = ref.sign(sks[1], b"another message")
    s = int.from_bytes(bad[6][32:], "little") + L
    bad[6] = bad[6][:32] + s.to_bytes(32, "little")
    return (msgs, pks, sigs), (msgs, pks, bad)


def _verdict_rows(prep, pad_rows):
    """The combined check's inputs: packed rows and coefficient rows
    (zero outside the host-canonical rows), padded."""
    packed = np.asarray(prep["packed"])
    idx = np.nonzero(prep["host_ok"])[0]
    z = np.zeros((pad_rows, 32), np.uint8)
    z[idx] = JD._rlc_coeffs(np.ascontiguousarray(packed[idx]), b"")
    return packed, z


@pytest.fixture(scope="module")
def jax_rlc():
    """The JAX package's combined verdicts and masks (and whether the
    fetch bisected) for both batches on make_mesh(8)."""
    mesh = make_mesh(8)
    out = []
    for batch in _batches():
        prep = JD.prepare_batch(*batch)
        packed, z = _verdict_rows(prep, 8)
        verdict = bool(np.asarray(JS._cached_rlc_verifier(mesh)(
            *JS._pack_rlc_rows(mesh, packed, np.nonzero(z.any(1))[0], 8, 8,
                               b""))))
        bisected = []
        mask = JS.verify_rlc_sharded_pack(
            mesh, prep, on_bisect=lambda: bisected.append(1))()()
        out.append((batch, verdict, np.asarray(mask), bisected))
    return out


def test_sharded_rlc_verdicts_equal_jax(jax_rlc):
    mesh = virtual_mesh(8, "cpu")
    verdicts = []
    for batch, want, _, _ in jax_rlc:
        packed, z = _verdict_rows(D.prepare_batch(*batch), 8)
        got = S._launch_rlc(mesh, S._shard_put(mesh, packed),
                            S._shard_put(mesh, z))
        assert got.shape == () and bool(got) == want
        verdicts.append(want)
    assert verdicts == [True, False]


def test_sharded_rlc_masks_and_bisection_equal_jax(jax_rlc):
    """The valid batch passes in one combined check; the forged one
    bisects (its first half of three canonical rows drops to the
    per-signature floor, the second passes) to the JAX package's mask,
    which is also the one-card per-signature mask."""
    mesh = virtual_mesh(8, "cpu")
    for batch, _, want, want_bisected in jax_rlc:
        bisected = []
        got = S.verify_rlc_sharded_pack(
            mesh, D.prepare_batch(*batch),
            on_bisect=lambda: bisected.append(1))()()
        assert got.tolist() == want.tolist()
        assert bisected == want_bisected
    assert jax_rlc[1][2].tolist() == [i not in (1, 6) for i in range(8)]
    assert jax_rlc[1][3] == [1] and jax_rlc[0][3] == []


def test_sharded_rlc_degenerate_batches_take_the_per_signature_program():
    """Fewer than RLC_MIN_MSM canonical rows, and the empty batch."""
    (msgs, pks, sigs), _ = _batches()
    mesh = virtual_mesh(2, "cpu")
    prep = D.prepare_batch(msgs[:3], pks[:3], sigs[:3])
    assert S.verify_rlc_sharded(mesh, prep).tolist() == [True] * 3
    empty = D.prepare_batch([], [], [])
    assert S.verify_rlc_sharded(mesh, empty).shape == (0,)
