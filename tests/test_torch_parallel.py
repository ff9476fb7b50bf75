"""hotstuff_tpu_torch.parallel.sharded_verify's per-signature and
whole-backlog scan mesh programs on virtual_mesh(8, "cpu") held to the
JAX package's (hotstuff_tpu.parallel.sharded_verify on make_mesh(8) of
the conftest's 8 CPU devices): masks and psum'd bad counts; and the
mesh's gathered window sums and their _tree_sum limb for limb against
hotstuff_tpu.ops.ed25519, on a 3-shard mesh (padded with identity
points) and an 8-shard one.  Exact.  The one-MSM RLC program is held to
the JAX package's in tests/test_torch_parallel_rlc.py.

The batch is tests/test_sharded_verify.py's 16 signatures (seed 5, two
forged), plus a non-canonical S, so the JAX program is the one the
reference's own test compiles.  Every JAX program runs once, in a
module-scoped fixture; the port's plain versions cost ~1.4 s a shard.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hotstuff_tpu.crypto import eddsa as JD  # noqa: E402
from hotstuff_tpu.ops import ed25519 as JE  # noqa: E402
from hotstuff_tpu.parallel import sharded_verify as JS  # noqa: E402
from hotstuff_tpu.parallel.mesh import make_mesh  # noqa: E402
from hotstuff_tpu_torch.crypto import eddsa as D  # noqa: E402
from hotstuff_tpu_torch.crypto import ref_ed25519 as ref  # noqa: E402
from hotstuff_tpu_torch.ops import ed25519 as E  # noqa: E402
from hotstuff_tpu_torch.parallel import sharded_verify as S  # noqa: E402
from hotstuff_tpu_torch.parallel.mesh import Mesh, make_mesh as \
    port_make_mesh, virtual_mesh  # noqa: E402
from hotstuff_tpu_torch.utils.intmath import L  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    """tests/test_sharded_verify.py's 16 signatures (two with a flipped
    R byte), and row 7's S raised by L (non-canonical: host-rejected)."""
    rng = np.random.default_rng(5)
    msgs, pks, sigs = [], [], []
    for i in range(16):
        sk = rng.bytes(32)
        _, pk = ref.generate_keypair(sk)
        msg = rng.bytes(32)
        sig = ref.sign(sk, msg)
        if i in (3, 11):
            sig = sig[:8] + bytes([sig[8] ^ 1]) + sig[9:]
        msgs.append(msg)
        pks.append(pk)
        sigs.append(sig)
    s = int.from_bytes(sigs[7][32:], "little") + L
    sigs[7] = sigs[7][:32] + s.to_bytes(32, "little")
    return msgs, pks, sigs


@pytest.fixture(scope="module")
def jax_per_sig():
    """The JAX package's sharded per-signature mask and psum'd bad count
    on make_mesh(8)."""
    msgs, pks, sigs = _batch()
    mask, bad = JS.verify_batch_sharded(
        make_mesh(8), JD.prepare_batch(msgs, pks, sigs),
        return_bad_total=True)
    return (msgs, pks, sigs), np.asarray(mask), bad


def test_sharded_per_signature_mask_and_bad_count_equal_jax(jax_per_sig):
    (msgs, pks, sigs), want, want_bad = jax_per_sig
    assert want.tolist() == [i not in (3, 7, 11) for i in range(16)]
    assert want_bad == 2          # the host-rejected row is not counted
    prep = D.prepare_batch(msgs, pks, sigs)
    mesh = virtual_mesh(8, "cpu")
    mask, bad = S.verify_batch_sharded(mesh, prep, return_bad_total=True)
    assert mask.tolist() == want.tolist() and bad == want_bad
    # The staged entry: the same mask.
    assert S.verify_batch_sharded_pack(mesh, prep)()().tolist() == \
        want.tolist()


def test_sharded_per_shard_chunks_equal_the_whole_shard():
    """Shards over max_subbatch run as whole chunks of it (per_shard 4,
    cap 2: two chunks a shard), with the mask and count unchanged."""
    msgs, pks, sigs = _batch()
    prep = D.prepare_batch(msgs[:8], pks[:8], sigs[:8])
    mesh = virtual_mesh(2, "cpu")
    whole = S.verify_batch_sharded(mesh, prep, return_bad_total=True)
    chunked = S.verify_batch_sharded(mesh, prep, return_bad_total=True,
                                     max_subbatch=2)
    assert whole[0].tolist() == chunked[0].tolist() == \
        [i not in (3, 7) for i in range(8)]
    assert whole[1] == chunked[1] == 1


def test_sharded_scan_mask_and_bad_count_equal_jax(jax_per_sig):
    """The whole-backlog scan (g = 2 chunks of one row a shard) gives the
    JAX package's sharded mask and count: its scan and its per-signature
    program agree row for row (tests/test_sharded_verify.py), so the
    per-signature result is the oracle and no scan program is
    compiled."""
    (msgs, pks, sigs), want, want_bad = jax_per_sig
    prep = D.prepare_batch(msgs, pks, sigs)
    mesh = virtual_mesh(8, "cpu")
    mask, bad = S.verify_sharded_chunked(mesh, prep, rows=1,
                                         return_bad_total=True)
    assert mask.tolist() == want.tolist() and bad == want_bad
    # The staged entry, on two shards of two chunks of two rows.
    half = D.prepare_batch(msgs[:8], pks[:8], sigs[:8])
    assert S.verify_sharded_chunked_pack(
        virtual_mesh(2, "cpu"), half, rows=2)()().tolist() == \
        want[:8].tolist()


# ---------------------------------------------------------------------------
# The gathered window sums and _tree_sum
# ---------------------------------------------------------------------------

_jtree = jax.jit(JE._tree_sum)


def test_gathered_window_sums_and_tree_sum_equal_jax_on_3_shards():
    """Twelve prepared rows (one forged) over a 3-shard mesh, 4 rows a
    shard: each shard's window sums (rlc_partials, held to the JAX
    package's in tests/test_torch_rlc.py), gathered on the lead and
    padded to 4 with identity points, equal the JAX package's gather of
    the same sums, and their tree sum equals its _tree_sum."""
    keys = [ref.generate_keypair(bytes([61, i]) * 16) for i in range(12)]
    msgs = [bytes([62, i]) * 16 for i in range(12)]
    sigs = [ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    sigs[5] = ref.sign(keys[5][0], b"forged")
    packed = D.prepare_batch(msgs, [pk for _, pk in keys], sigs)["packed"]
    z = D._rlc_coeffs(packed, b"")
    mesh = virtual_mesh(3, "cpu")
    rows = S._shard_put(mesh, packed)
    zs = S._shard_put(mesh, z)
    wsums = []
    for i in range(3):
        with mesh.on(i):
            wsums.append(E.rlc_partials(rows[i], zs[i])[0])
    with mesh.on("lead"):
        allw = S.gather_window_sums(mesh, wsums)
        combined = E._tree_sum(allw)
    want = jnp.concatenate([jnp.stack([jnp.asarray(w.numpy())
                                       for w in wsums]),
                            JE.identity_ext((1, 64))], axis=0)
    assert allw.shape == (4, 64, 4, 32)
    assert np.array_equal(allw.numpy(), np.asarray(want))
    assert np.array_equal(combined.numpy(), np.asarray(_jtree(want)))


def test_tree_sum_equals_jax_on_8_shards():
    """Eight shards' window sums (random weak limbs below 2^9): the port's
    tree and its plain-multiply form against the JAX package's."""
    from hotstuff_tpu_torch.ops.kern.field_mul import field_mul_plain

    pts = np.random.default_rng(63).integers(
        0, 512, (8, 64, 4, 32)).astype(np.int32)
    want = np.asarray(_jtree(jnp.asarray(pts)))
    assert np.array_equal(E._tree_sum(torch.from_numpy(pts)).numpy(), want)
    assert np.array_equal(E._tree_sum(torch.from_numpy(pts),
                                      mul=field_mul_plain).numpy(), want)


# ---------------------------------------------------------------------------
# The mesh itself
# ---------------------------------------------------------------------------

def test_meshes_name_their_devices_and_never_double_cards_up():
    mesh = virtual_mesh(3, "cpu")
    assert mesh.size == 3 and mesh.lead == torch.device("cpu")
    assert port_make_mesh(2, "cpu").devices == (torch.device("cpu"),) * 2
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 4 devices, have 0"):
            port_make_mesh(4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            virtual_mesh(2, "cuda:0")
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError):
        virtual_mesh(0, "cpu")


def test_mesh_tallies_launches_by_shard(monkeypatch):
    from hotstuff_tpu_torch.ops import kern

    monkeypatch.setitem(kern.LAUNCHES, "probe", kern.LAUNCHES["probe"])
    mesh = virtual_mesh(2, "cpu")
    for key, n in ((0, 2), (1, 1), ("lead", 3)):
        with mesh.on(key):
            kern.count_launch("probe", n)
    kern.count_launch("probe")
    assert mesh.launches == {0: {"probe": 2}, 1: {"probe": 1},
                             "lead": {"probe": 3}}
    mesh.reset_launches()
    assert mesh.launches == {}


def test_a_shard_counts_only_its_own_threads_launches(monkeypatch):
    """A thread still inside shard 1's block (a guard thread left running
    after a wedge) launches while the engine's thread is in shard 0's:
    each launch counts to its own thread's shard, and once in all."""
    import threading

    from hotstuff_tpu_torch.ops import kern

    monkeypatch.setitem(kern.LAUNCHES, "probe", 0)
    mesh = virtual_mesh(2, "cpu")
    inside, release = threading.Event(), threading.Event()

    def stray():
        with mesh.on(1):
            inside.set()
            release.wait(10)
            kern.count_launch("probe")

    t = threading.Thread(target=stray)
    t.start()
    assert inside.wait(10)
    with mesh.on(0):
        kern.count_launch("probe", 2)
        release.set()
        t.join(10)
    assert mesh.launches == {0: {"probe": 2}, 1: {"probe": 1}}
    assert kern.LAUNCHES["probe"] == 3
