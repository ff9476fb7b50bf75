"""Driver entry points of the port, mirroring the repository's
``__graft_entry__.py``.

* ``entry()`` returns the single-card verify step and its arguments on
  the card: ``(ops.ed25519.verify_compact, (a, r, s, k))``.
* ``dryrun_multichip(n, device=None)`` runs one sharded per-signature
  step (per-shard masks and the psum'd bad count), one whole-backlog
  scan step and one sharded BLS multi-digest check (a 3-vote TC shape
  and its tampered twin) on an ``n``-shard mesh: ``n`` cards, or ``n``
  shards on the CPU when the caller passes ``device="cpu"``.

Run:  python -m hotstuff_tpu_torch.__graft_entry__ N [--cpu]
"""

from __future__ import annotations

import numpy as np


def _example_prep(batch: int):
    """Host-prepare a batch of real signatures, every fifth tampered."""
    from .crypto import eddsa, ref_ed25519 as ref

    rng = np.random.default_rng(42)
    msgs, pks, sigs = [], [], []
    for i in range(batch):
        sk = rng.bytes(32)
        _, pk = ref.generate_keypair(sk)
        msg = rng.bytes(32)
        sig = ref.sign(sk, msg)
        if i % 5 == 4:
            sig = sig[:8] + bytes([sig[8] ^ 1]) + sig[9:]
        msgs.append(msg)
        pks.append(pk)
        sigs.append(sig)
    return eddsa.prepare_batch(msgs, pks, sigs)


def entry(device=None):
    """Returns (fn, example_args): the per-signature verify step and
    eight prepared signatures as (8, 32) uint8 tensors on the card."""
    import torch

    from .ops import ed25519 as E
    from .utils.device import resolve

    dev = resolve(device)
    prep = _example_prep(8)
    args = tuple(torch.from_numpy(np.ascontiguousarray(prep[k])).to(dev)
                 for k in ("a", "r", "s", "k"))
    return E.verify_compact, args


def _check_lanes(label: str, mask: np.ndarray, expect: np.ndarray) -> None:
    """Fail naming every lane where the mask departs from the injected
    pattern: a false reject (a valid vote rejected) or an escaped
    invalid (a tampered vote accepted)."""
    disagree = np.nonzero(mask != expect)[0]
    if len(disagree) == 0:
        return
    detail = ", ".join(
        f"lane {int(i)}: " + ("false-reject (valid vote rejected)"
                              if expect[i] else
                              "escaped-invalid (tampered vote accepted)")
        for i in disagree)
    raise AssertionError(f"{label} verification: {len(disagree)} "
                         f"unexpected lane(s): {detail}")


def _dryrun_bls_mesh(mesh) -> str:
    from .offchain import bls12381 as host
    from .parallel.sharded_bls import verify_aggregate_multi_sharded

    sks, pks = zip(*[host.key_gen(bytes([40 + i]) * 32) for i in range(3)])
    msgs = [bytes([i]) * 32 for i in range(3)]
    sigs = [host.sign(sk, m) for sk, m in zip(sks, msgs)]
    agg = host.aggregate(sigs)
    assert verify_aggregate_multi_sharded(mesh, list(pks), msgs, agg), \
        "sharded BLS pairing product rejected a valid 3-vote TC shape"
    bad = host.aggregate(sigs[:2] + [host.sign(sks[2], b"x" * 32)])
    assert not verify_aggregate_multi_sharded(mesh, list(pks), msgs, bad), \
        "sharded BLS pairing product accepted a wrong-digest vote"
    return "BLS pairing-product shard ok (3-vote TC shape + tampered twin)"


def dryrun_multichip(n_devices: int, device=None) -> str:
    """One sharded verification step of each kind on an ``n_devices``
    mesh (cards, or CPU shards for ``device="cpu"``); prints and returns
    the summary line, raises on any disagreement."""
    from .parallel.mesh import make_mesh, virtual_mesh
    from .parallel.sharded_verify import verify_batch_sharded, \
        verify_sharded_chunked

    if device is not None and str(device) == "cpu":
        mesh = virtual_mesh(n_devices, "cpu")
    else:
        mesh = make_mesh(n_devices, device)
    batch = 4 * n_devices
    prep = _example_prep(batch)
    expect = np.array([i % 5 != 4 for i in range(batch)])
    mask, bad_total = verify_batch_sharded(mesh, prep, return_bad_total=True)
    _check_lanes("sharded", mask, expect)
    assert bad_total == int((~mask).sum()), \
        f"psum bad={bad_total} disagrees with the mask " \
        f"({int((~mask).sum())} invalid lanes)"
    # Each shard's four votes as two chunks of two in one launch.
    mask2, bad2 = verify_sharded_chunked(mesh, prep, rows=2,
                                         return_bad_total=True)
    _check_lanes("whole-backlog scan", mask2, expect)
    assert bad2 == bad_total
    injected = sorted(int(i) for i in np.nonzero(~expect)[0])
    line = (f"dryrun_multichip({n_devices}): ok — {mask.sum()}/{mask.size} "
            f"valid (psum bad={bad_total}, all {len(injected)} "
            f"injected-invalid: lanes {injected}), chunked shard scan ok, "
            f"{_dryrun_bls_mesh(mesh)}")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    import sys

    args = [a for a in sys.argv[1:] if a != "--cpu"]
    dryrun_multichip(int(args[0]) if args else 1,
                     device="cpu" if "--cpu" in sys.argv[1:] else None)
