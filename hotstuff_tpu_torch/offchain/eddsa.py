"""Ed25519 for the off-chain suite: the port of
hotstuff_tpu/offchain/eddsa.py.  Host keygen and signing, and three
verify paths: host single (the reference benchmark's ed25519-dalek loop,
production/src/main.rs:19-64), host batch (a sequential loop, the
baseline), and device batch (``verify_batch_device``: the port's verify
program, crypto/eddsa.verify_batch, on the card by default).
"""

from __future__ import annotations

from ..crypto import ref_ed25519 as _ref


def key_gen(seed: bytes):
    sk, pk = _ref.generate_keypair(seed)
    return sk, pk


def sign(sk: bytes, msg: bytes) -> bytes:
    return _ref.sign(sk, msg)


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """Host single verify (OpenSSL through ``cryptography`` when it is
    installed, else the pure reference implementation)."""
    try:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PublicKey,
        )
    except ImportError:
        return _ref.verify(pk, msg, sig)
    try:
        Ed25519PublicKey.from_public_bytes(pk).verify(sig, msg)
        return True
    except (InvalidSignature, ValueError):
        return False


def verify_batch_host(msgs, pks, sigs):
    """Sequential host loop (what the reference's EdDSA bench measures)."""
    return [verify(pk, msg, sig) for msg, pk, sig in zip(msgs, pks, sigs)]


def verify_batch_device(msgs, pks, sigs, device=None):
    """Batch verification by the port's per-signature program
    (crypto/eddsa.verify_batch): on the card unless ``device`` says
    otherwise (``"cpu"`` runs the kernels' plain versions)."""
    from ..crypto import eddsa

    return [bool(b) for b in eddsa.verify_batch(msgs, pks, sigs,
                                                device=device)]
