"""ECDSA over secp256k1 for the off-chain suite
(off-chain-benchmarking/ecdsa.py capability): the port's copy of
hotstuff_tpu/offchain/ecdsa.py, host only."""

from __future__ import annotations

from . import secp256k1 as _c


def key_gen(seed: bytes | None = None):
    return _c.key_gen(seed)


def sign(sk: int, msg: bytes):
    return _c.ecdsa_sign(sk, msg)


def verify(pk, msg: bytes, sig) -> bool:
    return _c.ecdsa_verify(pk, msg, sig)


def verify_batch(msgs, pks, sigs):
    return [verify(pk, m, s) for m, pk, s in zip(msgs, pks, sigs)]
