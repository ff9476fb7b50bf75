"""Schnorr over secp256k1 for the off-chain suite (the port's copy of
hotstuff_tpu/offchain/schnorr.py, host only)
(off-chain-benchmarking/schnorr.py capability; also covers the scheme the
reference's "eddsa.py" actually implements — a Schnorr over secp256k1 via
petlib, see SURVEY.md §2.1)."""

from __future__ import annotations

from . import secp256k1 as _c


def key_gen(seed: bytes | None = None):
    return _c.key_gen(seed)


def sign(sk: int, msg: bytes):
    return _c.schnorr_sign(sk, msg)


def verify(pk, msg: bytes, sig) -> bool:
    return _c.schnorr_verify(pk, msg, sig)


def verify_batch(msgs, pks, sigs):
    return [verify(pk, m, s) for m, pk, s in zip(msgs, pks, sigs)]
