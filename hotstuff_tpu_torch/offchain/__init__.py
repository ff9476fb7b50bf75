"""The off-chain signature suite (the port of hotstuff_tpu/offchain):
EdDSA (host, and batches on the card), ECDSA and Schnorr over secp256k1
(host), and BLS12-381 with aggregation (host, and the aggregate check on
the card); ``python -m hotstuff_tpu_torch.offchain`` runs its
benchmarks.  ``bls12381`` is also the sidecar's host BLS layer."""
