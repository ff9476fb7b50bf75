"""Verification sharded over a mesh of cards, from one process: the port
of hotstuff_tpu/parallel/."""
