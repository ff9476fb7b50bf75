"""Which verify program a coalesced launch of n unique records takes.

The JAX package's registry records which XLA shapes were compiled before
the socket bound, because a first compile mid-traffic stalls the engine.
The port has no per-shape compile: the kernels are built once, for every
shape, before the server binds.  So routing depends on n alone: batches
of ``RLC_MIN_LAUNCH`` up to ``MAX_SUBBATCH`` records pay one Straus MSM
(the RLC program, whose bisection keeps the mask equal to the
per-signature program's), everything else runs per signature.
"""

from __future__ import annotations

from ...crypto.eddsa import MAX_SUBBATCH

# Engine-path RLC floor: below this the combined check's fixed
# Horner/comb tail outweighs the saved ladders (crypto/eddsa.RLC_MIN_MSM
# is the bisection floor, a different constant).
RLC_MIN_LAUNCH = 16

# Verify paths (also the stats path-counter keys; ``rlc_bisect`` counts
# RLC launches whose combined check failed and bisected; ``host`` is a
# ``--host-crypto`` engine's, which verifies every record on the host).
PATH_PER_SIG = "per_sig"
PATH_RLC = "rlc"
PATH_RLC_BISECT = "rlc_bisect"
PATH_HOST = "host"


def route(n: int) -> str:
    """Verify path for a coalesced batch of n unique records."""
    if RLC_MIN_LAUNCH <= n <= MAX_SUBBATCH:
        return PATH_RLC
    return PATH_PER_SIG
