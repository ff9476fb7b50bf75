"""The launch-shape registry of one card: the port of
hotstuff_tpu/sidecar/sched/shapes.py's ``ShapeRegistry``, its one-card
routes only (the mesh routes wait for the port of ``parallel/``).

The JAX package records which XLA shapes were compiled before the socket
bound, because a first compile mid-traffic stalls the engine, and routes
only to warmed shapes.  The port has no per-shape compile: one kernel
build serves every shape, and the build runs before the server binds.
So the route depends on n alone: batches of ``RLC_MIN_LAUNCH`` up to
``MAX_SUBBATCH`` unique records pay one Straus MSM (the RLC program,
whose bisection keeps the mask equal to the per-signature program's),
everything else runs per signature; a ``use_host`` registry routes every
batch to the host.  ``bucket_capacity`` is the padded shape a launch
rides in, the room pad-fill may use without growing it.
"""

from __future__ import annotations

from ...crypto.eddsa import MAX_SUBBATCH, _bucket
from ...utils.intmath import next_pow2

# Engine-path RLC floor: below this the combined check's fixed
# Horner/comb tail outweighs the saved ladders (crypto/eddsa.RLC_MIN_MSM
# is the bisection floor, a different constant).
RLC_MIN_LAUNCH = 16

# Verify paths (also the stats path-counter keys; ``rlc_bisect`` counts
# RLC launches whose combined check failed and bisected).
PATH_PER_SIG = "per_sig"
PATH_RLC = "rlc"
PATH_RLC_BISECT = "rlc_bisect"
PATH_HOST = "host"


class ShapeRegistry:
    """Launch cap and routing of one card; owned by the engine, read by
    the scheduler."""

    def __init__(self, use_host: bool = False,
                 committee: int | None = None):
        self.use_host = use_host
        self.committee = int(committee) if committee else None
        # Per-launch cap in signatures: the coalescer's budget.
        self.launch_cap = MAX_SUBBATCH

    def bucket_capacity(self, n: int) -> int:
        """Padded device capacity of an n-signature launch (the free room
        pad-fill may use without growing it).  The host path verifies
        exactly n records, so a host registry has no padding."""
        if self.use_host:
            return n
        if n <= MAX_SUBBATCH:
            return _bucket(n)
        g = next_pow2(-(-n // MAX_SUBBATCH))
        return g * MAX_SUBBATCH

    def route(self, n: int) -> str:
        """Verify path for a coalesced batch of n unique records."""
        if self.use_host:
            return PATH_HOST
        if RLC_MIN_LAUNCH <= n <= MAX_SUBBATCH:
            return PATH_RLC
        return PATH_PER_SIG

    def snapshot(self) -> dict:
        return {"launch_cap": self.launch_cap, "committee": self.committee}
