"""The launch-shape registry: the port of
hotstuff_tpu/sidecar/sched/shapes.py's ``ShapeRegistry``.

The JAX package records which XLA shapes were compiled before the socket
bound, because a first compile mid-traffic stalls the engine, and routes
only to warmed shapes.  The port has no per-shape compile: one kernel
build serves every shape, and the build runs before the server binds.

One card: the route depends on n alone.  Batches of ``RLC_MIN_LAUNCH``
up to ``MAX_SUBBATCH`` unique records pay one Straus MSM (the RLC
program, whose bisection keeps the mask equal to the per-signature
program's), everything else runs per signature; a ``use_host`` registry
routes every batch to the host.

A mesh (``n_devices`` > 1) routes exactly as the reference does for the
same marks, and the port's mesh warm-up (sidecar/service) makes the
marks the reference's warm-up makes:

  ``shard_buckets`` / ``rlc_shard_buckets``  per-shard padded row counts
      (parallel/shard_shapes.shard_bucket) the per-signature and the
      one-MSM mesh programs were run at;
  ``mesh_chunks`` / ``scan_rows``  chunk counts g, and the per-shard
      chunk row count, of the whole-backlog mesh scan;
      ``enable_bulk`` raises the launch cap only as far as they reach.

Routes: ``rlc_sharded`` for RLC_MIN_LAUNCH+ records on a marked RLC
bucket; ``scan_sharded`` for a backlog past every marked ladder bucket
whose chunk count is marked; ``ladder_sharded`` otherwise, sliced at
``ladder_cap``.  ``bucket_capacity`` is the padded shape a launch rides
in, the room pad-fill may use without growing it: the shard-aligned row
count on a mesh.
"""

from __future__ import annotations

from ...crypto.eddsa import MAX_SUBBATCH, _bucket
from ...parallel.shard_shapes import mesh_chunk_count, shard_aligned_rows, \
    shard_bucket
from ...utils.intmath import next_pow2

# Engine-path RLC floor: below this the combined check's fixed
# Horner/comb tail outweighs the saved ladders (crypto/eddsa.RLC_MIN_MSM
# is the bisection floor, a different constant).
RLC_MIN_LAUNCH = 16

# Largest chunk count the whole-backlog mesh scan warms: it caps the
# scan shapes and how long one backlog drain holds the engine ahead of a
# QC.
MESH_SCAN_CHUNKS = 16

# Verify paths (also the stats path-counter keys; ``rlc_bisect`` counts
# RLC launches whose combined check failed and bisected).
PATH_PER_SIG = "per_sig"
PATH_RLC = "rlc"
PATH_RLC_BISECT = "rlc_bisect"
PATH_HOST = "host"
PATH_RLC_SHARDED = "rlc_sharded"
PATH_LADDER_SHARDED = "ladder_sharded"
PATH_SCAN_SHARDED = "scan_sharded"
# The reference's catch-all route of a registry flagged mesh without a
# device count; the port always knows its shard count, so no route
# answers it (the name stays an OP_STATS path key).
PATH_MESH = "mesh"


def quorum_sigs(committee: int) -> int:
    """Signature count of a quorum certificate for an n-node committee
    with unit stakes: 2n/3 + 1 (native/src/consensus/config.hpp's
    formula).  The mesh warm-up floors its largest shape at it, so a
    QC-shaped batch (~667 votes at n = 1000) lands on a marked
    sharded-RLC bucket."""
    return 2 * committee // 3 + 1


class ShapeRegistry:
    """Launch cap, marks and routing; owned by the engine, read by the
    scheduler.  Marks grow only (the warm-up, before the socket binds),
    so a stale read can at worst route one batch down the per-signature
    path."""

    def __init__(self, use_host: bool = False, n_devices: int = 0,
                 committee: int | None = None):
        self.use_host = use_host
        self.n_devices = int(n_devices or 0)
        self.committee = int(committee) if committee else None
        self.shard_buckets: set[int] = set()
        self.rlc_shard_buckets: set[int] = set()
        self.scan_rows = 0
        self.mesh_chunks: set[int] = set()
        # Per-launch cap in signatures: the coalescer's budget.  A mesh
        # raises it to the scan capacity once the scan shapes are marked
        # (enable_bulk).
        self.launch_cap = MAX_SUBBATCH

    @property
    def qc_sigs(self) -> int | None:
        """Signature count of one QC of the served committee (None when
        the committee size is unknown)."""
        if self.committee and self.committee > 1:
            return quorum_sigs(self.committee)
        return None

    # -- warm-up bookkeeping (mesh registries) --------------------------------

    def mark_bucket(self, n: int):
        """An n-record per-signature mesh launch ran: its per-shard
        bucket is marked (a one-card registry routes on n alone)."""
        if self.n_devices > 1:
            self.shard_buckets.add(shard_bucket(n, self.n_devices))

    def mark_rlc_sharded(self, n: int):
        """An n-record sharded one-MSM launch ran at its per-shard
        bucket."""
        if self.n_devices > 1:
            self.rlc_shard_buckets.add(shard_bucket(n, self.n_devices))

    def mark_mesh_chunks(self, g: int, rows: int):
        """A whole-backlog mesh scan of g chunks of ``rows`` per-shard
        rows ran.  One ``rows`` value per registry."""
        if self.n_devices <= 1:
            return
        if self.scan_rows and self.scan_rows != rows:
            raise ValueError(
                f"mesh scan chunk rows already warmed at "
                f"{self.scan_rows}, cannot also warm {rows}")
        self.scan_rows = rows
        self.mesh_chunks.add(g)

    def enable_bulk(self, max_coalesced: int):
        """Raise the launch cap of a mesh registry to the marked scan
        capacity (at most ``max_coalesced``; never lowering it); without
        marked scan shapes it stays.  A one-card registry keeps
        MAX_SUBBATCH: its bulk launches slice at the cap."""
        cap = self.scan_capacity()
        if cap:
            self.launch_cap = max(self.launch_cap, min(max_coalesced, cap))

    # -- shape queries --------------------------------------------------------

    def scan_shape_of(self, n: int):
        """(g, rows) of the marked whole-backlog scan an n-record launch
        would run as, or None when no marked scan shape covers it."""
        if self.n_devices <= 1 or not self.scan_rows \
                or not self.mesh_chunks:
            return None
        g = mesh_chunk_count(n, self.n_devices, self.scan_rows)
        if g in self.mesh_chunks:
            return g, self.scan_rows
        return None

    def scan_capacity(self) -> int:
        """Largest backlog one marked whole-backlog scan can drain (0
        without marked scan shapes)."""
        if self.n_devices <= 1 or not self.mesh_chunks:
            return 0
        return self.n_devices * max(self.mesh_chunks) * self.scan_rows

    def ladder_cap(self) -> int:
        """Slice size of the sliced-ladder mesh route: the device count
        times the largest marked per-shard bucket (MAX_SUBBATCH with none
        marked), never the scan-raised launch cap."""
        if self.n_devices > 1:
            if self.shard_buckets:
                return self.n_devices * max(self.shard_buckets)
            return min(self.launch_cap, MAX_SUBBATCH)
        return self.launch_cap

    def shard_bucket_of(self, n: int) -> int | None:
        """Per-shard padded row count of an n-record mesh launch (None
        without a mesh size)."""
        if self.n_devices > 1:
            return shard_bucket(n, self.n_devices)
        return None

    def bucket_capacity(self, n: int) -> int:
        """Padded device capacity of an n-signature launch (the free room
        pad-fill may use without growing it).  The host path verifies
        exactly n records, so a host registry has no padding; a mesh pads
        to the shard-aligned row count."""
        if self.use_host:
            return n
        if self.n_devices > 1:
            return shard_aligned_rows(n, self.n_devices)
        if n <= MAX_SUBBATCH:
            return _bucket(n)
        g = next_pow2(-(-n // MAX_SUBBATCH))
        return g * MAX_SUBBATCH

    def route(self, n: int) -> str:
        """Verify path for a coalesced batch of n unique records."""
        if self.use_host:
            return PATH_HOST
        if self.n_devices > 1:
            per = shard_bucket(n, self.n_devices)
            if n >= RLC_MIN_LAUNCH and per <= MAX_SUBBATCH and \
                    per in self.rlc_shard_buckets:
                return PATH_RLC_SHARDED
            if per not in self.shard_buckets and \
                    self.scan_shape_of(n) is not None:
                return PATH_SCAN_SHARDED
            return PATH_LADDER_SHARDED
        if RLC_MIN_LAUNCH <= n <= MAX_SUBBATCH:
            return PATH_RLC
        return PATH_PER_SIG

    def snapshot(self) -> dict:
        snap = {"launch_cap": self.launch_cap, "committee": self.committee}
        if self.n_devices > 1:
            snap.update({
                "n_devices": self.n_devices,
                "shard_buckets": sorted(self.shard_buckets),
                "rlc_shard_buckets": sorted(self.rlc_shard_buckets),
                "scan_rows": self.scan_rows,
                "mesh_chunks": sorted(self.mesh_chunks),
            })
        return snap
