"""The verify scheduler: the port of hotstuff_tpu/sidecar/sched.

  classes.py    request classes (latency / bulk), Pending/Launch/queue types
  tenantq.py    per-tenant lanes drained in deficit round-robin order
  shapes.py     launch cap, padded capacity and verify-path routing,
                the mesh routes included
  scheduler.py  admission, strict-priority coalescing, pad-fill, carry-over
  stats.py      per-launch telemetry behind the OP_STATS wire request
  surge.py      overlap-driven bulk derate, bulk-before-latency shedding,
                retry-after hints
"""

from .classes import BULK, LATENCY, Launch, Pending, \
    class_of_opcode  # noqa: F401
from .scheduler import BULK_QUEUE_CAP_SIGS, LATENCY_QUEUE_CAP_SIGS, \
    Scheduler, size_queue_caps  # noqa: F401
from .shapes import MESH_SCAN_CHUNKS, PATH_HOST, PATH_LADDER_SHARDED, \
    PATH_MESH, PATH_PER_SIG, PATH_RLC, PATH_RLC_BISECT, PATH_RLC_SHARDED, \
    PATH_SCAN_SHARDED, RLC_MIN_LAUNCH, ShapeRegistry, \
    quorum_sigs  # noqa: F401
from .stats import SchedStats  # noqa: F401
from .surge import AdmissionController  # noqa: F401
