"""The verify scheduler's single-device routing, admission caps and
telemetry (the port of hotstuff_tpu/sidecar/sched, cut to what one card
serves)."""

from .scheduler import size_queue_caps  # noqa: F401
from .shapes import PATH_HOST, PATH_PER_SIG, PATH_RLC, PATH_RLC_BISECT, \
    RLC_MIN_LAUNCH, route  # noqa: F401
from .stats import SchedStats  # noqa: F401
