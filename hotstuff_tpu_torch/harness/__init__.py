"""The benchmark harness: the port's copy of hotstuff_tpu/harness
(configs, commands, the log parser and aggregator, ``LocalBench`` with
its fault injector, the plots, the ssh fleet and the cloud instances),
booting the port's sidecar (``python -m hotstuff_tpu_torch.harness
local``)."""

from .config import (  # noqa: F401
    BenchParameters,
    Committee,
    ConfigError,
    Key,
    LocalCommittee,
    NodeParameters,
    PlotParameters,
)
from .logs import LogParser, ParseError  # noqa: F401
from .utils import BenchError, PathMaker, Print  # noqa: F401
