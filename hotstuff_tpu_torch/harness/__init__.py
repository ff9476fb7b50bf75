"""The benchmark harness's local path: the port's copy of
hotstuff_tpu/harness (configs, commands, the log parser and aggregator,
``LocalBench``), booting the port's sidecar (``python -m
hotstuff_tpu_torch.harness local``)."""

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
