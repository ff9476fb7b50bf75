"""K0: the toolchain and launch probe (csrc/probe.cu), the counterpart of
the JAX package's interpreter probe (ops/kern/backend.interpret_probe)."""

from __future__ import annotations

import torch

from . import (build, check_int32, check_launch, count_launch, on_card,
                stream_of)


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1


def probe(x: torch.Tensor) -> torch.Tensor:
    """x + 1 for a contiguous int32 tensor: the kernel on a CUDA tensor,
    the plain version on a CPU one."""
    check_int32("probe x", x, x.shape)
    if not on_card(x):
        return probe_plain(x)
    out = torch.empty_like(x)
    check_launch("probe", build.load().hk_probe(
        x.data_ptr(), out.data_ptr(), x.numel(), stream_of(x)))
    count_launch("probe")
    return out
