"""The hand-written CUDA kernels of the verify hot paths, and their routing.

Sixteen kernels, each in ``csrc/`` with a Python wrapper and a plain
PyTorch version of the same function beside it:

  probe             x + 1, the toolchain and launch check (probe.py)
  field_mul         K1, a * b mod 2^255 - 19 on weak limbs (field_mul.py)
  scalar_mont_mul   K2, the mod-L Montgomery product (scalar_mont.py)
  msm_window_accum  K3, the Straus MSM window sums, in at most two grids
                      (msm_accum.py)
  point_ladder      K1 redesigned: whole point chains in one launch each
  decompress          (point_chain.py): the ladder, comb and Horner loops,
  point_multiples     x-recovery, and the 16-entry multiple tables
  rlc_scalars       K2 redesigned: the RLC program's scalar work mod L
  rlc_reduce          in one launch each (scalar_rlc.py): the products,
                      lifts and digits per row; the limb-sum reduction
  fq12_mul          flat Fq12 chains (fq12_chain.py, no TPU kernel
  fq12_pow            behind them): one Fq12 product, the windowed
  fq_pow              exponentiations over Fq12 and over Fq, for
                      bls381's flat Fq12 functions, off the check's path
  final_exp         the check on the Fq12 tower over 32-bit words
  fq12_hard_pow       (fq12_tower.py): the product of the Miller values,
  miller_accumulate   its whole final exponentiation and the verdict; the
  fq12_product        hard part alone as the chain in x; the whole Miller
                      accumulation; the product stage alone.  A pairing
                      check launches miller_accumulate and final_exp,
                      nothing else; on a mesh each shard adds one
                      fq12_product

Routing follows the tensors and nothing else: a CUDA tensor always goes
through the kernel, a CPU tensor always through the plain version.
There is no switch and no fallback; a kernel that fails to build or
launch raises.  ``LAUNCHES`` counts each kernel's grid launches (K3
launches one or two grids; plain-version calls count nothing),
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import contextlib
import threading

import torch

LAUNCHES = {"probe": 0, "field_mul": 0, "scalar_mont_mul": 0,
            "msm_window_accum": 0, "point_ladder": 0, "decompress": 0,
            "point_multiples": 0, "rlc_scalars": 0, "rlc_reduce": 0,
            "fq12_mul": 0, "miller_accumulate": 0, "fq12_pow": 0,
            "fq_pow": 0, "fq12_hard_pow": 0, "final_exp": 0,
            "fq12_product": 0}


# The launching thread's extra tally (``counting_to``), None outside one.
_thread = threading.local()


def count_launch(name: str, grids: int = 1) -> None:
    """Count ``grids`` launches of kernel ``name``: the wrappers call it
    where they launch, and nowhere else."""
    LAUNCHES[name] += grids
    tally = getattr(_thread, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + grids


@contextlib.contextmanager
def counting_to(tally: dict):
    """Inside the block, this thread's launches also count in ``tally``
    (a mesh shard's, parallel/mesh ``Mesh.on``).  Another thread's
    launches never do: a guard thread left running after a wedge keeps
    counting to its own shard."""
    outer = getattr(_thread, "tally", None)
    _thread.tally = tally
    try:
        yield tally
    finally:
        _thread.tally = outer


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device (the kernel
    route), False when every tensor lies on the CPU (the plain route);
    raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on several devices: {devices}")
    (dev,) = devices
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def check_int32(name: str, t: torch.Tensor, shape: tuple) -> None:
    """The wrappers' input contract: int32, contiguous, the given shape."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the raw handle the C
    entries take; raises when that device is not the current one (the
    kernels launch on the current device)."""
    if t.device.index is not None and \
            t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
