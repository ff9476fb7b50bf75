"""The device mesh of one process: the port of
hotstuff_tpu/parallel/mesh.py.

The JAX package builds a 1-D ``jax.sharding.Mesh`` over its local
devices and runs ``shard_map`` programs on it from one controller.  The
port does the same from one process: a mesh is an ordered tuple of
``torch.device``s, each shard's work is launched under that shard's
device (launches on different cards are asynchronous, so one host
thread keeps every card busy), and the collectives are copies to the
lead device, shard 0: a ``psum`` is the sum of the per-shard counts
copied there, an ``all_gather`` a ``torch.stack`` of the copied parts.
No ``torch.distributed``, no NCCL, no extra processes.

Shards share one card only when the caller names that card
(``virtual_mesh``); ``make_mesh`` never doubles shards up.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops import kern

BATCH_AXIS = "batch"


class Mesh:
    """An ordered tuple of devices, shard 0 the lead.  ``launches``
    tallies the kernel launches made under ``on(key)`` per shard index
    (and under ``on("lead")`` for the lead's collectives and finish),
    each counted by the thread that launched it (``kern.count_launch``)."""

    def __init__(self, devices):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {d}")
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)
        self.launches: dict = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)})"

    def reset_launches(self) -> None:
        self.launches = {}

    @contextlib.contextmanager
    def on(self, key):
        """Run a block on shard ``key`` (an index, or "lead"): its device
        is the current one inside (CUDA's current device is per host
        thread, and the guard runs each launch on a fresh one), and the
        kernel launches this thread makes in the block count towards
        ``key``."""
        dev = self.lead if key == "lead" else self.devices[key]
        ctx = torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()
        with ctx, kern.counting_to(self.launches.setdefault(key, {})):
            yield dev


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` cards (default: all), or
    ``n_devices`` CPU shards for ``device="cpu"`` (default 1).  Raises
    the JAX package's ``need {n} devices, have {k}`` when there are too
    few cards."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return Mesh(["cpu"] * (n_devices or 1))
    if kind != "cuda":
        raise ValueError(f"unsupported device {device}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n < 1 or have < n:
        raise ValueError(f"need {max(n, 1)} devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def virtual_mesh(n_devices: int, device) -> Mesh:
    """``n_devices`` shards on the one named device: the port's
    ``--xla_force_host_platform_device_count``, for tests, the dry run
    and chip_smoke.py (four shards on one card show that the mesh path
    runs and is right, not that it scales)."""
    if n_devices < 1:
        raise ValueError(f"need a positive device count, got {n_devices}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hotstuff_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return Mesh([dev] * n_devices)
