#!/usr/bin/env python3
"""Time K3 (hotstuff_tpu_torch's msm_window_accum kernel) on one NVIDIA
card for each number of partial points per window M between its two
grids, at the RLC program's MSM sizes (the QC's 256 points, the bulk
batch's 2048), each launch replayed from a CUDA graph.

Run from the root of a checkout on a machine with a card:
    python3 scripts/torch_k3_partials.py

Every M must give the same window sums as the plain version (the fold
and finish grids compute the reference's tree nodes whatever M is); the
wrapper uses ``msm_accum.PARTIALS``.  Prints the card's name and power
limit, then one line per (B, M) with the graph ms of the launch pair.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import graph_ms
    from hotstuff_tpu_torch.ops import ed25519 as E
    from hotstuff_tpu_torch.ops.kern import build, stream_of
    from hotstuff_tpu_torch.ops.kern import msm_accum as K3

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    lib = build.load()
    rng = np.random.default_rng(20261017)
    base = E.basepoint_ext(dev).expand(1, 4, 32)
    for b in (256, 2048):
        pts = E.msm_table(base)[0, 1:].repeat(b // 15 + 1, 1, 1)[:b]
        table = E.msm_table(pts.contiguous()).contiguous()
        digits = torch.from_numpy(
            rng.integers(0, 16, (b, 64)).astype(np.int32)).to(dev)
        want = K3.msm_window_accum_plain(table, digits)
        for m in (8, 16, 32, 64):
            out = torch.empty((64, 4, 32), dtype=torch.int32, device=dev)
            partials = torch.empty((64, m, 4, 32), dtype=torch.int32,
                                   device=dev)

            def launch():
                err = lib.hk_msm_window_accum(
                    table.data_ptr(), digits.data_ptr(),
                    partials.data_ptr(), out.data_ptr(), b, m,
                    stream_of(table))
                if err:
                    raise RuntimeError(f"launch failed with error {err}")

            launch()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print(f"FAIL: B {b}, M {m} differs from the plain version")
                return 1
            print(f"B {b}, M {m}: exact; {graph_ms(launch, 20):.6f} ms a "
                  f"launch pair in a CUDA graph", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
