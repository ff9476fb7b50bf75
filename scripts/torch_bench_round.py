#!/usr/bin/env python3
"""Where one round of the port's headline bench goes, on the card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/torch_bench_round.py [--rounds 5]

One round is what ``python -m hotstuff_tpu_torch.bench`` pipelines 20
times a trial: host preparation of G x N = 16 x 1024 triples
(``eddsa.prepare_batch`` a sub-batch), the copy to the card, and
``ops/ed25519.verify_packed_chunked(x).all()``.  Here each stage runs
alone, in turn, on the main thread, ``--rounds`` times: prep ms, copy
ms (pinned, synchronised), dispatch ms (until the call returns) and the
wait for the card after it; then one round under torch.profiler, whose
device events give the card's busy time a round, and the operators the
call dispatches; then, with --pipelined, the headline itself
(``bench.device_throughput``: rounds pipelined as the bench runs them,
best of its trials), in sigs/s.  Prints every sample and one JSON line
last, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--pipelined", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hotstuff_tpu_torch import bench
    from hotstuff_tpu_torch.crypto import eddsa
    from hotstuff_tpu_torch.ops import ed25519 as E

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    g, n = bench.G, bench.N
    msgs, pks, sigs = bench.make_batch(g, n)

    def prep():
        rows = [eddsa.prepare_batch(msgs[i * n:(i + 1) * n],
                                    pks[i * n:(i + 1) * n],
                                    sigs[i * n:(i + 1) * n])["packed"]
                for i in range(g)]
        return torch.from_numpy(np.stack(rows)).pin_memory()

    x = prep().to(dev)
    if not bool(E.verify_packed_chunked(x).all()):    # build and warm up
        raise SystemExit("benchmark signatures must verify")
    samples = {"prep_ms": [], "copy_ms": [], "dispatch_ms": [],
               "wait_ms": [], "round_ms": []}
    for r in range(args.rounds):
        t0 = time.perf_counter()
        host = prep()
        t1 = time.perf_counter()
        x = host.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        flag = E.verify_packed_chunked(x).all()
        t3 = time.perf_counter()
        ok = bool(flag)
        t4 = time.perf_counter()
        if not ok:
            raise SystemExit("benchmark signatures must verify")
        for key, v in (("prep_ms", t1 - t0), ("copy_ms", t2 - t1),
                       ("dispatch_ms", t3 - t2), ("wait_ms", t4 - t3),
                       ("round_ms", t4 - t0)):
            samples[key].append(round(v * 1e3, 3))
        print(f"round {r}: " + ", ".join(
            f"{k} {v[-1]}" for k, v in samples.items()), flush=True)

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bool(E.verify_packed_chunked(x).all())
        call_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == cuda]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    operators = sum(1 for e in prof.events()
                    if e.device_type != cuda and e.name.startswith("aten::"))
    out = {k: statistics.median(v) for k, v in samples.items()}
    out.update({
        "card": card, "g": g, "n": n, "rounds": args.rounds,
        "profiled_call_ms": round(call_ms, 3),
        "device_events": len(device),
        "device_busy_ms": round(busy_ms, 3) if device else "not measured",
        "busy_share_of_call": round(busy_ms / call_ms, 4)
        if device else "not measured",
        "aten_operators": operators,
        "stage_sum_ms": round(sum(statistics.median(samples[k]) for k in
                                  ("prep_ms", "copy_ms", "dispatch_ms",
                                   "wait_ms")), 3)})
    if args.pipelined:
        out["pipelined_sigs_per_s"] = round(bench.device_throughput(
            msgs, pks, sigs, device=dev), 1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
