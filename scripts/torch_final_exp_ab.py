#!/usr/bin/env python3
"""final_exp and the BLS pairing check on the card, in one or more
checkouts of the repository, each in a process of its own, so that two
commits compare on one card in one call:

    python3 scripts/torch_final_exp_ab.py PARENT . . PARENT

For each root, in the order given, the child process builds the
kernels from that root's sources (``build.load()``), makes the Miller
lines of a valid aggregate of three messages (four pairings, seeded
keys) with that root's host code, and prints one JSON line:
``final_exp`` in ms a launch (ten launches replayed in one CUDA graph)
at P = 2 (the last two pairings: a statement that does not hold), 4,
8 and 68 (the four tiled: it holds), and the device span of
``ops/bls381.pairings_check`` on 2 and 68 pairings (CUDA events around
the call, the median of five, as ``chip_smoke.py`` phase 8 takes it),
with the root's ``build.source_hash()``.  The last line lists every
run and the card's name and power limit.  Exits 2 without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = (2, 4, 8, 68)


def one(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from hotstuff_tpu_torch.offchain import bls12381 as bls
    from hotstuff_tpu_torch.ops import bls381 as B
    from hotstuff_tpu_torch.ops.kern import build
    from hotstuff_tpu_torch.ops.kern import fq12_tower as FT

    dev = torch.device("cuda", 0)
    build.load()
    keys = [bls.key_gen(bytes([200, i]) * 16) for i in range(3)]
    msgs = [bytes([i]) * 32 for i in range(3)]
    sig = bls.aggregate([bls.sign(sk, m) for (sk, _), m in zip(keys, msgs)])
    lines4 = torch.from_numpy(np.stack(
        B.multi_pairing_rows([pk for _, pk in keys], msgs, sig))).to(dev)

    def tiled(n):
        return lines4.repeat(n // 4 + 1, 1, 1, 1, 1)[-n:].contiguous()

    def graph_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    out = {"root": root, "sources": build.source_hash()}
    for n in SHAPES:
        fs = FT.miller_accumulate(tiled(n))[None].contiguous()
        ok = bool(FT.final_exp(fs)[0])
        if ok != (n > 2):
            raise SystemExit(f"final_exp at P = {n}: verdict {ok}")
        out[f"final_exp_p{n}_ms"] = graph_ms(lambda: FT.final_exp(fs))
    for n in (2, 68):
        lines = tiled(n)[None]
        B.pairings_check(lines)
        spans = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            B.pairings_check(lines)
            end.record()
            torch.cuda.synchronize()
            spans.append(start.elapsed_time(end))
        out[f"check_{n}_span_ms"] = sorted(spans)[2]
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print("usage: torch_final_exp_ab.py ROOT...", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, flush=True)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"runs": runs, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
