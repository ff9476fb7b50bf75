#!/usr/bin/env python3
"""A hand-written kernel on the card, in one or more checkouts of the
repository, each in a process of its own, so that two commits compare
on one card in one call:

    python3 scripts/torch_final_exp_ab.py [--kernel NAME] PARENT . . PARENT

For each root, in the order given, the child process builds the
kernels from that root's sources (``build.load()``) and prints one JSON
line with the root's ``build.source_hash()``.  The last line lists
every run and the card's name and power limit.  Exits 2 without a card.

``--kernel final_exp`` (the default): the child makes the Miller lines
of a valid aggregate of three messages (four pairings, seeded keys)
with that root's host code and times ``final_exp`` in ms a launch (ten
launches replayed in one CUDA graph) at P = 2 (the last two pairings: a
statement that does not hold), 4, 8 and 68 (the four tiled: it holds),
and the device span of ``ops/bls381.pairings_check`` on 2 and 68
pairings (CUDA events around the call, the median of five, as
``chip_smoke.py`` phase 8 takes it).

``--kernel decompress``: the child holds ``decompress`` exactly to its
plain version at 16, 256 and 2048 rows (``chip_smoke.py`` phase 4's
rows: real encodings, random bytes and the edge rows) and times it
there, in ms a launch in a CUDA graph of twenty and in ms a call from
Python; reports the decompress kernels' registers, stack and spills
(ptxas), their resident blocks an SM at 32 to 256 threads a block
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, from a small
program built on the root's ``point_chain.cu``) and their warp
shuffles by loop depth (cuobjdump); and the device busy time of a QC
of 67 through the RLC program (``eddsa.verify_batch_rlc_pack``, warm,
torch.profiler's device events, five runs), as ``chip_smoke.py`` phase
6 takes it.

``--kernel point_multiples``: the same for ``point_multiples`` at
``chip_smoke.MULTIPLES_SHAPES``, the verify paths' shapes (8 and 1024
rows cached from -P, 256 and 2048 extended), each on
``chip_smoke.multiples_inputs`` (real points, random weak limbs, the
identity, all-511 and all-0 rows): exact against its plain version,
graph and Python ms, the point_multiples kernels' ptxas report,
resident blocks an SM and shuffles by loop depth, and a QC of 67's
device busy time.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (2, 4, 8, 68)
DECOMPRESS_ROWS = (16, 256, 2048)
OCCUPANCY_BLOCKS = (32, 64, 128, 256)


def graph_ms(fn, iters=10):
    import torch

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


def one_final_exp(root: str) -> dict:
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


def smoke_module():
    """This checkout's chip_smoke.py (its input rows and report
    parsers; they import the package only inside their functions, so
    they run on the root's)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_occupancy(root: str, build, prefix: str) -> dict:
    """Resident blocks an SM of each kernel of the root's point_chain.cu
    whose name starts with ``prefix``, at each block size, from a
    program that includes the source (its kernels sit in the program's
    own anonymous namespace).  A kernel templated on one bool is taken
    at both values, named as ``chip_smoke.kernel_name`` names it
    (``<0>``, ``<1>``)."""
    src = os.path.join(os.path.abspath(root), "hotstuff_tpu_torch", "ops",
                       "kern", "csrc", "point_chain.cu")
    with open(src) as f:
        found = re.findall(r"(template\s*<\s*bool\s+\w+\s*>\s*)?"
                           r"__global__\s+void\s+(" + prefix + r"\w*)\(",
                           f.read())
    kernels = sorted({(f"{k}<{v}>", f"{k}<{'true' if v else 'false'}>")
                      if tmpl else (k, k)
                      for tmpl, k in found for v in (0, 1)})
    calls = "".join(
        f'  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, {sym}, {t}, '
        f'0);\n  std::printf("{k} {t} %d\\n", b);\n'
        for k, sym in kernels for t in OCCUPANCY_BLOCKS)
    work = os.path.join(REPO, "build", "ab", build.source_hash())
    os.makedirs(work, exist_ok=True)
    prog = os.path.join(work, "occupancy.cu")
    with open(prog, "w") as f:
        f.write(f'#include <cstdio>\n#include "{src}"\n'
                f"int main() {{\n  int b = 0;\n{calls}  return 0;\n}}\n")
    exe = os.path.join(work, "occupancy")
    subprocess.run([build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", prog, "-o", exe], check=True,
                   capture_output=True, timeout=600)
    text = subprocess.run([exe], check=True, capture_output=True, text=True,
                          timeout=60).stdout
    out: dict = {}
    for line in text.splitlines():
        k, t, b = line.split()
        out.setdefault(k, {})[f"blocks_at_{t}"] = int(b)
        out[k][f"warps_at_{t}"] = int(b) * int(t) // 32
    return out


def qc_busy_ms(dev) -> dict:
    """A QC of 67 through the RLC program, warm: the device busy time of
    each of five runs (torch.profiler's device events) and the median."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hotstuff_tpu_torch import bench
    from hotstuff_tpu_torch.crypto import eddsa

    msgs, pks, sigs = bench.make_batch(1, 67)
    pack = eddsa.verify_batch_rlc_pack
    for _ in range(3):
        if not bool(pack(msgs, pks, sigs, device=dev)()().all()):
            raise SystemExit("a valid QC of 67 failed")
    cuda = torch.autograd.DeviceType.CUDA
    runs = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pack(msgs, pks, sigs, device=dev)()()
            torch.cuda.synchronize()
        runs.append(sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == cuda) / 1e3)
    return {"median": sorted(runs)[2], "runs": runs}


def kernel_report(root: str, build, smoke, prefix: str, dev) -> dict:
    """The kernels named ``prefix...``: ptxas's report, resident blocks
    an SM and shuffles by loop depth; and a QC of 67's busy time."""
    _, depths = smoke.sass_shuffles()
    return {"ptxas": {k: v for k, v in
                      smoke.ptxas_report(build.build_log()).items()
                      if k.startswith(prefix)},
            "occupancy": kernel_occupancy(root, build, prefix),
            "shuffles_by_depth": {k: v for k, v in depths.items()
                                  if k.startswith(prefix)},
            "qc67_busy_ms": qc_busy_ms(dev)}


def one_decompress(root: str) -> dict:
    import numpy as np
    import torch

    from hotstuff_tpu_torch.ops.kern import build
    from hotstuff_tpu_torch.ops.kern import point_chain as PC

    smoke = smoke_module()
    dev = torch.device("cuda", 0)
    build.load()
    out = {"root": root, "sources": build.source_hash()}
    rng = np.random.default_rng(20261018)
    for n in DECOMPRESS_ROWS:
        y, sign = smoke.decompress_inputs(rng, n, dev)
        err = smoke.max_abs_err(PC.decompress(y, sign),
                                PC.decompress_plain(y, sign))
        if err != 0:
            raise SystemExit(f"decompress at {n} rows differs from its "
                             f"plain version (max abs err {err})")
        fn = lambda: PC.decompress(y, sign)  # noqa: E731
        out[f"decompress_{n}_graph_ms"] = graph_ms(fn, 20)
        out[f"decompress_{n}_ms"] = smoke.time_ms(fn, 20)
    return dict(out, **kernel_report(root, build, smoke, "decompress", dev))


def one_point_multiples(root: str) -> dict:
    import numpy as np
    import torch

    from hotstuff_tpu_torch.ops.kern import build
    from hotstuff_tpu_torch.ops.kern import point_chain as PC

    smoke = smoke_module()
    dev = torch.device("cuda", 0)
    build.load()
    out = {"root": root, "sources": build.source_hash()}
    rng = np.random.default_rng(20261019)
    for n, cached, negate in smoke.MULTIPLES_SHAPES:
        pts = smoke.multiples_inputs(rng, n, dev)
        args = (pts, cached, negate)
        err = smoke.max_abs_err(PC.point_multiples(*args),
                                PC.point_multiples_plain(*args))
        if err != 0:
            raise SystemExit(f"point_multiples at {args[1:]} and {n} rows "
                             f"differs from its plain version (max abs "
                             f"err {err})")
        label = f"point_multiples_{n}_{'cached' if cached else 'ext'}"
        fn = lambda: PC.point_multiples(*args)  # noqa: E731
        out[f"{label}_graph_ms"] = graph_ms(fn, 20)
        out[f"{label}_ms"] = smoke.time_ms(fn, 20)
    return dict(out, **kernel_report(root, build, smoke, "point_multiples",
                                     dev))


KERNELS = {"final_exp": one_final_exp, "decompress": one_decompress,
           "point_multiples": one_point_multiples}


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        sys.path.insert(0, os.path.abspath(argv[2]))
        print(json.dumps(KERNELS[argv[1]](argv[2])), flush=True)
        return 0
    kernel = "final_exp"
    if argv[:1] == ["--kernel"] and len(argv) > 1:
        kernel, argv = argv[1], argv[2:]
    if not argv or kernel not in KERNELS:
        print(f"usage: torch_final_exp_ab.py [--kernel "
              f"{'|'.join(KERNELS)}] ROOT...", file=sys.stderr)
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
                               "--one", kernel, root], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, flush=True)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"kernel": kernel, "runs": runs, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
