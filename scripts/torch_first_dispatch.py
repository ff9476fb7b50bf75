#!/usr/bin/env python3
"""Time the first RLC dispatch at 1024 signatures in fresh processes,
with the Python stack of the dispatching thread sampled while it runs.

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/torch_first_dispatch.py [N [REBOOTS]]

The parent signs a QC of 67 votes and two bulk batches of 1024 once,
then starts N child processes one after another.  Each child boots as
the guard drill's sidecar does before its first request (the kernel
library, ``VerifyEngine(device="cuda")``, ``service.warmup`` and
``service.warmup_bls``), verifies the QC five times through the RLC
program, runs REBOOTS times (default 0) what the guard's crash-only
reboot runs (``_teardown_device``, the two warm-ups) and one more QC,
then sends the two bulk batches as the staged engine does:
bulk 1's pack on the calling thread, bulk 2's pack on a second thread
started with bulk 1's dispatch, each dispatch and fetch on a fresh
thread.  While a dispatch or fetch runs longer than 40 ms, a sampler
takes its thread's Python stack every 20 ms.  Each child prints one
JSON line: the walls in seconds (``dispatch1``, ``fetch1``,
``dispatch2``, ``fetch2``, ``pack2``) and the stacks sampled.  The last
line is one JSON object with every child's line.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import threading
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "build", "chip", "first_dispatch.json")


def seed(tag: str, i: int) -> bytes:
    return hashlib.sha256(f"first-dispatch/{tag}/{i}".encode()).digest()


def make_data() -> None:
    from hotstuff_tpu_torch.crypto import ref_ed25519 as ref

    keys = [ref.generate_keypair(seed("replica", i)) for i in range(67)]
    digest = seed("block", 0)
    qc = ([digest] * 67, [pk for _, pk in keys],
          [ref.sign(sk, digest) for sk, _ in keys])
    bulks = []
    for b in range(2):
        msgs = [seed(f"tx{b}", j) for j in range(1024)]
        ks = [keys[j % 67] for j in range(1024)]
        bulks.append((msgs, [pk for _, pk in ks],
                      [ref.sign(sk, m) for (sk, _), m in zip(ks, msgs)]))
    os.makedirs(os.path.dirname(DATA), exist_ok=True)
    with open(DATA, "w") as f:
        json.dump([[[x.hex() for x in col] for col in batch]
                   for batch in [qc, *bulks]], f)


def timed_on_thread(fn, samples: list, label: str):
    """Run fn on a fresh thread; sample its stack past 40 ms."""
    box: dict = {}

    def run():
        box["out"] = fn()

    t = threading.Thread(target=run)
    t0 = time.monotonic()
    t.start()
    while t.is_alive():
        t.join(0.02)
        if t.is_alive() and time.monotonic() - t0 > 0.04:
            frame = sys._current_frames().get(t.ident)
            if frame is not None:
                samples.append({
                    "at": label, "t_s": round(time.monotonic() - t0, 4),
                    "stack": "".join(traceback.format_stack(frame)[-6:])})
    return box.get("out"), time.monotonic() - t0


def child(reboots: int) -> None:
    sys.path.insert(0, REPO)
    import numpy as np

    from hotstuff_tpu_torch.crypto import eddsa
    from hotstuff_tpu_torch.ops.kern import build
    from hotstuff_tpu_torch.sidecar import service

    with open(DATA) as f:
        qc, bulk1, bulk2 = [[[bytes.fromhex(x) for x in col] for col in b]
                            for b in json.load(f)]
    t0 = time.monotonic()
    build.load()
    engine = service.VerifyEngine(device="cuda")
    service.warmup(engine)
    service.warmup_bls(engine)
    boot_s = time.monotonic() - t0
    for _ in range(5):
        mask = eddsa.verify_batch_rlc(*qc, device=engine.device)
        assert bool(np.all(mask))
    for _ in range(reboots):
        # What the guard's crash-only reboot runs before its canary.
        engine._teardown_device()
        service.warmup(engine)
        service.warmup_bls(engine)
        mask = eddsa.verify_batch_rlc(*qc, device=engine.device)
        assert bool(np.all(mask))
    samples: list = []
    walls: dict = {}
    t = time.monotonic()
    dispatch1 = eddsa.verify_batch_rlc_pack(*bulk1, device=engine.device)
    walls["pack1"] = time.monotonic() - t
    box: dict = {}

    def pack2():
        t = time.monotonic()
        box["dispatch2"] = eddsa.verify_batch_rlc_pack(
            *bulk2, device=engine.device)
        walls["pack2"] = time.monotonic() - t

    packer = threading.Thread(target=pack2)
    packer.start()
    fetch1, walls["dispatch1"] = timed_on_thread(dispatch1, samples,
                                                 "dispatch1")
    packer.join()
    fetch2, walls["dispatch2"] = timed_on_thread(box["dispatch2"], samples,
                                                 "dispatch2")
    mask1, walls["fetch1"] = timed_on_thread(fetch1, samples, "fetch1")
    mask2, walls["fetch2"] = timed_on_thread(fetch2, samples, "fetch2")
    assert bool(np.all(mask1)) and bool(np.all(mask2))
    print(json.dumps({"boot_s": round(boot_s, 3),
                      "walls_s": {k: round(v, 6) for k, v in walls.items()},
                      "samples": samples}), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        child(int(argv[1]))
        return 0
    n = int(argv[0]) if argv else 16
    reboots = int(argv[1]) if len(argv) > 1 else 0
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    t0 = time.monotonic()
    make_data()
    print(f"signed a QC of 67 and two bulks of 1024 in "
          f"{time.monotonic() - t0:.3f} s", flush=True)
    runs = []
    for i in range(n):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", str(reboots)], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        line = out.stdout.strip().splitlines()[-1:] if out.stdout else []
        run = json.loads(line[0]) if out.returncode == 0 and line else {
            "rc": out.returncode, "stderr": out.stderr[-2000:]}
        runs.append(run)
        print(f"== child {i}: {json.dumps(run)[:600]}", flush=True)
    print(json.dumps({"runs": runs}), flush=True)
    return 0 if all("walls_s" in r for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
