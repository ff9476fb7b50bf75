#!/usr/bin/env python3
"""What the launch guard and the staged engine cost on the card, and the
sidecar process against another checkout's (the parent commit's).

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/torch_guard_cost.py [--rounds 8] [--other PATH]

In one process, in turns:
  * ``bare`` and ``guarded``: one fresh QC of 67 votes (a new digest, so
    no cache hit) through ``VerifyEngine.submit`` of an engine without a
    guard and of one with a guard (as ``serve()`` builds it);
  * ``process``: the same through ``python -m hotstuff_tpu_torch.sidecar``
    booted from this checkout, over its socket; with ``--other PATH``
    also ``other``, the sidecar booted from the checkout at PATH; each
    process arm also verifies one fresh bulk request of 1024;
  * the guard's bare cost (``LaunchGuard.call`` of a no-op), and the RLC
    program's dispatch and fetch on the calling thread against on a
    fresh thread.
Every round rotates which arm goes first.  Prints every sample in ms and
one JSON line last, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def boot_sidecar(root: str, log_path: str):
    """``python -m hotstuff_tpu_torch.sidecar`` from checkout ``root`` on
    a free port; returns (process, port) once it answers a PING."""
    from hotstuff_tpu_torch.sidecar.client import SidecarClient

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "hotstuff_tpu_torch.sidecar", "--port",
             str(port)], cwd=root, stdout=log, stderr=subprocess.STDOUT)
    t0 = time.monotonic()
    while True:
        try:
            with SidecarClient(port=port, timeout=10) as c:
                c.ping()
            return proc, port
        except (ConnectionError, OSError):
            if proc.poll() is not None or time.monotonic() - t0 > 600:
                proc.kill()
                raise RuntimeError(f"the sidecar of {root} did not come "
                                   f"up:\n" + open(log_path).read()[-3000:])
            time.sleep(0.5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--other", default=None, metavar="PATH",
                    help="another checkout whose sidecar process to time "
                         "beside this one's")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    from hotstuff_tpu_torch.crypto import eddsa, ref_ed25519 as ref
    from hotstuff_tpu_torch.sidecar import protocol as proto
    from hotstuff_tpu_torch.sidecar import service
    from hotstuff_tpu_torch.sidecar.client import SidecarClient
    from hotstuff_tpu_torch.sidecar.guard import LaunchDeadlines, LaunchGuard

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    def seed(tag: str, i: int) -> bytes:
        return hashlib.sha256(f"guard-cost/{tag}/{i}".encode()).digest()

    committee = [ref.generate_keypair(seed("replica", i)) for i in range(67)]
    pks = [pk for _, pk in committee]
    fresh_block = iter(range(10 ** 6))

    def qc():
        digest = seed("block", next(fresh_block))
        return [digest] * 67, pks, [ref.sign(sk, digest)
                                    for sk, _ in committee]

    def bulk():
        b = next(fresh_block)
        msgs = [seed(f"tx{b}", j) for j in range(1024)]
        keys = [committee[j % 67] for j in range(1024)]
        return (msgs, [pk for _, pk in keys],
                [ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)])

    dev = torch.device("cuda", 0)
    bare = service.VerifyEngine(device=dev)
    service.warmup(bare)
    guard = LaunchGuard(deadlines=LaunchDeadlines.from_build(dev))
    guarded = service.VerifyEngine(device=dev, guard=guard)
    work = os.path.join(REPO, "build", "chip")
    os.makedirs(work, exist_ok=True)
    roots = {"process": REPO}
    if args.other:
        roots["other"] = os.path.abspath(args.other)
    procs, clients = {}, {}
    try:
        for name, root in roots.items():
            procs[name], port = boot_sidecar(
                root, os.path.join(work, f"guard-cost-{name}.log"))
            clients[name] = SidecarClient(port=port, timeout=120)

        def through_engine(engine) -> float:
            done = threading.Event()
            box = []

            def reply(mask):
                box.append(mask)
                done.set()

            request = proto.VerifyRequest(1, *qc())
            t0 = time.perf_counter()
            engine.submit(request, reply)
            if not done.wait(60):
                raise RuntimeError("no reply within 60 s")
            ms = (time.perf_counter() - t0) * 1e3
            if box[0] != [True] * 67:
                raise RuntimeError("a QC's mask is not all valid")
            return ms

        def through_client(client, batch, is_bulk) -> float:
            t0 = time.perf_counter()
            mask = client.verify_batch(*batch, bulk=is_bulk)
            ms = (time.perf_counter() - t0) * 1e3
            if mask != [True] * len(batch[0]):
                raise RuntimeError("a mask is not all valid")
            return ms

        arms = [("bare", lambda: through_engine(bare)),
                ("guarded", lambda: through_engine(guarded))]
        for name, client in clients.items():
            arms.append((name, lambda c=client: through_client(
                c, qc(), False)))
            arms.append((f"{name}_bulk1024", lambda c=client: through_client(
                c, bulk(), True)))
        for _, arm in arms:                  # one warm-up each
            arm()
        samples = {name: [] for name, _ in arms}
        for r in range(args.rounds):
            k = r % len(arms)
            for name, arm in arms[k:] + arms[:k]:
                samples[name].append(arm())
    finally:
        for c in clients.values():
            c.close()
        for p in procs.values():
            p.terminate()
            p.wait(timeout=30)
        bare.stop()
        guarded.stop()

    calls = []
    for _ in range(200):
        t0 = time.perf_counter()
        guard.call("noop", lambda: None)
        calls.append((time.perf_counter() - t0) * 1e3)
    guard.close()

    # The RLC program's dispatch + fetch on this thread and on a fresh
    # thread, in turns (packed beforehand; the program caches nothing).
    same, fresh = [], []
    batch = qc()
    for r in range(args.rounds):
        for where in (("same", "fresh") if r % 2 == 0
                      else ("fresh", "same")):
            dispatch = eddsa.verify_batch_rlc_pack(*batch, device=dev)
            torch.cuda.synchronize()
            box = []

            def run():
                t0 = time.perf_counter()
                dispatch()()
                box.append((time.perf_counter() - t0) * 1e3)

            if where == "same":
                run()
                same.append(box[0])
            else:
                t = threading.Thread(target=run)
                t.start()
                t.join(60)
                fresh.append(box[0])

    out = {
        "card": card,
        "roots": roots,
        "ms": {k: [round(x, 3) for x in v] for k, v in samples.items()},
        "median_ms": {k: round(statistics.median(v), 3)
                      for k, v in samples.items()},
        "guard_noop_call_ms_median": round(statistics.median(calls), 4),
        "rlc_dispatch_fetch_ms": {"calling_thread": [round(x, 3)
                                                     for x in same],
                                  "fresh_thread": [round(x, 3)
                                                   for x in fresh]},
        "rlc_dispatch_fetch_median_ms": {
            "calling_thread": round(statistics.median(same), 3),
            "fresh_thread": round(statistics.median(fresh), 3)},
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
