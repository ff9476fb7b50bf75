#!/usr/bin/env python3
"""The port's sidecar on a mesh of four cards against one card, with
chip_smoke.py phase 11's requests.

Run from the root of a checkout on a machine with four CUDA cards:

    python3 scripts/torch_mesh_cards.py [--rounds 3] [--out PATH]

Boots ``python -m hotstuff_tpu_torch.sidecar --mesh 4 --warm-rlc-sharded
--committee 1000`` (one process driving four cards) and, beside it, the
same sidecar on one card (``--committee 1000``).  Each gets the requests
of chip_smoke.py's phase 11 over its socket (a QC of 667 votes of a
1000-key committee, the QC over another block with a forged vote, 3
votes, a bulk backlog of 1280, a BLS TC of 67 votes over 67 digests, a
TC of 3 with a wrong-digest vote), then ``--rounds`` further QCs of 667
over fresh blocks, sent to both in turns.  Every mask and verdict must
equal the host reference's.  Each line gives the sidecar, the request,
its path (OP_STATS ``paths``), the wall time of the round trip and, on
the mesh, the kernel launches per shard and on the lead (OP_STATS
``kernels_by_shard``).  The cards' names and power limits come first;
one JSON object with every sample is the last line, and is also written
to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARDS = 4
COMMITTEE = 1000


def boot(flags: list, log_path: str):
    """The sidecar with ``flags`` on a free port: (process, port) once it
    answers a PING."""
    from hotstuff_tpu_torch.sidecar.client import SidecarClient

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "hotstuff_tpu_torch.sidecar", "--port",
             str(port), *flags], cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT)
    t0 = time.monotonic()
    while True:
        try:
            with SidecarClient(port=port, timeout=10) as c:
                c.ping()
            return proc, port, time.monotonic() - t0
        except (ConnectionError, OSError):
            if proc.poll() is not None or time.monotonic() - t0 > 900:
                proc.kill()
                raise RuntimeError(f"sidecar {flags} did not come up:\n"
                                   + open(log_path).read()[-3000:])
            time.sleep(0.5)


def delta(after: dict, before: dict) -> dict:
    out = {}
    for key, counts in after.items():
        d = {k: v - before.get(key, {}).get(k, 0) for k, v in counts.items()
             if v != before.get(key, {}).get(k, 0)}
        if d:
            out[key] = d
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "torch_mesh_cards.json"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"need {CARDS} devices, have {have}", file=sys.stderr)
        return 2
    import chip_smoke
    import hashlib

    from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
    from hotstuff_tpu_torch.offchain import bls12381 as bls
    from hotstuff_tpu_torch.sidecar.client import SidecarClient

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cards = smi.stdout.strip().splitlines()
    for line in cards:
        print(line, flush=True)

    t0 = time.monotonic()
    reqs, bls_reqs = chip_smoke.make_mesh_requests()
    committee = [ref.generate_keypair(hashlib.sha256(
        f"chip-smoke/mesh/replica/{i}".encode()).digest())
        for i in range(2 * COMMITTEE // 3 + 1)]

    def fresh_qc(block: int):
        digest = hashlib.sha256(f"mesh-cards/block/{block}".encode()).digest()
        return ([digest] * len(committee), [pk for _, pk in committee],
                [ref.sign(sk, digest) for sk, _ in committee])

    extra = [(f"QC of 667 votes, round {r}", False, fresh_qc(r))
             for r in range(args.rounds)]
    want = [[ref.verify(pk, m, s) for m, pk, s in zip(*r)]
            for _, _, r in reqs + extra]
    bls_want = [bls.verify_aggregate(pks, msgs, bls.aggregate(sigs))
                for _, pks, msgs, sigs in bls_reqs]
    print(f"signed and host-verified the requests in "
          f"{time.monotonic() - t0:.3f} s", flush=True)

    work = os.path.join(REPO, "build", "chip")
    os.makedirs(work, exist_ok=True)
    sidecars = {}
    try:
        for name, flags in (
                ("mesh4", ["--mesh", str(CARDS), "--warm-rlc-sharded",
                           "--committee", str(COMMITTEE)]),
                ("one_card", ["--committee", str(COMMITTEE)])):
            proc, port, boot_s = boot(flags, os.path.join(
                work, f"mesh-cards-{name}.log"))
            sidecars[name] = (proc, port)
            print(f"{name}: sidecar {flags} answered a PING after "
                  f"{boot_s:.3f} s", flush=True)
        samples = []
        clients = {name: SidecarClient(port=port, timeout=600)
                   for name, (_, port) in sidecars.items()}
        order = list(clients)
        for i, (label, bulk, (msgs, pks, sigs)) in enumerate(reqs + extra):
            for name in order if i % 2 == 0 else order[::-1]:
                c = clients[name]
                before = c.stats()
                t1 = time.perf_counter()
                mask = c.verify_batch(msgs, pks, sigs, bulk=bulk)
                ms = (time.perf_counter() - t1) * 1e3
                after = c.stats()
                paths = sorted(p for p, n in after["paths"].items()
                               if n > before["paths"].get(p, 0))
                shards = delta(after.get("kernels_by_shard", {}),
                               before.get("kernels_by_shard", {}))
                ok = mask == want[i]
                samples.append(dict(sidecar=name, request=label, ms=ms,
                                    paths=paths, launches=shards, ok=ok))
                print(f"{name} {label}: path {'+'.join(paths)}, {ms:.3f} ms,"
                      f" mask {'equal to' if ok else 'DIFFERS FROM'} the "
                      f"host reference, launches per shard and on the "
                      f"lead {shards}", flush=True)
                if not ok:
                    return 1
        for (label, pks, msgs, sigs), w in zip(bls_reqs, bls_want):
            pk_enc = [bls.g1_encode(pk) for pk in pks]
            sig_enc = [bls.g2_encode(s) for s in sigs]
            for name in order:
                c = clients[name]
                before = c.stats()
                t1 = time.perf_counter()
                got = c.bls_verify_multi(msgs, pk_enc, sig_enc)
                ms = (time.perf_counter() - t1) * 1e3
                after = c.stats()
                shards = delta(after.get("kernels_by_shard", {}),
                               before.get("kernels_by_shard", {}))
                samples.append(dict(sidecar=name, request=label, ms=ms,
                                    paths=["bls_multi"], launches=shards,
                                    ok=got == w))
                print(f"{name} {label}: verdict {got} (host reference {w}),"
                      f" {ms:.3f} ms (host preparation included), launches "
                      f"per shard and on the lead {shards}", flush=True)
                if got != w:
                    return 1
        stats = {name: c.stats() for name, c in clients.items()}
        for c in clients.values():
            c.close()
    finally:
        for proc, _ in sidecars.values():
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
    result = {"cards": cards, "samples": samples,
              "mesh": stats["mesh4"]["mesh"], "scan": stats["mesh4"]["scan"],
              "shapes": stats["mesh4"]["shapes"],
              "kernels_by_shard": stats["mesh4"]["kernels_by_shard"]}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
