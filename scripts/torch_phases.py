#!/usr/bin/env python3
"""Run chosen phases of chip_smoke.py alone, each as often as asked.

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/torch_phases.py 7 14 14:bls 14:faults

Phases 1 (the card's name and power limit) and 2 (the kernels' build)
always run first.  Then, in the order given:

  7   the BLS requests through the port's sidecar on the card (phase
      7's second half: verdicts held to the host reference, each
      request's latency and its host preparation by stage);
  14  the committee legs of the local harness (native/ is built once):
      all three, or ``14:ed25519``, ``14:bls`` or ``14:faults`` (the
      Ed25519 fault leg) alone;
  15  the headline bench in its own process.

A phase that fails prints its FAIL line and the next one runs; the
script exits 1 if any failed.  The last line is one JSON object: each
run's phase, outcome and seconds, and the card.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# One leg of phase 14: its scheme, and whether it runs the fault plan.
LEGS = {"14:ed25519": ("ed25519", False), "14:bls": ("bls", False),
        "14:faults": ("ed25519", True)}


def main(argv) -> int:
    phases = list(argv)
    if not phases or set(phases) - {"7", "14", "15", *LEGS}:
        print("usage: torch_phases.py PHASE... (7, 14, 14:ed25519, "
              "14:bls, 14:faults or 15)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    import subprocess

    import chip_smoke as smoke
    from hotstuff_tpu_torch.ops.kern import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.monotonic()
    build.load()
    print(f"kernel build and load: {time.monotonic() - t0:.3f} s",
          flush=True)
    work = os.path.join(REPO, "build", "chip", "harness")
    built = False
    runs = []
    for phase in phases:
        t0 = time.monotonic()
        print(f"== phase {phase}, run {len(runs) + 1}", flush=True)
        try:
            if phase == "7":
                reqs, want = smoke.make_bls_requests()
                smoke.bls_sidecar_phase(dev, reqs, want)
            elif phase == "14":
                smoke.harness_phase(card)
                built = True
            elif phase in LEGS:
                if not built:
                    os.makedirs(work, exist_ok=True)
                    link = os.path.join(work, "native")
                    if not os.path.islink(link):
                        os.symlink(os.path.join(REPO, "native"), link)
                    smoke.native_build(work)
                    built = True
                scheme, faults = LEGS[phase]
                smoke.harness_leg(scheme, card, work,
                                  smoke.FAULT_PLAN if faults else None)
            else:
                smoke.bench_phase(card)
            ok = True
        except SystemExit:
            ok = False
        runs.append({"phase": phase, "ok": ok,
                     "s": round(time.monotonic() - t0, 3)})
        print(f"== phase {phase}: {'ok' if ok else 'FAILED'} in "
              f"{runs[-1]['s']} s", flush=True)
    print(json.dumps({"runs": runs, "card": card}), flush=True)
    return 0 if all(r["ok"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
