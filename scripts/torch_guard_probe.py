#!/usr/bin/env python3
"""Run chip_smoke.py's guard drill (phase 10) alone, N times, with the
wall of the sidecar's guarded launches logged.

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/torch_guard_probe.py [N] [--whole]

Every sidecar that ``chip_smoke.start_sidecar`` boots runs through this
script's ``--sidecar`` mode (``chip_smoke.SIDECAR_CMD``): the port's
sidecar (``hotstuff_tpu_torch.sidecar.service.main``) with
``LaunchGuard.call`` wrapped so that every ``launch:1024`` call and every
call over 50 ms logs ``guard-probe: call KEY wall S`` to the sidecar's
log.  Each drill's log is copied to chiprun_out/guard_probe/drill-<i>.log.
With ``--whole``, ``chip_smoke.main()`` runs first in this process (its
own drill through the same wrapper, copied to whole.log), then the N
drills.  The last line is one JSON object: each drill's outcome and its
``launch:1024`` walls in the order they completed (dispatch and fetch of
the first bulk, then of the second).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "chiprun_out", "guard_probe")
TAG = "guard-probe: call"


def sidecar(argv) -> None:
    """The port's sidecar with each guarded call's wall logged."""
    sys.path.insert(0, REPO)
    from hotstuff_tpu_torch.sidecar import guard, service

    call = guard.LaunchGuard.call

    def timed_call(self, key, thunk):
        t = time.monotonic()
        try:
            return call(self, key, thunk)
        finally:
            wall = time.monotonic() - t
            if wall > 0.05 or key == "launch:1024":
                print(f"{TAG} {key} wall {wall:.6f}", file=sys.stderr,
                      flush=True)

    guard.LaunchGuard.call = timed_call
    service.main(argv)


def walls(path: str) -> list[float]:
    with open(path) as f:
        return [float(line.split()[-1]) for line in f
                if line.startswith(f"{TAG} launch:1024 ")]


def main(argv) -> int:
    if argv[:1] == ["--sidecar"]:
        sidecar(argv[1:])
        return 0
    whole = "--whole" in argv
    nums = [a for a in argv if a != "--whole"]
    n = int(nums[0]) if nums else 10
    sys.path.insert(0, REPO)
    import chip_smoke as smoke

    smoke.SIDECAR_CMD = (os.path.abspath(__file__), "--sidecar")
    os.makedirs(OUT, exist_ok=True)
    log = os.path.join(REPO, "build", "chip", "sidecar-guard.log")
    runs = []

    def keep(name: str, ok: bool, t0: float) -> None:
        shutil.copy(log, os.path.join(OUT, f"{name}.log"))
        runs.append({"run": name, "ok": ok,
                     "s": round(time.monotonic() - t0, 3),
                     "launch_1024_walls_s": walls(log)})
        print(f"== {name}: {'ok' if ok else 'FAILED'}; launch:1024 walls "
              f"{runs[-1]['launch_1024_walls_s']}", flush=True)

    if whole:
        t0 = time.monotonic()
        sys.argv = [os.path.join(REPO, "chip_smoke.py")]
        try:
            ok = smoke.main() == 0
        except SystemExit as e:
            ok = e.code == 0
        keep("whole", ok, t0)
    for i in range(n):
        t0 = time.monotonic()
        try:
            smoke.guard_phase()
            ok = True
        except SystemExit:
            ok = False
        keep(f"drill-{i}", ok, t0)
    print(json.dumps({"runs": runs}), flush=True)
    return 0 if all(r["ok"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
