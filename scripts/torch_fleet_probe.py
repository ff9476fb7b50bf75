#!/usr/bin/env python3
"""How often the bench's host-mode ``fleet`` field fails, and which part
of its bar:

    python3 scripts/torch_fleet_probe.py [--runs 20] [--after-bench]
    python3 scripts/torch_fleet_probe.py --flood-detail 5

Runs ``hotstuff_tpu_torch.bench.fleet_headline_probe()`` alone, each
run in a process of its own, ``--runs`` times; with ``--after-bench``
also runs ``python -m hotstuff_tpu_torch.bench`` once (every field
before ``fleet`` first, as ``chip_smoke.py`` phase 15 runs it; needs a
card) and takes the fleet field from its last line.  Each run prints
one JSON line: the field and its bar by part (``chip_smoke.py``'s
``fleet_bar_parts``: masks, rehome, no_host_fallback, goodput, dedup,
flood, the flood verdict's reason and p99s).  The last line counts the
failures by part.  The probe itself needs no card.

``--flood-detail N`` runs the field's greedy-tenant flood alone
(``bench._fleet_flood`` on one host-mode engine) N times and prints,
beside each verdict, the engine's OP_STATS before and after the flood:
the launches by size (``coalesce_hist``) and each tenant's queue wait.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("masks", "rehome", "no_host_fallback", "goodput", "dedup", "flood")


def smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lone_run() -> dict:
    proc = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; sys.path.insert(0, sys.argv[1]); "
         "from hotstuff_tpu_torch import bench; "
         "print(json.dumps(bench.fleet_headline_probe()))", REPO],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        return {"error": proc.stderr[-2000:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def bench_run() -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "hotstuff_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
    if not lines:
        return {"error": f"bench exited {proc.returncode}: "
                         f"{proc.stderr[-2000:]}"}
    fleet = json.loads(lines[-1]).get("fleet", {})
    return dict(fleet, bench_exit=proc.returncode)


def flood_detail(runs: int) -> None:
    import threading

    sys.path.insert(0, REPO)
    from hotstuff_tpu_torch import bench
    from hotstuff_tpu_torch.sidecar.service import SidecarServer, VerifyEngine

    for i in range(runs):
        eng = VerifyEngine(use_host=True)
        srv = SidecarServer(("127.0.0.1", 0), eng)
        threading.Thread(target=srv.serve_forever,
                         kwargs=dict(poll_interval=0.05), daemon=True).start()
        snaps, real = [], eng.stats_snapshot

        def snapshot():
            snaps.append(real())
            return snaps[-1]

        eng.stats_snapshot = snapshot
        try:
            verdict = bench._fleet_flood(srv.server_address[1], eng)
        finally:
            srv.shutdown()
            eng.stop()
            srv.server_close()
        print(json.dumps({"i": i, "verdict": verdict, **{
            phase: {"coalesce_hist": st.get("coalesce_hist"),
                    "queue_wait": {k: v.get("queue_wait") for k, v in
                                   st.get("tenants", {}).items()}}
            for phase, st in zip(("pre", "post"), snaps)}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--after-bench", action="store_true")
    ap.add_argument("--flood-detail", type=int, default=0)
    args = ap.parse_args()
    if args.flood_detail:
        flood_detail(args.flood_detail)
        return 0
    smoke = smoke_module()
    runs = [("alone", i) for i in range(args.runs)]
    if args.after_bench:
        runs.append(("after the bench's fields", 0))
    failed = {p: 0 for p in PARTS}
    results = []
    for label, i in runs:
        t0 = time.monotonic()
        field = lone_run() if label == "alone" else bench_run()
        parts = smoke.fleet_bar_parts(field)
        for p in PARTS:
            failed[p] += not parts[p]
        results.append({"run": label, "i": i, "ok": field.get("ok") is True,
                        "parts": parts, "seconds": time.monotonic() - t0,
                        "field": field})
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps({
        "runs": len(results),
        "failed": sum(not r["ok"] for r in results),
        "failed_alone": sum(not r["ok"] for r in results
                            if r["run"] == "alone"),
        "failed_by_part": failed,
        "reasons": [r["parts"]["reason"] for r in results
                    if not r["ok"]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
