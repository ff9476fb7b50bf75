"""Off-chain signature microbenchmarks: the port of
hotstuff_tpu/offchain/bench.py.

The reference benchmark's two workloads with this package's schemes:
  * single sign and verify latency, N iterations per scheme
    (off-chain-benchmarking/main.py:10-38, 100 iterations);
  * a batch and aggregate verify sweep over batch sizes
    (off-chain-benchmarking/main.py:78-111: 20..300 step 20;
    production/src/main.rs:19-64: EdDSA sequential against BLS
    aggregate);
plus the device columns: Ed25519 batches through the port's verify
program and the BLS aggregate check's pairing on the card
(``eddsa_device_ms``, ``bls_aggregate_device_ms``).  Before the sweep
the device's arithmetic is checked exact against host bigints
(``field25519.mul_selfcheck``, ``bls381.selfcheck``), which raise on a
mismatch.

Rows go to stdout as JSON lines; a row with a device time names the
device it ran on.  ``to_csv`` and ``plot_batch`` import pandas and
matplotlib when called, so the rest runs without them.
"""

from __future__ import annotations

import json
import time

import numpy as np


def _timed(fn, iters=1):
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    dt = (time.perf_counter() - t0) / iters
    return out, dt


def device_name(device) -> str:
    """The name a row gives its device: the card's
    (``torch.cuda.get_device_name``) or ``cpu``."""
    import torch

    from ..utils.device import resolve

    dev = resolve(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _make_ed25519(n, msg_len=32):
    from . import eddsa

    rng = np.random.default_rng(11)
    msgs, pks, sigs = [], [], []
    for _ in range(n):
        sk, pk = eddsa.key_gen(rng.bytes(32))
        msg = rng.bytes(msg_len)
        msgs.append(msg)
        pks.append(pk)
        sigs.append(eddsa.sign(sk, msg))
    return msgs, pks, sigs


def measure_single(iters=100, schemes=("eddsa", "ecdsa", "schnorr", "bls")):
    """Single sign + verify latency per scheme on the host (reference
    main.py:10-38)."""
    results = []
    msg = b"off-chain benchmark message"

    if "eddsa" in schemes:
        from . import eddsa

        sk, pk = eddsa.key_gen(b"\x01" * 32)
        sig, sign_dt = _timed(lambda: eddsa.sign(sk, msg), iters)
        ok, verify_dt = _timed(lambda: eddsa.verify(pk, msg, sig), iters)
        if not ok:
            raise RuntimeError("eddsa: a fresh signature did not verify")
        results.append(("eddsa", sign_dt, verify_dt))

    if "ecdsa" in schemes:
        from . import ecdsa

        sk, pk = ecdsa.key_gen(b"\x02")
        sig, sign_dt = _timed(lambda: ecdsa.sign(sk, msg), iters)
        ok, verify_dt = _timed(lambda: ecdsa.verify(pk, msg, sig), iters)
        if not ok:
            raise RuntimeError("ecdsa: a fresh signature did not verify")
        results.append(("ecdsa", sign_dt, verify_dt))

    if "schnorr" in schemes:
        from . import schnorr

        sk, pk = schnorr.key_gen(b"\x03")
        sig, sign_dt = _timed(lambda: schnorr.sign(sk, msg), iters)
        ok, verify_dt = _timed(lambda: schnorr.verify(pk, msg, sig), iters)
        if not ok:
            raise RuntimeError("schnorr: a fresh signature did not verify")
        results.append(("schnorr", sign_dt, verify_dt))

    if "bls" in schemes:
        from . import bls12381 as bls

        # Pure-Python pairing: a handful of iterations is plenty.
        bls_iters = max(1, min(iters, 3))
        sk, pk = bls.key_gen(b"\x04")
        sig, sign_dt = _timed(lambda: bls.sign(sk, msg), bls_iters)
        ok, verify_dt = _timed(lambda: bls.verify(pk, msg, sig), bls_iters)
        if not ok:
            raise RuntimeError("bls: a fresh signature did not verify")
        results.append(("bls", sign_dt, verify_dt))

    rows = []
    for scheme, sign_dt, verify_dt in results:
        row = {
            "workload": "single",
            "scheme": scheme,
            "sign_ms": round(sign_dt * 1e3, 4),
            "verify_ms": round(verify_dt * 1e3, 4),
        }
        rows.append(row)
        print(json.dumps(row))
    return rows


def measure_batch(sizes=tuple(range(20, 301, 20)), on_device=True,
                  device=None):
    """Batch-verify scaling (reference main.py:78-111 sweep and the Rust
    production comparison): Ed25519 as a sequential host loop and as one
    batch on the device, and the BLS aggregate (one message, the
    2-pairing path) on the host and on the device.  ``on_device`` False
    keeps the host columns; ``device`` None is the card, ``"cpu"`` runs
    the kernels' plain versions.  Every device mask and verdict must be
    all valid, or it raises."""
    from . import bls12381 as bls
    from . import eddsa

    rows = []
    msgs_all, pks_all, sigs_all = _make_ed25519(max(sizes))

    # BLS: one shared message, aggregated signature (QC-style).
    bls_keys = [bls.key_gen(i.to_bytes(2, "big") * 4)
                for i in range(max(sizes))]
    common = b"common quorum digest"
    bls_sigs = [bls.sign(sk, common) for sk, _ in bls_keys]

    name = None
    if on_device:
        from ..ops import bls381 as dbls
        from ..ops import field25519

        name = device_name(device)
        field25519.mul_selfcheck(device=device)
        dbls.selfcheck(device=device)
        # One warm-up places the device tables; the check is the same
        # two launches at every size (public keys aggregate on the host).
        agg0 = bls.aggregate(bls_sigs[:2])
        if not dbls.verify_aggregate_common(
                [pk for _, pk in bls_keys[:2]], common, agg0,
                device=device):
            raise RuntimeError("bls: the device warm-up check was false")

    for n in sizes:
        msgs, pks, sigs = msgs_all[:n], pks_all[:n], sigs_all[:n]
        _, host_dt = _timed(lambda: eddsa.verify_batch_host(msgs, pks, sigs))
        row = {
            "workload": "batch",
            "n": n,
            "eddsa_host_ms": round(host_dt * 1e3, 3),
        }

        if on_device:
            # Warm this bucket's tables, then time.
            eddsa.verify_batch_device(msgs, pks, sigs, device=device)
            mask, dev_dt = _timed(
                lambda: eddsa.verify_batch_device(msgs, pks, sigs,
                                                  device=device))
            if not all(mask):
                raise RuntimeError(f"eddsa: the device mask of {n} valid "
                                   f"signatures is not all true")
            row["eddsa_device_ms"] = round(dev_dt * 1e3, 3)

        agg = bls.aggregate(bls_sigs[:n])
        apks = [pk for _, pk in bls_keys[:n]]
        ok, bls_dt = _timed(
            lambda: bls.verify_aggregate_common(apks, common, agg))
        if not ok:
            raise RuntimeError(f"bls: the host aggregate check of {n} is "
                               f"false")
        row["bls_aggregate_ms"] = round(bls_dt * 1e3, 3)

        if on_device:
            ok, dbls_dt = _timed(
                lambda: dbls.verify_aggregate_common(apks, common, agg,
                                                     device=device))
            if not ok:
                raise RuntimeError(f"bls: the device aggregate check of "
                                   f"{n} is false")
            row["bls_aggregate_device_ms"] = round(dbls_dt * 1e3, 3)
            row["device"] = name
        rows.append(row)
        print(json.dumps(row))
    return rows


def measure_message_length(lengths=tuple(range(64, 6401, 640)), iters=20):
    """Single-verify cost against message length on the host
    (production/src/main.rs:67-108)."""
    from . import eddsa

    rows = []
    rng = np.random.default_rng(5)
    sk, pk = eddsa.key_gen(b"\x09" * 32)
    for length in lengths:
        msg = rng.bytes(length)
        sig = eddsa.sign(sk, msg)
        ok, dt = _timed(lambda: eddsa.verify(pk, msg, sig), iters)
        if not ok:
            raise RuntimeError(f"eddsa: a fresh signature over {length} "
                               f"bytes did not verify")
        row = {
            "workload": "msg-length",
            "scheme": "eddsa",
            "msg_len": length,
            "verify_ms": round(dt * 1e3, 4),
        }
        rows.append(row)
        print(json.dumps(row))
    return rows


def to_csv(rows, path):
    import pandas as pd

    pd.DataFrame(rows).to_csv(path, index=False)


def plot_batch(rows, path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    batch = [r for r in rows if r.get("workload") == "batch"]
    if not batch:
        return
    n = [r["n"] for r in batch]
    plt.figure(figsize=(6.4, 4.8))
    for key, label in (("eddsa_host_ms", "Ed25519 host loop"),
                       ("eddsa_device_ms", "Ed25519 device batch"),
                       ("bls_aggregate_ms", "BLS aggregate (common msg)"),
                       ("bls_aggregate_device_ms",
                        "BLS aggregate, device check")):
        ys = [r[key] for r in batch if key in r]
        if len(ys) == len(n):
            plt.plot(n, ys, marker="o", label=label)
    plt.xlabel("signatures")
    plt.ylabel("verify time (ms)")
    plt.yscale("log")
    plt.grid(True, alpha=0.3)
    plt.legend()
    plt.savefig(path, bbox_inches="tight")
