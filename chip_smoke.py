#!/usr/bin/env python3
"""Drive hotstuff_tpu_torch's main path once on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ops/kern/csrc with nvcc (and, beside
     them, a program of phase 7 that times the word tower's pieces);
  3. launch the probe kernel K0 and check x + 1;
  4. run K1, K2, K3 (at the bulk batch's 2048 MSM points and the QC's
     256), the three point-chain kernels (point_ladder as the
     per-signature ladder, the comb and Horner; decompress;
     point_multiples) and the two scalar_rlc kernels (rlc_scalars at
     1024 rows, rlc_reduce at batch 1) at the main path's shapes beside
     their plain PyTorch versions on the card, require exact equality,
     and time both (the kernel also as launches replayed from a CUDA
     graph, which leaves out the host's overhead between calls);
     point_ladder at 1024 rows (ladder and comb), batch 1 (comb and
     Horner), 3 rows (the committee's per-signature ladder and comb),
     128 rows (a mesh shard of 1024 over 8) and on a table whose limbs
     are all 511, each beside its bounds in operations, in warp
     shuffles (cuobjdump's count per loop depth times the iterations)
     and, up to 132 rows, on one SM; decompress at 2048, 256 and 16
     rows (a bulk batch, a QC of 67, a per-signature launch) on real
     encodings, random bytes and the edge rows (y = 0, 1 and p - 1
     with either sign, 2, and y >= p: p, p + 1, 2^255 - 1), each beside
     its bounds in operations and in warp shuffles; point_multiples
     at 8 and 1024 rows cached from -P (the per-signature tables of a
     committee launch and of a headline sub-batch) and 256 and 2048
     extended (the RLC tables of a QC of 67 and of a bulk batch) on
     real points, random weak limbs, the identity and all-511 and
     all-0 rows, each beside its bounds in operations and in warp
     shuffles; the point_ladder, decompress and point_multiples
     kernels that spill or use a stack frame fail the run in phase 2;
  5. serve the main path through the port's verify sidecar on the card:
     QC verifies of 67 votes from a 100-key committee (the RLC program),
     a QC with a forged vote and a non-canonical S (RLC with bisection),
     a 3-vote request (the per-signature program), two OP_VERIFY_BULK
     requests of 1024 signatures (RLC at 2048 MSM points), OP_STATS.
     Every mask must equal the host reference row for row; the probe
     must have been launched at the sidecar's boot and every other
     kernel of the path by the requests (launches are counted per grid:
     K3 counts 1 up to 64 points, 2 above); K2 itself is off the path,
     its work done inside rlc_scalars and rlc_reduce;
  6. profile a QC and a bulk batch through the RLC program, and the
     bulk batch through the per-signature program at 1024 rows: host
     wall time split into the program's pack, dispatch and fetch
     stages, the card's busy time from torch.profiler, and the
     operators each function dispatches (the RLC calls must dispatch
     none from scalar25519, whose work the scalar_rlc kernels do);
  7. the BLS12-381 path: the Fq12 kernels (the word-tower kernels of
     fq12_tower.cu: miller_accumulate at 2 and 68 pairings of real
     Miller lines and on a dense random line and a row of lines equal to
     one, final_exp at 2 and 68 real Miller values and on a product
     equal to one, the product whose flat norm has a top limb of 224 or
     more, and a zero value, fq12_hard_pow on an easy-part output; the
     flat chains of fq12_chain.cu, off the path since final_exp: fq12_mul
     at 1 and 68 rows, fq12_pow with the final exponentiation's hard
     exponent, kept as the "before" row, fq_pow with q - 2) beside their
     plain versions, exact, timed as in phase 4, with their int32 bounds
     on the card and on one SM (the chain bound), each counted on the
     algorithm its kernel runs and, for final_exp's Fq inversion, on
     this data; the tower's pieces alone (one Montgomery product and one
     inversion of fq381w.cuh, each bilinear record of fq12w.cuh on one
     block); then,
     on a 100-key BLS committee, the port's sidecar
     serves a QC of 67 votes (OP_BLS_VERIFY_VOTES), the QC with one
     vote over another digest, the QC with a signature that is no
     curve point, OP_BLS_VERIFY_AGG over the 67 keys, a TC of 67 votes
     over 67 digests (OP_BLS_VERIFY_MULTI), OP_BLS_SIGN and a repeat of
     the QC; every verdict must equal the port's host reference
     (offchain/bls12381.py), the signature its host signer's bytes, the
     repeat must come from the verdict cache, and every pairing check
     must launch exactly miller_accumulate and final_exp, once each, and
     no other kernel (launches counted over these requests and per
     request); each
     request's latency is split into the
     device's check and the rest, and the rest by stage (the per-vote G2
     decode, aggregation, the subgroup test, the key decode, hash-to-G2
     from a cold memo, the Miller lines per row, SIGN's G2
     multiplication, the copy);
  8. profile the QC's and the TC's pairing check on the card (the
     requests' own Miller lines): wall time, torch.profiler's device
     busy time, kernel launches and operators by caller;
  9. the wire: the port's sidecar booted in a process of its own with
     the flags the harness gives a 4-node run (hotstuff_tpu/harness/
     local.py), answering OP_HELLO and OP_CHAOS with the reference's
     bytes and a QC with the host reference's mask, its --trace spans
     well formed;
 10. the guard drill: the sidecar booted with --chaos (a 2 s warm grace
     in its environment): QCs of 67 votes on the device; a scripted
     wedge, a QC with a forged vote answered by the host ladder with the
     expected mask, a bulk request of 1024 answered OP_BUSY during the
     crash-only reboot, device routing again after the canary, fresh QCs
     through the RLC kernels; a wedged BLS QC answered transient with the
     reference's bytes, BLS QCs True from the card after the reboot; the
     chaos knobs (shed, a 200 ms delay with a pipelined PING answered
     first, drop, clear); two bulk requests back to back and OP_STATS
     ``pipeline``.  A chaos wedge parks the launch's guard thread, not
     the card;
 11. the mesh: fq12_product (the shard's fold) at 17 and 68 rows beside
     its plain version, exact, timed with its bound and one-SM chain
     bound; the gathered window sums of a 667-vote QC's four shards
     tree-summed by _tree_sum on the card and by its plain version,
     exact; then four shards on the card (virtual_mesh(4, cuda:0))
     behind VerifyEngine(mesh=...) with committee 1000, the
     --warm-rlc-sharded warm-up and a launch guard: a QC of 667 votes
     (rlc_sharded, 256 rows a shard), a QC of 667 with one forged vote
     (rlc_sharded with bisection), 3 votes (ladder_sharded), a bulk
     backlog of 1280 (scan_sharded, 2 chunks of 256 rows a shard), a TC
     of 67 votes over 67 digests (68 rows, 17 a shard) and a TC of 3
     with a wrong-digest vote, each line with its path, mask or verdict
     (equal to the one-card program's on the card and the host
     reference's), launches per shard and on the lead, and wall time;
 12. the cadence ring (sidecar/ring.py) on the card, every engine under
     one launch guard: 12 QCs of 67 votes of a 100-key committee, one
     tampered vote each, offered one every 5 ms to the staged engine
     and to the ring pinned at depths 2, 4 and 8 (a fresh engine each),
     then to the staged engine again (the ring's ratio is to the mean
     of the two staged legs), sigs/s and per-request latency for each,
     every mask equal to the host reference's; 16 valid QCs to the
     staged engine and to a fresh ring seeded with the warm-up's walls
     (its trainer's state printed); a ring whose depth
     trainer is seeded with the warm-up's walls: the same load, a bulk
     backlog of 1024 (64 requests of 16) with a QC offered behind its
     first half (the QC's tick pad-fills), its OP_STATS ``cadence``
     section (no generation drop; a ``tick:`` deadline trained), then a
     chaos wedge under the ring (the host ladder answers, the ring falls
     back to the staged loop, one reply per request id, the next QC
     from the card); a sidecar process booted with --cadence
     --warm-bls (its log shows the ring engaged and the BLS self-check
     exact before the socket binds) answering a QC, OP_STATS ``cadence``;
     last, four shards of the card with the ring and
     committee 1000: 3 votes and a twin with a forged vote armed
     through ring_slot_pack at the ring's fixed rows (ladder_sharded),
     a QC of 667 (rlc_sharded), masks equal to verify_batch_sharded_pack
     and the host reference, launches per shard and on the lead;
 13. the off-chain suite (offchain/) on the card: the three self-checks
     (field25519.mul_selfcheck, field381.mul_selfcheck,
     bls381.selfcheck), measure_single for EdDSA, ECDSA, Schnorr and
     BLS, measure_batch at 20, 160 and 300 with both device columns
     (every mask and verdict true, each row naming the card), and
     measure_message_length at three lengths;
 14. the local benchmark harness (hotstuff_tpu_torch/harness): native/
     built once (the harness's own compile step where cmake is on the
     PATH, else scripts/native_build.sh), then LocalBench at the
     harness's local settings (4 nodes, 100,000 tx/s of 512 B, batches
     of 15,000 B, a 1,000 ms timeout, --tpu-sidecar --warm-rlc; a 20 s
     window, the default's 30 cut) boots the port's sidecar on the card
     and a committee of the unchanged C++ nodes with their clients on
     free ports, for Ed25519, for BLS, and for Ed25519 under the fault
     plan FAULT_PLAN (harness/faults.py: a replica killed and restarted,
     then a wedge of the sidecar's next launch over OP_CHAOS; the 30 s
     window the plan needs), in build/chip/harness/ (its sweep reaches
     only processes running there).  Each of the first two legs must commit
     with finite consensus and end-to-end latency; its OP_STATS paths
     must be device routes only, with no request shed (queue_full, the
     guard's busy replies) and the guard's device up; its sidecar log
     must show no host route; every replica must have connected, kept
     its breaker closed and logged no host route; the sidecar must have
     admitted at least the replicas' certificate checks and answered
     each within half the replicas' deadline; the committee must launch
     the scheme's kernels.  In the Ed25519 leg a forged batch of 67
     votes sent mid-run must get the host mask; the BLS leg's log must
     show the boot self-check exact.  The fault leg must execute every
     event, recover from each with a finite latency, commit after the
     last, show the guard's wedge and reboot with the device up at
     teardown, and route and launch on the device again after the
     reboot with no host answer after it.  One JSON line per leg: TPS
     and latency, routes, launches per kernel over the sampled window,
     queue waits, the trace's sidecar breakdown and critical path (its
     verify_submit->verify_reply segment is the verify round trip), the
     chip host's load averages, the CPU share of the replicas, clients
     and sidecar and its memory, the replicas' stores' size, what the
     replicas and clients logged in counts (payload blocks proposed and
     committed, digests a block, batches, view timeouts, TCs, consensus
     events slower than 500 ms by kind, WARN lines by kind), for BLS the
     engine thread's wall by request kind (OP_STATS ``bls_busy``), for
     the fault leg its events and recoveries, the card;
 15. the headline bench: ``python -m hotstuff_tpu_torch.bench`` in its
     own process at full width (16 sub-batches of 1024 a round, 20
     rounds, best of 4; every field at its sizes and default budget).
     Its last line must carry a live value above 0, vs_baseline against
     the single-core OpenSSL baseline it names, the card as phase 1
     names it, every field of the root bench's probes present and
     passing its bar (mesh_rlc and committee_scale: every size measured
     on eight shards of the card, each route launching on every shard;
     cadence and fleet: their ``ok``; a field that fails, or one the
     bench names as failed when it exits non-zero, is printed whole,
     the fleet field's bar by part), and the launch tallies: each
     headline call exactly 16 decompress, 32 point_ladder, 16
     point_multiples and 160 field_mul launches, the rlc field through
     rlc_scalars, rlc_reduce and msm_window_accum, K0 once.

The line before the last is a JSON object listing the kernels with
their launches on the main paths (over the requests, the probe's at
boot, and one request of each kind; the Fq12 kernels over the BLS
requests; fq12_product over phase 11's; ``launches_mesh`` over phase
11's requests, ``launches_ring`` over phase 12's, ``launches_offchain``
over phase 13, ``launches_harness`` over phase 14's sampled windows
(the committees' and the forged batch's), the probe's at the sidecars'
boots; ``launches_bench_round`` one call of phase 15's headline (one
round), ``launches_bench_rlc`` its rlc field, ``launches_bench_mesh`` its
mesh_rlc, committee_scale and cadence fields; the probe's library time is
torch.add's), times and bounds;
the last line is {"ok": true, "device":
{...}}.  Without a CUDA device, or without the rest of the repository
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM at its 700 W limit.  Bytes: HBM3 at 3.35
# TB/s (NVIDIA's data sheet).  The kernels do int32 scalar arithmetic:
# an SM of compute capability 9.0 retires 64 32-bit integer adds,
# multiply-adds, shifts or logical operations per clock (CUDA C++
# Programming Guide, throughput of native arithmetic instructions), on
# 132 SMs at the 1.98 GHz boost clock that the data sheet's 67 TFLOP/s
# float32 rate implies (132 SMs x 128 lanes x 2 x 1.98 GHz).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 64 * 132 * 1.98e9

# int32 instructions per unit of work, a multiply-add counting as one
# and a carry step as three per limb (mask, shift, add).
OPS_CARRY_STEP = 3 * 32
OPS_FIELD_MUL = 32 * 32 + 32 + 4 * OPS_CARRY_STEP   # products, x38 fold
# A squaring: the 528 symmetric products, the doubling and the fold of
# each coefficient (the same integers as the multiply's).
OPS_FIELD_SQR = 528 + 32 + 32 + 4 * OPS_CARRY_STEP
OPS_FIELD_ADD = 32 + OPS_CARRY_STEP
OPS_FIELD_SUB = 2 * 32 + 2 * OPS_CARRY_STEP
OPS_TO_CACHED = OPS_FIELD_MUL + OPS_FIELD_ADD + OPS_FIELD_SUB
OPS_ADD_CACHED = 8 * OPS_FIELD_MUL + 4 * OPS_FIELD_ADD + 3 * OPS_FIELD_SUB
OPS_DBL = (4 * OPS_FIELD_SQR + 4 * OPS_FIELD_MUL + 3 * OPS_FIELD_ADD
           + 5 * OPS_FIELD_SUB)
OPS_DBL_NO_T = OPS_DBL - OPS_FIELD_MUL
OPS_TREE_NODE = OPS_TO_CACHED + OPS_ADD_CACHED
OPS_MONT_ROW = (32 * 32 + 528 + 32 * 32                # T, m, m*L
                + 3 * (64 + 32 + 64) + 4 * 32)         # ripples, subtract
OPS_COND_SUB = 4 * 32
# rlc_scalars: two mul_mod_l (four Montgomery products), two lifts
# (multiply-add and a 32-byte ripple each) and two nibble splits.
OPS_RLC_SCALARS_ROW = (4 * OPS_MONT_ROW + 2 * (32 + 3 * 32)
                       + 2 * 2 * 32)
# rlc_reduce: the 36-byte ripple, one Montgomery product, mod_small's
# four conditional subtracts, add_mod_l's add, ripple and subtract.
OPS_RLC_REDUCE_ROW = (3 * 36 + OPS_MONT_ROW + 4 * OPS_COND_SUB
                      + 32 + 3 * 32 + OPS_COND_SUB)
# canonical: two 32-limb ripples (add, mask, shift), the x38 adds, two
# borrow chains (subtract twice, compare, shift-add) and the select.
OPS_CANONICAL = 2 * 3 * 32 + 2 + 2 * 4 * 32 + 32
# decompress: 255 squarings (251 of them in the pow chain) and 20
# multiplies (11 in the pow chain), one add, three subtractions and four
# canonical forms.
OPS_DECOMPRESS_ROW = (255 * OPS_FIELD_SQR + 20 * OPS_FIELD_MUL
                      + OPS_FIELD_ADD + 3 * OPS_FIELD_SUB
                      + 4 * OPS_CANONICAL)
# point_multiples: to_cached(P) and 14 additions (extended output).
OPS_MULTIPLES_ROW = OPS_TO_CACHED + 14 * OPS_ADD_CACHED


# The warp-per-element kernels exchange limbs by warp shuffles, and an SM
# issues one shuffle (32 lanes) per clock: a second bound that the int32
# one does not count.
PEAK_WARP_SHUFFLES_PER_S = 132 * 1.98e9


# BLS12-381 (fq12_chain.cu, field381.cuh), counted the same way on
# 48-limb elements: a Montgomery product is the a*b, m = T q' (low half)
# and m*q schoolbooks plus ten carry steps over 96, 48 and 96 limbs;
# reduce_sum six steps over 49-48 limbs and two folds; an Fq12 product
# 144 Montgomery products, the anti-diagonal adds, 35 reduce_sums and the
# fold's 11 (add, add, sub).
OPS_MONT_381 = (48 * 48 + 48 * 49 // 2 + 48 * 48
                + 3 * (3 * 96 + 3 * 48 + 3 * 96 + 48) + 8)
OPS_REDUCE_SUM_381 = 3 * 3 * 49 + 48 + 3 * 2 * 48 + 2 + 48 + 3 * 48
OPS_ADD_381 = 48 + 3 * 48
OPS_SUB_381 = 2 * 48 + 3 * 2 * 48
OPS_FQ12_MUL = (144 * OPS_MONT_381 + 144 * 48 + 35 * OPS_REDUCE_SUM_381
                + 11 * (2 * OPS_ADD_381 + OPS_SUB_381))
FQ12_BYTES = 12 * 48 * 4

# The word tower (fq12_tower.cu on fq381w.cuh, fq12w.cuh), counted per
# 32-bit word: an IMAD.WIDE (32 x 32 -> 64 bits, or a 64-bit
# multiply-add) as two int32 operations, a 64-bit add as two, a word
# add or subtract with its carry or borrow as three.  A Montgomery
# product (CIOS) is 2 x 144 IMAD.WIDE, each with a 64-bit add of the
# running carry, the per-row top-word updates, and reduce13 (the
# quotient estimate, a 12-word multiply-subtract and one conditional
# subtraction).  A sum term adds one word column per word (an
# IMAD.WIDE by its coefficient); a negative term first forms q - v.
OPS_W_REDUCE = 2 + 12 * (2 + 3) + 12 * 4
OPS_W_MONT = 2 * 144 * (2 + 2) + 12 * 12 + OPS_W_REDUCE
OPS_W_TERM = 12 * 2
OPS_W_NEG = 12 * 3
OPS_W_CARRY = 12 * 3
OPS_W_CONVERT = 2 * 48 + 12 * 3 + OPS_W_REDUCE   # limbs <-> words, per Fq
# One SM's int32 rate: the least time of a dependent chain that one
# block (one SM) runs, whatever its layout inside the SM.
PEAK_SM_INT32_OPS_PER_S = 64 * 1.98e9


def ops_ladder_row(steps: int, ndbl: int) -> int:
    dbl = (ndbl - 1) * OPS_DBL_NO_T + OPS_DBL if ndbl else 0
    return steps * (dbl + OPS_ADD_CACHED)


def fail(msg: str) -> None:
    # On stderr too: a caller that keeps only the end of stderr still
    # sees which check failed.
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke.py FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_name(mangled: str) -> str | None:
    """The kernel's name in a mangled symbol, with its integer and bool
    template arguments (``point_ladder_kernel<4>``); None when
    no part of it names a kernel."""
    import re

    # The mangled name's parts are length-prefixed, and the prefix may
    # follow digits of an anonymous namespace's hash: take the part that
    # ends in _kernel and whose length a tail of the digits before it
    # gives.
    for m in re.finditer(r"_kernel", mangled):
        end = m.end()
        for d in re.finditer(r"\d+", mangled[:m.start()]):
            digits, start = d.group(), d.end()
            if any(int(digits[i:]) == end - start
                   for i in range(len(digits))):
                name = mangled[start:end]
                targs = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
                if targs:
                    name += "<" + ",".join(
                        re.findall(r"L[ib](\d+)E", targs.group(1))) + ">"
                return name
    return None


def sass_shuffles() -> tuple[dict, dict]:
    """Warp-shuffle (SHFL) instructions in each kernel's machine code,
    from cuobjdump on the built library: the static count, and the count
    at each loop depth (a loop being the span from a backward branch's
    target to the branch).  Both empty when the toolkit has no
    cuobjdump."""
    import re

    from hotstuff_tpu_torch.ops.kern import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    lib = build.BUILD_ROOT / build.source_hash() / build.LIB_NAME
    if not os.path.exists(tool):
        return {}, {}
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    code: dict = {}   # kernel -> [(address, instruction or label)]
    name = None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = kernel_name(line)
            if name:
                code[name] = []
            continue
        if not name:
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if label:
            code[name].append((None, label.group(1)))
        elif ins:
            code[name].append((int(ins.group(1), 16), ins.group(2)))
    counts, depths = {}, {}
    for name, lines in code.items():
        where, addr = {}, None
        for a, text in reversed(lines):   # a label sits at the next address
            if a is None:
                where[text] = addr
            else:
                addr = a
        loops = []
        for a, text in lines:
            if a is None or not re.search(r"\bBRA\b", text):
                continue
            m = re.search(r"\((\.L_x_\d+)\)", text)
            h = re.search(r"\b0x([0-9a-f]+)\s*$", text)
            target = (where.get(m.group(1)) if m else
                      int(h.group(1), 16) if h else None)
            if target is not None and target < a:
                loops.append((target, a))
        by_depth: list = []
        for a, text in lines:
            if a is not None and "SHFL" in text:
                d = sum(lo <= a <= hi for lo, hi in loops)
                by_depth += [0] * (d + 1 - len(by_depth))
                by_depth[d] += 1
        counts[name] = sum(by_depth)
        depths[name] = by_depth
    return counts, depths


def ptxas_report(log: str) -> dict:
    """Each kernel's registers, stack frame and spill bytes from
    ptxas's -v report in build.log."""
    import re

    report: dict = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)", line)
        if m:
            name = kernel_name(m.group(1))
            if name:
                report.setdefault(name, {})
            continue
        if not name:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            report[name].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
    return report


# The kernels on fq12_lanes.cuh's split step.
LANE_KERNELS = ("final_exp_kernel", "fq12_hard_pow_kernel")


def lane_kernel_report(log: str) -> dict:
    """ptxas's report for each split-step kernel: its registers, stack
    and spills, and the stack and spills of every device function
    compiled into it (the lines after its entry, until the next)."""
    import re

    out: dict = {}
    name = None
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([A-Za-z0-9_]+)'", line)
        if m:
            name = kernel_name(m.group(1))
            name = name if name in LANE_KERNELS else None
            if name:
                out[name] = {"functions": {}}
            fn = None
            continue
        if name is None:
            continue
        m = re.search(r"Function properties for ([A-Za-z0-9_]+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            rep = dict(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            if kernel_name(fn) == name:
                out[name].update(rep)
            else:
                out[name]["functions"][fn] = rep
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def check_tower_registers(log: str) -> None:
    """Phase 2: the split-step kernels' registers, spills and stack from
    ptxas's report, and those of the device functions compiled into
    them; a kernel or function that spills or uses a stack frame fails."""
    report = lane_kernel_report(log)
    for name in LANE_KERNELS:
        rep = report.get(name)
        if not rep or "registers" not in rep:
            fail(f"{name} is not in ptxas's report")
        fns = rep.pop("functions")
        print(f"split-step kernel {name}: {rep}; {len(fns)} device "
              f"functions", flush=True)
        bad = {f: r for f, r in fns.items() if any(r.values())}
        for f, r in sorted(fns.items()):
            print(f"  {f}: {r}", flush=True)
        if any(rep[k] for k in ("stack", "spill_stores", "spill_loads")) \
                or bad:
            fail(f"{name} or a function in it spills or uses a stack "
                 f"frame: {rep} {bad}")


def time_ms(fn, iters: int) -> float:
    """Mean ms per call on the card (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean ms per call on the card with ``iters`` calls captured in one
    CUDA graph and replayed: the device's own time per launch, without
    the host's Python and launch overhead between calls."""
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


# decompress's edge rows, (y, sign): y = 0 and y = 1 with either sign,
# y = p - 1 with either sign, y = 2 (u = 3 over v = 4d + 1 is no
# square), and y >= p (p, p + 1 and 2^255 - 1; the host flags these, the
# kernel still sees them).
P25519 = 2**255 - 19
DECOMPRESS_EDGE_ROWS = (
    (0, 0), (0, 1), (1, 0), (1, 1), (P25519 - 1, 0), (P25519 - 1, 1),
    (2, 0), (P25519, 0), (P25519 + 1, 0), (P25519 + 1, 1),
    (2**255 - 1, 0), (2**255 - 1, 1))


def decompress_inputs(rng, n: int, dev):
    """(n, 32) int32 y limbs and (n,) int32 sign bits for decompress:
    encodings of real points (multiples of the base point, up to 256
    distinct, tiled) in the first 7/8 of the rows (half of the rows
    that are not edge rows, below 128 rows), then random bytes (about
    half of them not on the curve), the edge rows last."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
    from hotstuff_tpu_torch.ops import ed25519 as E

    edges = len(DECOMPRESS_EDGE_ROWS)
    n_real = n * 7 // 8 if n >= 128 else (n - edges) // 2
    enc = [ref.encode_point(ref.scalar_mult(int(k), ref.B))
           for k in rng.integers(1, 2**62, min(256, n_real))]
    real = np.frombuffer(b"".join(enc), np.uint8).reshape(-1, 32)
    real = np.tile(real, (n_real // len(real) + 1, 1))[:n_real]
    rand = rng.integers(0, 256, (n - n_real - edges, 32)).astype(np.uint8)
    edge = np.array([list((y | s << 255).to_bytes(32, "little"))
                     for y, s in DECOMPRESS_EDGE_ROWS], np.uint8)
    arr = np.concatenate([real, rand, edge])
    return E.split_y_sign(torch.from_numpy(arr).to(dev))


# point_multiples at the verify paths' shapes, (rows, cached, negate): the
# per-signature program's cached tables of -A for 1024 rows (a headline
# sub-batch, a bulk of 1024; 16 launches a headline round) and 8 (a
# committee's 3-8 votes), the RLC program's extended MSM tables of 256
# points (a QC of 67, bucket 128) and 2048 (a bulk of 1024).
MULTIPLES_SHAPES = ((2048, False, False), (1024, True, True),
                    (8, True, True), (256, False, False))


def multiples_inputs(rng, n: int, dev):
    """(n, 4, 32) int32 extended points for point_multiples (n >= 5):
    real points (decompressed encodings of up to 64 distinct multiples
    of the base point, tiled) first, then an eighth of the rows (at
    least one) of random weak limbs in [0, 512), and the edge rows last:
    the identity, a row of all-511 limbs (the top of the weak form) and
    a row of all-0 limbs."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
    from hotstuff_tpu_torch.ops import ed25519 as E
    from hotstuff_tpu_torch.ops.kern import point_chain as PC

    n_rand = max(1, n // 8)
    n_real = n - n_rand - 3
    enc = [ref.encode_point(ref.scalar_mult(int(k), ref.B))
           for k in rng.integers(1, 2**62, min(64, n_real))]
    real = np.frombuffer(b"".join(enc), np.uint8).reshape(-1, 32)
    real = np.tile(real, (n_real // len(real) + 1, 1))[:n_real]
    pts, ok = PC.decompress(*E.split_y_sign(torch.from_numpy(real).to(dev)))
    if not bool(ok.all()):
        raise ValueError("a base point multiple did not decompress")
    rand = rng.integers(0, 512, (n_rand, 4, 32)).astype(np.int32)
    edge = torch.stack([E.identity_ext((), dev),
                        torch.full((4, 32), 511, dtype=torch.int32,
                                   device=dev),
                        torch.zeros((4, 32), dtype=torch.int32, device=dev)])
    return torch.cat([pts, torch.from_numpy(rand).to(dev), edge]).contiguous()


def max_abs_err(a, b) -> int:
    """Largest absolute difference; tuples compare element by element
    (a shape mismatch counts as a difference of -1)."""
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        return -1
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def kernel_phase(dev, rng, shuffles, depths):
    """Phases 3 and 4: each kernel beside its plain version, exact."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.ops import ed25519 as E
    from hotstuff_tpu_torch.ops.kern import field_mul as K1
    from hotstuff_tpu_torch.ops.kern import msm_accum as K3
    from hotstuff_tpu_torch.ops.kern import point_chain as PC
    from hotstuff_tpu_torch.ops.kern import probe as K0
    from hotstuff_tpu_torch.ops.kern import scalar_mont as K2
    from hotstuff_tpu_torch.ops.kern import scalar_rlc as SR
    from hotstuff_tpu_torch.utils.intmath import L

    rows = []

    def measure(name, shape, kernel, plain, args, nbytes, ops, iters):
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            fail(f"{name} at {shape} differs from its plain version "
                 f"(max abs err {err})")
        ms = time_ms(lambda: kernel(*args), iters)
        dev_ms = graph_ms(lambda: kernel(*args), iters)
        plain_ms = time_ms(lambda: plain(*args), max(1, iters // 10))
        b_ms, b_by = bound_ms(nbytes, ops)
        print(f"{name} {shape}: exact; kernel {ms:.6f} ms a call from "
              f"Python, {dev_ms:.6f} ms a launch in a CUDA graph; plain "
              f"{plain_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by})",
              flush=True)
        return dict(max_abs_err=err, ms=ms, graph_ms=dev_ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    def record(name, source, replaces, shape, *args, library=None):
        # ``library``: the one PyTorch call that computes the same
        # function, where there is one (only the probe's x + 1); it is
        # timed here and used nowhere in the port.
        lib = {"library_ms": None}
        if library is not None:
            lib = {"library_ms": time_ms(library, 200),
                   "library_graph_ms": graph_ms(library, 200)}
            print(f"{name} {shape}: library call {lib['library_ms']:.6f} "
                  f"ms from Python, {lib['library_graph_ms']:.6f} ms in a "
                  f"CUDA graph", flush=True)
        rows.append(dict(name=name, route="cuda", shape=shape,
                         source=source, replaces=replaces, **lib,
                         **measure(name, shape, *args)))

    # K0: the probe.
    x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    y = K0.probe(x)
    torch.cuda.synchronize()
    if not bool((y == 1).all()):
        fail("probe kernel did not return x + 1")
    print("K0 probe: launched, x + 1 correct", flush=True)
    record("probe", "hotstuff_tpu_torch/ops/kern/csrc/probe.cu",
           "hotstuff_tpu/ops/kern/backend.py:41", "(8, 128)", K0.probe,
           K0.probe_plain, (x,), 2 * x.numel() * 4, x.numel(), 200,
           library=lambda: torch.add(x, 1))

    # K1 at the bulk path's row count and at batch 1 (Horner, comb).
    src1 = "hotstuff_tpu_torch/ops/kern/csrc/field_mul.cu"
    rep1 = "hotstuff_tpu/ops/kern/field_mul.py:38"
    k1_args = []
    for n in (2048, 1):
        a = rng.integers(0, 512, (n, 32)).astype(np.int32)
        b = rng.integers(0, 512, (n, 32)).astype(np.int32)
        a[0] = 511
        b[0] = 511
        k1_args.append((f"({n}, 32)", K1.field_mul, K1.field_mul_plain,
                        (torch.from_numpy(a).to(dev),
                         torch.from_numpy(b).to(dev)),
                        3 * n * 32 * 4, n * OPS_FIELD_MUL, 200))
    record("field_mul", src1, rep1, *k1_args[0])
    rows[-1].update({f"batch1_{k}": v for k, v in
                     measure("field_mul", *k1_args[1]).items()})

    # K2 at the bulk path's RLC rows, with the 2^256 - 1 headroom case.
    n = 1024
    va = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(n)]
    vb = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(n)]
    va[0], va[1], vb[1] = 2**256 - 1, L - 1, L - 1
    to_bytes = lambda vs: np.array(  # noqa: E731
        [[(v >> (8 * i)) & 0xFF for i in range(32)] for v in vs], np.int32)
    sa = torch.from_numpy(to_bytes(va)).to(dev)
    sb = torch.from_numpy(to_bytes(vb)).to(dev)
    record("scalar_mont_mul", "hotstuff_tpu_torch/ops/kern/csrc/scalar_mont.cu",
           "hotstuff_tpu/ops/kern/scalar_mont.py:95", f"({n}, 32)",
           K2.scalar_mont_mul, K2.scalar_mont_mul_plain, (sa, sb),
           3 * n * 32 * 4, n * OPS_MONT_ROW, 200)

    # rlc_scalars (K2 redesigned) at the bulk path's 1024 rows: random
    # coefficients, challenges and S, with an excluded (all-zero z) row
    # and the boundary values; rlc_reduce at the RLC finish's batch 1, on
    # the limb sum of rlc_scalars' u.
    n = 1024
    rand = lambda bound: [  # noqa: E731
        int.from_bytes(rng.bytes(32), "little") % bound for _ in range(n)]
    zv, kv, sv = rand(L), rand(L), rand(L)
    zv[0], zv[1], kv[1], sv[2] = 0, 1, L - 1, 2**256 - 1
    z, k, s = (torch.from_numpy(to_bytes(v)).to(dev) for v in (zv, kv, sv))
    record("rlc_scalars", "hotstuff_tpu_torch/ops/kern/csrc/scalar_rlc.cu",
           "hotstuff_tpu/ops/kern/scalar_mont.py:95", f"({n}, 32) x 3",
           SR.rlc_scalars, SR.rlc_scalars_plain, (z, k, s),
           n * (3 * 32 + 2 * 64 + 32) * 4, n * OPS_RLC_SCALARS_ROW, 200)
    u_sum = torch.sum(SR.rlc_scalars_plain(z, k, s)[1], dim=0,
                      dtype=torch.int32)
    record("rlc_reduce", "hotstuff_tpu_torch/ops/kern/csrc/scalar_rlc.cu",
           "hotstuff_tpu/ops/kern/scalar_mont.py:95", "(32,)",
           SR.rlc_reduce, SR.rlc_reduce_plain, (u_sum,), 2 * 32 * 4,
           OPS_RLC_REDUCE_ROW, 200)

    # K3 at the bulk path's 2048 MSM points and at the QC's 256: a table
    # of real curve points (the base point's multiples, made on the card)
    # and random digits, with zero-digit rows as bucket padding makes
    # them.
    base = E.basepoint_ext(dev)
    k3_args = []
    for b in (2048, 256):
        steps = torch.from_numpy(
            rng.integers(0, 16, (b, 64)).astype(np.int32)).to(dev)
        pts = E.msm_table(base.expand(1, 4, 32))[0, 1:].repeat(
            b // 15 + 1, 1, 1)[:b]
        table = E.msm_table(pts.contiguous()).contiguous()
        digits = steps.clone()
        digits[b - b // 32:] = 0
        k3_args.append((f"table ({b}, 16, 4, 32)", K3.msm_window_accum,
                        K3.msm_window_accum_plain, (table, digits),
                        table.numel() * 4 + digits.numel() * 4 + 64 * 128 * 4,
                        64 * (b - 1) * OPS_TREE_NODE, 20))
    record("msm_window_accum", "hotstuff_tpu_torch/ops/kern/csrc/msm_accum.cu",
           "hotstuff_tpu/ops/kern/msm_accum.py:75", *k3_args[0])
    rows[-1].update({f"qc256_{k}": v for k, v in
                     measure("msm_window_accum", *k3_args[1]).items()})
    # The shuffle bound: 64 (B - 1) tree nodes, each the fold kernel's
    # static shuffle count (one copy of the node: its merge loop is not
    # unrolled, and its leaf loop holds no shuffle).
    per_node = shuffles.get("msm_fold_kernel")
    for prefix, b in (("", 2048), ("qc256_", 256)):
        rows[-1][f"{prefix}shfl_bound_ms"] = (
            None if per_node is None else
            64 * (b - 1) * per_node / PEAK_WARP_SHUFFLES_PER_S * 1e3)
    print(f"msm_window_accum: {per_node} warp shuffles per tree node; "
          f"shuffle bound {rows[-1]['shfl_bound_ms']} ms at 2048 points, "
          f"{rows[-1]['qc256_shfl_bound_ms']} ms at 256", flush=True)

    # The point-chain kernels (K1 redesigned), at the shapes the verify
    # programs give them: a 1024-signature batch decompresses 2048
    # points, builds a 2048-point MSM table (RLC) or 1024 ladder tables
    # (per-signature), and runs the ladder and the comb at 1024 rows;
    # the RLC finish runs Horner and the comb at batch 1.
    chain_src = "hotstuff_tpu_torch/ops/kern/csrc/point_chain.cu"
    pt_bytes = 4 * 32 * 4

    # decompress at the paths' shapes: 2048 rows (a bulk batch of 1024, a
    # headline sub-batch), 256 (a QC of 67, bucket 128) and 16 (a
    # per-signature launch of 3-8 votes), each on real encodings, random
    # bytes (about half of them not on the curve) and the edge rows, with
    # its bound in operations and in warp shuffles: a warp runs four rows
    # (one a lane group), its loops pow_p58's 11 steps and, inside them,
    # the step's squarings (251 in all).
    def decompress_case(n):
        y_limbs, sign = decompress_inputs(rng, n, dev)
        args = ("decompress", f"({n}, 32)", PC.decompress,
                PC.decompress_plain, (y_limbs, sign),
                n * (32 * 4 + 4) + n * (pt_bytes + 1),
                n * OPS_DECOMPRESS_ROW, 20)
        depth = depths.get("decompress_groups_kernel")
        extra = {"shfl_bound_ms": None}
        if depth and len(depth) <= 3:
            per_warp = sum(k * t for k, t in zip(depth, (1, 11, 251)))
            extra = {"shuffles_per_warp": per_warp,
                     "shfl_bound_ms": (-(-n // 4) * per_warp
                                       / PEAK_WARP_SHUFFLES_PER_S * 1e3)}
        print(f"decompress ({n}, 32): {extra.get('shuffles_per_warp')} warp "
              f"shuffles a warp of four rows (cuobjdump by loop depth "
              f"{depth}), shuffle bound {extra['shfl_bound_ms']} ms",
              flush=True)
        return (y_limbs, sign), args, extra

    (y_limbs, sign), args, extra = decompress_case(2048)
    record(args[0], chain_src, rep1, *args[1:])
    rows[-1].update(extra)
    for n in (256, 16):
        _, args, extra = decompress_case(n)
        rows[-1].update({f"rows{n}_{k}": v for k, v in
                         dict(measure(*args), **extra).items()})
    pts, _ = PC.decompress(y_limbs, sign)
    pts = pts[:1792].contiguous()                # real points only

    # point_multiples at the paths' shapes (MULTIPLES_SHAPES), each on real
    # points, random weak limbs and the edge rows, beside its bound in
    # operations and in warp shuffles: one warp a row, its loop the 14
    # additions.  The cached form adds 14 to_cached: entry 1's is
    # to_cached(P), already counted, and entry 0's is the identity's, a
    # constant.  -P adds two negations.
    def multiples_case(n, cached, negate):
        form = ("cached, from -P" if negate else "cached") if cached else (
            "extended, from -P" if negate else "extended")
        ops = (OPS_MULTIPLES_ROW + (14 * OPS_TO_CACHED if cached else 0)
               + (2 * OPS_FIELD_SUB if negate else 0))
        args = ("point_multiples", f"({n}, 4, 32) {form}",
                PC.point_multiples, PC.point_multiples_plain,
                (multiples_inputs(rng, n, dev), cached, negate),
                n * pt_bytes * (1 + 16), n * ops, 20)
        depth = depths.get(f"point_multiples_kernel<{int(cached)}>")
        extra = {"shfl_bound_ms": None}
        if depth and len(depth) <= 2:
            per_row = sum(k * t for k, t in zip(depth, (1, 14)))
            extra = {"shuffles_per_row": per_row,
                     "shfl_bound_ms": (n * per_row
                                       / PEAK_WARP_SHUFFLES_PER_S * 1e3)}
        print(f"point_multiples ({n}, 4, 32) {form}: "
              f"{extra.get('shuffles_per_row')} warp shuffles a row "
              f"(cuobjdump by loop depth {depth}), shuffle bound "
              f"{extra['shfl_bound_ms']} ms", flush=True)
        return args, extra

    # The main row: the first shape, the RLC bulk's 2048 extended rows, as
    # in every slice before; the others under rows<n>_ keys.
    for i, (n, cached, negate) in enumerate(MULTIPLES_SHAPES):
        args, extra = multiples_case(n, cached, negate)
        if i == 0:
            record(args[0], chain_src, rep1, *args[1:])
            rows[-1].update(extra)
        else:
            rows[-1].update({f"rows{n}_{k}": v for k, v in
                             dict(measure(*args), **extra).items()})

    def ladder_case(label, table, digits, ndbl):
        """point_ladder at one shape, held exactly to its plain version
        and timed, beside the bounds.  The plain version (~1 s at ndbl 4)
        is timed once, by the call that the kernel is held to."""
        # Bytes: the table entries this run's digits select (each once),
        # the digits and the output.
        bt, j = table.shape[:2]
        rows_, steps = digits.shape
        r_idx = (torch.arange(rows_, device=dev) if bt != 1 else
                 torch.zeros(rows_, dtype=torch.long, device=dev))
        s_idx = (torch.arange(steps, device=dev) if j != 1 else
                 torch.zeros(steps, dtype=torch.long, device=dev))
        key = ((r_idx[:, None] * j + s_idx[None, :]) * table.shape[2]
               + digits.long())
        entries = int(torch.unique(key).numel())
        args = (table, digits, ndbl)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = PC.point_ladder_plain(*args)
        end.record()
        got = PC.point_ladder(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            fail(f"point_ladder {label} differs from its plain version "
                 f"(max abs err {err})")
        b_ms, b_by = bound_ms(
            entries * pt_bytes + digits.numel() * 4 + rows_ * pt_bytes,
            rows_ * ops_ladder_row(steps, ndbl))
        fn = lambda: PC.point_ladder(*args)  # noqa: E731
        out = dict(max_abs_err=err, ms=time_ms(fn, 10),
                   graph_ms=graph_ms(fn, 10), plain_ms=start.elapsed_time(end),
                   bound_ms=b_ms, bound_by=b_by, shfl_bound_ms=None)
        # One warp a row; its loops are the steps and, inside them, the
        # ndbl doublings of a step.
        depth = depths.get(f"point_ladder_kernel<{ndbl}>")
        if depth:
            per_warp = sum(n * t for n, t in zip(
                depth, (1, steps, steps * ndbl)))
            out["shuffles_per_warp"] = per_warp
            out["shfl_bound_ms"] = (rows_ * per_warp
                                    / PEAK_WARP_SHUFFLES_PER_S * 1e3)
        if rows_ <= 132:
            # Each row a chain of dependent steps on one warp: its
            # operations at one SM's rate.
            out["chain_bound_ms"] = (ops_ladder_row(steps, ndbl)
                                     / PEAK_SM_INT32_OPS_PER_S * 1e3)
        print(f"point_ladder {label}, table {tuple(table.shape)}, digits "
              f"{tuple(digits.shape)}: exact; {out['ms']:.6f} ms a call "
              f"from Python, {out['graph_ms']:.6f} ms in a CUDA graph; plain "
              f"{out['plain_ms']:.6f} ms, bound {b_ms:.6f} ms ({b_by}), "
              f"{out.get('shuffles_per_warp')} warp shuffles a warp, shuffle "
              f"bound {out['shfl_bound_ms']} ms, chain bound on one SM "
              f"{out.get('chain_bound_ms')} ms", flush=True)
        return out

    # The per-signature ladder at 1024 rows: cached tables of -A; the
    # comb at 1024 rows and at batch 1; Horner at batch 1; the
    # committee's 3 votes (below RLC_MIN_LAUNCH, the per-signature
    # program); a mesh shard of a 1024-signature batch over 8; and a
    # table whose limbs are all 511, the top of the weak form.
    b = 1024
    ltable = PC.point_multiples(pts[:b].contiguous(), cached=True,
                                negate=True).unsqueeze(1)
    k_digits = torch.from_numpy(
        rng.integers(0, 16, (b, 64)).astype(np.int32)).to(dev)
    comb = E.comb_table_on(dev).unsqueeze(0)
    s_digits = torch.from_numpy(
        rng.integers(0, 256, (b, 32)).astype(np.int32)).to(dev)
    main = ladder_case("ladder1024", ltable, k_digits, 4)
    rows.append(dict(name="point_ladder", route="cuda",
                     shape=f"table {tuple(ltable.shape)}, digits "
                           f"{tuple(k_digits.shape)}",
                     source=chain_src, replaces=rep1, library_ms=None,
                     **main))
    full = torch.full((3, 1, 16, 4, 32), 511, dtype=torch.int32, device=dev)
    for label, case in (
            ("comb1024", (comb, s_digits, 0)),
            ("comb1", (comb, s_digits[:1].contiguous(), 0)),
            ("horner1", (E.to_cached(pts[:64]).reshape(1, 64, 1, 4, 32),
                         torch.zeros((1, 64), dtype=torch.int32,
                                     device=dev), 4)),
            ("rows3", (ltable[:3].contiguous(), k_digits[:3].contiguous(),
                       4)),
            ("comb3", (comb, s_digits[:3].contiguous(), 0)),
            ("rows128", (ltable[:128].contiguous(),
                         k_digits[:128].contiguous(), 4)),
            ("comb128", (comb, s_digits[:128].contiguous(), 0)),
            ("all511", (full, k_digits[:3].contiguous(), 4)),
            ("all511_comb", (full, s_digits[:3, :16].contiguous() % 16,
                             0))):
        rows[-1].update({f"{label}_{k}": v for k, v in
                         ladder_case(label, *case).items()})
    return rows


def make_requests():
    """Keys, votes and transactions from a fixed seed: a 100-key
    committee, QCs of 67 votes over distinct block digests, and two bulk
    batches of 1024 transactions signed by 64 client keys."""
    import hashlib

    from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
    from hotstuff_tpu_torch.utils.intmath import L

    def seed(tag: str, i: int) -> bytes:
        return hashlib.sha256(f"chip-smoke/{tag}/{i}".encode()).digest()

    committee = [ref.generate_keypair(seed("replica", i)) for i in range(100)]
    clients = [ref.generate_keypair(seed("client", i)) for i in range(64)]

    def qc(block: int, voters: int = 67):
        digest = seed("block", block)
        return ([digest] * voters, [pk for _, pk in committee[:voters]],
                [ref.sign(sk, digest) for sk, _ in committee[:voters]])

    def bulk(batch: int):
        msgs = [seed(f"tx{batch}", j) for j in range(1024)]
        keys = [clients[j % len(clients)] for j in range(1024)]
        return (msgs, [pk for _, pk in keys],
                [ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)])

    def non_canonical_s(sig: bytes) -> bytes:
        s = int.from_bytes(sig[32:], "little") + L   # same value mod L
        return sig[:32] + s.to_bytes(32, "little")

    small_order_pk = (1).to_bytes(32, "little")      # the identity

    reqs = [(f"qc{b}", False, qc(b)) for b in range(5)]
    msgs, pks, sigs = qc(5)
    sigs[10] = ref.sign(committee[10][0], seed("forged", 0))  # wrong digest
    sigs[40] = non_canonical_s(sigs[40])
    reqs.append(("qc5 forged + non-canonical S", False, (msgs, pks, sigs)))
    msgs, pks, sigs = qc(6, voters=3)
    reqs.append(("3 votes", False, (msgs, pks, sigs)))
    for batch in range(2):
        msgs, pks, sigs = bulk(batch)
        sigs[100 + batch] = non_canonical_s(sigs[100 + batch])
        pks[700] = small_order_pk
        if batch == 0:
            sigs[512] = ref.sign(clients[0][0], seed("forged", 1))
        reqs.append((f"bulk{batch} of 1024", True, (msgs, pks, sigs)))
    return reqs


def sidecar_phase(dev, reqs, want):
    """Phase 5: the port's sidecar on the card, driven over its socket
    by the port's client.  The launch counts are zeroed before the
    sidecar boots and read after its warm-up (the probe and one small
    batch through each program), then zeroed again and read after the
    requests.  Returns (boot counts, request counts, counts of one
    request of each kind)."""
    from hotstuff_tpu_torch.ops import kern
    from hotstuff_tpu_torch.sidecar import service
    from hotstuff_tpu_torch.sidecar.client import SidecarClient

    kern.reset_launches()
    t0 = time.monotonic()
    engine = service.VerifyEngine(device=dev)
    server = None
    per_kind: dict = {}
    try:
        service.warmup(engine)
        boot = dict(kern.LAUNCHES)
        server = service.SidecarServer(("127.0.0.1", 0), engine)
        print(f"sidecar boot (probe, warm-up) on {engine.device}: "
              f"{time.monotonic() - t0:.3f} s, kernel launches {boot}",
              flush=True)
        thread = threading.Thread(target=server.serve_forever,
                                  kwargs={"poll_interval": 0.1},
                                  daemon=True)
        thread.start()
        with SidecarClient(port=server.server_address[1],
                           timeout=600.0) as client:
            t0 = time.monotonic()
            if not client.ping():
                fail("sidecar ping failed")
            print(f"ping: {(time.monotonic() - t0) * 1e3:.3f} ms", flush=True)
            kern.reset_launches()
            for (label, bulk, (msgs, pks, sigs)), expect in zip(reqs, want):
                before = dict(kern.LAUNCHES)
                paths_before = dict(engine._sched.stats.paths)
                t0 = time.monotonic()
                mask = client.verify_batch(msgs, pks, sigs, bulk=bulk)
                ms = (time.monotonic() - t0) * 1e3
                delta = {k: kern.LAUNCHES[k] - before[k] for k in before}
                paths = sorted(
                    p for p, n in engine._sched.stats.paths.items()
                    if n > paths_before.get(p, 0))
                kind = f"{len(msgs)} sigs, {'+'.join(paths)}"
                per_kind.setdefault(kind, delta)
                bad = [i for i, (g, w) in enumerate(zip(mask, expect))
                       if g != w]
                print(f"{label}: {len(msgs)} records, "
                      f"{len(msgs) - sum(expect)} invalid, {ms:.3f} ms, "
                      f"paths {paths}, kernel launches {delta}", flush=True)
                if bad:
                    fail(f"{label}: mask differs from the host reference "
                         f"at rows {bad[:10]}")
            launches = dict(kern.LAUNCHES)
            stats = client.stats()
        print(f"OP_STATS: {json.dumps(stats, sort_keys=True)}", flush=True)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        engine.stop()
    paths = stats.get("paths", {})
    for path in ("rlc", "rlc_bisect", "per_sig"):
        if not paths.get(path):
            fail(f"OP_STATS paths show no {path!r} launch: {paths}")
    if not boot["probe"]:
        fail("the sidecar's boot did not launch the probe kernel")
    for name, count in launches.items():
        if name not in OFF_PATH + BLS_KERNELS + BLS_OFF_PATH + MESH_ONLY \
                and count == 0:
            fail(f"kernel {name} was not launched by the requests")
    for name in BLS_KERNELS + BLS_OFF_PATH:
        if launches[name]:
            fail(f"the Ed25519 requests launched the BLS kernel {name}")
    if launches["scalar_mont_mul"]:
        fail("the requests launched K2 (scalar_mont_mul), whose work on "
             "the RLC path belongs to rlc_scalars and rlc_reduce")
    print(f"kernel launches at boot: {boot}; over the requests: "
          f"{launches}", flush=True)
    return boot, launches, per_kind


# Kernels the requests do not launch: the probe runs at the sidecar's
# boot, and K2's work on the RLC path runs inside rlc_scalars and
# rlc_reduce (K2 stays for scalar25519's other callers).
OFF_PATH = ("probe", "scalar_mont_mul")
# The shard's fold of Miller values runs only on a mesh (phase 11).
MESH_ONLY = ("fq12_product",)


def ops_by_caller(run) -> dict:
    """Run ``run()`` once and count the PyTorch operators it dispatches
    (views excluded: they launch nothing on the card), each under the
    innermost function of hotstuff_tpu_torch outside ops/kern that
    called it (a kernel module's plain helpers count under their
    caller), as "module.py:function"."""
    from torch.utils._python_dispatch import TorchDispatchMode

    root = os.path.join(REPO, "hotstuff_tpu_torch") + os.sep
    kern_dir = os.path.join(root, "ops", "kern") + os.sep
    counts: dict = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                f = sys._getframe(1)
                while f is not None and (
                        not f.f_code.co_filename.startswith(root)
                        or f.f_code.co_filename.startswith(kern_dir)):
                    f = f.f_back
                where = ("outside the package" if f is None else
                         f"{os.path.basename(f.f_code.co_filename)}:"
                         f"{f.f_code.co_name}")
                counts[where] = counts.get(where, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count():
        run()
    return counts


def profile_phase(dev, reqs, want) -> None:
    """Phase 6: where a request's time goes.  A valid QC (67 votes) and
    a 1024-signature bulk batch go straight through the RLC program, and
    the bulk batch also through the per-signature program (no socket, no
    verdict cache): the host wall time of three runs, each split into
    its stages (pack: host preparation and the copy to the card;
    dispatch: issuing the device program; fetch: waiting for the card
    and the copy back), then one run under torch.profiler, whose device
    events give the card's busy time and the kernels that fill it, and
    one run that counts the operators each function of the port
    dispatches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hotstuff_tpu_torch.crypto import eddsa

    cuda = torch.autograd.DeviceType.CUDA
    cases = (("QC of 67 votes, RLC", eddsa.verify_batch_rlc_pack, 0),
             ("bulk of 1024, RLC", eddsa.verify_batch_rlc_pack, -1),
             ("bulk of 1024, per-signature", eddsa.verify_batch_pack, -1))
    for label, pack, i in cases:
        msgs, pks, sigs = reqs[i][2]
        walls, stages = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            dispatch = pack(msgs, pks, sigs, device=dev)
            t1 = time.perf_counter()
            fetch = dispatch()
            t2 = time.perf_counter()
            mask = fetch()
            t3 = time.perf_counter()
            walls.append((t3 - t0) * 1e3)
            stages.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                           (t3 - t2) * 1e3))
            if mask.tolist() != want[i]:
                fail(f"profile {label}: mask differs from the host reference")
        order = sorted(range(3), key=walls.__getitem__)
        wall = walls[order[1]]
        pack_ms, dispatch_ms, fetch_ms = stages[order[1]]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pack(msgs, pks, sigs, device=dev)()()
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == cuda:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        busy_ms = sum(us for _, us in by_name.values()) / 1e3
        events = sum(n for n, _ in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        share = f"{busy_ms / wall:.4f}" if events else "not measured"
        print(f"profile {label}: wall {wall:.3f} ms (median of 3: "
              f"{', '.join(f'{w:.3f}' for w in walls)}; its pack "
              f"{pack_ms:.3f}, dispatch {dispatch_ms:.3f}, fetch "
              f"{fetch_ms:.3f}); device events {events}, device busy "
              f"{busy_ms:.3f} ms, busy share of wall {share}", flush=True)
        for name, (n, us) in top:
            print(f"  device {us / 1e3:.3f} ms in {n} events: {name[:90]}",
                  flush=True)
        ops = ops_by_caller(lambda: pack(msgs, pks, sigs, device=dev)()())
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        print(f"  operators dispatched: {sum(ops.values())}; by caller: "
              + ", ".join(f"{k} {n}" for k, n in top_ops), flush=True)
        scalar_ops = {k: n for k, n in ops.items()
                      if k.startswith("scalar25519.py")}
        if pack is eddsa.verify_batch_rlc_pack and scalar_ops:
            fail(f"profile {label}: the RLC program dispatched scalar25519 "
                 f"operators {scalar_ops}")


# ---------------------------------------------------------------------------
# Phase 7-8: the BLS12-381 path
# ---------------------------------------------------------------------------

# The kernels every pairing check launches, once each, and those it must
# not: the flat Fq12 chains and the hard part alone, held to their plain
# versions in phase 7 all the same.
BLS_KERNELS = ("miller_accumulate", "final_exp")
BLS_OFF_PATH = ("fq12_mul", "fq_pow", "fq12_pow", "fq12_hard_pow")
BLS_SOURCE = "hotstuff_tpu_torch/ops/kern/csrc/fq12_chain.cu"
TOWER_SOURCE = "hotstuff_tpu_torch/ops/kern/csrc/fq12_tower.cu"
# No TPU kernel: the JAX package runs the whole check as one XLA program.
BLS_REPLACES = "hotstuff_tpu/ops/bls381.py:217"
QC_LABEL = "QC of 67 votes"
TC_LABEL = "TC of 67 votes over 67 digests"


# The tower's pieces timed alone (phase 7): one Montgomery product of
# fq381w.cuh as one thread's dependent chain and split across a lane
# group of fq12_lanes.cuh (W words a lane, W = 2, 3, 4), each record of
# fq12w.cuh's bilinear step on one block of 160 threads, and the split
# step of fq12_lanes.cuh for the cyclotomic square and the Karatsuba
# product at each W (and W = 12: one product a thread, fqw::mont_mul) on
# the block such a kernel launches, each N times in a loop inside one
# launch, timed with CUDA events.  A program of its own on the kernels'
# headers, built by nvcc in phase 2 beside the kernel library.
TOWER_PROG_CAPACITY = 4096
TOWER_PIECES_SOURCE = r"""
#include <cstdio>
#include <vector>
#include <cuda_runtime.h>
#include "fq12_lanes.cuh"

__global__ void mont_loop(uint32_t* out, int n) {
  uint32_t a[12], b[12];
  for (int i = 0; i < 12; ++i) {
    a[i] = fqw::kOne[i] ^ threadIdx.x;
    b[i] = fqw::kOne[i] + i;
  }
  a[11] &= 0x0fffffff;
  b[11] &= 0x0fffffff;
  for (int r = 0; r < n; ++r) fqw::mont_mul(a, b, a);
  for (int i = 0; i < 12; ++i) out[threadIdx.x * 12 + i] = a[i];
}

template <int W>
__global__ void split_loop(uint32_t* out, int n) {
  constexpr int G = tl::Split<W>::kGroup, L = tl::Split<W>::kLanes;
  const int l = static_cast<int>(threadIdx.x) % G;
  uint32_t a[1][W], b[1][W];
  for (int w = 0; w < W; ++w) {
    a[0][w] = l < L ? fqw::kOne[W * l + w] ^ (threadIdx.x / G) : 0u;
    b[0][w] = l < L ? fqw::kOne[W * l + w] + w : 0u;
  }
  if (l == L - 1) {
    a[0][W - 1] &= 0x0fffffff;
    b[0][W - 1] &= 0x0fffffff;
  }
  const tl::Group<G> g{l, (static_cast<int>(threadIdx.x) & 31) & ~(G - 1)};
  for (int r = 0; r < n; ++r) tl::mont_split<W>(g, a, b, a);
  for (int w = 0; w < W; ++w) out[threadIdx.x * W + w] = a[0][w];
}

__global__ void inv_loop(uint32_t* out, int n) {
  uint32_t a[12], one[12];
  for (int i = 0; i < 12; ++i) {
    one[i] = fqw::kOne[i];
    a[i] = fqw::kOne[i] ^ (0x9e3779b9u * (i + 1));
  }
  a[11] &= 0x0fffffff;
  for (int r = 0; r < n; ++r) {
    fqw::inv_mont(a, a);
    fqw::add_mod(a, one, a);
  }
  for (int i = 0; i < 12; ++i) out[i] = a[i];
}

template <int Op>
__global__ void bilinear_loop(const int* prog, int len, int n,
                              uint32_t* out) {
  __shared__ __align__(16) uint32_t x[144], y[144], w[tw::kScratchWords];
  __shared__ uint64_t cols[144];
  __shared__ int sp[TOWER_PROG_CAPACITY];
  tw::tasks(len, [&](int i) { sp[i] = prog[i]; });
  const tw::Scratch s = tw::make_scratch(w, cols);
  tw::tasks(144, [&](int i) {
    x[i] = fqw::kOne[i % 12] >> (i % 3);
    y[i] = fqw::kOne[i % 12] >> (i % 5);
  });
  for (int r = 0; r < n; ++r) tw::bilinear<Op>(sp, x, y, x, s);
  tw::tasks(144, [&](int i) { out[i] = x[i]; });
}

// The split step: a square (y = x) for kCyc, a product for kMul.
template <int Op, int W, int WO>
__global__ void step_loop(const int* prog, int len, int n, uint32_t* out) {
  __shared__ __align__(16) uint32_t x[144], y[144],
      prod[tw::kMaxProducts * 12];
  __shared__ int sp[TOWER_PROG_CAPACITY];
  tw::tasks(len, [&](int i) { sp[i] = prog[i]; });
  tw::tasks(144, [&](int i) {
    x[i] = fqw::kOne[i % 12] >> (i % 3);
    y[i] = fqw::kOne[i % 12] >> (i % 5);
  });
  for (int r = 0; r < n; ++r) {
    tl::step<Op, W, WO>(sp, x, Op == tw::kCyc ? x : y, x, prod);
  }
  tw::tasks(144, [&](int i) { out[i] = x[i]; });
}

static int* dprog;
static uint32_t* dout;
static int len;
static const int n = 400;

// The cyclotomic split step's stages alone, at the kernels' W and block:
// 0 the operands (both formed in every lane of each product's group), 1
// the operands and the products, 2 the outputs, 3 the two barriers.
template <int Stage, int W, int WO>
__global__ void stage_loop(const int* prog, int len, int n, uint32_t* out) {
  using S = tw::Shape<tw::kCyc>;
  constexpr int G = tl::Split<W>::kGroup;
  constexpr int GO = tl::Split<WO>::kGroup;
  __shared__ __align__(16) uint32_t x[144], prod[tw::kMaxProducts * 12];
  __shared__ int sp[TOWER_PROG_CAPACITY];
  tw::tasks(len, [&](int i) { sp[i] = prog[i]; });
  tw::tasks(144, [&](int i) { x[i] = fqw::kOne[i % 12] >> (i % 3); });
  const int* fa = tw::op_record(sp, tw::kCyc);
  const int* fb = fa + S::k * S::la;
  const int* fo = fb + S::k * S::lb;
  const int* fi = fo + 12 * S::lo;
  for (int r = 0; r < n; ++r) {
    tl::groups<G>(S::k, [&](const tl::Group<G>& g, int k, bool keep) {
      if (Stage > 1) return;
      uint32_t a[1][W], b[1][W], p[1][W];
      tl::operand<S::la, W, true>(g, fa + k * S::la, x, a);
      tl::operand<S::lb, W, true>(g, fb + k * S::lb, x, b);
      if (Stage == 1) {
        tl::mont_split<W>(g, a, b, p);
      } else {
        for (int w = 0; w < W; ++w) p[0][w] = a[0][w] ^ b[0][w];
      }
      if (keep) tl::store<W>(g, p, prod + k * 12);
    });
    tl::groups<GO>(12, [&](const tl::Group<GO>& g, int j, bool keep) {
      if (Stage != 2) return;
      uint32_t o[1][WO];
      tl::output<S::lo, S::li, WO>(g, fo + j * S::lo, fi + j * S::li,
                                   prod, x, o);
      if (keep) tl::store<WO>(g, o, x + j * 12);
    });
  }
  tw::tasks(144, [&](int i) { out[i] = x[i] ^ prod[i]; });
}

template <int Stage, int W, int WO>
static void stage_launch() {
  stage_loop<Stage, W, WO><<<1, tl::kThreads>>>(dprog, len, n, dout);
}

static float time_launch(void (*launch)(), cudaEvent_t s, cudaEvent_t e) {
  float ms;
  launch();
  cudaEventRecord(s);
  launch();
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  cudaEventElapsedTime(&ms, s, e);
  return ms;
}


template <int W>
static void split_launch() { split_loop<W><<<1, 32>>>(dout, n); }

template <int Op, int W, int WO>
static void step_launch() {
  // The block of a kernel on this split: 54 products' groups, whole warps.
  constexpr int threads =
      (tw::kMaxProducts * tl::Split<W>::kGroup + 31) / 32 * 32;
  step_loop<Op, W, WO><<<1, threads < 224 ? 224 : threads>>>(dprog, len, n,
                                                             dout);
}

int main(int argc, char** argv) {
  std::vector<int> prog;
  for (int i = 1; i < argc; ++i) prog.push_back(atoi(argv[i]));
  len = static_cast<int>(prog.size());
  cudaMalloc(&dprog, prog.size() * 4);
  cudaMemcpy(dprog, prog.data(), prog.size() * 4, cudaMemcpyHostToDevice);
  cudaMalloc(&dout, 1 << 16);
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  float ms;
  mont_loop<<<1, 64>>>(dout, n);
  cudaEventRecord(s);
  mont_loop<<<1, 64>>>(dout, n);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  cudaEventElapsedTime(&ms, s, e);
  printf("mont_mul (one thread's chain): %.6f us\n", ms * 1e3 / n);
  printf("mont_split W=2 (8 lanes): %.6f us\n",
         time_launch(split_launch<2>, s, e) * 1e3 / n);
  printf("mont_split W=3 (4 lanes): %.6f us\n",
         time_launch(split_launch<3>, s, e) * 1e3 / n);
  printf("mont_split W=4 (4 lanes): %.6f us\n",
         time_launch(split_launch<4>, s, e) * 1e3 / n);
  const int n_inv = 100;
  inv_loop<<<1, 1>>>(dout, n_inv);
  cudaEventRecord(s);
  inv_loop<<<1, 1>>>(dout, n_inv);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  cudaEventElapsedTime(&ms, s, e);
  printf("inv_mont (one thread, binary extended Euclid): %.6f us\n",
         ms * 1e3 / n_inv);
  void (*loops[7])(const int*, int, int, uint32_t*) = {
      bilinear_loop<0>, bilinear_loop<1>, bilinear_loop<2>, bilinear_loop<3>,
      bilinear_loop<4>, bilinear_loop<5>, bilinear_loop<6>};
  const char* names[7] = {"mul", "sqr", "line", "frob1", "frob2",
                          "inv6_abc", "inv6_norm"};
  for (int op = 0; op < 7; ++op) {
    loops[op]<<<1, 160>>>(dprog, len, n, dout);
    cudaEventRecord(s);
    loops[op]<<<1, 160>>>(dprog, len, n, dout);
    cudaEventRecord(e);
    cudaEventSynchronize(e);
    cudaEventElapsedTime(&ms, s, e);
    printf("bilinear %s: %.6f us\n", names[op], ms * 1e3 / n);
  }
  struct { const char* name; void (*launch)(); } steps[] = {
      {"split step cyc W=2", step_launch<tw::kCyc, 2, 2>},
      {"split step cyc W=3", step_launch<tw::kCyc, 3, 3>},
      {"split step cyc W=4", step_launch<tw::kCyc, 4, 4>},
      {"split step cyc W=12 (one product a thread)",
       step_launch<tw::kCyc, 12, 12>},
      {"split step cyc W=3, outputs W=1", step_launch<tw::kCyc, 3, 1>},
      {"split step cyc W=3, outputs W=2", step_launch<tw::kCyc, 3, 2>},
      {"split step cyc W=2, outputs W=1", step_launch<tw::kCyc, 2, 1>},
      {"split step cyc W=2, outputs W=3", step_launch<tw::kCyc, 2, 3>},
      {"split step mul W=2", step_launch<tw::kMul, 2, 2>},
      {"split step mul W=3", step_launch<tw::kMul, 3, 3>},
      {"split step mul W=4", step_launch<tw::kMul, 4, 4>},
      {"split step mul W=12 (one product a thread)",
       step_launch<tw::kMul, 12, 12>},
      {"split step mul W=3, outputs W=1", step_launch<tw::kMul, 3, 1>},
      {"split step mul W=3, outputs W=2", step_launch<tw::kMul, 3, 2>},
      {"split step cyc W=3, operands alone", stage_launch<0, 3, 3>},
      {"split step cyc W=3, operands and products", stage_launch<1, 3, 3>},
      {"split step cyc W=2, operands and products", stage_launch<1, 2, 2>},
      {"split step cyc, outputs alone W=1", stage_launch<2, 3, 1>},
      {"split step cyc, outputs alone W=2", stage_launch<2, 3, 2>},
      {"split step cyc, outputs alone W=3", stage_launch<2, 3, 3>},
      {"split step cyc, outputs alone W=12", stage_launch<2, 3, 12>},
      {"split step cyc, the two barriers alone", stage_launch<3, 3, 3>}};
  for (const auto& st : steps) {
    printf("%s: %.6f us\n", st.name, time_launch(st.launch, s, e) * 1e3 / n);
  }
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    printf("CUDA error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
"""


def start_tower_pieces_build():
    """Start nvcc on the tower pieces' program; returns (process, path
    of the executable).  The process is killed at exit if still running."""
    import atexit

    from hotstuff_tpu_torch.ops.kern import build

    work = build.BUILD_ROOT / "tower_pieces"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "tower_pieces.cu"
    src.write_text(TOWER_PIECES_SOURCE)
    exe = work / "tower_pieces"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    proc = subprocess.Popen(
        [build.nvcc(), *flags, f"-DTOWER_PROG_CAPACITY={TOWER_PROG_CAPACITY}",
         f"-I{build.CSRC}", str(src), "-o", str(exe)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, exe


def tower_pieces_phase(proc, exe) -> dict:
    """Phase 7: run the tower pieces' program; returns us per piece."""
    from hotstuff_tpu_torch.ops.kern import fq12_tower as FT

    out, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        fail(f"nvcc failed on the tower pieces' program:\n{out}")
    if FT.PROGRAM.size > TOWER_PROG_CAPACITY:
        fail(f"the tower table ({FT.PROGRAM.size} ints) exceeds "
             f"{TOWER_PROG_CAPACITY}")
    run = subprocess.run([str(exe), *map(str, FT.PROGRAM.tolist())],
                         capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        fail(f"the tower pieces' program failed:\n{run.stdout}{run.stderr}")
    times = {}
    for line in run.stdout.splitlines():
        name, us = line.rsplit(":", 1)
        times[name] = float(us.split()[0])
        print(f"tower piece, {line}", flush=True)
    return times


def ops_bilinear(op) -> int:
    """int32 operations of one tower product (fq12w.cuh bilinear) from
    its matrices: per Fq product, two operand sums and the Montgomery
    product; per output, its sum and one reduce13."""
    import numpy as np

    ops = 0
    for m in (op.ma, op.mb):
        ops += (int((m != 0).sum()) * OPS_W_TERM
                + int((m < 0).sum()) * OPS_W_NEG
                + m.shape[0] * OPS_W_CARRY)
    ops += op.products * (OPS_W_MONT + OPS_W_NEG)
    ops += int(np.count_nonzero(op.mc)) * OPS_W_TERM + 12 * (
        OPS_W_CARRY + OPS_W_REDUCE)
    return ops


# A negated term on fq12_lanes.cuh's split step: one XOR a word (~v).
OPS_W_FLIP = 12


def ops_lane_step(op) -> int:
    """int32 operations of one split step (fq12_lanes.cuh step) from the
    record's matrices: per operand its terms (a column add a word, an
    XOR a word for a negated one, the (q + 1) bias where any is
    negated) and its carries; per product one Montgomery product; per
    output its terms over the products and the input, the bias, its
    carries and one reduce13."""
    import numpy as np

    ops = op.products * OPS_W_MONT
    for m, per_form in ((op.ma, True), (op.mb, True), (op.mc, False),
                        (op.mx, False)):
        ops += (int((m != 0).sum()) * OPS_W_TERM
                + int((m < 0).sum()) * OPS_W_FLIP
                + int((m < 0).any(1).sum()) * OPS_W_TERM)
        if per_form:
            ops += m.shape[0] * OPS_W_CARRY
    return ops + 12 * (OPS_W_CARRY + OPS_W_REDUCE)


def ops_tower_pow(digits, width, sq: int, mul: int) -> int:
    """pow_digits: the table's 2^width - 2 products, width squarings
    per later digit, one product per later nonzero digit."""
    later = digits[1:]
    return (((1 << width) - 2 + sum(1 for d in later if d)) * mul
            + width * len(later) * sq)


def ops_hard_pow(lanes: bool = True) -> int:
    """fq12_hard_pow on one row: the x-chain, counted on the kernel's
    algorithm (fq12_lanes.cuh: cyclotomic squares and Karatsuba products
    on the split step, the Frobenius maps on fq12w.cuh's), or with
    ``lanes`` false on the complex-square chain (complex squares and
    products on fq12w.cuh's step), the count of the rows before."""
    from hotstuff_tpu_torch.ops.kern import fq12_tower as FT

    if lanes:
        sq, mul = ops_lane_step(FT.OPS["cyc"]), ops_lane_step(FT.OPS["mul"])
    else:
        sq, mul = ops_bilinear(FT.OPS["sqr"]), ops_bilinear(FT.OPS["mul"])
    conj = 6 * OPS_W_NEG
    return (ops_tower_pow(FT.E1_DIGITS, FT.E1_WIDTH, sq, mul)
            + 3 * ops_tower_pow(FT.X_DIGITS, 1, sq, mul)
            + ops_bilinear(FT.OPS["frob1"]) + ops_bilinear(FT.OPS["frob2"])
            + 4 * mul + 2 * conj
            + 24 * OPS_W_CONVERT)


# The binary extended Euclid of fqw::inv_int, per step: a halving is a
# parity test, a 12-word shift (two shifts and an or a word) of u or v,
# and the same of x + q or x with its select; a subtraction is a borrow
# chain, the copy, and sub_mod (a borrow chain, a carry chain and a
# select); each round tests u and v against one.
OPS_W_SHR1 = 12 * 3
OPS_W_HALF = 1 + 2 * OPS_W_SHR1 + 12 * 3 + 12
OPS_W_SUB_MOD = 2 * 12 * 3 + 12
OPS_W_SUB_STEP = 12 * 3 + 12 + OPS_W_SUB_MOD
OPS_W_ROUND = 2 * 12 * 2


def euclid_steps(x: int) -> tuple:
    """fqw::inv_int on the integer x in [0, q): (halvings, subtractions,
    rounds), the steps this value takes (the algorithm's time depends on
    it)."""
    from hotstuff_tpu_torch.ops import field381 as F381

    if x == 0:
        return 0, 0, 0
    u, v, halvings, subs, rounds = x, F381.Q, 0, 0, 0
    while u != 1 and v != 1:
        rounds += 1
        while u % 2 == 0:
            u, halvings = u // 2, halvings + 1
        while v % 2 == 0:
            v, halvings = v // 2, halvings + 1
        if u >= v:
            u -= v
        else:
            v -= u
        subs += 1
    return halvings, subs, rounds


def final_exp_norm(fs) -> int:
    """The Fq value whose inverse final_exp takes for one row of (1, P,
    12, 48) Miller values: the Fq2 norm F of f conj(f) down the tower, and
    F0^2 + F1^2 as fqw::fq2_inv forms it (two Montgomery products of the
    words, so (F0^2 + F1^2) / R mod q), from the kernel's plain pieces."""
    from hotstuff_tpu_torch.ops import field381 as F381
    from hotstuff_tpu_torch.ops.kern import fq12_tower as FT

    t = FT.flat_to_tower_plain(fs[0])
    f = t[0]
    for i in range(1, t.shape[0]):
        f = FT.bilinear_plain("mul", f, t[i])
    n = FT.bilinear_plain("mul", f, FT.conj_plain(f))
    norm = FT.bilinear_plain("inv6_norm", n,
                             FT.bilinear_plain("inv6_abc", n, n))
    f0, f1 = (F381.from_limbs(r) for r in norm[:2].cpu().numpy())
    return (f0 * f0 + f1 * f1) * pow(F381.R, -1, F381.Q) % F381.Q


def ops_final_exp(fs, lanes: bool = True) -> int:
    """final_exp on one row of (1, P, 12, 48) Miller values (fq12_lanes.cuh
    final_exp_row), counted on its algorithm and this row's data: the P
    inputs' conversions, P - 1 products, the conjugation, the tower
    inverse (three products, the two Fq6-inverse records, fq2_inv: four
    Montgomery products, an add, the Euclid's steps on this row's norm,
    one product by R^3, a negation), the easy part's two products and
    q^2 Frobenius map, the hard part's chain (as ops_hard_pow counts it
    with ``lanes``) and the output's conversion.  The product stage and
    the easy part's two products run on the split step, the tower
    inverse on fq12w.cuh's; with ``lanes`` false, all on fq12w.cuh's
    (the complex-square chain)."""
    from hotstuff_tpu_torch.ops.kern import fq12_tower as FT

    p = fs.shape[1]
    old = ops_bilinear(FT.OPS["mul"])
    mul = ops_lane_step(FT.OPS["mul"]) if lanes else old
    halvings, subs, rounds = euclid_steps(final_exp_norm(fs))
    fq2_inv = (5 * OPS_W_MONT + 2 * 12 * 3 + 12 + OPS_W_SUB_MOD
               + halvings * OPS_W_HALF + subs * OPS_W_SUB_STEP
               + rounds * OPS_W_ROUND)
    return (12 * p * OPS_W_CONVERT + (p + 1) * mul + 6 * OPS_W_NEG
            + 3 * old + ops_bilinear(FT.OPS["inv6_abc"])
            + ops_bilinear(FT.OPS["inv6_norm"]) + fq2_inv
            + ops_bilinear(FT.OPS["frob2"])
            + ops_hard_pow(lanes) - 12 * OPS_W_CONVERT)


def ops_miller_rows(lines) -> tuple:
    """miller_accumulate on these lines: (operations of all rows, of the
    heaviest row), counted on the branches the data take (a line equal
    to one skipped, a sparse one by the 42-product record, any other by
    the 54-product one), with every line's conversion to the tower."""
    from hotstuff_tpu_torch.ops.kern import fq12_tower as FT

    rows, steps = lines.shape[:2]
    one, sparse = FT.line_branches(FT.flat_to_tower_plain(lines))
    n_sparse = (~one & sparse).sum(dim=(1, 2))
    n_dense = (~one & ~sparse).sum(dim=(1, 2))
    per_row = (steps * ops_bilinear(FT.OPS["sqr"])
               + n_sparse * ops_bilinear(FT.OPS["line"])
               + n_dense * ops_bilinear(FT.OPS["mul"])
               + (2 * steps + 1) * 12 * OPS_W_CONVERT)
    return int(per_row.sum()), int(per_row.max())


def bls_kernel_phase(dev, rng):
    """Phase 7, first half: each Fq12 kernel beside its plain version at
    the BLS path's shapes, exact.  The plain versions are thousands of
    operators (seconds on the card), so each is timed once, by the call
    that the kernel is compared with."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.offchain import bls12381 as bls
    from hotstuff_tpu_torch.ops import bls381 as B
    from hotstuff_tpu_torch.ops import field381 as F381
    from hotstuff_tpu_torch.ops.kern import fq12_chain as FC
    from hotstuff_tpu_torch.ops.kern import fq12_tower as FT

    rows = []

    def fq12(n):
        return torch.from_numpy(np.stack([B.host_fq12_to_mont_limbs(
            [int.from_bytes(rng.bytes(48), "little") % F381.Q
             for _ in range(12)]) for _ in range(n)])).to(dev)

    def measure(name, shape, kernel, plain, args, nbytes, ops, chain_ops,
                iters):
        got = kernel(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*args)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        err = max_abs_err(got, want)
        if err != 0:
            fail(f"{name} at {shape} differs from its plain version "
                 f"(max abs err {err})")
        ms = time_ms(lambda: kernel(*args), iters)
        dev_ms = graph_ms(lambda: kernel(*args), iters)
        b_ms, b_by = bound_ms(nbytes, ops)
        chain_ms = chain_ops / PEAK_SM_INT32_OPS_PER_S * 1e3
        print(f"{name} {shape}: exact; kernel {ms:.6f} ms a call from "
              f"Python, {dev_ms:.6f} ms a launch in a CUDA graph; plain "
              f"{plain_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}), chain "
              f"bound on one SM {chain_ms:.6f} ms", flush=True)
        return dict(max_abs_err=err, ms=ms, graph_ms=dev_ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    chain_bound_ms=chain_ms)

    def record(name, source, shape, *args):
        rows.append(dict(name=name, route="cuda", shape=shape,
                         source=source, replaces=BLS_REPLACES,
                         library_ms=None, **measure(name, shape, *args)))

    # fq12_mul at 68 rows and at batch 1: bls381.fq12_mul, off the check's
    # path since final_exp took the Miller products, fq12_inv's and the
    # easy part's; held to its plain version at the shapes it had there.
    for n in (68, 1):
        x, y = fq12(n), fq12(n)
        args = (f"({n}, 12, 48)", FC.fq12_mul, FC.fq12_mul_plain, (x, y),
                3 * n * FQ12_BYTES, n * OPS_FQ12_MUL, OPS_FQ12_MUL, 50)
        if n == 68:
            record("fq12_mul", BLS_SOURCE, *args)
        else:
            rows[-1].update({f"batch1_{k}": v for k, v in
                             measure("fq12_mul", *args).items()})

    # miller_accumulate (the word tower) at the QC's 2 pairings and the
    # TC's 68: real Miller lines (three (pk, H(m)) rows and the (-g1,
    # signature) row, tiled to 68).
    keys = [bls.key_gen(bytes([200, i]) * 16) for i in range(3)]
    msgs = [bytes([i]) * 32 for i in range(3)]
    sig = bls.aggregate([bls.sign(sk, m) for (sk, _), m in zip(keys, msgs)])
    real = B.multi_pairing_rows([pk for _, pk in keys], msgs, sig)
    lines4 = torch.from_numpy(np.stack(real)).to(dev)
    steps = lines4.shape[1]
    prog_bytes = FT.PROGRAM.size * 4
    for n in (2, 68):
        lines = lines4.repeat(n // 4 + 1, 1, 1, 1, 1)[-n:].contiguous()
        ops, chain = ops_miller_rows(lines)
        args = (f"({n}, {steps}, 2, 12, 48)", FT.miller_accumulate,
                FT.miller_accumulate_plain, (lines,),
                lines.numel() * 4 + n * FQ12_BYTES + prog_bytes,
                ops, chain, 10)
        if n == 2:
            record("miller_accumulate", TOWER_SOURCE, *args)
        else:
            rows[-1].update({f"tc68_{k}": v for k, v in
                             measure("miller_accumulate", *args).items()})
    # Its other two branches: a dense random line (row 0, a slot that
    # holds one on real lines) and a row of lines all equal to one.
    lines = lines4[:2].clone()
    lines[0, 9, 1] = fq12(1)[0]
    lines[1] = B.fq12_one((steps, 2), dev)
    before = dict(FT.BRANCHES)
    err = max_abs_err(FT.miller_accumulate(lines),
                      FT.miller_accumulate_plain(lines))
    taken = {k: FT.BRANCHES[k] - before[k] for k in before}
    if err != 0 or not taken["dense"] or not taken["skip"]:
        fail(f"miller_accumulate on a dense line and a row of ones: max "
             f"abs err {err}, branches {taken}")
    print(f"miller_accumulate on a dense line and a row of lines equal to "
          f"one: exact; branches of the plain version {taken}", flush=True)

    # fq12_hard_pow at batch 1 (the check's shape) on an easy-part output
    # f^((q^6 - 1)(q^2 + 1)), its domain (the cyclotomic subgroup), on
    # final_exp's chain (fq12_lanes.cuh).
    f = fq12(1)
    f1 = B.fq12_mul(B.fq12_frobenius(f, 6), B.fq12_inv(f))
    f2 = B.fq12_mul(B.fq12_frobenius(f1, 2), f1).contiguous()
    hard = ops_hard_pow()
    record("fq12_hard_pow", TOWER_SOURCE,
           "(1, 12, 48), an easy-part output", FT.fq12_hard_pow,
           FT.fq12_hard_pow_plain, (f2,),
           2 * FQ12_BYTES + prog_bytes + 24 * 48
           + 4 * (len(FT.E1_DIGITS) + len(FT.X_DIGITS)),
           hard, hard, 10)
    old = ops_hard_pow(lanes=False)
    rows[-1]["complex_square_bound_ms"] = old / PEAK_INT32_OPS_PER_S * 1e3
    rows[-1]["complex_square_chain_bound_ms"] = (
        old / PEAK_SM_INT32_OPS_PER_S * 1e3)
    print(f"fq12_hard_pow counted on the complex-square chain "
          f"(fq12w.cuh's step): bound "
          f"{rows[-1]['complex_square_bound_ms']:.6f} ms, chain bound on "
          f"one SM {rows[-1]['complex_square_chain_bound_ms']:.6f} ms",
          flush=True)

    # final_exp, the check's second launch, on real Miller values (the
    # lines' miller_accumulate): the QC's P = 2 (a statement that does
    # not hold: verdict false), the mesh lead's P = 4 (phase 11's four
    # shards: the valid 4-pairing statement) and 8 (the bench's eight:
    # it twice), the TC's P = 68 (17 copies: true); bounds counted on its
    # algorithm and this data (the binary Euclid's steps on each row's
    # norm); beside them, the count on the complex-square chain.
    consts_bytes = 24 * 48 + 4 * (len(FT.E1_DIGITS) + len(FT.X_DIGITS))
    for n, verdict in ((2, False), (4, True), (8, True), (68, True)):
        lines = lines4.repeat(n // 4 + 1, 1, 1, 1, 1)[-n:].contiguous()
        fs = FT.miller_accumulate(lines)[None].contiguous()
        ops = ops_final_exp(fs)
        nbytes = (n + 1) * FQ12_BYTES + 4 + prog_bytes + consts_bytes
        args = (f"(1, {n}, 12, 48), real Miller values", FT.final_exp,
                FT.final_exp_plain, (fs,), nbytes, ops, ops, 10)
        pre = "" if n == 2 else "tc68_" if n == 68 else f"p{n}_"
        if n == 2:
            record("final_exp", TOWER_SOURCE, *args)
        else:
            rows[-1].update({f"{pre}{k}": v for k, v in
                             measure("final_exp", *args).items()})
        old = ops_final_exp(fs, lanes=False)
        row = rows[-1]
        row[f"{pre}complex_square_bound_ms"] = bound_ms(nbytes, old)[0]
        row[f"{pre}complex_square_chain_bound_ms"] = (
            old / PEAK_SM_INT32_OPS_PER_S * 1e3)
        print(f"final_exp (1, {n}, 12, 48) counted on the complex-square "
              f"chain: bound "
              f"{row[f'{pre}complex_square_bound_ms']:.6f} ms, chain bound "
              f"on one SM "
              f"{row[f'{pre}complex_square_chain_bound_ms']:.6f} ms",
              flush=True)
        if bool(FT.final_exp(fs)[0]) != verdict:
            fail(f"final_exp at P = {n}: verdict is not {verdict}")
    # A product equal to one (x, x^-1), the product whose norm in the
    # reference's flat fq12_inv has a top limb of 224 or more (rows 0 and
    # 8 of seed 60, as tests/test_torch_final_exp.py), a zero value, and
    # a seeded generic Fq12 (not a Miller value).
    seed60 = np.random.default_rng(60)
    high = torch.from_numpy(np.stack([B.host_fq12_to_mont_limbs(
        [int.from_bytes(seed60.bytes(48), "little") % F381.Q
         for _ in range(12)]) for _ in range(16)])[[0, 8]]).to(dev)
    f = B.fq12_mul(high[:1], high[1:])
    g = B.fq12_frobenius(f, 1)
    for k in range(2, 12):
        g = B.fq12_mul(g, B.fq12_frobenius(f, k))
    if int(B.fq12_mul(f, g)[0, 0, -1]) < FC.STABLE_TOP:
        fail("the high-norm product's norm is below STABLE_TOP")
    x = fq12(1)
    cases = {"a product equal to one": (torch.cat([x, B.fq12_inv(x)]), True),
             "the norm top limb >= 224 product": (high, False),
             "a zero value": (torch.cat([torch.zeros_like(x), x]), False),
             "a generic Fq12": (fq12(1), False)}
    for label, (fs, verdict) in cases.items():
        fs = fs[None].contiguous()
        got, want = FT.final_exp(fs), FT.final_exp_plain(fs)
        err = max_abs_err(got, want)
        if err != 0 or bool(got[0]) != verdict:
            fail(f"final_exp on {label}: max abs err {err}, verdict "
                 f"{bool(got[0])}, expected {verdict}")
        print(f"final_exp on {label}: exact, verdict {verdict}", flush=True)

    # fq12_pow with the hard exponent at batch 1: off the check's path
    # since fq12_hard_pow took the hard part; kept as the "before" row.
    e = B._HARD_EXP
    nd = len(F381.exponent_digits(e))
    chain = (14 + 5 * nd) * OPS_FQ12_MUL
    record("fq12_pow", BLS_SOURCE, "(1, 12, 48), e = (q^4 - q^2 + 1) / r",
           FC.fq12_pow, FC.fq12_pow_plain, (fq12(1), e),
           2 * FQ12_BYTES + nd * 4, chain, chain, 5)

    # fq_pow with q - 2 at batch 1 (bls381.fq12_inv's one Fq inversion,
    # off the check's path since final_exp took the inverse), and a row
    # whose top limb takes the reduction to the stable range first.
    e = F381.Q - 2
    nd = len(F381.exponent_digits(e))
    chain = (14 + 5 * nd) * OPS_MONT_381
    x = fq12(1)[:, 0].contiguous()
    record("fq_pow", BLS_SOURCE, "(1, 48), e = q - 2", FC.fq_pow,
           FC.fq_pow_plain, (x, e), 2 * 48 * 4 + nd * 4, chain, chain, 20)
    high = x.repeat(2, 1)
    high[1, -1] = FC.STABLE_TOP + 100
    err = max_abs_err(FC.fq_pow(high, e), FC.fq_pow_plain(high, e))
    if err != 0:
        fail(f"fq_pow on a row above STABLE_TOP differs from its plain "
             f"version (max abs err {err})")
    print("fq_pow with a top limb above STABLE_TOP: exact", flush=True)
    return rows


def make_bls_requests():
    """A 100-key BLS committee from a fixed seed; a QC of 67 votes over
    one digest and a TC of 67 votes over 67 distinct digests.  Returns
    (requests, expected results): each request is (label, client method
    name, arguments), each result a verdict or the signature's bytes."""
    import hashlib

    from hotstuff_tpu_torch.offchain import bls12381 as bls

    def seed(tag: str, i: int) -> bytes:
        return hashlib.sha256(f"chip-smoke/{tag}/{i}".encode()).digest()

    committee = [bls.key_gen(seed("bls-replica", i)) for i in range(100)]
    voters = committee[:67]
    pks = [pk for _, pk in voters]
    pk_enc = [bls.g1_encode(pk) for pk in pks]
    digest = seed("bls-block", 0)
    sigs = [bls.sign(sk, digest) for sk, _ in voters]
    sig_enc = [bls.g2_encode(s) for s in sigs]
    agg = bls.aggregate(sigs)
    qc_ok = bls.verify_aggregate_common(pks, digest, agg)

    forged = list(sig_enc)
    forged_sig = bls.sign(voters[1][0], seed("bls-forged", 0))
    forged[1] = bls.g2_encode(forged_sig)
    forged_ok = bls.verify_aggregate_common(
        pks, digest, bls.aggregate(sigs[:1] + [forged_sig] + sigs[2:]))

    junk = list(sig_enc)
    junk[2] = b"\x01" * 192                    # not a point of the curve
    try:
        bls.g2_decode_lax(junk[2])
        fail("the malformed signature decodes")
    except ValueError:
        pass

    tc_msgs = [seed("bls-round", i) for i in range(67)]
    tc_sigs = [bls.sign(sk, m) for (sk, _), m in zip(voters, tc_msgs)]
    tc_agg = bls.aggregate(tc_sigs)
    tc_ok = bls.verify_aggregate(pks, tc_msgs, tc_agg)

    sk0 = committee[0][0]
    reqs = [
        (QC_LABEL, "bls_verify_votes", (digest, pk_enc, sig_enc)),
        ("QC, one vote over another digest", "bls_verify_votes",
         (digest, pk_enc, forged)),
        ("QC, one signature not a curve point", "bls_verify_votes",
         (digest, pk_enc, junk)),
        ("aggregate over 67 keys", "bls_verify_aggregate",
         (digest, bls.g2_encode(agg), pk_enc)),
        (TC_LABEL, "bls_verify_multi",
         (tc_msgs, pk_enc, [bls.g2_encode(s) for s in tc_sigs])),
        ("sign", "bls_sign", (digest, sk0.to_bytes(48, "big"))),
        ("QC of 67 votes, repeated", "bls_verify_votes",
         (digest, pk_enc, sig_enc)),
    ]
    want = [qc_ok, forged_ok, False, qc_ok, tc_ok,
            bls.g2_encode(bls.sign(sk0, digest)), qc_ok]
    if [qc_ok, forged_ok, tc_ok] != [True, False, True]:
        fail(f"host reference verdicts {[qc_ok, forged_ok, tc_ok]}")
    return reqs, want


class StageClock:
    """Times the BLS host preparation by stage: wraps each named function
    of the port's modules (looked up by the callers at call time) to add
    its calls and wall to the current request's tally, until
    ``restore``.  The stages are disjoint: none calls another."""

    def __init__(self, targets):
        self.tally: dict = {}
        self._saved = []
        for module, attr, stage in targets:
            real = getattr(module, attr)
            self._saved.append((module, attr, real))
            setattr(module, attr, self._wrap(real, stage))

    def _wrap(self, real, stage):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                n, ms = self.tally.get(stage, (0, 0.0))
                self.tally[stage] = (
                    n + 1, ms + (time.perf_counter() - t0) * 1e3)
        return timed

    def take(self) -> dict:
        tally, self.tally = self.tally, {}
        return tally

    def restore(self) -> None:
        for module, attr, real in reversed(self._saved):
            setattr(module, attr, real)
        self._saved = []


def bls_stage_targets():
    """The BLS request body's host stages (sidecar/service.py
    _execute_bls_inner, ops/bls381.py): per-vote G2 decode (the on-curve
    check; an AGG request's subgroup test at decode falls in the rest),
    signature aggregation, the subgroup test, public-key decode,
    hash-to-G2, the Miller lines (one call a row), OP_BLS_SIGN's G2
    scalar multiplication, and ``_check`` (the rows' stack and copy to
    the card, and the device check inside it)."""
    from hotstuff_tpu_torch.offchain import bls12381 as bls
    from hotstuff_tpu_torch.ops import bls381 as B

    return [(bls, "g2_decode_lax", "g2 decode"),
            (bls, "aggregate", "aggregate"),
            (bls, "g2_in_subgroup", "subgroup test"),
            (bls, "g1_decode", "g1 decode"),
            (bls, "hash_to_g2", "hash_to_g2"),
            (B, "miller_lines", "miller_lines"),
            (bls, "g2_mul", "g2_mul (sign)"),
            (B, "_check", "copy and device check")]


def bls_sidecar_phase(dev, reqs, want):
    """Phase 7, second half: the BLS requests through the port's sidecar
    on the card.  The launch counts are zeroed just before the requests
    and read just after.  Every pairing check's device time is taken by
    wrapping ops/bls381.pairings_check (its call and a synchronize), and
    its Miller lines kept for phase 8.  Returns (launch counts over the
    requests, counts per request, {label: lines})."""
    import torch

    from hotstuff_tpu_torch.offchain import bls12381 as bls
    from hotstuff_tpu_torch.ops import bls381 as B
    from hotstuff_tpu_torch.ops import kern
    from hotstuff_tpu_torch.sidecar import protocol as proto
    from hotstuff_tpu_torch.sidecar import service
    from hotstuff_tpu_torch.sidecar.client import SidecarClient

    checks = []
    real_check = B.pairings_check

    def timed_check(lines):
        t0 = time.perf_counter()
        out = real_check(lines)
        torch.cuda.synchronize()
        checks.append(((time.perf_counter() - t0) * 1e3, lines))
        return out

    engine = service.VerifyEngine(device=dev)
    server = None
    per_request: dict = {}
    kept: dict = {}
    clock = None
    B.pairings_check = timed_check
    try:
        t0 = time.monotonic()
        service.warmup_bls(engine)
        print(f"BLS warm-up (a 3-vote aggregate) on {engine.device}: "
              f"{time.monotonic() - t0:.3f} s", flush=True)
        server = service.SidecarServer(("127.0.0.1", 0), engine)
        threading.Thread(target=server.serve_forever,
                         kwargs={"poll_interval": 0.1}, daemon=True).start()
        # The first request meets a cold hash-to-G2 memo, as a fresh
        # sidecar's first request does (make_bls_requests warmed it).
        bls._hash_to_g2_cached.cache_clear()
        clock = StageClock(bls_stage_targets())
        with SidecarClient(port=server.server_address[1],
                           timeout=600.0) as client:
            kern.reset_launches()
            for (label, method, args), expect in zip(reqs, want):
                before = dict(kern.LAUNCHES)
                n_checks = len(checks)
                clock.take()
                t0 = time.perf_counter()
                got = getattr(client, method)(*args)
                ms = (time.perf_counter() - t0) * 1e3
                stages = clock.take()
                delta = {k: kern.LAUNCHES[k] - before[k] for k in before
                         if kern.LAUNCHES[k] != before[k]}
                per_request[label] = delta
                device_ms = sum(c[0] for c in checks[n_checks:])
                for _, lines in checks[n_checks:]:
                    kept[label] = lines
                print(f"BLS {label}: verdict "
                      f"{got if method != 'bls_sign' else f'{len(got)} bytes'}"
                      f", {ms:.3f} ms (device check {device_ms:.3f} ms, "
                      f"host preparation and the rest "
                      f"{ms - device_ms:.3f} ms), kernel launches {delta}",
                      flush=True)
                print_bls_stages(label, ms, device_ms, stages)
                if got != expect:
                    fail(f"BLS {label}: {got!r} differs from the host "
                         f"reference {expect!r}")
                checked = len(checks) > n_checks
                if "curve point" in label and engine.cached_bls_verdict(
                        proto.BlsVotesRequest(0, *args)) != [False]:
                    fail(f"BLS {label}: the decode failure was not cached")
                if method != "bls_sign" and "repeated" not in label \
                        and "curve point" not in label:
                    if not checked or delta != {k: 1 for k in BLS_KERNELS}:
                        fail(f"BLS {label}: the check did not launch "
                             f"exactly {BLS_KERNELS} once each ({delta})")
                elif checked or delta:
                    fail(f"BLS {label}: ran a pairing check or launched "
                         f"kernels ({delta})")
            launches = dict(kern.LAUNCHES)
            stats = client.stats()
        print(f"OP_STATS paths after the BLS requests: {stats['paths']}",
              flush=True)
    finally:
        if clock is not None:
            clock.restore()
        B.pairings_check = real_check
        if server is not None:
            server.shutdown()
            server.server_close()
        engine.stop()
    for name in BLS_KERNELS:
        if not launches[name]:
            fail(f"kernel {name} was not launched by the BLS requests")
    print(f"kernel launches over the BLS requests: "
          f"{ {k: launches[k] for k in BLS_KERNELS + BLS_OFF_PATH} }",
          flush=True)
    return launches, per_request, kept


def print_bls_stages(label, ms, device_ms, stages) -> None:
    """One request's host preparation by stage: each stage's calls and
    ms (the Miller lines also per row), the copy (``_check`` less the
    device check), and what no stage holds (the wire, the engine's
    queue and guard, public-key aggregation)."""
    out = {}
    for stage, (n, t) in sorted(stages.items(), key=lambda kv: -kv[1][1]):
        if stage == "copy and device check":
            out["copy"] = {"n": n, "ms": round(t - device_ms, 3)}
            out["device check"] = {"n": n, "ms": round(device_ms, 3)}
            continue
        out[stage] = {"n": n, "ms": round(t, 3)}
        if stage == "miller_lines":
            out[stage]["ms_per_row"] = round(t / n, 3)
    out["rest"] = {"ms": round(ms - sum(t for _, t in stages.values()), 3)}
    print(f"BLS {label} stages: {json.dumps(out)}", flush=True)


def bls_profile_phase(dev, kept) -> None:
    """Phase 8: the QC's and the TC's pairing check on the card from the
    requests' own Miller lines (host preparation excluded): wall time of
    three runs and the first one's kernel launches; the device span of
    three runs (CUDA events recorded on the stream before the first
    launch and after the verdict's last operator: the card's time from
    the check's first kernel to its verdict, waits for the host's
    dispatch included); three runs under torch.profiler (device busy
    time and share per check, the kernels that fill it; "not measured"
    when its trace holds no kernel of the port); and one run counting
    the operators each function of the port dispatches."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from hotstuff_tpu_torch.ops import bls381 as B
    from hotstuff_tpu_torch.ops import kern

    cuda = torch.autograd.DeviceType.CUDA
    for label, key in (("QC check (2 pairings)", QC_LABEL),
                       ("TC check (68 pairings)", TC_LABEL)):
        lines = kept[key]
        walls = []
        for i in range(3):
            kern.reset_launches()
            t0 = time.perf_counter()
            ok = bool(B.pairings_check(lines).item())
            walls.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                launches = {k: v for k, v in kern.LAUNCHES.items() if v}
                if launches != {k: 1 for k in BLS_KERNELS}:
                    fail(f"profile {label}: launches {launches}")
            if not ok:
                fail(f"profile {label}: the check returned False")
        wall = sorted(walls)[1]
        spans = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            B.pairings_check(lines)
            end.record()
            torch.cuda.synchronize()
            spans.append(start.elapsed_time(end))
        span = sorted(spans)[1]
        # Four checks under the profiler, the first a warm-up step that
        # is not recorded: the device tracer loses the first kernels it
        # sees (a check's first launches were missing without it).
        active = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=active),
                     acc_events=True) as prof:
            for _ in range(1 + active):
                B.pairings_check(lines).item()
                torch.cuda.synchronize()
                prof.step()
        by_name: dict = {}
        for e in prof.events():
            # The step's own range is on the device timeline too.
            if e.device_type == cuda and not e.name.startswith(
                    "ProfilerStep"):
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        busy_ms = sum(us for _, us in by_name.values()) / 1e3 / active
        events = sum(n for n, _ in by_name.values()) / active
        # The device tracer drops some of a short window's first kernels:
        # the busy time stands only when it holds every launch.
        traced = sum(n for name, (n, _) in by_name.items()
                     if "_kernel(" in name)
        busy = (f"device busy {busy_ms:.3f} ms, busy share of wall "
                f"{busy_ms / wall:.4f}" if traced == active * len(BLS_KERNELS)
                else f"device busy not measured (the profiler's trace holds "
                f"{traced} of the {active * len(BLS_KERNELS)} launches)")
        print(f"profile BLS {label}: wall {wall:.3f} ms (median of 3: "
              f"{', '.join(f'{w:.3f}' for w in walls)}); kernel launches "
              f"{launches}; device span {span:.3f} ms (median of 3: "
              f"{', '.join(f'{t:.3f}' for t in spans)}), span share of "
              f"wall {span / wall:.4f}; device events per check {events:g}, "
              f"{busy}", flush=True)
        for name, (n, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1]):
            print(f"  device {us / 1e3 / active:.3f} ms a check in "
                  f"{n / active:g} events: {name[:90]}", flush=True)
        ops = ops_by_caller(lambda: B.pairings_check(lines).item())
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        print(f"  operators dispatched: {sum(ops.values())}; by caller: "
              + ", ".join(f"{k} {n}" for k, n in top_ops), flush=True)


# The flags hotstuff_tpu/harness/local.py:314-317 gives a 4-node run's
# sidecar at 1,000 tx/s with RLC warm-up (ports and paths filled in).
HARNESS_FLAGS = "--port {port} --committee 4 --client-rate 1000 --warm-rlc " \
    "--trace {trace}"


# What follows the interpreter in a sidecar's command line
# (scripts/torch_guard_probe.py puts a wrapper here that logs the wall of
# each guarded launch).
SIDECAR_CMD = ("-m", "hotstuff_tpu_torch.sidecar")


def start_sidecar(flags: str, log_name: str, env=None):
    """Boot ``python -m hotstuff_tpu_torch.sidecar`` with ``flags`` (a
    free port filled into ``{port}``) in a process of its own, its output
    in build/chip/``log_name``, and wait until it answers PING.  Returns
    (the process, the port, the argv, the log's path, seconds to the
    PING)."""
    import socket

    from hotstuff_tpu_torch.sidecar.client import SidecarClient

    work = os.path.join(REPO, "build", "chip")
    os.makedirs(work, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = flags.format(port=port).split()
    log_path = os.path.join(work, log_name)
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, *SIDECAR_CMD, *argv],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, **(env or {})})
    while True:
        try:
            with SidecarClient(port=port, timeout=10) as c:
                c.ping()
            return proc, port, argv, log_path, time.monotonic() - t0
        except (ConnectionError, OSError):
            if proc.poll() is not None or time.monotonic() - t0 > 600:
                stop_process(proc)
                with open(log_path) as f:
                    fail(f"the sidecar with {argv} did not come up:\n"
                         + f.read()[-4000:])
            time.sleep(0.5)


def stop_process(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def wire_phase(reqs, want) -> None:
    """Phase 9: the port's sidecar as the harness boots it, in a process
    of its own on the card: OP_HELLO is answered with the reference's
    reply (encode_hello_reply: the server's protocol version and the
    tenant), OP_CHAOS with [0] (refused, the reference without
    --chaos), a QC through the connection that said HELLO with the host
    reference's mask, and the --trace file holds every stage's spans
    with no malformed line."""
    import socket

    from hotstuff_tpu_torch.obs import parse_spans
    from hotstuff_tpu_torch.sidecar import protocol as proto
    from hotstuff_tpu_torch.sidecar.client import SidecarClient

    work = os.path.join(REPO, "build", "chip")
    os.makedirs(work, exist_ok=True)
    trace = os.path.join(work, "sidecar-spans.jsonl")
    if os.path.exists(trace):
        os.remove(trace)
    proc, port, argv, _, boot_s = start_sidecar(
        HARNESS_FLAGS.replace("{trace}", trace), "sidecar.log")
    try:
        print(f"wire: the sidecar with the harness's flags {argv} "
              f"listening after {boot_s:.3f} s", flush=True)
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            for frame, want_reply, what in (
                    (proto.encode_hello_request(1, "node"),
                     proto.encode_hello_reply(1, "node"), "OP_HELLO"),
                    (proto.encode_chaos_request(2, {"delay_ms": 5}),
                     proto.encode_reply(proto.OP_CHAOS, 2, [0]),
                     "OP_CHAOS")):
                s.sendall(frame)
                got = proto.read_frame(s)
                if got != want_reply[4:]:
                    fail(f"wire: {what} answered {got!r}, the reference "
                         f"answers {want_reply[4:]!r}")
                print(f"wire: {what} answered as the reference", flush=True)
        with SidecarClient(port=port, timeout=120) as c:
            if c.hello("node") != "node":
                fail("wire: HELLO on the client did not echo the tenant")
            mask = c.verify_batch(*reqs[0][2])
            if mask != want[0]:
                fail("wire: the QC's mask differs from the host reference")
            paths = c.stats()["paths"]
        print(f"wire: a QC after HELLO, mask equal to the host reference; "
              f"paths {paths}", flush=True)
    finally:
        stop_process(proc)
    spans, malformed = parse_spans(open(trace).read())
    stages = sorted({r["stage"] for r in spans})
    if malformed or not {"admit", "queue", "pack", "dispatch", "device",
                         "reply"} <= set(stages):
        fail(f"wire: spans {stages}, {malformed} malformed")
    print(f"wire: {len(spans)} spans, stages {stages}, none malformed",
          flush=True)


# Phase 10: the guard drill.  The sidecar runs in its own process with
# --chaos, and a short warm grace so that a scripted wedge is declared in
# seconds (the launches it judges take milliseconds on the card).
GUARD_FLAGS = "--port {port} --chaos --committee 100 --warm-bls"
GUARD_ENV = {"HOTSTUFF_TPU_GUARD_WARM_GRACE_S": "2",
             "HOTSTUFF_TPU_GUARD_MIN_DEADLINE_S": "0.5"}


def guard_phase() -> None:
    """Phase 10: the launch guard, the chaos hook and the staged pipeline
    on the card, through the wire of a sidecar booted as
    ``python -m hotstuff_tpu_torch.sidecar --chaos --committee 100
    --warm-bls``.  A chaos wedge parks the launch's guard thread on an
    event: the guard's deadline, ladder, reboot and canary run as for a
    hung device call, but the card itself is never hung.  Any failed
    drill ends the run."""
    import hashlib
    import socket
    import statistics

    from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
    from hotstuff_tpu_torch.offchain import bls12381 as bls
    from hotstuff_tpu_torch.sidecar import protocol as proto
    from hotstuff_tpu_torch.sidecar.client import (SidecarClient,
                                                   SidecarOverloaded)

    def seed(tag: str, i: int) -> bytes:
        return hashlib.sha256(f"chip-smoke/{tag}/{i}".encode()).digest()

    committee = [ref.generate_keypair(seed("replica", i)) for i in range(67)]
    bls_keys = [bls.key_gen(seed("bls-replica", i)) for i in range(67)]
    bls_pks = [bls.g1_encode(pk) for _, pk in bls_keys]

    def qc(block: int, forged: int | None = None):
        digest = seed("guard-block", block)
        sigs = [ref.sign(sk, digest) for sk, _ in committee]
        if forged is not None:
            sigs[forged] = ref.sign(committee[forged][0], seed("forged", 9))
        pks = [pk for _, pk in committee]
        want = [ref.verify(pk, digest, s) for pk, s in zip(pks, sigs)]
        return ([digest] * len(pks), pks, sigs), want

    def bls_qc(block: int):
        digest = seed("guard-bls-block", block)
        return digest, [bls.g2_encode(bls.sign(sk, digest))
                        for sk, _ in bls_keys]

    def bulk(batch: int):
        msgs = [seed(f"guard-tx{batch}", j) for j in range(1024)]
        keys = [committee[j % len(committee)] for j in range(1024)]
        return (msgs, [pk for _, pk in keys],
                [ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)])

    t0 = time.monotonic()
    qcs = [qc(b) for b in range(10)]
    forged_qc = qc(20, forged=30)
    bulks = [bulk(b) for b in range(3)]
    bls_wedged, bls_after = bls_qc(0), bls_qc(1)
    if not bls.verify_aggregate_common(
            [pk for _, pk in bls_keys], bls_after[0],
            bls.aggregate([bls.g2_decode(s) for s in bls_after[1]])):
        fail("guard: the host reference rejects the BLS QC")
    print(f"guard: signed 11 QCs, 3 bulk batches and 2 BLS QCs in "
          f"{time.monotonic() - t0:.3f} s", flush=True)

    proc, port, argv, log_path, boot_s = start_sidecar(
        GUARD_FLAGS, "sidecar-guard.log", GUARD_ENV)

    def log_tail() -> str:
        # Long enough to hold the guard's stack of the last overrun.
        with open(log_path) as f:
            return f.read()[-8000:]

    def check(ok: bool, what: str) -> None:
        if not ok:
            fail(f"guard: {what}\n{log_tail()}")

    def wait_for(pred, what: str, timeout: float = 120.0):
        t = time.monotonic()
        while time.monotonic() - t < timeout:
            got = pred()
            if got:
                return got
            time.sleep(0.002)
        check(False, f"timed out waiting for {what}")

    try:
        print(f"guard: sidecar {argv} with {GUARD_ENV} listening after "
              f"{boot_s:.3f} s", flush=True)
        with SidecarClient(port=port, timeout=120) as c, \
                SidecarClient(port=port, timeout=120) as watch:
            def timed(fn, *args, **kw):
                t = time.monotonic()
                out = fn(*args, **kw)
                return out, (time.monotonic() - t) * 1e3

            first = watch.stats()
            check(first["guard"]["warm_boot"] and first["guard"]["device_ok"],
                  f"boot guard section {first['guard']}")
            # Ed25519 1: QCs of 67 votes on the device, before the wedge.
            before_ms = []
            for args, want in qcs[:5]:
                mask, ms = timed(c.verify_batch, *args)
                check(mask == want, "a QC's mask before the wedge")
                before_ms.append(ms)
            print(f"guard: Ed25519 QC of 67 before the wedge: median "
                  f"{statistics.median(before_ms):.3f} ms "
                  f"(each {[round(m, 3) for m in before_ms]})", flush=True)
            # Ed25519 2: a wedge, then a QC with one forged vote, answered
            # by the host ladder.
            check(c.chaos(wedge=1), "OP_CHAOS wedge was refused")
            box: dict = {}

            def ladder_qc():
                try:
                    box["mask"], box["ms"] = timed(
                        c.verify_batch, *forged_qc[0])
                except Exception as e:       # reported below
                    box["error"] = repr(e)

            t_qc = threading.Thread(target=ladder_qc)
            t_qc.start()
            # Ed25519 3: bulk while the reboot runs gets OP_BUSY.
            wait_for(lambda: watch.stats()["guard"]["rebooting"],
                     "the reboot to start", timeout=60)
            try:
                watch.verify_batch(*bulks[0], bulk=True)
                check(False, "bulk during the reboot was not shed")
            except SidecarOverloaded as e:
                busy_retry = e.retry_after_ms
            check(busy_retry is not None and busy_retry >= 0,
                  f"OP_BUSY retry-after {busy_retry}")
            t_qc.join(120)
            check("mask" in box, f"the wedged QC: {box}")
            check(box["mask"] == forged_qc[1],
                  "the host-answered mask differs from the expected mask")
            print(f"guard: wedge -> host-answered mask of the forged QC "
                  f"(exact, 1 invalid of 67) after {box['ms']:.3f} ms; "
                  f"bulk 1024 during the reboot: OP_BUSY, retry-after "
                  f"{busy_retry} ms", flush=True)
            # Ed25519 4: device routing resumes after the canary.
            g = wait_for(lambda: (lambda g: g if g["device_ok"]
                                  and not g["rebooting"] else None)(
                watch.stats()["guard"]), "the reboot to end")
            check(g["reboots"] == 1 and g["canary_passes"] >= 1
                  and g["wedges"] == 1, f"guard after recovery {g}")
            print(f"guard: rebooted: last_reboot_wall_s "
                  f"{g['last_reboot_wall_s']}, last_rewarm_wall_s "
                  f"{g['last_rewarm_wall_s']}, canary passes "
                  f"{g['canary_passes']}, host-fallback records "
                  f"{g['host_fallback_records']}, busy replies "
                  f"{g['busy_replies']}", flush=True)
            # Ed25519 5: fresh QCs on the device again.
            stats0 = watch.stats()
            after_ms = []
            for args, want in qcs[5:10]:
                mask, ms = timed(c.verify_batch, *args)
                check(mask == want, "a QC's mask after the reboot")
                after_ms.append(ms)
            stats1 = watch.stats()
            moved = stats1["paths"].get("rlc", 0) - \
                stats0["paths"].get("rlc", 0)
            launched = {k: stats1["kernels"][k] - stats0["kernels"][k]
                        for k in stats1["kernels"]}
            check(moved == 5 and launched["rlc_scalars"] >= 5
                  and launched["point_ladder"] >= 5
                  and "host" not in stats1["paths"],
                  f"QCs after the reboot: paths {stats1['paths']}, "
                  f"launches {launched}")
            print(f"guard: Ed25519 QC of 67 after recovery: median "
                  f"{statistics.median(after_ms):.3f} ms (each "
                  f"{[round(m, 3) for m in after_ms]}); paths.rlc +{moved}; "
                  f"kernel launches {launched}", flush=True)

            # BLS 1: a wedge, then a BLS QC: the transient reply.
            check(c.chaos(wedge=1), "OP_CHAOS wedge was refused")
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=120) as s:
                t = time.monotonic()
                s.sendall(proto.encode_bls_votes_request(
                    77, bls_wedged[0], bls_pks, bls_wedged[1]))
                got = proto.read_frame(s)
                bls_ms = (time.monotonic() - t) * 1e3
            transient = proto.encode_reply(proto.OP_BLS_VERIFY_VOTES, 77,
                                           [False])[4:]
            check(got == transient, f"the wedged BLS QC answered {got!r}")
            g = wait_for(lambda: (lambda g: g if g["device_ok"]
                                  and not g["rebooting"]
                                  and g["reboots"] == 2 else None)(
                watch.stats()["guard"]), "the second reboot to end")
            print(f"guard: wedge -> BLS QC answered transient ([False], "
                  f"the reference's bytes) after {bls_ms:.3f} ms; "
                  f"rebooted: last_reboot_wall_s {g['last_reboot_wall_s']},"
                  f" last_rewarm_wall_s {g['last_rewarm_wall_s']}",
                  flush=True)
            # BLS 2: the same QC (not cached False) and one over a new
            # digest are True from the card.
            stats0 = watch.stats()
            for digest, sigs in (bls_wedged, bls_after):
                ok, ms = timed(c.bls_verify_votes, digest, bls_pks, sigs)
                check(ok is True, "a BLS QC after the reboot")
            stats1 = watch.stats()
            launched = {k: stats1["kernels"][k] - stats0["kernels"][k]
                        for k in ("miller_accumulate", "final_exp")}
            check(launched == {"miller_accumulate": 2, "final_exp": 2},
                  f"BLS QCs after the reboot launched {launched}")
            print(f"guard: BLS QCs after recovery True from the card (the "
                  f"second {ms:.3f} ms), kernel launches {launched}",
                  flush=True)

            # The chaos knobs.
            check(c.chaos(shed=1), "OP_CHAOS shed was refused")
            try:
                c.verify_batch(*qcs[0][0])
                check(False, "shed did not answer OP_BUSY")
            except SidecarOverloaded:
                pass
            check(c.chaos(delay_ms=200), "OP_CHAOS delay was refused")
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=60) as s:
                t = time.monotonic()
                s.sendall(proto.encode_request(88, *qcs[0][0])
                          + proto.encode_ping(89))
                order = []
                for _ in range(2):
                    op, rid, _ = proto.decode_reply_raw(proto.read_frame(s))
                    order.append((rid, (time.monotonic() - t) * 1e3))
            check([r for r, _ in order] == [89, 88] and order[1][1] >= 200,
                  f"delay_ms 200: replies {order}")
            check(c.chaos(drop=1), "OP_CHAOS drop was refused")
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=60) as s:
                s.sendall(proto.encode_request(90, *qcs[0][0]))
                try:
                    dropped = proto.read_frame(s) == b""
                except (ConnectionError, OSError):
                    dropped = True
            check(dropped, "drop did not close the connection")
            check(c.chaos(shed=3, drop=3, delay_ms=700),
                  "OP_CHAOS shed, drop and delay were refused")
            check(c.chaos(clear=True), "OP_CHAOS clear was refused")
            mask, clear_ms = timed(c.verify_batch, *qcs[0][0])
            check(mask == qcs[0][1] and clear_ms < 700,
                  f"after clear: {clear_ms:.3f} ms")
            print(f"guard: chaos shed -> OP_BUSY; delay_ms 200 -> the "
                  f"pipelined PING at {order[0][1]:.3f} ms, the verify at "
                  f"{order[1][1]:.3f} ms; drop -> connection closed; clear "
                  f"-> a cached QC in {clear_ms:.3f} ms", flush=True)

            # The staged pipeline: two bulk requests of 1024 back to back.
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=120) as s:
                t = time.monotonic()
                s.sendall(proto.encode_request(
                    91, *bulks[1], opcode=proto.OP_VERIFY_BULK)
                    + proto.encode_request(
                    92, *bulks[2], opcode=proto.OP_VERIFY_BULK))
                replies = [proto.decode_reply_raw(proto.read_frame(s))
                           for _ in range(2)]
                pair_ms = (time.monotonic() - t) * 1e3
            check(sorted(r[1] for r in replies) == [91, 92]
                  and all(r[0] == proto.OP_VERIFY_BULK for r in replies),
                  f"bulk pair replies {[r[:2] for r in replies]}")
            stats = watch.stats()
            pipe = stats["pipeline"]
            print(f"guard: two bulk 1024 back to back in {pair_ms:.3f} ms; "
                  f"pipeline {json.dumps(pipe, sort_keys=True)}; surge "
                  f"derate {stats['surge']['derate']}", flush=True)
            g = stats["guard"]
            print(f"guard: OP_STATS guard {json.dumps(g, sort_keys=True)}",
                  flush=True)
    finally:
        stop_process(proc)


# ---------------------------------------------------------------------------
# Phase 11: the mesh on the card
# ---------------------------------------------------------------------------

MESH_SHARDS = 4
MESH_COMMITTEE = 1000
# The kernels the mesh requests must launch (the probe at its boot).
MESH_KERNELS = ("field_mul", "msm_window_accum", "point_ladder",
                "decompress", "point_multiples", "rlc_scalars", "rlc_reduce",
                "miller_accumulate", "final_exp", "fq12_product")
# The shard's fold replaces the reference's XLA scan of flat products.
FOLD_REPLACES = "hotstuff_tpu/parallel/sharded_bls.py:41"
MESH_QC_LABEL = f"QC of 667 votes (committee {MESH_COMMITTEE})"


def ops_fq12_product(n: int) -> int:
    """fq12_product on n values, counted as final_exp's product stage:
    the n inputs' conversions, n - 1 Karatsuba products, the output's
    conversion."""
    from hotstuff_tpu_torch.ops.kern import fq12_tower as FT

    return ((n + 1) * 12 * OPS_W_CONVERT
            + (n - 1) * ops_bilinear(FT.OPS["mul"]))


def mesh_kernel_phase(dev, rng, mesh) -> dict:
    """Phase 11, first part: fq12_product at the TC's 17 rows a shard and
    at 68 beside its plain version, exact, timed as in phase 7; returns
    its kernels-line row."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.ops import bls381 as B
    from hotstuff_tpu_torch.ops import field381 as F381
    from hotstuff_tpu_torch.ops.kern import fq12_tower as FT

    row = dict(name="fq12_product", route="cuda", source=TOWER_SOURCE,
               replaces=FOLD_REPLACES, library_ms=None)
    prog_bytes = FT.PROGRAM.size * 4
    for n in (17, 68):
        x = torch.from_numpy(np.stack([B.host_fq12_to_mont_limbs(
            [int.from_bytes(rng.bytes(48), "little") % F381.Q
             for _ in range(12)]) for _ in range(n)])).to(dev)
        got = FT.fq12_product(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = FT.fq12_product_plain(x)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, want)
        if err != 0:
            fail(f"fq12_product ({n}, 12, 48) differs from its plain "
                 f"version (max abs err {err})")
        ms = time_ms(lambda: FT.fq12_product(x), 20)
        g_ms = graph_ms(lambda: FT.fq12_product(x), 20)
        ops = ops_fq12_product(n)
        b_ms, b_by = bound_ms((n + 1) * FQ12_BYTES + prog_bytes, ops)
        chain_ms = ops / PEAK_SM_INT32_OPS_PER_S * 1e3
        print(f"fq12_product ({n}, 12, 48): exact; kernel {ms:.6f} ms a "
              f"call from Python, {g_ms:.6f} ms a launch in a CUDA graph; "
              f"plain {plain_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}), "
              f"chain bound on one SM {chain_ms:.6f} ms", flush=True)
        vals = dict(max_abs_err=err, ms=ms, graph_ms=g_ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    chain_bound_ms=chain_ms)
        if n == 17:
            row.update(shape=f"({n}, 12, 48)", **vals)
        else:
            row.update({f"tc68_{k}": v for k, v in vals.items()})
    return row


def mesh_tree_check(mesh, prep) -> dict:
    """Phase 11: the gathered window sums of the QC's four shards (each
    shard's rlc_partials at its 256 rows, copied to the lead), tree-summed
    by _tree_sum on the card (K1) and by its plain version, exact."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.ops import ed25519 as E
    from hotstuff_tpu_torch.ops.kern.field_mul import field_mul_plain
    from hotstuff_tpu_torch.parallel import sharded_verify as shv

    packed = np.asarray(prep["packed"])
    idx = np.nonzero(prep["host_ok"])[0]
    n = packed.shape[0]
    rows, z = shv._pack_rlc_rows(mesh, packed, idx, n,
                                 shv.shard_aligned_rows(n, mesh.size), b"")
    wsums = []
    for i in range(mesh.size):
        with mesh.on(i):
            wsums.append(E.rlc_partials(rows[i], z[i])[0])
    with mesh.on("lead"):
        allw = shv.gather_window_sums(mesh, wsums)
        got = E._tree_sum(allw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = E._tree_sum(allw, mul=field_mul_plain)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ms = time_ms(lambda: E._tree_sum(allw), 20)
    err = max_abs_err(got, want)
    if err != 0:
        fail(f"_tree_sum of the gathered {tuple(allw.shape)} window sums "
             f"differs from its plain version (max abs err {err})")
    print(f"_tree_sum of the gathered {tuple(allw.shape)} window sums "
          f"(the QC's four shards): exact; {ms:.6f} ms on the card (K1), "
          f"plain {plain_ms:.6f} ms", flush=True)
    return dict(tree_sum_4x64_max_abs_err=err, tree_sum_4x64_ms=ms,
                tree_sum_4x64_plain_ms=plain_ms)


def make_mesh_requests():
    """A 1000-key Ed25519 committee and 64 client keys from a fixed seed:
    a QC of 667 votes, a QC of 667 over another block with one forged
    vote, 3 votes, a bulk backlog of 1280 transactions (a non-canonical
    S, a forged signature, an identity public key); a 67-key BLS
    committee's TC of 67 votes over 67 digests, and a TC of 3 votes with
    one over a wrong digest."""
    import hashlib

    from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
    from hotstuff_tpu_torch.offchain import bls12381 as bls
    from hotstuff_tpu_torch.utils.intmath import L

    def seed(tag: str, i: int) -> bytes:
        return hashlib.sha256(f"chip-smoke/mesh/{tag}/{i}".encode()).digest()

    committee = [ref.generate_keypair(seed("replica", i))
                 for i in range(MESH_COMMITTEE)]
    clients = [ref.generate_keypair(seed("client", i)) for i in range(64)]
    quorum = 2 * MESH_COMMITTEE // 3 + 1

    def qc(block: int, voters: int = quorum):
        digest = seed("block", block)
        return ([digest] * voters, [pk for _, pk in committee[:voters]],
                [ref.sign(sk, digest) for sk, _ in committee[:voters]])

    reqs = [(MESH_QC_LABEL, False, qc(0))]
    msgs, pks, sigs = qc(1)
    sigs[300] = ref.sign(committee[300][0], seed("forged", 0))
    reqs.append(("QC of 667 votes, one forged", False, (msgs, pks, sigs)))
    reqs.append(("3 votes", False, qc(2, voters=3)))
    n_bulk = 1280
    msgs = [seed("tx", j) for j in range(n_bulk)]
    keys = [clients[j % len(clients)] for j in range(n_bulk)]
    pks = [pk for _, pk in keys]
    sigs = [ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    s = int.from_bytes(sigs[100][32:], "little") + L
    sigs[100] = sigs[100][:32] + s.to_bytes(32, "little")
    sigs[900] = ref.sign(clients[1][0], seed("forged", 1))
    pks[700] = (1).to_bytes(32, "little")
    reqs.append((f"bulk backlog of {n_bulk}", True, (msgs, pks, sigs)))

    bls_keys = [bls.key_gen(seed("bls-replica", i)) for i in range(67)]
    pks = [pk for _, pk in bls_keys]
    tc_msgs = [seed("bls-round", i) for i in range(67)]
    tc_sigs = [bls.sign(sk, m) for (sk, _), m in zip(bls_keys, tc_msgs)]
    bad = [bls.sign(bls_keys[2][0], seed("bls-forged", 0))]
    bls_reqs = [
        ("TC of 67 votes over 67 digests", pks, tc_msgs, tc_sigs),
        ("TC of 3 votes, one over a wrong digest", pks[:3], tc_msgs[:3],
         tc_sigs[:2] + bad)]
    return reqs, bls_reqs


def mesh_phase(dev, rng) -> tuple:
    """Phase 11: the mesh on the card.  Four shards on the card
    (virtual_mesh(4, cuda:0): they show that the mesh path runs and is
    right, not that it scales) behind the engine's own entry,
    VerifyEngine(mesh=...) with committee 1000, the --warm-rlc-sharded
    warm-up and a launch guard.  The launch counts are zeroed before the
    warm-up (read after it), then just before the requests and read just
    after.  Every mask and verdict must equal the one-card program's on
    the same card and the host reference's.  Returns (the fq12_product
    row, launch counts over the requests, the _tree_sum check's
    fields, and phase 11's Ed25519 requests with their host masks for
    phase 12's mesh leg)."""
    import queue

    import numpy as np

    from hotstuff_tpu_torch.crypto import eddsa, ref_ed25519 as ref
    from hotstuff_tpu_torch.offchain import bls12381 as bls
    from hotstuff_tpu_torch.ops import bls381 as B
    from hotstuff_tpu_torch.ops import kern
    from hotstuff_tpu_torch.parallel.mesh import virtual_mesh
    from hotstuff_tpu_torch.sidecar import protocol as proto
    from hotstuff_tpu_torch.sidecar import service
    from hotstuff_tpu_torch.sidecar.guard import LaunchDeadlines, LaunchGuard
    from hotstuff_tpu_torch.sidecar.sched import BULK, LATENCY

    mesh = virtual_mesh(MESH_SHARDS, dev)
    product_row = mesh_kernel_phase(dev, rng, mesh)

    t0 = time.monotonic()
    reqs, bls_reqs = make_mesh_requests()
    want = [np.array([ref.verify(pk, m, s) for m, pk, s in zip(*r)])
            for _, _, r in reqs]
    bls_want = [bls.verify_aggregate(pks, msgs, bls.aggregate(sigs))
                for _, pks, msgs, sigs in bls_reqs]
    if bls_want != [True, False]:
        fail(f"mesh: host reference TC verdicts {bls_want}")
    # The one-card programs on the same card, before the counted window.
    one_card = [eddsa.verify_batch(*r, device=dev) for _, _, r in reqs]
    one_card_bls = [B.verify_aggregate_multi(pks, msgs, bls.aggregate(sigs),
                                             device=dev)
                    for _, pks, msgs, sigs in bls_reqs]
    print(f"mesh: signed {sum(len(r[0]) for _, _, r in reqs)} Ed25519 "
          f"records and {sum(len(r[3]) for r in bls_reqs)} BLS votes, host "
          f"and one-card verdicts in {time.monotonic() - t0:.3f} s",
          flush=True)
    for (label, _, _), w, o in zip(reqs, want, one_card):
        if not np.array_equal(w, o):
            fail(f"mesh {label}: the one-card program's mask differs from "
                 f"the host reference")
    if one_card_bls != bls_want:
        fail(f"mesh: one-card TC verdicts {one_card_bls} differ from the "
             f"host reference {bls_want}")
    tree = mesh_tree_check(mesh, eddsa.prepare_batch(*reqs[0][2]))

    kern.reset_launches()
    mesh.reset_launches()
    t0 = time.monotonic()
    engine = service.VerifyEngine(mesh=mesh, committee=MESH_COMMITTEE)
    guard = None
    try:
        service.warmup(engine)
        service.warmup_rlc_sharded(engine)
        boot = {k: v for k, v in kern.LAUNCHES.items() if v}
        print(f"mesh boot on {mesh} (warm-up and --warm-rlc-sharded, "
              f"committee {MESH_COMMITTEE}): {time.monotonic() - t0:.3f} s,"
              f" kernel launches {boot}; registry "
              f"{json.dumps(engine._shapes.snapshot())}", flush=True)
        if not boot.get("probe"):
            fail("the mesh boot did not launch the probe kernel")
        guard = LaunchGuard(deadlines=LaunchDeadlines.from_build(
            engine.device))
        engine._guard = guard
        replies: queue.Queue = queue.Queue()
        rid = 0

        def run(label, request, cls):
            nonlocal rid
            before = dict(kern.LAUNCHES)
            shards_before = {k: dict(v) for k, v in mesh.launches.items()}
            paths_before = dict(engine._sched.stats.paths)
            t0 = time.monotonic()
            if not engine.submit(request, replies.put, cls=cls):
                fail(f"mesh {label}: the engine refused the request")
            got = replies.get(timeout=600)
            ms = (time.monotonic() - t0) * 1e3
            paths = sorted(p for p, n in engine._sched.stats.paths.items()
                           if n > paths_before.get(p, 0))
            delta = {k: kern.LAUNCHES[k] - before[k] for k in before
                     if kern.LAUNCHES[k] != before[k]}
            shards = {}
            for key, counts in mesh.launches.items():
                d = {k: v - shards_before.get(key, {}).get(k, 0)
                     for k, v in counts.items()
                     if v != shards_before.get(key, {}).get(k, 0)}
                if d:
                    shards[str(key)] = d
            return got, ms, paths, delta, shards

        kern.reset_launches()
        mesh.reset_launches()
        expect_paths = [["rlc_sharded"], ["rlc_bisect", "rlc_sharded"],
                        ["ladder_sharded"], ["scan_sharded"]]
        for (label, bulk, (msgs, pks, sigs)), w, paths_want in zip(
                reqs, want, expect_paths):
            rid += 1
            got, ms, paths, delta, shards = run(
                label, proto.VerifyRequest(rid, msgs, pks, sigs),
                BULK if bulk else LATENCY)
            print(f"mesh {label}: {len(msgs)} records, "
                  f"{len(msgs) - int(w.sum())} invalid, path "
                  f"{'+'.join(paths)}, {ms:.3f} ms, launches per shard "
                  f"and on the lead {shards}", flush=True)
            if got is None or list(got) != [bool(b) for b in w]:
                fail(f"mesh {label}: the mask differs from the host "
                     f"reference and the one-card program")
            if paths != paths_want:
                fail(f"mesh {label}: path {paths}, expected {paths_want}")
        for (label, pks, msgs, sigs), w in zip(bls_reqs, bls_want):
            rid += 1
            got, ms, paths, delta, shards = run(
                label, proto.BlsMultiRequest(
                    rid, msgs, [bls.g1_encode(pk) for pk in pks],
                    [bls.g2_encode(s) for s in sigs]), LATENCY)
            print(f"mesh {label}: verdict {got}, path {'+'.join(paths)}, "
                  f"{ms:.3f} ms (host preparation included), launches per "
                  f"shard and on the lead {shards}", flush=True)
            if got != [w]:
                fail(f"mesh {label}: verdict {got}, the host reference and "
                     f"the one-card program say {w}")
            want_shards = {str(i): {"miller_accumulate": 1,
                                    "fq12_product": 1}
                           for i in range(MESH_SHARDS)}
            want_shards["lead"] = {"final_exp": 1}
            if shards != want_shards:
                fail(f"mesh {label}: launches {shards}, expected "
                     f"{want_shards}")
        launches = dict(kern.LAUNCHES)
        stats = engine.stats_snapshot()
    finally:
        engine.stop()
        if guard is not None:
            guard.close()
    print(f"mesh OP_STATS: mesh {json.dumps(stats['mesh'])}, scan "
          f"{json.dumps(stats['scan'])}, paths {json.dumps(stats['paths'])}"
          f", kernels by shard {json.dumps(stats['kernels_by_shard'])}",
          flush=True)
    if not stats["mesh"]["sharded_launches"] or \
            stats["scan"]["launches"] != 1 or \
            stats["scan"]["chunk_hist"] != {"2": 1}:
        fail(f"mesh OP_STATS: mesh {stats['mesh']}, scan {stats['scan']}")
    for name in MESH_KERNELS:
        if not launches[name]:
            fail(f"kernel {name} was not launched by the mesh requests")
    print(f"kernel launches over the mesh requests: "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return product_row, launches, tree, (reqs, want)


# ---------------------------------------------------------------------------
# Phase 12: the cadence ring on the card
# ---------------------------------------------------------------------------

RING_COMMITTEE = 100
RING_QCS, RING_VOTES = 12, 67
# Valid QCs (no bisection) for the second load, staged against the ring.
RING_VALID_QCS = 16
# The fixed offered load: one QC of 67 votes every 5 ms (the reference's
# bench.py cadence_probe offers 12 requests at once from the host).
RING_INTERVAL_S = 0.005
RING_BULK, RING_BULK_REQ = 1024, 16
# The sidecar process of the phase's wire leg.
RING_FLAGS = "--port {port} --cadence --committee 100 --warm-bls"
# A short warm grace for the phase's guard, so that the wedge leg's
# wedge is declared in seconds even before the tick keys are trained.
RING_WARM_GRACE_S = 5.0
# The kernels the ring's requests must launch: the RLC program, and the
# per-signature program of the bisection.
RING_KERNELS = ("field_mul", "msm_window_accum", "point_ladder",
                "decompress", "point_multiples", "rlc_scalars", "rlc_reduce")


def make_ring_requests() -> dict:
    """A 100-key Ed25519 committee from a fixed seed: 12 QCs of 67 votes
    over distinct digests, each with one tampered signature (byte 1
    flipped, as the reference's cadence probe); 16 valid QCs; a bulk
    backlog of 1024
    signatures in requests of 16 and a QC of 67 behind it; and two QCs
    for the wedge leg (one tampered vote each).  Host masks beside
    each."""
    import hashlib

    from hotstuff_tpu_torch.crypto import ref_ed25519 as ref

    def seed(tag: str, i: int) -> bytes:
        return hashlib.sha256(f"chip-smoke/ring/{tag}/{i}".encode()).digest()

    committee = [ref.generate_keypair(seed("replica", i))
                 for i in range(RING_COMMITTEE)]

    def request(msgs, keys, tamper=None):
        sigs = [ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
        if tamper is not None:
            s = sigs[tamper]
            sigs[tamper] = s[:1] + bytes([s[1] ^ 0xFF]) + s[2:]
        pks = [pk for _, pk in keys]
        want = [bool(ref.verify(pk, m, s)) for m, pk, s in zip(msgs, pks,
                                                                sigs)]
        return (msgs, pks, sigs), want

    def qc(tag, block, tamper=None):
        return request([seed(tag, block)] * RING_VOTES,
                       committee[:RING_VOTES], tamper)

    bulk = [request([seed("tx", r * RING_BULK_REQ + j)
                     for j in range(RING_BULK_REQ)],
                    [committee[(r + j) % RING_COMMITTEE]
                     for j in range(RING_BULK_REQ)])
            for r in range(RING_BULK // RING_BULK_REQ)]
    return {"qcs": [qc("block", b, tamper=(5 * b + 3) % RING_VOTES)
                    for b in range(RING_QCS)],
            "valid": [qc("valid", b) for b in range(RING_VALID_QCS)],
            "bulk": bulk, "behind": qc("behind", 0),
            "wedge": [qc("wedge", b, tamper=(11 + b) % RING_VOTES)
                      for b in range(2)]}


class _Replies:
    """Every reply per request id, with its arrival time."""

    def __init__(self):
        self.done: dict = {}
        self.cond = threading.Condition()

    def to(self, rid):
        def reply(mask):
            with self.cond:
                self.done.setdefault(rid, []).append(
                    (time.monotonic(), mask))
                self.cond.notify_all()
        return reply

    def wait(self, rids, timeout=300.0) -> bool:
        with self.cond:
            return self.cond.wait_for(
                lambda: all(r in self.done for r in rids), timeout=timeout)


def ring_offer(engine, replies, rid0, reqs, cls, interval_s=0.0) -> dict:
    """Offer ``reqs`` ((msgs, pks, sigs), want) from this thread, one
    every ``interval_s``, from request id ``rid0`` on; -> {rid: offer
    time}."""
    from hotstuff_tpu_torch.sidecar import protocol as proto

    sent = {}
    t0 = time.monotonic()
    for i, ((msgs, pks, sigs), _) in enumerate(reqs):
        wait = t0 + i * interval_s - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        rid = rid0 + i
        sent[rid] = time.monotonic()
        if not engine.submit(proto.VerifyRequest(rid, msgs, pks, sigs),
                             replies.to(rid), cls=cls):
            fail(f"ring: the engine refused request {rid}")
    return sent


def ring_check(label, replies, sent, reqs) -> list:
    """Every request answered exactly once with the host mask; -> the
    per-request latencies in ms."""
    if not replies.wait(list(sent)):
        fail(f"ring {label}: not every request was answered")
    lat = []
    for (rid, t_sent), (_, want) in zip(sent.items(), reqs):
        got = replies.done[rid]
        if len(got) != 1:
            fail(f"ring {label}: request {rid} got {len(got)} replies")
        t_reply, mask = got[0]
        if mask is None or list(mask) != want:
            fail(f"ring {label}: request {rid}'s mask differs from the "
                 f"host reference")
        lat.append((t_reply - t_sent) * 1e3)
    return lat


def ring_phase(dev, mesh_reqs) -> dict:
    """Phase 12: the cadence ring on the card.  One guard (warm grace
    RING_WARM_GRACE_S) supervises every engine of the phase.  The fixed
    load of 12 QCs goes through the staged engine, the ring pinned at
    depths 2, 4 and 8 and the staged engine again (a fresh engine each,
    so no verdict is cached), every mask equal to the host reference's;
    16 valid QCs through the staged engine and a fresh ring seeded with
    the warm-up's walls; then a ring engine whose depth trainer is
    seeded with the warm-up's walls (as ``serve()`` does): the same
    load, a bulk backlog of 1024
    with a QC behind it (that tick pad-fills), its OP_STATS ``cadence``
    section, and a chaos wedge under the ring (fallback to the staged
    loop, one reply per request, the next QC from the card); last, four
    shards of the card with the ring: 3 votes and a twin with a forged
    vote through ``ring_slot_pack`` (``ladder_sharded``), and a QC of
    667 (``rlc_sharded``).  Returns the launches over the phase's
    requests."""
    import numpy as np

    from hotstuff_tpu_torch.crypto import eddsa
    from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
    from hotstuff_tpu_torch.ops import kern
    from hotstuff_tpu_torch.parallel import sharded_verify as shv
    from hotstuff_tpu_torch.parallel.mesh import virtual_mesh
    from hotstuff_tpu_torch.sidecar import service
    from hotstuff_tpu_torch.sidecar.client import SidecarClient
    from hotstuff_tpu_torch.sidecar.guard import LaunchDeadlines, LaunchGuard
    from hotstuff_tpu_torch.sidecar.ring import CadenceRing, RingDepth
    from hotstuff_tpu_torch.sidecar.sched import BULK, LATENCY

    t0 = time.monotonic()
    data = make_ring_requests()
    n_records = sum(len(r[0][0]) for key in ("qcs", "valid", "bulk")
                    for r in data[key]) + RING_VOTES * 3
    print(f"ring: signed and host-verified {n_records} records in "
          f"{time.monotonic() - t0:.3f} s", flush=True)
    guard = LaunchGuard(deadlines=LaunchDeadlines.from_build(
        dev, warm_grace_s=RING_WARM_GRACE_S))
    totals: dict = {}

    def counted(fn):
        kern.reset_launches()
        out = fn()
        for k, v in kern.LAUNCHES.items():
            totals[k] = totals.get(k, 0) + v
        return out

    def boot(**kw):
        engine = service.VerifyEngine(device=dev, committee=RING_COMMITTEE,
                                      **kw)
        walls = service.warmup(engine)
        engine._guard = guard
        return engine, walls

    def load(engine, label, rid0, key="qcs"):
        replies = _Replies()
        reqs = data[key]

        def run():
            t = time.monotonic()
            sent = ring_offer(engine, replies, rid0, reqs, LATENCY,
                              RING_INTERVAL_S)
            lat = ring_check(label, replies, sent, reqs)
            return lat, time.monotonic() - t

        lat, wall = counted(run)
        snap = engine.stats_snapshot()
        n_sigs = sum(len(r[0][0]) for r in reqs)
        row = {"sigs_per_s": n_sigs / wall, "wall_ms": wall * 1e3,
               "latency_ms_p50": float(np.median(lat)),
               "latency_ms_max": max(lat), "launches": snap["launches"],
               "paths": snap["paths"]}
        cad = snap.get("cadence")
        tail = ""
        if cad is not None:
            row["cadence"] = {k: cad[k] for k in (
                "depth", "ticks", "dispatch_ticks", "occupancy_hist")}
            tail = (f", depth {cad['depth']}, ticks {cad['ticks']} "
                    f"({cad['dispatch_ticks']} dispatch), occupancy "
                    f"{json.dumps(cad['occupancy_hist'])}, trainer "
                    f"{json.dumps(cad['depth_trainer'])}")
            if cad["generation"]["drops"]:
                fail(f"ring {label}: generation drops {cad['generation']}")
        what = "one tampered vote each" if key == "qcs" else "valid"
        print(f"ring {label}: {len(reqs)} QCs of {RING_VOTES} ({what}) "
              f"offered every {RING_INTERVAL_S * 1e3:.0f} ms: "
              f"{row['sigs_per_s']:.1f} sigs/s, wall {row['wall_ms']:.3f} "
              f"ms, latency p50 {row['latency_ms_p50']:.3f} / max "
              f"{row['latency_ms_max']:.3f} ms, launches {row['launches']},"
              f" paths {json.dumps(row['paths'])}{tail}", flush=True)
        return row

    results = {}
    try:
        engine, _ = boot()
        try:
            if engine._ring is not None:
                fail("ring: a default engine runs the ring")
            results["staged"] = load(engine, "staged", 1000)
        finally:
            engine.stop()
        for k in RingDepth.DEPTHS:
            engine, _ = boot(ring_factory=lambda e, k=k: CadenceRing(
                e, depth=RingDepth(pinned=k)))
            try:
                results[f"ring k={k}"] = load(engine, f"ring k={k}",
                                              1000 * (k + 1))
                if results[f"ring k={k}"]["cadence"]["depth"] != k:
                    fail(f"ring k={k}: the ring ran at another depth")
            finally:
                engine.stop()
        # The staged engine again: the legs run in a fixed order, so the
        # ring legs are compared with a staged leg on either side.
        engine, _ = boot()
        try:
            results["staged, last"] = load(engine, "staged, last", 10000)
        finally:
            engine.stop()
        # The valid QCs (no bisection): staged, then a fresh trained ring.
        engine, _ = boot()
        try:
            results["staged, valid"] = load(engine, "staged, valid", 11000,
                                            "valid")
        finally:
            engine.stop()
        engine, walls = boot(cadence=True)
        try:
            engine._ring.depth.seed(walls)
            results["ring trained, valid"] = load(
                engine, "ring trained, valid", 12000, "valid")
        finally:
            engine.stop()

        # The trained ring: the load, the bulk backlog, OP_STATS, the wedge.
        chaos = service.ChaosState()
        engine, walls = boot(cadence=True, chaos=chaos)
        try:
            engine._ring.depth.seed(walls)
            print(f"ring trained: warm-up walls "
                  f"{ {k: round(v * 1e3, 3) for k, v in walls.items()} } ms "
                  f"seed the depth trainer "
                  f"{json.dumps(engine._ring.depth.snapshot())}", flush=True)
            results["ring trained"] = load(engine, "ring trained", 20000)
            replies = _Replies()

            def backlog():
                # The QC goes in behind the backlog's first half, so the
                # second half is queued whenever the ring takes the QC.
                half = len(data["bulk"]) // 2
                t = time.monotonic()
                sent = ring_offer(engine, replies, 30000,
                                  data["bulk"][:half], BULK)
                sent.update(ring_offer(engine, replies, 31000,
                                       [data["behind"]], LATENCY))
                sent.update(ring_offer(engine, replies, 30000 + half,
                                       data["bulk"][half:], BULK))
                lat = ring_check("bulk backlog", replies, sent,
                                 data["bulk"][:half] + [data["behind"]]
                                 + data["bulk"][half:])
                return lat[half], time.monotonic() - t

            lat, wall = counted(backlog)
            snap = engine.stats_snapshot()
            cad = snap["cadence"]
            print(f"ring trained: bulk backlog of {RING_BULK} "
                  f"({RING_BULK // RING_BULK_REQ} requests of "
                  f"{RING_BULK_REQ}) with a QC of {RING_VOTES} behind its "
                  f"first half: wall {wall * 1e3:.3f} ms, the QC's latency "
                  f"{lat:.3f} ms,"
                  f" pad-fill {json.dumps(cad['pad_fill'])}", flush=True)
            if not cad["pad_fill"]["sigs"]:
                fail("ring: no tick pad-filled from the bulk backlog")
            deadlines = guard.snapshot()["deadlines"]
            ticks = {k: v for k, v in deadlines.items()
                     if k.startswith("tick:")}
            print(f"ring OP_STATS cadence: {json.dumps(cad)}", flush=True)
            print(f"ring guard deadlines: {json.dumps(deadlines)}",
                  flush=True)
            if cad["generation"]["drops"] or not cad["dispatch_ticks"] or \
                    cad["fallbacks"] or not cad["queue_wait"]["n"]:
                fail(f"ring OP_STATS cadence: {cad}")
            if not any(v["n"] >= LaunchDeadlines.MIN_OBSERVATIONS
                       for v in ticks.values()):
                fail(f"ring: no tick: deadline trained ({ticks})")

            # A chaos wedge under the ring.
            (wedged, after) = data["wedge"]
            replies = _Replies()
            chaos.configure({"wedge": 1})
            t = time.monotonic()
            sent = ring_offer(engine, replies, 40000, [wedged], LATENCY)
            lat = ring_check("wedge", replies, sent, [wedged])
            print(f"ring wedge: the wedged QC answered by the host ladder "
                  f"after {lat[0]:.3f} ms, ring enabled "
                  f"{engine._ring.enabled}", flush=True)
            if engine._ring.enabled:
                fail("ring: the wedge did not disengage the ring")
            t = time.monotonic()
            while not (engine._device_ok and not engine._rebooting):
                if time.monotonic() - t > 120:
                    fail("ring: the reboot after the wedge did not finish")
                time.sleep(0.01)
            reboot_s = time.monotonic() - t
            paths_before = dict(engine._sched.stats.paths)
            lat = counted(lambda: ring_check(
                "after the wedge", replies,
                ring_offer(engine, replies, 40001, [after], LATENCY),
                [after]))
            launched = {k: v for k, v in kern.LAUNCHES.items() if v}
            paths = sorted(p for p, n in engine._sched.stats.paths.items()
                           if n > paths_before.get(p, 0))
            cad = engine.stats_snapshot()["cadence"]
            print(f"ring wedge: reboot done {reboot_s:.3f} s after the "
                  f"answer; the next QC from the staged loop in "
                  f"{lat[0]:.3f} ms, path {'+'.join(paths)}, launches "
                  f"{launched}; cadence fallbacks {cad['fallbacks']}; "
                  f"one reply per request id", flush=True)
            if "rlc" not in paths or not launched.get("rlc_scalars"):
                fail("ring: the QC after the wedge did not run on the card")
            if cad["fallbacks"] != 1:
                fail(f"ring: cadence fallbacks {cad['fallbacks']}")
        finally:
            engine.stop()

        staged = (results["staged"]["sigs_per_s"]
                  + results["staged, last"]["sigs_per_s"]) / 2
        for label, row in results.items():
            if label.endswith("valid"):
                row["vs_staged"] = row["sigs_per_s"] / \
                    results["staged, valid"]["sigs_per_s"]
            elif not label.startswith("staged"):
                row["vs_staged"] = row["sigs_per_s"] / staged

        # The CLI: a sidecar process with --cadence (and --warm-bls, whose
        # warm-up runs the BLS self-check before the socket binds).
        proc, port, argv, log_path, boot_s = start_sidecar(
            RING_FLAGS, "sidecar-ring.log")
        try:
            (qc, qc_want) = data["wedge"][0]
            with SidecarClient(port=port, timeout=120) as c:
                t = time.monotonic()
                mask = c.verify_batch(*qc)
                ms = (time.monotonic() - t) * 1e3
                cad = c.stats()["cadence"]
        finally:
            stop_process(proc)
        with open(log_path) as f:
            boot_log = f.read()
        print(f"ring wire: sidecar {argv} listening after {boot_s:.3f} s; a "
              f"QC of {RING_VOTES} (one tampered vote) in {ms:.3f} ms; "
              f"OP_STATS cadence enabled {cad['enabled']}, depth "
              f"{cad['depth']}, dispatch ticks {cad['dispatch_ticks']}",
              flush=True)
        if mask != qc_want or not cad["enabled"] or \
                not cad["dispatch_ticks"]:
            fail(f"ring wire: mask equal {mask == qc_want}, cadence {cad}")
        for line in ("cadence: ring engaged", "BLS self-check exact"):
            if line not in boot_log:
                fail(f"ring wire: the sidecar's log lacks {line!r}:\n"
                     + boot_log[-4000:])

        # The mesh ring slot.
        reqs, want = mesh_reqs
        by_label = {label: (r, w) for (label, _, r), w in zip(reqs, want)}
        three, three_want = by_label["3 votes"]
        msgs, pks, sigs = three
        sigs = list(sigs)
        sigs[1] = sigs[1][:1] + bytes([sigs[1][1] ^ 0xFF]) + sigs[1][2:]
        twin = (msgs, pks, sigs)
        twin_want = [bool(ref.verify(pk, m, s))
                     for m, pk, s in zip(msgs, pks, sigs)]
        qc, qc_want = by_label[MESH_QC_LABEL]
        mesh_legs = [("3 votes", three, list(map(bool, three_want)),
                      ["ladder_sharded"]),
                     ("3 votes, one forged", twin, twin_want,
                      ["ladder_sharded"]),
                     (MESH_QC_LABEL, qc, list(map(bool, qc_want)),
                      ["rlc_sharded"])]
        mesh = virtual_mesh(MESH_SHARDS, dev)
        for label, r, w, _ in mesh_legs[:2]:
            got = shv.verify_batch_sharded_pack(
                mesh, eddsa.prepare_batch(*r))()()
            if [bool(b) for b in got] != w:
                fail(f"ring mesh {label}: verify_batch_sharded_pack's mask "
                     f"differs from the host reference")
        t = time.monotonic()
        engine = service.VerifyEngine(mesh=mesh, committee=MESH_COMMITTEE,
                                      cadence=True)
        try:
            service.warmup(engine)
            service.warmup_rlc_sharded(engine)
            engine._guard = guard
            ring_rows = shv.shard_aligned_rows(engine._shapes.ladder_cap(),
                                               mesh.size)
            print(f"ring mesh boot on {mesh} with the ring (committee "
                  f"{MESH_COMMITTEE}): {time.monotonic() - t:.3f} s; the "
                  f"ring's slot rows {ring_rows} ({ring_rows // mesh.size} "
                  f"a shard)", flush=True)
            replies = _Replies()
            for i, (label, r, w, paths_want) in enumerate(mesh_legs):
                mesh.reset_launches()
                paths_before = dict(engine._sched.stats.paths)
                lat = counted(lambda: ring_check(
                    f"mesh {label}", replies,
                    ring_offer(engine, replies, 50000 + i, [(r, w)],
                               LATENCY), [(r, w)]))
                paths = sorted(p for p, n in
                               engine._sched.stats.paths.items()
                               if n > paths_before.get(p, 0))
                shards = {str(k): {n: c for n, c in v.items() if c}
                          for k, v in mesh.launches.items()}
                print(f"ring mesh {label}: {len(r[0])} records, "
                      f"{len(w) - sum(w)} invalid, path {'+'.join(paths)}, "
                      f"{lat[0]:.3f} ms, launches per shard and on the "
                      f"lead {shards}", flush=True)
                if paths != paths_want:
                    fail(f"ring mesh {label}: path {paths}, expected "
                         f"{paths_want}")
            snap = engine.stats_snapshot()
        finally:
            engine.stop()
        print(f"ring mesh OP_STATS: mesh {json.dumps(snap['mesh'])}, paths "
              f"{json.dumps(snap['paths'])}, cadence "
              f"{json.dumps({k: snap['cadence'][k] for k in ('depth', 'ticks', 'dispatch_ticks')})}",
              flush=True)
        slot = str(ring_rows // mesh.size)
        if snap["mesh"]["shard_buckets"].get(slot, 0) < 2:
            fail(f"ring mesh: the ladder requests were not armed at the "
                 f"ring's {slot} rows a shard: {snap['mesh']}")
    finally:
        guard.close()
    for name in RING_KERNELS:
        if not totals.get(name):
            fail(f"kernel {name} was not launched by the ring's requests")
    print(f"ring phase summary: "
          f"{json.dumps({k: {x: round(y, 3) for x, y in v.items() if isinstance(y, float)} for k, v in results.items()})}",
          flush=True)
    print(f"kernel launches over the ring's requests: "
          f"{ {k: v for k, v in totals.items() if v} }", flush=True)
    return totals


# ---------------------------------------------------------------------------
# Phase 13: the off-chain suite on the card
# ---------------------------------------------------------------------------

OFFCHAIN_SIZES = (20, 160, 300)
OFFCHAIN_LENGTHS = (64, 704, 6400)
# The kernels the suite's device paths must launch: K1 in the self-check
# and the per-signature program, fq12_mul in the BLS self-check, the
# pairing check's two.
OFFCHAIN_KERNELS = ("field_mul", "point_ladder", "decompress", "fq12_mul",
                    "miller_accumulate", "final_exp")


def offchain_phase(dev) -> dict:
    """Phase 13: the off-chain suite (hotstuff_tpu_torch/offchain/) on
    the card: the three self-checks, measure_single for the four schemes
    (host), measure_batch at 20, 160 and 300 with both device columns
    (it raises on any mask or verdict that is not all valid, and runs
    its self-checks first), measure_message_length.  Returns the
    launches over the phase."""
    from hotstuff_tpu_torch.offchain import bench
    from hotstuff_tpu_torch.ops import bls381, field25519, field381
    from hotstuff_tpu_torch.ops import kern

    kern.reset_launches()
    t0 = time.monotonic()
    for name, check in (("field25519.mul_selfcheck",
                         field25519.mul_selfcheck),
                        ("field381.mul_selfcheck", field381.mul_selfcheck),
                        ("bls381.selfcheck", bls381.selfcheck)):
        t = time.monotonic()
        check(device=dev)
        print(f"offchain {name} on {dev}: exact, {time.monotonic() - t:.3f}"
              f" s", flush=True)
    t = time.monotonic()
    bench.measure_single(iters=10)
    print(f"offchain single: {time.monotonic() - t:.3f} s", flush=True)
    t = time.monotonic()
    rows = bench.measure_batch(sizes=OFFCHAIN_SIZES, device=dev)
    print(f"offchain batch {OFFCHAIN_SIZES}: {time.monotonic() - t:.3f} s "
          f"(keys, signatures, host columns included)", flush=True)
    name = bench.device_name(dev)
    for row in rows:
        if row.get("device") != name or "eddsa_device_ms" not in row or \
                "bls_aggregate_device_ms" not in row:
            fail(f"offchain batch row {row}")
    bench.measure_message_length(lengths=OFFCHAIN_LENGTHS, iters=20)
    launches = dict(kern.LAUNCHES)
    for k in OFFCHAIN_KERNELS:
        if not launches[k]:
            fail(f"kernel {k} was not launched by the off-chain suite")
    print(f"offchain phase: {time.monotonic() - t0:.3f} s; kernel launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 14: a committee of the unchanged C++ nodes on the card
# ---------------------------------------------------------------------------

# The harness's local settings (``python -m hotstuff_tpu_torch.harness
# local`` with its defaults and --tpu-sidecar --warm-rlc), the run window
# cut from 30 s to 20 s.
HARNESS_LOCAL = {"nodes": 4, "rate": 100_000, "tx_size": 512,
                 "batch_size": 15_000, "batch_delay": 100, "timeout": 1_000,
                 "duration": 20}
# The kernels each leg's committee must launch: a QC of 3 votes is below
# RLC_MIN_LAUNCH and runs the per-signature program; a BLS QC is one
# pairing check.
HARNESS_KERNELS = {"ed25519": ("field_mul", "point_ladder", "decompress",
                               "point_multiples"),
                   "bls": ("miller_accumulate", "final_exp")}
# OP_STATS paths of the Ed25519 device programs (the host's is "host").
DEVICE_PATHS = ("per_sig", "rlc", "rlc_bisect")
# Sidecar log lines that mean a request was answered off the card.
HOST_ROUTE_MARKS = ("(host crypto)", "WEDGED", "degradation ladder",
                    "Traceback", "failed")


# Replica log lines that mean a certificate was verified, or a vote
# signed, off the sidecar (native/src/crypto/sidecar_client.cpp,
# crypto.cpp, consensus/core.cpp; the replicas log at INFO).
NODE_HOST_MARKS = ("circuit breaker OPEN", "lost connection to verify sidecar",
                   "in-flight sidecar request(s)",
                   "async verify transport failure",
                   "BLS signing unavailable", "protocol mismatch from sidecar")
# A replica's deadline for one sidecar request, in ms (kRecvTimeoutMs and
# kBlsRecvTimeoutMs, native/src/crypto/sidecar_client.hpp).  An Ed25519
# request answered later is verified on the host with no line at INFO.
NODE_DEADLINE_MS = {"ed25519": 1_000, "bls": 60_000}
# OP_STATS paths of the BLS requests (each runs on the card in a device
# sidecar; the sidecar log and the guard show a host answer).
BLS_PATHS = ("bls_votes", "bls_multi", "bls_sign", "bls_agg")


def free_port_block(n: int) -> int:
    """The first of ``n`` consecutive loopback ports free now, drawn at
    random below Linux's ephemeral range (32768-60999): a committee on
    the harness's fixed ports would meet another checkout's on the same
    machine."""
    import random
    import socket

    draw = random.Random(os.getpid() ^ time.time_ns())
    for _ in range(100):
        base = draw.randrange(20_000, 32_000 - n)
        socks = []
        try:
            for port in range(base, base + n):
                socks.append(socket.socket())
                socks[-1].bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    fail(f"no {n} consecutive free loopback ports")


def native_build(work: str) -> None:
    """Build native/ (the C++ node and client) once, from ``work``, the
    legs' directory: with the harness's own compile step (cmake, ninja)
    where cmake is on the PATH, so that each leg's compile step, run from
    the same path, finds nothing to do; else with scripts/native_build.sh,
    whose binaries the compile step accepts."""
    import shutil

    from hotstuff_tpu_torch.harness.commands import CommandMaker

    if shutil.which("cmake"):
        how = "the harness's compile step (cmake, ninja)"
        argv = ["/bin/sh", "-c", CommandMaker.compile()]
    else:
        how = "scripts/native_build.sh"
        argv = [os.path.join(REPO, "scripts", "native_build.sh"), "none"]
    t0 = time.monotonic()
    proc = subprocess.run(argv, cwd=work, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        fail(f"{how} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    print(f"harness: native/ built by {how} in "
          f"{time.monotonic() - t0:.3f} s", flush=True)


def forged_batch():
    """A QC of 67 votes by 67 keys with one tampered vote (signed over
    another digest), and its host mask."""
    import hashlib

    from hotstuff_tpu_torch.crypto import ref_ed25519 as ref

    def seed(tag: str, i: int) -> bytes:
        return hashlib.sha256(f"chip-smoke/harness/{tag}/{i}".encode()) \
            .digest()

    keys = [ref.generate_keypair(seed("replica", i)) for i in range(67)]
    digest = seed("block", 0)
    msgs = [digest] * 67
    pks = [pk for _, pk in keys]
    sigs = [ref.sign(sk, digest) for sk, _ in keys]
    sigs[33] = ref.sign(keys[33][0], seed("forged", 0))
    return (msgs, pks, sigs), [ref.verify(pk, m, s)
                               for m, pk, s in zip(msgs, pks, sigs)]


def node_routes(scheme: str, node_logs: dict, spans: list) -> tuple:
    """Where the committee's certificates were verified, from the
    replicas' side: each replica connected to the sidecar and logged no
    host route, its breaker stayed closed in every METRICS line; the
    sidecar shed no request, admitted at least as many as the replicas'
    verify_submit traces, and answered each within half the replicas'
    deadline (its spans: admit to reply, or to the end of a BLS
    request's device span).  A request still open at teardown is a fault
    only if the sidecar outlived its deadline.  Returns (facts, faults)."""
    from collections import defaultdict

    from hotstuff_tpu_torch.obs.sampler import parse_node_metrics

    faults, submits = [], 0
    for name, text in sorted(node_logs.items()):
        if "connected to verify sidecar" not in text:
            faults.append(f"{name} never connected to the sidecar")
        faults += [f"{name} logs {m!r}" for m in NODE_HOST_MARKS if m in text]
        breakers = {r["metrics"]["breaker"]
                    for r in parse_node_metrics(text, name)}
        if breakers != {"closed"}:
            faults.append(f"{name}: breaker states {sorted(breakers)}")
        submits += text.count("TRACE stage=verify_submit ")
    admitted, done, shed = defaultdict(list), defaultdict(list), 0
    for r in spans:
        key = (r.get("rid"), r.get("ctx"))
        if r.get("stage") == "admit":
            if r.get("ok") is False:
                shed += 1
            else:
                admitted[key].append(r["t"])
        elif r.get("stage") == "reply" or (r.get("stage") == "device"
                                          and "rid" in r):
            done[key].append(r["t"] + r.get("dur_ms", 0.0) / 1e3)
    deadline_s = NODE_DEADLINE_MS[scheme] / 1e3
    last = max((t for ts in done.values() for t in ts), default=0.0)
    waits, open_at_end, expired = [], 0, 0
    for key, starts in admitted.items():
        starts, ends = sorted(starts), sorted(done.get(key, ()))
        waits += [e - a for a, e in zip(starts, ends)]
        for a in starts[len(ends):]:
            open_at_end += 1
            expired += last - a > deadline_s
    requests = sum(len(v) for v in admitted.values())
    slowest_ms = max(waits, default=0.0) * 1e3
    waits.sort()
    facts = {"replica_verify_submits": submits, "sidecar_requests": requests,
             "shed": shed, "open_at_teardown": open_at_end,
             "slowest_request_ms": round(slowest_ms, 3),
             "request_p50_ms": round(
                 waits[len(waits) // 2] * 1e3, 3) if waits else None,
             "request_p99_ms": round(
                 waits[min(len(waits) - 1, int(0.99 * len(waits)))] * 1e3,
                 3) if waits else None}
    if shed:
        faults.append(f"{shed} request(s) shed: answered OP_BUSY, the "
                      "replica verifies on the host")
    if expired:
        faults.append(f"{expired} request(s) unanswered past the replicas' "
                      f"{NODE_DEADLINE_MS[scheme]} ms deadline")
    if requests < submits:
        faults.append(f"the sidecar admitted {requests} requests, the "
                      f"replicas submitted {submits} certificate checks")
    if slowest_ms >= NODE_DEADLINE_MS[scheme] / 2:
        faults.append(f"a request took {slowest_ms:.3f} ms, past half the "
                      f"replicas' {NODE_DEADLINE_MS[scheme]} ms deadline")
    return facts, faults


def leg_processes(work: str) -> dict:
    """The leg's processes by kind, from /proc: {pid: kind} for the
    replicas (``./node``), the clients (``./client``) and the port's
    sidecar interpreter, each running in ``work``."""
    root = os.path.realpath(work)
    out = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            if os.readlink(f"/proc/{entry}/cwd") != root:
                continue
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if argv[0] == b"./node":
            out[int(entry)] = "nodes"
        elif argv[0] == b"./client":
            out[int(entry)] = "clients"
        elif os.path.basename(argv[0]).startswith(b"python") and \
                b"hotstuff_tpu_torch.sidecar" in argv:
            out[int(entry)] = "sidecar"
    return out


def proc_cpu_s(pid: int) -> float:
    """A process's user and system CPU seconds (/proc/<pid>/stat)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def meminfo_mb() -> dict:
    """MemAvailable, Dirty and Writeback from /proc/meminfo, in MB."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemAvailable", "Dirty", "Writeback"):
                out[key] = round(int(value.split()[0]) / 1024, 1)
    return out


class HostLoad(threading.Thread):
    """Samples the chip host's load once a second while a leg runs: the
    load averages, the CPU seconds of the leg's replicas, clients and
    sidecar (every process of each kind, from /proc), and the memory's
    available, dirty and writeback MB.  ``summary`` gives the first and
    last samples that saw the sidecar up and each kind's CPU share
    (cores) between them, so that a starved run can be told from a slow
    one."""

    KINDS = ("nodes", "clients", "sidecar")

    def __init__(self, work: str):
        super().__init__(daemon=True)
        self.work = work
        self.stop = threading.Event()
        self.samples: list = []
        self.last_cpu: dict = {}   # pid -> (kind, last CPU seconds read)

    def run(self):
        while not self.stop.is_set():
            for pid, kind in leg_processes(self.work).items():
                try:
                    self.last_cpu[pid] = (kind, proc_cpu_s(pid))
                except OSError:
                    pass
            # An exited process keeps its last reading, so a kind's sum
            # never drops when a replica is killed.
            cpu = dict.fromkeys(self.KINDS, 0.0)
            for kind, secs in self.last_cpu.values():
                cpu[kind] += secs
            self.samples.append({
                "t": time.monotonic(), "loadavg": os.getloadavg(),
                "cpu_s": cpu, "mem_mb": meminfo_mb(),
                "sidecar_up": any(k == "sidecar"
                                  for k, _ in self.last_cpu.values())})
            self.stop.wait(1.0)

    def summary(self) -> dict:
        up = [x for x in self.samples if x["sidecar_up"]]
        if len(up) < 2:
            return {"samples": len(self.samples), "cpus": os.cpu_count()}
        first, last = up[0], up[-1]
        dt = last["t"] - first["t"]
        return {"cpus": os.cpu_count(),
                "loadavg_start": [round(v, 2) for v in first["loadavg"]],
                "loadavg_end": [round(v, 2) for v in last["loadavg"]],
                "cpu_share": {k: round((last["cpu_s"][k]
                                        - first["cpu_s"][k]) / dt, 3)
                              for k in self.KINDS},
                "mem_mb_start": first["mem_mb"],
                "mem_mb_end": last["mem_mb"],
                "dirty_mb_max": max(x["mem_mb"].get("Dirty", 0.0)
                                    for x in up),
                "over_s": round(dt, 3)}


# The consensus core's event kinds (native/src/consensus/core.hpp
# CoreEvent::Kind) and message kinds (messages.hpp ConsensusMessage::Kind),
# in enum order.  The node's SLOW event line prints both numbers, the
# message kind also for events that carry no message.
CORE_EVENT_KINDS = ("kMessage", "kLoopback", "kVerdict", "kTcVerdict")
CONSENSUS_MESSAGE_KINDS = ("kPropose", "kVote", "kTimeout", "kTC",
                           "kSyncRequest")


def slow_event_label(kind: int, msg_kind: int) -> str:
    """A SLOW event's label: its event kind by name, and for a kMessage
    the kind of the message it carried."""
    def name(names, i):
        return names[i] if 0 <= i < len(names) else str(i)

    label = name(CORE_EVENT_KINDS, kind)
    if kind == 0:
        label += " " + name(CONSENSUS_MESSAGE_KINDS, msg_kind)
    return label


def committee_diagnostics(node_logs: dict, client_logs: dict) -> dict:
    """What the replicas and clients logged, in counts: per replica the
    blocks it proposed with a payload, the digests they carried and the
    most in one block, the payload blocks it committed, the batches its
    mempool sealed, its view timeouts and TCs, its store's WAL
    compactions, its consensus events slower than 500 ms by event kind
    and, for a message, its kind (``slow_event_label``; count, longest
    ms), its other WARN and ERROR lines by kind (digits dropped), and
    its last METRICS line; per client the transactions it reports sent
    (its last running total) and its WARN lines by kind."""
    import re

    def kinds(text):
        seen: dict = {}
        for m in re.finditer(r"^\S+ (?:WARN|ERROR) ([^\]]+)\] (.*)$", text,
                             re.M):
            if m.group(2).startswith("SLOW event"):
                continue
            key = f"{m.group(1)}: {re.sub(r'[0-9]+', 'N', m.group(2))[:70]}"
            seen[key] = seen.get(key, 0) + 1
        return dict(sorted(seen.items(), key=lambda kv: -kv[1])[:5])

    nodes = {}
    for name, text in sorted(node_logs.items()):
        blocks = len(re.findall(r"Created B\d+$", text, re.M))
        metrics = re.findall(r"METRICS (.*)$", text, re.M)
        per_block: dict = {}
        for r in re.findall(r"Created B(\d+) -> ", text):
            per_block[r] = per_block.get(r, 0) + 1
        slow: dict = {}
        for kind, msg_kind, ms in re.findall(
                r"SLOW event kind=(-?\d+) msg_kind=(-?\d+) took (\d+) ms",
                text):
            label = slow_event_label(int(kind), int(msg_kind))
            n, top = slow.get(label, (0, 0))
            slow[label] = (n + 1, max(top, int(ms)))
        nodes[name] = {
            "proposed_blocks": blocks,
            "proposed_digests": sum(per_block.values()),
            "most_digests_a_block": max(per_block.values(), default=0),
            "committed_blocks": len(re.findall(r"Committed B\d+$", text,
                                               re.M)),
            "batches": len(re.findall(r"contains \d+ B$", text, re.M)),
            "timeouts": text.count("Timeout reached"),
            "tcs": text.count("Formed TC"),
            "wal_compactions": text.count("WAL compacted"),
            "slow_events": {k: {"n": n, "max_ms": top}
                            for k, (n, top) in slow.items()},
            "warn": kinds(text),
            "metrics": metrics[-1] if metrics else None}
    clients = {}
    for name, text in sorted(client_logs.items()):
        sent = re.findall(r"Sent (\d+) transactions", text)
        clients[name] = {"sent": max((int(x) for x in sent), default=0),
                         "warn": kinds(text)}
    return {"nodes": nodes, "clients": clients}


# Phase 14's fault leg: the harness's fault plan (hotstuff_tpu_torch/
# harness/faults.py): a replica killed and restarted on its store, then a
# wedge of the sidecar's next launch (OP_CHAOS), which the guard's ladder
# answers from the host before its crash-only reboot.  The harness's
# pre-boot check needs 13 s of window after the last event (2 x the
# replicas' 5 s default timeout + 3), so this leg keeps the local
# default's 30 s window.
FAULT_PLAN = "4 node:3 kill; 8 node:3 restart; 11 sidecar wedge"
FAULT_LEG_DURATION = 30


def fault_leg_summary(parser, events, window) -> dict:
    """The fault leg's facts: each executed event and its recovery (the
    parser's summary: the first commit after the event), the commits
    after the last event, and from the sampled OP_STATS the wedge, the
    reboot, the host answers before and after the device came back, and
    the device's requests and launches after it."""
    import math

    chaos = parser.chaos or {}
    last_wall = max((e.get("wall") or 0.0) for e in events) if events \
        else 0.0
    after = sum(1 for t in parser.commits.values() if t > last_wall)

    def host(st):
        return st.get("paths", {}).get("host", 0) + \
            st.get("guard", {}).get("host_fallback_records", 0)

    def device(st):
        return sum(v for k, v in st.get("paths", {}).items()
                   if k in DEVICE_PATHS)

    t0 = window[0]["t"]
    wedged = next((x for x in window
                   if x["stats"].get("guard", {}).get("wedges")), None)
    back = next((x for x in window if wedged is not None
                 and x["t"] > wedged["t"]
                 and x["stats"]["guard"].get("reboots")
                 and x["stats"]["guard"].get("device_ok")
                 and not x["stats"]["guard"].get("rebooting")), None)
    last = window[-1]["stats"]
    out = {"executed": len(events),
           "injected_ok": all(e.get("ok", True) for e in events),
           "events": [{"t": e.get("t"), "target": e.get("target"),
                       "action": e.get("action"),
                       "recovery_ms": e.get("recovery_ms")}
                      for e in chaos.get("events", [])],
           "max_recovery_ms": chaos.get("max_recovery_ms"),
           "slo": [{k: v.get(k) for k in ("class", "recovery_ms", "slo_ms",
                                          "ok")}
                   for v in (chaos.get("slo") or {}).get("verdicts", [])],
           "commits_after_last_event": after,
           "wedge_sampled_at_s": None if wedged is None else
           round(wedged["t"] - t0, 3),
           "device_back_sampled_at_s": None if back is None else
           round(back["t"] - t0, 3),
           "host_answers": host(last),
           "host_answers_after_device_back": None if back is None else
           host(last) - host(back["stats"]),
           "device_requests_after_device_back": None if back is None else
           device(last) - device(back["stats"]),
           "launches_after_device_back": None if back is None else
           {k: v - back["stats"]["kernels"].get(k, 0)
            for k, v in last["kernels"].items()
            if v - back["stats"]["kernels"].get(k, 0)}}
    out["recoveries_finite"] = bool(out["events"]) and all(
        isinstance(e["recovery_ms"], (int, float))
        and math.isfinite(e["recovery_ms"]) for e in out["events"])
    return out


def fault_leg_checks(line, stats, sidecar_log, port) -> None:
    """The fault leg must show every event of the plan executed, a finite
    recovery after each, commits after the last, the guard's wedge and
    reboot with the device up at teardown, and the device routing and
    launching again once it came back, with no host answer after that:
    host answers belong to the ladder's handling of the wedge."""
    chaos, guard = line["chaos"], stats.get("guard", {})
    leg = line["leg"]
    faults = []
    if chaos["executed"] != len(FAULT_PLAN.split(";")) or \
            not chaos["injected_ok"]:
        faults.append(f"{chaos['executed']} event(s) executed, injected "
                      f"ok {chaos['injected_ok']}")
    if not chaos["recoveries_finite"]:
        faults.append(f"recoveries {chaos['events']}")
    if not chaos["commits_after_last_event"]:
        faults.append("no commit after the last event")
    if not (guard.get("wedges", 0) >= 1 and guard.get("reboots", 0) >= 1
            and guard.get("device_ok") is True):
        faults.append(f"guard {guard}")
    if chaos["device_back_sampled_at_s"] is None or \
            not chaos["device_requests_after_device_back"] or \
            not chaos["launches_after_device_back"]:
        faults.append("the device did not route again after the reboot")
    if chaos["host_answers_after_device_back"]:
        faults.append(f"{chaos['host_answers_after_device_back']} host "
                      f"answer(s) after the device came back")
    if f"listening on 127.0.0.1:{port} (cuda" not in sidecar_log:
        faults.append("the sidecar did not listen on the card")
    if faults:
        fail(f"harness {leg}: {faults}")


def harness_leg(scheme: str, card: str, work: str,
                plan: str | None = None) -> dict:
    """One leg of phase 14: LocalBench (hotstuff_tpu_torch/harness) boots
    the port's sidecar on the card, a committee of HARNESS_LOCAL["nodes"]
    C++ nodes and their clients on free ports, runs the window and parses
    the logs, in ``work`` (its native/ is the repository's); the leg's
    logs stay in ``work``/logs-<leg>/.  With ``plan`` (the Ed25519 fault
    leg) the harness runs the fault plan through harness/faults.py over
    a window of FAULT_LEG_DURATION s, and fault_leg_checks judges it.
    Launches are counted over the sampled window, from the harness's
    first OP_STATS sample (logs/metrics.jsonl, taken once the committee
    has run 2 x timeout) to its last; in the Ed25519 leg they include
    the forged batch that a client sends half-way through.  Returns
    those launches (the probe's at boot)."""
    from hotstuff_tpu_torch.harness.config import (
        BenchParameters, NodeParameters)
    from hotstuff_tpu_torch.harness.local import LocalBench
    from hotstuff_tpu_torch.harness.utils import BenchError, PathMaker
    from hotstuff_tpu_torch.obs import build_run_trace, parse_spans
    from hotstuff_tpu_torch.obs.sampler import read_samples, split_samples
    from hotstuff_tpu_torch.sidecar.client import SidecarClient

    import glob
    import math
    import shutil

    cfg = HARNESS_LOCAL
    n = cfg["nodes"]
    leg = scheme if plan is None else f"{scheme} faults"
    base = free_port_block(3 * n + 1)

    class Bench(LocalBench):
        BASE_PORT = base                 # 3 ports a replica
        SIDECAR_PORT = base + 3 * n

    port = Bench.SIDECAR_PORT
    bench_params = BenchParameters({
        "faults": 0, "nodes": [n], "rate": [cfg["rate"]],
        "tx_size": cfg["tx_size"],
        "duration": cfg["duration"] if plan is None else FAULT_LEG_DURATION,
        "tpu_sidecar": True, "sidecar_warm_rlc": True, "scheme": scheme,
        "fault_plan": plan})
    node_params = NodeParameters.default(
        tpu_sidecar=f"127.0.0.1:{port}",
        scheme=None if scheme == "ed25519" else scheme)
    node_params.json["mempool"]["batch_size"] = cfg["batch_size"]
    node_params.json["mempool"]["max_batch_delay"] = cfg["batch_delay"]
    node_params.json["consensus"]["timeout_delay"] = cfg["timeout"]
    bench = Bench(bench_params, node_params)
    seen: dict = {}
    stop = threading.Event()
    batch, host_mask = forged_batch() \
        if scheme == "ed25519" and plan is None else (None, None)

    def send_forged():
        # The sidecar answers a PING once warm; the replicas boot next and
        # the harness samples after 2 x timeout: half-way through the
        # window, the batch goes.
        while not stop.is_set():
            try:
                with SidecarClient(port=port, timeout=5) as c:
                    c.ping()
                break
            except (ConnectionError, OSError):
                stop.wait(0.5)
        if stop.wait(2 * cfg["timeout"] / 1000 + cfg["duration"] / 2):
            return
        try:
            with SidecarClient(port=port, timeout=120) as c:
                before = c.stats()
                t = time.monotonic()
                seen["mask"] = c.verify_batch(*batch)
                seen["forged_ms"] = (time.monotonic() - t) * 1e3
                seen["forged_window"] = (before, c.stats())
        except Exception as e:  # noqa: BLE001 - reported as a failure
            seen["forged_error"] = repr(e)

    forger = threading.Thread(target=send_forged, daemon=True) \
        if batch is not None else None
    load = HostLoad(work)
    cwd = os.getcwd()
    t0 = time.monotonic()
    os.chdir(work)
    try:
        load.start()
        if forger is not None:
            forger.start()
        parser = bench.run()
        if forger is not None:
            forger.join(timeout=300)
        logs = PathMaker.logs_path()
        with open(PathMaker.sidecar_stats_file()) as f:
            stats = json.load(f)
        with open(PathMaker.sidecar_log_file()) as f:
            sidecar_log = f.read()
        samples, _ = read_samples(PathMaker.metrics_file())
        summary, _ = build_run_trace(logs)
        with open(PathMaker.sidecar_spans_file()) as f:
            spans, _ = parse_spans(f.read())
        node_logs, client_logs = {}, {}
        for pattern, into in (("node-*.log", node_logs),
                              ("client-*.log", client_logs)):
            for path in glob.glob(os.path.join(logs, pattern)):
                with open(path, errors="replace") as f:
                    into[os.path.basename(path)] = f.read()
        events = None
        if plan is not None:
            with open(PathMaker.chaos_events_file()) as f:
                events = json.load(f)
        kept = os.path.join(work, f"logs-{leg.replace(' ', '-')}")
        shutil.rmtree(kept, ignore_errors=True)
        shutil.copytree(logs, kept)
        log_path = os.path.join(kept, os.path.basename(
            PathMaker.sidecar_log_file()))
    except BenchError as e:
        fail(f"harness {leg}: {e} ({e.cause})")
    finally:
        stop.set()
        load.stop.set()
        bench._kill_nodes()
        # The replicas' stores grow by gigabytes at this rate; the logs
        # stay for reading.
        store_mb = 0.0
        for store in glob.glob(os.path.join(work, ".db-*")):
            for root, _, files in os.walk(store):
                store_mb += sum(os.path.getsize(os.path.join(root, f))
                                for f in files) / 1e6
            shutil.rmtree(store, ignore_errors=True)
        os.chdir(cwd)
    wall = time.monotonic() - t0

    window = [s for s in split_samples(samples)[0] if s.get("ok")]
    if len(window) < 2:
        fail(f"harness {leg}: {len(window)} OP_STATS sample(s) in the "
             f"window")
    first, last = window[0]["stats"], window[-1]["stats"]
    t0_win, t1_win = window[0]["t"], window[-1]["t"]
    launches = {k: v - first["kernels"].get(k, 0)
                for k, v in last["kernels"].items()}
    launches["probe"] = first["kernels"]["probe"]
    cons_tps, _, _ = parser._consensus_throughput()
    e2e_tps, _, _ = parser._end_to_end_throughput()
    cons_ms = parser._consensus_latency() * 1e3
    e2e_ms = parser._end_to_end_latency() * 1e3
    guard = stats.get("guard", {})
    paths = stats.get("paths", {})
    waits = stats.get("queue_wait", {})
    routes, route_faults = node_routes(scheme, node_logs, spans)
    # The sidecar's device-stage spans over the sampled window: the wall
    # its launches spent from dispatch to fetch, an upper bound on the
    # card's busy time (a BLS request's span holds its host preparation
    # too).
    device_ms = sum(r.get("dur_ms", 0.0) for r in spans
                    if r.get("stage") == "device" and t0_win <= r["t"] < t1_win)
    line = {
        "leg": leg, "card": card, "nodes": n,
        "rate": cfg["rate"], "tx_size": cfg["tx_size"],
        "duration_s": bench_params.duration, "wall_s": round(wall, 3),
        "window_s": round(t1_win - t0_win, 3),
        "device_span_share": round(device_ms / 1e3 / (t1_win - t0_win), 4),
        "commits": len(parser.commits),
        "consensus_tps": round(cons_tps, 3),
        "consensus_latency_ms": round(cons_ms, 3),
        "end_to_end_tps": round(e2e_tps, 3),
        "end_to_end_latency_ms": round(e2e_ms, 3),
        "paths": paths, "device": stats.get("device"),
        "device_ok": guard.get("device_ok"),
        "host_fallback_records": guard.get("host_fallback_records"),
        "busy_replies": guard.get("busy_replies"),
        "queue_full": stats.get("queue_full"),
        "replica_routes": routes,
        "launches": {k: v for k, v in launches.items() if v},
        "queue_wait": {c: {"p50_ms": w.get("p50_ms"), "p99_ms":
                           w.get("p99_ms"), "n": w.get("n")}
                       for c, w in waits.items()},
        "sidecar_breakdown": summary.get("sidecar"),
        "critical_path": {k: {"n": v.get("n"), "p50_ms": v.get("p50_ms"),
                              "p99_ms": v.get("p99_ms")}
                          for k, v in (summary.get("segments") or {})
                          .items()},
        "join": summary.get("join"),
        "host_load": load.summary(),
        "store_mb": round(store_mb, 1),
        "committee": committee_diagnostics(node_logs, client_logs),
    }
    if scheme == "bls":
        # The engine thread's wall in BLS requests by path over the
        # sampled window, and over the whole run (OP_STATS bls_busy).
        busy0, busy1 = first.get("bls_busy", {}), last.get("bls_busy", {})
        line["bls_busy_window"] = {
            path: {"n": v["n"] - busy0.get(path, {}).get("n", 0),
                   "ms": round(v["ms"] - busy0.get(path, {}).get("ms", 0.0),
                               3)}
            for path, v in busy1.items()}
        line["bls_busy_run"] = stats.get("bls_busy")
    if batch is not None:
        # Launches while the forged batch was in flight: its own and any
        # of the committee's that ran beside it.
        before, after = seen.get("forged_window", ({}, {}))
        line["forged_batch"] = {
            "votes": len(batch[0]), "invalid": host_mask.count(False),
            "ms": round(seen.get("forged_ms", -1.0), 3),
            "paths": {k: v - before.get("paths", {}).get(k, 0)
                      for k, v in after.get("paths", {}).items()
                      if v - before.get("paths", {}).get(k, 0)},
            "launches_in_flight": {
                k: v - before.get("kernels", {}).get(k, 0)
                for k, v in after.get("kernels", {}).items()
                if v - before.get("kernels", {}).get(k, 0)}}
    if plan is not None:
        line["plan"] = plan
        line["chaos"] = fault_leg_summary(parser, events, window)
        print(f"harness {leg}: {json.dumps(line, sort_keys=True)}",
              flush=True)
        fault_leg_checks(line, stats, sidecar_log, port)
        return launches
    print(f"harness {leg}: {json.dumps(line, sort_keys=True)}",
          flush=True)

    marks = [m for m in HOST_ROUTE_MARKS if m in sidecar_log]
    if marks:
        fail(f"harness {scheme}: the sidecar log ({log_path}) shows "
             f"{marks}")
    if f"listening on 127.0.0.1:{port} (cuda" not in sidecar_log:
        fail(f"harness {scheme}: the sidecar did not listen on the card")
    if not parser.commits or not all(
            x > 0 and math.isfinite(x)
            for x in (cons_ms, e2e_ms, cons_tps, e2e_tps)):
        fail(f"harness {scheme}: no commits or a non-finite metric")
    if guard.get("device_ok") is not True or \
            guard.get("host_fallback_records") or guard.get("busy_replies"):
        fail(f"harness {scheme}: guard {guard}")
    if any(stats.get("queue_full", {}).values()):
        fail(f"harness {scheme}: OP_STATS queue_full "
             f"{stats['queue_full']}: shed requests verify on the host")
    if route_faults:
        fail(f"harness {scheme}: verified off the sidecar: {route_faults}")
    for name in HARNESS_KERNELS[scheme]:
        if not launches.get(name):
            fail(f"harness {scheme}: the committee launched no {name}")
    if not paths or set(paths) - set(
            DEVICE_PATHS if scheme == "ed25519" else BLS_PATHS):
        fail(f"harness {scheme}: OP_STATS paths {paths}")
    if scheme == "ed25519":
        if "forged_error" in seen or seen.get("mask") != host_mask:
            fail(f"harness ed25519: the forged batch's mask "
                 f"{seen.get('mask')} ({seen.get('forged_error')}) is not "
                 f"the host mask")
    elif "BLS self-check exact" not in sidecar_log:
        fail("harness bls: no 'BLS self-check exact' in the sidecar log")
    return launches


def harness_phase(card: str) -> dict:
    """Phase 14: build native/, then the Ed25519 leg, the BLS leg and
    the Ed25519 fault leg (FAULT_PLAN) of a 4-node committee of the
    unchanged C++ nodes through the port's sidecar on the card, all in
    build/chip/harness/.  Returns the kernels' launches over the legs'
    sampled windows (the forged batch included; the probe's at the
    sidecars' boots)."""
    work = os.path.join(REPO, "build", "chip", "harness")
    os.makedirs(work, exist_ok=True)
    native = os.path.join(work, "native")
    if not os.path.islink(native):
        os.symlink(os.path.join(REPO, "native"), native)
    native_build(work)
    total: dict = {}
    for scheme, plan in (("ed25519", None), ("bls", None),
                         ("ed25519", FAULT_PLAN)):
        t0 = time.monotonic()
        for k, v in harness_leg(scheme, card, work, plan).items():
            total[k] = total.get(k, 0) + v
        leg = scheme if plan is None else f"{scheme} faults"
        print(f"harness {leg} leg: {time.monotonic() - t0:.3f} s",
              flush=True)
    return total


# ---------------------------------------------------------------------------
# Phase 15: the headline bench (python -m hotstuff_tpu_torch.bench)
# ---------------------------------------------------------------------------

# The bench's outer deadline here (HOTSTUFF_TPU_BENCH_DEADLINE, the root
# bench's variable; it cuts no work: past it the bench re-prints its
# last line with "killed" and exits 1), and this phase's own timeout.
BENCH_DEADLINE_S = 400
BENCH_TIMEOUT_S = 460

# The line's keys: the root bench's, less msm_window_chunk, plus device.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "rlc", "roofline",
              "viewchange", "sched", "chaos", "trace", "surge", "guard",
              "users", "mesh_rlc", "committee_scale", "cadence", "fleet",
              "device"}
# The mesh fields' sizes (the root bench's) and the routes each size runs
# on eight shards of the card.
BENCH_MESH = {"mesh_rlc": (("n64", "n256", "n1024"),
                           ("per_sig_sharded", "rlc_sharded")),
              "committee_scale": (("N100", "N300", "N1000"),
                                  ("per_sig_sharded", "rlc_sharded",
                                   "scan"))}
# The kernel each mesh route must launch on every shard.
MESH_ROUTE_KERNEL = {"per_sig_sharded": "point_ladder",
                     "rlc_sharded": "msm_window_accum",
                     "scan": "point_ladder"}
BENCH_BEST = {"best_on_record", "best_vs_baseline", "best_measured_at",
              "note"}

# Launches of one headline call (G = 16 sub-batches of 1024 through the
# per-signature program): each sub-batch decompresses once, runs the
# ladder and the comb, builds one multiples table, and its final compare
# launches K1 ten times.
BENCH_ROUND = {"decompress": 16, "point_ladder": 32, "point_multiples": 16,
               "field_mul": 160}


def bench_bars(line: dict) -> dict:
    """Each bar of the bench's last line: its name -> (True when it
    holds, the field that holds it)."""
    def get(*keys):
        v = line
        for k in keys:
            v = v.get(k) if isinstance(v, dict) else None
        return v

    wan = get("chaos", "wan") or {}
    bars = {"viewchange": (get("viewchange", "ok"), "viewchange"),
            "surge": (get("surge", "ok"), "surge"),
            "guard": (get("guard", "ok"), "guard"),
            "users": (get("users", "ok"), "users"),
            "chaos recovered": (get("chaos", "recovered"), "chaos"),
            "chaos slo": (get("chaos", "slo", "ok"), "chaos"),
            "wan": (bool(wan.get("roundtrip_ok") and
                         wan.get("partition_enforced") and wan.get("healed")),
                    "chaos"),
            "trace": (get("trace", "roundtrip_ok"), "trace"),
            "sched": (get("sched", "paths") == {"host": 2}, "sched"),
            "cadence": (get("cadence", "ok"), "cadence"),
            "cadence mesh slot": (
                get("cadence", "mesh_ring_slot", "bit_identical"), "cadence"),
            "fleet": (get("fleet", "ok"), "fleet")}
    # The mesh fields: every size measured on eight shards of the card
    # (the masks are checked inside: a wrong one is an error), each route
    # launching its kernel on every shard.
    for name, (sizes, routes) in BENCH_MESH.items():
        for size in sizes:
            stats = get(name, size) or {}
            shards = stats.get("launches_per_shard", {})
            bars[f"{name} {size}"] = (
                "skipped" not in stats and "error" not in stats
                and set(shards) == set(routes)
                and all(shards[r].get(str(i), {}).get(MESH_ROUTE_KERNEL[r])
                        for r in routes for i in range(8)), name)
    slot = get("cadence", "mesh_ring_slot", "launches_per_shard") or {}
    bars["cadence mesh slot launches"] = (all(
        slot.get(str(i), {}).get("point_ladder") for i in range(8)),
        "cadence")
    return bars


def fleet_bar_parts(fleet: dict) -> dict:
    """The parts of the ``fleet`` field's bar (``ok`` of
    bench.fleet_headline_probe), each True when it holds, with the flood
    verdict's reason (or the probe's error) and its two p99s."""
    fleet = fleet if isinstance(fleet, dict) else {}
    flood = fleet.get("flood") if isinstance(fleet.get("flood"), dict) \
        else {}
    return {
        "masks": fleet.get("masks_bit_identical") is True,
        "rehome": (fleet.get("rehomes") or 0) >= 1
        and fleet.get("active_endpoint") == 1,
        "no_host_fallback": fleet.get("host_fallbacks") == 0,
        "goodput": (fleet.get("live_goodput_sigs_per_s") or 0) > 0
        and (fleet.get("failover_goodput_sigs_per_s") or 0) > 0,
        "dedup": ((fleet.get("dedup") or {}).get("hit_rate") or 0) > 0,
        "flood": flood.get("ok") is True,
        "reason": (flood.get("reason") or flood.get("error")
                   or flood.get("errors") or fleet.get("error")),
        "pre_p99_ms": flood.get("pre_p99_ms"),
        "post_p99_ms": flood.get("post_p99_ms")}


def print_failed_fields(line: dict, stderr: str = "") -> list:
    """Print each field of the bench's last line that fails: those the
    bench names on stderr ("bench: failed fields: ...") and those that
    hold a failed bar, whole, and the fleet field's bar by part.
    Returns their names."""
    import re

    named = []
    for m in re.finditer(r"failed fields: (.*)", stderr or ""):
        named += [x.strip() for x in m.group(1).split(",") if x.strip()]
    held = [field for ok, field in bench_bars(line).values()
            if ok is not True]
    names = [n for n in dict.fromkeys(named + held) if n in line]
    for name in names:
        out = [f"bench failed field {name}: " + json.dumps(line[name])]
        if name == "fleet":
            out.append("bench fleet bar: "
                       + json.dumps(fleet_bar_parts(line["fleet"])))
        for text in out:
            print(text, flush=True)
            print(text, file=sys.stderr, flush=True)
    return names


def bench_phase(card: str) -> dict:
    """Phase 15: the port's headline bench on the card, in its own
    process, at full width (G x N = 16 x 1024, 20 rounds, best of 4).
    Checks its last line: the metric, a live value above 0, vs_baseline
    against the OpenSSL baseline it names, the card as nvidia-smi names
    it, every field of the root bench's probes present and passing its
    bar, and the launch tallies: the headline through decompress and
    point_ladder (exactly BENCH_ROUND a call), the rlc field through
    rlc_scalars, rlc_reduce and msm_window_accum, K0 once.  Returns the
    tallies."""
    env = dict(os.environ, HOTSTUFF_TPU_BENCH_DEADLINE=str(BENCH_DEADLINE_S))
    print(f"bench: python -m hotstuff_tpu_torch.bench, no cut (G x N = "
          f"16 x 1024, ROUNDS 20, TRIALS 4, every field's sizes and the "
          f"default stage budgets); outer deadline {BENCH_DEADLINE_S} s",
          flush=True)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "hotstuff_tpu_torch.bench"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.monotonic() - t0
    lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
    if proc.returncode != 0 or not lines:
        if lines:
            print_failed_fields(json.loads(lines[-1]), proc.stderr)
        fail(f"bench exited {proc.returncode} after {wall:.1f} s: "
             f"{proc.stderr[-3000:]}")
    line = json.loads(lines[-1])
    # A best on record (a run of these kernels in this checkout that
    # measured more) rides beside the live value, never in its place.
    if set(line) - BENCH_BEST != BENCH_KEYS:
        fail(f"bench line keys {sorted(line)}")
    if line["metric"] != "ed25519-batch-verify" or \
            line["unit"] != "sigs/sec" or not line["value"] > 0 or \
            "killed" in line:
        fail(f"bench headline {line['metric']} {line['value']}")
    dev = line["device"]
    if f"{dev['name']}, {dev['power_limit']}" != card:
        fail(f"bench device {dev['name']}, {dev['power_limit']} is not "
             f"{card}")
    base = dev["baseline"]
    if not base["library"].startswith("cryptography ") or \
            "OpenSSL" not in base["library"] or base["cores"] != 1 or \
            abs(line["vs_baseline"]
                - line["value"] / base["sigs_per_s"]) > 0.002:
        fail(f"bench vs_baseline {line['vs_baseline']} against {base}")
    rlc, roof, view = line["rlc"], line["roofline"], line["viewchange"]
    for field, sizes, key in ((rlc, (4, 16, 64, 256), "speedup"),
                              (roof, (64, 256, 1024), "sigs_per_s_chip"),
                              (view, (20, 100, 300), "speedup")):
        for n in sizes:
            if not field.get(f"n{n}", {}).get(key, 0) > 0:
                fail(f"bench n{n}: {field.get(f'n{n}')}")
    if roof["route"] != "cuda" or roof["card"] != dev["name"]:
        fail(f"bench roofline route {roof['route']} card {roof['card']}")
    chaos = line["chaos"]
    wan = chaos["wan"]
    bars = {name: ok for name, (ok, _) in bench_bars(line).items()}
    for name in ("mesh_rlc", "committee_scale", "cadence", "fleet"):
        print(f"bench {name}: " + json.dumps(line[name]), flush=True)
    if not all(v is True for v in bars.values()):
        print_failed_fields(line, proc.stderr)
        fail(f"bench probes: {bars}")
    tallies = dev["launches"]
    calls = dev["headline_calls"]
    head = tallies["headline"]
    if calls != 1 + 20 * 4 or \
            head != {k: v * calls for k, v in BENCH_ROUND.items()}:
        fail(f"bench headline launches {head} over {calls} calls")
    for name in ("rlc_scalars", "rlc_reduce", "msm_window_accum",
                 "decompress", "point_ladder"):
        if not tallies["rlc"].get(name):
            fail(f"bench rlc launched no {name}: {tallies['rlc']}")
    if tallies["probe"].get("probe") != 1:
        fail(f"bench probe launches {tallies['probe']}")
    print(f"bench: {line['value']} sigs/s, vs_baseline {line['vs_baseline']}"
          f" ({base['sigs_per_s']} verifies/s, {base['library']}, one core)"
          f" on {card}; {wall:.3f} s", flush=True)
    print("bench rlc: " + json.dumps(rlc), flush=True)
    print("bench roofline: " + json.dumps(roof), flush=True)
    print("bench viewchange: " + json.dumps(view), flush=True)
    print("bench probes: " + json.dumps(
        {"guard": line["guard"], "surge": line["surge"]["latency"],
         "users": {k: v.get("verified_goodput_sigs_per_s")
                   for k, v in line["users"].items()
                   if isinstance(v, dict)},
         "wan": wan}), flush=True)
    print("bench launches: " + json.dumps(
        {"calls": calls, **tallies, "stage_s": dev["stage_s"]}), flush=True)
    mesh: dict = {}
    for stage in ("mesh_rlc", "committee_scale", "cadence"):
        for k, v in tallies[stage].items():
            mesh[k] = mesh.get(k, 0) + v
    return {"round": {k: v // calls for k, v in head.items()},
            "rlc": tallies["rlc"], "mesh": mesh}


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "hotstuff_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(hotstuff_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # Phase 2: build the kernels.
    from hotstuff_tpu_torch.ops.kern import build

    t0 = time.monotonic()
    pieces_build = start_tower_pieces_build()
    build.load()
    print(f"kernel build and load: {time.monotonic() - t0:.3f} s "
          f"(nvcc wall {build.build_seconds}); sources "
          f"{build.source_hash()}", flush=True)
    for line in build.build_log().splitlines():
        if ("registers" in line or "spill" in line or line.startswith("==")
                or "entry function" in line):
            print("  ptxas:", line.strip(), flush=True)

    # The point-chain kernels (point_ladder, decompress, point_multiples)
    # must keep every value in registers.
    for name, rep in sorted(ptxas_report(build.build_log()).items()):
        if not name.startswith(("point_ladder", "decompress",
                                "point_multiples")):
            continue
        print(f"point-chain kernel {name}: {rep}", flush=True)
        if (rep.get("stack") or rep.get("spill_stores")
                or rep.get("spill_loads")):
            fail(f"{name} spills or uses a stack frame: {rep}")
    check_tower_registers(build.build_log())
    shuffles, depths = sass_shuffles()
    print(f"warp shuffles in each kernel's machine code (cuobjdump): "
          f"{shuffles or 'not measured'}; by loop depth: "
          f"{depths or 'not measured'}", flush=True)

    rng = np.random.default_rng(20261017)
    rows = kernel_phase(dev, rng, shuffles, depths)

    from hotstuff_tpu_torch.crypto import ref_ed25519 as ref

    t0 = time.monotonic()
    reqs = make_requests()
    want = [[ref.verify(pk, m, s) for m, pk, s in zip(*r)] for _, _, r in reqs]
    print(f"signed and host-verified {sum(len(w) for w in want)} records "
          f"in {time.monotonic() - t0:.3f} s", flush=True)
    boot, launches, per_kind = sidecar_phase(dev, reqs, want)
    for row in rows:
        name = row["name"]
        # The probe runs on the path only at the sidecar's boot; K1-K3
        # are counted over the requests.
        row["launches"] = boot[name] if name == "probe" else launches[name]
        row["launches_boot"] = boot[name]
        row["launches_per_request"] = {k: d[name]
                                       for k, d in per_kind.items()}
    profile_phase(dev, reqs, want)

    # Phases 7-8: the BLS12-381 path.
    t_bls = time.monotonic()
    bls_rows = bls_kernel_phase(dev, rng)
    pieces = tower_pieces_phase(*pieces_build)
    for row in bls_rows:
        if row["name"] == "fq12_hard_pow":
            row["tower_pieces_us"] = pieces
    t0 = time.monotonic()
    bls_reqs, bls_want = make_bls_requests()
    print(f"BLS committee keys, 135 signatures and the host reference "
          f"verdicts in {time.monotonic() - t0:.3f} s", flush=True)
    bls_launches, bls_per_request, kept = bls_sidecar_phase(
        dev, bls_reqs, bls_want)
    for row in bls_rows:
        row["launches"] = bls_launches[row["name"]]
        row["launches_per_request"] = {
            k: d.get(row["name"], 0) for k, d in bls_per_request.items()}
    bls_profile_phase(dev, kept)
    print(f"BLS phases: {time.monotonic() - t_bls:.3f} s", flush=True)

    # Phase 9: the wire, with the harness's flags.
    wire_phase(reqs, want)

    # Phase 10: the guard drill.
    t0 = time.monotonic()
    guard_phase()
    print(f"guard phase: {time.monotonic() - t0:.3f} s", flush=True)

    # Phase 11: the mesh.
    t0 = time.monotonic()
    product_row, mesh_launches, tree, mesh_reqs = mesh_phase(dev, rng)
    for row in rows + bls_rows:
        row["launches_mesh"] = mesh_launches[row["name"]]
        if row["name"] == "field_mul":
            row.update(tree)
    product_row["launches"] = product_row["launches_mesh"] = \
        mesh_launches["fq12_product"]
    print(f"mesh phase: {time.monotonic() - t0:.3f} s", flush=True)

    # Phase 12: the cadence ring.
    t0 = time.monotonic()
    ring_launches = ring_phase(dev, mesh_reqs)
    print(f"ring phase: {time.monotonic() - t0:.3f} s", flush=True)

    # Phase 13: the off-chain suite.
    t0 = time.monotonic()
    offchain_launches = offchain_phase(dev)
    print(f"offchain phase: {time.monotonic() - t0:.3f} s", flush=True)
    # Phase 14: the committee of C++ nodes through the harness.
    t0 = time.monotonic()
    harness_launches = harness_phase(card)
    print(f"harness phase: {time.monotonic() - t0:.3f} s", flush=True)
    # Phase 15: the headline bench.
    t0 = time.monotonic()
    bench_launches = bench_phase(card)
    print(f"bench phase: {time.monotonic() - t0:.3f} s", flush=True)
    for row in rows + bls_rows + [product_row]:
        row["launches_ring"] = ring_launches.get(row["name"], 0)
        row["launches_offchain"] = offchain_launches[row["name"]]
        row["launches_harness"] = harness_launches.get(row["name"], 0)
        row["launches_bench_round"] = bench_launches["round"].get(
            row["name"], 0)
        row["launches_bench_rlc"] = bench_launches["rlc"].get(row["name"], 0)
        row["launches_bench_mesh"] = bench_launches["mesh"].get(
            row["name"], 0)

    print(json.dumps({"kernels": rows + bls_rows + [product_row]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
