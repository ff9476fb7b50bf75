"""Admission caps per class, sized from the deployment: the port of
hotstuff_tpu/sidecar/sched/scheduler.py's ``size_queue_caps``.

The port's engine (sidecar/service.py) keeps two bounded FIFO queues and
no scheduler object yet (pad-fill, carry-over, surge admission and the
tenant lanes are ROADMAP Queue A item 4); what it takes from the
reference's scheduler is how large each queue may grow, in signature
records, before a request is answered OP_BUSY.
"""

from __future__ import annotations

import os

# The STATIC defaults; deployments that know their committee size /
# client rate get caps sized from those parameters instead, and the
# HOTSTUFF_TPU_{LATENCY,BULK}_QUEUE_CAP_SIGS env vars override both.
_DEFAULT_LATENCY_CAP_SIGS = 64 * 1024
_DEFAULT_BULK_CAP_SIGS = 128 * 1024

# Per-replica async verify pipeline depth the latency sizing assumes --
# the C++ node's MAXIMUM adaptive in-flight budget (TpuVerifier::
# kInflightBudgetMax; the budget only ever shrinks below this).
_INFLIGHT_PER_REPLICA = 64


def _env_cap(name: str):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        v = int(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, v))


def size_queue_caps(committee: int | None = None,
                    client_rate: int | None = None):
    """``(latency_cap_sigs, bulk_cap_sigs)`` for a deployment.

    Latency demand scales with the committee: on the shared local
    testbed every replica verifies every certificate, so a worst-case
    burst is ``committee`` replicas x ``_INFLIGHT_PER_REPLICA`` pipelined
    requests x ``quorum`` signatures each.  Bulk demand scales with the
    client transaction rate: the cap admits ~2 s of arrivals, past which
    shedding to the client's host path beats an ever-older backlog.
    Both are clamped to [default/4, 16x default] so a typo'd parameter
    cannot starve or balloon the sidecar, and the explicit env
    overrides (HOTSTUFF_TPU_LATENCY_QUEUE_CAP_SIGS /
    HOTSTUFF_TPU_BULK_QUEUE_CAP_SIGS) win over everything."""
    lat = _env_cap("HOTSTUFF_TPU_LATENCY_QUEUE_CAP_SIGS")
    if lat is None:
        if committee and committee > 1:
            quorum = 2 * committee // 3 + 1
            lat = _clamp(committee * quorum * _INFLIGHT_PER_REPLICA,
                         _DEFAULT_LATENCY_CAP_SIGS // 4,
                         16 * _DEFAULT_LATENCY_CAP_SIGS)
        else:
            lat = _DEFAULT_LATENCY_CAP_SIGS
    blk = _env_cap("HOTSTUFF_TPU_BULK_QUEUE_CAP_SIGS")
    if blk is None:
        if client_rate and client_rate > 0:
            blk = _clamp(2 * client_rate,
                         _DEFAULT_BULK_CAP_SIGS // 4,
                         16 * _DEFAULT_BULK_CAP_SIGS)
        else:
            blk = _DEFAULT_BULK_CAP_SIGS
    return lat, blk
