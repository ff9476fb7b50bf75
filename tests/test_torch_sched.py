"""The port's verify scheduler (hotstuff_tpu_torch/sidecar/sched) against
the JAX package's (hotstuff_tpu/sidecar/sched), differentially, on the
CPU, with tolerance 0:

* one seeded trace of offers (classes, tenants, sizes, BLS requests,
  duplicate records) and pack observations, with ``monotonic`` patched
  to one fake clock in both packages, gives the same admissions and
  sheds, the same launches (request ids, kind, class, pad-fill), the
  same ``retry_after_ms`` and bulk derate after every step, and the same
  OP_STATS snapshot; the same for ``next_tick`` quotas;
* the scheduler-level cases of tests/test_verifysched.py and
  tests/test_surge.py (strict priority, carry-over, oversized requests,
  pad-fill under sustained latency load and on deduped records, queue
  caps, tenant lanes, bulk before latency, the derated cap, retry-after,
  the admission controller's windows and the stats sections) run on
  both packages and return the same results.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from hotstuff_tpu.sidecar import sched as jsched
from hotstuff_tpu.sidecar.sched import classes as jclasses
from hotstuff_tpu.sidecar.sched import scheduler as jscheduler
from hotstuff_tpu.sidecar.sched import surge as jsurge
from hotstuff_tpu_torch.sidecar import sched as psched
from hotstuff_tpu_torch.sidecar.sched import classes as pclasses
from hotstuff_tpu_torch.sidecar.sched import scheduler as pscheduler
from hotstuff_tpu_torch.sidecar.sched import surge as psurge

PACKAGES = {"reference": (jsched, jclasses, jscheduler, jsurge),
            "port": (psched, pclasses, pscheduler, psurge)}


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    """One fake clock for both packages' module-level ``monotonic``."""
    c = FakeClock()
    for _, classes, scheduler, _ in PACKAGES.values():
        monkeypatch.setattr(classes, "monotonic", c)
        monkeypatch.setattr(scheduler, "monotonic", c)
    return c


def _scheduler(pkg, clock, **kw):
    sched, _, _, surge = PACKAGES[pkg]
    return sched.Scheduler(stats=sched.SchedStats(clock=clock),
                           admission=surge.AdmissionController(clock=clock),
                           **kw)


def _req(n, tag, dup_of=None):
    """A verify request of n records with distinct msg bytes (or the
    records of request ``dup_of``: the same QC from another replica)."""
    base = tag if dup_of is None else dup_of
    msgs = [b"%16d|%16d" % (base, i) for i in range(n)]
    return SimpleNamespace(request_id=tag, msgs=msgs, pks=[b"p" * 32] * n,
                           sigs=[b"s" * 64] * n)


def _bls(tag):
    return SimpleNamespace(request_id=tag, msg=b"m" * 32, pks=[b"k"] * 3,
                           sigs=[b"s"] * 3)


def _launch(launch):
    if launch is None:
        return None
    return (launch.kind, launch.cls, launch.fill_count,
            [p.request.request_id for p in launch.items],
            [p.tenant for p in launch.items])


def _trace(seed: int, steps: int, flood: int = 0):
    """A seeded workload: offers of both classes from four tenants,
    BLS requests, duplicated QCs, pack observations, clock steps and
    launch / tick requests; the first ``flood`` steps only offer, so
    the queues fill up to their class and tenant caps."""
    rng = np.random.default_rng(seed)
    ops = []
    for tag in range(1, steps + 1):
        kind = rng.choice(["lat", "bulk", "bls", "dup", "pack", "launch",
                           "tick", "launch"][:4 if tag <= flood else 8])
        tenant = [None, "a", "b", "c"][rng.integers(0, 4)]
        if kind == "lat":
            n = int(rng.integers(1, 300) if rng.random() < 0.5
                    else rng.integers(1, 12))
            ops.append(("offer", _req(n, tag), "latency", False, tenant))
        elif kind == "bulk":
            ops.append(("offer", _req(int(rng.choice([1, 2, 3, 4, 5, 7, 13,
                                                      600, 1500, 4000])),
                                      tag),
                        "bulk", False, tenant))
        elif kind == "bls":
            ops.append(("offer", _bls(tag), "latency", True, tenant))
        elif kind == "dup":
            ops.append(("offer", _req(67, tag, dup_of=7), "latency", False,
                        tenant))
        elif kind == "pack":
            ops.append(("pack", float(rng.uniform(0.001, 0.02)),
                        bool(rng.integers(0, 2))))
        elif kind == "tick":
            ops.append(("tick", int(rng.choice([8, 64, 512]))))
        else:
            ops.append(("launch",))
        ops.append(("clock", float(rng.exponential(0.05))))
    return ops


def _run_trace(pkg, clock, ops, **kw):
    s = _scheduler(pkg, clock, **kw)
    out = []
    for op in ops:
        if op[0] == "offer":
            _, req, cls, is_bls, tenant = op
            out.append(("offer", s.offer(req, lambda m: None, cls=cls,
                                         is_bls=is_bls, tenant=tenant)))
        elif op[0] == "pack":
            s.stats.note_pack(op[1], op[2])
        elif op[0] == "tick":
            out.append(("tick", _launch(s.next_tick(op[1]))))
        elif op[0] == "launch":
            out.append(("launch", _launch(s.next_launch(block=False))))
        else:
            clock.t += op[1]
        out.append((s.retry_after_ms("latency"), s.retry_after_ms("bulk"),
                    s.admission.bulk_derate(),
                    s.queued_sigs("latency"), s.queued_sigs("bulk")))
    while (launch := s.next_launch(block=False)) is not None:
        out.append(("drain", _launch(launch)))
    out.append(("caps", s.queue_caps(), s.tenant_caps(),
                s.tenant_occupancy()))
    out.append(("stats", s.stats.snapshot()))
    return out


@pytest.mark.parametrize("seed,flood,caps", [
    (1, 0, {}),
    (2, 0, {"latency_cap_sigs": 600, "bulk_cap_sigs": 2000}),
    (3, 0, {"latency_cap_sigs": 300, "bulk_cap_sigs": 5000,
            "committee": 4}),
    (4, 0, {"latency_cap_sigs": 2000, "bulk_cap_sigs": 1200,
            "committee": 100}),
    (5, 150, {"latency_cap_sigs": 3000, "bulk_cap_sigs": 9000}),
    (6, 150, {"latency_cap_sigs": 40000, "bulk_cap_sigs": 20000,
              "committee": 10}),
])
def test_seeded_trace_gives_the_reference_launches(clock, seed, flood,
                                                   caps):
    ops = _trace(seed, 400, flood)
    t0 = clock.t
    want = _run_trace("reference", clock, ops, **caps)
    clock.t = t0
    got = _run_trace("port", clock, ops, **caps)
    assert [k for k, *_ in want if k in ("offer",)].count("offer") > 100
    assert got == want
    sheds = want[-1][1]["queue_full"]
    if caps:
        assert sum(sheds.values()) > 0      # the caps were exercised


def test_admission_derate_series_equals_the_reference(clock):
    """The surge controller's derate series over one seeded stream of
    pack observations, ring occupancy samples and clock steps."""
    rng = np.random.default_rng(11)
    ctrls = {pkg: PACKAGES[pkg][3].AdmissionController(clock=clock)
             for pkg in PACKAGES}
    series = {pkg: [] for pkg in PACKAGES}
    steps = []
    for _ in range(600):
        r = rng.random()
        if r < 0.6:
            steps.append(("pack", float(rng.uniform(0, 0.02)),
                          bool(rng.random() < 0.4)))
        elif r < 0.7:
            steps.append(("ring", int(rng.integers(0, 5)), 4))
        elif r < 0.8:
            steps.append(("launch", int(rng.integers(1, 2048))))
        else:
            steps.append(("clock", float(rng.exponential(0.5))))
    for pkg, ctrl in ctrls.items():
        clock.t = 1000.0
        for step in steps:
            if step[0] == "pack":
                ctrl.note_pack(step[1], step[2])
            elif step[0] == "ring":
                ctrl.note_ring_occupancy(step[1], step[2])
            elif step[0] == "launch":
                ctrl.note_launch(step[1])
            else:
                clock.t += step[1]
            series[pkg].append((ctrl.bulk_derate(), ctrl.recent_overlap(),
                                ctrl.retry_after_ms("bulk", 3000),
                                ctrl.retry_after_ms("latency", 40)))
        series[pkg].append(ctrl.snapshot())
    assert series["port"] == series["reference"]
    assert series["port"][-1]["derate"]["engagements"] > 0


# ---------------------------------------------------------------------------
# The scheduler-level cases of tests/test_verifysched.py and test_surge.py,
# each run on both packages.
# ---------------------------------------------------------------------------

def _priority(pkg, clock):
    s = _scheduler(pkg, clock)
    for i in range(3):
        assert s.offer(_req(600, 100 + i), None, cls="bulk")
    assert s.offer(_req(100, 1), None, cls="latency")
    return [_launch(s.next_launch(block=False)) for _ in range(5)]


def _carry_over(pkg, clock):
    s = _scheduler(pkg, clock)
    for n, tag in ((700, 1), (700, 2), (100, 3)):
        s.offer(_req(n, tag), None, cls="bulk")
    out = [_launch(s.next_launch(block=False)) for _ in range(3)]
    return out, s.stats.snapshot()["carries"], s.shapes.launch_cap


def _oversized(pkg, clock):
    s = _scheduler(pkg, clock)
    s.offer(_req(3000, 9), None, cls="bulk")
    launch = s.next_launch(block=False)
    return launch.total_sigs, s.stats.snapshot()["coalesce_hist"]


def _pad_fill_sustained(pkg, clock):
    s = _scheduler(pkg, clock)
    for i in range(10):
        assert s.offer(_req(2, 200 + i), None, cls="bulk")
    launches = []
    for i in range(12):
        s.offer(_req(4, i), None, cls="latency")
        launches.append(_launch(s.next_launch(block=False)))
        if s.queued_sigs("bulk") == 0:
            break
    snap = s.stats.snapshot()
    assert snap["bulk_fill_sigs"] == 20
    return launches, snap["bulk_fill_sigs"], snap["pad_waste_sigs"]


def _pad_fill_dedup(pkg, clock):
    s = _scheduler(pkg, clock)
    s.offer(_req(5, 1), None, cls="latency")
    s.offer(_req(5, 1), None, cls="latency")        # the same records
    for i in range(3):
        s.offer(_req(3, 300 + i), None, cls="bulk")
    launch = s.next_launch(block=False)
    assert launch.fill_count == 1 and launch.total_sigs == 13
    # unique 5 -> room 3 exactly: a 4-signature bulk request stays out,
    # a 3-signature one rides.
    edge = []
    for n in (4, 3):
        s = _scheduler(pkg, clock)
        s.offer(_req(5, 2), None, cls="latency")
        s.offer(_req(n, 400), None, cls="bulk")
        edge.append(_launch(s.next_launch(block=False)))
    assert [e[2] for e in edge] == [0, 1]
    return _launch(launch), edge


def _queue_full(pkg, clock):
    s = _scheduler(pkg, clock, bulk_cap_sigs=8)
    out = [s.offer(_req(8, 1), None, cls="bulk"),
           s.offer(_req(4, 2), None, cls="bulk"),
           s.offer(_req(4, 3), None, cls="latency")]
    snap = s.stats.snapshot()
    assert out == [True, False, True]
    return out, snap["queue_full"], snap["admitted"], snap["surge"]


def _tenant_lanes(pkg, clock):
    """A flooding tenant sheds on its own share while another keeps
    admitting, and the lanes drain in deficit round-robin order."""
    s = _scheduler(pkg, clock, latency_cap_sigs=4096, bulk_cap_sigs=4096)
    out = [s.offer(_req(100, 9), None, cls="bulk", tenant="victim")]
    for i in range(12):
        out.append(s.offer(_req(700, 10 + i), None, cls="bulk",
                           tenant="greedy"))
    for i in range(3):
        out.append(s.offer(_req(100, 50 + i), None, cls="bulk",
                           tenant="victim"))
    # the greedy tenant sheds on its share (2048), not the class cap
    assert out[1:4] == [True, True, False]
    occupancy = s.tenant_occupancy()
    launches = [_launch(s.next_launch(block=False)) for _ in range(6)]
    snap = s.stats.snapshot()
    assert "victim" in occupancy["bulk"] and all(out[-3:])
    return out, occupancy, launches, snap["tenants"], s.tenant_caps()


def _bulk_before_latency(pkg, clock):
    s = _scheduler(pkg, clock, latency_cap_sigs=32, bulk_cap_sigs=1024)
    out = [s.offer(_req(32, 1), None, cls="latency"),
           s.offer(_req(32, 2), None, cls="latency"),
           s.offer(_req(8, 3), None, cls="bulk")]
    snap = s.stats.snapshot()["surge"]
    assert out == [True, False, False]
    assert snap["bulk_before_latency_sheds"] == 1
    clock.t += jsurge.LATENCY_PRESSURE_S + 0.5   # the window closes
    out.append(s.offer(_req(8, 4), None, cls="bulk"))
    return out, snap, s.stats.snapshot()["surge"]


def _derated_cap(pkg, clock):
    s = _scheduler(pkg, clock, latency_cap_sigs=1024, bulk_cap_sigs=1000)
    for _ in range(64):
        s.admission.note_pack(0.01, hidden=False)
    out = [s.offer(_req(100, i), None, cls="bulk") for i in (1, 2, 3)]
    engaged = s.stats.snapshot()["surge"]["derate"]
    for _ in range(64):
        s.admission.note_pack(0.01, hidden=True)
    out.append(s.offer(_req(100, 4), None, cls="bulk"))
    assert out == [True, True, False, True]
    return out, engaged


def _retry_after(pkg, clock):
    s = _scheduler(pkg, clock, latency_cap_sigs=1024, bulk_cap_sigs=4096)
    out = [s.retry_after_ms("bulk"), s.retry_after_ms("latency")]
    for i in range(6):
        s.offer(_req(500, i), None, cls="bulk")
        clock.t += 0.1
        out.append(_launch(s.next_launch(block=False)))
        out.append((s.retry_after_ms("bulk"), s.retry_after_ms("latency")))
    for i in range(8):
        s.offer(_req(400, 100 + i), None, cls="bulk")
        out.append(s.retry_after_ms("bulk"))
    return out


def _admission_windows(pkg, clock):
    """The derate's hysteresis count, its time-bounded window and the
    fairness counter's pressure window, as test_surge.py drives them."""
    surge = PACKAGES[pkg][3]
    adm = surge.AdmissionController(clock=clock)
    out = []
    for hidden, n in ((False, 7), (False, 64), (True, 64), (False, 64),
                      (True, 32)):
        for _ in range(n):
            adm.note_pack(0.01, hidden=hidden)
        out.append((adm.bulk_derate(), adm.snapshot()["derate"]))
    clock.t += surge.PACK_WINDOW_S + 1.0
    out.append((adm.recent_overlap(), adm.bulk_derate()))
    adm.note_latency_shed()
    adm.note_admitted("bulk")
    clock.t += 2.0
    adm.note_admitted("bulk")
    out.append(adm.snapshot())
    return out


def _stats_sections(pkg, clock):
    """The mesh, scan and pipeline sections (the rolling window and the
    lifetime totals) of SchedStats."""
    sched = PACKAGES[pkg][0]
    stats = sched.SchedStats(clock=clock)
    stats.note_mesh_launch([4, 4, 8, None])
    stats.note_scan_launch(16, 16384, 15)
    stats.note_scan_launch(4, 300, 0)
    for _ in range(8):
        stats.note_pack(0.010, hidden=False)
    first = stats.snapshot()
    clock.t += 31.0
    for _ in range(4):
        stats.note_pack(0.010, hidden=True)
    stats.note_bulk_source(True, 5)
    stats.note_bulk_source(False, 7)
    return first, stats.snapshot()


@pytest.mark.parametrize("case", [
    _priority, _carry_over, _oversized, _pad_fill_sustained,
    _pad_fill_dedup, _queue_full, _tenant_lanes, _bulk_before_latency,
    _derated_cap, _retry_after, _admission_windows, _stats_sections],
    ids=lambda f: f.__name__.strip("_"))
def test_scheduler_case_equals_the_reference(clock, case):
    t0 = clock.t
    want = case("reference", clock)
    clock.t = t0
    got = case("port", clock)
    assert got == want


def test_next_tick_quotas_equal_the_reference(clock):
    """Cadence ticks: the coalesce run capped at the quota (never above
    the launch cap), with the same strict priority and pad-fill."""
    out = {}
    for pkg in PACKAGES:
        clock.t = 1000.0
        s = _scheduler(pkg, clock)
        for i in range(6):
            s.offer(_req(100, i), None, cls="bulk", tenant=f"t{i % 2}")
        s.offer(_req(20, 50), None, cls="latency")
        s.offer(_req(3, 51), None, cls="bulk")
        out[pkg] = [_launch(s.next_tick(q)) for q in (64, 128, 256, 4096,
                                                      64, 64, 64)]
        out[pkg].append(_launch(s.next_tick(64, timeout=0.0)))
    assert out["port"] == out["reference"]
    assert out["port"][0][1] == "latency"


def test_shape_registry_one_card_capacity_and_routes():
    """The port's registry: the reference's one-card padded capacity,
    its launch cap, and the routes the port's kernels serve (RLC for
    16..1024 unique records, per signature elsewhere, host for a
    host-crypto engine)."""
    ref, port = jsched.ShapeRegistry(), psched.ShapeRegistry()
    for n in list(range(1, 70)) + [100, 1000, 1024, 1025, 3000, 16384]:
        assert port.bucket_capacity(n) == ref.bucket_capacity(n), n
        want = psched.PATH_RLC if 16 <= n <= 1024 else psched.PATH_PER_SIG
        assert port.route(n) == want
    assert port.launch_cap == ref.launch_cap
    host = psched.ShapeRegistry(use_host=True)
    assert host.route(64) == psched.PATH_HOST and host.bucket_capacity(5) == 5
    assert psched.ShapeRegistry(committee=100).snapshot() == {
        "launch_cap": 1024, "committee": 100}


def _ids(launch):
    return [p.request.request_id for p in launch.items]


@pytest.mark.parametrize("refill", [False, True],
                         ids=["backlogged", "refilled"])
def test_host_registry_launches_one_request_least_served_first(clock,
                                                                 refill):
    """A host registry (the host path verifies record by record) launches
    one request at a time and serves the least recently served tenant
    first: a victim that queues behind a greedy tenant's backlog, or
    behind a greedy lane that emptied and refilled first, waits for no
    more than the request in progress.  A device registry still
    coalesces the backlog into one launch, as the reference does."""
    def run(host):
        s = _scheduler("port", clock,
                       shapes=psched.ShapeRegistry(use_host=host))
        for i in range(1 if refill else 3):
            s.offer(_req(32, 1 + i), None, tenant="greedy")
        first = _ids(s.next_launch(block=False))
        if refill:
            s.offer(_req(32, 2), None, tenant="greedy")
            s.offer(_req(32, 3), None, tenant="greedy")
        s.offer(_req(4, 9), None, tenant="victim")
        rest = []
        while (launch := s.next_launch(block=False)) is not None:
            rest.append(_ids(launch))
        return [first] + rest

    assert run(host=True) == [[1], [9], [2], [3]]
    assert run(host=False) == ([[1], [2, 3, 9]] if refill
                               else [[1, 2, 3], [9]])


def test_host_registry_ticks_still_fill_their_quota(clock):
    """Cadence ticks keep coalescing on a host registry: a tick drains
    the backlog up to its quota, least recently served tenant first."""
    s = _scheduler("port", clock, shapes=psched.ShapeRegistry(use_host=True))
    for i in range(3):
        s.offer(_req(32, 1 + i), None, tenant="greedy")
    s.offer(_req(4, 9), None, tenant="victim")
    assert _ids(s.next_tick(80)) == [1, 9, 2]
    assert _ids(s.next_tick(80)) == [3]
