"""The port's verify engine on a mesh of CPU shards, against the
reference's engine logic:

* the mesh warm-ups (``warmup``, ``warmup_rlc_sharded``) make the marks
  the reference's (``_warmup``, ``_warmup_rlc_sharded``) make for the
  same committee, warm ceiling and scan ceiling (both run with their
  sharded programs replaced by an all-valid stand-in, so the shapes of
  a 1000-node committee cost nothing), and every route, capacity and
  cap equals the reference ShapeRegistry's for those marks;
* ``VerifyEngine(mesh=virtual_mesh(4, "cpu"))`` after the real mesh
  warm-up routes a QC of 16 votes ``rlc_sharded``, 3 votes
  ``ladder_sharded`` and a bulk backlog ``scan_sharded``, with masks
  equal to ``verify_batch``'s, and OP_STATS ``mesh`` and ``scan`` hold
  the reference's keys;
* ``python -m hotstuff_tpu_torch.sidecar --device cpu --mesh 4
  --warm-rlc-sharded`` boots and answers a QC; ``--mesh 4`` without
  ``--device cpu`` exits on a host with no card with the reference's
  device-count error; ``--cadence`` without ``--device cpu`` raises
  the no-card error there.
"""

from __future__ import annotations

import os
import queue
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hotstuff_tpu.parallel import sharded_verify as jshv
from hotstuff_tpu.sidecar import sched as jsched
from hotstuff_tpu.sidecar import service as jservice
from hotstuff_tpu.sidecar.sched.stats import SchedStats
from hotstuff_tpu_torch.crypto import eddsa as D
from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
from hotstuff_tpu_torch.parallel import sharded_verify as pshv
from hotstuff_tpu_torch.parallel.mesh import virtual_mesh
from hotstuff_tpu_torch.sidecar import protocol as proto
from hotstuff_tpu_torch.sidecar import sched, service
from hotstuff_tpu_torch.sidecar.client import SidecarClient

from conftest import REPO, free_port


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _all_valid(mesh, prep, **kw):
    n = len(prep["host_ok"])
    return lambda: (lambda: np.ones((n,), bool))


class _RefEngine:
    """What the reference's warm-ups read and write of an engine."""
    compile_tracker = None

    def __init__(self, n_devices, committee):
        self._shapes = jsched.ShapeRegistry(n_devices=n_devices,
                                            committee=committee)
        self._mesh = object()

    def _verify(self, msgs, pks, sigs):
        return np.ones((len(msgs),), bool)

    def enable_bulk(self):
        self._shapes.enable_bulk(jservice.MAX_COALESCED)


def _reference_marks(monkeypatch, n_devices, committee, warm_max,
                     scan_chunks):
    for name in ("verify_batch_sharded_pack", "verify_rlc_sharded_pack",
                 "verify_sharded_chunked_pack"):
        monkeypatch.setattr(jshv, name, _all_valid)
    eng = _RefEngine(n_devices, committee)
    jservice._warmup(eng, warm_max)
    jservice._warmup_rlc_sharded(eng, warm_max, scan_chunks=scan_chunks)
    return eng._shapes


def _port_marks(monkeypatch, n_devices, committee, warm_max, scan_chunks):
    for name in ("verify_batch_sharded_pack", "verify_rlc_sharded_pack",
                 "verify_sharded_chunked_pack"):
        monkeypatch.setattr(pshv, name, _all_valid)
    eng = service.VerifyEngine(mesh=virtual_mesh(n_devices, "cpu"),
                               committee=committee)
    try:
        service.warmup(eng, warm_max)
        service.warmup_rlc_sharded(eng, warm_max, scan_chunks=scan_chunks)
    finally:
        eng.stop()
    return eng._shapes


def _assert_same_routes(reg, refreg):
    for n in list(range(1, 1100)) + list(range(1100, 20000, 97)):
        assert reg.route(n) == refreg.route(n), n
        assert reg.bucket_capacity(n) == refreg.bucket_capacity(n), n
        assert reg.scan_shape_of(n) == refreg.scan_shape_of(n), n
    assert reg.launch_cap == refreg.launch_cap
    assert reg.ladder_cap() == refreg.ladder_cap()
    want = refreg.snapshot()
    for key in ("buckets", "chunks", "rlc_buckets"):
        want.pop(key)
    assert reg.snapshot() == want


@pytest.mark.parametrize("n_devices,committee,warm_max,scan_chunks", [
    (4, 1000, 1024, None), (4, None, 16, 2), (8, 100, 1024, 4),
    (3, None, 64, None)])
def test_mesh_warmup_marks_and_routes_equal_the_reference(
        monkeypatch, n_devices, committee, warm_max, scan_chunks):
    refreg = _reference_marks(monkeypatch, n_devices, committee, warm_max,
                              scan_chunks)
    reg = _port_marks(monkeypatch, n_devices, committee, warm_max,
                      scan_chunks)
    assert reg.rlc_shard_buckets and reg.mesh_chunks
    _assert_same_routes(reg, refreg)


# ---------------------------------------------------------------------------
# The engine on four CPU shards, warmed for real
# ---------------------------------------------------------------------------

WARM_MAX, SCAN_CHUNKS = 16, 2


@pytest.fixture(scope="module")
def engine():
    eng = service.VerifyEngine(mesh=virtual_mesh(4, "cpu"))
    service.warmup(eng, WARM_MAX)
    service.warmup_rlc_sharded(eng, WARM_MAX, scan_chunks=SCAN_CHUNKS)
    yield eng
    eng.stop()


def _records(n, tag, forged=(), noncanonical=()):
    keys = [ref.generate_keypair(bytes([tag, i]) * 16) for i in range(n)]
    msgs = [bytes([tag + 1, i]) * 16 for i in range(n)]
    sigs = [ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    for i in forged:
        sigs[i] = ref.sign(keys[i][0], b"forged")
    for i in noncanonical:
        s = int.from_bytes(sigs[i][32:], "little") + D.L
        sigs[i] = sigs[i][:32] + s.to_bytes(32, "little")
    return msgs, [pk for _, pk in keys], sigs


def test_warmed_engine_routes_equal_the_reference(engine, monkeypatch):
    refreg = _reference_marks(monkeypatch, 4, None, WARM_MAX, SCAN_CHUNKS)
    _assert_same_routes(engine._shapes, refreg)


def test_mesh_routes_give_the_one_card_masks(engine):
    """Each route's mask equals verify_batch's; paths as the registry
    says, and OP_STATS counts the mesh and scan launches."""
    replies: queue.Queue = queue.Queue()
    cases = [("rlc_sharded", False, _records(16, 10)),
             ("ladder_sharded", False, _records(3, 20, forged=(1,))),
             ("scan_sharded", True, _records(32, 30, forged=(5,),
                                             noncanonical=(9,)))]
    for i, (path, bulk, (msgs, pks, sigs)) in enumerate(cases):
        assert engine._shapes.route(len(msgs)) == path
        before = dict(engine._sched.stats.paths)
        assert engine.submit(proto.VerifyRequest(i, msgs, pks, sigs),
                             replies.put,
                             cls=sched.BULK if bulk else sched.LATENCY)
        got = replies.get(timeout=300)
        assert got == D.verify_batch(msgs, pks, sigs, device="cpu").tolist()
        assert engine._sched.stats.paths[path] == before.get(path, 0) + 1
    stats = engine.stats_snapshot()
    ref_stats = SchedStats().snapshot()
    for section in ("mesh", "scan"):
        assert set(stats[section]) == set(ref_stats[section])
    # The scan launch counts in ``scan`` only, as in the reference.
    assert stats["mesh"]["sharded_launches"] == 2
    assert stats["mesh"]["shard_buckets"] == {"2": 1, "4": 1}
    assert stats["scan"] == {"launches": 1, "sigs": 32,
                             "chunk_hist": {"2": 1}, "slices_avoided": 0}
    assert stats["shapes"]["n_devices"] == 4
    assert set(stats["kernels_by_shard"]) == {"0", "1", "2", "3", "lead"}


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

# The sidecar's own main() with the scan's chunk-count ceiling lowered
# to 2 in its process, as the reference's tests pass ``scan_chunks`` to
# its warm-up: the full scan warm-up is minutes of plain versions here.
BOOT_WITH_TWO_SCAN_CHUNKS = (
    "import sys\n"
    "from hotstuff_tpu_torch.sidecar import sched, service\n"
    "sched.MESH_SCAN_CHUNKS = 2\n"
    "service.main(sys.argv[1:])\n")


def test_cpu_mesh_sidecar_boots_and_answers_a_qc(tmp_path):
    port = free_port()
    log_path = tmp_path / "sidecar.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", BOOT_WITH_TWO_SCAN_CHUNKS, "--port",
             str(port), "--device", "cpu", "--mesh", "4",
             "--warm-rlc-sharded", "--warm", "8"],
            cwd=REPO, stdout=log, stderr=log,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        deadline = time.monotonic() + 300
        while True:
            try:
                with SidecarClient(port=port, timeout=10) as c:
                    assert c.ping()
                break
            except (ConnectionError, OSError):
                assert proc.poll() is None, log_path.read_text()
                assert time.monotonic() < deadline, log_path.read_text()
                time.sleep(0.5)
        msgs, pks, sigs = _records(3, 40, forged=(2,))
        with SidecarClient(port=port, timeout=300) as c:
            assert c.verify_batch(msgs, pks, sigs) == [True, True, False]
            stats = c.stats()
        assert stats["paths"] == {"ladder_sharded": 1}
        assert stats["shapes"]["n_devices"] == 4
        assert stats["shapes"]["rlc_shard_buckets"] == [2]
        assert stats["shapes"]["mesh_chunks"] == [2]
        assert stats["device"] == "Mesh(cpu, cpu, cpu, cpu)"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_mesh_without_cards_exits_with_the_device_count_error():
    proc = subprocess.run(
        [sys.executable, "-m", "hotstuff_tpu_torch.sidecar", "--mesh", "4",
         "--warm-rlc-sharded"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "need 4 devices, have 0" in proc.stderr


def test_cadence_still_exits_naming_its_item():
    """``--cadence`` is served since the cadence ring was ported (it no
    longer exits naming a ROADMAP item); like every device boot, a
    process on a host with no card exits non-zero with the no-card
    error."""
    proc = subprocess.run(
        [sys.executable, "-m", "hotstuff_tpu_torch.sidecar", "--cadence",
         "--mesh", "4"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "need 4 devices, have 0" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "hotstuff_tpu_torch.sidecar", "--cadence"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "not ported" not in proc.stderr


def test_engine_on_a_mesh_needs_its_cards():
    if torch.cuda.is_available():
        pytest.skip("the host has a card")
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        service.VerifyEngine(mesh_devices=2)
    eng = service.VerifyEngine(mesh_devices=2, device="cpu")
    try:
        assert eng._mesh.devices == (torch.device("cpu"),) * 2
        assert sched.ShapeRegistry(n_devices=2).route(3) == \
            eng._shapes.route(3) == sched.PATH_LADDER_SHARDED
    finally:
        eng.stop()
