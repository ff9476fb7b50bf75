"""The port's verify sidecar on the CPU (``device="cpu"``), driven over its
socket by the copied client: ping, latency and bulk verifies whose masks
equal the host reference, the RLC / bisection / per-signature routes in
OP_STATS, the verdict cache, OP_BUSY on a full queue, and the
``python -m hotstuff_tpu_torch.sidecar --device cpu`` entry.  Also: the
copied protocol module encodes every opcode to the reference's bytes.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from hotstuff_tpu.sidecar import protocol as jproto
from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
from hotstuff_tpu_torch.sidecar import protocol as proto
from hotstuff_tpu_torch.sidecar import service
from hotstuff_tpu_torch.sidecar.sched import surge
from hotstuff_tpu_torch.sidecar.client import (SidecarClient,
                                               SidecarOverloaded)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _votes(n, tag):
    keys = [ref.generate_keypair(bytes([tag, i]) * 16) for i in range(n)]
    digest = bytes([tag]) * 32
    return ([digest] * n, [pk for _, pk in keys],
            [ref.sign(sk, digest) for sk, _ in keys], keys)


@pytest.fixture(scope="module")
def sidecar():
    engine = service.VerifyEngine(device="cpu")
    server = service.SidecarServer(("127.0.0.1", 0), engine)
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    server.server_close()
    engine.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_ping_verify_bulk_and_stats(sidecar):
    port = sidecar.server_address[1]
    msgs, pks, sigs, keys = _votes(20, 1)
    sigs[7] = ref.sign(keys[7][0], b"a different digest")
    sigs[11] = sigs[11][:32] + (int.from_bytes(sigs[11][32:], "little")
                                + ref.L).to_bytes(32, "little")
    want = [ref.verify(pk, m, s) for m, pk, s in zip(msgs, pks, sigs)]
    assert want.count(False) == 2
    b_msgs, b_pks, b_sigs, _ = _votes(3, 2)
    with SidecarClient(port=port, timeout=120) as client:
        assert client.ping()
        assert client.verify_batch(msgs, pks, sigs) == want       # rlc
        assert client.verify_batch(b_msgs, b_pks, b_sigs,
                                   bulk=True) == [True] * 3       # per_sig
        # Every record is cached now: answered on the connection thread.
        assert client.verify_batch(msgs, pks, sigs) == want
        assert client.verify_batch([], [], []) == []
        stats = client.stats()
    assert stats["device"] == "cpu"
    assert stats["paths"] == {"rlc": 1, "rlc_bisect": 1, "per_sig": 1}
    assert stats["launches_by_class"] == {"latency": 1, "bulk": 1}
    assert stats["admitted"] == {"latency": 1, "bulk": 1}
    assert stats["sigs_launched"] == 23
    assert stats["verdict_cache_entries"] == 23
    assert set(stats["kernels"]) == {"probe", "field_mul", "scalar_mont_mul",
                                     "msm_window_accum", "point_ladder",
                                     "decompress", "point_multiples",
                                     "rlc_scalars", "rlc_reduce",
                                     "fq12_mul", "miller_accumulate",
                                     "fq12_pow", "fq_pow", "fq12_hard_pow",
                                     "final_exp", "fq12_product"}


def test_full_queue_answers_busy():
    # A stopped engine drains nothing: its queues keep what they admit.
    engine = service.VerifyEngine(device="cpu")
    engine.stop()
    server = service.SidecarServer(("127.0.0.1", 0), engine)
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    try:
        engine._sched._queues[service.BULK].cap_sigs = 2
        # A request is admitted whole when its queue is empty; one queued
        # signature makes the 3-signature request overflow the cap of 2.
        assert engine.submit(proto.VerifyRequest(0, [b"m"], [b"k"], [b"s"]),
                             lambda _: None, service.BULK)
        msgs, pks, sigs, _ = _votes(3, 3)
        with SidecarClient(port=server.server_address[1],
                           timeout=60) as client:
            with pytest.raises(SidecarOverloaded) as err:
                client.verify_batch(msgs, pks, sigs, bulk=True)
            # No launch has run, so the surge controller has no drain
            # rate yet and the hint is the bulk class's default.
            assert err.value.retry_after_ms == \
                surge.RETRY_DEFAULT_MS[service.BULK]
            assert client.stats()["queue_full"] == {"bulk": 1}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_unserved_opcode_closes_the_connection(sidecar):
    # Opcode 99 is none of the protocol's: the frame does not decode.
    payload = proto._HDR.pack(99, 1, 0, 0)
    with socket.create_connection(sidecar.server_address, timeout=30) as s:
        s.sendall(len(payload).to_bytes(4, "big") + payload)
        assert s.recv(64) == b""


def test_engine_coalesces_latency_before_bulk():
    engine = service.VerifyEngine(device="cpu")
    try:
        order = []
        # Hold the scheduler while three requests queue.  The bulk one
        # (5 signatures) does not fit the 4 pad slots of the latency
        # launch's bucket of 8, so it launches alone, after it.
        with engine._sched._cond:
            for cls, tag, n in ((service.BULK, 4, 5),
                                (service.LATENCY, 5, 2),
                                (service.LATENCY, 6, 2)):
                msgs, pks, sigs, _ = _votes(n, tag)
                req = proto.VerifyRequest(tag, msgs, pks, sigs)
                assert engine.submit(
                    req, lambda m, tag=tag: order.append((tag, m)), cls)
        deadline = time.monotonic() + 120
        while len(order) < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert [t for t, _ in order] == [5, 6, 4]
        assert all(m == [True] * len(m) for _, m in order)
        assert [len(m) for _, m in order] == [2, 2, 5]
        assert engine.stats_snapshot()["launches_by_class"] == {
            "latency": 1, "bulk": 1}
    finally:
        engine.stop()


def test_module_entry_serves_on_cpu(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log = open(tmp_path / "sidecar.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "hotstuff_tpu_torch.sidecar", "--port",
         str(port), "--device", "cpu"], cwd=REPO, stdout=log, stderr=log)
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                with SidecarClient(port=port, timeout=30) as client:
                    assert client.ping()
                    msgs, pks, sigs, _ = _votes(2, 7)
                    assert client.verify_batch(msgs, pks, sigs) == [True] * 2
                    # The warm-up calls the programs directly; only this
                    # request is counted.
                    assert client.stats()["paths"] == {"per_sig": 1}
                break
            except (ConnectionError, OSError):
                assert proc.poll() is None, (tmp_path / "sidecar.log"
                                             ).read_text()
                assert time.monotonic() < deadline
                time.sleep(0.2)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()


def _ref_and_port(name, *args, **kwargs):
    return (getattr(jproto, name)(*args, **kwargs),
            getattr(proto, name)(*args, **kwargs))


@pytest.mark.parametrize("name,args,kwargs", [
    ("encode_request", (5, [b"m" * 32] * 2, [b"p" * 32] * 2,
                        [b"s" * 64] * 2), {}),
    ("encode_request", (6, [b"m" * 32], [b"p" * 32], [b"s" * 64]),
     {"opcode": jproto.OP_VERIFY_BULK, "ctx": b"c" * 32}),
    ("encode_ping", (7,), {}),
    ("encode_stats_request", (8,), {}),
    ("encode_stats_reply", (9, {"paths": {"rlc": 2}, "launches": 3}), {}),
    ("encode_busy_reply", (10, 70000), {}),
    ("encode_hello_request", (11, "tenant-1"), {}),
    ("encode_hello_reply", (12, "tenant-1"), {}),
    ("encode_chaos_request", (13, {"delay_ms": 5}), {}),
    ("encode_bls_agg_request", (14, b"m" * 32, b"g" * 192,
                                [b"k" * 96] * 2), {}),
    ("encode_bls_sign_request", (15, b"m" * 32, b"x" * 48), {}),
    ("encode_bls_votes_request", (16, b"m" * 32, [b"k" * 96],
                                  [b"g" * 192]), {"ctx": b"c" * 32}),
    ("encode_bls_multi_request", (17, [b"m" * 32] * 2, [b"k" * 96] * 2,
                                  [b"g" * 192] * 2), {}),
    ("encode_reply", (jproto.OP_VERIFY_BATCH, 18, [True, False, True]), {}),
    ("encode_reply_raw", (jproto.OP_BLS_SIGN, 19, b"sig"), {}),
])
def test_protocol_copy_encodes_the_reference_bytes(name, args, kwargs):
    want, got = _ref_and_port(name, *args, **kwargs)
    assert got == want
    payload = got[4:]
    if name.startswith("encode_") and "reply" not in name:
        jop, jreq = jproto.decode_request(payload)
        op, req = proto.decode_request(payload)
        assert op == jop and vars(req) == vars(jreq)
    else:
        assert proto.decode_reply_raw(payload) == \
            jproto.decode_reply_raw(payload)


def test_protocol_constants_match_the_reference():
    names = [n for n in dir(jproto) if n.isupper() and not n.startswith("_")]
    assert names
    for n in names:
        assert getattr(proto, n) == getattr(jproto, n), n
