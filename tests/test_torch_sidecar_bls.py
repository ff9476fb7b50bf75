"""The port's verify sidecar serving the four BLS opcodes on the CPU
(``device="cpu"``: the Fq12 chain kernels' plain versions), driven over
its socket by the port's client on a 4-key committee: every verdict and
the OP_BLS_SIGN bytes equal the JAX package's host engine
(hotstuff_tpu/sidecar/service.py with ``use_host=True``) on the same
frames, a repeated request is answered from the verdict cache, a
transient failure replies [False] without entering the cache, BLS
requests launch alone, and ``--warm-bls`` / ``--warm-bls-multi N`` run
one check of their shape at boot.
"""

from __future__ import annotations

import threading

import pytest
import torch

from hotstuff_tpu.sidecar import service as jservice
from hotstuff_tpu_torch.offchain import bls12381 as bls
from hotstuff_tpu_torch.ops import bls381
from hotstuff_tpu_torch.sidecar import protocol as proto
from hotstuff_tpu_torch.sidecar import service
from hotstuff_tpu_torch.sidecar.client import SidecarClient

MSG = b"\x42" * 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The plain Fq12 chains are thousands of small operators; one thread
    # each keeps parallel test workers (pytest-xdist) from
    # oversubscribing the CPU.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _serve(server):
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    return thread


@pytest.fixture(scope="module")
def servers():
    """(port engine, port server, reference server) on free ports."""
    engine = service.VerifyEngine(device="cpu")
    port_srv = service.SidecarServer(("127.0.0.1", 0), engine)
    ref_engine = jservice.VerifyEngine(use_host=True)
    ref_srv = jservice.SidecarServer(("127.0.0.1", 0), ref_engine)
    threads = [_serve(port_srv), _serve(ref_srv)]
    yield engine, port_srv, ref_srv
    for srv in (port_srv, ref_srv):
        srv.shutdown()
        srv.server_close()
    engine.stop()
    ref_engine.stop()
    for t in threads:
        t.join(timeout=10)


@pytest.fixture(scope="module")
def committee():
    keys = [bls.key_gen(bytes([90 + i]) * 32) for i in range(4)]
    return keys, [bls.g1_encode(pk) for _, pk in keys]


def _both(servers, call):
    """call(client) against the port's sidecar and the reference's."""
    _, port_srv, ref_srv = servers
    out = []
    for srv in (port_srv, ref_srv):
        with SidecarClient(port=srv.server_address[1], timeout=600) as c:
            out.append(call(c))
    return out


def test_bls_opcodes_match_the_reference_host_engine(servers, committee):
    engine = servers[0]
    keys, pk_enc = committee
    sk_bytes = [sk.to_bytes(48, "big") for sk, _ in keys]

    # OP_BLS_SIGN: the same bytes as the host signer and the reference.
    sigs = _both(servers, lambda c: [c.bls_sign(MSG, sk) for sk in sk_bytes])
    assert sigs[0] == sigs[1]
    assert sigs[0] == [bls.g2_encode(bls.sign(sk, MSG)) for sk, _ in keys]
    sigs = sigs[0]

    # A QC as per-vote signatures: valid, one vote over another digest,
    # one signature that is not a curve point.
    forged = list(sigs)
    forged[2] = bls.g2_encode(bls.sign(keys[2][0], b"\x43" * 32))
    junk = list(sigs)
    junk[1] = b"\x01" * proto.BLS_SIG_LEN
    got = _both(servers, lambda c: [c.bls_verify_votes(MSG, pk_enc, s)
                                    for s in (sigs, forged, junk)])
    assert got[0] == got[1] == [True, False, False]
    # Decode failures are a pure function of the request bytes: cached.
    key = engine.bls_cache_key(proto.BlsVotesRequest(0, MSG, pk_enc, junk))
    assert engine._verdicts[key] is False

    # One aggregate signature over the 4 keys.
    agg = bls.g2_encode(bls.aggregate([bls.g2_decode(s) for s in sigs]))
    got = _both(servers, lambda c: c.bls_verify_aggregate(MSG, agg, pk_enc))
    assert got == [True, True]

    # A TC: 4 votes over 4 distinct digests.
    msgs = [bytes([i]) * 32 for i in range(4)]
    tc = [bls.g2_encode(bls.sign(sk, m)) for (sk, _), m in zip(keys, msgs)]
    got = _both(servers, lambda c: c.bls_verify_multi(msgs, pk_enc, tc))
    assert got == [True, True]

    # A repeat of the QC is a cache hit: no pairing check runs.
    checks = []
    real = bls381.verify_aggregate_common

    def counting(*args, **kwargs):
        checks.append(1)
        return real(*args, **kwargs)

    bls381.verify_aggregate_common = counting
    try:
        with SidecarClient(port=servers[1].server_address[1],
                           timeout=600) as c:
            assert c.bls_verify_votes(MSG, pk_enc, sigs) is True
            assert c.bls_verify_multi(msgs, pk_enc, tc) is True
            stats = c.stats()
    finally:
        bls381.verify_aggregate_common = real
    assert checks == []
    assert stats["paths"] == {"bls_sign": 4, "bls_votes": 3, "bls_agg": 1,
                              "bls_multi": 1}


def test_bls_transient_failure_replies_false_and_is_not_cached(
        servers, committee, monkeypatch):
    engine, port_srv, _ = servers
    keys, pk_enc = committee
    msg = b"\x44" * 32
    agg = bls.g2_encode(bls.aggregate([bls.sign(sk, msg) for sk, _ in keys]))
    key = engine.bls_cache_key(proto.BlsAggRequest(0, msg, agg, pk_enc))

    def broken(*args, **kwargs):
        raise RuntimeError("device fault")

    monkeypatch.setattr(bls381, "verify_aggregate_common", broken)
    with SidecarClient(port=port_srv.server_address[1], timeout=600) as c:
        assert c.bls_verify_aggregate(msg, agg, pk_enc) is False
        assert key not in engine._verdicts
        monkeypatch.undo()
        # The retry verifies, and now the verdict is cached.
        assert c.bls_verify_aggregate(msg, agg, pk_enc) is True
    assert engine._verdicts[key] is True


def test_bls_requests_launch_alone():
    """A BLS request is a launch of its own: it never coalesces with the
    Ed25519 requests queued around it."""
    engine = service.VerifyEngine(device="cpu")
    engine.stop()                          # inspect the queues by hand
    votes = proto.VerifyRequest(0, [b"m"] * 3, [b"k"] * 3, [b"s"] * 3)
    bls_req = proto.BlsVotesRequest(1, MSG, [b"k"] * 2, [b"s"] * 2)
    for req in (votes, votes, bls_req, votes):
        assert engine.submit(req, lambda _: None)
    sizes = []
    for _ in range(3):
        launch = engine._sched.next_launch(block=False)
        sizes.append([type(p.request).__name__ for p in launch.items])
    assert sizes == [["VerifyRequest", "VerifyRequest"], ["BlsVotesRequest"],
                     ["VerifyRequest"]]
    assert engine._sched.next_launch(block=False) is None
    assert [engine._sched.queued_sigs(c)
            for c in (service.LATENCY, service.BULK)] == [0, 0]


def test_warm_bls_flags_reach_the_boot(monkeypatch):
    calls = []
    monkeypatch.setattr(service, "serve", lambda *a, **k: calls.append(k))
    service.main(["--device", "cpu", "--warm-bls", "--warm-bls-multi", "5"])
    service.main(["--device", "cpu"])
    rest = {"use_host": False, "committee": None, "client_rate": None,
            "trace_path": None, "chaos": False, "tcp": None,
            "mesh_devices": None, "warm_max": 1024,
            "warm_rlc_sharded": False, "cadence": None}
    assert calls == [
        {"device": "cpu", "warm_bls": True, "warm_bls_multi": 5, **rest},
        {"device": "cpu", "warm_bls": False, "warm_bls_multi": 0, **rest}]


def test_warmup_bls_verifies_one_statement_of_each_shape(monkeypatch):
    """The warm-ups sign real votes and run one check of the shape on
    the engine's device; a False verdict fails the boot."""
    seen = []

    def common(pks, msg, agg, device=None):
        seen.append(("common", len(pks), str(device)))
        return bls.verify_aggregate_common(pks, msg, agg)

    def multi(pks, msgs, agg, device=None):
        seen.append(("multi", len(pks), str(device)))
        return bls.verify_aggregate(pks, msgs, agg)

    monkeypatch.setattr(bls381, "verify_aggregate_common", common)
    monkeypatch.setattr(bls381, "verify_aggregate_multi", multi)
    engine = service.VerifyEngine(device="cpu")
    try:
        service.warmup_bls(engine)
        service.warmup_bls(engine, 2, multi=True)
        assert seen == [("common", 3, "cpu"), ("multi", 2, "cpu")]
        monkeypatch.setattr(bls381, "verify_aggregate_common",
                            lambda *a, **k: False)
        with pytest.raises(RuntimeError, match="warm-up"):
            service.warmup_bls(engine)
    finally:
        engine.stop()
