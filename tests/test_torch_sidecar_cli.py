"""The port's sidecar against the reference on the wire and at its command
line, on the CPU:

* OP_HELLO gets the JAX package's reply bytes, a known tenant is taken
  again, and the 257th distinct tenant is refused with a clean close, on
  both sidecars; OP_CHAOS gets the reference's [0] (refused);
* ``main()`` takes the exact flag strings that
  hotstuff_tpu/harness/local.py builds for a 4-node run (Ed25519, BLS,
  host crypto) and the integration tests' ``--host-crypto [--trace
  PATH]``; ``--chaos``, ``--tcp`` and ``--cadence`` reach ``serve()``;
  no flag is left unported, and ``--cadence`` without a card raises the
  no-card error;
* ``sched.size_queue_caps`` equals the reference's over a grid of
  committees and rates, and with its environment overrides;
* a ``python -m hotstuff_tpu_torch.sidecar --host-crypto --trace PATH``
  process answers an Ed25519 QC and a BLS QC with the masks of the
  reference's ``use_host=True`` engine, and its spans file parses with
  ``hotstuff_tpu.obs.parse_spans`` with no malformed line.
"""

from __future__ import annotations

import base64
import shlex
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from hotstuff_tpu.harness.local import LocalBench
from hotstuff_tpu.obs import parse_spans
from hotstuff_tpu.sidecar import service as jservice
from hotstuff_tpu.sidecar.sched import scheduler as jsched
from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
from hotstuff_tpu_torch.offchain import bls12381 as bls
from hotstuff_tpu_torch.sidecar import protocol as proto
from hotstuff_tpu_torch.sidecar import sched, service
from hotstuff_tpu_torch.sidecar.client import SidecarClient

from conftest import REPO, free_port


def _serve(server):
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    return thread


@pytest.fixture(scope="module")
def servers():
    """(the port's server, the reference's), each on a host engine."""
    port_srv = service.SidecarServer(
        ("127.0.0.1", 0), service.VerifyEngine(use_host=True))
    ref_srv = jservice.SidecarServer(
        ("127.0.0.1", 0), jservice.VerifyEngine(use_host=True))
    threads = [_serve(port_srv), _serve(ref_srv)]
    yield port_srv, ref_srv
    for srv in (port_srv, ref_srv):
        srv.shutdown()
        srv.server_close()
        srv.engine.stop()
    for t in threads:
        t.join(timeout=10)


def _exchange(server, frame: bytes) -> bytes:
    """Send one frame on a fresh connection; the reply frame, or b"" when
    the sidecar closes the connection instead."""
    with socket.create_connection(server.server_address, timeout=30) as s:
        s.sendall(frame)
        try:
            return proto.read_frame(s)
        except ConnectionError:
            return b""


def test_hello_gets_the_reference_reply_and_the_registry_is_capped(servers):
    for srv in servers:
        # 255 tenants registered before, so the wire's first new tenant
        # is the 256th (accepted) and its second the 257th (refused).
        for i in range(srv.TENANT_REGISTRY_CAP - 1):
            assert srv.register_tenant(f"pre-{i}")
    port_srv, ref_srv = servers
    assert port_srv.TENANT_REGISTRY_CAP == ref_srv.TENANT_REGISTRY_CAP == 256
    for frame, accepted in (
            (proto.encode_hello_request(1, "node"), True),
            (proto.encode_hello_request(2, "pre-3"), True),     # known
            (proto.encode_hello_request(3, "node"), True),      # re-HELLO
            (proto.encode_hello_request(4, "one-too-many"), False)):
        got, want = (_exchange(srv, frame) for srv in servers)
        assert got == want
        assert (got != b"") == accepted
        if accepted:
            assert proto.decode_hello_body(got[9:])[1] in ("node", "pre-3")


def test_chaos_is_refused_as_by_the_reference(servers):
    frame = proto.encode_chaos_request(7, {"delay_ms": 5})
    got, want = (_exchange(srv, frame) for srv in servers)
    assert got == want == proto.encode_reply(proto.OP_CHAOS, 7, [0])[4:]


def test_requests_after_hello_are_answered(servers):
    """A connection that said HELLO (as the C++ client of a fleet member
    does before its first request) gets the reference's HELLO reply on
    that connection and is then served like any other."""
    sk, pk = ref.generate_keypair(b"\x41" * 32)
    sig = ref.sign(sk, b"\x42" * 32)
    hello = proto.encode_hello_request(9, "node")
    replies, masks = [], []
    for srv in servers:
        with socket.create_connection(srv.server_address, timeout=60) as s:
            s.sendall(hello)
            replies.append(proto.read_frame(s))
        with SidecarClient(port=srv.server_address[1], timeout=60) as c:
            assert c.hello("node") == "node"
            assert c.server_version == proto.PROTOCOL_VERSION
            masks.append(c.verify_batch([b"\x42" * 32, b"\x43" * 32],
                                        [pk] * 2, [sig] * 2))
            assert c.ping()
    assert replies[0] == replies[1]
    assert proto.decode_hello_body(replies[0][9:])[1] == "node"
    assert masks == [[True, False]] * 2


def _harness_flags(monkeypatch, **params) -> list:
    """The sidecar flags hotstuff_tpu/harness/local.py builds for a 4-node
    run at 1,000 tx/s (its _boot_sidecar, with the process start and the
    readiness wait taken out)."""
    bench = LocalBench(SimpleNamespace(nodes=[4], rate=[1000], tx_size=512,
                                       faults=0, duration=20,
                                       tpu_sidecar=True, **params))
    cmds = []
    monkeypatch.setattr(bench, "_background_run",
                        lambda cmd, log, append=False: cmds.append(cmd))
    monkeypatch.setattr(bench, "_wait_sidecar_ready", lambda **kw: None)
    bench._degraded = False
    bench._boot_sidecar(host_crypto=bool(params.get("sidecar_host_crypto")))
    (cmd,) = cmds
    argv = shlex.split(cmd)
    assert argv[:3] == ["python", "-m", "hotstuff_tpu.sidecar"]
    return argv[3:]


def _main(monkeypatch, argv) -> dict:
    """service.main(argv) with serve() replaced by a recorder."""
    seen = {}
    monkeypatch.setattr(service, "serve",
                        lambda *a, **kw: seen.update(args=a, **kw))
    service.main(argv)
    return seen


@pytest.mark.parametrize("params,want", [
    ({"scheme": "ed25519", "sidecar_warm_rlc": True},
     {"warm_bls": False, "warm_bls_multi": 0, "use_host": False}),
    ({"scheme": "bls", "sidecar_warm_rlc": True},
     {"warm_bls": True, "warm_bls_multi": 3, "use_host": False}),
    ({"scheme": "ed25519", "sidecar_host_crypto": True},
     {"warm_bls": False, "warm_bls_multi": 0, "use_host": True}),
])
def test_main_takes_the_harness_flags(monkeypatch, params, want):
    argv = _harness_flags(monkeypatch, **params)
    assert "--committee" in argv and "--trace" in argv
    seen = _main(monkeypatch, argv)
    assert seen["args"] == ("127.0.0.1", 7100)
    assert seen["committee"] == 4 and seen["client_rate"] == 1000
    assert seen["trace_path"] == argv[argv.index("--trace") + 1]
    assert {k: seen[k] for k in want} == want


@pytest.mark.parametrize("extra", [[], ["--trace", "spans.jsonl"]])
def test_main_takes_the_integration_tests_flags(monkeypatch, extra):
    seen = _main(monkeypatch, ["--port", "7555", "--host-crypto", *extra])
    assert seen["args"] == ("127.0.0.1", 7555) and seen["use_host"]
    assert seen["trace_path"] == (extra[1] if extra else None)
    assert seen["committee"] is None and seen["client_rate"] is None


@pytest.mark.parametrize("argv", [["--cadence"]])
def test_unported_flags_exit_nonzero(monkeypatch, argv):
    """``--cadence`` was the last flag of the reference's CLI left
    unported; it is served since the cadence ring was ported.  It reaches
    serve() (cadence=True; without it the environment decides), and on a
    host without a card the boot raises the no-card error rather than
    serve on the CPU."""
    import torch

    assert not hasattr(service, "NOT_PORTED")
    assert _main(monkeypatch, argv)["cadence"] is True
    assert _main(monkeypatch, [])["cadence"] is None
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        service.main(argv)


@pytest.mark.parametrize("argv", [["--mesh", "4"],
                                  ["--mesh", "4", "--warm-rlc-sharded"]])
def test_mesh_flags_without_cards_exit_nonzero(monkeypatch, capsys, argv):
    """--mesh N is served since the port of parallel/; on a host with
    fewer than N cards (and no --device cpu) it exits with the
    reference's device-count error, before serve()."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(service, "serve", lambda *a, **kw: None)
    with pytest.raises(SystemExit) as exc:
        service.main(argv)
    assert exc.value.code != 0
    assert "need 4 devices, have 0" in capsys.readouterr().err


def test_mesh_flags_reach_serve(monkeypatch):
    seen = _main(monkeypatch, ["--device", "cpu", "--mesh", "4",
                               "--warm-rlc-sharded", "--warm", "64"])
    assert {k: seen[k] for k in ("device", "mesh_devices", "warm_max",
                                 "warm_rlc_sharded")} == {
        "device": "cpu", "mesh_devices": 4, "warm_max": 64,
        "warm_rlc_sharded": True}
    assert "scan_chunks" not in seen


@pytest.mark.parametrize("argv,want", [
    (["--chaos"], {"chaos": True, "tcp": None}),
    (["--tcp", "0.0.0.0:7200"], {"chaos": False, "tcp": "0.0.0.0:7200"})])
def test_chaos_and_tcp_flags_are_served(monkeypatch, argv, want):
    seen = _main(monkeypatch, ["--host-crypto", *argv])
    assert {k: seen[k] for k in want} == want


def test_harness_mesh_flags_exit_nonzero(monkeypatch):
    argv = _harness_flags(monkeypatch, scheme="ed25519", sidecar_mesh=4)
    assert "--mesh" in argv
    monkeypatch.setattr(service, "serve", lambda *a, **kw: None)
    with pytest.raises(SystemExit) as exc:
        service.main(argv)
    assert exc.value.code != 0


@pytest.mark.parametrize("committee", [None, 0, 1, 2, 4, 10, 67, 100, 1000,
                                       10 ** 6])
def test_size_queue_caps_equals_the_reference(committee):
    for rate in (None, 0, 1, 1000, 50_000, 10 ** 9):
        assert sched.size_queue_caps(committee, rate) == \
            jsched.size_queue_caps(committee, rate)


def test_size_queue_caps_env_overrides_equal_the_reference(monkeypatch):
    for lat, blk in (("5000", ""), ("", "777"), ("12", "34"), ("x", "-3")):
        monkeypatch.setenv("HOTSTUFF_TPU_LATENCY_QUEUE_CAP_SIGS", lat)
        monkeypatch.setenv("HOTSTUFF_TPU_BULK_QUEUE_CAP_SIGS", blk)
        for committee, rate in ((None, None), (100, 1000)):
            assert sched.size_queue_caps(committee, rate) == \
                jsched.size_queue_caps(committee, rate)


def test_engine_caps_follow_committee_and_rate():
    engine = service.VerifyEngine(use_host=True, committee=100,
                                  client_rate=50_000)
    try:
        assert engine.stats_snapshot()["queue_caps"] == {
            service.LATENCY: jsched.size_queue_caps(100, 50_000)[0],
            service.BULK: jsched.size_queue_caps(100, 50_000)[1]}
        assert engine.stats_snapshot()["device"] == "host"
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def host_sidecar(tmp_path_factory):
    """``python -m hotstuff_tpu_torch.sidecar --host-crypto --trace PATH``
    on a free port: (port, spans path, log path)."""
    work = tmp_path_factory.mktemp("host_sidecar")
    spans, log_path = work / "spans.jsonl", work / "sidecar.log"
    port = free_port()
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "hotstuff_tpu_torch.sidecar", "--port",
         str(port), "--host-crypto", "--trace", str(spans)], cwd=REPO,
        stdout=log, stderr=log)
    deadline = time.monotonic() + 180
    while True:
        try:
            with SidecarClient(port=port, timeout=10) as c:
                assert c.ping()
            break
        except (ConnectionError, OSError):
            assert proc.poll() is None, log_path.read_text()
            assert time.monotonic() < deadline, log_path.read_text()
            time.sleep(0.2)
    yield port, spans, log_path
    proc.terminate()
    proc.wait(timeout=30)
    log.close()


@pytest.fixture
def traced_reference(tmp_path):
    """The reference's host engine with a tracer: (server, spans path)."""
    from hotstuff_tpu.obs.spans import Tracer

    path = tmp_path / "ref-spans.jsonl"
    srv = jservice.SidecarServer(("127.0.0.1", 0), jservice.VerifyEngine(
        use_host=True, tracer=Tracer(str(path))))
    thread = _serve(srv)
    yield srv, path
    srv.shutdown()
    srv.server_close()
    srv.engine.stop()
    thread.join(timeout=10)


def _span_shapes(path) -> set:
    """(stage, sorted tag names) of each well-formed span of a file, once
    it holds the two spans that both sidecars write after the reply has
    gone out (the Ed25519 request's ``reply`` and the BLS request's
    ``device``), so a client that has its answers may still be ahead of
    them."""
    deadline = time.monotonic() + 60
    while True:
        records, malformed = parse_spans(path.read_text())
        stages = {r["stage"] for r in records if "kind" not in r}
        if ("reply" in stages and any("kind" in r for r in records)) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert malformed == 0
    return {(r["stage"], tuple(sorted(r))) for r in records}


def test_host_crypto_sidecar_answers_as_the_reference_host_engine(
        traced_reference, host_sidecar):
    """Masks, verdicts and the spans' stages and field names equal the
    reference's host engine's, on an Ed25519 QC tagged with a block
    digest and a BLS QC."""
    port, spans, log_path = host_sidecar
    ref_srv, ref_spans = traced_reference
    keys = [ref.generate_keypair(bytes([0x50, i]) * 16) for i in range(5)]
    digest = b"\x51" * 32
    sigs = [ref.sign(sk, digest) for sk, _ in keys]
    sigs[2] = ref.sign(keys[2][0], b"\x52" * 32)
    ed = ([digest] * 5, [pk for _, pk in keys], sigs)
    bkeys = [bls.key_gen(bytes([0x53 + i]) * 32) for i in range(3)]
    bls_qc = (digest, [bls.g1_encode(pk) for _, pk in bkeys],
              [bls.g2_encode(bls.sign(sk, digest)) for sk, _ in bkeys])
    out = []
    for p in (port, ref_srv.server_address[1]):
        with SidecarClient(port=p, timeout=120) as c:
            out.append((c.verify_batch(*ed, ctx=b"\x5a" * 32),
                        c.bls_verify_votes(*bls_qc), c.stats()["paths"]))
    (mask, verdict, paths), (ref_mask, ref_verdict, _) = out
    assert mask == ref_mask == [True, True, False, True, True]
    assert verdict is ref_verdict is True
    assert paths == {"host": 1, "bls_votes": 1}
    shapes = _span_shapes(spans)
    assert shapes == _span_shapes(ref_spans)
    assert {stage for stage, _ in shapes} == {
        "admit", "queue", "pack", "dispatch", "device", "reply"}
    records, _ = parse_spans(spans.read_text())
    tag = base64.b64encode(b"\x5a" * 32).decode("ascii")
    assert {r["ctx"] for r in records if "ctx" in r} == {tag}
    assert {tuple(r["ctxs"]) for r in records if "ctxs" in r} == {(tag,)}
    assert [r["kind"] for r in records if "kind" in r] == ["bls"]
    assert "Traceback" not in log_path.read_text()
