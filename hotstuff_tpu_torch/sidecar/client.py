"""Python client for the verify sidecar (test + harness use; the node's
production client is the C++ implementation in native/crypto)."""

from __future__ import annotations

import socket
import threading

from . import protocol as proto


class SidecarOverloaded(RuntimeError):
    """The sidecar's class queue was full and it shed this request
    (explicit OP_BUSY backpressure reply, or the legacy empty-body form
    — see protocol.py).  ``retry_after_ms`` carries the sidecar's hint
    when the reply had one (None on the legacy form).  The caller
    decides: retry after ~the hint, or verify on host."""

    def __init__(self, message: str, retry_after_ms: int | None = None):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms


class SidecarClient:
    """Blocking, thread-safe client with request pipelining."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7100,
                 timeout: float | None = 60.0,
                 tenant: str | None = None):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        self._next_id = 0
        self._results: dict[int, list] = {}
        self._abandoned: set[int] = set()
        self._cond = threading.Condition()
        self.server_version: int | None = None
        if tenant is not None:
            self.hello(tenant)

    def hello(self, tenant: str) -> str:
        """graftfleet HELLO (protocol v6): register this connection's
        scheduling tenant.  Returns the tenant the server accepted and
        records the server's protocol version in ``server_version``;
        connections that never HELLO schedule under the default tenant."""
        rid = self._send(
            lambda r: proto.encode_hello_request(r, tenant))
        body = bytes(self._await(rid))
        version, accepted = proto.decode_hello_body(body)
        self.server_version = version
        return accepted

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def ping(self) -> bool:
        rid = self._send(proto.encode_ping)
        self._await(rid)
        return True

    def verify_batch(self, msgs, pks, sigs, *, bulk: bool = False,
                     ctx: bytes | None = None) -> list:
        """Returns per-signature validity list of bools.

        ``bulk=True`` tags the request bulk-class on the wire
        (OP_VERIFY_BULK): it coalesces behind consensus-latency verifies
        instead of ahead of them.  Mempool batch verification and
        offchain sweeps should pass it; QC/TC verification must not.

        ``ctx`` (protocol v5, graftscope) attaches the 32-byte block
        digest this verify serves, so the sidecar's stage spans join the
        block's node-side trace in logs/trace.json.

        Raises :class:`SidecarOverloaded` when the sidecar sheds the
        request (its class queue was full)."""
        if not msgs:
            return []
        op = proto.OP_VERIFY_BULK if bulk else proto.OP_VERIFY_BATCH
        rid = self._send(
            lambda r: proto.encode_request(r, msgs, pks, sigs, opcode=op,
                                           ctx=ctx))
        body = self._await(rid)
        if len(body) != len(msgs):
            raise SidecarOverloaded(
                f"sidecar shed {'bulk' if bulk else 'latency'}-class "
                f"verify of {len(msgs)} records (queue full)")
        return [bool(b) for b in body]

    def stats(self) -> dict:
        """Scheduler-telemetry snapshot (the OP_STATS round trip)."""
        rid = self._send(proto.encode_stats_request)
        return proto.decode_stats_body(bytes(self._await(rid)))

    def chaos(self, **spec) -> bool:
        """Configure the sidecar's fault-injection hook (OP_CHAOS):
        ``delay_ms=``, ``shed=``, ``drop=``, ``clear=True`` — see
        service.ChaosState.  Returns True when applied, False when the
        sidecar runs without ``--chaos`` (refusal, not an error: the
        graftchaos injector turns it into a reported plan failure)."""
        rid = self._send(lambda r: proto.encode_chaos_request(r, spec))
        body = self._await(rid)
        return bool(body) and bool(body[0])

    def bls_verify_aggregate(self, msg: bytes, agg_sig: bytes, pks) -> bool:
        """Common-message BLS aggregate verify (pks: 96 B uncompressed G1,
        agg_sig: 192 B uncompressed G2).  Raises SidecarOverloaded on a
        queue-full shed — an overload must never read as 'forged'."""
        rid = self._send(
            lambda r: proto.encode_bls_agg_request(r, msg, agg_sig, pks))
        return self._bls_verdict(self._await(rid))

    def bls_verify_votes(self, msg: bytes, pks, sigs) -> bool:
        """Per-vote BLS verify over one digest (the QC shape the C++
        node sends: the sidecar aggregates the signatures itself).
        Raises SidecarOverloaded on a queue-full shed."""
        rid = self._send(
            lambda r: proto.encode_bls_votes_request(r, msg, pks, sigs))
        return self._bls_verdict(self._await(rid))

    def bls_verify_multi(self, msgs, pks, sigs) -> bool:
        """Multi-digest BLS verify (the TC shape): n (digest, pk, sig)
        triples checked as one product of pairings in ONE round-trip.
        Raises SidecarOverloaded on a queue-full shed."""
        rid = self._send(
            lambda r: proto.encode_bls_multi_request(r, msgs, pks, sigs))
        return self._bls_verdict(self._await(rid))

    @staticmethod
    def _bls_verdict(body) -> bool:
        # A real BLS verdict is always exactly one 0/1 byte (errors reply
        # [False], never nothing) — an empty body is the scheduler's
        # explicit queue-full shed, which must surface as overload, not
        # as an invalid certificate.
        if not body:
            raise SidecarOverloaded(
                "sidecar shed BLS verify (queue full)")
        return bool(body[0])

    def bls_sign(self, msg: bytes, sk: bytes) -> bytes:
        """BLS sign via the sidecar's host signer -> 192 B G2 signature.
        A queue-full shed raises :class:`SidecarOverloaded` (v4 OP_BUSY,
        with ``retry_after_ms``); a signing failure replies an empty
        body and raises RuntimeError.  Either way the caller retries."""
        rid = self._send(lambda r: proto.encode_bls_sign_request(r, msg, sk))
        sig = bytes(self._await(rid))
        if len(sig) != proto.BLS_SIG_LEN:
            raise RuntimeError("sidecar BLS signing failed or shed")
        return sig

    # -- internals ---------------------------------------------------------

    def _send(self, make_frame):
        with self._send_lock:
            rid = self._next_id
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF
            frame = make_frame(rid)
            self._sock.sendall(frame)
            return rid

    @staticmethod
    def _unwrap(opcode, body):
        """Reply -> body, surfacing OP_BUSY sheds as SidecarOverloaded
        with the server's retry-after hint attached."""
        if opcode == proto.OP_BUSY:
            try:
                hint = proto.decode_busy_body(bytes(body))
            except ValueError:
                hint = None
            raise SidecarOverloaded(
                "sidecar shed request (queue full; retry after "
                f"{hint} ms)", retry_after_ms=hint)
        return body

    def _await(self, rid):
        try:
            while True:
                with self._cond:
                    if rid in self._results:
                        return self._unwrap(*self._results.pop(rid))
                # one thread at a time drains the socket; results are
                # published under the condition so pipelined waiters wake up
                if self._recv_lock.acquire(timeout=0.05):
                    try:
                        with self._cond:
                            if rid in self._results:
                                return self._unwrap(
                                    *self._results.pop(rid))
                        payload = proto.read_frame(self._sock)
                        opcode, got_rid, body = \
                            proto.decode_reply_raw(payload)
                        with self._cond:
                            if got_rid in self._abandoned:
                                self._abandoned.discard(got_rid)
                            else:
                                self._results[got_rid] = (opcode, body)
                                self._cond.notify_all()
                    finally:
                        self._recv_lock.release()
                else:
                    with self._cond:
                        self._cond.wait(timeout=0.05)
        except BaseException:
            # Abandoned request: reap a published result, or mark the rid so
            # the drainer drops its reply when it later arrives — either way
            # long-lived pipelined clients don't leak masks in _results.
            with self._cond:
                if self._results.pop(rid, None) is None:
                    self._abandoned.add(rid)
            raise
