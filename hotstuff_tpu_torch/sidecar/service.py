"""The verify sidecar on the card: the port of
hotstuff_tpu/sidecar/service.py, cut to the main path.

A long-lived process owns the device.  Connection threads decode frames
(``protocol.py``, unchanged wire protocol v6) and admit verify requests
into two bounded class queues; one engine thread takes launches, latency
class first.  Ed25519 requests coalesce up to the launch cap of
``MAX_SUBBATCH`` signatures, run the routed verify program (the one-MSM
RLC program or the per-signature program, ``sched/shapes.route``) and
fan the mask back out.  BLS requests (``scheme=bls`` committees) run one
at a time, uncoalesced: the aggregate checks of ops/bls381.py on the
device, signing on the host.

Served opcodes: OP_PING, OP_VERIFY_BATCH (latency class: QC/TC votes),
OP_VERIFY_BULK (bulk class: mempool batches), OP_STATS, and, in the
latency class, OP_BLS_VERIFY_VOTES (a QC's per-vote signatures over one
digest), OP_BLS_VERIFY_AGG (one aggregate signature), OP_BLS_VERIFY_MULTI
(a TC: per-vote signatures over distinct digests) and OP_BLS_SIGN.
OP_HELLO registers the connection's tenant (at most
``TENANT_REGISTRY_CAP`` distinct ones; past that the connection closes)
and echoes it, as the reference does; the tenant is kept per connection
only: scheduling stays in one lane per class, shared by every tenant,
until the tenant lanes are ported (ROADMAP Queue A item 4).  OP_CHAOS is
answered [0], refused: the fault-injection hook (``--chaos``) is not
ported.  A frame that does not decode closes the connection.

``--host-crypto`` verifies on the host, with no device and no kernel
build: Ed25519 with the copied ``crypto/ref_ed25519``, the BLS opcodes
with the copied ``offchain/bls12381`` (the reference's ``use_host``
engine).  ``--trace PATH`` appends the reference's sidecar spans
(obs/spans.py): admit, queue, pack, dispatch, device and reply.

There is no launch guard yet: a BLS check runs on the engine thread
without a deadline, so a hung device call parks the engine (the JAX
package runs BLS under its guard, hotstuff_tpu/sidecar/guard.py).

Run:  python -m hotstuff_tpu_torch.sidecar --port 7100 [--device cuda|cpu]
          [--host-crypto] [--warm-bls] [--warm-bls-multi N]
          [--committee N] [--client-rate TPS] [--trace PATH]
"""

from __future__ import annotations

import argparse
import collections
import logging
import queue
import socket
import socketserver
import threading
from base64 import b64encode
from time import monotonic

from . import protocol as proto
from . import sched as vsched
from ..crypto.eddsa import MAX_SUBBATCH
from ..obs.spans import Tracer
from ..utils.device import resolve

log = logging.getLogger("sidecar")

LATENCY = "latency"
BULK = "bulk"

# Requests answered with OP_BUSY carry this retry-after hint.
RETRY_AFTER_MS = 50


BLS_VERIFY_OPS = (proto.OP_BLS_VERIFY_AGG, proto.OP_BLS_VERIFY_VOTES,
                  proto.OP_BLS_VERIFY_MULTI)
BLS_REQUESTS = (proto.BlsAggRequest, proto.BlsVotesRequest,
                proto.BlsMultiRequest, proto.BlsSignRequest)

# OP_STATS path keys of the BLS requests.
BLS_PATHS = {proto.BlsAggRequest: "bls_agg", proto.BlsVotesRequest:
             "bls_votes", proto.BlsMultiRequest: "bls_multi",
             proto.BlsSignRequest: "bls_sign"}


def class_of_opcode(opcode: int) -> str:
    return BULK if opcode == proto.OP_VERIFY_BULK else LATENCY


def _ctx_tag(request):
    """A request's block-digest context tag as the base64 string the C++
    node logs in its TRACE lines (obs/trace.py joins on it), or None.
    Callers test ``tracer.enabled`` first: an untraced run never pays the
    encode."""
    ctx = getattr(request, "ctx", None)
    return b64encode(ctx).decode("ascii") if ctx else None


def _ctx_kw(request) -> dict:
    """A span's ``ctx`` tag for one request, when it carries one."""
    ctx = _ctx_tag(request)
    return {"ctx": ctx} if ctx else {}


def _ctxs_kw(batch) -> dict:
    """A span's ``ctxs`` tag for a coalesced launch: its distinct context
    tags, sorted, when any request carries one."""
    tags = sorted({_ctx_tag(p.request) for p in batch} - {None})
    return {"ctxs": tags} if tags else {}


def sigs_of(request) -> int:
    """Signatures a request carries, the unit of the admission bounds
    (a BLS aggregate counts its public keys, a signing request one)."""
    if isinstance(request, proto.BlsSignRequest):
        return 1
    return len(request.pks)


class Pending:
    """One admitted request, its class, when it was admitted, and its
    reply callback.  An Ed25519 reply takes the
    mask, or None for an OP_BUSY answer; a BLS reply takes the verdict
    list (or signature bytes), or None for a transient failure (sent as
    [False], never cached)."""

    __slots__ = ("request", "reply_fn", "cls", "enqueued_at")

    def __init__(self, request, reply_fn, cls: str):
        self.request = request
        self.reply_fn = reply_fn
        self.cls = cls
        self.enqueued_at = monotonic()


class VerifyEngine:
    """Owns the device; one engine thread drains the class queues.

    ``use_host`` verifies every request on the host instead (no device);
    ``committee`` and ``client_rate`` size the class queues
    (sched.size_queue_caps); ``tracer`` receives the stage spans."""

    # Bounded FIFO of (msg, pk, sig) -> verdict.
    VERDICT_CACHE_CAP = 64 * 1024

    def __init__(self, device=None, *, use_host: bool = False,
                 committee: int | None = None,
                 client_rate: int | None = None,
                 tracer: Tracer | None = None):
        self.use_host = use_host
        self.device = None if use_host else resolve(device)
        # Admission bounds per class, in queued signatures: a full queue
        # answers OP_BUSY instead of growing.
        self.queue_caps = dict(zip((LATENCY, BULK), vsched.size_queue_caps(
            committee, client_rate)))
        self._tracer = tracer or Tracer.disabled()
        self.stats = vsched.SchedStats()
        self._queues = {LATENCY: collections.deque(),
                        BULK: collections.deque()}
        self._queued_sigs = {LATENCY: 0, BULK: 0}
        self._cond = threading.Condition()
        self._stopped = False
        # Validity is a pure function of the record bytes, so verdicts
        # are cached; the engine thread is the only writer, connection
        # threads read it for the cached fast path.
        self._verdicts: dict = {}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="verify-engine")
        self._thread.start()

    # -- admission ---------------------------------------------------------

    def submit(self, request, reply_fn, cls: str = LATENCY) -> bool:
        """Admit one verify request; False (nothing retained, the caller
        replies OP_BUSY) when its class queue is full."""
        n = sigs_of(request)
        with self._cond:
            ok = self._queued_sigs[cls] + n <= self.queue_caps[cls]
            if ok:
                self._queues[cls].append(Pending(request, reply_fn, cls))
                self._queued_sigs[cls] += n
                self.stats.note_admitted(cls)
                self._cond.notify()
            else:
                self.stats.note_queue_full(cls)
        if self._tracer.enabled:
            self._tracer.event("admit", rid=request.request_id, cls=cls,
                               ok=ok,
                               n=len(getattr(request, "msgs", ()) or ())
                               or 1, **_ctx_kw(request))
        return ok

    def cached_verdicts(self, request):
        """[bool] when every record of the request has a cached verdict,
        else None (connection threads' fast path)."""
        out = []
        for rec in zip(request.msgs, request.pks, request.sigs):
            v = self._verdicts.get(rec)
            if v is None:
                return None
            out.append(v)
        return out or None

    @staticmethod
    def bls_cache_key(req):
        """Verdict-cache key for a BLS verify request, or None if the op
        is uncacheable (signing).  Validity is a pure function of the
        request's own bytes, so the whole request keys the verdict: N
        replicas verifying one certificate cost one pairing check.  The
        JAX package's keys (hotstuff_tpu/sidecar/service.py
        bls_cache_key): SHA-256 of the length-prefixed parts."""
        import hashlib

        def h(tag, *parts):
            # Fixed 32-byte keys: BLS requests embed every pk and sig
            # (~32 KB for a 100-vote TC).  Length-prefixed parts keep
            # the encoding injective before hashing.
            d = hashlib.sha256(tag)
            for p in parts:
                seq = p if isinstance(p, (list, tuple)) else (p,)
                d.update(len(seq).to_bytes(4, "big"))  # list boundary
                for b in seq:
                    d.update(len(b).to_bytes(4, "big"))
                    d.update(b)
            return d.digest()

        if isinstance(req, proto.BlsMultiRequest):
            return ("bm", h(b"bm", req.msgs, req.pks, req.sigs))
        if isinstance(req, proto.BlsVotesRequest):
            return ("bv", h(b"bv", req.msg, req.pks, req.sigs))
        if isinstance(req, proto.BlsAggRequest):
            return ("ba", h(b"ba", req.msg, req.pks, req.agg_sig))
        return None

    def cached_bls_verdict(self, req):
        """[bool] if this BLS verify request's verdict is cached, else
        None (connection threads' fast path)."""
        key = self.bls_cache_key(req)
        if key is None:
            return None
        v = self._verdicts.get(key)
        return None if v is None else [v]

    def stats_snapshot(self) -> dict:
        from ..ops import kern

        snap = self.stats.snapshot()
        snap["device"] = "host" if self.use_host else str(self.device)
        snap["kernels"] = dict(kern.LAUNCHES)
        snap["verdict_cache_entries"] = len(self._verdicts)
        return snap

    def stop(self):
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=60)

    # -- engine thread -------------------------------------------------------

    def _next_launch(self):
        """Block until work or stop; the latency class drains first, and
        a launch coalesces whole Ed25519 requests up to the launch cap (a
        single larger request goes alone and is sliced by the
        per-signature path).  A BLS request is a launch of its own."""
        with self._cond:
            while not self._stopped and not any(self._queues.values()):
                self._cond.wait(timeout=0.25)
            if self._stopped:
                return None
            cls = LATENCY if self._queues[LATENCY] else BULK
            q = self._queues[cls]
            batch = [q.popleft()]
            total = sigs_of(batch[0].request)
            if not isinstance(batch[0].request, BLS_REQUESTS):
                while (q and not isinstance(q[0].request, BLS_REQUESTS)
                       and total + len(q[0].request.msgs) <= MAX_SUBBATCH):
                    total += len(q[0].request.msgs)
                    batch.append(q.popleft())
            self._queued_sigs[cls] -= total
        self.stats.note_launch(cls, total)
        if self._tracer.enabled:
            # One span per launched request: admission -> launch.
            now = monotonic()
            for p in batch:
                self._tracer.event(
                    "queue", dur_ms=(now - p.enqueued_at) * 1e3,
                    rid=p.request.request_id, cls=p.cls,
                    **_ctx_kw(p.request))
        return batch

    def _trace_replies(self, batch):
        if not self._tracer.enabled:
            return
        for p in batch:
            self._tracer.event("reply", rid=p.request.request_id,
                               cls=p.cls, **_ctx_kw(p.request))

    def _run(self):
        while True:
            batch = self._next_launch()
            if batch is None:
                break
            if isinstance(batch[0].request, BLS_REQUESTS):
                item = batch[0]
                tags = _ctx_kw(item.request) if self._tracer.enabled else {}
                with self._tracer.span("device", kind="bls",
                                       rid=item.request.request_id, **tags):
                    self._execute_bls(item)
                continue
            try:
                fetch = self._pack(batch)()
                dispatched_at = monotonic()
                if self._tracer.enabled:
                    self._tracer.event("dispatch", reqs=len(batch),
                                       **_ctxs_kw(batch))
                mask = fetch()
            except Exception:
                # A failed launch is no verdict: every request of it is
                # answered OP_BUSY, and the node verifies on the host.
                log.exception("verify launch failed")
                for p in batch:
                    p.reply_fn(None)
                self._trace_replies(batch)
                continue
            if self._tracer.enabled:
                self._tracer.event(
                    "device", dur_ms=(monotonic() - dispatched_at) * 1e3,
                    reqs=len(batch),
                    sigs=sum(len(p.request.msgs) for p in batch),
                    **_ctxs_kw(batch))
            off = 0
            for p in batch:
                n = len(p.request.msgs)
                p.reply_fn([bool(b) for b in mask[off:off + n]])
                off += n
            self._trace_replies(batch)
        # Shutdown: requests still queued are answered OP_BUSY.
        with self._cond:
            left = [p for q in self._queues.values() for p in q]
            for q in self._queues.values():
                q.clear()
        for p in left:
            p.reply_fn(None)

    def _pack(self, batch):
        """Host-side pack of one coalesced batch: verdict-cache lookups,
        in-batch dedup, route selection and the verify program's own
        pack (a ``--host-crypto`` engine verifies here, on the host).
        Returns ``dispatch() -> fetch() -> mask``."""
        from ..crypto import eddsa

        t0 = monotonic()
        records = [rec for p in batch for rec in zip(
            p.request.msgs, p.request.pks, p.request.sigs)]
        cached = [self._verdicts.get(r) for r in records]
        # Each unique uncached record is verified once and fanned out to
        # every index that carried it.
        uniq: dict = {}
        for i, c in enumerate(cached):
            if c is None:
                uniq.setdefault(records[i], []).append(i)
        uniq_records = list(uniq)
        msgs = [r[0] for r in uniq_records]
        pks = [r[1] for r in uniq_records]
        sigs = [r[2] for r in uniq_records]
        path = vsched.PATH_HOST if self.use_host \
            else vsched.route(len(uniq_records))
        if uniq_records:
            self.stats.note_path(path)

        def on_bisect():
            self.stats.note_path(vsched.PATH_RLC_BISECT)

        if not uniq_records:
            dispatchers = []
        elif path == vsched.PATH_HOST:
            from ..crypto import ref_ed25519 as ref

            res = [ref.verify(pk, m, s) for m, pk, s in zip(msgs, pks, sigs)]
            dispatchers = [lambda: (lambda: res)]
        elif path == vsched.PATH_RLC:
            dispatchers = [eddsa.verify_batch_rlc_pack(
                msgs, pks, sigs, on_bisect=on_bisect, device=self.device)]
        else:
            step = MAX_SUBBATCH
            dispatchers = [eddsa.verify_batch_pack(
                msgs[i:i + step], pks[i:i + step], sigs[i:i + step],
                device=self.device) for i in range(0, len(msgs), step)]
        if self._tracer.enabled:
            # The port packs on the engine thread, so a pack is never
            # hidden behind a launch in flight.
            self._tracer.event("pack", dur_ms=(monotonic() - t0) * 1e3,
                               reqs=len(batch), uniq=len(uniq_records),
                               path=path, hidden=False, **_ctxs_kw(batch))

        def dispatch():
            fetchers = [d() for d in dispatchers]

            def fetch():
                fresh = []
                for f in fetchers:
                    fresh.extend(f())
                mask = list(cached)
                for record, ok in zip(uniq_records, fresh):
                    ok = bool(ok)
                    self._cache_verdict(record, ok)
                    for i in uniq[record]:
                        mask[i] = ok
                return mask

            return fetch

        return dispatch

    def _execute_bls(self, item):
        """Run one BLS request on the engine thread and send its one
        reply: the JAX package's reply contract
        (hotstuff_tpu/sidecar/service.py _execute_bls), without its
        launch guard.  Only verdicts the inner body marks cacheable --
        pure functions of the request bytes: decode and subgroup
        failures, completed checks -- enter the verdict cache; a
        transient failure (an exception) replies None, which the
        connection sends as [False] and nothing caches, since one
        poisoned shared entry would reject a valid certificate for every
        replica."""
        req = item.request
        self.stats.note_path(BLS_PATHS[type(req)])
        cache_key = self.bls_cache_key(req)
        try:
            payload, cacheable = self._execute_bls_inner(req, cache_key)
        except Exception:
            log.exception("BLS request failed")
            payload, cacheable = None, False
        if cacheable and cache_key is not None and payload:
            self._cache_verdict(cache_key, bool(payload[0]))
        item.reply_fn(payload)

    def _execute_bls_inner(self, req, cache_key):
        """The BLS request body; returns ``(payload, cacheable)``.  Every
        verify runs the pairing check on ``self.device``: there is no
        per-shape compile, so no shape needs warming and none falls back
        to the host.  A ``--host-crypto`` engine runs the host reference's
        check instead."""
        from ..offchain import bls12381 as bls
        from ..ops import bls381 as dbls

        if isinstance(req, proto.BlsSignRequest):
            # Signing is G2 scalar multiplication: host bigint work.
            sk = int.from_bytes(req.sk, "big")
            return bls.g2_encode(bls.sign(sk, req.msg)), False
        cached = self._verdicts.get(cache_key)
        if cached is not None:
            return [cached], False
        try:
            if isinstance(req, proto.BlsAggRequest):
                agg = bls.g2_decode(req.agg_sig)
            else:
                # Per-vote signatures get the on-curve check only; the
                # one aggregate gets the [R]P subgroup test (the pairing
                # statement depends only on the aggregate).
                agg = bls.aggregate(
                    [bls.g2_decode_lax(s) for s in req.sigs])
                if not bls.g2_in_subgroup(agg):
                    return [False], True
            pks = [bls.g1_decode(p) for p in req.pks]
        except ValueError:
            return [False], True
        if self.use_host:
            if isinstance(req, proto.BlsMultiRequest):
                ok = bls.verify_aggregate(pks, req.msgs, agg)
            else:
                ok = bls.verify_aggregate_common(pks, req.msg, agg)
        elif isinstance(req, proto.BlsMultiRequest):
            ok = dbls.verify_aggregate_multi(pks, req.msgs, agg,
                                             device=self.device)
        else:
            ok = dbls.verify_aggregate_common(pks, req.msg, agg,
                                              device=self.device)
        return [bool(ok)], True

    def _cache_verdict(self, record, ok: bool):
        if record not in self._verdicts:
            while len(self._verdicts) >= self.VERDICT_CACHE_CAP:
                self._verdicts.pop(next(iter(self._verdicts)))
        self._verdicts[record] = ok


class _Handler(socketserver.BaseRequestHandler):
    """Reader loop per connection; replies go through a writer thread so
    a client that stops draining stalls only its own connection."""

    def handle(self):
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        engine: VerifyEngine = self.server.engine  # type: ignore[attr-defined]
        outbox: "queue.Queue[bytes | None]" = queue.Queue(maxsize=1024)

        def writer():
            while True:
                frame = outbox.get()
                if frame is None:
                    return
                try:
                    sock.sendall(frame)
                except OSError:
                    return

        threading.Thread(target=writer, daemon=True,
                         name="sidecar-conn-writer").start()
        # The connection's tenant: a HELLO sets it; a connection that
        # never sends one is the default tenant.
        tenant = proto.DEFAULT_TENANT
        try:
            while True:
                try:
                    payload = proto.read_frame(sock)
                except (ConnectionError, OSError, ValueError):
                    return
                try:
                    opcode, req = proto.decode_request(payload)
                except ValueError:
                    log.exception("bad frame; closing connection")
                    return
                if opcode == proto.OP_HELLO:
                    # Distinct tenants are bounded: past the cap the
                    # connection closes (never a hang), so a tenant-id
                    # fuzzer cannot grow the registry without limit.
                    if not self.server.register_tenant(req.tenant):
                        log.warning("HELLO refused: tenant registry full "
                                    "(tenant %r); closing connection",
                                    req.tenant)
                        return
                    tenant = req.tenant
                    outbox.put(proto.encode_hello_reply(req.request_id,
                                                        tenant))
                    continue
                if opcode == proto.OP_CHAOS:
                    # [0] = refused: the fault-injection hook is not
                    # served, as the reference without --chaos.
                    outbox.put(proto.encode_reply(opcode, req.request_id,
                                                  [0]))
                    continue
                if opcode == proto.OP_PING:
                    outbox.put(proto.encode_reply(
                        proto.OP_PING, req.request_id, []))
                    continue
                if opcode == proto.OP_STATS:
                    outbox.put(proto.encode_stats_reply(
                        req.request_id, engine.stats_snapshot()))
                    continue
                if opcode in (proto.OP_VERIFY_BATCH, proto.OP_VERIFY_BULK):
                    verdicts = engine.cached_verdicts(req)
                elif opcode in BLS_VERIFY_OPS:
                    verdicts = engine.cached_bls_verdict(req)
                else:                       # OP_BLS_SIGN
                    verdicts = None
                if verdicts is not None:
                    outbox.put(proto.encode_reply(
                        opcode, req.request_id, verdicts))
                    continue

                def reply(result, _rid=req.request_id, _op=opcode):
                    if _op == proto.OP_BLS_SIGN:
                        frame = proto.encode_reply_raw(_op, _rid,
                                                       result or b"")
                    elif _op in BLS_VERIFY_OPS:
                        frame = proto.encode_reply(
                            _op, _rid, result if result is not None
                            else [False])
                    elif result is not None:
                        frame = proto.encode_reply(_op, _rid, result)
                    else:
                        frame = proto.encode_busy_reply(_rid, RETRY_AFTER_MS)
                    try:
                        outbox.put_nowait(frame)
                    except queue.Full:
                        pass

                if not engine.submit(req, reply, cls=class_of_opcode(opcode)):
                    outbox.put(proto.encode_busy_reply(
                        req.request_id, RETRY_AFTER_MS))
        finally:
            outbox.put(None)


class SidecarServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    # Distinct tenant ids one server process registers over its lifetime
    # (the reference's bound).
    TENANT_REGISTRY_CAP = 256

    def __init__(self, addr, engine: VerifyEngine):
        super().__init__(addr, _Handler)
        self.engine = engine
        self._tenants: set = set()
        self._tenants_lock = threading.Lock()

    def register_tenant(self, tenant: str) -> bool:
        """Accept a HELLO's tenant id; False once the registry is full
        (a known tenant is always accepted again: connections that share
        an id share its lane)."""
        with self._tenants_lock:
            if tenant in self._tenants:
                return True
            if len(self._tenants) >= self.TENANT_REGISTRY_CAP:
                return False
            self._tenants.add(tenant)
            return True


def warmup(engine: VerifyEngine) -> None:
    """Build the kernels, check the toolchain with the probe kernel and
    place the comb table on the device before the socket binds, by
    verifying one small batch through each program: until the socket
    exists, nodes get ECONNREFUSED and verify on the host instead of
    waiting on a build."""
    import torch

    from ..crypto import eddsa, ref_ed25519 as ref
    from ..ops.kern.probe import probe

    x = torch.zeros((8, 128), dtype=torch.int32, device=engine.device)
    if not bool((probe(x) == 1).all()):
        raise RuntimeError("probe kernel did not return x + 1")

    sk = bytes(range(32))
    _, pk = ref.generate_keypair(sk)
    msg = b"\x01" * 32
    sig = ref.sign(sk, msg)
    n = vsched.RLC_MIN_LAUNCH
    if not all(eddsa.verify_batch([msg], [pk], [sig], device=engine.device)):
        raise RuntimeError("warm-up per-signature verify returned false")
    if not all(eddsa.verify_batch_rlc([msg] * n, [pk] * n, [sig] * n,
                                      device=engine.device)):
        raise RuntimeError("warm-up RLC verify returned false")


def warmup_bls(engine: VerifyEngine, n_votes: int = 3,
               multi: bool = False) -> None:
    """One BLS aggregate verify of n votes on the engine's device before
    the socket binds (``--warm-bls``: the common-message QC check;
    ``--warm-bls-multi N``: the N-vote distinct-digest TC check).  It
    builds the kernels and leaves the Frobenius tables and exponent
    digits on the device; no shape gates the card path, every shape
    runs the same kernels."""
    from ..offchain import bls12381 as bls
    from ..ops import bls381 as dbls

    t0 = monotonic()
    keys = [bls.key_gen(bytes([i + 1]) * 32) for i in range(n_votes)]
    pks = [pk for _, pk in keys]
    if multi:
        msgs = [bytes([i]) * 32 for i in range(n_votes)]
        agg = bls.aggregate([bls.sign(sk, m)
                             for (sk, _), m in zip(keys, msgs)])
        ok = dbls.verify_aggregate_multi(pks, msgs, agg,
                                         device=engine.device)
    else:
        msg = b"warmup"
        agg = bls.aggregate([bls.sign(sk, msg) for sk, _ in keys])
        ok = dbls.verify_aggregate_common(pks, msg, agg,
                                          device=engine.device)
    if not ok:
        raise RuntimeError(f"BLS warm-up verify of {n_votes} votes "
                           f"(multi={multi}) returned false")
    log.info("BLS %s warm-up (%d votes) done in %.1fs",
             "multi-digest" if multi else "aggregate", n_votes,
             monotonic() - t0)


def serve(host: str = "127.0.0.1", port: int = 7100, device=None,
          warm_bls: bool = False, warm_bls_multi: int = 0,
          use_host: bool = False, committee: int | None = None,
          client_rate: int | None = None, trace_path: str | None = None):
    """Warm up (a ``use_host`` engine has nothing to warm), then run the
    sidecar until interrupted; returns the closed server."""
    tracer = None
    if trace_path:
        tracer = Tracer(trace_path)
        log.info("span emission -> %s", trace_path)
    engine = VerifyEngine(device=device, use_host=use_host,
                          committee=committee, client_rate=client_rate,
                          tracer=tracer)
    try:
        t0 = monotonic()
        if not use_host:
            warmup(engine)
            if warm_bls:
                warmup_bls(engine)
            if warm_bls_multi:
                warmup_bls(engine, warm_bls_multi, multi=True)
        log.info("warm-up on %s done in %.1fs",
                 "the host" if use_host else engine.device, monotonic() - t0)
        server = SidecarServer((host, port), engine)
    except BaseException:
        engine.stop()
        raise
    log.info("sidecar listening on %s:%d (%s)", host,
             server.server_address[1],
             "host crypto" if use_host else engine.device)
    try:
        server.serve_forever(poll_interval=0.2)
    finally:
        engine.stop()
        server.server_close()
        if tracer is not None:
            tracer.close()
    return server


# Flags of the reference's CLI whose machinery the port has not ported:
# each exits with the ROADMAP item that ports it, never ignored.
NOT_PORTED = {
    "mesh": "sharding verify over several cards (--mesh N, N > 1) is "
            "ROADMAP Queue A item 5 (parallel/ over torch.distributed)",
    "chaos": "the OP_CHAOS fault-injection hook (--chaos) is ROADMAP "
             "Queue A item 3; without it OP_CHAOS is answered [0], "
             "refused",
    "cadence": "the cadence ring (--cadence, sidecar/ring.py) is ROADMAP "
               "Queue A item 3",
    "tcp": "the fleet's second listener (--tcp) is ROADMAP Queue A item "
           "4, with the tenant lanes",
    "warm_rlc_sharded": "the sharded RLC programs of --mesh N "
                        "(--warm-rlc-sharded) are ROADMAP Queue A item 5",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7100)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the verify programs run (default: the "
                         "card; cpu runs the kernels' plain versions)")
    ap.add_argument("--host-crypto", action="store_true",
                    help="verify on the host (the copied ref_ed25519 and "
                         "offchain/bls12381): no device, no kernel build")
    ap.add_argument("--warm-bls", action="store_true",
                    help="also verify one BLS aggregate before listening "
                         "(scheme=bls deployments)")
    ap.add_argument("--warm-bls-multi", type=int, default=0, metavar="N",
                    help="also verify one N-vote multi-digest BLS "
                         "aggregate (the TC check at quorum size N) "
                         "before listening")
    ap.add_argument("--warm-rlc", action="store_true",
                    help="accepted for the harness: every boot already "
                         "verifies one batch through the RLC program "
                         "(the default)")
    ap.add_argument("--committee", type=int, default=0, metavar="N",
                    help="committee size served; sizes the latency-class "
                         "admission cap (0 = static default)")
    ap.add_argument("--client-rate", type=int, default=0, metavar="TPS",
                    help="aggregate client tx rate; sizes the bulk-class "
                         "admission cap (0 = static default)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="append JSONL spans (admit/queue/pack/dispatch/"
                         "device/reply, tagged rid + class) to PATH")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="not ported for N > 1: " + NOT_PORTED["mesh"])
    for flag in ("chaos", "cadence", "warm_rlc_sharded"):
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        help="not ported: " + NOT_PORTED[flag])
    ap.add_argument("--tcp", default=None, metavar="HOST:PORT",
                    help="not ported: " + NOT_PORTED["tcp"])
    ap.add_argument("-v", "--verbose", action="count", default=0)
    args = ap.parse_args(argv)
    for flag in ("chaos", "cadence", "tcp", "warm_rlc_sharded"):
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} is not ported: "
                     f"{NOT_PORTED[flag]}")
    if args.mesh > 1:
        ap.error(f"--mesh {args.mesh} is not ported: {NOT_PORTED['mesh']}")
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s.%(msecs)03dZ %(levelname)s [%(name)s] %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S")
    serve(args.host, args.port, device=args.device, warm_bls=args.warm_bls,
          warm_bls_multi=args.warm_bls_multi, use_host=args.host_crypto,
          committee=args.committee or None,
          client_rate=args.client_rate or None, trace_path=args.trace)


if __name__ == "__main__":
    main()
