"""The BLS host preparation's exact shortcuts in the port, held to the
JAX package's host bigints: the memo of ``offchain/bls12381.hash_to_g2``
(the same points as hotstuff_tpu/offchain/bls12381.py, on seeded
messages, a repeat, and a message whose first try-and-increment counter
fails), the signatures built on it, and ``ops/bls381.miller_lines`` from
Fq2 line coefficients (the same limbs as hotstuff_tpu/ops/bls381.py's
Fq12 walk, on seeded keys, hash points, signatures and the vertical
line).  Also the engine's ``bls_busy`` OP_STATS section."""

from __future__ import annotations

import threading

import numpy as np
import pytest

from hotstuff_tpu.offchain import bls12381 as rhost
from hotstuff_tpu.ops import bls381 as rops
from hotstuff_tpu_torch.offchain import bls12381 as host
from hotstuff_tpu_torch.ops import bls381 as ops


def _msgs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


def _first_counter_fails(msg) -> bool:
    """Whether the reference's try-and-increment rejects counter 0 for
    ``msg`` (the x it draws has no point on the twist)."""
    import hashlib

    h = hashlib.sha512(b"BLS_H2G2" + (0).to_bytes(4, "big") + msg).digest()
    x = (int.from_bytes(h[:32], "big") % rhost.Q,
         int.from_bytes(h[32:], "big") % rhost.Q)
    y2 = rhost.fq2_add(rhost.fq2_mul(rhost.fq2_mul(x, x), x), rhost._fq2.b)
    return rhost._fq2_sqrt(y2) is None


def test_hash_to_g2_memo_equals_the_reference():
    """Seeded messages, one whose counter 0 fails, and a repeat: the
    same points as the reference's uncached map; a repeat is a memo hit
    that returns the same point."""
    msgs = _msgs(3, seed=1301)
    retry = next(m for m in _msgs(64, seed=1302) if _first_counter_fails(m))
    host._hash_to_g2_cached.cache_clear()
    for m in msgs + [retry]:
        assert host.hash_to_g2(m) == rhost.hash_to_g2(m)
    hits = host._hash_to_g2_cached.cache_info().hits
    assert host.hash_to_g2(bytearray(retry)) == rhost.hash_to_g2(retry)
    assert host._hash_to_g2_cached.cache_info().hits == hits + 1
    assert host._hash_to_g2_uncached(retry) == host.hash_to_g2(retry)


def test_signatures_on_the_memo_equal_the_reference():
    """One digest signed by several keys (a committee's round: each
    replica signs, then the QC is checked), and again: the reference's
    signature bytes every time."""
    digest = _msgs(1, seed=1303)[0]
    host._hash_to_g2_cached.cache_clear()
    for seed in (b"a", b"b", b"a"):
        sk, _ = host.key_gen(seed * 8)
        assert host.g2_encode(host.sign(sk, digest)) == \
            rhost.g2_encode(rhost.sign(sk, digest))


@pytest.mark.parametrize("case", ["key at a hash point",
                                  "generator at a signature",
                                  "aggregate key at a hash point"])
def test_miller_lines_equal_the_reference(case):
    msg = _msgs(1, seed=1304)[0]
    keys = [rhost.key_gen(bytes([i]) * 8) for i in range(3)]
    if case == "key at a hash point":
        p, q = keys[0][1], rhost.hash_to_g2(msg)
    elif case == "generator at a signature":
        p = rhost.g1_neg(rhost.g1_generator())
        q = rhost.sign(keys[1][0], msg)
    else:
        p = rhost.g1_add(rhost.g1_add(keys[0][1], keys[1][1]), keys[2][1])
        q = rhost.hash_to_g2(msg)
    got = ops.miller_lines(p, q)
    assert got.dtype == np.int32 and got.shape == (ops.N_STEPS, 2, 12, 48)
    assert np.array_equal(got, rops.miller_lines(p, q))
    assert np.array_equal(ops.lines_at(ops.line_coeffs(q), p), got)


def test_vertical_line_and_its_sum_equal_the_reference():
    """Q and -Q: the reference's vertical line xP - X1 and an identity
    sum, from the Fq2 step as from the Fq12 one."""
    q = rhost.hash_to_g2(b"vertical")
    neg = rhost.g2_neg(q)
    p = rhost.key_gen(b"v" * 8)[1]
    line, total = ops._line_step(q, neg)
    assert line[0] == 1 and total is None
    assert rhost._add(rhost._twist(q), rhost._twist(neg), rhost._fq12) is None
    want = rops.host_fq12_to_mont_limbs(rhost._linefunc(
        rhost._twist(q), rhost._twist(neg), rhost._cast_g1_fq12(p)))
    slots = [line] + [None] * (2 * ops.N_STEPS - 1)
    assert np.array_equal(ops.lines_at(slots, p)[0, 0], want)


def test_bls_busy_counts_each_request_kind():
    """OP_STATS ``bls_busy`` appears once a BLS request ran, one count
    and a positive wall for its path."""
    from hotstuff_tpu_torch.sidecar.client import SidecarClient
    from hotstuff_tpu_torch.sidecar.service import SidecarServer, \
        VerifyEngine

    engine = VerifyEngine(use_host=True)
    srv = SidecarServer(("127.0.0.1", 0), engine)
    threading.Thread(target=srv.serve_forever,
                     kwargs=dict(poll_interval=0.05), daemon=True).start()
    try:
        with SidecarClient(port=srv.server_address[1], timeout=60) as c:
            assert "bls_busy" not in c.stats()
            sk, _ = host.key_gen(b"busy" * 8)
            c.bls_sign(b"\x07" * 32, sk.to_bytes(48, "big"))
            busy = c.stats()["bls_busy"]
        assert set(busy) == {"bls_sign"}
        assert busy["bls_sign"]["n"] == 1 and busy["bls_sign"]["ms"] > 0
    finally:
        srv.shutdown()
        engine.stop()
        srv.server_close()
