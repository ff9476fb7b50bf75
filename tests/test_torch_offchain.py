"""The port's off-chain suite (hotstuff_tpu_torch/offchain/) against the
JAX package's (hotstuff_tpu/offchain/) on the CPU, on the same seeded
inputs: mirrors tests/test_offchain.py.

* secp256k1 points and encodings, ECDSA (its RFC 6979 signatures, an
  OpenSSL interchange) and Schnorr equal the reference's and reject
  tampering;
* BLS12-381: ``pairing`` equals the reference's and is bilinear,
  ``sign``/``verify``, ``g1_in_subgroup``, ``g2_neg`` and ``_mul`` (held
  to the Jacobian ladder) as in the reference;
* Ed25519: the host paths equal the reference's host loop, and
  ``verify_batch_device(device="cpu")`` (the kernels' plain versions)
  gives the same mask;
* the self-checks (``field25519.mul_selfcheck``,
  ``field381.mul_selfcheck``, ``bls381.selfcheck``) pass on
  ``device="cpu"`` and raise on a deliberately wrong multiply;
* ``bench.measure_single``, ``measure_batch(sizes=(2,), device="cpu")``
  and ``measure_message_length`` run; the CLI's ``--no-device`` sweep
  gives the host columns only; ``to_csv`` without pandas raises an
  ImportError naming it.

Host pairings are seconds each in Python bigints, so each test keeps to
a few.
"""

from __future__ import annotations

import hashlib
import json
import sys

import numpy as np
import pytest
import torch

from hotstuff_tpu.offchain import bls12381 as jbls
from hotstuff_tpu.offchain import ecdsa as jecdsa
from hotstuff_tpu.offchain import eddsa as jeddsa
from hotstuff_tpu.offchain import schnorr as jschnorr
from hotstuff_tpu.offchain import secp256k1 as jsecp
from hotstuff_tpu_torch.offchain import bench
from hotstuff_tpu_torch.offchain import bls12381 as bls
from hotstuff_tpu_torch.offchain import ecdsa, eddsa, schnorr, secp256k1
from hotstuff_tpu_torch.ops import bls381, field25519, field381


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The plain versions are thousands of small operators; one thread
    # each keeps parallel test workers (pytest-xdist) from
    # oversubscribing the CPU.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# secp256k1, ECDSA, Schnorr (host)
# ---------------------------------------------------------------------------

def test_secp256k1_point_arithmetic():
    g = (secp256k1.GX, secp256k1.GY)
    assert secp256k1.on_curve(g)
    assert secp256k1.point_mul(secp256k1.N) is None
    two_g = secp256k1.point_add(g, g)
    assert two_g == secp256k1.point_mul(2)
    rng = np.random.default_rng(1)
    for k in [2, 3, 12345] + [int.from_bytes(rng.bytes(32), "big")
                              for _ in range(3)]:
        p = secp256k1.point_mul(k)
        assert p == jsecp.point_mul(k)
        enc = secp256k1.point_encode(p)
        assert enc == jsecp.point_encode(p)
        assert secp256k1.point_decode(enc) == p == jsecp.point_decode(enc)
    assert secp256k1.point_add(g, two_g) == jsecp.point_add(g, two_g)


@pytest.mark.parametrize("seed", [b"seed", b"other"])
def test_ecdsa_roundtrip_and_tamper(seed):
    sk, pk = ecdsa.key_gen(seed)
    assert (sk, pk) == jecdsa.key_gen(seed)
    sig = ecdsa.sign(sk, b"hello")
    assert sig == jecdsa.sign(sk, b"hello")
    assert ecdsa.verify(pk, b"hello", sig)
    assert not ecdsa.verify(pk, b"world", sig)
    r, s = sig
    assert not ecdsa.verify(pk, b"hello", (r, (s + 1) % secp256k1.N))
    _, pk2 = ecdsa.key_gen(seed + b"2")
    assert not ecdsa.verify(pk2, b"hello", sig)
    assert ecdsa.verify_batch([b"hello", b"world"], [pk, pk], [sig, sig]) \
        == jecdsa.verify_batch([b"hello", b"world"], [pk, pk], [sig, sig]) \
        == [True, False]


def test_ecdsa_cross_check_openssl():
    """The port's signatures verify under OpenSSL's secp256k1 and the
    reverse (DER interchange)."""
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import (
        decode_dss_signature,
    )

    msg = b"cross-check message"
    sk, pk = ecdsa.key_gen(b"xseed")
    sig = ecdsa.sign(sk, msg)
    ec.EllipticCurvePublicNumbers(pk[0], pk[1], ec.SECP256K1()).public_key() \
        .verify(secp256k1.ecdsa_sig_to_der(sig), msg,
                ec.ECDSA(hashes.SHA256()))
    der = ec.derive_private_key(sk, ec.SECP256K1()).sign(
        msg, ec.ECDSA(hashes.SHA256()))
    r, s = decode_dss_signature(der)
    if s > secp256k1.N // 2:
        s = secp256k1.N - s
    assert ecdsa.verify(pk, msg, (r, s))


def test_schnorr_roundtrip_and_tamper():
    sk, pk = schnorr.key_gen(b"seed")
    sig = schnorr.sign(sk, b"msg")
    assert sig == jschnorr.sign(sk, b"msg")
    assert schnorr.verify(pk, b"msg", sig)
    assert not schnorr.verify(pk, b"other", sig)
    R, s = sig
    assert not schnorr.verify(pk, b"msg", (R, (s + 1) % secp256k1.N))
    assert schnorr.verify_batch([b"msg", b"other"], [pk, pk], [sig, sig]) \
        == jschnorr.verify_batch([b"msg", b"other"], [pk, pk], [sig, sig])


# ---------------------------------------------------------------------------
# BLS12-381 (host)
# ---------------------------------------------------------------------------

def test_bls_pairing_bilinearity():
    g1, g2 = bls.g1_generator(), bls.g2_generator()
    e = bls.pairing(g1, g2)
    assert e == jbls.pairing(g1, g2)
    assert e != bls.FQ12_ONE
    assert bls.fq12_pow(e, bls.R) == bls.FQ12_ONE
    assert bls.pairing(bls.g1_mul(g1, 5),
                       bls.g2_mul(g2, 7)) == bls.fq12_pow(e, 35)


def test_bls_sign_verify():
    sk, pk = bls.key_gen(b"seed")
    sig = bls.sign(sk, b"msg")
    assert sig == jbls.sign(sk, b"msg")
    assert bls.verify(pk, b"msg", sig)
    assert not bls.verify(pk, b"other", sig)
    assert not bls.verify(pk, b"msg", None)


def test_bls_subgroup_and_negation():
    g1, g2 = bls.g1_generator(), bls.g2_generator()
    assert bls.g1_in_subgroup(g1) and bls.g1_in_subgroup(None)
    x = 5
    while True:    # the reference test's first curve point outside G1
        rhs = (x * x * x + 4) % bls.Q
        y = pow(rhs, (bls.Q + 1) // 4, bls.Q)
        if y * y % bls.Q == rhs and not jbls.g1_in_subgroup((x, y)):
            break
        x += 1
    assert bls.g1_on_curve((x, y)) and not bls.g1_in_subgroup((x, y))
    q = bls.g2_mul(g2, 12345)
    assert bls.g2_neg(q) == jbls.g2_neg(q)
    assert bls.g2_add(q, bls.g2_neg(q)) is None
    assert bls.g2_neg(None) is None


def test_bls_jacobian_mul_matches_affine():
    for ops, gen in ((bls._fq, bls.g1_generator()),
                     (bls._fq2, bls.g2_generator())):
        for k in (1, 2, 3, 5, 255, 65537, 2**64 + 3):
            assert bls._jac_mul(gen, k, ops) == bls._mul(gen, k, ops)
        assert bls._mul(gen, 0, ops) is None


# ---------------------------------------------------------------------------
# Ed25519: host and device paths
# ---------------------------------------------------------------------------

def _ed25519(n, tamper=()):
    msgs, pks, sigs = [], [], []
    for i in range(n):
        sk, pk = eddsa.key_gen(hashlib.sha256(bytes([i])).digest())
        msg = b"msg-%d" % i
        sig = eddsa.sign(sk, msg)
        if i in tamper:
            sig = sig[:10] + bytes([sig[10] ^ 1]) + sig[11:]
        msgs.append(msg)
        pks.append(pk)
        sigs.append(sig)
    return msgs, pks, sigs


def test_eddsa_wrapper_paths_agree():
    msgs, pks, sigs = _ed25519(4, tamper={2})
    want = jeddsa.verify_batch_host(msgs, pks, sigs)
    assert want == [True, True, False, True]
    assert eddsa.key_gen(b"\x05" * 32) == jeddsa.key_gen(b"\x05" * 32)
    assert eddsa.verify_batch_host(msgs, pks, sigs) == want
    assert eddsa.verify_batch_device(msgs, pks, sigs, device="cpu") == want


# ---------------------------------------------------------------------------
# the self-checks
# ---------------------------------------------------------------------------

def test_selfchecks_pass_on_the_cpu():
    field25519.mul_selfcheck(device="cpu")
    field381.mul_selfcheck(device="cpu")
    bls381.selfcheck(device="cpu")


def test_selfchecks_raise_on_a_wrong_multiply(monkeypatch):
    def off_by_one(mul):
        def wrong(a, b):
            out = mul(a, b).clone()
            out[..., 0] += 1
            return out
        return wrong

    monkeypatch.setattr(field25519, "mul", off_by_one(field25519.mul))
    with pytest.raises(AssertionError, match="field25519"):
        field25519.mul_selfcheck(batch=8, device="cpu")
    monkeypatch.undo()
    monkeypatch.setattr(field381, "mont_mul", off_by_one(field381.mont_mul))
    with pytest.raises(AssertionError, match="field381"):
        field381.mul_selfcheck(batch=4, device="cpu")
    with pytest.raises(AssertionError, match="field381"):
        bls381.selfcheck(device="cpu")
    monkeypatch.undo()
    monkeypatch.setattr(bls381, "fq12_mul", off_by_one(bls381.fq12_mul))
    with pytest.raises(AssertionError, match="fq12"):
        bls381.selfcheck(device="cpu")


# ---------------------------------------------------------------------------
# the bench and its CLI
# ---------------------------------------------------------------------------

def test_bench_measure_single_smoke(capsys):
    rows = bench.measure_single(iters=2, schemes=("eddsa", "ecdsa",
                                                  "schnorr"))
    assert [r["scheme"] for r in rows] == ["eddsa", "ecdsa", "schnorr"]
    assert all(r["verify_ms"] > 0 and r["sign_ms"] > 0 for r in rows)
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert printed == rows


def test_bench_measure_batch_smoke(monkeypatch):
    """One size on device="cpu": the self-checks run first, both device
    columns are timed, and the row names its device."""
    checks = []
    for mod, name in ((field25519, "mul_selfcheck"),
                      (bls381, "selfcheck")):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda device=None, _r=real, _n=name:
            (checks.append((_n, device)), _r(device=device))[1])
    rows = bench.measure_batch(sizes=(2,), device="cpu")
    assert checks == [("mul_selfcheck", "cpu"), ("selfcheck", "cpu")]
    (row,) = rows
    assert row["n"] == 2 and row["device"] == "cpu"
    for key in ("eddsa_host_ms", "eddsa_device_ms", "bls_aggregate_ms",
                "bls_aggregate_device_ms"):
        assert row[key] > 0, key


def test_bench_cli_no_device_and_msglen(capsys):
    from hotstuff_tpu_torch.offchain.__main__ import main

    main(["batch", "--min", "2", "--max", "2", "--no-device"])
    (row,) = [json.loads(line) for line in
              capsys.readouterr().out.splitlines()]
    assert set(row) == {"workload", "n", "eddsa_host_ms",
                        "bls_aggregate_ms"}
    rows = bench.measure_message_length(lengths=(64, 704, 6400), iters=2)
    assert [r["msg_len"] for r in rows] == [64, 704, 6400]
    assert all(r["verify_ms"] > 0 for r in rows)


def test_bench_device_columns_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.measure_batch(sizes=(1,))


def test_csv_without_pandas_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas"):
        bench.to_csv([{"n": 1}], str(tmp_path / "rows.csv"))
