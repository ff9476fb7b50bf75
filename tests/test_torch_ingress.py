"""The port's signed-ingress pieces against the JAX package's: the
signed-transaction codec (crypto/txsign.py) byte for byte, the seeded
multi-user arrival model (harness/loadgen.py) arrival for arrival, and
the bench's ``users`` probe on a host-mode engine.  Neither reference
module imports JAX."""

from __future__ import annotations

import random

import pytest

from hotstuff_tpu.crypto import txsign as rtx
from hotstuff_tpu.harness import loadgen as rload
from hotstuff_tpu_torch.crypto import txsign as ptx
from hotstuff_tpu_torch.harness import loadgen as pload

CONSTANTS = ("TX_FRAME_VERSION", "TX_PK_LEN", "TX_NONCE_LEN", "TX_LEN_LEN",
             "TX_SIG_LEN", "TX_FRAME_HEADER_LEN", "TX_FRAME_OVERHEAD",
             "TX_MIN_PAYLOAD", "TX_MAX_PAYLOAD", "TX_MARKER_SAMPLE",
             "TX_MARKER_FILLER", "TX_MARKER_FORGED", "TX_SIGN_DOMAIN",
             "TX_KEY_DOMAIN", "INGRESS_CTX")


@pytest.mark.parametrize("name", CONSTANTS)
def test_txsign_constants_equal_the_reference(name):
    assert getattr(ptx, name) == getattr(rtx, name)


def test_sidecar_takes_its_ingress_tag_from_txsign():
    from hotstuff_tpu_torch.sidecar import service

    assert service.INGRESS_CTX is ptx.INGRESS_CTX


@pytest.mark.parametrize("seed,user", [(0, 0), (7, 1), (7, 123456),
                                       (2 ** 40, 999_999)])
def test_user_seed_and_keypair_equal_the_reference(seed, user):
    assert ptx.derive_user_seed(seed, user) == \
        rtx.derive_user_seed(seed, user)
    assert ptx.derive_user_keypair(seed, user) == \
        rtx.derive_user_keypair(seed, user)


def test_frames_records_and_verdicts_equal_the_reference():
    """Signed frames (honest, forged, padded payloads), their parse,
    admission records and host verdicts: the same bytes and answers."""
    rng = random.Random(5)
    for i in range(6):
        user = rng.randrange(10 ** 6)
        forge = i % 3 == 2
        size = rtx.TX_MIN_PAYLOAD + rng.randrange(64)
        marker = rtx.TX_MARKER_FORGED if forge else rtx.TX_MARKER_FILLER
        frames = []
        for mod in (rtx, ptx):
            kp = mod.derive_user_keypair(7, user)
            frames.append(mod.build_signed_tx(
                kp, nonce=i, payload=mod.build_payload(marker, i, size),
                flip_sig_bit=forge))
        assert frames[0] == frames[1]
        frame = frames[0]
        assert tuple(ptx.parse_signed_tx(frame)) == \
            tuple(rtx.parse_signed_tx(frame))
        assert ptx.admission_record(frame) == rtx.admission_record(frame)
        assert ptx.verify_tx(frame) == rtx.verify_tx(frame) == (not forge)


@pytest.mark.parametrize("frame,reason", [
    (b"", "not-signed"), (b"\x01" + b"\x00" * 200, "not-signed"),
    (b"\x02" + b"\x00" * 50, "truncated"),
    (b"\x02" + b"\x00" * 40 + (5).to_bytes(4, "big") + b"\x00" * 80,
     "bad-payload-len"),
    (b"\x02" + b"\x00" * 40 + (20).to_bytes(4, "big") + b"\x00" * 80,
     "bad-payload-len")])
def test_malformed_frames_fail_as_the_reference(frame, reason):
    with pytest.raises(rtx.TxFrameError) as r:
        rtx.parse_signed_tx(frame)
    with pytest.raises(ptx.TxFrameError) as p:
        ptx.parse_signed_tx(frame)
    assert p.value.reason == r.value.reason == reason
    assert ptx.verify_tx(frame) is rtx.verify_tx(frame) is False


def test_keyring_lru_equals_the_reference():
    seq = [1, 2, 3, 1, 4, 5, 2, 1, 6, 3]
    rings = [rtx.UserKeyring(seed=3, capacity=3),
             ptx.UserKeyring(seed=3, capacity=3)]
    for u in seq:
        assert rings[0].get(u) == rings[1].get(u)
        assert len(rings[0]) == len(rings[1])
    assert rings[0].derivations == rings[1].derivations == 9


def _drive(mod, **kw):
    """One seeded stream on a virtual clock with BUSY backoff: the
    arrivals per tick, the users in order, the counters."""
    load = mod.UserLoad(**kw)
    ticks, users = [], []
    for k in range(1, 400):
        t = k * 0.01
        ticks.append(load.arrivals(t, users))
        if k % 50 == 0:
            load.busy(t, 0.03)
    gaps = [load.sample_gap(t * 0.5) for t in range(5)]
    return (ticks, users, gaps, load.sent, load.deferred, load.busy_events,
            [load.profile(t) for t in (0.0, 100.0, 450.0)])


@pytest.mark.parametrize("kw", [
    dict(rate=200.0, users=50, seed=11),
    dict(rate=64.0, users=100_000, seed=13),
    dict(rate=500.0, users=20, seed=3, dist="pareto", alpha=1.8),
    dict(rate=80.0, users=7, seed=9, diurnal_amp=0.5,
         diurnal_period_s=2.0, busy_base_s=0.02)])
def test_user_load_arrivals_equal_the_reference(kw):
    assert _drive(pload, **kw) == _drive(rload, **kw)


@pytest.mark.parametrize("kw", [dict(rate=0.0, users=1),
                                dict(rate=1.0, users=0),
                                dict(rate=1.0, users=1, dist="zipf")])
def test_user_load_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        rload.UserLoad(**kw)
    with pytest.raises(ValueError):
        pload.UserLoad(**kw)


def test_users_probe_rejects_every_forgery_on_a_host_engine():
    """The bench's ``users`` field at a small population: every honest
    frame verified, every forged one rejected, the bulk lane all
    ingress-fed (INGRESS_CTX), with the reference's keys per point."""
    import ast
    import os

    from hotstuff_tpu_torch import bench

    out = bench.users_headline_probe(populations=(500,), txs_per_point=24)
    point = out["u500"]
    assert out["ok"] and point["point_ok"]
    assert point["forged_sent"] >= 1
    assert point["forged_rejected"] == point["forged_sent"]
    assert point["verified"] == point["txs"] - point["forged_sent"]
    assert point["bulk_ingress_share"] == 1.0
    # The point's keys are the reference probe's (its dict literal).
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "users_headline_probe")
    point_dict = next(n.value for n in ast.walk(fn)
                      if isinstance(n, ast.Assign)
                      and isinstance(n.value, ast.Dict)
                      and any(isinstance(k, ast.Constant)
                              and k.value == "users" for k in n.value.keys))
    assert set(point) == {k.value for k in point_dict.keys}
