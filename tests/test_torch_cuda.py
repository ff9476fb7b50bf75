"""hotstuff_tpu_torch's CUDA kernels on the card, each held exactly to its
plain PyTorch version on the same inputs, and the Ed25519 verify
programs and the BLS12-381 aggregate checks on the card held to the host
references.

Marked ``gpu``: without a card every test skips (the decision is taken
in the ``card`` fixture, never at import).  On a machine with one:
``python -m pytest tests/test_torch_cuda.py -m gpu -p no:xdist
--noconftest`` (tests/conftest.py sets up JAX, which this file does not
use).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hotstuff_tpu_torch.crypto import eddsa as D
from hotstuff_tpu_torch.crypto import ref_ed25519 as ref
from hotstuff_tpu_torch.offchain import bls12381 as host
from hotstuff_tpu_torch.ops import bls381 as B
from hotstuff_tpu_torch.ops import ed25519 as E
from hotstuff_tpu_torch.ops import field381 as F381
from hotstuff_tpu_torch.ops import kern
from hotstuff_tpu_torch.ops.kern import field_mul as K1
from hotstuff_tpu_torch.ops.kern import fq12_chain as FC
from hotstuff_tpu_torch.ops.kern import fq12_tower as FT
from hotstuff_tpu_torch.ops.kern import msm_accum as K3
from hotstuff_tpu_torch.ops.kern import point_chain as PC
from hotstuff_tpu_torch.ops.kern import probe as K0
from hotstuff_tpu_torch.ops.kern import scalar_mont as K2
from hotstuff_tpu_torch.ops.kern import scalar_rlc as SR
from hotstuff_tpu_torch.utils.intmath import L

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda", torch.cuda.current_device())


def _launched(name, fn, grids=1):
    before = kern.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kern.LAUNCHES[name] == before + grids
    return out


def test_probe_on_card(card):
    x = torch.arange(1024, dtype=torch.int32, device=card)
    assert torch.equal(_launched("probe", lambda: K0.probe(x)), x + 1)


@pytest.mark.parametrize("rows", [1, 7, 2048])
def test_field_mul_equals_plain_on_card(card, rows):
    rng = np.random.default_rng(rows)
    a = torch.from_numpy(rng.integers(0, 512, (rows, 32)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 512, (rows, 32)).astype(np.int32))
    a[0] = 511
    a, b = a.to(card), b.to(card)
    got = _launched("field_mul", lambda: K1.field_mul(a, b))
    assert torch.equal(got, K1.field_mul_plain(a, b))


def test_scalar_mont_mul_equals_plain_on_card(card):
    rng = np.random.default_rng(2)
    vals = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(130)]
    vals[0] = 2**256 - 1
    rows = np.array([[(v >> (8 * i)) & 0xFF for i in range(32)]
                     for v in vals], np.int32)
    a = torch.from_numpy(rows).to(card)
    b = torch.from_numpy(np.roll(rows, 1, axis=0)).to(card)
    b[0] = b[1]
    got = _launched("scalar_mont_mul", lambda: K2.scalar_mont_mul(a, b))
    assert torch.equal(got, K2.scalar_mont_mul_plain(a, b))


@pytest.mark.parametrize("b", [2, 4, 8, 32, 64, 256, 2048])
def test_msm_window_accum_equals_plain_on_card(card, b):
    rng = np.random.default_rng(b)
    base = E.basepoint_ext(card).expand(1, 4, 32)
    pts = E.msm_table(base)[0, 1:].repeat(b // 15 + 1, 1, 1)[:b]
    table = E.msm_table(pts.contiguous()).contiguous()
    digits = torch.from_numpy(
        rng.integers(0, 16, (b, 64)).astype(np.int32)).to(card)
    digits[b // 2:] = 0
    # One grid up to 64 points (the finish alone), then fold + finish.
    got = _launched("msm_window_accum",
                    lambda: K3.msm_window_accum(table, digits),
                    grids=1 if b <= 64 else 2)
    assert torch.equal(got, K3.msm_window_accum_plain(table, digits))


def _scalar_rows(vals) -> np.ndarray:
    return np.array([[(v >> (8 * i)) & 0xFF for i in range(32)]
                     for v in vals], np.int32)


@pytest.mark.parametrize("rows", [1, 7, 128, 1024])
def test_rlc_scalars_equals_plain_on_card(card, rows):
    rng = np.random.default_rng(rows)

    def rand(bound):
        return [int.from_bytes(rng.bytes(32), "little") % bound
                for _ in range(rows)]

    zv, kv, sv = rand(L), rand(L), rand(L)
    zv[0] = 0                                  # an excluded row
    if rows > 3:
        zv[1], kv[1], sv[1] = 1, L - 1, L - 1
        zv[2], sv[2] = L - 1, 2**256 - 1       # S up to the headroom
    z, k, s = (torch.from_numpy(_scalar_rows(v)).to(card)
               for v in (zv, kv, sv))
    got = _launched("rlc_scalars", lambda: SR.rlc_scalars(z, k, s))
    want = SR.rlc_scalars_plain(z, k, s)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_rlc_reduce_equals_plain_on_card(card):
    rng = np.random.default_rng(11)
    sums = rng.integers(0, 1 << 24, (64, 32)).astype(np.int32)
    sums[0] = 0
    sums[1] = (1 << 24) - 1
    sums[2] = _scalar_rows([L - 1])[0] * 1024  # 1024 rows of L - 1
    sums = torch.from_numpy(sums).to(card)
    for x in (sums, sums[5]):
        got = _launched("rlc_reduce", lambda: SR.rlc_reduce(x))
        assert torch.equal(got, SR.rlc_reduce_plain(x))


def test_msm_window_accum_rejects_one_point_on_card(card):
    table = E.msm_table(E.basepoint_ext(card).expand(1, 4, 32)).contiguous()
    digits = torch.ones((1, 64), dtype=torch.int32, device=card)
    before = kern.LAUNCHES["msm_window_accum"]
    with pytest.raises(ValueError, match="at least 2 points"):
        K3.msm_window_accum(table, digits)
    assert kern.LAUNCHES["msm_window_accum"] == before


def test_verify_programs_on_card_match_reference(card):
    keys = [ref.generate_keypair(bytes([9, i]) * 16) for i in range(20)]
    msgs = [bytes([i]) * 32 for i in range(20)]
    sigs = [ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    pks = [pk for _, pk in keys]
    sigs[3] = ref.sign(keys[3][0], b"other")
    want = [ref.verify(pk, m, s) for m, pk, s in zip(msgs, pks, sigs)]
    assert D.verify_batch(msgs, pks, sigs, device=card).tolist() == want
    assert D.verify_batch_rlc(msgs, pks, sigs, device=card).tolist() == want


def _multiples(rows, rng):
    """(rows, 4, 32) ext points on the CPU: the base point's multiples 1B
    .. 15B in a random order (inputs made without the kernels)."""
    mult = PC.point_multiples_plain(E.basepoint_ext().expand(1, 4, 32),
                                    cached=False, negate=False)[0, 1:]
    return mult[torch.from_numpy(rng.integers(0, 15, rows))].contiguous()


@pytest.mark.parametrize("rows", [1, 7, 256])
def test_decompress_equals_plain_on_card(card, rows):
    rng = np.random.default_rng(rows)
    enc = rng.integers(0, 256, (rows, 32)).astype(np.uint8)
    keys = [ref.generate_keypair(bytes([5, i]) * 16)[1]
            for i in range(min(rows, 4))]
    for i, pk in enumerate(keys):
        enc[i] = np.frombuffer(pk, np.uint8)
    if rows > 5:
        enc[5] = np.frombuffer((1 | (1 << 255)).to_bytes(32, "little"),
                               np.uint8)               # x = 0 with sign 1
    y, s = E.split_y_sign(torch.from_numpy(enc).to(card))
    pts, ok = _launched("decompress", lambda: PC.decompress(y, s))
    want_pts, want_ok = PC.decompress_plain(y, s)
    assert torch.equal(ok, want_ok) and bool(ok[:len(keys)].all())
    assert torch.equal(pts, want_pts)


@pytest.mark.parametrize("rows", [1, 7, 8, 256, 1024])
def test_point_multiples_equals_plain_on_card(card, rows):
    pts = _multiples(rows, np.random.default_rng(rows)).to(card)
    for cached, negate in ((False, False), (True, True), (True, False)):
        got = _launched("point_multiples",
                        lambda: PC.point_multiples(pts, cached, negate))
        assert torch.equal(
            got, PC.point_multiples_plain(pts, cached, negate))


@pytest.mark.parametrize("per_row,per_step", [(False, False), (True, False),
                                              (False, True), (True, True)])
@pytest.mark.parametrize("rows", [1, 7, 256])
def test_point_ladder_equals_plain_on_card(card, rows, per_row, per_step):
    rng = np.random.default_rng(rows)
    steps = 6
    base = PC.point_multiples_plain(_multiples(rows, rng), cached=True,
                                    negate=False)        # (rows, 16, 4, 32)
    table = torch.stack([base.roll(s, dims=0) for s in range(steps)], dim=1)
    table = table[:, :steps if per_step else 1]
    table = (table if per_row else table[:1]).contiguous().to(card)
    digits = torch.from_numpy(
        rng.integers(0, 16, (rows, steps)).astype(np.int32)).to(card)
    for ndbl in (4, 0):
        got = _launched("point_ladder",
                        lambda: PC.point_ladder(table, digits, ndbl))
        assert torch.equal(got, PC.point_ladder_plain(table, digits, ndbl))


@pytest.mark.parametrize("rows", [1, 3, 5, 130])
def test_point_ladder_shapes_equal_plain_on_card(card, rows):
    """point_ladder at the committee's 3 rows, an odd row count (the
    second warp of a block idle), past one row per SM, on shared,
    per-step and all-511 tables; one launch, counted as point_ladder."""
    rng = np.random.default_rng(rows + 40)
    steps = 5
    base = PC.point_multiples_plain(_multiples(rows, rng), cached=True,
                                    negate=False)        # (rows, 16, 4, 32)
    table = torch.stack([base.roll(s, dims=0) for s in range(steps)], dim=1)
    digits = torch.from_numpy(
        rng.integers(0, 16, (rows, steps)).astype(np.int32)).to(card)
    for tab in (table[:, :1].contiguous().to(card),
                table.contiguous().to(card),
                torch.full((rows, 1, 16, 4, 32), 511, dtype=torch.int32,
                           device=card)):
        for ndbl in (4, 0):
            got = _launched("point_ladder", lambda: PC.point_ladder(
                tab, digits, ndbl))
            assert torch.equal(got, PC.point_ladder_plain(tab, digits, ndbl))


def test_point_chain_wrappers_reject_bad_inputs_on_card(card):
    pts = _multiples(2, np.random.default_rng(0)).to(card)
    table = PC.point_multiples_plain(pts, True, False).unsqueeze(1)
    digits = torch.zeros((2, 3), dtype=torch.int32, device=card)
    y = torch.zeros((2, 32), dtype=torch.int32, device=card)
    sign = torch.zeros((2,), dtype=torch.int32, device=card)
    before = dict(kern.LAUNCHES)
    bad = [lambda: PC.point_ladder(table, digits.long(), 4),
           lambda: PC.point_ladder(table, digits[:1], 4),
           lambda: PC.point_ladder(table.transpose(0, 1), digits, 4),
           lambda: PC.decompress(y.long(), sign),
           lambda: PC.decompress(y[:, :16].contiguous(), sign),
           lambda: PC.point_multiples(pts[:, :3].contiguous()),
           lambda: PC.point_multiples(pts.float())]
    for call in bad:
        with pytest.raises((TypeError, ValueError)):
            call()
    torch.cuda.synchronize()
    assert kern.LAUNCHES == before


# ---------------------------------------------------------------------------
# The BLS12-381 Fq12 chain kernels (fq12_chain.cu)
# ---------------------------------------------------------------------------

def _fq12_rows(rows, rng):
    """(rows, 12, 48) Montgomery Fq12 elements on the CPU: random
    residues, with one row of all-511 weak limbs (the bound)."""
    out = np.stack([B.host_fq12_to_mont_limbs(
        [int.from_bytes(rng.bytes(48), "little") % F381.Q
         for _ in range(12)]) for _ in range(rows)])
    out[0, :, :] = 511
    return torch.from_numpy(out)


def _lines(n, tag):
    """(n, 63, 2, 12, 48) real Miller lines: n - 1 (pk, H(m)) rows and
    the (-g1, signature) row, from the host reference."""
    keys = [host.key_gen(bytes([tag, i]) * 16) for i in range(n - 1)]
    rows = [B.miller_lines(pk, host.hash_to_g2(bytes([i]) * 32))
            for i, (_, pk) in enumerate(keys)]
    sig = host.sign(keys[0][0], b"\x00" * 32)
    rows.append(B.miller_lines(host.g1_neg(host.g1_generator()), sig))
    return torch.from_numpy(np.stack(rows))


@pytest.mark.parametrize("rows", [1, 7, 68])
def test_fq12_mul_equals_plain_on_card(card, rows):
    rng = np.random.default_rng(rows)
    x, y = _fq12_rows(rows, rng).to(card), _fq12_rows(rows, rng).to(card)
    got = _launched("fq12_mul", lambda: FC.fq12_mul(x, y))
    assert torch.equal(got, FC.fq12_mul_plain(x, y))
    got = _launched("fq12_mul", lambda: FC.fq12_mul(x, x))
    assert torch.equal(got, FC.fq12_mul_plain(x, x))


@pytest.mark.parametrize("rows", [1, 2, 68])
def test_miller_accumulate_equals_plain_on_card(card, rows):
    """Real lines (four rows tiled), with one dense random line and one
    row of lines all equal to one, so the skip, sparse and dense branches
    all run; canonical limbs, exact."""
    lines = _lines(4, 4).repeat(rows, 1, 1, 1, 1)[:rows].clone()
    lines[0, 9, 1] = _fq12_rows(2, np.random.default_rng(rows))[1]
    if rows > 1:
        lines[-1] = B.fq12_one((lines.shape[1], 2))
    lines = lines.to(card)
    got = _launched("miller_accumulate", lambda: FT.miller_accumulate(lines))
    before = dict(FT.BRANCHES)
    assert torch.equal(got, FT.miller_accumulate_plain(lines))
    assert all(FT.BRANCHES[k] > before[k] for k in ("skip", "sparse",
                                                     "dense"))


def _easy_part_rows(rows, rng):
    """(rows, 12, 48) easy-part outputs f^((q^6 - 1)(q^2 + 1)) of random
    f: the cyclotomic subgroup, fq12_hard_pow's domain (made by the plain
    operators on the CPU)."""
    f = _fq12_rows(rows, rng)
    f1 = B.fq12_mul(B.fq12_frobenius(f, 6), B.fq12_inv(f))
    return B.fq12_mul(B.fq12_frobenius(f1, 2), f1).contiguous()


@pytest.mark.parametrize("rows", [1, 3])
def test_fq12_hard_pow_equals_plain_on_card(card, rows):
    x = _easy_part_rows(rows, np.random.default_rng(rows)).to(card)
    got = _launched("fq12_hard_pow", lambda: FT.fq12_hard_pow(x))
    assert torch.equal(got, FT.fq12_hard_pow_plain(x))
    assert int(got.max()) < 256


@pytest.mark.parametrize("p", [2, 68])
def test_final_exp_equals_plain_on_card(card, p):
    """Real Miller values of a statement of p pairings (the QC's 2, the
    TC's 68, tiled from four real rows) as row 0, random values as row 1,
    a product equal to one (x, x^-1, ones) as row 2 and a zero value in
    row 3: the verdicts and the canonical limbs, exact."""
    rng = np.random.default_rng(p)
    real = FT.miller_accumulate_plain(_lines(4, 9))
    fs = torch.stack([real.repeat(p // 4 + 1, 1, 1)[:p],
                      _fq12_rows(p, rng), _fq12_rows(p, rng),
                      _fq12_rows(p, rng)])
    x = fs[2, 0:1]
    fs[2, 1] = B.fq12_inv(x)[0]
    fs[2, 2:] = B.fq12_one((p - 2,))
    fs[3, p // 2] = 0
    fs = fs.to(card)
    ok, got = _launched("final_exp", lambda: FT.final_exp(fs))
    want_ok, want = FT.final_exp_plain(fs)
    assert torch.equal(got, want) and torch.equal(ok, want_ok)
    assert ok.tolist()[1:] == [False, True, False]
    assert int(got[3].abs().sum()) == 0


@pytest.mark.parametrize("rows,exponent", [(1, "hard"), (3, 0), (3, 77777)])
def test_fq12_pow_equals_plain_on_card(card, rows, exponent):
    e = B._HARD_EXP if exponent == "hard" else exponent
    x = _fq12_rows(rows, np.random.default_rng(rows)).to(card)
    got = _launched("fq12_pow", lambda: FC.fq12_pow(x, e))
    assert torch.equal(got, FC.fq12_pow_plain(x, e))


@pytest.mark.parametrize("rows", [1, 33])
def test_fq_pow_equals_plain_on_card(card, rows):
    x = _fq12_rows(rows, np.random.default_rng(rows))[:, 0].contiguous()
    x[-1] = 0                                     # inv(0) = 0
    x = x.to(card)
    got = _launched("fq_pow", lambda: FC.fq_pow(x, F381.Q - 2))
    assert torch.equal(got, FC.fq_pow_plain(x, F381.Q - 2))


def test_fq12_chain_wrappers_reject_bad_inputs_on_card(card):
    x = _fq12_rows(2, np.random.default_rng(0)).to(card)
    lines = torch.zeros((2, 3, 2, 12, 48), dtype=torch.int32, device=card)
    before = dict(kern.LAUNCHES)
    bad = [lambda: FC.fq12_mul(x, x[:1]),
           lambda: FC.fq12_mul(x.long(), x.long()),
           lambda: FC.fq12_mul(x.transpose(0, 1), x.transpose(0, 1)),
           lambda: FT.miller_accumulate(lines[:, :, 0]),
           lambda: FT.miller_accumulate(lines.long()),
           lambda: FT.miller_accumulate(lines.to("meta")),
           lambda: FT.fq12_hard_pow(x[:, :6].contiguous()),
           lambda: FT.fq12_hard_pow(x.long()),
           lambda: FT.fq12_hard_pow(x.transpose(1, 2).contiguous()),
           lambda: FT.fq12_hard_pow(x[:, :, ::2]),
           lambda: FT.fq12_hard_pow(x.to("meta")),
           lambda: FT.final_exp(x),
           lambda: FT.final_exp(x[:, None].long()),
           lambda: FT.final_exp(x[:, None][:, :0].contiguous()),
           lambda: FT.final_exp(x[:1].expand(2, 3, 12, 48)),
           lambda: FC.fq12_pow(x[:, :6].contiguous(), 5),
           lambda: FC.fq12_pow(x, -1),
           lambda: FC.fq_pow(x[:, :, :47].contiguous(), 5)]
    for call in bad:
        with pytest.raises((TypeError, ValueError)):
            call()
    torch.cuda.synchronize()
    assert kern.LAUNCHES == before


def test_bls_aggregate_checks_on_card_match_host(card):
    keys = [host.key_gen(bytes([7, i]) * 16) for i in range(4)]
    pks = [pk for _, pk in keys]
    msg = b"\x11" * 32
    agg = host.aggregate([host.sign(sk, msg) for sk, _ in keys])
    forged = host.aggregate([host.sign(sk, msg) for sk, _ in keys[:3]]
                            + [host.sign(keys[3][0], b"other")])
    for sig in (agg, forged):
        assert B.verify_aggregate_common(pks, msg, sig, device=card) == \
            host.verify_aggregate_common(pks, msg, sig)
    msgs = [bytes([i]) * 32 for i in range(4)]
    agg_m = host.aggregate([host.sign(sk, m) for (sk, _), m in zip(keys, msgs)])
    assert B.verify_aggregate_multi(pks, msgs, agg_m, device=card)
    assert not B.verify_aggregate_multi(pks, msgs[::-1], agg_m, device=card)


@pytest.mark.parametrize("kind", ["QC", "forged QC", "TC"])
def test_pairings_check_on_card_runs_the_tower_kernels(card, kind):
    """One pairing check per statement: the verdict equals the host's,
    and the check launches miller_accumulate and final_exp once each and
    no other kernel (fq12_hard_pow's chain runs inside final_exp; the
    flat fq12_mul, fq_pow and fq12_pow are off the path)."""
    keys = [host.key_gen(bytes([8, i]) * 16) for i in range(3)]
    pks = [pk for _, pk in keys]
    msgs = [b"\x12" * 32] * 3 if kind != "TC" else \
        [bytes([i]) * 32 for i in range(3)]
    sigs = [host.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    if kind == "forged QC":
        sigs[2] = host.sign(keys[2][0], b"other")
    agg = host.aggregate(sigs)
    rows = B.multi_pairing_rows(pks, msgs, agg)
    lines = torch.from_numpy(np.stack(rows)).to(card)
    kern.reset_launches()
    got = bool(B.pairings_check(lines).item())
    torch.cuda.synchronize()
    assert got == host.verify_aggregate(pks, msgs, agg) == (kind != "forged QC")
    assert {k: v for k, v in kern.LAUNCHES.items() if v} == {
        "miller_accumulate": 1, "final_exp": 1}


@pytest.mark.parametrize("rows", [1, 17, 68])
def test_fq12_product_equals_plain_on_card(card, rows):
    """The shard's fold: the product of ``rows`` Fq12 values (random
    Montgomery limbs, all-511 weak limbs in row 0), exact against its
    plain version, one launch."""
    x = _fq12_rows(rows, np.random.default_rng(70 + rows)).to(card)
    got = _launched("fq12_product", lambda: FT.fq12_product(x))
    assert torch.equal(got, FT.fq12_product_plain(x))


def _mesh_batch(n, forged=()):
    keys = [ref.generate_keypair(bytes([71, i]) * 16) for i in range(n)]
    msgs = [bytes([72, i]) * 16 for i in range(n)]
    sigs = [ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    for i in forged:
        sigs[i] = ref.sign(keys[i][0], b"forged")
    return msgs, [pk for _, pk in keys], sigs


def test_two_shard_mesh_on_card_rlc_and_bls(card):
    """A 2-shard virtual_mesh on the card: the sharded RLC program on a
    valid batch (one combined check, launches on both shards and the
    lead) and on a batch with a forged vote (bisection), masks equal to
    the one-card program's; the sharded BLS TC true and forged, equal to
    the host reference."""
    from hotstuff_tpu_torch.offchain import bls12381 as pbls
    from hotstuff_tpu_torch.parallel import sharded_bls, sharded_verify
    from hotstuff_tpu_torch.parallel.mesh import virtual_mesh

    mesh = virtual_mesh(2, card)
    for forged in ((), (5,)):
        msgs, pks, sigs = _mesh_batch(20, forged)
        want = D.verify_batch(msgs, pks, sigs, device=card)
        mesh.reset_launches()
        bisected = []
        got = sharded_verify.verify_rlc_sharded_pack(
            mesh, D.prepare_batch(msgs, pks, sigs),
            on_bisect=lambda: bisected.append(1))()()
        assert got.tolist() == want.tolist()
        assert got.sum() == 20 - len(forged)
        assert bisected == ([1] if forged else [])
        for shard in (0, 1):
            assert mesh.launches[shard]["msm_window_accum"] >= 1
        assert mesh.launches["lead"]["rlc_reduce"] >= 1
    keys = [pbls.key_gen(bytes([73, i]) * 16) for i in range(3)]
    pks = [pk for _, pk in keys]
    msgs = [bytes([i]) * 32 for i in range(3)]
    sigs = [pbls.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    for agg, want in ((pbls.aggregate(sigs), True),
                      (pbls.aggregate(sigs[:2] + [pbls.sign(keys[2][0],
                                                            b"x")]), False)):
        mesh.reset_launches()
        assert sharded_bls.verify_aggregate_multi_sharded(
            mesh, pks, msgs, agg) is want
        assert host.verify_aggregate(pks, msgs, agg) is want
        assert mesh.launches == {
            0: {"miller_accumulate": 1, "fq12_product": 1},
            1: {"miller_accumulate": 1, "fq12_product": 1},
            "lead": {"final_exp": 1}}


def test_cadence_ring_on_card_qc_of_67(card):
    """A ring engine on the card (depth pinned at 2, a launch guard): a
    QC of 67 with one forged vote gets ref_ed25519's mask, its launches
    run under the ``tick:`` class and the kernels of the RLC program and
    its bisection ran."""
    import threading

    from hotstuff_tpu_torch.sidecar import protocol as proto
    from hotstuff_tpu_torch.sidecar import service
    from hotstuff_tpu_torch.sidecar.guard import LaunchDeadlines, LaunchGuard
    from hotstuff_tpu_torch.sidecar.ring import CadenceRing, RingDepth

    keys = [ref.generate_keypair(bytes([74, i]) * 16) for i in range(67)]
    msg = b"\x75" * 32
    sigs = [ref.sign(sk, msg) for sk, _ in keys]
    sigs[9] = ref.sign(keys[9][0], b"forged")
    pks = [pk for _, pk in keys]
    want = [ref.verify(pk, msg, s) for pk, s in zip(pks, sigs)]
    engine = service.VerifyEngine(
        device=card, ring_factory=lambda e: CadenceRing(
            e, depth=RingDepth(pinned=2)))
    guard = LaunchGuard(deadlines=LaunchDeadlines(warm_boot=True))
    try:
        service.warmup(engine)
        engine._guard = guard
        got, done = [], threading.Event()
        kern.reset_launches()
        assert engine.submit(proto.VerifyRequest(1, [msg] * 67, pks, sigs),
                             lambda m: (got.append(m), done.set()))
        assert done.wait(120)
        assert got == [want]
        assert kern.LAUNCHES["rlc_scalars"] >= 1
        assert kern.LAUNCHES["point_ladder"] >= 1
        cad = engine.stats_snapshot()["cadence"]
        assert cad["enabled"] and cad["dispatch_ticks"] >= 1
        assert any(k.startswith("tick:")
                   for k in guard.snapshot()["deadlines"])
    finally:
        engine.stop()
        guard.close()


@pytest.mark.parametrize("check", ["field25519", "field381", "bls381"])
def test_selfchecks_on_card(card, check):
    from hotstuff_tpu_torch.ops import field25519

    fn = {"field25519": field25519.mul_selfcheck,
          "field381": F381.mul_selfcheck, "bls381": B.selfcheck}[check]
    before = dict(kern.LAUNCHES)
    fn(device=card)
    torch.cuda.synchronize()
    launched = {k for k, v in kern.LAUNCHES.items() if v != before[k]}
    assert launched == {"field25519": {"field_mul"}, "field381": set(),
                        "bls381": {"fq12_mul"}}[check]


def test_offchain_verify_batch_device_at_300(card):
    from hotstuff_tpu_torch.offchain import eddsa as off

    keys = [off.key_gen(bytes([76, i % 256, i // 256, 0]) * 8)
            for i in range(300)]
    msgs = [bytes([77, i % 256]) * 16 for i in range(300)]
    sigs = [off.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    sigs[123] = off.sign(keys[123][0], b"forged")
    pks = [pk for _, pk in keys]
    assert off.verify_batch_device(msgs, pks, sigs, device=card) == \
        off.verify_batch_host(msgs, pks, sigs)
    assert sum(off.verify_batch_device(msgs, pks, sigs)) == 299
