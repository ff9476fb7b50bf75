"""The BLS check's final exponentiation on the CPU: the plain version of
the final_exp kernel (hotstuff_tpu_torch/ops/kern/fq12_tower.py
final_exp_plain) and its tower inverse, against the JAX package's host
bigints (hotstuff_tpu/offchain/bls12381.py: fq12_mul, fq12_inv,
final_exponentiate), never the port's copy of that module; and the
pairing check, which now ends in final_exp, against the host verifiers.

Inputs are Miller values of real statements from that module's own
Miller loop (a QC, the QC with a forged signature, a TC of three votes),
a product equal to one, a zero value, and a product whose norm in the
reference's flat fq12_inv has a top limb of 224 or more (where the JAX
package's device inverse is wrong, ROADMAP Queue C; here it is compared
with the host bigints only).  numpy seeds, one torch thread; every
comparison is exact (canonical residues, tolerance 0).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hotstuff_tpu.offchain import bls12381 as ref
from hotstuff_tpu_torch.ops import bls381 as D
from hotstuff_tpu_torch.ops import field381 as F
from hotstuff_tpu_torch.ops import kern
from hotstuff_tpu_torch.ops.kern import fq12_chain as FC
from hotstuff_tpu_torch.ops.kern import fq12_tower as T

Q = F.Q
MSG = b"\x61" * 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The plain chains are thousands of small operators; one thread each
    # keeps parallel test workers (pytest-xdist) from oversubscribing the
    # CPU.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mont(vals) -> torch.Tensor:
    return torch.from_numpy(np.stack([D.host_fq12_to_mont_limbs(v)
                                      for v in vals]))


def _values(x) -> list:
    """(n, 12, 48) Montgomery limbs -> host Fq12 tuples."""
    c = F.from_mont(torch.as_tensor(x)).numpy()
    return [tuple(F.from_limbs(r) for r in row) for row in c]


def _random(rng, n) -> list:
    return [tuple(int.from_bytes(rng.bytes(48), "little") % Q
                  for _ in range(12)) for _ in range(n)]


def _miller(pk, q_g2):
    return ref.miller_loop(ref._twist(q_g2), ref._cast_g1_fq12(pk))


@pytest.fixture(scope="module")
def committee():
    return [ref.key_gen(bytes([0x70 + i]) * 32) for i in range(3)]


@pytest.fixture(scope="module")
def cases(committee):
    """name -> (the Miller values, P of them, as host Fq12 tuples)."""
    neg_g1 = ref.g1_neg(ref.g1_generator())
    apk = committee[0][1]
    for _, pk in committee[1:]:
        apk = ref.g1_add(apk, pk)
    sigs = [ref.sign(sk, MSG) for sk, _ in committee]
    forged = sigs[:2] + [ref.sign(committee[2][0], b"\x62" * 32)]
    h = ref.hash_to_g2(MSG)
    msgs = [bytes([0x63 + i]) * 32 for i in range(3)]
    tc_sig = ref.aggregate([ref.sign(sk, m)
                            for (sk, _), m in zip(committee, msgs)])
    rng = np.random.default_rng(60)
    x = _random(rng, 16)
    a = _random(np.random.default_rng(61), 1)[0]
    return {
        "QC": [_miller(apk, h), _miller(neg_g1, ref.aggregate(sigs))],
        "forged QC": [_miller(apk, h), _miller(neg_g1, ref.aggregate(forged))],
        # Rows 0 and 8 of seed 60: the product's norm has a top limb of
        # 481 (asserted in test_high_norm_case_is_high).
        "high norm": [x[0], x[8]],
        "one": [a, ref.fq12_inv(a)],
        "zero": [tuple([0] * 12), a],
        "TC": [_miller(pk, ref.hash_to_g2(m))
               for (_, pk), m in zip(committee, msgs)]
        + [_miller(neg_g1, tc_sig)],
    }


@pytest.fixture(scope="module")
def final_exps(cases):
    """name -> (verdict, value as a host Fq12 tuple) from one
    final_exp_plain call: every case in one batch of P = 4 values, the
    shorter ones followed by ones."""
    names = list(cases)
    fs = torch.stack([_mont(cases[n] + [ref.FQ12_ONE] * (4 - len(cases[n])))
                      for n in names])
    before = dict(kern.LAUNCHES)
    ok, got = T.final_exp(fs)
    assert kern.LAUNCHES == before          # the plain route counts nothing
    assert got.shape == (len(names), 12, 48) and int(got.max()) < 256
    return {n: (v, g) for n, v, g in zip(names, ok.tolist(), _values(got))}


def _host_final_exp(values):
    p = values[0]
    for v in values[1:]:
        p = ref.fq12_mul(p, v)
    return ref.final_exponentiate(p)


@pytest.mark.parametrize("name,verdict", [
    ("QC", True), ("forged QC", False), ("high norm", False), ("one", True),
    ("zero", False), ("TC", True)])
def test_final_exp_plain_equals_the_host(cases, final_exps, name, verdict):
    ok, got = final_exps[name]
    want = _host_final_exp(cases[name])
    assert got == want
    assert ok == verdict == (want == ref.FQ12_ONE)


def test_high_norm_case_is_high(cases):
    """The reference's fq12_inv of this product meets a norm whose weak
    top limb is at least fq12_chain.STABLE_TOP (the range where the JAX
    package's f32 inverse loses exactness)."""
    a, b = _mont(cases["high norm"])
    f = D.fq12_mul(a, b)
    g = D.fq12_frobenius(f, 1)
    for k in range(2, 12):
        g = D.fq12_mul(g, D.fq12_frobenius(f, k))
    assert int(D.fq12_mul(f, g)[0, -1]) >= FC.STABLE_TOP


def _sub_element(rng, kind: str, n: int) -> torch.Tensor:
    """n canonical tower elements of a subfield: Fq (value 0), Fq2
    (values 0-1), Fq6 (0-5), Fq12 (all), or zero."""
    width = {"Fq": 1, "Fq2": 2, "Fq6": 6, "Fq12": 12, "zero": 0}[kind]
    vals = [[int.from_bytes(rng.bytes(48), "little") % Q if i < width
             else 0 for i in range(12)] for _ in range(n)]
    return torch.from_numpy(np.stack([np.stack([F.to_limbs(v) for v in row])
                                      for row in vals]))


@pytest.mark.parametrize("kind", ["Fq", "Fq2", "Fq6", "Fq12", "zero"])
def test_tower_inverse_equals_the_host(kind):
    x = _sub_element(np.random.default_rng(62), kind, 2)
    got = T.tower_inv_plain(x)
    assert int(got.max()) < 256
    have = _values(T.tower_to_flat_plain(x))
    inv = _values(T.tower_to_flat_plain(got))
    if kind == "zero":
        assert inv == have == [tuple([0] * 12)] * 2
        return
    assert inv == [ref.fq12_inv(v) for v in have]
    if kind == "Fq":
        # The tower's value 0 is the flat a_0: the plain inverse mod q.
        assert [v[0] for v in inv] == [pow(v[0], -1, Q) for v in have]


def test_fq2_inverse_equals_the_host():
    rng = np.random.default_rng(63)
    vals = [(int.from_bytes(rng.bytes(48), "little") % Q,
             int.from_bytes(rng.bytes(48), "little") % Q) for _ in range(3)]
    vals.append((0, 0))
    x = torch.from_numpy(np.stack([np.stack([F.to_limbs(v * F.R % Q)
                                             for v in pair])
                                   for pair in vals]))
    got = F.from_mont(T.fq2_inv_plain(x)).numpy()
    want = [ref.fq2_inv(v) if any(v) else (0, 0) for v in vals]
    assert [tuple(F.from_limbs(r) for r in row) for row in got] == want


@pytest.fixture(scope="module")
def check_lines(committee):
    """Miller lines of three statements of three pairings each, for one
    batched check: a valid QC and the QC with a forged signature (two
    pairings and a row of lines equal to one, whose Miller value is one),
    and a TC of two votes."""
    neg_g1 = ref.g1_neg(ref.g1_generator())
    keys = committee[:2]
    apk = ref.g1_add(keys[0][1], keys[1][1])
    h = ref.hash_to_g2(MSG)
    sigs = [ref.sign(sk, MSG) for sk, _ in keys]
    forged = [sigs[0], ref.sign(keys[1][0], b"\x64" * 32)]
    ones = np.asarray(D.fq12_one((D.N_STEPS, 2)))
    qcs = [[D.miller_lines(apk, h), D.miller_lines(neg_g1, ref.aggregate(s)),
            ones] for s in (sigs, forged)]
    msgs = [bytes([0x65 + i]) * 32 for i in range(2)]
    agg = ref.aggregate([ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)])
    tc = [D.miller_lines(pk, ref.hash_to_g2(m))
          for (_, pk), m in zip(keys, msgs)] + [D.miller_lines(neg_g1, agg)]
    want = [ref.verify_aggregate_common([pk for _, pk in keys], MSG,
                                        ref.aggregate(s))
            for s in (sigs, forged)]
    want.append(ref.verify_aggregate([pk for _, pk in keys], msgs, agg))
    return np.asarray(qcs + [tc]), want


def test_pairings_check_verdicts_equal_the_host(check_lines):
    lines, want = check_lines
    assert want == [True, False, True]
    before = dict(kern.LAUNCHES)
    assert D.pairings_check(torch.from_numpy(lines)).tolist() == want
    assert kern.LAUNCHES == before
