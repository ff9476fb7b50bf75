"""The whole BLS12-381 aggregate check of hotstuff_tpu_torch/ops/bls381.py
on the CPU (the Fq12 chain kernels' plain versions) against both host
references, hotstuff_tpu/offchain/bls12381.py and the port's copy, on a
4-key committee: a valid same-digest aggregate, one signed over another
digest, one checked against the wrong key, one that is on the curve but
outside the prime-order subgroup, and a distinct-digest aggregate of 4
votes, valid and with its digests swapped.  (The JAX package's compiled
check takes minutes to build on this CPU, so the host references are the
oracle here; the pieces are held to the JAX package limb for limb in
test_torch_bls381.py and test_torch_bls381_loops.py.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hotstuff_tpu.offchain import bls12381 as jhost
from hotstuff_tpu_torch.offchain import bls12381 as host
from hotstuff_tpu_torch.ops import bls381 as D
from hotstuff_tpu_torch.ops import kern

MSG = b"\x77" * 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The plain Fq12 chains are thousands of small operators; one thread
    # each keeps parallel test workers (pytest-xdist) from
    # oversubscribing the CPU.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def committee():
    keys = [host.key_gen(bytes([60 + i]) * 32) for i in range(4)]
    return [sk for sk, _ in keys], [pk for _, pk in keys]


def _off_subgroup_point():
    """A point of E'(Fq2) outside G2: a curve point before the cofactor
    clearing of hash_to_g2."""
    counter = 0
    while True:
        x = (counter + 5, 7)
        y2 = host.fq2_add(host.fq2_mul(host.fq2_mul(x, x), x), host._fq2.b)
        y = host._fq2_sqrt(y2)
        if y is not None and not host.g2_in_subgroup((x, y)):
            return (x, y)
        counter += 1


def _statements(committee):
    """(pks, agg) same-digest statements over MSG."""
    sks, pks = committee
    agg = host.aggregate([host.sign(sk, MSG) for sk in sks])
    other = host.aggregate([host.sign(sk, MSG) for sk in sks[:3]]
                           + [host.sign(sks[3], b"\x78" * 32)])
    wrong_key = list(pks)
    wrong_key[1] = host.key_gen(b"\x99" * 32)[1]
    off = host.g2_add(agg, _off_subgroup_point())
    assert host.g2_on_curve(off) and not host.g2_in_subgroup(off)
    return [("valid", pks, agg), ("other digest", pks, other),
            ("wrong key", wrong_key, agg), ("off subgroup", pks, off)]


def test_common_message_checks_match_both_host_references(committee):
    cases = _statements(committee)
    want = []
    for _, pks, agg in cases:
        verdicts = {host.verify_aggregate_common(pks, MSG, agg),
                    jhost.verify_aggregate_common(pks, MSG, agg)}
        assert len(verdicts) == 1
        want.append(verdicts.pop())
    assert want == [True, False, False, False]
    # All four checks in one batched call of the pairing check ...
    neg_g1 = host.g1_neg(host.g1_generator())
    h = host.hash_to_g2(MSG)
    lines = []
    for _, pks, agg in cases:
        apk = pks[0]
        for pk in pks[1:]:
            apk = host.g1_add(apk, pk)
        lines.append([D.miller_lines(apk, h), D.miller_lines(neg_g1, agg)])
    before = dict(kern.LAUNCHES)
    got = D.pairings_check(torch.from_numpy(np.asarray(lines)))
    assert got.tolist() == want
    assert kern.LAUNCHES == before          # the plain route counts nothing
    # ... and the valid one through the entry.
    assert D.verify_aggregate_common(cases[0][1], MSG, cases[0][2],
                                     device="cpu")


def test_distinct_digest_check_matches_both_host_references(committee):
    sks, pks = committee
    msgs = [bytes([i]) * 32 for i in range(4)]
    agg = host.aggregate([host.sign(sk, m) for sk, m in zip(sks, msgs)])
    assert host.verify_aggregate(pks, msgs, agg)
    assert jhost.verify_aggregate(pks, msgs, agg)
    assert D.verify_aggregate_multi(pks, msgs, agg, device="cpu")
    swapped = msgs[1:] + msgs[:1]
    assert not host.verify_aggregate(pks, swapped, agg)
    assert not D.verify_aggregate_multi(pks, swapped, agg, device="cpu")


def test_malformed_inputs_reject_before_the_device(committee):
    _, pks = committee
    agg = host.aggregate([host.sign(1234, MSG)])
    not_on_curve = (agg[0], host.fq2_add(agg[1], (1, 0)))
    assert not D.verify_aggregate_common(pks, MSG, not_on_curve, device="cpu")
    assert not D.verify_aggregate_common(pks, MSG, None, device="cpu")
    assert not D.verify_aggregate_common([], MSG, agg, device="cpu")
    assert D.multi_pairing_rows(pks, [MSG] * 3, agg) is None
    assert D.multi_pairing_rows([], [], agg) is None
    assert not D.verify_aggregate_multi(pks[:1], [MSG], not_on_curve,
                                        device="cpu")
