"""hotstuff_tpu_torch/__graft_entry__.py on the CPU: ``entry()``'s step
on its arguments, and ``dryrun_multichip(2, device="cpu")`` (a sharded
per-signature step, a whole-backlog scan step and a sharded BLS TC with
its tampered twin on two CPU shards) printing the repository entry's
summary line."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hotstuff_tpu_torch import __graft_entry__ as graft


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_step_verifies_its_example_args():
    fn, args = graft.entry(device="cpu")
    assert [tuple(a.shape) for a in args] == [(8, 32)] * 4
    mask = fn(*args).numpy()
    assert mask.tolist() == [i % 5 != 4 for i in range(8)]


def test_dryrun_multichip_on_two_cpu_shards(capsys):
    line = graft.dryrun_multichip(2, device="cpu")
    # The repository entry's line (__graft_entry__.py), for 8 votes with
    # lane 4 tampered.
    assert line == (
        "dryrun_multichip(2): ok — 7/8 valid (psum bad=1, all 1 "
        "injected-invalid: lanes [4]), chunked shard scan ok, BLS "
        "pairing-product shard ok (3-vote TC shape + tampered twin)")
    assert capsys.readouterr().out.strip() == line


def test_check_lanes_names_each_disagreeing_lane():
    expect = np.array([True, False, True])
    graft._check_lanes("x", expect.copy(), expect)
    with pytest.raises(AssertionError, match="lane 0: false-reject.*"
                       "lane 1: escaped-invalid"):
        graft._check_lanes("x", np.array([False, True, True]), expect)
