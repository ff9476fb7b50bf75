"""hotstuff_tpu_torch.parallel.sharded_bls on CPU shards, one torch
thread:

* fq12_product's plain version (the shard's fold) against the product
  of the JAX package's host bigints (hotstuff_tpu/offchain/bls12381.py
  fq12_mul), across the kernel's chunk of 15 inputs and on weak limbs;
* the kernel's own logic (csrc/fq12w.cuh product_tower, compiled as
  plain C++ by a host compiler) against the plain version;
* the sharded TC verdict, true and forged, on 2 and 4 CPU shards (six
  pairing rows: padded rows on the 4-shard mesh), against the host
  reference and the port's unsharded verify_aggregate_multi.

The JAX package's sharded Miller program is not compiled: it takes
minutes on this CPU.  Every comparison is exact.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hotstuff_tpu.offchain import bls12381 as ref
from hotstuff_tpu_torch.offchain import bls12381 as host
from hotstuff_tpu_torch.ops import bls381 as D
from hotstuff_tpu_torch.ops import field381 as F
from hotstuff_tpu_torch.ops.kern import fq12_tower as T
from hotstuff_tpu_torch.parallel.mesh import virtual_mesh
from hotstuff_tpu_torch.parallel.sharded_bls import \
    verify_aggregate_multi_sharded

Q = F.Q
CSRC = Path(T.__file__).resolve().parent / "csrc"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host_elems(rng, n):
    return [tuple(int.from_bytes(rng.bytes(48), "little") % Q
                  for _ in range(12)) for _ in range(n)]


def _mont(vals) -> torch.Tensor:
    return torch.from_numpy(np.stack([D.host_fq12_to_mont_limbs(v)
                                      for v in vals]))


def _value(x) -> tuple:
    """(12, 48) Montgomery limbs -> a host Fq12 tuple."""
    c = F.from_mont(torch.as_tensor(x)).numpy()
    return tuple(F.from_limbs(r) for r in c)


def _host_product(vals):
    acc = vals[0]
    for v in vals[1:]:
        acc = ref.fq12_mul(acc, v)
    return acc


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 31])
def test_fq12_product_plain_equals_the_host_product(n):
    vals = _host_elems(np.random.default_rng(80 + n), n)
    got = T.fq12_product_plain(_mont(vals))
    assert got.shape == (12, 48)
    assert int(got.max()) < 256                   # canonical limbs
    assert _value(got) == _host_product(vals)


def test_fq12_product_plain_on_weak_limbs():
    """All-511 limbs (the weak bound) as one input: the same residue."""
    vals = _host_elems(np.random.default_rng(79), 3)
    x = _mont(vals)
    weak = torch.full((1, 12, 48), 511, dtype=torch.int32)
    weak_val = tuple(F.from_limbs(r) % Q for r in F.from_mont(weak)[0].numpy())
    got = T.fq12_product_plain(torch.cat([x, weak]))
    assert _value(got) == ref.fq12_mul(_host_product(vals), weak_val)


def test_fq12_product_rejects_bad_shapes():
    with pytest.raises(ValueError):
        T.fq12_product(torch.zeros((0, 12, 48), dtype=torch.int32))
    with pytest.raises(ValueError):
        T.fq12_product(torch.zeros((2, 12, 47), dtype=torch.int32))
    with pytest.raises(TypeError):
        T.fq12_product(torch.zeros((2, 12, 48), dtype=torch.int64))


_HARNESS = r"""
#include "fq12w.cuh"
#include <vector>
static uint32_t words[tw::kScratchWords];
static uint64_t cols[12 * tw::kWords];
extern "C" void hh_product(const int* x, int n, const int* prog, int* out) {
  std::vector<uint32_t> f(tw::kFq12), table(tw::kProductChunk * tw::kFq12);
  const tw::Scratch s = tw::make_scratch(words, cols);
  tw::product_tower(prog, x, n, f.data(), table.data(), s);
  tw::tower_to_flat(f.data(), out);
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """fq12w.cuh's product_tower built with the host's C++ compiler into
    a ctypes library (the code the card runs, on one thread)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    work = tmp_path_factory.mktemp("product_harness")
    (work / "harness.cpp").write_text(_HARNESS)
    lib = work / "libharness.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", str(work / "harness.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("n", [1, 17])
def test_product_kernel_logic_on_the_host_equals_plain(harness, n):
    x = _mont(_host_elems(np.random.default_rng(90 + n), n))
    x[0] = 511                                    # weak limbs
    x = x.numpy().copy()
    prog = T.PROGRAM
    out = np.zeros((12, 48), np.int32)
    harness.hh_product(ctypes.c_void_p(x.ctypes.data), n,
                       ctypes.c_void_p(prog.ctypes.data),
                       ctypes.c_void_p(out.ctypes.data))
    assert np.array_equal(out, T.fq12_product_plain(torch.from_numpy(x))
                          .numpy())


@pytest.fixture(scope="module")
def tc():
    """A 5-vote TC over 5 digests (six pairing rows), its forged twin (one
    vote over another digest), and the host reference's verdicts."""
    keys = [ref.key_gen(bytes([81, i]) * 16) for i in range(5)]
    pks = [pk for _, pk in keys]
    msgs = [bytes([82, i]) * 16 for i in range(5)]
    sigs = [ref.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    good = ref.aggregate(sigs)
    forged = ref.aggregate(sigs[:4] + [ref.sign(keys[4][0], b"x" * 32)])
    want = [ref.verify_aggregate(pks, msgs, good),
            ref.verify_aggregate(pks, msgs, forged)]
    assert want == [True, False]
    # The port's own host types (byte-identical encodings).
    ppks = [host.g1_decode(ref.g1_encode(pk)) for pk in pks]
    aggs = [host.g2_decode(ref.g2_encode(a)) for a in (good, forged)]
    return ppks, msgs, aggs, want


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_tc_verdicts_equal_the_host_reference(tc, n_shards):
    pks, msgs, aggs, want = tc
    mesh = virtual_mesh(n_shards, "cpu")
    got = [verify_aggregate_multi_sharded(mesh, pks, msgs, a) for a in aggs]
    assert got == want


def test_unsharded_tc_verdicts_agree(tc):
    pks, msgs, aggs, want = tc
    assert [D.verify_aggregate_multi(pks, msgs, a, device="cpu")
            for a in aggs] == want


def test_sharded_tc_rejects_malformed_statements_without_device_work(tc):
    pks, msgs, aggs, _ = tc
    mesh = virtual_mesh(2, "cpu")
    assert not verify_aggregate_multi_sharded(mesh, pks, msgs[:4], aggs[0])
    assert not verify_aggregate_multi_sharded(mesh, [], [], aggs[0])
    assert not verify_aggregate_multi_sharded(mesh, pks, msgs, None)
