"""The Fq12 tower of hotstuff_tpu_torch/ops/kern/fq12_tower.py on the CPU
(the plain versions of the fq12_hard_pow and miller_accumulate kernels),
numpy-seeded, one torch thread:

* the flat <-> tower maps, and each bilinear map (Karatsuba product,
  complex square, sparse line product, both Frobenius maps) and the
  conjugation, against the JAX package's host bigints
  (hotstuff_tpu/offchain/bls12381.py: fq12_mul, fq12_pow) on canonical
  values;
* the hard part's chain on easy-part outputs against that module's
  fq12_pow(f2, (q^4 - q^2 + 1)/r), and bls381.final_exponentiate against
  its final_exponentiate (the JAX package's host bigints, not its
  compiled programs: the 1,268-bit windowed power takes minutes to build
  on this CPU);
* miller_accumulate on real Miller lines with one dense line and one row
  of lines equal to one (all three branches taken, counted) against
  field381.canonical of the JAX package's miller_accumulate;
* field381.canonical on weak values up to ~2^388;
* the kernels' own logic (csrc/fq12_lanes.cuh, csrc/fq12w.cuh,
  csrc/fq381w.cuh compiled as plain C++ by a host compiler, one row at a
  time) against the plain versions -- the hard part, the Miller
  accumulation, the tower inverse and final_exp at P = 17 (two of its
  chunks of inputs) -- and the word field, with its inversion, against
  Python integers.

Every comparison is exact: residues in canonical limbs (tolerance 0).
The new outputs are canonical; the JAX package's weak limbs are
compared after field381.canonical.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotstuff_tpu.offchain import bls12381 as ref
from hotstuff_tpu.ops import bls381 as JD
from hotstuff_tpu_torch.offchain import bls12381 as host
from hotstuff_tpu_torch.ops import bls381 as D
from hotstuff_tpu_torch.ops import field381 as F
from hotstuff_tpu_torch.ops import kern
from hotstuff_tpu_torch.ops.kern import fq12_tower as T

Q = F.Q
CSRC = Path(T.__file__).resolve().parent / "csrc"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The plain chains are thousands of small operators; one thread each
    # keeps parallel test workers (pytest-xdist) from oversubscribing the
    # CPU.
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


def _values(x) -> list:
    """(n, 12, 48) Montgomery limbs -> host Fq12 tuples."""
    c = F.from_mont(torch.as_tensor(x)).numpy()
    return [tuple(F.from_limbs(r) for r in row) for row in c]


def _easy_part(f: torch.Tensor) -> torch.Tensor:
    f1 = D.fq12_mul(D.fq12_frobenius(f, 6), D.fq12_inv(f))
    return D.fq12_mul(D.fq12_frobenius(f1, 2), f1).contiguous()


@pytest.fixture(scope="module")
def elems():
    rng = np.random.default_rng(51)
    a, b = _host_elems(rng, 3), _host_elems(rng, 3)
    return a, b, _mont(a), _mont(b)


def test_flat_tower_round_trip_on_weak_inputs(elems):
    _, _, x, _ = elems
    weak = torch.cat([x, torch.full((1, 12, 48), 511, dtype=torch.int32)])
    t = T.flat_to_tower_plain(weak)
    assert int(t.max()) < 256
    assert torch.equal(T.tower_to_flat_plain(t), F.canonical(weak))
    # The tower's u^0 part of w^k's coefficient is a_k + a_{k+6}.
    assert _values(T.tower_to_flat_plain(t[:3])) == _values(x)


@pytest.mark.parametrize("name", ["mul", "sqr", "line", "frob1", "frob2",
                                  "conj"])
def test_tower_maps_equal_the_host(elems, name):
    a, b, x, y = elems
    tx = T.flat_to_tower_plain(x)
    c1, c2 = T._frob_consts("cpu")
    if name == "line":
        # Real lines: a doubling line and an addition line of one pairing.
        sk, pk = ref.key_gen(b"\x06" * 32)
        qt = ref._twist(ref.hash_to_g2(b"\x34" * 32))
        pf = ref._cast_g1_fq12(pk)
        ls = [ref._linefunc(qt, qt, pf),
              ref._linefunc(ref._add(qt, qt, ref._fq12), qt, pf),
              ref._linefunc(qt, qt, pf)]
        ty = T.flat_to_tower_plain(_mont(ls))
        assert T.line_branches(ty)[1].all()
        got = T.bilinear_plain("line", tx, ty)
        want = [ref.fq12_mul(p, q) for p, q in zip(a, ls)]
    elif name == "conj":
        got = T.conj_plain(tx)
        want = [ref.fq12_pow(p, Q ** 6) for p in a]
    else:
        y_arg = {"mul": T.flat_to_tower_plain(y), "sqr": tx, "frob1": c1,
                 "frob2": c2}[name]
        got = T.bilinear_plain(name, tx, y_arg)
        want = {"mul": [ref.fq12_mul(p, q) for p, q in zip(a, b)],
                "sqr": [ref.fq12_mul(p, p) for p in a],
                "frob1": [ref.fq12_pow(p, Q) for p in a],
                "frob2": [ref.fq12_pow(p, Q * Q) for p in a]}[name]
    assert int(got.max()) < 256
    assert _values(T.tower_to_flat_plain(got)) == want


def test_chain_constants():
    assert T.HARD_EXP == D._HARD_EXP == JD._HARD_EXP
    assert T.E1.bit_length() == 126 and len(T.E1_DIGITS) == 32
    assert sum(T.X_DIGITS) == 6 and len(T.X_DIGITS) == 64
    prog = T.PROGRAM
    # [offset of each of the 8 records, records]: record i is K forms of
    # LA terms, K of LB, 12 of LO and 12 of LI, as RECORD_SHAPES gives
    # them (LI is 0 but for the cyclotomic square).
    sizes = [k * (la + lb) + 12 * (lo + li)
             for k, la, lb, lo, li in (T.RECORD_SHAPES[n] for n in T.OPS)]
    assert list(T.OPS) == ["mul", "sqr", "line", "frob1", "frob2",
                           "inv6_abc", "inv6_norm", "cyc"]
    assert [T.RECORD_SHAPES[n][0] for n in T.OPS] == [54, 36, 42, 18, 12,
                                                      18, 9, 18]
    assert prog[:8].tolist() == np.cumsum([8] + sizes[:-1]).tolist()
    assert len(prog) == 8 + sum(sizes)


@pytest.fixture(scope="module")
def easy():
    rng = np.random.default_rng(52)
    return _easy_part(_mont(_host_elems(rng, 2)))


def test_fq12_hard_pow_plain_equals_the_host_power(easy):
    before = dict(kern.LAUNCHES)
    got = T.fq12_hard_pow(easy)
    assert kern.LAUNCHES == before          # the plain route counts nothing
    assert int(got.max()) < 256
    assert _values(got) == [ref.fq12_pow(f, JD._HARD_EXP)
                            for f in _values(easy)]


def test_final_exponentiate_equals_the_host():
    f = _mont(_host_elems(np.random.default_rng(53), 1))
    got = D.final_exponentiate(f)
    assert _values(got) == [ref.final_exponentiate(_values(f)[0])]


@pytest.fixture(scope="module")
def branch_lines():
    """Real lines of two pairings, with one dense random line (step 9,
    slot 1 of row 0) and a third row of lines all equal to one."""
    sk, pk = host.key_gen(b"\x05" * 32)
    msg = b"\x33" * 32
    lines = np.stack([D.miller_lines(pk, host.hash_to_g2(msg)),
                      D.miller_lines(host.g1_neg(host.g1_generator()),
                                     host.sign(sk, msg)),
                      D.miller_lines(pk, host.hash_to_g2(msg))])
    lines[0, 9, 1] = D.host_fq12_to_mont_limbs(
        _host_elems(np.random.default_rng(54), 1)[0])
    lines[2] = np.asarray(D.fq12_one((D.N_STEPS, 2)))
    return lines


def test_miller_accumulate_takes_every_branch_and_equals_reference(
        branch_lines):
    """canonical(JAX miller_accumulate) == the port's, limb for limb."""
    before = dict(T.BRANCHES)
    got = D.miller_accumulate(torch.from_numpy(branch_lines))
    counts = {k: T.BRANCHES[k] - before[k] for k in before}
    # Rows 0 and 1: 63 doubling and 5 addition lines each are real
    # (sparse), the other 58 slots one; row 0's dense line took one of
    # those slots (BLS_X's bit 9 after the leading one is clear).  Row 2:
    # 126 lines equal to one.
    assert counts == {"sparse": 2 * 68, "dense": 1, "skip": 57 + 58 + 126}
    want = jax.jit(JD.miller_accumulate)(jnp.asarray(branch_lines))
    assert torch.equal(got, F.canonical(torch.from_numpy(np.array(want))))
    assert int(got.max()) < 256


def test_canonical_on_weak_values_near_2_386():
    rng = np.random.default_rng(55)
    x = rng.integers(0, 512, (6, 48)).astype(np.int32)
    x[0] = 511
    x[1, -1] = 323                   # the by_norm seed's top limbs
    x[2, -1] = 290
    x[3] = 2047
    x[4] = F.to_limbs(Q)             # q itself -> 0
    x[5] = F.to_limbs(Q - 1)
    got = F.canonical(torch.from_numpy(x)).numpy()
    assert (got >= 0).all() and (got < 256).all()
    assert [F.from_limbs(r) for r in got] == [F.from_limbs(r) % Q for r in x]
    assert max(F.from_limbs(r) for r in x).bit_length() == 388
    # reduce_sum outputs of an Fq12 product (values up to ~2R).
    y = D.fq12_mul(_mont(_host_elems(rng, 2)), _mont(_host_elems(rng, 2)))
    flat = y.reshape(-1, 48)
    assert [F.from_limbs(r) for r in F.canonical(flat).numpy()] == \
        [F.from_limbs(r) % Q for r in flat.numpy()]


# ---------------------------------------------------------------------------
# The kernels' logic, compiled for the host
# ---------------------------------------------------------------------------

_HARNESS = r"""
#include "fq12_lanes.cuh"
#include <vector>
static uint32_t words[tw::kScratchWords];
static uint64_t cols[12 * tw::kWords];
static tw::Scratch scratch() { return tw::make_scratch(words, cols); }
// a b R^-1 mod q by fq12_lanes.cuh's split product: the values as the
// digits of a group's lanes (lane l words W l ..), the group run at once.
template <int W>
static void split_mul(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  constexpr int G = tl::Split<W>::kGroup, L = tl::Split<W>::kLanes;
  uint32_t x[G][W] = {}, y[G][W] = {}, z[G][W];
  for (int l = 0; l < L; ++l) {
    for (int k = 0; k < W; ++k) {
      x[l][k] = a[W * l + k];
      y[l][k] = b[W * l + k];
    }
  }
  tl::mont_split<W>(tl::Group<G>{}, x, y, z);
  for (int l = 0; l < L; ++l) {
    for (int k = 0; k < W; ++k) r[W * l + k] = z[l][k];
  }
}
extern "C" {
void hh_record_shape(int op, int* out) { tw::record_shape(op, out); }
void hh_hard_pow(const int* x, const int* prog, const int* consts,
                 const int* d1, int n1, const int* dx, int nx, int* out,
                 long long rows) {
  std::vector<uint32_t> buf(20 * tw::kFq12);
  uint32_t* b = buf.data();
  tl::HardBuffers h{b, b + tw::kFq12, b + 2 * tw::kFq12, b + 3 * tw::kFq12,
                    b + 4 * tw::kFq12, b + 5 * tw::kFq12};
  for (long long r = 0; r < rows; ++r)
    tl::hard_pow_row(prog, reinterpret_cast<const uint32_t*>(consts), d1, n1,
                     dx, nx, x + r * tw::kFlatInts, out + r * tw::kFlatInts,
                     h, scratch());
}
void hh_miller(const int* lines, const int* prog, int* out, long long rows,
               int steps) {
  std::vector<uint32_t> f(tw::kFq12), l(2 * tw::kFq12);
  std::vector<int> stage(4 * tw::kFlatInts);
  for (long long r = 0; r < rows; ++r)
    tw::miller_row(prog, lines + r * steps * 2 * tw::kFlatInts, steps,
                   out + r * tw::kFlatInts, f.data(), l.data(), stage.data(),
                   scratch());
}
void hh_split_mul(int w, const uint32_t* a, const uint32_t* b,
                  uint32_t* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    const long long o = 12 * i;
    if (w == 2) split_mul<2>(a + o, b + o, out + o);
    else if (w == 3) split_mul<3>(a + o, b + o, out + o);
    else split_mul<4>(a + o, b + o, out + o);
  }
}
// The kernels' split step in place, as the hard part calls it: out holds
// x on entry; the square's y is out itself.
void hh_step(int op, const uint32_t* y, const int* prog, uint32_t* out) {
  if (op == tw::kCyc) tl::step<tw::kCyc, tl::kW, tl::kWO>(prog, out, out, out, words);
  else tl::step<tw::kMul, tl::kW, tl::kWO>(prog, out, y, out, words);
}
void hh_mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                 long long n) {
  for (long long i = 0; i < n; ++i)
    fqw::mont_mul(a + 12 * i, b + 12 * i, out + 12 * i);
}
void hh_load_limbs(const int* limbs, uint32_t* out, long long n) {
  for (long long i = 0; i < n; ++i) fqw::load_limbs(limbs + 48 * i, out + 12 * i);
}
void hh_inv_mont(const uint32_t* a, uint32_t* out, long long n) {
  for (long long i = 0; i < n; ++i) fqw::inv_mont(a + 12 * i, out + 12 * i);
}
void hh_tower_inv(const uint32_t* x, const int* prog, uint32_t* out,
                  long long rows) {
  std::vector<uint32_t> cf(tw::kFq12), t(tw::kFq12), u(tw::kFq12);
  for (long long r = 0; r < rows; ++r) {
    tw::conj(x + r * tw::kFq12, cf.data());
    tw::tower_inv(prog, x + r * tw::kFq12, cf.data(), out + r * tw::kFq12,
                  t.data(), u.data(), scratch());
  }
}
void hh_final_exp(const int* x, int n, const int* prog, const int* consts,
                  const int* d1, int n1, const int* dx, int nx, int* out,
                  int* ok, long long rows) {
  std::vector<uint32_t> buf(20 * tw::kFq12);
  uint32_t* b = buf.data();
  tl::HardBuffers h{b, b + tw::kFq12, b + 2 * tw::kFq12, b + 3 * tw::kFq12,
                    b + 4 * tw::kFq12, b + 5 * tw::kFq12};
  for (long long r = 0; r < rows; ++r)
    tl::final_exp_row(prog, reinterpret_cast<const uint32_t*>(consts), d1, n1,
                      dx, nx, x + r * n * tw::kFlatInts, n,
                      out + r * tw::kFlatInts, ok + r, h, scratch());
}
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The kernel headers built with the host's C++ compiler into a
    ctypes library (the same code the card runs, one row at a time)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    work = tmp_path_factory.mktemp("tower_harness")
    (work / "harness.cpp").write_text(_HARNESS)
    lib = work / "libharness.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", str(work / "harness.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _words(vals) -> np.ndarray:
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]
                     for v in vals], np.uint32)


def _unwords(w) -> list:
    return [sum(int(x) << (32 * i) for i, x in enumerate(r)) for r in w]


def test_kernel_record_shapes_equal_the_table(harness):
    """fq12w.cuh's Shape<Op> (compile-time K, LA, LB, LO, LI) against
    RECORD_SHAPES, to which fq12_tower.py pads the table's records, and
    its neg flag against whether the record's operands take a negation
    (fq12_lanes.cuh's step skips the negation work where they take
    none)."""
    for op, name in enumerate(T.OPS):
        out = np.zeros(6, np.int32)
        harness.hh_record_shape(op, _ptr(out))
        assert tuple(out[:5].tolist()) == T.RECORD_SHAPES[name], name
        m = T.OPS[name]
        assert out[5] == int((m.ma < 0).any() or (m.mb < 0).any()), name


def test_word_field_on_the_host_equals_python_integers(harness):
    """mont_mul at its extremes (inputs up to R - 1, the 8q operand
    bound) and load_limbs on weak limbs up to ~2^388."""
    rng = np.random.default_rng(56)
    r = F.R
    a = [r - 1, 8 * Q - 1, Q - 1, 0, 2 * Q + 5] + \
        [int.from_bytes(rng.bytes(48), "little") for _ in range(60)]
    b = [r - 1, 8 * Q - 1, 1, r - 1, 4 * Q - 1] + \
        [int.from_bytes(rng.bytes(48), "little") for _ in range(60)]
    wa, wb = _words(a), _words(b)
    out = np.zeros_like(wa)
    harness.hh_mont_mul(_ptr(wa), _ptr(wb), _ptr(out),
                        ctypes.c_longlong(len(a)))
    rinv = pow(r, -1, Q)
    assert _unwords(out) == [x * y * rinv % Q for x, y in zip(a, b)]
    limbs = rng.integers(0, 512, (40, 48)).astype(np.int32)
    limbs[0] = 511
    limbs[1] = 2047
    limbs[2, -1] = 323
    out = np.zeros((40, 12), np.uint32)
    harness.hh_load_limbs(_ptr(limbs), _ptr(out), ctypes.c_longlong(40))
    assert _unwords(out) == [F.from_limbs(v) % Q for v in limbs]


def test_kernel_logic_on_the_host_equals_plain(harness, easy, branch_lines):
    prog = T.PROGRAM
    consts = T._mont_words(T.FROB_CONSTS)
    d1 = np.asarray(T.E1_DIGITS, np.int32)
    dx = np.asarray(T.X_DIGITS, np.int32)
    x = easy.numpy().copy()
    out = np.zeros_like(x)
    harness.hh_hard_pow(_ptr(x), _ptr(prog), _ptr(consts), _ptr(d1),
                        len(d1), _ptr(dx), len(dx), _ptr(out),
                        ctypes.c_longlong(len(x)))
    assert np.array_equal(out, T.fq12_hard_pow_plain(easy).numpy())
    lines = np.ascontiguousarray(branch_lines)
    out = np.zeros((len(lines), 12, 48), np.int32)
    harness.hh_miller(_ptr(lines), _ptr(prog), _ptr(out),
                      ctypes.c_longlong(len(lines)), lines.shape[1])
    assert np.array_equal(
        out, T.miller_accumulate_plain(torch.from_numpy(lines)).numpy())


def _limb_words(x: torch.Tensor) -> np.ndarray:
    """Canonical limbs (..., 48) -> the same values as (..., 12) words."""
    return np.ascontiguousarray(x.numpy().astype(np.uint8)).view(np.uint32)


def test_word_inverse_on_the_host_equals_python_integers(harness):
    """fqw::inv_mont (the binary extended Euclid, then a product by R^3)
    maps a R to a^-1 R: for a word value x, x^-1 R^2 mod q; 0 -> 0."""
    rng = np.random.default_rng(57)
    a = [0, 1, 2, Q - 1, F.R % Q, Q - 2] + \
        [int.from_bytes(rng.bytes(48), "little") % Q for _ in range(40)]
    wa = _words(a)
    out = np.zeros_like(wa)
    harness.hh_inv_mont(_ptr(wa), _ptr(out), ctypes.c_longlong(len(a)))
    r2 = F.R * F.R % Q
    assert _unwords(out) == [pow(x, -1, Q) * r2 % Q if x else 0 for x in a]


def test_tower_inverse_on_the_host_equals_plain(harness):
    """fq12w.cuh tower_inv on an Fq12, an Fq6, an Fq2 and an Fq element
    and on zero, against the plain version."""
    rng = np.random.default_rng(58)
    vals = [[int.from_bytes(rng.bytes(48), "little") % Q if i < w else 0
             for i in range(12)] for w in (12, 6, 2, 1, 0)]
    x = torch.from_numpy(np.stack([np.stack([F.to_limbs(v) for v in row])
                                   for row in vals]))
    wx = _limb_words(x)
    out = np.zeros_like(wx)
    harness.hh_tower_inv(_ptr(wx), _ptr(T.PROGRAM), _ptr(out),
                         ctypes.c_longlong(len(wx)))
    assert np.array_equal(out, _limb_words(T.tower_inv_plain(x)))


def test_final_exp_on_the_host_equals_plain(harness):
    """fq12_lanes.cuh final_exp_row at P = 17 (two of the kernel's chunks of
    15 inputs) on a QC's two real Miller values followed by ones (verdict
    true), on random values (false) and on a row with a zero value."""
    sk, pk = ref.key_gen(b"\x07" * 32)
    msg = b"\x35" * 32
    neg_g1 = ref.g1_neg(ref.g1_generator())
    qc = [ref.miller_loop(ref._twist(ref.hash_to_g2(msg)),
                          ref._cast_g1_fq12(pk)),
          ref.miller_loop(ref._twist(ref.sign(sk, msg)),
                          ref._cast_g1_fq12(neg_g1))] + [ref.FQ12_ONE] * 15
    rnd = _host_elems(np.random.default_rng(59), 17)
    fs = torch.stack([_mont(qc), _mont(rnd), _mont([(0,) * 12] + rnd[1:])])
    want_ok, want = T.final_exp_plain(fs)
    assert want_ok.tolist() == [True, False, False]
    x = fs.numpy().copy()
    out = np.zeros((len(x), 12, 48), np.int32)
    ok = np.zeros(len(x), np.int32)
    consts = T._mont_words(T.FROB_CONSTS)
    d1 = np.asarray(T.E1_DIGITS, np.int32)
    dx = np.asarray(T.X_DIGITS, np.int32)
    harness.hh_final_exp(_ptr(x), x.shape[1], _ptr(T.PROGRAM), _ptr(consts),
                         _ptr(d1),
                         len(d1), _ptr(dx), len(dx), _ptr(out), _ptr(ok),
                         ctypes.c_longlong(len(x)))
    assert np.array_equal(out, want.numpy())
    assert ok.tolist() == [1, 0, 0]


@pytest.mark.parametrize("w", [2, 3, 4])
def test_split_product_on_the_host_equals_python_integers(harness, w):
    """fq12_lanes.cuh mont_split (a group's lanes run one after another,
    a shuffle an array read) at W words a lane, on the operand bounds
    (R - 1, 8q - 1) and seeded values: a b R^-1 mod q, the words of
    fqw::mont_mul."""
    rng = np.random.default_rng(80 + w)
    r = F.R
    a = [r - 1, 8 * Q - 1, Q - 1, 0, 1] + \
        [int.from_bytes(rng.bytes(48), "little") for _ in range(40)]
    b = [r - 1, 8 * Q - 1, 1, r - 1, 8 * Q - 1] + \
        [int.from_bytes(rng.bytes(48), "little") for _ in range(40)]
    wa, wb = _words(a), _words(b)
    out, ref_out = np.zeros_like(wa), np.zeros_like(wa)
    harness.hh_split_mul(w, _ptr(wa), _ptr(wb), _ptr(out),
                         ctypes.c_longlong(len(a)))
    harness.hh_mont_mul(_ptr(wa), _ptr(wb), _ptr(ref_out),
                        ctypes.c_longlong(len(a)))
    rinv = pow(r, -1, Q)
    assert _unwords(out) == [x * y * rinv % Q for x, y in zip(a, b)]
    assert np.array_equal(out, ref_out)


@pytest.mark.parametrize("name", ["cyc", "mul"])
def test_split_step_on_the_host_equals_plain(harness, name):
    """fq12_lanes.cuh step<kCyc> and step<kMul> (each product on a group
    of 4 lanes), in place, against bilinear_plain on seeded canonical
    tower elements."""
    rng = np.random.default_rng(85)
    vals = [[int.from_bytes(rng.bytes(48), "little") % Q for _ in range(12)]
            for _ in range(2)]
    x = torch.from_numpy(np.stack([np.stack([F.to_limbs(v) for v in row])
                                   for row in vals]))
    out, y = _limb_words(x[0]).copy(), _limb_words(x[1]).copy()
    op = list(T.OPS).index(name)
    harness.hh_step(op, _ptr(y), _ptr(T.PROGRAM), _ptr(out))
    want = T.bilinear_plain(name, x[0], x[0] if name == "cyc" else x[1])
    assert np.array_equal(out, _limb_words(want))


def test_final_exp_at_two_on_the_host_equals_plain(harness):
    """fq12_lanes.cuh final_exp_row at P = 2 (a QC's shape) on a QC's two
    real Miller values (verdict true) and on a row with a zero value."""
    sk, pk = ref.key_gen(b"\x08" * 32)
    msg = b"\x36" * 32
    neg_g1 = ref.g1_neg(ref.g1_generator())
    qc = [ref.miller_loop(ref._twist(ref.hash_to_g2(msg)),
                          ref._cast_g1_fq12(pk)),
          ref.miller_loop(ref._twist(ref.sign(sk, msg)),
                          ref._cast_g1_fq12(neg_g1))]
    rnd = _host_elems(np.random.default_rng(86), 1)
    fs = torch.stack([_mont(qc), _mont([(0,) * 12] + rnd)])
    want_ok, want = T.final_exp_plain(fs)
    assert want_ok.tolist() == [True, False]
    x = fs.numpy().copy()
    out = np.zeros((len(x), 12, 48), np.int32)
    ok = np.zeros(len(x), np.int32)
    consts = T._mont_words(T.FROB_CONSTS)
    d1 = np.asarray(T.E1_DIGITS, np.int32)
    dx = np.asarray(T.X_DIGITS, np.int32)
    harness.hh_final_exp(_ptr(x), x.shape[1], _ptr(T.PROGRAM), _ptr(consts),
                         _ptr(d1), len(d1), _ptr(dx), len(dx), _ptr(out),
                         _ptr(ok), ctypes.c_longlong(len(x)))
    assert np.array_equal(out, want.numpy())
    assert ok.tolist() == [1, 0]
    assert _values(out[1:]) == [tuple([0] * 12)]
