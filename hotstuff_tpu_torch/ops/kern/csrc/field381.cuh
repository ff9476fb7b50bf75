// GF(q) Montgomery arithmetic for BLS12-381 (R = 2^384), the device side
// of hotstuff_tpu_torch/ops/field381.py, shared by the Fq12 chain kernels
// (fq12_chain.cu).
//
// Layout: one thread holds one whole field element, the 48 int32
// radix-2^8 limbs of the weak form (limbs < ~2^9, value < ~2^385) in
// registers: every loop below has a compile-time trip count and is
// unrolled, so every array index is a constant.  Each function repeats
// the reference's op boundaries and carry schedule exactly -- mont_mul's
// steps 3 / 3 / 3 / 1, reduce_sum's 3 / 2 / 1, the top limb's overflow
// kept in place by weak_carry and dropped by trunc_carry -- so the limbs
// equal hotstuff_tpu/ops/field381.py's limb for limb (the weak form of
// a residue is not unique, so nothing less would compare).
//
// Exactness: weak limbs are < 2^11, so a schoolbook coefficient (at most
// 48 products) is < 2^24 and every intermediate fits int32; the carry
// out of the low half in mont_mul is taken exactly in int64.
//
// Without __CUDACC__ the functions are plain inline C++, so a host
// compiler can check them against the plain PyTorch version.
#pragma once

#if defined(__CUDACC__)
#define FQ_FN __device__ __forceinline__
#define FQ_OUTLINE __device__ __noinline__
#define FQ_CONST static __constant__
#else
#define FQ_FN inline
#define FQ_OUTLINE inline
#define FQ_CONST static const
#endif

namespace fq {

constexpr int kLimbs = 48;

// q, q' = -q^-1 mod 2^384, the 64q subtraction bias spread so every limb
// is >= 511, 2^384 mod q (also the Montgomery one), 2^385 mod q: the
// reference's _Q_LIMBS, _QPRIME_LIMBS, _BIAS_ARR, _R_MOD_Q_LIMBS and
// _P385_LIMBS.
FQ_CONST int kQ[kLimbs] = {
    171, 170, 255, 255, 255, 255, 254, 185, 255, 255, 83,  177,
    254, 255, 171, 30,  36,  246, 176, 246, 160, 210, 48,  103,
    191, 18,  133, 243, 132, 75,  119, 100, 215, 172, 75,  67,
    182, 167, 27,  75,  154, 230, 127, 57,  234, 17,  1,   26};
FQ_CONST int kQPrime[kLimbs] = {
    253, 255, 252, 255, 252, 255, 243, 137, 232, 19,  209, 217,
    146, 219, 106, 40,  72,  11,  227, 200, 240, 46,  239, 22,
    76,  219, 178, 142, 14,  202, 236, 25,  88,  207, 104, 226,
    254, 22,  179, 104, 148, 252, 170, 254, 6,   97,  176, 206};
FQ_CONST int kBias[kLimbs] = {
    704, 680, 744, 765, 765, 765, 701, 637, 748, 765, 765, 594,
    682, 765, 765, 680, 517, 647, 571, 682, 571, 678, 562, 714,
    727, 685, 578, 735, 570, 735, 720, 539, 727, 563, 745, 720,
    654, 747, 743, 708, 656, 676, 759, 605, 652, 632, 578, 1662};
FQ_CONST int kRModQ[kLimbs] = {
    253, 255, 2,   0,   0,   0,   9,   118, 2,   0,   12,  196,
    11,  0,   244, 235, 186, 88,  199, 83,  87,  152, 72,  95,
    69,  87,  82,  112, 83,  88,  206, 119, 109, 236, 86,  162,
    151, 26,  7,   92,  147, 228, 128, 250, 195, 94,  246, 21};
FQ_CONST int kP385[kLimbs] = {
    79,  85,  6,   0,   0,   0,   19,  50,  5,   0,   196, 214,
    24,  0,   60,  185, 81,  187, 221, 176, 13,  94,  96,  87,
    203, 155, 31,  237, 33,  101, 37,  139, 3,   44,  98,  1,
    121, 141, 242, 108, 140, 226, 129, 187, 157, 171, 235, 17};

// STEPS parallel carry steps over N limbs: every limb keeps its low byte
// and takes the high bits of the limb below.  weak_carry keeps the top
// limb's overflow in place, trunc_carry drops it.  In place, top limb
// first, so each limb reads the old value below it.
template <int N, int STEPS>
FQ_FN void weak_carry(int (&x)[N]) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    x[N - 1] += x[N - 2] >> 8;
#pragma unroll
    for (int i = N - 2; i >= 1; --i) x[i] = (x[i] & 255) + (x[i - 1] >> 8);
    x[0] &= 255;
  }
}

template <int N, int STEPS>
FQ_FN void trunc_carry(int (&x)[N]) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
#pragma unroll
    for (int i = N - 1; i >= 1; --i) x[i] = (x[i] & 255) + (x[i - 1] >> 8);
    x[0] &= 255;
  }
}

FQ_FN void load(int (&x)[kLimbs], const int* p) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) x[i] = p[i];
}

FQ_FN void store(int* p, const int (&x)[kLimbs]) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) p[i] = x[i];
}

// REDC(a * b), field381.mont_mul: T = a b (95 coefficients, widened to
// 96 limbs, 3 steps), m = (T mod R) q' mod R (3 truncating steps),
// T + m q (3 steps), the exact carry c out of the low 48 limbs, then
// the high half with c added to its first limb (1 step).  out may alias
// a or b: both are read before out is written.
FQ_OUTLINE void mont_mul(const int* a, const int* b, int* out) {
  int t[2 * kLimbs];
  {
    int bb[kLimbs];
    load(bb, b);
#pragma unroll
    for (int k = 0; k < 2 * kLimbs; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) {
      const int ai = a[i];
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) t[i + j] += ai * bb[j];
    }
  }
  weak_carry<2 * kLimbs, 3>(t);
  {
    int m[kLimbs];
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) m[k] = 0;
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) {
#pragma unroll
      for (int j = 0; j < kLimbs - i; ++j) m[i + j] += t[i] * kQPrime[j];
    }
    trunc_carry<kLimbs, 3>(m);
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) {
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) t[i + j] += m[i] * kQ[j];
    }
  }
  weak_carry<2 * kLimbs, 3>(t);
  // T + m q = c 2^384 exactly; the limbs below 44 (nonnegative, < 2^32)
  // add less than 2^(352+32), so c is the ceiling of limbs 44..47 / 2^32.
  const long long h = static_cast<long long>(t[44]) +
                      (static_cast<long long>(t[45]) << 8) +
                      (static_cast<long long>(t[46]) << 16) +
                      (static_cast<long long>(t[47]) << 24);
  int hi[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) hi[i] = t[kLimbs + i];
  hi[0] += static_cast<int>((h + 0xFFFFFFFFLL) >> 32);
  weak_carry<kLimbs, 1>(hi);
  store(out, hi);
}

// field381.add: limb add and one carry step.
FQ_FN void add(int (&out)[kLimbs], const int (&a)[kLimbs],
               const int (&b)[kLimbs]) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) out[i] = a[i] + b[i];
  weak_carry<kLimbs, 1>(out);
}

// field381.sub: a + 64q - b and two carry steps.
FQ_FN void sub(int (&out)[kLimbs], const int (&a)[kLimbs],
               const int (&b)[kLimbs]) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) out[i] = a[i] + kBias[i] - b[i];
  weak_carry<kLimbs, 2>(out);
}

// field381.reduce_sum: widen to 49 limbs and carry (3 steps), fold limb
// 48 back by 2^384 mod q and carry (2 steps), fold limb 47's bits above
// 9 by 2^385 mod q and carry (1 step).  out may alias in.
FQ_OUTLINE void reduce_sum(const int* in, int* out) {
  int x[kLimbs + 1];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) x[i] = in[i];
  x[kLimbs] = 0;
  weak_carry<kLimbs + 1, 3>(x);
  const int spill = x[kLimbs];
  int y[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) y[i] = x[i] + spill * kRModQ[i];
  weak_carry<kLimbs, 2>(y);
  const int excess = y[kLimbs - 1] >> 9;
  y[kLimbs - 1] &= 511;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) y[i] += excess * kP385[i];
  weak_carry<kLimbs, 1>(y);
  store(out, y);
}

// ---------------------------------------------------------------------------
// The pieces of one Fq12 product (bls381.fq12_mul), each one thread's
// task; the kernel runs each piece over its tasks with a barrier between
// pieces.  Fq12 elements are 12 x 48 limbs, coefficient i at i * 48.
// ---------------------------------------------------------------------------

constexpr int kFq12 = 12 * kLimbs;
constexpr int kProducts = 144;        // coefficient pairs (i, j)
constexpr int kDiagonals = 23;        // degrees 0..22 before the fold

// Task p < 144: prod[p] = x_i * y_j with i = p / 12, j = p % 12.
FQ_FN void fq12_product(const int* x, const int* y, int* prod, int p) {
  mont_mul(x + (p / 12) * kLimbs, y + (p % 12) * kLimbs, prod + p * kLimbs);
}

// Task u < 23 * 48: limb u % 48 of the anti-diagonal sum of degree
// k = u / 48 (at most 12 weak terms: limbs < 2^13).
FQ_FN void fq12_diagonal(const int* prod, int* coef, int u) {
  const int k = u / kLimbs;
  const int limb = u - k * kLimbs;
  const int lo = k > 11 ? k - 11 : 0;
  const int hi = k < 11 ? k : 11;
  int s = 0;
  for (int i = lo; i <= hi; ++i) s += prod[(i * 12 + (k - i)) * kLimbs + limb];
  coef[u] = s;
}

// One step of the fold w^12 = 2w^6 - 2 at degree d: c2 = c_d + c_d,
// c_{d-6} += c2, c_{d-12} -= c2 (field381.add / sub).
FQ_FN void fold_step(int* coef, int d) {
  int c[kLimbs], c2[kLimbs], r[kLimbs];
  load(c, coef + d * kLimbs);
  add(c2, c, c);
  load(c, coef + (d - 6) * kLimbs);
  add(r, c, c2);
  store(coef + (d - 6) * kLimbs, r);
  load(c, coef + (d - 12) * kLimbs);
  sub(r, c, c2);
  store(coef + (d - 12) * kLimbs, r);
}

// Task t < 6: the fold's chain d = 17 + t, then d = 11 + t when that is
// still >= 12.  The reference folds d = 22 down to 12; step d reads c_d
// and writes c_{d-6} and c_{d-12}, all of one residue mod 6, so the six
// chains are independent and each keeps the reference's order.
FQ_FN void fq12_fold(int* coef, int t) {
  fold_step(coef, 17 + t);
  if (t >= 1) fold_step(coef, 11 + t);
}

}  // namespace fq
