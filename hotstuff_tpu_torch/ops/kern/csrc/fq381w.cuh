// GF(q) Montgomery arithmetic for BLS12-381 in 32-bit words, the field of
// the tower kernels (fq12w.cuh, fq12_tower.cu).
//
// Representation: 12 x uint32_t words, little-endian, of a value in
// Montgomery form x R mod q with R = 2^384, the radix of field381.cuh and
// of ops/field381.py (48 x 8 = 12 x 32 bits).  A value therefore means the
// same thing here and in the 48-limb form; only the digits differ.  At
// the boundary of every function below a value is fully reduced, in
// [0, q): the representative is unique, so two results compare word for
// word (and, split into bytes, limb for limb with field381.canonical).
//
// Why words: the H100 multiplies 32 x 32 -> 64 bits in one IMAD.WIDE,
// so a Montgomery product (CIOS, Koc et al. 1996) is 2 x 144 wide
// multiply-adds and their carries, where the 48-limb radix of the TPU
// reference needs ~5,800 int32 multiply-adds and ~2,300 carry operations.
// (Separated operand scanning in 64-bit columns, whose products do not
// wait on a carry chain, measured 2.3x slower than CIOS on the H100.)
//
// Bounds the functions rely on (q < 2^381, so 8q < 2^384 = R):
// * mont_mul takes any a, b < R (so sums of up to 8 reduced values, the
//   tower's Karatsuba operands, need no reduction first): CIOS keeps its
//   running value t < b + q < 2R, so 13 words hold it, and ends with
//   t < ab/R + q < R + q.  reduce13 then brings t into [0, q).
// * Acc sums words in 64-bit columns, each column an independent add
//   (no carry chain per term); a sum of at most 2^20 terms of 32-bit
//   words cannot overflow a column.  reduce13 takes the carried sum.
// * reduce13 takes a 13-word V < 2^400: qhat = floor(V_hi floor(2^64 /
//   (q_top + 1)) / 2^64), with V_hi = V >> 352 and q_top = q >> 352, is at
//   most floor(V / q) and at least floor(V / q) - 1 (the error terms
//   are V_hi / q_top^2 + 1 / q_top + V_hi / 2^64 < 0.01 plus one from the
//   truncated reciprocal), so V - qhat q lies in [0, 2q) and one
//   conditional subtraction ends in [0, q).
// * load_limbs takes 48 nonnegative int32 limbs (any weak form of the
//   48-limb field: limbs up to ~2^11 and values up to ~2^387 after
//   reduce_sum or an Fq12 product; the bound is the 2^400 of reduce13).
//
// Without __CUDACC__ the functions are plain C++ (the portable 64-bit
// form, the same code the card runs), so a host compiler can hold them to
// the plain PyTorch versions before a card run.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define FQW_FN __device__ __forceinline__
#define FQW_CONST static __constant__
#else
#define FQW_FN inline
#define FQW_CONST static const
#endif

namespace fqw {

constexpr int kWords = 12;

// q, R mod q (the Montgomery one), -q^-1 mod 2^32, q's top word and
// floor(2^64 / (q_top + 1)): fq12_tower.py derives and checks each.
FQW_CONST uint32_t kQ[kWords] = {
    0xffffaaab, 0xb9feffff, 0xb153ffff, 0x1eabfffe, 0xf6b0f624, 0x6730d2a0,
    0xf38512bf, 0x64774b84, 0x434bacd7, 0x4b1ba7b6, 0x397fe69a, 0x1a0111ea};
FQW_CONST uint32_t kOne[kWords] = {
    0x0002fffd, 0x76090000, 0xc40c0002, 0xebf4000b, 0x53c758ba, 0x5f489857,
    0x70525745, 0x77ce5853, 0xa256ec6d, 0x5c071a97, 0xfa80e493, 0x15f65ec3};
constexpr uint32_t kQInv = 0xfffcfffdu;
constexpr uint64_t kQTopRecip = 0x9d835d2a8ull;

// 12-word add and subtract chains.  On the card each is one PTX carry
// chain (add.cc / addc.cc, sub.cc / subc.cc: one instruction a word on
// the dependent path); the host's portable form gives the same words.
#if defined(__CUDA_ARCH__)
// d = a - b as one borrow chain; returns 0xffffffff on a borrow out, else 0.
__device__ __forceinline__ uint32_t sub12(const uint32_t (&a)[kWords],
                                        const uint32_t (&b)[kWords],
                                        uint32_t (&d)[kWords]) {
  uint32_t out;
  asm("sub.cc.u32 %0, %13, %25;\n\t"
      "subc.cc.u32 %1, %14, %26;\n\t"
      "subc.cc.u32 %2, %15, %27;\n\t"
      "subc.cc.u32 %3, %16, %28;\n\t"
      "subc.cc.u32 %4, %17, %29;\n\t"
      "subc.cc.u32 %5, %18, %30;\n\t"
      "subc.cc.u32 %6, %19, %31;\n\t"
      "subc.cc.u32 %7, %20, %32;\n\t"
      "subc.cc.u32 %8, %21, %33;\n\t"
      "subc.cc.u32 %9, %22, %34;\n\t"
      "subc.cc.u32 %10, %23, %35;\n\t"
      "subc.cc.u32 %11, %24, %36;\n\t"
      "subc.u32 %12, %37, %37;"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]),
        "=&r"(d[5]), "=&r"(d[6]), "=&r"(d[7]), "=&r"(d[8]), "=&r"(d[9]),
        "=&r"(d[10]), "=&r"(d[11]), "=&r"(out)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]),
        "r"(0u));
  return out;
}

// d = a + b as one carry chain; returns the carry out (0 or 1).
__device__ __forceinline__ uint32_t add12(const uint32_t (&a)[kWords],
                                        const uint32_t (&b)[kWords],
                                        uint32_t (&d)[kWords]) {
  uint32_t out;
  asm("add.cc.u32 %0, %13, %25;\n\t"
      "addc.cc.u32 %1, %14, %26;\n\t"
      "addc.cc.u32 %2, %15, %27;\n\t"
      "addc.cc.u32 %3, %16, %28;\n\t"
      "addc.cc.u32 %4, %17, %29;\n\t"
      "addc.cc.u32 %5, %18, %30;\n\t"
      "addc.cc.u32 %6, %19, %31;\n\t"
      "addc.cc.u32 %7, %20, %32;\n\t"
      "addc.cc.u32 %8, %21, %33;\n\t"
      "addc.cc.u32 %9, %22, %34;\n\t"
      "addc.cc.u32 %10, %23, %35;\n\t"
      "addc.cc.u32 %11, %24, %36;\n\t"
      "addc.u32 %12, %37, %37;"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]),
        "=&r"(d[5]), "=&r"(d[6]), "=&r"(d[7]), "=&r"(d[8]), "=&r"(d[9]),
        "=&r"(d[10]), "=&r"(d[11]), "=&r"(out)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]),
        "r"(0u));
  return out;
}
#else
inline uint32_t sub12(const uint32_t (&a)[kWords], const uint32_t (&b)[kWords],
                      uint32_t (&d)[kWords]) {
  int64_t borrow = 0;
  for (int i = 0; i < kWords; ++i) {
    const int64_t s = static_cast<int64_t>(a[i]) - b[i] - borrow;
    d[i] = static_cast<uint32_t>(s);
    borrow = s < 0;
  }
  return borrow ? 0xffffffffu : 0u;
}

inline uint32_t add12(const uint32_t (&a)[kWords], const uint32_t (&b)[kWords],
                      uint32_t (&d)[kWords]) {
  uint64_t carry = 0;
  for (int i = 0; i < kWords; ++i) {
    const uint64_t s = static_cast<uint64_t>(a[i]) + b[i] + carry;
    d[i] = static_cast<uint32_t>(s);
    carry = s >> 32;
  }
  return static_cast<uint32_t>(carry);
}
#endif

FQW_FN void load_q(uint32_t (&q)[kWords]) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) q[i] = kQ[i];
}

// v - q if v >= q, else v (v < 2q).
FQW_FN void cond_sub_q(uint32_t (&v)[kWords]) {
  uint32_t q[kWords], d[kWords];
  load_q(q);
  const uint32_t borrow = sub12(v, q, d);
#pragma unroll
  for (int i = 0; i < kWords; ++i) v[i] = borrow ? v[i] : d[i];
}

// A 13-word V < 2^400 -> V mod q in [0, q) (see the header's bound):
// V - qhat q, with qhat q's low and high word halves added as one chain,
// then one conditional subtraction.
FQW_FN void reduce13(const uint32_t (&v)[kWords + 1], uint32_t (&out)[kWords]) {
  const uint64_t hi = (static_cast<uint64_t>(v[kWords]) << 32) | v[kWords - 1];
#if defined(__CUDA_ARCH__)
  const uint32_t qhat = static_cast<uint32_t>(__umul64hi(hi, kQTopRecip));
#else
  const uint32_t qhat = static_cast<uint32_t>(
      (static_cast<unsigned __int128>(hi) * kQTopRecip) >> 64);
#endif
  uint32_t lo[kWords], up[kWords], p[kWords], low[kWords];
  up[0] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint64_t x = static_cast<uint64_t>(qhat) * kQ[i];
    lo[i] = static_cast<uint32_t>(x);
    if (i + 1 < kWords) up[i + 1] = static_cast<uint32_t>(x >> 32);
  }
  add12(lo, up, p);
#pragma unroll
  for (int i = 0; i < kWords; ++i) low[i] = v[i];
  // The top words cancel: V - qhat q is below 2q < 2^382.
  sub12(low, p, out);
  cond_sub_q(out);
}

// Column sums of words: c[i] accumulates word i of each term, times its
// coefficient, without carries between columns.
struct Acc {
  uint64_t c[kWords];
};

FQW_FN void acc_zero(Acc& a) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) a.c[i] = 0;
}

FQW_FN void acc_add(Acc& a, const uint32_t* v, uint32_t coef) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) a.c[i] += static_cast<uint64_t>(coef) * v[i];
}

// The sum's value, carried into 13 words.
FQW_FN void acc_words(const Acc& a, uint32_t (&v)[kWords + 1]) {
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint64_t s = a.c[i] + carry;   // c < 2^52, carry < 2^21
    v[i] = static_cast<uint32_t>(s);
    carry = s >> 32;
  }
  v[kWords] = static_cast<uint32_t>(carry);
}

// The sum mod q, in [0, q).
FQW_FN void acc_reduce(const Acc& a, uint32_t (&out)[kWords]) {
  uint32_t v[kWords + 1];
  acc_words(a, v);
  reduce13(v, out);
}

// REDC(a b) = a b R^-1 mod q in [0, q), for any a, b < R: CIOS over 12
// words with the running value in 13 words plus a carry word.
FQW_FN void mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  uint32_t aa[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) aa[j] = a[j];
  uint32_t t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint32_t bi = b[i];
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint64_t s = static_cast<uint64_t>(aa[j]) * bi + t[j] + carry;
      t[j] = static_cast<uint32_t>(s);
      carry = static_cast<uint32_t>(s >> 32);
    }
    uint64_t s = static_cast<uint64_t>(t[kWords]) + carry;
    t[kWords] = static_cast<uint32_t>(s);
    t[kWords + 1] = static_cast<uint32_t>(s >> 32);
    const uint32_t m = t[0] * kQInv;
    s = static_cast<uint64_t>(m) * kQ[0] + t[0];
    carry = static_cast<uint32_t>(s >> 32);
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      s = static_cast<uint64_t>(m) * kQ[j] + t[j] + carry;
      t[j - 1] = static_cast<uint32_t>(s);
      carry = static_cast<uint32_t>(s >> 32);
    }
    s = static_cast<uint64_t>(t[kWords]) + carry;
    t[kWords - 1] = static_cast<uint32_t>(s);
    t[kWords] = t[kWords + 1] + static_cast<uint32_t>(s >> 32);
  }
  uint32_t v[kWords + 1], r[kWords];
#pragma unroll
  for (int j = 0; j <= kWords; ++j) v[j] = t[j];
  reduce13(v, r);
#pragma unroll
  for (int j = 0; j < kWords; ++j) out[j] = r[j];
}

FQW_FN void load_words(const uint32_t* p, uint32_t (&r)[kWords]) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) r[i] = p[i];
}

// (a + b) mod q, a, b in [0, q).
FQW_FN void add_mod(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  uint32_t x[kWords], y[kWords], s[kWords];
  load_words(a, x);
  load_words(b, y);
  add12(x, y, s);   // a + b < 2q < 2^384: no carry out
  cond_sub_q(s);
#pragma unroll
  for (int i = 0; i < kWords; ++i) out[i] = s[i];
}

// (a - b) mod q, a, b in [0, q).
FQW_FN void sub_mod(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  uint32_t x[kWords], y[kWords], d[kWords], q[kWords], e[kWords];
  load_words(a, x);
  load_words(b, y);
  const uint32_t borrow = sub12(x, y, d);
  load_q(q);
  add12(d, q, e);
#pragma unroll
  for (int i = 0; i < kWords; ++i) out[i] = borrow ? e[i] : d[i];
}

// (q - a) as words, for a in [0, q): q - 0 = q stands for zero in sums.
FQW_FN void q_minus(const uint32_t* a, uint32_t* out) {
  uint32_t x[kWords], q[kWords], d[kWords];
  load_words(a, x);
  load_q(q);
  sub12(q, x, d);
#pragma unroll
  for (int i = 0; i < kWords; ++i) out[i] = d[i];
}

// 48 nonnegative int32 radix-2^8 limbs (a weak form) -> the value mod q.
FQW_FN void load_limbs(const int* limbs, uint32_t* out) {
  uint32_t v[kWords + 1];
  uint64_t carry = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint64_t s = carry;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      s += static_cast<uint64_t>(static_cast<uint32_t>(limbs[4 * w + b]))
           << (8 * b);
    }
    v[w] = static_cast<uint32_t>(s);
    carry = s >> 32;
  }
  v[kWords] = static_cast<uint32_t>(carry);
  uint32_t r[kWords];
  reduce13(v, r);
#pragma unroll
  for (int i = 0; i < kWords; ++i) out[i] = r[i];
}

// Words in [0, q) -> 48 limbs, each below 256: the canonical limbs.
FQW_FN void store_limbs(const uint32_t* v, int* limbs) {
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      limbs[4 * w + b] = static_cast<int>((v[w] >> (8 * b)) & 255u);
    }
  }
}

FQW_FN bool is_zero(const uint32_t* v) {
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) x |= v[i];
  return x == 0;
}

FQW_FN bool is_one(const uint32_t* v) {
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) x |= v[i] ^ kOne[i];
  return x == 0;
}

// ---------------------------------------------------------------------------
// Inversion: the one Fq inverse of the final exponentiation's easy part.
//
// A binary extended Euclid on the integers (Hankerson, Menezes and
// Vanstone, Guide to Elliptic Curve Cryptography, algorithm 2.22): u =
// a, v = q and x1 = 1, x2 = 0 keep x1 a = u and x2 a = v mod q; each
// round halves u and v while even (and their x, mod q) and subtracts the
// smaller from the larger, until one of them is 1.  That is about 760
// halvings and a few hundred subtractions of 12-word values, each a
// short carry chain, where a Fermat power a^(q - 2) is ~455 dependent
// Montgomery products (~0.7 ms at the tower's 1.6 us a product).  Its
// time depends on the value, which is public here (the check's inputs
// are public keys, digests and signatures).
// ---------------------------------------------------------------------------

// R^3 mod q: inv_mont's correction, a^-1 R^-1 -> a^-1 R.
FQW_CONST uint32_t kR3[kWords] = {
    0xd94ca1e0, 0xed48ac6b, 0x03a7adf8, 0x315f831e, 0x615e29dd, 0x9a53352a,
    0x921e1761, 0x34c04e5e, 0x65724728, 0x2512d435, 0x91755d4d, 0x0aa63460};

FQW_FN bool is_int_one(const uint32_t (&v)[kWords]) {
  uint32_t x = v[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < kWords; ++i) x |= v[i];
  return x == 0;
}

FQW_FN void shr1(uint32_t (&v)[kWords]) {
#pragma unroll
  for (int i = 0; i < kWords - 1; ++i) v[i] = (v[i] >> 1) | (v[i + 1] << 31);
  v[kWords - 1] >>= 1;
}

// x / 2 mod q for x in [0, q): x / 2, or (x + q) / 2 when x is odd
// (x + q < 2q < 2^382: no carry out).
FQW_FN void half_mod(uint32_t (&x)[kWords]) {
  uint32_t q[kWords], s[kWords];
  load_q(q);
  add12(x, q, s);
  const bool odd = x[0] & 1u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) x[i] = odd ? s[i] : x[i];
  shr1(x);
}

// a^-1 mod q of an integer a in [0, q), with 0 -> 0.
FQW_FN void inv_int(const uint32_t* a, uint32_t* out) {
  uint32_t u[kWords], v[kWords], x1[kWords], x2[kWords], d[kWords];
  load_words(a, u);
  if (is_zero(u)) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) out[i] = 0;
    return;
  }
  load_q(v);
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    x1[i] = i == 0;
    x2[i] = 0;
  }
  // gcd(u, v) = 1 throughout, so u = v only at u = v = 1, and neither
  // reaches 0.
  while (!is_int_one(u) && !is_int_one(v)) {
    while (!(u[0] & 1u)) {
      shr1(u);
      half_mod(x1);
    }
    while (!(v[0] & 1u)) {
      shr1(v);
      half_mod(x2);
    }
    if (!sub12(u, v, d)) {          // u >= v
#pragma unroll
      for (int i = 0; i < kWords; ++i) u[i] = d[i];
      sub_mod(x1, x2, x1);
    } else {
      sub12(v, u, d);
#pragma unroll
      for (int i = 0; i < kWords; ++i) v[i] = d[i];
      sub_mod(x2, x1, x2);
    }
  }
  const bool at_u = is_int_one(u);
#pragma unroll
  for (int i = 0; i < kWords; ++i) out[i] = at_u ? x1[i] : x2[i];
}

// The Montgomery inverse: a R mod q -> a^-1 R mod q (0 -> 0), as the
// integer inverse (a R)^-1 times R^3 in one Montgomery product.
FQW_FN void inv_mont(const uint32_t* a, uint32_t* out) {
  uint32_t y[kWords], r3[kWords];
  inv_int(a, y);
#pragma unroll
  for (int i = 0; i < kWords; ++i) r3[i] = kR3[i];
  mont_mul(y, r3, out);
}

// (-a) mod q for a in [0, q).
FQW_FN void neg_mod(const uint32_t* a, uint32_t* out) {
  uint32_t z[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) z[i] = 0;
  sub_mod(z, a, out);
}

// The Fq2 inverse (a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 + a1^2), Montgomery
// forms in [0, q); 0 -> 0.  Outputs may alias inputs.
FQW_FN void fq2_inv(const uint32_t* a0, const uint32_t* a1, uint32_t* b0,
                    uint32_t* b1) {
  uint32_t x0[kWords], x1[kWords], n[kWords], t[kWords];
  load_words(a0, x0);
  load_words(a1, x1);
  mont_mul(x0, x0, n);
  mont_mul(x1, x1, t);
  add_mod(n, t, n);
  inv_mont(n, n);
  mont_mul(x0, n, b0);
  mont_mul(x1, n, t);
  neg_mod(t, b1);
}

}  // namespace fqw
