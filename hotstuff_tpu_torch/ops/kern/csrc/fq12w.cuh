// The Fq2 / Fq6 / Fq12 tower over the word field of fq381w.cuh, and the
// chains of the BLS12-381 check that run on it (fq12_tower.cu): the
// Miller accumulation, the product of Miller values and the tower
// inverse (the final exponentiation's hard part runs on the split step
// of fq12_lanes.cuh).
//
// Tower: Fq2 = Fq[u]/(u^2 + 1), Fq6 = Fq2[v]/(v^3 - (1 + u)), Fq12 =
// Fq6[w]/(w^2 - v).  An Fq12 element is 12 Fq values of 12 words, Fq
// value 6i + 2j + l the u^l part of the v^j coefficient of w^i.  The
// reference's flat basis (sum a_k w^k modulo w^12 - 2w^6 + 2, so u = w^6
// - 1 and v = w^2) maps by additions alone: the Fq2 coefficient of w^k,
// k < 6, is (a_k + a_{k+6}) + a_{k+6} u, and it sits at i = k mod 2, j =
// k / 2.
//
// Every product of the tower (Karatsuba product, complex squaring, the
// sparse product by a Miller line, the two Frobenius maps, the two
// steps of the Fq6 inverse, and the cyclotomic square) is bilinear:
// K Fq products of operands that are signed sums of the inputs' Fq
// values, then 12 outputs that are signed sums of the products (and,
// for the cyclotomic square, of the input's values).
// fq12_tower.py derives the sums from the tower formulas (once, in
// Python) and hands them to the kernel as a table, the same sums its
// plain version applies; this file only evaluates them.  The table:
// [offset of each record, records]; record Op is K forms of LA terms
// over x, K of LB terms over y, 12 of LO terms over the products and 12
// of LI over x, with K, LA, LB, LO and LI those of Shape<Op> below.  A
// term is |coef| << 8 | index: index < 12 names an input value, 12 + i
// the value's negation q - v_i (over the products: 54 + k names q -
// P_k); a 0 term pads a form to its record's length and adds nothing.
//
// Layout: one block per row, 160 threads, five stages between barriers,
// every value in shared memory: (1) the inputs and their negations, 24
// tasks, for the records whose operands take negations (the square and
// the q-power Frobenius map); (2) the 2K operands, one per thread,
// summed in 64-bit word
// columns (an operand's |coefficients| add up to at most 8, so it stays
// below 8q < R and enters the product unreduced); (3) the K Montgomery
// products, one per thread, and q minus each; (4) the 144 (output,
// word) columns of the output sums, one per thread; (5) the 12 outputs'
// carries and one reduction each into [0, q).  Every thread of a warp
// walks the same number of terms, so the sums do not diverge.  (The
// cyclotomic record's input terms are read only by fq12_lanes.cuh's
// step.)
//
// tasks() runs one piece of work per index across the block and ends
// with a barrier; without __CUDACC__ it is a serial loop, so a host
// compiler runs the very same chains (the kernels' logic) one row at a
// time.
#pragma once

#include "fq381w.cuh"

#if defined(__CUDACC__)
#include <cuda_pipeline.h>
#endif

#if defined(__CUDACC__)
#define TW_FN __device__ __forceinline__
#define TW_OUTLINE __device__ __noinline__
#else
#define TW_FN inline
#define TW_OUTLINE inline
#endif

namespace tw {

using fqw::kWords;
constexpr int kFq12 = 12 * kWords;     // words of one tower element
constexpr int kMaxProducts = 54;
constexpr int kFlatInts = 12 * 48;     // ints of one flat element's limbs

// Table records, in fq12_tower.py's order (OPS).
enum Op {
  kMul = 0, kSqr = 1, kLine = 2, kFrob1 = 3, kFrob2 = 4, kInv6Abc = 5,
  kInv6Norm = 6, kCyc = 7
};
constexpr int kOps = 8;

#if defined(__CUDACC__)
template <class F>
__device__ __forceinline__ void tasks(int n, F&& task) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) task(t);
  __syncthreads();
}
__device__ __forceinline__ void barrier() { __syncthreads(); }
#else
template <class F>
inline void tasks(int n, F&& task) {
  for (int t = 0; t < n; ++t) task(t);
}
inline void barrier() {}
#endif

// Shared scratch of a block, kWords words per value.
struct Scratch {
  uint32_t* vx;     // 24 values: x, then q - x
  uint32_t* vy;     // 24 values: y, then q - y
  uint32_t* opnd;   // 2 kMaxProducts operands: the A's, then the B's
  uint32_t* prod;   // 2 kMaxProducts values: P_k, then q - P_k
  uint64_t* cols;   // 12 x kWords columns of the outputs' sums
};

constexpr int kScratchWords = (24 + 24 + 4 * kMaxProducts) * kWords;

// The Scratch over kScratchWords words and 12 x kWords columns.
TW_FN Scratch make_scratch(uint32_t* words, uint64_t* cols) {
  return Scratch{words, words + 24 * kWords, words + 48 * kWords,
                 words + (48 + 2 * kMaxProducts) * kWords, cols};
}

TW_FN const int* op_record(const int* prog, int op) {
  return prog + prog[op];
}

TW_FN void load12(const uint32_t* p, uint32_t (&r)[kWords]) {
#if defined(__CUDACC__)
  const uint4* q = reinterpret_cast<const uint4*>(p);   // 16-byte aligned
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint4 v = q[i];
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
#else
  for (int i = 0; i < kWords; ++i) r[i] = p[i];
#endif
}

// The records' shapes: K products, the lengths LA, LB, LO and LI of
// their forms, and whether an operand form takes a negation (then the
// inputs' negations are made first).  fq12_tower.py pads each record to
// these (RECORD_SHAPES, which its tests hold to these through
// record_shape() below); fixed lengths let every loop below unroll, so
// each thread issues all of its loads at once.
template <int Op> struct Shape;
template <> struct Shape<kMul> {
  static constexpr int k = 54, la = 8, lb = 8, lo = 36, li = 0;
  static constexpr bool neg = false;
};
template <> struct Shape<kSqr> {
  static constexpr int k = 36, la = 8, lb = 8, lo = 23, li = 0;
  static constexpr bool neg = true;
};
template <> struct Shape<kLine> {
  static constexpr int k = 42, la = 8, lb = 4, lo = 21, li = 0;
  static constexpr bool neg = false;
};
template <> struct Shape<kFrob1> {
  static constexpr int k = 18, la = 2, lb = 2, lo = 3, li = 0;
  static constexpr bool neg = true;
};
template <> struct Shape<kFrob2> {
  static constexpr int k = 12, la = 1, lb = 1, lo = 1, li = 0;
  static constexpr bool neg = false;
};
template <> struct Shape<kInv6Abc> {
  static constexpr int k = 18, la = 2, lb = 2, lo = 6, li = 0;
  static constexpr bool neg = false;
};
template <> struct Shape<kInv6Norm> {
  static constexpr int k = 9, la = 2, lb = 2, lo = 7, li = 0;
  static constexpr bool neg = false;
};
// The cyclotomic square: each output also takes its own input value.
template <> struct Shape<kCyc> {
  static constexpr int k = 18, la = 4, lb = 4, lo = 6, li = 1;
  static constexpr bool neg = true;
};

template <int Op>
inline void shape_of(int* out) {
  using S = Shape<Op>;
  const int v[6] = {S::k, S::la, S::lb, S::lo, S::li, S::neg ? 1 : 0};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

// K, LA, LB, LO, LI and neg of record op, for the host's check of the
// table.
inline void record_shape(int op, int* out) {
  void (*const shapes[kOps])(int*) = {
      shape_of<kMul>, shape_of<kSqr>, shape_of<kLine>, shape_of<kFrob1>,
      shape_of<kFrob2>, shape_of<kInv6Abc>, shape_of<kInv6Norm>,
      shape_of<kCyc>};
  shapes[op](out);
}

// One operand: the sum of the form's Len terms over values v, as words
// below R (unreduced).
template <int Len>
TW_FN void operand(const int* form, const uint32_t* v, uint32_t* out) {
  int terms[Len];
#pragma unroll
  for (int t = 0; t < Len; ++t) terms[t] = form[t];
  fqw::Acc acc;
  fqw::acc_zero(acc);
#pragma unroll
  for (int t = 0; t < Len; ++t) {
    uint32_t x[kWords];
    load12(v + (terms[t] & 255) * kWords, x);
    fqw::acc_add(acc, x, static_cast<uint32_t>(terms[t] >> 8));
  }
  uint32_t w[kWords + 1];
  fqw::acc_words(acc, w);   // w[12] == 0: the sum is below 8q < R
#pragma unroll
  for (int i = 0; i < kWords; ++i) out[i] = w[i];
}

// out = the bilinear map of record Op at (x, y).  Every thread of the
// block calls it; out may alias x or y (they are read in the first
// stage, out written in the last).
template <int Op>
TW_OUTLINE void bilinear(const int* prog, const uint32_t* x, const uint32_t* y,
                         uint32_t* out, const Scratch& s) {
  using S = Shape<Op>;
  const int* fa = op_record(prog, Op);
  const int* fb = fa + S::k * S::la;
  const int* fo = fb + S::k * S::lb;
  const uint32_t* vx = x;
  const uint32_t* vy = y;
  if (S::neg) {
    tasks(24, [&](int t) {
      const int i = t % 12;
      const uint32_t* src = (t < 12 ? x : y) + i * kWords;
      uint32_t* dst = (t < 12 ? s.vx : s.vy) + i * kWords;
#pragma unroll
      for (int w = 0; w < kWords; ++w) dst[w] = src[w];
      fqw::q_minus(src, dst + 12 * kWords);
    });
    vx = s.vx;
    vy = s.vy;
  }
  tasks(2 * S::k, [&](int t) {
    if (t < S::k) {
      operand<S::la>(fa + t * S::la, vx, s.opnd + t * kWords);
    } else {
      const int k = t - S::k;
      operand<S::lb>(fb + k * S::lb, vy,
                     s.opnd + (kMaxProducts + k) * kWords);
    }
  });
  tasks(S::k, [&](int k) {
    uint32_t* p = s.prod + k * kWords;
    fqw::mont_mul(s.opnd + k * kWords, s.opnd + (kMaxProducts + k) * kWords,
                  p);
    fqw::q_minus(p, s.prod + (kMaxProducts + k) * kWords);
  });
  tasks(12 * kWords, [&](int t) {
    const int j = t / kWords, w = t - j * kWords;
    const int* form = fo + j * S::lo;
    int terms[S::lo];
#pragma unroll
    for (int u = 0; u < S::lo; ++u) terms[u] = form[u];
    uint64_t c = 0;
#pragma unroll
    for (int u = 0; u < S::lo; ++u) {
      c += static_cast<uint64_t>(static_cast<uint32_t>(terms[u] >> 8)) *
           s.prod[(terms[u] & 255) * kWords + w];
    }
    s.cols[t] = c;
  });
  tasks(12, [&](int j) {
    fqw::Acc acc;
#pragma unroll
    for (int w = 0; w < kWords; ++w) acc.c[w] = s.cols[j * kWords + w];
    uint32_t r[kWords];
    fqw::acc_reduce(acc, r);
#pragma unroll
    for (int i = 0; i < kWords; ++i) out[j * kWords + i] = r[i];
  });
}

TW_FN void copy(const uint32_t* x, uint32_t* out) {
  tasks(kFq12, [&](int i) { out[i] = x[i]; });
}

TW_FN void set_one(uint32_t* out) {
  tasks(kFq12, [&](int i) { out[i] = i < kWords ? fqw::kOne[i] : 0u; });
}

// Conjugation over Fq6, x^(q^6): negate c1.  In place is safe (each task
// reads and writes its own value).
TW_FN void conj(const uint32_t* x, uint32_t* out) {
  tasks(12, [&](int j) {
    const uint32_t* a = x + j * kWords;
    uint32_t r[kWords];
    if (j < 6 || fqw::is_zero(a)) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) r[i] = a[i];
    } else {
      fqw::q_minus(a, r);
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) out[j * kWords + i] = r[i];
  });
}

// n of the reference's flat (12, 48) elements (weak, nonnegative limbs)
// -> n tower elements: one task per Fq2 coefficient (6 n tasks), each
// reducing its two limb rows a_k, a_{k+6} to words.
TW_FN void flat_to_tower(const int* limbs, uint32_t* out, int n) {
  tasks(6 * n, [&](int t) {
    const int e = t / 6, k = t - 6 * e;
    const int* a = limbs + e * kFlatInts;
    uint32_t lo[kWords], hi[kWords];
    fqw::load_limbs(a + k * 48, lo);
    fqw::load_limbs(a + (k + 6) * 48, hi);
    uint32_t* o = out + e * kFq12 + (6 * (k & 1) + 2 * (k >> 1)) * kWords;
    fqw::add_mod(lo, hi, o);
#pragma unroll
    for (int i = 0; i < kWords; ++i) o[kWords + i] = hi[i];
  });
}

// Copy n ints (a multiple of 4, both ends 16-byte aligned) from device
// memory into shared memory without waiting: cp.async on the card, in
// 16-byte pieces; copy_wait() waits for every copy the block issued.
// On the host a plain copy.
TW_FN void copy_async(int* dst, const int* src, int n) {
#if defined(__CUDACC__)
  for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {
    __pipeline_memcpy_async(dst + 4 * c, src + 4 * c, 16);
  }
  __pipeline_commit();
#else
  for (int i = 0; i < n; ++i) dst[i] = src[i];
#endif
}

TW_FN void copy_wait() {
#if defined(__CUDACC__)
  __pipeline_wait_prior(0);
  __syncthreads();
#endif
}

// The tower -> canonical flat (12, 48) limbs: a_{k+6} = b1, a_k = b0 - b1.
TW_FN void tower_to_flat(const uint32_t* x, int* limbs) {
  tasks(6, [&](int k) {
    const int t = 6 * (k & 1) + 2 * (k >> 1);
    uint32_t lo[kWords];
    fqw::sub_mod(x + t * kWords, x + (t + 1) * kWords, lo);
    fqw::store_limbs(x + (t + 1) * kWords, limbs + (k + 6) * 48);
    fqw::store_limbs(lo, limbs + k * 48);
  });
}

TW_FN bool fq12_is_one(const uint32_t* x) {
  if (!fqw::is_one(x)) return false;
  for (int i = 1; i < 12; ++i) {
    if (!fqw::is_zero(x + i * kWords)) return false;
  }
  return true;
}

// A line's zero pattern: the Fq2 coefficients c0.1, c0.2 and c1.0 (Fq
// values 2..7) vanish, as they do on every line of host._twist's
// embedding, so the sparse record applies.
TW_FN bool is_line_sparse(const uint32_t* x) {
  for (int i = 2; i < 8; ++i) {
    if (!fqw::is_zero(x + i * kWords)) return false;
  }
  return true;
}

// The product of n flat elements (n >= 1) into the tower element f: they
// enter the tower up to kProductChunk at a time (into table, kProductChunk
// elements) and multiply into f by Karatsuba products, in input order.
constexpr int kProductChunk = 15;

TW_OUTLINE void product_tower(const int* prog, const int* in, int n,
                              uint32_t* f, uint32_t* table,
                              const Scratch& s) {
  for (int i = 0; i < n; i += kProductChunk) {
    const int m = n - i < kProductChunk ? n - i : kProductChunk;
    flat_to_tower(in + i * kFlatInts, table, m);
    int j = 0;
    if (i == 0) {
      copy(table, f);
      j = 1;
    }
    for (; j < m; ++j) bilinear<kMul>(prog, f, table + j * kFq12, f, s);
  }
}

// out = f^-1 (0 -> 0) for f = a + b w, given cf = conj(f) = a - b w, down
// the tower with one Fq inversion: N = f cf = a^2 - b^2 v in Fq6; for N
// = c0 + c1 v + c2 v^2, (A, B, C) = (c0^2 - xi c1 c2, xi c2^2 - c0 c1,
// c1^2 - c0 c2) and the Fq2 norm F = c0 A + xi (c2 B + c1 C), so N^-1 =
// (A, B, C) F^-1 and f^-1 = cf N^-1; F^-1 = conj(F) / (F0^2 + F1^2) on
// one thread (fqw::fq2_inv).  Elements of Fq6 and Fq2 sit in the first
// 6 and 2 values of a tower element, the rest zero, so the Karatsuba
// product multiplies them.  t, u: scratch elements.
TW_OUTLINE void tower_inv(const int* prog, const uint32_t* f,
                          const uint32_t* cf, uint32_t* out, uint32_t* t,
                          uint32_t* u, const Scratch& s) {
  bilinear<kMul>(prog, f, cf, t, s);              // N
  bilinear<kInv6Abc>(prog, t, t, u, s);           // (A, B, C)
  bilinear<kInv6Norm>(prog, t, u, out, s);        // F
  tasks(1, [&](int) { fqw::fq2_inv(out, out + kWords, out, out + kWords); });
  bilinear<kMul>(prog, u, out, t, s);             // N^-1
  bilinear<kMul>(prog, cf, t, out, s);            // f^-1
}

// The Miller accumulation f <- f^2 l0 l1 over steps (S, 2, 12, 48) flat
// lines from f = 1: a line equal to one is skipped, a sparse one takes
// the sparse record, any other the dense product.  f: kFq12 words; l:
// the step's two lines in the tower, 2 kFq12 words; stage: two buffers
// of one step's 2 x 12 x 48 ints.  Step s + 1's lines are copied into the
// other buffer while step s computes, so device memory's latency is
// hidden behind the step.
TW_OUTLINE void miller_row(const int* prog, const int* lines, int steps,
                           int* out, uint32_t* f, uint32_t* l, int* stage,
                           const Scratch& s) {
  constexpr int kStep = 2 * kFlatInts;
  set_one(f);
  if (steps > 0) copy_async(stage, lines, kStep);
  for (int step = 0; step < steps; ++step) {
    int* cur = stage + (step & 1) * kStep;
    copy_wait();
    if (step + 1 < steps) {
      copy_async(stage + ((step + 1) & 1) * kStep,
                 lines + (step + 1) * kStep, kStep);
    }
    flat_to_tower(cur, l, 2);
    bool one[2], sparse[2];
    for (int slot = 0; slot < 2; ++slot) {
      one[slot] = fq12_is_one(l + slot * kFq12);
      sparse[slot] = is_line_sparse(l + slot * kFq12);
    }
    bilinear<kSqr>(prog, f, f, f, s);
    for (int slot = 0; slot < 2; ++slot) {
      if (one[slot]) continue;
      if (sparse[slot]) {
        bilinear<kLine>(prog, f, l + slot * kFq12, f, s);
      } else {
        bilinear<kMul>(prog, f, l + slot * kFq12, f, s);
      }
    }
  }
  tower_to_flat(f, out);
}

}  // namespace tw
