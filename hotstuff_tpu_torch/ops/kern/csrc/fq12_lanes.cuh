// The final exponentiation's chains on lane groups: the tower step of
// fq12w.cuh with each Fq value and each Fq product split across the
// lanes of a group, and the hard part (and the whole final
// exponentiation) on it, its squarings the cyclotomic square of Granger
// and Scott (record kCyc, 18 Fq products where the complex square takes
// 36).  fq12_tower.cu's final_exp and fq12_hard_pow run these;
// miller_accumulate and fq12_product stay on fq12w.cuh's step.
//
// Why: on fq12w.cuh's step one thread runs a whole 12-word CIOS
// product, a dependent chain of ~1.6 us, and each operand and output
// sum is one thread's 12-word chain too.  Here a group of kLanes lanes
// holds an Fq value as digits of W words (W = 12 / kLanes), digit l in
// lane l, and every chain is W words long:
// * a sum of a record's terms: lane l adds the W word columns of its
//   digit, then the carries between digits are resolved at once
//   (resolve: each lane adds the carry of the lane below; a carry that
//   ripples on through digits of all ones goes by a lookahead on two
//   ballots);
// * a Montgomery product: CIOS in radix beta = 2^(32 W), kLanes rounds:
//   every lane adds a_l b_i (b_i shuffled from lane i) to its digit of
//   the running value t, lane 0's m = t_0 q' mod beta is broadcast, every
//   lane adds m q_l, and each lane's low digit moves one lane down while
//   its high part stays; products go into 64-bit columns, so no product
//   waits on another's carry.  The digits stay redundant (W words and an
//   excess word, t_l <= 3 beta - 2) until the end; then resolve, and
//   reduce: fqw::reduce13 across the group (the quotient estimate from
//   lane L - 1's top words, V - qhat q and one conditional subtraction,
//   each a borrow lookahead).  t is fqw::mont_mul's (a b + M q) / R (M =
//   -a b q^-1 mod R is unique), so the product equals mont_mul's word for
//   word.
//
// A step: (1) each of the record's K products in a group of its own,
// which forms its operands A_k and B_k and multiplies them; each lane
// stores its digit of P_k; a barrier; (2) each of the 12 outputs in a
// group of its own, which sums the output's terms (products, and for
// kCyc its own input value) and reduces; each lane stores its digit; a
// barrier.  A negated term enters as ~v + q + 1 - 2^384, so every
// column is an unsigned sum and the 2^384s come off the top: no negation
// stage, two barriers a step where fq12w.cuh's step has five.
//
// Lanes: on the card a thread is one lane (Group<G>::N = 1), a shuffle
// is __shfl_sync within the group's G lanes and a ballot
// __ballot_sync's bits of the group; without __CUDACC__ one call runs
// all G lanes of a group (N = G, every per-lane value an array over the
// lanes), a shuffle reads the source lane's entry and a ballot gathers
// the lanes' bits, so a host compiler runs the very same chains, one
// group after another.
#pragma once

#include "fq12w.cuh"

namespace tl {

using fqw::kWords;
using tw::kFq12;

// -q^-1 mod R = 2^384 as 12 words: its low W words are q' of radix
// 2^(32 W) (tests/test_torch_final_exp_lanes.py checks it).
FQW_CONST uint32_t kQInvR[kWords] = {
    0xfffcfffd, 0x89f3fffc, 0xd9d113e8, 0x286adb92, 0xc8e30b48, 0x16ef2ef0,
    0x8eb2db4c, 0x19ecca0e, 0xe268cf58, 0x68b316fe, 0xfeaafc94, 0xceb06106};

// A value in digits of W words: kLanes digits, in a group of kGroup
// lanes (a power of two; lanes from kLanes on hold zero).  W = 12 is one
// product a thread (fqw::mont_mul), kept to time against the split.
template <int W>
struct Split {
  static_assert(kWords % W == 0, "W divides 12");
  static constexpr int kLanes = kWords / W;
  static constexpr int kGroup = kLanes == 1 ? 1 : kLanes <= 2 ? 2
                              : kLanes <= 4 ? 4 : kLanes <= 8 ? 8 : 16;
};

// The lanes of one group that this call runs: entry j of a per-lane
// array [N] or [N][M] is lane lane(j)'s; from() reads lane src's entry
// (src modulo G), ballot() sets bit l where lane l's flag is true.
template <int G>
struct Group {
#if defined(__CUDACC__)
  static constexpr int N = 1;
  int me;      // the lane in the group
  int shift;   // the group's first lane in the warp
  __device__ __forceinline__ int lane(int) const { return me; }
  __device__ __forceinline__ uint32_t from(const uint32_t (&v)[1],
                                           int src) const {
    if constexpr (G == 1) return v[0];
    return __shfl_sync(0xffffffffu, v[0], src, G);
  }
  template <int M>
  __device__ __forceinline__ uint32_t from(const uint32_t (&v)[1][M], int w,
                                           int src) const {
    if constexpr (G == 1) return v[0][w];
    return __shfl_sync(0xffffffffu, v[0][w], src, G);
  }
  __device__ __forceinline__ uint32_t ballot(const bool (&b)[1]) const {
    if constexpr (G == 1) return b[0] ? 1u : 0u;
    return (__ballot_sync(0xffffffffu, b[0]) >> shift) & ((1u << G) - 1u);
  }
#else
  static constexpr int N = G;
  int lane(int j) const { return j; }
  uint32_t from(const uint32_t (&v)[G], int src) const {
    return v[src & (G - 1)];
  }
  template <int M>
  uint32_t from(const uint32_t (&v)[G][M], int w, int src) const {
    return v[src & (G - 1)][w];
  }
  uint32_t ballot(const bool (&b)[G]) const {
    uint32_t m = 0;
    for (int j = 0; j < G; ++j) m |= (b[j] ? 1u : 0u) << j;
    return m;
  }
#endif
};

// q's digit l (words W l .. W l + W - 1), zero for l >= kLanes: selects,
// so no register array is indexed at run time.
template <int W>
TW_FN void q_digit(int l, uint32_t (&d)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t x = 0;
#pragma unroll
    for (int k = 0; k < Split<W>::kLanes; ++k) {
      x = l == k ? fqw::kQ[W * k + w] : x;
    }
    d[w] = x;
  }
}

// col[j + k] += lo(x_j y_k), col[j + k + 1] += hi(x_j y_k) for the W x W
// products (each independent of the others), within C columns.
template <int W, int C>
TW_FN void mac_cols(uint64_t (&col)[C], const uint32_t* x, const uint32_t* y) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (j + k >= C) continue;
      const uint64_t p = static_cast<uint64_t>(x[j]) * y[k];
      col[j + k] += static_cast<uint32_t>(p);
      if (j + k + 1 < C) col[j + k + 1] += p >> 32;
    }
  }
}

// The words of C columns (their sum: words + carry 2^(32 C)); returns the
// carry.
template <int C>
TW_FN uint32_t carry_cols(const uint64_t (&col)[C], uint32_t (&d)[C]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const uint64_t s = col[i] + c;
    d[i] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  return static_cast<uint32_t>(c);
}

// u += x y for W-word x, y into 2W + 1 words (the sum fits): the
// products' halves in 64-bit columns (no product waits on another's
// carry), then one carry pass.
template <int W>
TW_FN void add_product(uint32_t (&u)[2 * W + 1], const uint32_t* x,
                       const uint32_t* y) {
  uint64_t col[2 * W + 1];
#pragma unroll
  for (int c = 0; c < 2 * W + 1; ++c) col[c] = u[c];
  mac_cols<W, 2 * W + 1>(col, x, y);
  carry_cols<2 * W + 1>(col, u);
}

// m = x q' mod beta: the low W words of a W x W-word product.
template <int W>
TW_FN void mul_low(const uint32_t* x, uint32_t (&m)[W]) {
  uint32_t q[W];
#pragma unroll
  for (int k = 0; k < W; ++k) q[k] = kQInvR[k];
  uint64_t col[W];
#pragma unroll
  for (int i = 0; i < W; ++i) col[i] = 0;
  mac_cols<W, W>(col, x, q);
  carry_cols<W>(col, m);
}

// Exact digits of sum_l (d_l + c_l beta) beta^l, for the group's digits d
// (W words a lane) and carries c: each lane adds the carry of the lane
// below; the carries that ripple on, through digits of all ones, go by
// a lookahead on two ballots (the carry into lane l is bit l of ((gen <<
// 1) + prop) ^ prop, gen and prop the lanes' generate and propagate
// bits).  top: the part above digit L - 1, valid in lane L - 1.
template <int W, int G>
TW_FN void resolve(const Group<G>& g, uint32_t (&d)[Group<G>::N][W],
                   const uint32_t (&c)[Group<G>::N],
                   uint32_t (&top)[Group<G>::N]) {
  constexpr int L = Split<W>::kLanes;
  constexpr int N = Group<G>::N;
  bool gen[N], prop[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = g.lane(j);
    const uint32_t below = g.from(c, (l + G - 1) & (G - 1));
    uint64_t s = l > 0 && l < L ? below : 0u;
    uint32_t ones = 0xffffffffu;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      s += d[j][w];
      d[j][w] = static_cast<uint32_t>(s);
      ones &= d[j][w];
      s >>= 32;
    }
    gen[j] = s != 0;
    prop[j] = ones == 0xffffffffu && l < L;
  }
  const uint32_t gm = g.ballot(gen), pm = g.ballot(prop);
  const uint32_t k = ((gm << 1) + pm) ^ pm;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = g.lane(j);
    uint64_t s = (k >> l) & 1u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      s += d[j][w];
      d[j][w] = static_cast<uint32_t>(s);
      s >>= 32;
    }
    top[j] = c[j] + ((k >> L) & 1u);
  }
}

// d -= e for one lane's W-word digits; returns whether it borrowed.
template <int W>
TW_FN bool sub_digit(uint32_t (&d)[W], const uint32_t (&e)[W]) {
  uint64_t b = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint64_t s = static_cast<uint64_t>(d[w]) - e[w] - b;
    d[w] = static_cast<uint32_t>(s);
    b = s >> 63;
  }
  return b != 0;
}

// The borrows between the lanes' differences d (each lane's own borrow
// in gen): the borrow into lane l by the lookahead of resolve (a digit
// of zeros propagates), taken off each digit.  Returns whether the top
// digit borrowed.
template <int W, int G>
TW_FN bool borrow(const Group<G>& g, uint32_t (&d)[Group<G>::N][W],
                  const bool (&gen)[Group<G>::N]) {
  constexpr int L = Split<W>::kLanes;
  constexpr int N = Group<G>::N;
  bool prop[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint32_t any = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) any |= d[j][w];
    prop[j] = any == 0 && g.lane(j) < L;
  }
  const uint32_t gm = g.ballot(gen), pm = g.ballot(prop);
  const uint32_t k = ((gm << 1) + pm) ^ pm;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t b = (k >> g.lane(j)) & 1u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t s = static_cast<uint64_t>(d[j][w]) - b;
      d[j][w] = static_cast<uint32_t>(s);
      b = s >> 63;
    }
  }
  return (k >> L) & 1u;
}

// V mod q in [0, q) for V = sum_l d_l beta^l + top 2^384 < 2^400 (top
// valid in lane L - 1), into d: fqw::reduce13 across the group.  qhat
// from lane L - 1's top 64 bits (at most one below floor(V / q)), the
// digits of qhat q mod 2^384 (resolved), V - qhat q in [0, 2q) by a
// borrow lookahead (the parts above 2^384 cancel), then q subtracted
// unless that borrows.
template <int W, int G>
TW_FN void reduce(const Group<G>& g, uint32_t (&d)[Group<G>::N][W],
                  const uint32_t (&top)[Group<G>::N]) {
  constexpr int L = Split<W>::kLanes;
  constexpr int N = Group<G>::N;
  uint32_t qh[N], s[N][W], sc[N], unused[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint64_t hi = (static_cast<uint64_t>(top[j]) << 32) | d[j][W - 1];
#if defined(__CUDA_ARCH__)
    qh[j] = static_cast<uint32_t>(__umul64hi(hi, fqw::kQTopRecip));
#else
    qh[j] = static_cast<uint32_t>(
        (static_cast<unsigned __int128>(hi) * fqw::kQTopRecip) >> 64);
#endif
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t qhat = g.from(qh, L - 1);
    uint32_t qd[W];
    q_digit<W>(g.lane(j), qd);
    uint64_t c = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t p = static_cast<uint64_t>(qhat) * qd[w] + c;
      s[j][w] = static_cast<uint32_t>(p);
      c = p >> 32;
    }
    sc[j] = static_cast<uint32_t>(c);
  }
  resolve<W>(g, s, sc, unused);
  bool gen[N];
#pragma unroll
  for (int j = 0; j < N; ++j) gen[j] = sub_digit<W>(d[j], s[j]);
  borrow<W>(g, d, gen);
  uint32_t u[N][W];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint32_t qd[W];
    q_digit<W>(g.lane(j), qd);
#pragma unroll
    for (int w = 0; w < W; ++w) u[j][w] = d[j][w];
    gen[j] = sub_digit<W>(u[j], qd);
  }
  const bool below_q = borrow<W>(g, u, gen);
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int w = 0; w < W; ++w) d[j][w] = below_q ? d[j][w] : u[j][w];
  }
}

// out = REDC(a b) = a b R^-1 mod q in [0, q) for any a, b < R, as the
// group's digits: fqw::mont_mul's words.  Bounds (beta = 2^(32 W)): t_l
// <= 3 beta - 2 at the start of a round, so t_l + a_l b_i + m q_l < 2
// beta^2 fits 2W + 1 words (and every column stays below 2^36); its
// high part is below 2 beta, plus the next lane's low digit below beta,
// so the bound holds again; lane 0's low digit is 0 mod beta by the
// choice of m; at the end sum t_l beta^l = (a b + M q) / R < R + q.
template <int W, int G>
TW_FN void mont_split(const Group<G>& g, const uint32_t (&a)[Group<G>::N][W],
                      const uint32_t (&b)[Group<G>::N][W],
                      uint32_t (&out)[Group<G>::N][W]) {
  constexpr int N = Group<G>::N;
  if constexpr (W == kWords) {
    for (int j = 0; j < N; ++j) fqw::mont_mul(a[j], b[j], out[j]);
  } else {
    constexpr int L = Split<W>::kLanes;
    constexpr int C = 2 * W + 1;
    uint32_t bd[L][W], t[N][W + 1], qd[N][W];
#pragma unroll
    for (int i = 0; i < L; ++i) {
#pragma unroll
      for (int w = 0; w < W; ++w) bd[i][w] = g.from(b, w, i);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      q_digit<W>(g.lane(j), qd[j]);
#pragma unroll
      for (int w = 0; w <= W; ++w) t[j][w] = 0;
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
      uint32_t u[N][C], m[N][W], lo[N][W];
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int c = 0; c < C; ++c) u[j][c] = c <= W ? t[j][c] : 0u;
        add_product<W>(u[j], a[j], bd[i]);
        mul_low<W>(u[j], m[j]);         // lane 0's is the round's m
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        uint32_t mb[W];
#pragma unroll
        for (int w = 0; w < W; ++w) mb[w] = g.from(m, w, 0);
        add_product<W>(u[j], mb, qd[j]);
#pragma unroll
        for (int w = 0; w < W; ++w) lo[j][w] = u[j][w];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int l = g.lane(j);
        uint64_t s = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const uint32_t up = g.from(lo, w, (l + 1) & (G - 1));
          s += static_cast<uint64_t>(u[j][W + w]) + (l + 1 < L ? up : 0u);
          t[j][w] = static_cast<uint32_t>(s);
          s >>= 32;
        }
        t[j][W] = u[j][2 * W] + static_cast<uint32_t>(s);
      }
    }
    uint32_t c[N], top[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int w = 0; w < W; ++w) out[j][w] = t[j][w];
      c[j] = t[j][W];
    }
    resolve<W>(g, out, c, top);
    reduce<W>(g, out, top);
  }
}

// The sum of a form's Len terms (|c| << 8 | i) over 12 values v, in the
// 64-bit columns of words w0 .. w0 + W - 1: i < n takes c v_i, i >= n
// takes c (q - v_(i - n)) as c (~v + q + 1) - c 2^384.  Adds the columns
// to col and the 2^384s to *negs.  Neg: whether the form may hold a
// negated term (Shape<Op>::neg for an operand).
template <int Len, int W, bool Neg = true>
TW_FN void form_cols(const int* form, const uint32_t* v, int n, int w0,
                     uint64_t (&col)[W], uint32_t* negs) {
  int terms[Len];
#pragma unroll
  for (int u = 0; u < Len; ++u) terms[u] = form[u];
#pragma unroll
  for (int u = 0; u < Len; ++u) {
    const int idx = terms[u] & 255;
    const uint32_t c = static_cast<uint32_t>(terms[u]) >> 8;
    const bool neg = Neg && idx >= n;
    const uint32_t flip = neg ? 0xffffffffu : 0u;
    const uint32_t* src = v + (neg ? idx - n : idx) * kWords + w0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      col[w] += static_cast<uint64_t>(c) * (src[w] ^ flip);
    }
    *negs += neg ? c : 0u;
  }
}

// The group's digits of a sum of terms: lane l's columns (form_cols at
// its digit's words), plus negs (q + 1), carried within the lane, then
// between the lanes.  top (valid in lane L - 1): the sum's part above
// 2^384, less nothing (the caller takes the 2^384s off).
template <int W, int G>
TW_FN void digits(const Group<G>& g, uint64_t (&col)[Group<G>::N][W],
                  const uint32_t (&negs)[Group<G>::N],
                  uint32_t (&d)[Group<G>::N][W],
                  uint32_t (&top)[Group<G>::N]) {
  constexpr int L = Split<W>::kLanes;
  constexpr int N = Group<G>::N;
  uint32_t c[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = g.lane(j);
    uint32_t qd[W];
    q_digit<W>(l, qd);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      col[j][w] += static_cast<uint64_t>(negs[j]) *
                   (qd[w] + (l == 0 && w == 0 ? 1u : 0u));
    }
    c[j] = carry_cols<W>(col[j], d[j]);
    if (l >= L) {
      c[j] = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) d[j][w] = 0;
    }
  }
  resolve<W>(g, d, c, top);
}

// One operand of a product: the form's sum over v (12 values), below 8q
// < R, as the group's digits (the 2^384s are the carry out of the top
// digit, dropped).
template <int Len, int W, bool Neg, int G>
TW_FN void operand(const Group<G>& g, const int* form, const uint32_t* v,
                   uint32_t (&out)[Group<G>::N][W]) {
  constexpr int L = Split<W>::kLanes;
  constexpr int N = Group<G>::N;
  uint64_t col[N][W];
  uint32_t negs[N], top[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = g.lane(j);
#pragma unroll
    for (int w = 0; w < W; ++w) col[j][w] = 0;
    negs[j] = 0;
    form_cols<Len, W, Neg>(form, v, 12, l < L ? W * l : 0, col[j],
                           &negs[j]);
  }
  digits<W>(g, col, negs, out, top);
}

// Output j of a record: its LO terms over the products P (q - P_k at
// index kMaxProducts + k) and LI over the input x, reduced into [0, q),
// as the group's digits.
template <int LO, int LI, int W, int G>
TW_FN void output(const Group<G>& g, const int* fo, const int* fi,
                  const uint32_t* prod, const uint32_t* x,
                  uint32_t (&out)[Group<G>::N][W]) {
  constexpr int L = Split<W>::kLanes;
  constexpr int N = Group<G>::N;
  uint64_t col[N][W];
  uint32_t negs[N], top[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = g.lane(j);
    const int w0 = l < L ? W * l : 0;
#pragma unroll
    for (int w = 0; w < W; ++w) col[j][w] = 0;
    negs[j] = 0;
    form_cols<LO, W>(fo, prod, tw::kMaxProducts, w0, col[j], &negs[j]);
    if constexpr (LI > 0) form_cols<LI, W>(fi, x, 12, w0, col[j], &negs[j]);
  }
  digits<W>(g, col, negs, out, top);
#pragma unroll
  for (int j = 0; j < N; ++j) top[j] -= negs[j];   // V < 2^400 now
  reduce<W>(g, out, top);
}

// Runs f(group, index, keep) for n groups of G lanes, then a barrier: on
// the card group k is threads G k .. G k + G - 1, and a warp whose first
// group is below n runs whole (its groups past n repeat group n - 1 with
// keep false, so every shuffle and ballot has the whole warp); on the
// host one group after another.
template <int G, class F>
TW_FN void groups(int n, F&& f) {
#if defined(__CUDACC__)
  const int t = static_cast<int>(threadIdx.x);
  if ((t & ~31) / G < n) {
    const int k = t / G;
    f(Group<G>{t % G, (t & 31) & ~(G - 1)}, k < n ? k : n - 1, k < n);
  }
  __syncthreads();
#else
  for (int k = 0; k < n; ++k) f(Group<G>{}, k, true);
#endif
}

// Each lane writes its digit of the value at dst.
template <int W, int G>
TW_FN void store(const Group<G>& g, const uint32_t (&v)[Group<G>::N][W],
                 uint32_t* dst) {
#pragma unroll
  for (int j = 0; j < Group<G>::N; ++j) {
    const int l = g.lane(j);
    if (l >= Split<W>::kLanes) continue;
#pragma unroll
    for (int w = 0; w < W; ++w) dst[W * l + w] = v[j][w];
  }
}

// out = the bilinear map of record Op at (x, y), each product and its
// operands on a group of Split<W>::kGroup lanes, each output on a group
// of Split<WO>::kGroup; prod: kMaxProducts x 12 words of shared scratch.
// Every thread of the block calls it; out may alias x or y (an output's
// only input term is its own value, whose words each lane reads before
// the group's first shuffle and writes after its last).
template <int Op, int W, int WO>
TW_OUTLINE void step(const int* prog, const uint32_t* x, const uint32_t* y,
                     uint32_t* out, uint32_t* prod) {
  using S = tw::Shape<Op>;
  constexpr int G = Split<W>::kGroup;
  constexpr int N = Group<G>::N;
  constexpr int GO = Split<WO>::kGroup;
  const int* fa = tw::op_record(prog, Op);
  const int* fb = fa + S::k * S::la;
  const int* fo = fb + S::k * S::lb;
  const int* fi = fo + 12 * S::lo;
  groups<G>(S::k, [&](const Group<G>& g, int k, bool keep) {
    uint32_t a[N][W], b[N][W], p[N][W];
    operand<S::la, W, S::neg>(g, fa + k * S::la, x, a);
    operand<S::lb, W, S::neg>(g, fb + k * S::lb, y, b);
    mont_split<W>(g, a, b, p);
    if (keep) store<W>(g, p, prod + k * kWords);
  });
  groups<GO>(12, [&](const Group<GO>& g, int j, bool keep) {
    uint32_t r[Group<GO>::N][WO];
    output<S::lo, S::li, WO>(g, fo + j * S::lo, fi + j * S::li, prod, x, r);
    if (keep) store<WO>(g, r, out + j * kWords);
  });
}

// The kernels' split: a product on 4 lanes of 3 words, an output on 8
// lanes of 2 (the fastest pairs on the H100, PERF.md).
constexpr int kW = 3;
constexpr int kWO = 2;
// Threads of a block that runs step<kMul, kW, kWO>: 54 groups, in whole
// warps.
constexpr int kThreads =
    (tw::Shape<tw::kMul>::k * Split<kW>::kGroup + 31) / 32 * 32;
static_assert(12 * Split<kWO>::kGroup <= kThreads, "outputs fit the block");

TW_FN void mul(const int* prog, const uint32_t* x, const uint32_t* y,
               uint32_t* out, const tw::Scratch& s) {
  step<tw::kMul, kW, kWO>(prog, x, y, out, s.prod);
}

TW_FN void cyc_sqr(const int* prog, uint32_t* x, const tw::Scratch& s) {
  step<tw::kCyc, kW, kWO>(prog, x, x, x, s.prod);
}

// acc = base^e for base in the cyclotomic subgroup, e given by nd digits
// in base 2^width, most significant first, the first nonzero:
// table[d - 1] = base^d for d < 2^width (2^width - 2 products), then
// width cyclotomic squares per digit and a product by the table for
// each nonzero digit.  Digits are clamped into the table's range
// (fq12_tower.py makes them valid).
TW_OUTLINE void pow_digits(const int* prog, const uint32_t* base,
                           const int* digits, int nd, int width,
                           uint32_t* acc, uint32_t* table, const tw::Scratch& s) {
  const int top = (1 << width) - 1;
  tw::copy(base, table);
  for (int d = 2; d <= top; ++d) {
    mul(prog, table + (d - 2) * kFq12, base, table + (d - 1) * kFq12, s);
  }
  const int d0 = digits[0] < 1 ? 1 : (digits[0] > top ? top : digits[0]);
  tw::copy(table + (d0 - 1) * kFq12, acc);
  for (int i = 1; i < nd; ++i) {
    for (int r = 0; r < width; ++r) cyc_sqr(prog, acc, s);
    const int d = digits[i] < 0 ? 0 : (digits[i] > top ? top : digits[i]);
    if (d) mul(prog, acc, table + (d - 1) * kFq12, acc, s);
  }
}

// Buffers of one block's hard part, each kFq12 words, and a table of
// (2^4 - 1) elements.
struct HardBuffers {
  uint32_t *f, *a, *b, *t, *u, *table;
};

// h.a = h.f^((q^4 - q^2 + 1) / r) for h.f in the cyclotomic subgroup (an
// easy-part output), with x = -BLS_X: a = f^((x - 1)^2 / 3), b = a^x a^q,
// c = b^(x^2) b^(q^2) b^-1, out = c f, where a^x = conj(a^|x|), b^-1 =
// conj(b) and the cyclotomic square hold only in that subgroup.  consts:
// the Frobenius maps' 12 + 12 Fq constants (y of records kFrob1, kFrob2).
TW_OUTLINE void hard_pow_tower(const int* prog, const uint32_t* consts,
                               const int* d1, int n1, const int* dx, int nx,
                               const HardBuffers& h, const tw::Scratch& s) {
  pow_digits(prog, h.f, d1, n1, 4, h.a, h.table, s);      // a
  pow_digits(prog, h.a, dx, nx, 1, h.t, h.table, s);      // a^|x|
  tw::conj(h.t, h.t);                                     // a^x
  tw::bilinear<tw::kFrob1>(prog, h.a, consts, h.u, s);    // a^q
  mul(prog, h.t, h.u, h.b, s);                            // b
  pow_digits(prog, h.b, dx, nx, 1, h.t, h.table, s);      // b^|x|
  pow_digits(prog, h.t, dx, nx, 1, h.a, h.table, s);      // b^(x^2)
  tw::bilinear<tw::kFrob2>(prog, h.b, consts + 12 * kWords, h.u, s);
  mul(prog, h.a, h.u, h.a, s);                            // b^(q^2)
  tw::conj(h.b, h.u);                                     // b^-1
  mul(prog, h.a, h.u, h.a, s);                            // c
  mul(prog, h.a, h.f, h.a, s);                            // c f
}

// The hard part of one flat element (fq12_hard_pow).  Inline: the
// kernel calls it once, and its arguments stay in registers.
TW_FN void hard_pow_row(const int* prog, const uint32_t* consts,
                             const int* d1, int n1, const int* dx, int nx,
                             const int* in, int* out, const HardBuffers& h,
                             const tw::Scratch& s) {
  tw::flat_to_tower(in, h.f, 1);
  hard_pow_tower(prog, consts, d1, n1, dx, nx, h, s);
  tw::tower_to_flat(h.a, out);
}

// The product of n flat elements (n >= 1) into the tower element f, as
// fq12w.cuh's product_tower with the split step's products.
TW_OUTLINE void product(const int* prog, const int* in, int n,
                              uint32_t* f, uint32_t* table,
                              const tw::Scratch& s) {
  for (int i = 0; i < n; i += tw::kProductChunk) {
    const int m = n - i < tw::kProductChunk ? n - i : tw::kProductChunk;
    tw::flat_to_tower(in + i * tw::kFlatInts, table, m);
    int j = 0;
    if (i == 0) {
      tw::copy(table, f);
      j = 1;
    }
    for (; j < m; ++j) mul(prog, f, table + j * kFq12, f, s);
  }
}

// The final exponentiation of the product of n flat elements (n >= 1):
// out = p^((q^12 - 1) / r) for p = in_0 ... in_(n-1), as canonical flat
// limbs, and *ok = (out == 1).  The inputs enter the tower up to 15 at a
// time (into the table, free until the hard part) and multiply into h.f;
// the easy part f^((q^6 - 1)(q^2 + 1)) is conj(f) f^-1 (fq12w.cuh's
// tower_inv, one Fq inversion), then its q^2 power times itself; the
// hard part is hard_pow_tower's chain.  Inline: the kernel calls it
// once, and its twelve arguments stay in registers.
TW_FN void final_exp_row(const int* prog, const uint32_t* consts,
                              const int* d1, int n1, const int* dx, int nx,
                              const int* in, int n, int* out, int* ok,
                              const HardBuffers& h, const tw::Scratch& s) {
  tl::product(prog, in, n, h.f, h.table, s);
  tw::conj(h.f, h.a);
  tw::tower_inv(prog, h.f, h.a, h.b, h.t, h.u, s);
  mul(prog, h.a, h.b, h.f, s);                            // f^(q^6 - 1)
  tw::bilinear<tw::kFrob2>(prog, h.f, consts + 12 * kWords, h.a, s);
  mul(prog, h.a, h.f, h.f, s);                            // ^(q^2 + 1)
  hard_pow_tower(prog, consts, d1, n1, dx, nx, h, s);
  tw::tower_to_flat(h.a, out);
  tw::tasks(1, [&](int) { *ok = tw::fq12_is_one(h.a) ? 1 : 0; });
}

}  // namespace tl
