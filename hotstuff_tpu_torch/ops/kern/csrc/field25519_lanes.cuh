// GF(2^255 - 19) on lane groups: the field arithmetic, point formulas and
// row loops of point_ladder and point_multiples (point_chain.cu), and the
// squaring and canonical form of decompress, whose rows each run on one
// group, four rows a warp.  field25519.cuh keeps the one-limb-a-lane
// functions of the other kernels.
//
// Layout (point_ladder, point_multiples): one warp a row, in four groups
// of G = 8 lanes.  A group holds one field element, lane l of the group
// holding limbs 4l .. 4l + 3 of the (..., 32) int32 radix-2^8 weak form
// (every limb < 2^9).  Each point
// formula (dbl, add_cached) is two phases of four independent multiplies,
// and group g runs product g of each phase, then takes the other groups'
// products by warp shuffles, so a step's critical path is ~10 multiplies,
// not 37.  Between phases every group runs the same linear ops on whole
// values.  All lanes of the warp call every function together.
//
// Op boundaries and carry schedule are the reference's
// (hotstuff_tpu/ops/field25519.py): add = one parallel carry step, sub =
// 8p bias + two steps, mul = the exact coefficients of the 32 x 32
// product with the high half folded in times 38, then four parallel
// steps.  So the limbs equal the reference's limb for limb, not only
// modulo p.
//
// The multiply.  Lane l owns outputs j = 4l + v (v < 4), each
//   x_j = sum_i a_i * b_((j - i) mod 32) * (i <= j ? 1 : 38),
// the reference's lo_j + 38 * hi_j as one exact integer.  In step t
// (0 .. 7) lane l takes the a block of lane (l - t) mod 8 (its own at
// t = 0) and the b limbs 4t - 3 .. 4t + 3, the same for every lane of the
// group: block t and the top of block t - 1 (of block 7 at t = 0).  Every
// product of that a block with that window lands on an own output, and
// its weight is 38 exactly when i > j: when t > l, and at t = 0 when
// u > v (a limb u of the own block against output v).  Scaling the a
// block by 38 folds the high half into the sum, which gives the same
// integer.  Limbs travel two to a 32-bit word (16 bits apiece); packed
// words are shuffled, never multiplied.  A multiply shuffles 2 words for
// each of 7 a blocks and 8 b blocks (block 7 once, kept for t = 0 and
// t = 7), plus one word for each of its four carry steps: 34, against
// 64 + 4 in field25519.cuh.
//
// Exactness: products < 2^18, scaled ones < 38 * 2^18, and a coefficient
// sums 32 of them: < 32 * 38 * 511^2 < 2^29, all int32 as in the
// reference.  tests/test_torch_point_ladder_layout.py holds a numpy model
// of this schedule (which lane holds which limbs, which words travel,
// which products each lane sums) to the JAX package's multiply.
#pragma once

namespace hk {
namespace lanes {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPtInts = 4 * 32;  // int32 values per point
constexpr int L = 4;             // limbs a lane
constexpr int G = 32 / L;        // lanes a group (one field element)

// One lane's share of a field element: limbs L*l .. L*l + L - 1.
struct Fe {
  int v[L];
};

// This thread's place: g its group (the product of each phase it runs),
// l its lane in the group.
struct Lane {
  int g, l;
};

__device__ __forceinline__ int group_shfl(int x, int src) {
  return __shfl_sync(kFull, x, src, G);
}

// One of the reference's parallel carry steps: limb i keeps its low byte
// and takes limb i - 1's high bits, limb 31's times 38 into limb 0
// (2^256 = 38 mod p).  Limb L*l - 1 comes from the lane below.
__device__ __forceinline__ Fe carry_step(const Fe& x, int l) {
  const int up = group_shfl(x.v[L - 1], (l - 1) & (G - 1)) >> 8;
  Fe r;
  r.v[0] = (x.v[0] & 0xFF) + (l == 0 ? 38 * up : up);
#pragma unroll
  for (int v = 1; v < L; ++v) r.v[v] = (x.v[v] & 0xFF) + (x.v[v - 1] >> 8);
  return r;
}

template <int K>
__device__ __forceinline__ Fe carry(Fe x, int l) {
#pragma unroll
  for (int s = 0; s < K; ++s) x = carry_step(x, l);
  return x;
}

__device__ __forceinline__ Fe add(const Fe& a, const Fe& b, int l) {
  Fe s;
#pragma unroll
  for (int v = 0; v < L; ++v) s.v[v] = a.v[v] + b.v[v];
  return carry<1>(s, l);
}

// a + 8p - b, 8p spread over the limbs as [8*237, 8*255 x30, 8*127]: every
// bias limb dominates any weak limb, so nothing goes negative.
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b, int l) {
  Fe s;
#pragma unroll
  for (int v = 0; v < L; ++v) {
    const int i = L * l + v;
    const int bias = i == 0 ? 8 * 237 : (i == 31 ? 8 * 127 : 8 * 255);
    s.v[v] = a.v[v] + bias - b.v[v];
  }
  return carry<2>(s, l);
}

// The reference's neg: sub(0, a).
__device__ __forceinline__ Fe neg(const Fe& a, int l) {
  return sub(Fe{}, a, l);
}

// Limbs 2w and 2w + 1 of a block in word w, 16 bits apiece.
__device__ __forceinline__ void pack(const Fe& x, int (&w)[L / 2]) {
#pragma unroll
  for (int i = 0; i < L / 2; ++i) w[i] = x.v[2 * i] | (x.v[2 * i + 1] << 16);
}

__device__ __forceinline__ Fe unpack(const int (&w)[L / 2]) {
  Fe x;
#pragma unroll
  for (int i = 0; i < L / 2; ++i) {
    x.v[2 * i] = w[i] & 0xFFFF;
    x.v[2 * i + 1] = w[i] >> 16;
  }
  return x;
}

// The block of lane `src` of the group, from its packed words.
__device__ __forceinline__ Fe fetch(const int (&w)[L / 2], int src) {
  int got[L / 2];
#pragma unroll
  for (int i = 0; i < L / 2; ++i) got[i] = group_shfl(w[i], src);
  return unpack(got);
}

// a * b mod p, weak limbs in and out (the schedule above).
__device__ __forceinline__ Fe mul(const Fe& a, const Fe& b, int l) {
  int aw[L / 2], bw[L / 2];
  pack(a, aw);
  pack(b, bw);
  const Fe top = fetch(bw, G - 1);
  Fe prev;
  int acc[L];
  {
    const Fe cur = fetch(bw, 0);
#pragma unroll
    for (int v = 0; v < L; ++v) {
      int s = 0;
#pragma unroll
      for (int u = 0; u < L; ++u) {
        s += u <= v ? a.v[u] * cur.v[v - u]
                    : (38 * a.v[u]) * top.v[L + v - u];
      }
      acc[v] = s;
    }
    prev = cur;
  }
#pragma unroll
  for (int t = 1; t < G; ++t) {
    const Fe cur = t == G - 1 ? top : fetch(bw, t);
    Fe am = fetch(aw, (l - t) & (G - 1));
    const int scale = t <= l ? 1 : 38;
#pragma unroll
    for (int u = 0; u < L; ++u) am.v[u] *= scale;
#pragma unroll
    for (int v = 0; v < L; ++v) {
#pragma unroll
      for (int u = 0; u < L; ++u) {
        acc[v] += am.v[u] * (u <= v ? cur.v[v - u] : prev.v[L + v - u]);
      }
    }
    prev = cur;
  }
  Fe x;
#pragma unroll
  for (int v = 0; v < L; ++v) x.v[v] = acc[v];
  return carry<4>(x, l);
}

// a^2 mod p, weak limbs in and out: the exact coefficients of mul(a, a)
// (the reference's sqr is that multiply), from 74 products a lane instead
// of 128, then the same four carry steps.
//
// Lane l owns outputs j = 4l + v.  A product a_i a_k with i + k = j (mod
// 32) has i in block m and k in block n with m + n = l (its "low" part,
// positions u + w = v) or m + n = l - 1 (its "high" part, u + w = v + 4),
// mod 8.  mul takes every ordered block pair; here each unordered pair is
// taken once and doubled, the self pairs (m = n) once as they are:
//   low  q = 0..3:  blocks (c - q, ceil(l/2) + q),   sum l,
//   high q = 0..3:  blocks (floor((l-1)/2) - q, c + q), sum l - 1,
// with c = floor(l/2), and the step q = 4 of whichever sum is even: the
// block c + 4 with itself, all seven coefficients of its square formed
// from 10 products, the low four kept on an even lane, the high three on
// an odd one.  A pair is a self pair when q = 0 and its sum is even;
// every other pair is doubled.  Its weight is 38 when its first block
// index goes below 0 (the pair wraps past limb 31): so each lane scales
// the blocks c - 1 .. c - 4 by 38 where c + s < 0, once, and every first
// factor comes from those scaled blocks (the last block's square takes
// one scaled and one plain copy).
//
// Each lane fetches the blocks c - 4 .. c + 3 (c - 4 is c + 4), one limb
// a shuffle, 32 in all (packed two to a word, the unpacking cost what the
// shuffles saved on the H100).  An odd lane takes the blocks
// ceil(l/2) + s by a select from the next block (fetching them by
// shuffle too measured slower).  The
// doubled products sum apart and are doubled once.  Sums stay below the
// multiply's (< 2^29): the same integers, summed in another order.
// tests/test_torch_decompress_layout.py holds a numpy model of this
// schedule to the JAX package's sqr, and runs this header on the host.
__device__ __forceinline__ Fe sqr(const Fe& a, int l) {
  const int c = l >> 1;
  const bool odd = l & 1;
  Fe u[G + 1];  // u[s + G / 2]: block c + s, s = -4 .. 4; u[G] unscaled
#pragma unroll
  for (int s = -G / 2; s < G / 2; ++s) {
#pragma unroll
    for (int v = 0; v < L; ++v) {
      u[s + G / 2].v[v] = group_shfl(a.v[v], (c + s) & (G - 1));
    }
  }
  u[G] = u[0];
#pragma unroll
  for (int s = -G / 2; s < 0; ++s) {
    const int wrap = c + s < 0 ? 38 : 1;
#pragma unroll
    for (int v = 0; v < L; ++v) u[s + G / 2].v[v] *= wrap;
  }
  int acc[L] = {0, 0, 0, 0}, dbl[L] = {0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < G / 2; ++q) {
    // Low part: blocks c - q and ceil(l/2) + q.
    const Fe& x = u[G / 2 - q];
    Fe y;
#pragma unroll
    for (int v = 0; v < L; ++v) {
      y.v[v] = odd ? u[G / 2 + q + 1].v[v] : u[G / 2 + q].v[v];
    }
    // High part: blocks floor((l-1)/2) - q and c + q.
    const Fe& z = u[G / 2 + q];
    Fe h;
#pragma unroll
    for (int v = 0; v < L; ++v) {
      h.v[v] = odd ? u[G / 2 - q].v[v] : u[G / 2 - q - 1].v[v];
    }
    if (q == 0) {  // a self pair on one parity, doubled on the other
#pragma unroll
      for (int v = 0; v < L; ++v) {
        int s = 0;
#pragma unroll
        for (int k = 0; k <= v; ++k) s += x.v[k] * y.v[v - k];
        acc[v] += (odd ? 2 : 1) * s;
      }
#pragma unroll
      for (int v = 0; v < L - 1; ++v) {
        int s = 0;
#pragma unroll
        for (int k = v + 1; k < L; ++k) s += h.v[k] * z.v[L + v - k];
        acc[v] += (odd ? 1 : 2) * s;
      }
    } else {
#pragma unroll
      for (int v = 0; v < L; ++v) {
#pragma unroll
        for (int k = 0; k <= v; ++k) dbl[v] += x.v[k] * y.v[v - k];
      }
#pragma unroll
      for (int v = 0; v < L - 1; ++v) {
#pragma unroll
        for (int k = v + 1; k < L; ++k) dbl[v] += h.v[k] * z.v[L + v - k];
      }
    }
  }
  // q = 4: block c + 4 squared, one factor scaled by 38.
  const Fe& xs = u[0];
  const Fe& x = u[G];
  const int c0 = xs.v[0] * x.v[0];
  const int c1 = 2 * (xs.v[0] * x.v[1]);
  const int c2 = 2 * (xs.v[0] * x.v[2]) + xs.v[1] * x.v[1];
  const int c3 = 2 * (xs.v[0] * x.v[3] + xs.v[1] * x.v[2]);
  const int c4 = 2 * (xs.v[1] * x.v[3]) + xs.v[2] * x.v[2];
  const int c5 = 2 * (xs.v[2] * x.v[3]);
  const int c6 = xs.v[3] * x.v[3];
  acc[0] += odd ? c4 : c0;
  acc[1] += odd ? c5 : c1;
  acc[2] += odd ? c6 : c2;
  acc[3] += odd ? 0 : c3;
  Fe r;
#pragma unroll
  for (int v = 0; v < L; ++v) r.v[v] = acc[v] + 2 * dbl[v];
  return carry<4>(r, l);
}

// True on every lane of the group when `pred` holds on all its lanes
// (all four groups of the warp call it together).
__device__ __forceinline__ bool group_all(bool pred, int g) {
  return ((__ballot_sync(kFull, pred) >> (G * g)) & 0xFFu) == 0xFFu;
}

// The carry (or borrow) into each lane's block from a short serial pass
// over the group: `out[k]` is the carry out of this lane's block for a
// carry k into it (k < 3); lane i's carry in is lane i - 1's carry out.
// Returns the carry into this lane, and sets `last` to the carry out of
// lane G - 1 on every lane.
__device__ __forceinline__ int carry_in(const int (&out)[3], int l,
                                        int& last) {
  int cin = 0, mine = 0;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    mine = l == i ? cin : mine;
    const int next = cin == 0 ? out[0] : (cin == 1 ? out[1] : out[2]);
    cin = group_shfl(next, i);
  }
  last = cin;
  return mine;
}

// The reference's sequential carry (field25519._sequential_carry): every
// limb becomes a byte, and the carry out of limb 31 is returned on every
// lane.  On weak limbs (< 2^9) a carry is at most 2.
__device__ __forceinline__ int ripple(Fe& x, int l) {
  int out[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int t = k;
#pragma unroll
    for (int v = 0; v < L; ++v) t = (x.v[v] + t) >> 8;
    out[k] = t;
  }
  int last;
  int t = carry_in(out, l, last);
#pragma unroll
  for (int v = 0; v < L; ++v) {
    t += x.v[v];
    x.v[v] = t & 0xFF;
    t >>= 8;
  }
  return last;
}

__device__ __forceinline__ int p_digit(int i) {
  return i == 0 ? 237 : (i == 31 ? 127 : 255);
}

// x - p if x >= p, else x (x canonical bytes below 2^256): the
// reference's borrow chain.
__device__ __forceinline__ Fe cond_sub_p(const Fe& x, int l) {
  int out[3];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    int b = k;
#pragma unroll
    for (int v = 0; v < L; ++v) b = x.v[v] - p_digit(L * l + v) - b < 0;
    out[k] = b;
  }
  out[2] = out[1];
  int last;
  int b = carry_in(out, l, last);
  Fe r;
#pragma unroll
  for (int v = 0; v < L; ++v) {
    const int d = x.v[v] - p_digit(L * l + v) - b;
    b = d < 0;
    r.v[v] = d + (b << 8);
  }
  return last ? x : r;  // a borrow out means x < p
}

// Weak element -> canonical bytes, value in [0, p): field25519.canonical.
__device__ __forceinline__ Fe canonical(Fe x, int l) {
  int c = ripple(x, l);
  x.v[0] += l == 0 ? 38 * c : 0;
  c = ripple(x, l);
  x.v[0] += l == 0 ? 38 * c : 0;
  return cond_sub_p(cond_sub_p(x, l), l);
}

// The four products of a formula's phase of independent multiplies.
struct Quad {
  Fe r[4];
};

__device__ __forceinline__ Fe pick(int g, const Fe& x0, const Fe& x1,
                                   const Fe& x2, const Fe& x3) {
  Fe r;
#pragma unroll
  for (int v = 0; v < L; ++v) {
    r.v[v] = g == 0 ? x0.v[v] : (g == 1 ? x1.v[v] : (g == 2 ? x2.v[v]
                                                             : x3.v[v]));
  }
  return r;
}

__device__ __forceinline__ Fe load_fe(const int* coord, int l) {
  const int4 q = *reinterpret_cast<const int4*>(coord + L * l);
  return Fe{{q.x, q.y, q.z, q.w}};
}

__device__ __forceinline__ void store_fe(int* coord, const Fe& x, int l) {
  *reinterpret_cast<int4*>(coord + L * l) =
      make_int4(x.v[0], x.v[1], x.v[2], x.v[3]);
}

// a_i * b_i for i < 4: group g runs product g, then every lane takes the
// same limbs of the other groups' products, two words from lane G*k + l
// of group k.
__device__ __forceinline__ Quad mul4(const Fe& a0, const Fe& b0,
                                     const Fe& a1, const Fe& b1,
                                     const Fe& a2, const Fe& b2,
                                     const Fe& a3, const Fe& b3,
                                     const Lane& ln) {
  const Fe p = mul(pick(ln.g, a0, a1, a2, a3), pick(ln.g, b0, b1, b2, b3),
                   ln.l);
  int w[L / 2];
  pack(p, w);
  Quad q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int got[L / 2];
#pragma unroll
    for (int i = 0; i < L / 2; ++i) {
      got[i] = __shfl_sync(kFull, w[i], G * k + ln.l);
    }
    q.r[k] = unpack(got);
  }
  return q;
}

// Extended (X, Y, Z, T).
struct Point {
  Fe x, y, z, t;
};

// Doubling (dbl-2008-hwcd, a = -1), op for op the reference's dbl_t, in
// two phases of four multiplies.  The T product comes free (a fourth
// group runs it), so every doubling computes T.
__device__ __forceinline__ Point dbl(const Point& p, const Lane& ln) {
  const int l = ln.l;
  const Fe s = add(p.x, p.y, l);
  const Quad m = mul4(p.x, p.x, p.y, p.y, p.z, p.z, s, s,
                      ln);  // a, b, zz, s^2
  const Fe& a = m.r[0];
  const Fe& b = m.r[1];
  const Fe c = add(m.r[2], m.r[2], l);
  const Fe e = sub(sub(m.r[3], a, l), b, l);  // 2*X1*Y1
  const Fe g = sub(b, a, l);
  const Fe f = sub(g, c, l);
  const Fe h = neg(add(a, b, l), l);
  const Quad n = mul4(e, f, g, h, f, g, e, h, ln);
  return Point{n.r[0], n.r[1], n.r[2], n.r[3]};
}

// Complete unified addition, extended + cached -> extended, op for op the
// reference's add_t, in two phases of four multiplies.  `q` is the one
// coordinate of the cached entry (Y+X, Y-X, Z, 2dT) that this group's
// first product takes: coordinate g ^ 1 (Y-X, Y+X, 2dT, Z for g = 0..3).
__device__ __forceinline__ Point add_cached(const Point& p, const Fe& q,
                                            const Lane& ln) {
  const int l = ln.l;
  const Quad m = mul4(sub(p.y, p.x, l), q, add(p.y, p.x, l), q, p.t, q,
                      p.z, q, ln);  // a, b, c, zz
  const Fe& a = m.r[0];
  const Fe& b = m.r[1];
  const Fe& c = m.r[2];
  const Fe d = add(m.r[3], m.r[3], l);
  const Fe e = sub(b, a, l);
  const Fe f = sub(d, c, l);
  const Fe g = add(d, c, l);
  const Fe h = add(b, a, l);
  const Quad n = mul4(e, f, g, h, f, g, e, h, ln);
  return Point{n.r[0], n.r[1], n.r[2], n.r[3]};
}

__device__ __forceinline__ int clamp_digit(int d, int k) {
  return d < 0 ? 0 : (d > k - 1 ? k - 1 : d);
}

// One row of point_ladder: from the identity, `steps` times kNdbl
// doublings and one addition of the cached entry trow[s or 0][digit].
// Step s + 1's entry is loaded during step s (and its digit during step
// s - 1), so the loads hide behind the formulas.  Digits are in [0, k)
// by construction; clamping keeps a bad one inside the table.  Group g
// stores coordinate g.
template <int kNdbl>
__device__ __forceinline__ void ladder_row(const int* trow, const int* drow,
                                           int* orow, int steps, int k,
                                           int per_step, const Lane& ln) {
  const long long step_stride = per_step ? static_cast<long long>(k) * kPtInts
                                         : 0;
  const int coord = (ln.g ^ 1) * 32;
  Point acc{};
  acc.y.v[0] = acc.z.v[0] = ln.l == 0 ? 1 : 0;  // the identity (0, 1, 1, 0)
  Fe next{};
  int d_next = 0;
  if (steps > 0) {
    next = load_fe(trow + clamp_digit(drow[0], k) * kPtInts + coord, ln.l);
    if (steps > 1) d_next = clamp_digit(drow[1], k);
  }
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const Fe q = next;
    if (s + 1 < steps) {
      next = load_fe(trow + (s + 1) * step_stride + d_next * kPtInts + coord,
                     ln.l);
      if (s + 2 < steps) d_next = clamp_digit(drow[s + 2], k);
    }
#pragma unroll 1
    for (int i = 0; i < kNdbl; ++i) acc = dbl(acc, ln);
    acc = add_cached(acc, q, ln);
  }
  store_fe(orow + ln.g * 32, pick(ln.g, acc.x, acc.y, acc.z, acc.t), ln.l);
}

// This lane's limbs of a row of 32 (no alignment asked).
__device__ __forceinline__ Fe load_limbs(const int* row, int l) {
  Fe x;
#pragma unroll
  for (int v = 0; v < L; ++v) x.v[v] = row[L * l + v];
  return x;
}

__device__ __forceinline__ Fe select(bool p, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int v = 0; v < L; ++v) r.v[v] = p ? a.v[v] : b.v[v];
  return r;
}

// One entry of point_multiples' table: group g stores coordinate g.
// Extended: (X, Y, Z, T).  Cached: Y+X, Y-X and Z here, every group
// forming the sums (all lanes shuffle together); group 3's T * 2d comes
// later (multiples_row).
template <bool kCached>
__device__ __forceinline__ void multiples_entry(int* entry, const Point& e,
                                                const Lane& ln) {
  if (kCached) {
    const Fe ypx = add(e.y, e.x, ln.l);
    const Fe ymx = sub(e.y, e.x, ln.l);
    if (ln.g < 3) {
      store_fe(entry + ln.g * 32, pick(ln.g, ypx, ymx, e.z, e.z), ln.l);
    }
  } else {
    store_fe(entry + ln.g * 32, pick(ln.g, e.x, e.y, e.z, e.t), ln.l);
  }
}

// One row of point_multiples (point_chain.cu): the 16-entry table 0P..15P
// of the extended point at `prow` (built from -P when `negate`), op for
// op the reference's msm_table and the per-signature ladder's table of -A:
// entry 0 the identity, entry 1 P, entry i = entry i - 1 + cached(P) for
// i = 2..15, each in extended form or, with kCached, cached form.  `k2d`
// is 2d's canonical limbs; `orow` gets (16, 4, 32) int32.  Every lane of
// the warp calls it together.
//
// Each group takes coordinate g ^ 1 of cached(P), the factor of its
// first product in every add_cached (ladder_row's q), so the 14 additions
// are two mul4 phases each.  The cached form's T * 2d: group g keeps the
// T of entries 4s + g (s < 4) as the loop passes them, then runs its four
// products (the four groups at once) and stores them; no other group
// needs them, so no exchange.
template <bool kCached>
__device__ __forceinline__ void multiples_row(const int* prow, int* orow,
                                              bool negate, const int* k2d,
                                              const Lane& ln) {
  const int l = ln.l;
  Point p{load_limbs(prow, l), load_limbs(prow + 32, l),
          load_limbs(prow + 64, l), load_limbs(prow + 96, l)};
  p.x = select(negate, neg(p.x, l), p.x);  // formed either way: the
  p.t = select(negate, neg(p.t, l), p.t);  // shuffles of every lane
  const Fe k = load_limbs(k2d, l);
  // cached(P) = (Y+X, Y-X, Z, 2dT): coordinate g ^ 1 for group g.
  const Fe q = pick(ln.g, sub(p.y, p.x, l), add(p.y, p.x, l), mul(p.t, k, l),
                    p.z);
  Point e{};
  e.y.v[0] = e.z.v[0] = l == 0 ? 1 : 0;  // the identity (0, 1, 1, 0)
  multiples_entry<kCached>(orow, e, ln);
  multiples_entry<kCached>(orow + kPtInts, p, ln);
  Fe t[4] = {};  // kCached: T of entries 4s + g; entry 0's is 0
  t[0] = select(ln.g == 1, p.t, t[0]);
  e = p;
#pragma unroll 1
  for (int i = 2; i < 16; ++i) {
    e = add_cached(e, q, ln);
    multiples_entry<kCached>(orow + i * kPtInts, e, ln);
    if (kCached) {
#pragma unroll
      for (int s = 0; s < 4; ++s) t[s] = select(i == 4 * s + ln.g, e.t, t[s]);
    }
  }
  if (kCached) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      store_fe(orow + (4 * s + ln.g) * kPtInts + 96, mul(t[s], k, l), l);
    }
  }
}

// decompress (point_chain.cu): ed25519.decompress_t for one row on one
// group, four rows a warp.
constexpr int kRowsPerWarp = 32 / G;

// The reference's pow_p58 chain as 11 steps of k squarings of the running
// value and one multiply by an earlier value (the slots x, x^(2^2 - 1),
// x^(2^5 - 1), x^(2^10 - 1), x^(2^20 - 1), x^(2^50 - 1), x^(2^100 - 1));
// the product goes back to a slot where a later step takes it.
struct PowStep {
  int k, take, keep;  // squarings, slot multiplied by, slot kept in (-1)
};
static __constant__ PowStep kPowSteps[11] = {
    {1, 0, 1},  {2, 1, -1}, {1, 0, 2},    {5, 2, 3},   {10, 3, 4}, {20, 4, -1},
    {10, 3, 5}, {50, 5, 6}, {100, 6, -1}, {50, 5, -1}, {2, 0, -1}};

// x^((p-5)/8) = x^(2^252 - 3): 251 squarings and 11 multiplies, op for op
// the reference's chain.  One loop of steps around one loop of squarings
// (unroll 1): one copy of each in the machine code.
__device__ __forceinline__ Fe pow_p58(const Fe& x, int l) {
  Fe slot[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) slot[i] = x;
  Fe acc = x;
#pragma unroll 1
  for (int s = 0; s < 11; ++s) {
    const PowStep st = kPowSteps[s];
#pragma unroll 1
    for (int i = 0; i < st.k; ++i) acc = sqr(acc, l);
    Fe m = slot[0];
#pragma unroll
    for (int i = 1; i < 7; ++i) m = select(st.take == i, slot[i], m);
    acc = mul(acc, m, l);
#pragma unroll
    for (int i = 1; i < 7; ++i) slot[i] = select(st.keep == i, acc, slot[i]);
  }
  return acc;
}

// Field equality of two canonical values, on every lane of group g.
__device__ __forceinline__ bool equal(const Fe& a, const Fe& b, int g) {
  bool same = true;
#pragma unroll
  for (int v = 0; v < L; ++v) same = same && a.v[v] == b.v[v];
  return group_all(same, g);
}

// One row of decompress, op for op the reference's decompress_t: the
// x-recovery x = u v^3 (u v^7)^((p-5)/8) with u = y^2 - 1, v = d y^2 + 1,
// the two equality tests, the sqrt(-1) fix-up and the sign flip.  `d`
// and `sqrt_m1` are canonical limbs; `orow` gets (x, y, 1, x y) and `ok`
// the mask when `live`.  Every lane of the warp calls it together.
__device__ __forceinline__ void decompress_row(
    const int* yrow, int sign, const int* d, const int* sqrt_m1, int* orow,
    unsigned char* ok, bool live, int g, int l) {
  const Fe y = load_limbs(yrow, l);
  const Fe one{{l == 0 ? 1 : 0, 0, 0, 0}};
  const Fe y2 = sqr(y, l);
  const Fe u = sub(y2, one, l);
  const Fe v = add(mul(load_limbs(d, l), y2, l), one, l);
  const Fe v3 = mul(sqr(v, l), v, l);
  const Fe v7 = mul(sqr(v3, l), v, l);
  Fe x = mul(mul(u, v3, l), pow_p58(mul(u, v7, l), l), l);
  const Fe vxx = canonical(mul(v, sqr(x, l), l), l);
  const bool ok_direct = equal(vxx, canonical(u, l), g);
  const bool ok_twist = equal(vxx, canonical(neg(u, l), l), g);
  x = select(ok_twist, mul(x, load_limbs(sqrt_m1, l), l), x);
  // Sign adjustment; x == 0 with sign 1 is invalid.
  const Fe xc = canonical(x, l);
  const bool x_zero = equal(xc, Fe{}, g);
  const int parity = group_shfl(xc.v[0], 0) & 1;
  x = select(parity != sign && !x_zero, neg(x, l), x);
  const Fe t = mul(x, y, l);
  if (live) {
    store_fe(orow, x, l);
    store_fe(orow + 32, y, l);
    store_fe(orow + 64, one, l);
    store_fe(orow + 96, t, l);
    if (l == 0) {
      *ok = (ok_direct || ok_twist) && !(x_zero && sign == 1) ? 1 : 0;
    }
  }
}

}  // namespace lanes
}  // namespace hk
