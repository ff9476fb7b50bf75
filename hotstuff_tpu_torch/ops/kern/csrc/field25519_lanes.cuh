// GF(2^255 - 19) on lane groups: the field arithmetic, point formulas and
// row loop of point_ladder (point_chain.cu).  Only point_ladder uses this
// header; field25519.cuh keeps the one-limb-a-lane functions of the other
// kernels.
//
// Layout: one warp a row, in four groups of G = 8 lanes.  A group holds
// one field element, lane l of the group holding limbs 4l .. 4l + 3 of the
// (..., 32) int32 radix-2^8 weak form (every limb < 2^9).  Each point
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

}  // namespace lanes
}  // namespace hk
