// GF(2^255 - 19) limb arithmetic shared by the field-multiply kernel
// (field_mul.cu), the MSM window accumulator (msm_accum.cu) and the
// point-chain kernels (point_chain.cu).
//
// Layout: one warp holds one field element, lane i holding limb i of the
// (..., 32) int32 radix-2^8 weak form (every limb < 2^9).  Every function
// below is called by all 32 lanes of a warp together (they shuffle), and
// reproduces the reference's op boundaries and carry schedule exactly:
// add = one parallel carry step, sub = 8p bias + two steps, mul = exact
// 32x32 schoolbook, x38 fold of the high half, four parallel steps.  So
// the limbs equal the reference's limb for limb, not only modulo p.
//
// Exactness: weak limbs are < 2^9, so products are < 2^18, coefficient
// sums < 2^23 and folded values < 39 * 2^23 < 2^29 -- all int32.
#pragma once

namespace hk {

constexpr unsigned kFullMask = 0xffffffffu;

// 2d mod p, canonical little-endian bytes (d the Edwards constant).
static __constant__ int kK2D[32] = {
    89, 241, 178, 38, 148, 155, 214, 235, 86, 177, 131, 130, 154, 20, 224, 0,
    48, 209, 243, 238, 242, 128, 142, 25, 231, 252, 223, 86, 220, 217, 6, 36};

// 8p spread over the limbs: [8*237, 8*255 x30, 8*127]; every limb
// dominates any weak limb, so a + bias - b never goes negative.
__device__ __forceinline__ int sub_bias(int lane) {
  return lane == 0 ? 8 * 237 : (lane == 31 ? 8 * 127 : 8 * 255);
}

// One parallel carry step: every limb keeps its low byte, its high bits
// move one limb up, and limb 31's carry wraps to limb 0 times 38
// (2^256 = 38 mod p).
__device__ __forceinline__ int carry_step(int x, int lane) {
  int from = __shfl_sync(kFullMask, x >> 8, (lane + 31) & 31);
  return (x & 0xFF) + (lane == 0 ? 38 * from : from);
}

__device__ __forceinline__ int f_add(int a, int b, int lane) {
  return carry_step(a + b, lane);
}

__device__ __forceinline__ int f_sub(int a, int b, int lane) {
  return carry_step(carry_step(a + sub_bias(lane) - b, lane), lane);
}

// The reference's neg: sub(0, a).
__device__ __forceinline__ int f_neg(int a, int lane) {
  return f_sub(0, a, lane);
}

// a * b mod p: lane j accumulates coefficient j (pairs k <= j) and
// coefficient j + 32 (pairs k > j, whose b index wraps), then folds the
// high one in times 38 and runs four parallel carry steps.
__device__ __forceinline__ int f_mul(int a, int b, int lane) {
  int lo = 0, hi = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    int p = __shfl_sync(kFullMask, a, k) *
            __shfl_sync(kFullMask, b, (lane - k) & 31);
    if (k <= lane) {
      lo += p;
    } else {
      hi += p;
    }
  }
  int x = lo + 38 * hi;
#pragma unroll
  for (int s = 0; s < 4; ++s) x = carry_step(x, lane);
  return x;
}

// A point is four coordinates, one limb per lane each: extended
// (X, Y, Z, T) or cached (Y+X, Y-X, Z, 2dT).
struct Pt {
  int c[4];
};

__device__ __forceinline__ Pt to_cached(const Pt& p, int lane) {
  Pt q;
  q.c[0] = f_add(p.c[1], p.c[0], lane);
  q.c[1] = f_sub(p.c[1], p.c[0], lane);
  q.c[2] = p.c[2];
  q.c[3] = f_mul(p.c[3], kK2D[lane], lane);
  return q;
}

// Complete unified addition, extended + cached -> extended (8 muls),
// op for op the reference's add_t.
__device__ __forceinline__ Pt add_cached(const Pt& p, const Pt& q, int lane) {
  int a = f_mul(f_sub(p.c[1], p.c[0], lane), q.c[1], lane);
  int b = f_mul(f_add(p.c[1], p.c[0], lane), q.c[0], lane);
  int c = f_mul(p.c[3], q.c[3], lane);
  int zz = f_mul(p.c[2], q.c[2], lane);
  int d = f_add(zz, zz, lane);
  int e = f_sub(b, a, lane);
  int f = f_sub(d, c, lane);
  int g = f_add(d, c, lane);
  int h = f_add(b, a, lane);
  Pt r;
  r.c[0] = f_mul(e, f, lane);
  r.c[1] = f_mul(g, h, lane);
  r.c[2] = f_mul(f, g, lane);
  r.c[3] = f_mul(e, h, lane);
  return r;
}

}  // namespace hk
