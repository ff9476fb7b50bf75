// K2 redesigned: the RLC program's scalar work mod L in two fused passes.
//
// Replaces, on the RLC path, hotstuff_tpu/ops/kern/scalar_mont.py
// scalar_mont_mul (Pallas body _mont_kernel) together with the byte
// ripples XLA fuses around it in hotstuff_tpu/ops/ed25519.py rlc_partials
// (:797-818) and scalar25519.py reduce_limbsum_mod_l (:206-220).  Run
// from eager PyTorch, those ripples were ~1,400 one-byte operators per
// RLC call around five launches of the Montgomery product.
//
//   rlc_scalars  per row: w = mul_mod_l(z, k), u = mul_mod_l(z, S) (two
//                Montgomery products each), present = any(z != 0), the
//                torsion lifts w + t_w L and z + t_z L, and the MSB-first
//                nibble digits of [w_lift; z_lift] in the (2B, 64) order
//                msm_window_sums takes;
//   rlc_reduce   per row of (32,) limb sums (limbs < 2^24): the 36-byte
//                carry, mont_mul(hi, R^2), mod_small(lo) and add_mod_l.
//
// Layout: one warp per row, lane i holding byte i, as K1 holds a field
// element.  A product's 32 x 32 schoolbook splits across the lanes as in
// hk::f_mul (lane j accumulates coefficients j and j + 32); carries and
// borrows are resolved across the warp: a few parallel carry steps bring
// every limb to <= 510 (so every remaining carry is 0 or 1), then one
// carry-lookahead from two ballots (generate: limb > 255; propagate: limb
// == 255) gives each lane its carry-in: cin = ((g | p) + g) ^ p, the
// carries of the integer sum (g | p) + g.  A conditional subtract is the
// same lookahead over borrows (generate: byte < modulus byte; propagate:
// equal), whose carry out of the top says x < modulus.
//
// Exactness.  Every ripple in this chain is an exact integer whose dropped
// top carry is zero: T = ab < 2^512 (64 bytes); U = T + mL < 2RL (64
// bytes); x + tL < 8L < 2^256 (32 bytes); the limb sum < 2^269 fits 36
// bytes; a + b < 2L for add_mod_l.  The one exception is m's truncation
// mod R, which is intended.  Canonical bytes of an exact value (or of
// the value mod 2^256 or 2^512) are unique, so any exact carry method --
// the reference's serial ripple or the lookahead here -- gives the same
// bytes, and the borrow chains of the conditional subtracts are exact
// too.  So the output equals the reference's byte for byte.
//
// What bounds it on this card: ~4 Montgomery products per row (~3,000
// int32 multiply-adds each, ~200 warp shuffles each in this layout); at
// the RLC path's 128 to 1024 rows that is well under a millisecond of
// any resource, so launch latency and one warp's dependent chain bound
// it.  The previous K2 ran one thread per row in 128-thread blocks (1024
// rows on 8 of the 132 SMs), three serial byte ripples each, and five
// launches per RLC call; here two rows per block spread the rows over
// the card and the ripples are a handful of warp-wide steps.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 2;   // rows per block

// L = 2^252 + 27742317777372353535851937790883648493, little-endian bytes,
// and its multiples and Montgomery constants at R = 2^256.
__constant__ int kL[32] = {237, 211, 245, 92, 26, 99, 18, 88, 214, 156, 247,
                           162, 222, 249, 222, 20, 0, 0, 0, 0, 0, 0,
                           0, 0, 0, 0, 0, 0, 0, 0, 0, 16};
// L' = -L^-1 mod R.
__constant__ int kLPrime[32] = {27, 126, 84, 18, 163, 29, 181, 210,
                                255, 132, 186, 253, 242, 6, 162, 177,
                                234, 107, 163, 255, 56, 84, 231, 20,
                                54, 24, 233, 111, 242, 198, 182, 157};
// R^2 mod L.
__constant__ int kR2[32] = {1, 15, 156, 68, 227, 17, 6, 164,
                            71, 147, 133, 104, 167, 27, 14, 208,
                            101, 190, 245, 23, 210, 115, 236, 206,
                            61, 154, 48, 124, 27, 65, 153, 3};
__constant__ int k2L[32] = {218, 167, 235, 185, 52, 198, 36, 176, 172, 57,
                            239, 69, 189, 243, 189, 41, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 32};
__constant__ int k4L[32] = {180, 79, 215, 115, 105, 140, 73, 96, 89, 115,
                            222, 139, 122, 231, 123, 83, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 64};
__constant__ int k8L[32] = {104, 159, 174, 231, 210, 24, 147, 192, 178, 230,
                            188, 23, 245, 206, 247, 166, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 128};

// The constants one lane holds: byte `lane` of each.
struct Consts {
  int l, lprime, r2;
};

__device__ __forceinline__ Consts load_consts(int lane) {
  return Consts{kL[lane], kLPrime[lane], kR2[lane]};
}

// Carry-in of each limb from the lookahead over generate and propagate
// masks (bit i: limb i); the carry out of the top is bit `width` of s.
__device__ __forceinline__ unsigned long long lookahead(
    unsigned long long g, unsigned long long p, unsigned long long* s) {
  *s = (g | p) + g;
  return *s ^ p;
}

// Exact carry of non-negative int32 limbs (lane i: limb i) into 32
// canonical bytes, mod 2^256.  Three parallel steps bring any limb below
// 2^31 to <= 384, then the lookahead resolves the 0/1 carries.
__device__ __forceinline__ int carry32(int x, int lane) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    int c = __shfl_up_sync(kFull, x >> 8, 1);
    x = (x & 0xFF) + (lane == 0 ? 0 : c);
  }
  unsigned g = __ballot_sync(kFull, x > 0xFF);
  unsigned p = __ballot_sync(kFull, x == 0xFF);
  unsigned long long s;
  unsigned cin = static_cast<unsigned>(lookahead(g, p, &s));
  return (x + static_cast<int>((cin >> lane) & 1u)) & 0xFF;
}

// The same over 64 limbs (lo: limbs 0..31, hi: limbs 32..63), mod 2^512.
__device__ __forceinline__ void carry64(int& lo, int& hi, int lane) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    int clo = lo >> 8, chi = hi >> 8;
    int top = __shfl_sync(kFull, clo, 31);
    int blo = __shfl_up_sync(kFull, clo, 1);
    int bhi = __shfl_up_sync(kFull, chi, 1);
    lo = (lo & 0xFF) + (lane == 0 ? 0 : blo);
    hi = (hi & 0xFF) + (lane == 0 ? top : bhi);
  }
  unsigned long long g =
      __ballot_sync(kFull, lo > 0xFF) |
      (static_cast<unsigned long long>(__ballot_sync(kFull, hi > 0xFF)) << 32);
  unsigned long long p =
      __ballot_sync(kFull, lo == 0xFF) |
      (static_cast<unsigned long long>(__ballot_sync(kFull, hi == 0xFF))
       << 32);
  unsigned long long s;
  unsigned long long cin = lookahead(g, p, &s);
  lo = (lo + static_cast<int>((cin >> lane) & 1ull)) & 0xFF;
  hi = (hi + static_cast<int>((cin >> (32 + lane)) & 1ull)) & 0xFF;
}

// x - m if x >= m else x, for canonical bytes x and m (lane i: byte i).
__device__ __forceinline__ int cond_sub(int x, int m, int lane) {
  int d = x - m;
  unsigned long long s;
  unsigned bin = static_cast<unsigned>(
      lookahead(__ballot_sync(kFull, d < 0), __ballot_sync(kFull, d == 0),
                &s));
  bool keep = (s >> 32) != 0;   // borrow out: x < m
  return keep ? x : (d - static_cast<int>((bin >> lane) & 1u)) & 0xFF;
}

// The 32 x 32 schoolbook a * b: lane j gets coefficient j in lo and
// coefficient j + 32 in hi (pairs whose b index wraps), each < 2^21.
__device__ __forceinline__ void schoolbook(int a, int b, int lane, int& lo,
                                           int& hi) {
  lo = 0;
  hi = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    int p = __shfl_sync(kFull, a, k) * __shfl_sync(kFull, b, (lane - k) & 31);
    if (k <= lane) {
      lo += p;
    } else {
      hi += p;
    }
  }
}

// a * b * R^-1 mod L for canonical bytes with a * b < R L: T = ab, m =
// (T mod R) L' mod R, U = T + mL, U / R, one conditional subtract of L --
// scalar25519.mont_mul's steps.
__device__ __forceinline__ int mont_mul(int a, int b, const Consts& c,
                                        int lane) {
  int t_lo, t_hi;
  schoolbook(a, b, lane, t_lo, t_hi);
  carry64(t_lo, t_hi, lane);
  // m: only coefficients 0..31 of (T mod R) * L' carry weight below R.
  int m = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    int p = __shfl_sync(kFull, t_lo, k) *
            __shfl_sync(kFull, c.lprime, (lane - k) & 31);
    if (k <= lane) m += p;
  }
  m = carry32(m, lane);
  int u_lo, u_hi;
  schoolbook(m, c.l, lane, u_lo, u_hi);
  u_lo += t_lo;
  u_hi += t_hi;
  carry64(u_lo, u_hi, lane);
  return cond_sub(u_hi, c.l, lane);
}

__device__ __forceinline__ int mul_mod_l(int a, int b, const Consts& c,
                                         int lane) {
  return mont_mul(mont_mul(a, b, c, lane), c.r2, c, lane);
}

// digits row: MSB-first nibbles of the 32 little-endian bytes; byte i
// lands at digits 2 (31 - i) (high nibble) and 2 (31 - i) + 1 (low).
__device__ __forceinline__ void store_nibbles(int* row, int byte, int lane) {
  int at = 2 * (31 - lane);
  row[at] = byte >> 4;
  row[at + 1] = byte & 15;
}

__global__ void __launch_bounds__(kWarps * 32)
rlc_scalars_kernel(const int* __restrict__ z, const int* __restrict__ k,
                   const int* __restrict__ s, int* __restrict__ digits,
                   int* __restrict__ u, long long rows) {
  long long r = static_cast<long long>(blockIdx.x) * kWarps +
                (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  if (r >= rows) return;
  Consts c = load_consts(lane);
  int zv = z[r * 32 + lane];
  int kv = k[r * 32 + lane];
  int sv = s[r * 32 + lane];
  int w = mul_mod_l(zv, kv, c, lane);
  u[r * 32 + lane] = mul_mod_l(zv, sv, c, lane);
  // Torsion-exact CRT lift (ed25519.rlc_partials): w' = w (mod L), w' = k
  // (mod 8); z' = z (mod L), z' = 1 (mod 8); excluded rows keep 0.  x & 7
  // is the floor residue mod 8 of a two's-complement x.
  bool present = __any_sync(kFull, zv != 0);
  int k0 = __shfl_sync(kFull, kv, 0);
  int w0 = __shfl_sync(kFull, w, 0);
  int z0 = __shfl_sync(kFull, zv, 0);
  int t_w = present ? (5 * ((k0 & 7) - (w0 & 7))) & 7 : 0;
  int t_z = present ? (5 * (1 - (z0 & 7))) & 7 : 0;
  store_nibbles(digits + r * 64, carry32(w + t_w * c.l, lane), lane);
  store_nibbles(digits + (rows + r) * 64, carry32(zv + t_z * c.l, lane),
                lane);
}

__global__ void __launch_bounds__(kWarps * 32)
rlc_reduce_kernel(const int* __restrict__ sums, int* __restrict__ out,
                  long long rows) {
  long long r = static_cast<long long>(blockIdx.x) * kWarps +
                (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  if (r >= rows) return;
  Consts c = load_consts(lane);
  // The limb sum as 36 bytes: lo = bytes 0..31, hi = bytes 32..35.
  int lo = sums[r * 32 + lane];
  int hi = 0;
  carry64(lo, hi, lane);
  if (lane >= 4) hi = 0;
  int hi_red = mont_mul(hi, c.r2, c, lane);    // hi * 2^256 mod L
  lo = cond_sub(lo, k8L[lane], lane);          // mod_small: lo < 16L
  lo = cond_sub(lo, k4L[lane], lane);
  lo = cond_sub(lo, k2L[lane], lane);
  lo = cond_sub(lo, c.l, lane);
  out[r * 32 + lane] = cond_sub(carry32(hi_red + lo, lane), c.l, lane);
}

unsigned blocks_for(long long rows) {
  return static_cast<unsigned>((rows + kWarps - 1) / kWarps);
}

}  // namespace

// z, k, s (rows, 32) canonical bytes; digits (2 rows, 64), u (rows, 32).
extern "C" int hk_rlc_scalars(const int* z, const int* k, const int* s,
                              int* digits, int* u, long long rows,
                              void* stream) {
  if (rows > 0) {
    rlc_scalars_kernel<<<blocks_for(rows), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(z, k, s, digits,
                                                              u, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// sums (rows, 32) int32 limb sums, limbs in [0, 2^24); out (rows, 32).
extern "C" int hk_rlc_reduce(const int* sums, int* out, long long rows,
                             void* stream) {
  if (rows > 0) {
    rlc_reduce_kernel<<<blocks_for(rows), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(sums, out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
