// K3: Straus MSM window sums.  For each of the 64 MSB-first 4-bit
// windows, select table[row, digit] for every row and reduce the B
// selected points by the reference's binary tree: at each level,
// pts[i] = pts[i] + cached(pts[i + m]) for i < m, m halving from B / 2.
//
// Replaces hotstuff_tpu/ops/kern/msm_accum.py msm_window_accum (Pallas
// body _msm_kernel).  Inputs: table (B, 16, 4, 32) int32 extended points
// (entry 0 the identity, so digit-0 and padded rows vanish exactly as in
// the reference), digits (B, 64) int32 in [0, 16), B a power of two.
// Output (64, 4, 32) int32 window sums, limb for limb the reference's.
// Extended coordinates are not unique, so the pairing order is part of
// the result: every node below is the reference's node, computed from
// the same two children by the same formulas.
//
// What bounds it on this card: ~(B - 1) * 64 point additions of 8 field
// multiplies each (~10^6 multiplies at B = 2048) over a 16.8 MB table;
// the integer work (and the shuffles under it), not the bytes, is the
// larger share.  The tree is cut in two grids, whatever B is:
//
//   grid 1 (only when B > M, M = the number of partial points per
//   window, at most 64): one warp per (window w, i < M) folds the 2^k
//   points {i + j M : j < 2^k}, k = log2(B / M), selected straight from
//   the table by digit.  The reference's first k levels pair x with
//   x + m for m >= M, which stays inside that strided set, so the warp
//   carries exactly those levels: node(j, h) = node(j, 2h) +
//   cached(node(j + h, 2h)) over the local index j, evaluated depth
//   first (leaves in bit-reversed order, a stack of at most k partial
//   points in shared memory), and writes node(0, 1) as partial i.
//   At B = 2048 that is 4,096 warps of 31 additions each.
//
//   grid 2: one block per window holds its M partial points (or, when
//   B <= M, the B selected points) in shared memory (M * 512 bytes,
//   32 KB at M = 64) and runs the remaining log2(M) levels, a warp per
//   pair and __syncthreads between levels, then writes the window sum.
//
// The previous design launched one grid per tree level (log2(B) grids,
// 11 at 2048 points) whose last levels ran 64 to a few hundred warps.
#include <cuda_runtime.h>

#include "field25519.cuh"

namespace {

constexpr int kWindows = 64;
constexpr int kPt = 4 * 32;            // int32 values per point
constexpr int kMaxPartials = 64;       // M: partial points per window
constexpr int kFoldWarps = 4;          // grid 1: warps per block
constexpr int kFinishWarps = 16;       // grid 2: warps per block at most

__device__ __forceinline__ hk::Pt load_selected(const int* table,
                                                const int* digits, int row,
                                                int w, int lane) {
  int d = digits[row * kWindows + w] & 15;
  const int* e = table + (static_cast<long long>(row) * 16 + d) * kPt;
  hk::Pt p;
#pragma unroll
  for (int c = 0; c < 4; ++c) p.c[c] = e[c * 32 + lane];
  return p;
}

__device__ __forceinline__ hk::Pt load_point(const int* base, int lane) {
  hk::Pt p;
#pragma unroll
  for (int c = 0; c < 4; ++c) p.c[c] = base[c * 32 + lane];
  return p;
}

__device__ __forceinline__ void store_point(int* base, const hk::Pt& p,
                                            int lane) {
#pragma unroll
  for (int c = 0; c < 4; ++c) base[c * 32 + lane] = p.c[c];
}

// Grid 1: warp (w, i) folds the strided set {i + j * m : j < 2^k} of
// window w into partials[w, i].  Leaf t of the depth-first walk is local
// index bitrev_k(t); after it, ctz(t + 1) merges each pop the left child
// and add the cached right child (the newer node), as the reference's
// pts[:m] + cached(pts[m:]).  Each lane reads back only the limbs it
// wrote, so the stack needs no warp synchronisation.
__global__ void __launch_bounds__(kFoldWarps * 32)
msm_fold_kernel(const int* __restrict__ table, const int* __restrict__ digits,
                int* __restrict__ partials, int m, int k) {
  extern __shared__ int stack_mem[];
  int lane = threadIdx.x & 31;
  int warp_in_block = threadIdx.x >> 5;
  int warp = blockIdx.x * kFoldWarps + warp_in_block;
  if (warp >= kWindows * m) return;
  int w = warp / m;
  int i = warp % m;
  int* stack = stack_mem + warp_in_block * k * kPt;
  int n = 1 << k;
  int sp = 0;
  hk::Pt acc;
  // Not unrolled: one copy of the node's code keeps the kernel's static
  // shuffle count equal to one tree node's (chip_smoke.py reads it).
#pragma unroll 1
  for (int t = 0; t < n; ++t) {
    int j = static_cast<int>(__brev(static_cast<unsigned>(t)) >> (32 - k));
    acc = load_selected(table, digits, i + j * m, w, lane);
#pragma unroll 1
    for (int merges = __ffs(t + 1) - 1; merges > 0; --merges) {
      --sp;
      hk::Pt left = load_point(stack + sp * kPt, lane);
      acc = hk::add_cached(left, hk::to_cached(acc, lane), lane);
    }
    if (t + 1 < n) {
      store_point(stack + sp * kPt, acc, lane);
      ++sp;
    }
  }
  store_point(partials + (static_cast<long long>(w) * m + i) * kPt, acc,
              lane);
}

// Grid 2: block w reduces window w's m points (partials[w], or the
// table's selection when partials is null) by the reference's tree.
__global__ void __launch_bounds__(kFinishWarps * 32, 1)
msm_finish_kernel(const int* __restrict__ table,
                  const int* __restrict__ digits,
                  const int* __restrict__ partials, int* __restrict__ out,
                  int m) {
  __shared__ int pts[kMaxPartials * kPt];
  int w = blockIdx.x;
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int warps = blockDim.x >> 5;
  for (int i = warp; i < m; i += warps) {
    hk::Pt p = partials == nullptr
                   ? load_selected(table, digits, i, w, lane)
                   : load_point(partials + (static_cast<long long>(w) * m +
                                            i) * kPt, lane);
    store_point(pts + i * kPt, p, lane);
  }
  __syncthreads();
  for (int h = m / 2; h >= 1; h /= 2) {
    for (int i = warp; i < h; i += warps) {
      hk::Pt q = load_point(pts + (i + h) * kPt, lane);
      hk::Pt p = load_point(pts + i * kPt, lane);
      store_point(pts + i * kPt, hk::add_cached(p, hk::to_cached(q, lane),
                                                lane), lane);
    }
    __syncthreads();
  }
  if (warp == 0) store_point(out + w * kPt, load_point(pts, lane), lane);
}

}  // namespace

// B >= 2 a power of two; m = min(B, 64) partial points per window, a
// power of two; partials holds 64 * m points when m < B (unused, may be
// null, when m == B); out (64, 4, 32).  Launches grid 1 only when
// m < B, then grid 2: the caller counts 1 + (m < B) launches.
extern "C" int hk_msm_window_accum(const int* table, const int* digits,
                                   int* partials, int* out, int b, int m,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 2 || m < 1 || m > kMaxPartials || m > b || (b & (b - 1)) ||
      (m & (m - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* src = nullptr;
  if (m < b) {
    int k = 0;
    while ((m << k) < b) ++k;
    unsigned blocks = static_cast<unsigned>(
        (kWindows * m + kFoldWarps - 1) / kFoldWarps);
    size_t smem = static_cast<size_t>(kFoldWarps) * k * kPt * sizeof(int);
    msm_fold_kernel<<<blocks, kFoldWarps * 32, smem, st>>>(table, digits,
                                                           partials, m, k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = partials;
  }
  int warps = m / 2 < 1 ? 1 : (m / 2 > kFinishWarps ? kFinishWarps : m / 2);
  msm_finish_kernel<<<kWindows, warps * 32, 0, st>>>(table, digits, src, out,
                                                      m);
  return static_cast<int>(cudaGetLastError());
}
