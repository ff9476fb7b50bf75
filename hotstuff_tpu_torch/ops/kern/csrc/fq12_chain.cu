// The BLS12-381 pairing check's Fq12 chains, one launch per chain.
//
// No TPU kernel stands behind these: the JAX package runs the whole
// check as one XLA program (hotstuff_tpu/ops/bls381.py:217
// pairings_check_jit), fusing ~2,000 Fq12 products.  Eager PyTorch
// dispatches every operator from the host, ~200 per plain fq12_mul, so
// the card path needs the loops fused:
//
//   fq12_mul           one Fq12 product per row (bls381.fq12_mul): the
//                      products outside the loops;
//   fq12_pow           x^e over Fq12 by the 4-bit windowed loop of
//                      field381.pow_windowed (table one, x, x^2, ..., 16
//                      entries in shared memory; four squarings and one
//                      table product per digit, digit 0 included):
//                      bls381.fq12_pow_const, off the check's path since
//                      fq12_tower.cu's fq12_hard_pow took the final
//                      exponentiation's hard part (which, with the Miller
//                      accumulation, runs on the word tower there);
//   fq_pow             the same loop over Fq (field381.inv, e = q - 2),
//                      on an input first multiplied by the Montgomery one
//                      when its top limb is kStableTop or more (see
//                      fq12_chain.py STABLE_TOP: the squarings of a value
//                      near 2^385 grow without bound).
//
// Layout: one block per row.  An Fq12 product runs as bls381.fq12_mul
// does, in pieces separated by barriers: 144 threads each compute one
// coefficient product x_i y_j as a whole Montgomery product in registers
// (field381.cuh, one thread per element); the block sums the 23
// anti-diagonals limb by limb; 23 threads reduce_sum them; 6 threads
// run the six independent chains of the w^12 = 2w^6 - 2 fold; 12
// threads reduce_sum the result.  Operands, products and coefficients
// stay in shared memory, so a chain reads its inputs from device memory
// once and writes its result once.  fq_pow runs one row per thread.
//
// What bounds it: int32 operations.  A Montgomery product is ~5,800
// multiply-adds and ~2,300 carry operations, so an Fq12 product is ~1.2
// M int32 operations; an SM retires 64 a clock, so on one SM a product
// needs >= ~9 us, and fq12_pow's ~1,600 dependent products at the hard
// exponent >= ~15 ms at batch 1, whatever the layout inside the SM.
// This layout keeps 144 threads (4.5 warps) busy for the products, so
// one of the SM's four schedulers issues two warps' work; the serial
// reduce and fold pieces add to that.  fq12_tower.cu cuts the
// arithmetic itself (32-bit words, the Fq12 tower); moving fq12_mul and
// fq_pow onto it is later work.
#include <cuda_runtime.h>

#include <atomic>

#include "field381.cuh"

namespace {

constexpr int kThreads = 160;                 // 144 products, 5 warps
constexpr int kLimbs = fq::kLimbs;
constexpr int kFq12 = fq::kFq12;
constexpr int kTable = 16;                    // 4-bit window
constexpr int kStableTop = 224;               // fq12_chain.STABLE_TOP

// Shared scratch of one block's Fq12 product.
struct Scratch {
  int* prod;   // 144 x 48
  int* coef;   // 23 x 48
};

// out = x * y for the block's Fq12 operands in shared memory; every
// thread of the block calls it.  out may alias x or y: they are read
// only before the first barrier.
__device__ void fq12_mul_block(const int* x, const int* y, int* out,
                               const Scratch& s) {
  const int tid = threadIdx.x;
  if (tid < fq::kProducts) fq::fq12_product(x, y, s.prod, tid);
  __syncthreads();
  for (int u = tid; u < fq::kDiagonals * kLimbs; u += blockDim.x) {
    fq::fq12_diagonal(s.prod, s.coef, u);
  }
  __syncthreads();
  if (tid < fq::kDiagonals) {
    fq::reduce_sum(s.coef + tid * kLimbs, s.coef + tid * kLimbs);
  }
  __syncthreads();
  if (tid < 6) fq::fq12_fold(s.coef, tid);
  __syncthreads();
  if (tid < 12) fq::reduce_sum(s.coef + tid * kLimbs, out + tid * kLimbs);
  __syncthreads();
}

__device__ void copy_block(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// The Montgomery Fq12 one: coefficient 0 is 2^384 mod q.
__device__ void one_block(int* dst) {
  for (int i = threadIdx.x; i < kFq12; i += blockDim.x) {
    dst[i] = i < kLimbs ? fq::kRModQ[i] : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
fq12_mul_kernel(const int* __restrict__ x, const int* __restrict__ y,
                int* __restrict__ out) {
  __shared__ int sx[kFq12], sy[kFq12], sprod[fq::kProducts * kLimbs],
      scoef[fq::kDiagonals * kLimbs];
  const long long row = blockIdx.x;
  copy_block(sx, x + row * kFq12, kFq12);
  copy_block(sy, y + row * kFq12, kFq12);
  __syncthreads();
  fq12_mul_block(sx, sy, sx, Scratch{sprod, scoef});
  copy_block(out + row * kFq12, sx, kFq12);
}

// Dynamic shared memory: the 16-entry table, the accumulator, scratch.
constexpr int kPowSmemInts =
    kTable * kFq12 + kFq12 + (fq::kProducts + fq::kDiagonals) * kLimbs;

__global__ void __launch_bounds__(kThreads)
fq12_pow_kernel(const int* __restrict__ x, const int* __restrict__ digits,
                int* __restrict__ out, int ndigits) {
  extern __shared__ int smem[];
  int* table = smem;
  int* acc = table + kTable * kFq12;
  const Scratch s{acc + kFq12, acc + kFq12 + fq::kProducts * kLimbs};
  const long long row = blockIdx.x;
  one_block(table);
  copy_block(table + kFq12, x + row * kFq12, kFq12);
  one_block(acc);
  __syncthreads();
#pragma unroll 1
  for (int e = 2; e < kTable; ++e) {
    fq12_mul_block(table + (e - 1) * kFq12, table + kFq12, table + e * kFq12,
                   s);
  }
#pragma unroll 1
  for (int i = 0; i < ndigits; ++i) {
#pragma unroll 1
    for (int sq = 0; sq < 4; ++sq) fq12_mul_block(acc, acc, acc, s);
    // Digits are in [0, 16) by construction; clamping keeps a bad one
    // inside the table.
    const int d = min(max(digits[i], 0), kTable - 1);
    fq12_mul_block(acc, table + d * kFq12, acc, s);
  }
  copy_block(out + row * kFq12, acc, kFq12);
}

__global__ void __launch_bounds__(32)
fq_pow_kernel(const int* __restrict__ x, const int* __restrict__ digits,
              int* __restrict__ out, long long rows, int ndigits) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (row >= rows) return;
  int table[kTable][kLimbs];
  int acc[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    table[0][i] = fq::kRModQ[i];
    table[1][i] = x[row * kLimbs + i];
    acc[i] = fq::kRModQ[i];
  }
  if (table[1][kLimbs - 1] >= kStableTop) {
    fq::mont_mul(table[1], table[0], table[1]);
  }
#pragma unroll 1
  for (int e = 2; e < kTable; ++e) {
    fq::mont_mul(table[e - 1], table[1], table[e]);
  }
#pragma unroll 1
  for (int i = 0; i < ndigits; ++i) {
#pragma unroll 1
    for (int sq = 0; sq < 4; ++sq) fq::mont_mul(acc, acc, acc);
    const int d = min(max(digits[i], 0), kTable - 1);
    fq::mont_mul(acc, table[d], acc);
  }
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) out[row * kLimbs + i] = acc[i];
}

}  // namespace

// x, y, out (rows, 12, 48).
extern "C" int hk_fq12_mul(const int* x, const int* y, int* out,
                           long long rows, void* stream) {
  if (rows > 0) {
    fq12_mul_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, y, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out (rows, 12, 48); digits (ndigits,) in [0, 16), most significant
// first.
extern "C" int hk_fq12_pow(const int* x, const int* digits, int* out,
                           long long rows, int ndigits, void* stream) {
  const int bytes = kPowSmemInts * static_cast<int>(sizeof(int));
  // Above 48 KB of dynamic shared memory needs the opt-in, which
  // cudaFuncSetAttribute gives the current device only: once per device
  // (so never inside a CUDA graph capture after a device's first call).
  // A call on a device past kMaxDevices opts in every time.
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !opted_in[device].load()) {
    err = cudaFuncSetAttribute(
        fq12_pow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) opted_in[device].store(true);
  }
  if (rows > 0) {
    fq12_pow_kernel<<<static_cast<unsigned>(rows), kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(x, digits, out,
                                                           ndigits);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out (rows, 48); digits as for hk_fq12_pow.
extern "C" int hk_fq_pow(const int* x, const int* digits, int* out,
                         long long rows, int ndigits, void* stream) {
  constexpr int kRowsPerBlock = 32;   // the kernel's launch bound
  if (rows > 0) {
    fq_pow_kernel<<<static_cast<unsigned>((rows + kRowsPerBlock - 1) /
                                          kRowsPerBlock),
                    kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        x, digits, out, rows, ndigits);
  }
  return static_cast<int>(cudaGetLastError());
}
