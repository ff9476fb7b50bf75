// The BLS12-381 check on the Fq12 tower of fq12w.cuh, over the
// 32-bit-word Montgomery field of fq381w.cuh, in two launches:
// miller_accumulate, then final_exp (on a mesh, fq12_product between
// them on each shard).
//
//   final_exp          the product of a check's P Miller values, raised
//                      to (q^12 - 1) / r, and whether that is one (the
//                      verdict): P - 1 products, the easy part with the
//                      inverse taken down the tower to one Fq inversion
//                      (a binary extended Euclid, fq381w.cuh), then the
//                      hard part's chain below, all in one block, on
//                      fq12_lanes.cuh's split step;
//   fq12_hard_pow      f^((q^4 - q^2 + 1) / r) for f in the cyclotomic
//                      subgroup (bls381.final_exponentiate's hard part),
//                      as the exact chain in x = -BLS_X: a 126-bit
//                      windowed power, three powers by |x|, two Frobenius
//                      maps and two conjugations (~315 cyclotomic
//                      squares, ~60 products) where the generic fq12_pow
//                      runs 1,604 flat products; final_exp's chain alone;
//   fq12_product       the product of n flat values, final_exp's first
//                      stage alone: one block, a dependent chain of
//                      n - 1 Karatsuba products on fq12w.cuh's step;
//   miller_accumulate  all S steps of f <- f^2 l0 l1 from f = 1 for one
//                      pairing per row (bls381.miller_accumulate), each
//                      line skipped when it equals one (58 of a pairing's
//                      63 addition lines) and taken by the sparse product
//                      when its zero pattern allows (every real line), on
//                      fq12w.cuh's step.
//
// No TPU kernel stands behind these: the JAX package runs the whole check
// as one XLA program (hotstuff_tpu/ops/bls381.py:217 pairings_check_jit).
// They replace fq12_chain.cu's flat-polynomial versions (fq12_pow stays
// for bls381.fq12_pow_const, fq12_mul and fq_pow for bls381.fq12_mul and
// fq12_inv; miller_accumulate moved here; final_exp took the check's
// product, fq12_inv, easy part and is_one off them).
//
// Layout: one block per row, everything in shared memory; inputs are
// read once from device memory and outputs written once, as canonical
// limbs.  What bounds them is the dependent chain of tower steps on one
// SM, so the chain's length, not the card's throughput, sets the time.
// miller_accumulate and fq12_product: 160 threads, fq12w.cuh's five
// short stages a step, the longest its independent Montgomery products
// (one per thread, 36-54 threads).  final_exp and fq12_hard_pow: 224
// threads, fq12_lanes.cuh's two stages a step, each Montgomery product
// on a group of four lanes (3 words a lane), the hard part's squarings
// cyclotomic (18 products, 72 threads); the easy part's inverse and the
// Frobenius maps stay on fq12w.cuh's step.  The design cuts the chain:
// 32-bit-word products instead of the TPU's 8-bit limbs, Karatsuba /
// complex and cyclotomic squaring / sparse lines instead of the
// 144-product flat schoolbook, the x-chain instead of a 1,268-bit
// exponent, and a product split over lanes instead of one thread's
// 12-word chain.
#include <cuda_runtime.h>

#include "fq12_lanes.cuh"

namespace {

constexpr int kThreads = 160;       // the 144 output columns, 5 warps
constexpr int kPowThreads = tl::kThreads;     // 54 products x 4 lanes
constexpr int kWords = fqw::kWords;
constexpr int kFq12 = tw::kFq12;
constexpr int kTable = 15;          // base^1 .. base^15
constexpr int kConsts = 24 * kWords;          // Frobenius constants
constexpr int kProgCapacity = 3584;           // ints of the table

// The block's shared scratch, and the table copied into shared memory
// (its terms are read by every thread of every stage).
struct Shared {
  __align__(16) uint32_t scratch[tw::kScratchWords];
  uint64_t cols[12 * kWords];
  int prog[kProgCapacity];
};

__device__ void load_prog(Shared& sh, const int* prog, int len) {
  tw::tasks(len, [&](int i) { sh.prog[i] = prog[i]; });
}

// The shared memory of the two power kernels: the block's scratch and
// table, the hard part's buffers and the Frobenius constants, and the
// Scratch and HardBuffers that point into them (the chains take those by
// reference: here they need no thread's stack).
struct PowShared {
  Shared sh;
  __align__(16) uint32_t buf[5 * kFq12 + kTable * kFq12];
  __align__(16) uint32_t consts[kConsts];
  tw::Scratch s;
  tl::HardBuffers h;
};

__device__ void load_pow(PowShared& p, const int* prog, int prog_len,
                         const uint32_t* consts) {
  load_prog(p.sh, prog, prog_len);
  tw::tasks(kConsts, [&](int i) { p.consts[i] = consts[i]; });
  tw::tasks(1, [&](int) {
    uint32_t* b = p.buf;
    p.h = tl::HardBuffers{b, b + kFq12, b + 2 * kFq12, b + 3 * kFq12,
                          b + 4 * kFq12, b + 5 * kFq12};
    p.s = tw::make_scratch(p.sh.scratch, p.sh.cols);
  });
}

__global__ void __launch_bounds__(kPowThreads, 1)
fq12_hard_pow_kernel(const int* __restrict__ x, const int* __restrict__ prog,
                     int prog_len, const uint32_t* __restrict__ consts,
                     const int* __restrict__ d1, int n1,
                     const int* __restrict__ dx, int nx,
                     int* __restrict__ out) {
  __shared__ PowShared p;
  const long long row = blockIdx.x;
  load_pow(p, prog, prog_len, consts);
  tl::hard_pow_row(p.sh.prog, p.consts, d1, n1, dx, nx,
                   x + row * tw::kFlatInts, out + row * tw::kFlatInts, p.h,
                   p.s);
}

__global__ void __launch_bounds__(kPowThreads, 1)
final_exp_kernel(const int* __restrict__ x, int n,
                 const int* __restrict__ prog, int prog_len,
                 const uint32_t* __restrict__ consts,
                 const int* __restrict__ d1, int n1,
                 const int* __restrict__ dx, int nx, int* __restrict__ out,
                 int* __restrict__ ok) {
  __shared__ PowShared p;
  const long long row = blockIdx.x;
  load_pow(p, prog, prog_len, consts);
  tl::final_exp_row(p.sh.prog, p.consts, d1, n1, dx, nx,
                    x + row * n * tw::kFlatInts, n, out + row * tw::kFlatInts,
                    ok + row, p.h, p.s);
}

__global__ void __launch_bounds__(kThreads)
miller_accumulate_kernel(const int* __restrict__ lines,
                         const int* __restrict__ prog, int prog_len,
                         int* __restrict__ out, int steps) {
  __shared__ Shared sh;
  __shared__ __align__(16) uint32_t sf[kFq12], sl[2 * kFq12];
  __shared__ __align__(16) int sstage[4 * tw::kFlatInts];
  const long long row = blockIdx.x;
  load_prog(sh, prog, prog_len);
  tw::miller_row(sh.prog, lines + row * steps * 2 * tw::kFlatInts, steps,
                 out + row * tw::kFlatInts, sf, sl, sstage, tw::make_scratch(sh.scratch, sh.cols));
}

// The product of n flat values in one block: the product stage of
// final_exp alone (a mesh shard folds its Miller values with it before
// one element crosses to the lead).
struct ProductShared {
  Shared sh;
  __align__(16) uint32_t f[kFq12];
  __align__(16) uint32_t table[tw::kProductChunk * kFq12];
};

__global__ void __launch_bounds__(kThreads)
fq12_product_kernel(const int* __restrict__ x, int n,
                    const int* __restrict__ prog, int prog_len,
                    int* __restrict__ out) {
  __shared__ ProductShared p;
  load_prog(p.sh, prog, prog_len);
  const tw::Scratch s = tw::make_scratch(p.sh.scratch, p.sh.cols);
  tw::product_tower(p.sh.prog, x, n, p.f, p.table, s);
  tw::tower_to_flat(p.f, out);
}

}  // namespace

// x (n, 12, 48), n >= 1; prog as below; out (12, 48) the canonical limbs
// of x_0 ... x_(n-1).
extern "C" int hk_fq12_product(const int* x, int n, const int* prog,
                               int prog_len, int* out, void* stream) {
  if (prog_len > kProgCapacity || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fq12_product_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, prog, prog_len, out);
  return static_cast<int>(cudaGetLastError());
}

// x, out (rows, 12, 48); prog (prog_len,) the table of fq12_tower.py;
// consts the 24 Frobenius constants as (24, 12) words; d1 (n1,) the
// base-16 digits of (x - 1)^2 / 3 and dx (nx,) the bits of |x|, most
// significant first.
extern "C" int hk_fq12_hard_pow(const int* x, const int* prog, int prog_len,
                                const int* consts, const int* d1, int n1,
                                const int* dx, int nx, int* out,
                                long long rows, void* stream) {
  if (prog_len > kProgCapacity) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    fq12_hard_pow_kernel<<<static_cast<unsigned>(rows), kPowThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        x, prog, prog_len, reinterpret_cast<const uint32_t*>(consts), d1, n1,
        dx, nx, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (rows, n, 12, 48), n >= 1: each row's n Miller values; the other
// inputs as for hk_fq12_hard_pow; out (rows, 12, 48) the product's final
// exponentiation, ok (rows,) 1 where it is one, else 0.
extern "C" int hk_final_exp(const int* x, int n, const int* prog,
                            int prog_len, const int* consts, const int* d1,
                            int n1, const int* dx, int nx, int* out, int* ok,
                            long long rows, void* stream) {
  if (prog_len > kProgCapacity || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    final_exp_kernel<<<static_cast<unsigned>(rows), kPowThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        x, n, prog, prog_len, reinterpret_cast<const uint32_t*>(consts), d1,
        n1, dx, nx, out, ok);
  }
  return static_cast<int>(cudaGetLastError());
}

// lines (rows, steps, 2, 12, 48), 16-byte aligned; prog as above; out
// (rows, 12, 48).
extern "C" int hk_miller_accumulate(const int* lines, const int* prog,
                                    int prog_len, int* out, long long rows,
                                    int steps, void* stream) {
  if (prog_len > kProgCapacity) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    miller_accumulate_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        lines, prog, prog_len, out, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
