// The redesigned K1: field multiplies inside fused point chains.
//
// Replaces hotstuff_tpu/ops/kern/field_mul.py field_mul (Pallas body
// _field_mul_kernel) on the verify path.  On the TPU that kernel is one
// multiply inside a jitted program whose loops are lax.scans
// (hotstuff_tpu/ops/ed25519.py: the per-signature ladder :518/:548, the
// comb :530/:558, Horner :738, decompress_t :152).  Run from eager
// PyTorch, one launch per multiply cost ~3,000 launches per request and
// ten times as many glue kernels around them.  Here each loop is one
// launch that keeps the point in registers from the first step to the
// last:
//
//   point_ladder     acc <- [2^ndbl] acc + table[digit], S steps from the
//                    identity: the per-signature ladder (per-row 16-entry
//                    table, ndbl 4), both combs (the shared (32, 256)
//                    table, one table per step, ndbl 0) and Horner (one
//                    cached window sum per step, ndbl 4);
//   decompress       the whole of ed25519.decompress_t (x-recovery: the
//                    pow_p58 chain, the two equality tests, the sqrt(-1)
//                    fix-up, the sign flip), one row a lane group;
//   point_multiples  the 16-entry table 0P..15P, extended (msm_table,
//                    feeding K3) or cached (the ladder's table of -A).
//
// All three run on field25519_lanes.cuh's lane groups and keep the
// reference's op order and carry schedule, so the limbs equal the
// reference's limb for limb.
//
// point_ladder (field25519_lanes.cuh) runs a row on one warp, as four
// groups of 8 lanes: the groups run each formula phase's four independent
// multiplies at once (~10 multiplies a step on a row's critical path
// instead of 37), and a lane holds 4 limbs, so one shuffled word (two
// limbs) feeds several products (34 shuffles a multiply instead of 68).
// On the H100 (PERF.md) it is bound by instruction issue: a lane spends
// about two instructions a product (the unpacking, the x38 scale, the
// carries), one warp's stream at a few rows, the SMs' issue rate at 1024.
// Its tables (4 MB shared and 8 MB per-row at B = 1024) stay in device
// memory and L2; each step reads one 512-byte cached point a row.
//
// decompress (field25519_lanes.cuh) has no independent products to spread
// over groups, but many independent rows: one row a group of 8 lanes, four
// rows a warp, at every row count.  Its chain is 255 squarings and 20
// multiplies; the squaring forms 74 products a lane (mul(a, a)'s exact
// coefficients from the 528 distinct products, doubled and scaled where
// they wrap) against the multiply's 128, and the canonical forms walk
// their carries and borrows over the group's 8 lanes.  A lane issues ~180
// int32 instructions a squaring, so one warp a scheduler keeps the int32
// pipe busy: 2048 rows (512 warps) take about as long as 16, all resident
// at once (PERF.md has the registers, occupancy and times).
//
// point_multiples (field25519_lanes.cuh) is point_ladder's layout: one
// warp a row in four groups of 8 lanes, each of the 14 additions two mul4
// phases, group g storing coordinate g of each entry (one 512-byte store
// a warp), the cached form's 16 products T * 2d as four group-split
// products after the loop.  A row shuffles ~1,360 words (~1,500 cached),
// so at 2048 rows the shuffle bound is half the int32 one.  Like
// point_ladder it is bound by instruction issue: the SMs' rate at
// 1024-2048 rows, one warp's chain of 14 additions at a few rows.
#include <cuda_runtime.h>

#include "field25519.cuh"
#include "field25519_lanes.cuh"

namespace {

constexpr int kPt = 4 * 32;       // int32 values per point
constexpr int kEntries = 16;      // point_multiples: 0P .. 15P
constexpr int kThreads = 64;      // two warps per block

// d = -121665/121666 and sqrt(-1) mod p, canonical little-endian bytes.
__constant__ int kD[32] = {
    163, 120, 89, 19, 202, 77, 235, 117, 171, 216, 65, 65, 77, 10, 112, 0,
    152, 232, 121, 119, 121, 64, 199, 140, 115, 254, 111, 43, 238, 108, 3, 82};
__constant__ int kSqrtM1[32] = {
    176, 160, 14, 74, 39, 27, 238, 196, 120, 228, 47, 173, 6, 24, 67, 47,
    167, 215, 251, 61, 153, 0, 77, 43, 11, 223, 193, 79, 128, 36, 131, 43};

// One warp per row; rows * 32 threads in all.
__device__ __forceinline__ bool warp_row(long long rows, long long* row,
                                         int* lane) {
  *row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >>
         5;
  *lane = threadIdx.x & 31;
  return *row < rows;  // the whole warp leaves together
}

// point_ladder (field25519_lanes.cuh): one warp a row, two rows a block
// of 64 threads; one kernel per ndbl (0: the combs; 4: the per-signature
// ladder and Horner).
template <int kNdbl>
__global__ void point_ladder_kernel(const int* __restrict__ table,
                                    const int* __restrict__ digits,
                                    int* __restrict__ out, long long rows,
                                    int steps, int k, int per_row,
                                    int per_step) {
  long long row;
  int lane;
  if (!warp_row(rows, &row, &lane)) return;
  const hk::lanes::Lane ln{lane / hk::lanes::G, lane % hk::lanes::G};
  const long long table_stride = static_cast<long long>(
      per_step ? steps : 1) * k * kPt;
  hk::lanes::ladder_row<kNdbl>(
      table + (per_row ? row : 0) * table_stride, digits + row * steps,
      out + row * kPt, steps, k, per_step, ln);
}

// decompress (field25519_lanes.cuh): one row a group of 8 lanes, four rows
// a warp.  Rows not a multiple of 4: the last warp's idle groups
// recompute the last row (every lane takes part in the shuffles and
// ballots) and store nothing.
__global__ void decompress_groups_kernel(const int* __restrict__ y_limbs,
                                         const int* __restrict__ sign_bits,
                                         int* __restrict__ out,
                                         unsigned char* __restrict__ ok_out,
                                         long long rows) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / hk::lanes::G, l = lane % hk::lanes::G;
  const long long row = warp * hk::lanes::kRowsPerWarp + g;
  if (warp * hk::lanes::kRowsPerWarp >= rows) return;  // the whole warp
  const long long r = row < rows ? row : rows - 1;
  hk::lanes::decompress_row(y_limbs + r * 32, sign_bits[r], kD, kSqrtM1,
                            out + r * kPt, ok_out + r, row < rows, g, l);
}

// point_multiples (field25519_lanes.cuh): one warp a row, two rows a
// block of 64 threads; one kernel per output form (0 extended, 1 cached).
template <bool kCached>
__global__ void point_multiples_kernel(const int* __restrict__ pts,
                                       int* __restrict__ out,
                                       long long rows, int negate) {
  long long row;
  int lane;
  if (!warp_row(rows, &row, &lane)) return;
  const hk::lanes::Lane ln{lane / hk::lanes::G, lane % hk::lanes::G};
  hk::lanes::multiples_row<kCached>(pts + row * kPt,
                                    out + row * kEntries * kPt, negate != 0,
                                    hk::kK2D, ln);
}

unsigned blocks_for(long long rows) {
  return static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads);
}

}  // namespace

// table (Bt, J, k, 4, 32) with Bt = rows if per_row else 1 and J = steps
// if per_step else 1; digits (rows, steps) in [0, k); out (rows, 4, 32);
// ndbl 0 or 4.
extern "C" int hk_point_ladder(const int* table, const int* digits, int* out,
                               long long rows, int steps, int k, int per_row,
                               int per_step, int ndbl, void* stream) {
  if (ndbl != 0 && ndbl != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ndbl) {
      point_ladder_kernel<4><<<blocks_for(rows), kThreads, 0, s>>>(
          table, digits, out, rows, steps, k, per_row, per_step);
    } else {
      point_ladder_kernel<0><<<blocks_for(rows), kThreads, 0, s>>>(
          table, digits, out, rows, steps, k, per_row, per_step);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// y_limbs (rows, 32), sign_bits (rows,); out (rows, 4, 32), ok (rows,).
extern "C" int hk_decompress(const int* y_limbs, const int* sign_bits,
                             int* out, unsigned char* ok, long long rows,
                             void* stream) {
  if (rows > 0) {
    const long long warps = (rows + hk::lanes::kRowsPerWarp - 1) /
                            hk::lanes::kRowsPerWarp;
    decompress_groups_kernel<<<static_cast<unsigned>(
                                   (warps * 32 + kThreads - 1) / kThreads),
                               kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        y_limbs, sign_bits, out, ok, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// pts (rows, 4, 32) extended; out (rows, 16, 4, 32), cached form when
// cached != 0, built from -P when negate != 0.
extern "C" int hk_point_multiples(const int* pts, int* out, long long rows,
                                  int cached, int negate, void* stream) {
  if (rows > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cached) {
      point_multiples_kernel<true><<<blocks_for(rows), kThreads, 0, s>>>(
          pts, out, rows, negate);
    } else {
      point_multiples_kernel<false><<<blocks_for(rows), kThreads, 0, s>>>(
          pts, out, rows, negate);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
