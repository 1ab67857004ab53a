// The provers' first-layer FRI quotients for Hopper (sm_90a), bound through
// a plain C interface (ops/build.py compiles this file with nvcc;
// ops/quotients_cuda.py loads it with ctypes): the OODS quotient
// ("FRI answer") of one first-layer group at every point of its
// commitment domain, or of a chunk of it.
//
// Replaces what XLA compiled on the TPU from recursive_stwo_tpu/prover/
// device_prove.py `_stage_quotients_jit` (:543-568) and its streamed twin
// prover/stream.py `_quot_chunk_jit` (:585-613): quotients.py
// `fri_answers_for_group` with the domain as its query axis.  The port's
// eager version (prover/quotients.py `group_answers_plain`, which runs
// verifier/quotients.py `fri_answers_for_group` over chunks of 2^18 points)
// is the plain version.
//
// What bounds it on an H100: device memory.  A point reads one int64 of
// each of the group's sampled columns (a column sampled at two points is
// read twice, from L1 or L2) and writes four; its arithmetic is one M31 x
// QM31 product and sum a sampled column and one CM31 inverse a sample batch
// (ops/quotients_cuda.py counts both).
//
// The design, two kernels a call on one stream:
//   1. one block computes what does not depend on the point, once a call,
//      with quotient.cuh's code (fold.cu's): alpha_k = -2u rc^k for the
//      group's k (a warp), each sample batch's shifted point, each sampled
//      column's line coefficient C and each batch's SA = sum of A and SB =
//      sum of B, into a scratch of words;
//   2. a thread a point: it stages C and the batches' values in shared
//      memory, then for each batch sums C val over its columns, read in
//      place from the tree blocks through a pointer and row table (the
//      reads of a warp are 32 consecutive points of one column), takes
//      (sum - (SA dy + SB)) times the inverse of the batch's CM31
//      denominator, and writes the (4, N) limbs.
// The point (dx, dy) comes from the domain's (x, y) tables (resident
// trees) or from the tile geometry of prover/tiles.py (streamed chunks: the
// tile's base point times the tile table, y negated at odd positions).
// Every value is a canonical residue and every step a field operation, so
// the results are the plain version's residues.  inv(0) = 0, as in the
// plain version.

#include <cstdint>

#include <cuda_runtime.h>

#include "quotient.cuh"

namespace {

using namespace qm31;
using quotient::load_q;

constexpr int kThreads = 256;       // the point kernel's block, a thread a point
constexpr int kCoeffThreads = 128;  // the coefficient kernel's one block
constexpr int kMaxEntries = 512;    // sampled columns of a group
constexpr int kMaxBatches = 16;     // sample batches of a group
constexpr int kMaxBlocks = 8;       // column blocks of a group
constexpr int64_t kMaxGridX = 1 << 20;

// Positions in the `scalars` array (ops/quotients_cuda.py writes it).
enum Scalar {
  kPoints = 0,  // N
  kEntries,     // sampled columns in walk order (the table's first rows)
  kBatches,     // sample batches (the table's rows after them)
  kBlocks,
  kPointMode,   // enum PointMode
  kTileLog,     // kTilePoints: b, points a tile 2^b
  kOutStride,   // the output's row stride, in elements
  kOods,        // the OODS point, x then y, eight limbs
  kRc = kOods + 8,                // the random coefficient, four limbs
  kBlockStride = kRc + 4,         // row stride of column block k, in elements
  kScalars = kBlockStride + kMaxBlocks,
};

// Positions in the `ptrs` array.
enum Ptr {
  kOut = 0,  // (4, N) int64 at kOutStride
  kTab,      // int32 rows of 4: each entry (block, row in the block, sample, batch), then each batch (first, n, cx, cy)
  kSamples,  // (S, 4) int64
  kScratch,  // 4 entries + 16 batches words: C of each entry, then px, py, SA, SB of each batch
  kX,        // kDomainPoints: (N,) x and y; kTilePoints: (N / 2^b,) base points
  kY,
  kTx,       // kTilePoints: (2^b,) tile table
  kTy,
  kBlock,    // column block k: (rows, >= N) int64 at its row stride
  kPtrs = kBlock + kMaxBlocks,
};

enum PointMode { kDomainPoints = 0, kTilePoints = 1 };

struct Args {
  int64_t n_points;
  int n_entries, n_batches, n_blocks, point_mode, tile_log;
  int64_t out_stride;
  uint32_t oods[8], rc[4];
  int64_t block_stride[kMaxBlocks];
  int64_t* out;
  const int32_t* tab;
  const int64_t* samples;
  uint32_t* scratch;
  const int64_t *x, *y, *tx, *ty;
  const int64_t* block[kMaxBlocks];

  __device__ __forceinline__ const int32_t* batch_row(int bt) const { return tab + 4 * (n_entries + bt); }
  __device__ __forceinline__ uint32_t* batch_words(int bt) const { return scratch + 4 * n_entries + 16 * bt; }
};

__device__ __forceinline__ Q words_q(const uint32_t* w) { return Q{w[0], w[1], w[2], w[3]}; }

__device__ __forceinline__ void put_q(uint32_t* w, Q v) {
  w[0] = v.a;
  w[1] = v.b;
  w[2] = v.c;
  w[3] = v.d;
}

// Kernel 1: the group's coefficients, by one block.
__global__ void __launch_bounds__(kCoeffThreads) quotient_coeffs_kernel(const __grid_constant__ Args a) {
  __shared__ Q alpha[kMaxEntries];
  __shared__ Q coef_a[kMaxEntries];
  __shared__ Q coef_b[kMaxEntries];
  __shared__ Q pxy[2 * kMaxBatches];
  const int t = threadIdx.x;
  const Q ox{a.oods[0], a.oods[1], a.oods[2], a.oods[3]}, oy{a.oods[4], a.oods[5], a.oods[6], a.oods[7]};
  if (t < 32) quotient::alpha_powers(Q{a.rc[0], a.rc[1], a.rc[2], a.rc[3]}, t, a.n_entries, alpha);
  for (int bt = t - 32; bt >= 0 && bt < a.n_batches; bt += kCoeffThreads - 32) {
    const int32_t* row = a.batch_row(bt);
    quotient::batch_point(ox, oy, (uint32_t)row[2], (uint32_t)row[3], pxy[2 * bt], pxy[2 * bt + 1]);
  }
  __syncthreads();
  for (int e = t; e < a.n_entries; e += kCoeffThreads) {
    const int32_t* row = a.tab + 4 * e;
    const quotient::LineCoeffs lc = quotient::line_coeffs(alpha[e], load_q(a.samples + 4 * (int64_t)row[2]), pxy[2 * row[3] + 1]);
    put_q(a.scratch + 4 * e, lc.c);
    coef_a[e] = lc.a;
    coef_b[e] = lc.b;
  }
  __syncthreads();
  for (int bt = t; bt < a.n_batches; bt += kCoeffThreads) {
    const int32_t* row = a.batch_row(bt);
    Q sa = q_zero(), sb = q_zero();
    for (int e = row[0]; e < row[0] + row[1]; ++e) {
      sa = q_add(sa, coef_a[e]);
      sb = q_add(sb, coef_b[e]);
    }
    uint32_t* w = a.batch_words(bt);
    put_q(w, pxy[2 * bt]);
    put_q(w + 4, pxy[2 * bt + 1]);
    put_q(w + 8, sa);
    put_q(w + 12, sb);
  }
}

__device__ __forceinline__ void point_at(const Args& a, int64_t p, uint32_t& dx, uint32_t& dy) {
  if (a.point_mode == kDomainPoints) {
    dx = (uint32_t)a.x[p];
    dy = (uint32_t)a.y[p];
    return;
  }
  const int64_t g = p >> a.tile_log, r = p & ((1ll << a.tile_log) - 1);
  const uint32_t bx = (uint32_t)a.x[g], by = (uint32_t)a.y[g], tx = (uint32_t)a.tx[r], ty = (uint32_t)a.ty[r];
  dx = sub(mul(bx, tx), mul(by, ty));
  dy = add(mul(bx, ty), mul(by, tx));
  if (r & 1) dy = neg(dy);
}

// Kernel 2: a thread a point.
__global__ void __launch_bounds__(kThreads) quotient_points_kernel(const __grid_constant__ Args a) {
  __shared__ Q ctab[kMaxEntries];
  __shared__ const int64_t* column[kMaxEntries];
  __shared__ Q batch[4 * kMaxBatches];  // px, py, SA, SB
  __shared__ int span[2 * kMaxBatches];  // first, n
  const int t = threadIdx.x;
  for (int e = t; e < a.n_entries; e += kThreads) {
    const int32_t* row = a.tab + 4 * e;
    ctab[e] = words_q(a.scratch + 4 * e);
    column[e] = a.block[row[0]] + row[1] * a.block_stride[row[0]];
  }
  for (int i = t; i < 4 * a.n_batches; i += kThreads) batch[i] = words_q(a.batch_words(i >> 2) + 4 * (i & 3));
  for (int i = t; i < 2 * a.n_batches; i += kThreads) span[i] = a.batch_row(i >> 1)[i & 1];
  __syncthreads();

  for (int64_t p = (int64_t)blockIdx.x * kThreads + t; p < a.n_points; p += (int64_t)gridDim.x * kThreads) {
    uint32_t dx, dy;
    point_at(a, p, dx, dy);
    Q acc = q_zero();
    for (int bt = 0; bt < a.n_batches; ++bt) {
      const int first = span[2 * bt], last = first + span[2 * bt + 1];
      Q part = q_zero();
#pragma unroll 4
      for (int e = first; e < last; ++e) part = q_add(part, q_mul_m31(ctab[e], (uint32_t)column[e][p]));
      const Q num = q_sub(part, q_add(q_mul_m31(batch[4 * bt + 2], dy), batch[4 * bt + 3]));
      acc = q_add(acc, q_mul_cm31(num, c_inv(quotient::denominator(batch[4 * bt], batch[4 * bt + 1], dx, dy))));
    }
    a.out[p] = acc.a;
    a.out[a.out_stride + p] = acc.b;
    a.out[2 * a.out_stride + p] = acc.c;
    a.out[3 * a.out_stride + p] = acc.d;
  }
}

}  // namespace

// scalars: kScalars int64 (the Scalar positions above); ptrs: kPtrs device
// pointers (unused entries 0).  Launches the coefficient kernel and the
// point kernel on `stream` and returns the first launch's error, or
// cudaErrorInvalidValue for a shape past the kernels' limits.
extern "C" int quotients_group(const int64_t* scalars, const int64_t* ptrs, void* stream) {
  Args a{};
  a.n_points = scalars[kPoints];
  a.n_entries = (int)scalars[kEntries];
  a.n_batches = (int)scalars[kBatches];
  a.n_blocks = (int)scalars[kBlocks];
  a.point_mode = (int)scalars[kPointMode];
  a.tile_log = (int)scalars[kTileLog];
  a.out_stride = scalars[kOutStride];
  if (a.n_points < 0 || a.n_entries < 1 || a.n_entries > kMaxEntries || a.n_batches < 1 ||
      a.n_batches > kMaxBatches || a.n_blocks < 1 || a.n_blocks > kMaxBlocks ||
      (a.point_mode != kDomainPoints && a.point_mode != kTilePoints) || a.tile_log < 0 || a.tile_log > 30 ||
      a.out_stride < a.n_points) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 8; ++i) a.oods[i] = (uint32_t)scalars[kOods + i];
  for (int i = 0; i < 4; ++i) a.rc[i] = (uint32_t)scalars[kRc + i];
  for (int k = 0; k < kMaxBlocks; ++k) {
    a.block_stride[k] = scalars[kBlockStride + k];
    a.block[k] = (const int64_t*)ptrs[kBlock + k];
  }
  a.out = (int64_t*)ptrs[kOut];
  a.tab = (const int32_t*)ptrs[kTab];
  a.samples = (const int64_t*)ptrs[kSamples];
  a.scratch = (uint32_t*)ptrs[kScratch];
  a.x = (const int64_t*)ptrs[kX];
  a.y = (const int64_t*)ptrs[kY];
  a.tx = (const int64_t*)ptrs[kTx];
  a.ty = (const int64_t*)ptrs[kTy];
  if (a.n_points == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  quotient_coeffs_kernel<<<1, kCoeffThreads, 0, s>>>(a);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  int64_t blocks = (a.n_points + kThreads - 1) / kThreads;
  if (blocks > kMaxGridX) blocks = kMaxGridX;
  quotient_points_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
