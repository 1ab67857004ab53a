// The provers' interaction (logup) columns of one AIR table, for Hopper
// (sm_90a), bound through a plain C interface (ops/build.py compiles this
// file with nvcc; ops/interaction_cuda.py loads it with ctypes).
//
// Replaces what XLA compiled on the TPU from
// recursive_stwo_tpu/prover/device_prove.py (`_InteractionEval` :277-331,
// `_interaction_traced` :342-352, jitted by `_interaction_cols_jit` :373 and
// `_stage_interaction_jit` :390): the verifier's AIR evaluators in
// generation mode over the row-order base trace.
//
// One thread a row j of the base trace.  `RowSrc` reads the table's
// preprocessed and trace rows at j as M31 masks (a QM31 mask is (v, 0, 0,
// 0)), as the domain kernel's `DomainSrc` does (composition.cu); the AIR
// (composition_air.cuh's evaluate_plonk, evaluate_poseidon or
// evaluate_plonk_np) runs with `Generate` as its sink, which takes each logup
// batch's fraction p / q (no constraint: the compiler drops their arithmetic,
// and the poseidon AIR skips its rounds).  The sink turns each batch into
// p * q^-1 (qm31.cuh's q_inv, with inv(0) = 0 as the reference's) and writes
// the running sum of the batches before the last as interaction rows 0 ..
// 4k - 1, and S, the sum of all of them, into the last four rows.  What
// needs every row, the total sum of S, the shift total / N and the inclusive
// prefix sum of S - shift that replaces the last four rows, is left to the
// wrapper (a handful of torch reductions, as the JAX package leaves its
// associative_scan to XLA).  Neighbouring threads read and write neighbouring
// entries of every row (coalesced).
//
// What bounds it on an H100: integer ALU work, the relations' QM31 products
// and each batch's inverse (an M31 inverse chain of 37 products a batch,
// two batches a table), against the bytes of the rows the relations read
// and the 8 rows written (ops/interaction_cuda.py counts both).

#include <cstdint>

#include <cuda_runtime.h>

#include "composition_air.cuh"

namespace {

using namespace composition;

constexpr int kThreads = 128;

enum Air { kPlonk = 0, kPoseidon = 1, kPlonkNp = 2 };

// Row j of a (rows, n) block at i * stride + j.
struct RowSrc {
  const int64_t* pre_rows;
  const int64_t* tr_rows;
  int64_t pre_stride, tr_stride, j;

  __device__ __forceinline__ Q pre(int i) const { return q_m31((uint32_t)pre_rows[i * pre_stride + j]); }
  __device__ __forceinline__ Q tr(int i) const { return q_m31((uint32_t)tr_rows[i * tr_stride + j]); }
};

// The generation sink: batch b's fraction p / q becomes p q^-1; the running
// sum of batches 0 .. b goes to rows 4b .. 4b + 3 for each batch but the
// last, whose running sum, S, goes to the last four rows.
struct Generate {
  static constexpr bool kGenerate = true;
  int64_t* out;
  int64_t stride, j;
  Q acc = Q{0u, 0u, 0u, 0u};

  __device__ __forceinline__ void batch(int b, Q p, Q q) {
    acc = q_add(acc, q_mul(p, q_inv(q)));
    int64_t* o = out + 4 * b * stride + j;
    o[0] = acc.a;
    o[stride] = acc.b;
    o[2 * stride] = acc.c;
    o[3 * stride] = acc.d;
  }
};

template <int AIR>
__global__ void __launch_bounds__(kThreads)
interaction_kernel(const int64_t* __restrict__ pre, int64_t pre_stride, const int64_t* __restrict__ tr,
                   int64_t tr_stride, int64_t* __restrict__ out, int64_t out_stride, int64_t n, Q z, Q alpha) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const RowSrc src{pre, tr, pre_stride, tr_stride, j};
  Generate sink{out, out_stride, j};
  const Q unused_shift = q_zero();  // the cumsum shift enters constraints only
  if constexpr (AIR == kPlonk) {
    evaluate_plonk(src, sink, z, alpha, unused_shift);
  } else if constexpr (AIR == kPoseidon) {
    evaluate_poseidon(src, sink, z, alpha, unused_shift);
  } else {
    evaluate_plonk_np(src, sink, z, alpha, unused_shift);
  }
}

template <int AIR>
int launch(const int64_t* pre, int64_t pre_stride, const int64_t* tr, int64_t tr_stride, int64_t* out,
           int64_t out_stride, int64_t n, Q z, Q alpha, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  interaction_kernel<AIR><<<blocks, kThreads, 0, s>>>(pre, pre_stride, tr, tr_stride, out, out_stride, n, z, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// air 0: plonk, 1: poseidon, 2: without-Poseidon.  pre, tr: (rows, n) int64
// row-order blocks of row strides pre_stride, tr_stride (unit stride along a
// row); out: (4 * batches, n) int64 of row stride out_stride, written; zalpha
// (host): z then alpha, four limbs each.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int interaction_columns(int air, const void* pre, int64_t pre_stride, const void* tr, int64_t tr_stride,
                                   void* out, int64_t out_stride, int64_t n, const int64_t* zalpha, void* stream) {
  if (n == 0) return 0;
  const Q z{(uint32_t)zalpha[0], (uint32_t)zalpha[1], (uint32_t)zalpha[2], (uint32_t)zalpha[3]};
  const Q alpha{(uint32_t)zalpha[4], (uint32_t)zalpha[5], (uint32_t)zalpha[6], (uint32_t)zalpha[7]};
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t *p = (const int64_t*)pre, *t = (const int64_t*)tr;
  int64_t* o = (int64_t*)out;
  if (air == kPlonk) return launch<kPlonk>(p, pre_stride, t, tr_stride, o, out_stride, n, z, alpha, s);
  if (air == kPoseidon) return launch<kPoseidon>(p, pre_stride, t, tr_stride, o, out_stride, n, z, alpha, s);
  if (air == kPlonkNp) return launch<kPlonkNp>(p, pre_stride, t, tr_stride, o, out_stride, n, z, alpha, s);
  return (int)cudaErrorInvalidValue;
}
