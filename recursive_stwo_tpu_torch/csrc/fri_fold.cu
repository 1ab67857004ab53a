// The provers' FRI fold of one layer, for Hopper (sm_90a), bound through a
// plain C interface (ops/build.py compiles this file with nvcc;
// ops/fri_fold_cuda.py loads it with ctypes).
//
// Replaces what XLA compiled on the TPU from
// recursive_stwo_tpu/prover/device_prove.py `_fold_line_jit` (:572-589) and
// the fold half of `_join_commit_jit` (:593-623), and their streamed twins
// recursive_stwo_tpu/prover/stream.py `_join_fold_jit` (:667-701) and
// `_line_fold_jit` (:704-725).
//
// One launch takes a layer of 2^n points to the next layer's accumulator of
// 2^(n-1):
//   out = fold_line(g)                          (g alone)
//   out = fold_circle(join)                     (join alone: the first layer)
//   out = alpha^2 fold_line(g) + fold_circle(join)   (both)
// with fold(l, r, t) = (l + r) + alpha (l - r) t over the pair of positions
// (2i, 2i + 1): t = 1/x of the point of half_odds(n) at bit-reversed position
// 2i for a line fold (fri_host.line_fold_xinv), 1/y of the circle domain's
// point there for a circle fold (fri_host.circle_fold_yinv).  The line fold
// that ends layer i and the join of layer i + 1 share alpha_(i+1), so a proof
// folds in spec.n_inner_layers + 1 launches.
//
// One thread an output i.  Its point comes from two small tables, as the
// tile evaluation's do (prover/tiles.py): position 2i = j 2^b + r is the
// table point of r rotated by tile j's base point, one circle multiply
// (bx tx - by ty, bx ty + by tx); r is even, so a circle domain's point is
// never conjugated.  The wrapper picks b = ceil(n / 2), so both tables hold
// 2^(n/2) points or so and stay in L1 and L2.  The inverse is m31.cuh's
// addition chain, core/m31.py's, so inv(0) = 0 as in both packages.  A thread
// reads each limb row's pair as one 16-byte load and writes one word a limb
// row: neighbouring threads, neighbouring addresses.  Offsets are 64-bit (a
// last layer's first fold reads 4 x 2^27 words).
//
// What bounds it on an H100: bytes.  An output reads 64 bytes of g and 64 of
// the join and writes 32, against about 440 int32 operations a fold (the
// inverse's 37 products most of them) and 1,040 with both
// (ops/fri_fold_cuda.py counts both).

#include <cstdint>

#include <cuda_runtime.h>

#include "qm31.cuh"

namespace {

using namespace qm31;

constexpr int kThreads = 256;

// The coordinate of the point at bit-reversed position 2i that a fold
// divides by: x (kX) or y.  tab: [bx (tiles), by (tiles), tx (half), ty
// (half)], the tile bases and the table's even entries.
template <bool kX>
__device__ __forceinline__ uint32_t coordinate(const int64_t* __restrict__ tab, int64_t tiles, int64_t half,
                                               int64_t j, int64_t k) {
  const uint32_t bx = (uint32_t)tab[j], by = (uint32_t)tab[tiles + j];
  const uint32_t tx = (uint32_t)tab[2 * tiles + k], ty = (uint32_t)tab[2 * tiles + half + k];
  return kX ? sub(mul(bx, tx), mul(by, ty)) : add(mul(bx, ty), mul(by, tx));
}

// (l + r) + alpha (l - r) t of the pair (2i, 2i + 1) of four limb rows of
// length two_half.
__device__ __forceinline__ Q fold_pair(const int64_t* __restrict__ src, int64_t two_half, int64_t i, uint32_t t,
                                       Q alpha) {
  uint32_t l[4], r[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const longlong2 v = *reinterpret_cast<const longlong2*>(src + c * two_half + 2 * i);
    l[c] = (uint32_t)v.x;
    r[c] = (uint32_t)v.y;
  }
  const Q lq{l[0], l[1], l[2], l[3]}, rq{r[0], r[1], r[2], r[3]};
  return q_add(q_add(lq, rq), q_mul(q_mul_m31(q_sub(lq, rq), t), alpha));
}

template <bool kLine, bool kCircle>
__global__ void __launch_bounds__(kThreads)
fri_layer_kernel(const int64_t* __restrict__ g, const int64_t* __restrict__ join, int64_t* __restrict__ out,
                int64_t half, const int64_t* __restrict__ line_tab, const int64_t* __restrict__ circle_tab, int b,
                Q alpha, Q alpha2) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= half) return;
  const int64_t table = (int64_t)1 << (b - 1);  // the table's even entries
  const int64_t tiles = (2 * half) >> b;
  const int64_t j = i >> (b - 1), k = i & (table - 1);
  Q acc = q_zero();
  if constexpr (kLine) {
    acc = fold_pair(g, 2 * half, i, inv(coordinate<true>(line_tab, tiles, table, j, k)), alpha);
  }
  if constexpr (kCircle) {
    const Q f = fold_pair(join, 2 * half, i, inv(coordinate<false>(circle_tab, tiles, table, j, k)), alpha);
    if constexpr (kLine) {
      acc = q_add(q_mul(acc, alpha2), f);
    } else {
      acc = f;
    }
  }
  out[i] = acc.a;
  out[half + i] = acc.b;
  out[2 * half + i] = acc.c;
  out[3 * half + i] = acc.d;
}

template <bool kLine, bool kCircle>
int launch(const int64_t* g, const int64_t* join, int64_t* out, int64_t half, const int64_t* line_tab,
           const int64_t* circle_tab, int b, Q alpha, Q alpha2, cudaStream_t s) {
  const unsigned blocks = (unsigned)((half + kThreads - 1) / kThreads);
  fri_layer_kernel<kLine, kCircle><<<blocks, kThreads, 0, s>>>(g, join, out, half, line_tab, circle_tab, b, alpha,
                                                              alpha2);
  return (int)cudaGetLastError();
}

}  // namespace

// g, join: (4, 2^log_size) int64 limb rows, contiguous and 16-byte aligned,
// either null (not both); out: (4, 2^(log_size - 1)) int64, contiguous,
// written.  line_tab / circle_tab: the point tables of g's line domain and
// the join's circle domain (null where that input is), b the tile log (1 <=
// b <= log_size).  alphas (host): alpha then alpha^2, four limbs each.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int fri_fold_layer(const void* g, const void* join, void* out, int64_t log_size, const void* line_tab,
                              const void* circle_tab, int64_t b, const int64_t* alphas, void* stream) {
  if (log_size < 1 || b < 1 || b > log_size || (!g && !join)) return (int)cudaErrorInvalidValue;
  const Q alpha{(uint32_t)alphas[0], (uint32_t)alphas[1], (uint32_t)alphas[2], (uint32_t)alphas[3]};
  const Q alpha2{(uint32_t)alphas[4], (uint32_t)alphas[5], (uint32_t)alphas[6], (uint32_t)alphas[7]};
  const int64_t half = (int64_t)1 << (log_size - 1);
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t *gp = (const int64_t*)g, *jp = (const int64_t*)join;
  const int64_t *lt = (const int64_t*)line_tab, *ct = (const int64_t*)circle_tab;
  int64_t* o = (int64_t*)out;
  if (gp && jp) return launch<true, true>(gp, jp, o, half, lt, ct, (int)b, alpha, alpha2, s);
  if (gp) return launch<true, false>(gp, jp, o, half, lt, ct, (int)b, alpha, alpha2, s);
  return launch<false, true>(gp, jp, o, half, lt, ct, (int)b, alpha, alpha2, s);
}
