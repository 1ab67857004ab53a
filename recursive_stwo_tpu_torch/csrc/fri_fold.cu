// The provers' FRI fold of one layer, and the last layer's interpolation and
// degree check, for Hopper (sm_90a), bound through a plain C interface
// (ops/build.py compiles this file with nvcc; ops/fri_fold_cuda.py loads it
// with ctypes).  The last layer is at the end of the file.
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

#include <cooperative_groups.h>
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

// ---------------------------------------------------------------------------
// The last layer.
//
// Replaces no TPU kernel: the JAX package interpolates the last layer on the
// host (recursive_stwo_tpu/prover/fri.py `line_interpolate`, copied as
// prover/fri_host.py), after copying the folded layer back.  Here it stays on
// the card, and only the kept coefficients and a count come back.
//
// The layer is four M31 columns of 2^n (the twiddles are M31, so the QM31
// limbs never mix).  Round L (0 <= L < n) takes each pair of positions
// (p, p + 2^L) with bit L of p clear to
//   (a + b, (a - b) t),   t = tw[2^n - 2^(n-L) + (p >> (L + 1))],
// the round's inverse x of half_odds(n - L) (prover/fri_last.py `twiddles`,
// inv(0) = 0 as the host's m31.inv gives it).  The copy halves both outputs
// every round; field arithmetic is exact, so one product by 2^-n at the end
// gives the same residues.  After round n - 1 coefficient p of the layered
// order is coefficient br_n(p) of the verifier's basis: the kept positions
// j << (n - bound) of the copy are p = br_bound(j) < 2^bound, and every
// other coefficient has to be zero.
//
// One thread block cluster a column, of C = min(8, 2^(n - 13)) blocks, in
// two phases a block, with the cluster's barrier between them:
//   1. rounds 0 .. k1 - 1 (k1 = min(n, 13)) on contiguous slabs of 2^k1
//      words in shared memory: slab s of the column read from g, written to
//      a uint32 scratch column (the rounds pair positions within a slab);
//   2. rounds k1 .. n - 1 on tiles of 2^k2 rows (k2 = n - k1 <= 10) of W =
//      2^(13 - k2) scratch columns: positions h 2^k1 + w0 + w, read in runs
//      of W >= 8 words (a 32-byte sector or more); then the product by
//      2^-n, each kept coefficient written to its row br_bound(p) of the
//      output, and every other nonzero counted.
// Rank 0 zeroes the column's count word, after the output rows, before the
// cluster's barrier; each thread adds its count to it after.
//
// What bounds it on an H100: nothing the card is short of.  The layer is
// 4 x 2^n int64 read once (2 MiB at n = 16) and n 2^(n-1) butterflies a
// column; a block's rounds in shared memory, the scratch column in L2.  The
// time is a launch and n dependent rounds of a block barrier each.

namespace {

namespace cg = cooperative_groups;

constexpr int kLastThreads = 512;
constexpr int kSlabLog = 13;       // words of a block's slab or tile (32 KiB)
constexpr int kMaxRowLog = 10;     // phase 2's rows: tiles of at least 8 columns
constexpr int kMaxLastLog = kSlabLog + kMaxRowLog;
constexpr int kMaxClusterLog = 3;  // blocks of a column's cluster (a portable size)

// a table entry's value, a canonical residue: its int64's low word, through
// the read-only path
__device__ __forceinline__ uint32_t ld_twiddle(const int64_t* a) {
  return __ldg(reinterpret_cast<const unsigned int*>(a));
}

__device__ __forceinline__ void butterfly(uint32_t* v, uint32_t lo, uint32_t hi, uint32_t t) {
  const uint32_t a = v[lo], b = v[hi];
  v[lo] = add(a, b);
  v[hi] = mul(sub(a, b), t);
}

__global__ void __launch_bounds__(kLastThreads)
fri_last_kernel(const int64_t* __restrict__ g, const int64_t* __restrict__ tw, uint32_t* __restrict__ scratch,
                int64_t* __restrict__ out, int level, int bound, uint32_t scale) {
  __shared__ uint32_t v[1 << kSlabLog];
  cg::cluster_group cluster = cg::this_cluster();
  const int k1 = min(level, kSlabLog), k2 = level - k1, logw = k1 - k2;
  const uint32_t n = 1u << level, slab = 1u << k1, half = slab >> 1, W = 1u << logw;
  const uint32_t col = blockIdx.y, rank = blockIdx.x, ranks = gridDim.x, units = 1u << k2;
  const int64_t* src = g + (int64_t)col * n;
  uint32_t* mid = scratch + (int64_t)col * n;
  const uint32_t t = threadIdx.x;

  for (uint32_t s = rank; s < units; s += ranks) {
    const uint32_t base = s << k1;
    for (uint32_t e = t; e < slab; e += kLastThreads) v[e] = (uint32_t)src[base + e];
    __syncthreads();
    for (int L = 0; L < k1; ++L) {
      const int64_t* tl = tw + (n - (n >> L));
      for (uint32_t u = t; u < half; u += kLastThreads) {
        const uint32_t lo = ((u >> L) << (L + 1)) | (u & ((1u << L) - 1));
        butterfly(v, lo, lo + (1u << L), ld_twiddle(tl + ((base + lo) >> (L + 1))));
      }
      __syncthreads();
    }
    for (uint32_t e = t; e < slab; e += kLastThreads) mid[base + e] = v[e];
    __syncthreads();
  }
  if (rank == 0 && t == 0) out[((int64_t)4 << bound) + col] = 0;
  __threadfence();
  cluster.sync();  // every slab of the column in scratch, its count zeroed

  unsigned nonzero = 0;
  for (uint32_t s = rank; s < units; s += ranks) {
    const uint32_t w0 = s << logw;
    for (uint32_t e = t; e < slab; e += kLastThreads) v[e] = __ldcg(mid + ((e >> logw) << k1) + w0 + (e & (W - 1)));
    __syncthreads();
    for (int j = 0; j < k2; ++j) {
      const int64_t* tl = tw + (n - (n >> (k1 + j)));
      for (uint32_t u = t; u < half; u += kLastThreads) {
        const uint32_t h = u >> logw, w = u & (W - 1);
        const uint32_t hlo = ((h >> j) << (j + 1)) | (h & ((1u << j) - 1));
        butterfly(v, (hlo << logw) + w, ((hlo + (1u << j)) << logw) + w, ld_twiddle(tl + (hlo >> (j + 1))));
      }
      __syncthreads();
    }
    for (uint32_t e = t; e < slab; e += kLastThreads) {
      const uint32_t p = ((e >> logw) << k1) + w0 + (e & (W - 1));
      const uint32_t c = mul(v[e], scale);
      if ((p >> bound) == 0) {
        out[(int64_t)(bound ? __brev(p) >> (32 - bound) : 0) * 4 + col] = c;
      } else {
        nonzero += c != 0;
      }
    }
    __syncthreads();
  }
  if (nonzero) atomicAdd(reinterpret_cast<unsigned long long*>(out + ((int64_t)4 << bound) + col), nonzero);
}

}  // namespace

// g: (4, 2^level) int64 limb rows, contiguous; tw: the 2^level - 1 round
// twiddles (prover/fri_last.py `twiddles`), int64; scratch: (4, 2^level)
// uint32, overwritten; out: 4 x 2^bound + 4 int64, written: the kept
// coefficients as (2^bound, 4) rows in the verifier's order, then each
// column's count of nonzero coefficients outside them.  scale = 2^-level mod
// p.  1 <= level <= 23, 0 <= bound <= level.  Launches on `stream` and
// returns the launch's error.
extern "C" int fri_last_layer(const void* g, const void* tw, void* scratch, void* out, int64_t level, int64_t bound,
                              int64_t scale, void* stream) {
  if (level < 1 || level > kMaxLastLog || bound < 0 || bound > level) return (int)cudaErrorInvalidValue;
  const int k2 = level > kSlabLog ? (int)level - kSlabLog : 0;
  const unsigned ranks = 1u << (k2 < kMaxClusterLog ? k2 : kMaxClusterLog);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, 4, 1);
  cfg.blockDim = dim3(kLastThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, fri_last_kernel, (const int64_t*)g, (const int64_t*)tw,
                                          (uint32_t*)scratch, (int64_t*)out, (int)level, (int)bound,
                                          (uint32_t)scale);
  return err != 0 ? err : (int)cudaGetLastError();
}
