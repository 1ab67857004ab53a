// The circle FFT over M31 for Hopper (sm_90a), bound through a plain C
// interface (ops/build.py compiles this file with nvcc; ops/fft_cuda.py
// loads it with ctypes): the provers' interpolations and low-degree
// extensions of whole columns, and the streamed provers' evaluation of
// base coefficients on tiles of a larger domain.
//
// Replaces what XLA compiled on the TPU from recursive_stwo_tpu/prover/
// circle_fft.py `interpolate_traced` (:156), `evaluate_traced` (:174) and
// `extend_traced` (:193), reached through device_prove.py `_lde_t` (:149),
// and from prover/stream.py `_tile_twiddles` (:164) and `_eval_tiles`
// (:176).  The port's eager versions (prover/circle_fft.py
// `interpolate_plain` / `evaluate_plain`, prover/stream.py `_eval_tiles`)
// are the plain versions: one launch per op, about six passes over device
// memory a layer.
//
// The transforms are circle_fft.py's: evaluations in bit-reversed
// circle-domain order, coefficients in the stwo basis.  Layer k pairs the
// positions p and p + 2^k of each group of 2^(k+1) and takes the group's
// twiddle, indexed by the group's position p >> (k + 1).  Interpolation runs
// layers 0 .. n-1 with (a, b) -> (a + b, (a - b) t) and scales by 1/2^n;
// evaluation runs layers n-1 .. 0 with (f0, f1) -> (f0 + t f1, f0 - t f1).
// An evaluation of 2^b coefficients on a domain of G 2^b points is the
// evaluation of the zero-padded coefficients: its layers b .. above have a
// zero second operand and only copy, so the kernel skips them and reads
// position p's value from coefficient p mod 2^b; each of the G segments of
// 2^b outputs then runs layers b-1 .. 0 with its own twiddles.  Every mode
// reads layer k's twiddle of the group at p from one int32 table at
// N - (N >> k) + (p >> (k + 1)), N = G 2^b: whole columns from circle_fft_host
// `_twiddles` / `_inv_twiddles` flattened (ops/fft_cuda.py `_table`), the
// streamed provers' tiles (prover/tiles.py) from a table that
// fft_tile_twiddle_kernel derives first from each tile's points, as
// stream.py `_tile_twiddles` does: layer 0 the y of the even points, layer 1
// the x of the multiples of 4, layer k + 1 one doubling (x -> 2x^2 - 1) of
// layer k's twiddle at the even groups; each tile's base point read once a
// thread, the tile table once a pair of points.
//
// What bounds it on an H100: the integer pipe.  A butterfly is one modular
// product and two modular sums, twelve int32 operations as ops/fft_cuda.py
// counts them (nine instructions on sm_90, which fuses an add and a min),
// against 16 bytes of int64 read and written a point a pass; at b = 15-18
// layers the operations outweigh the bytes.  The design spends as little
// else as it can:
// - Radix-8 rounds in registers.  A thread takes eight points of a group at
//   a time (2^Q, Q = 3, fewer only in the top round), loads them once, runs
//   three layers on them with the group's seven twiddles (three loads
//   through the read-only path: four, two and one consecutive words), and
//   stores them once.  A round computes a group's addresses once (shared
//   words by per-round byte offsets); one block barrier a round, none a
//   layer.  A thread holds 64 words of its block's tile, so a block of 2^Bt
//   words has 2^(Bt-6) threads and each takes 2^(6-Q) groups a round, 32
//   points of them in flight.
// - Whole segments in one pass.  A block holds 2^13 or 2^14 words of a
//   column in dynamic shared memory (one pad word a 32, so that the rounds
//   at element strides 1 (as 16-byte vectors), 8, 16 and 32 and up hit 32
//   banks), three blocks an SM, and a thread block cluster of 2-16 blocks
//   holds a segment of 2^14-2^18 in distributed shared memory (16: a
//   non-portable cluster size).  A cluster's layers above one block's tile
//   are one round across its ranks, run as the evaluation's first round
//   (read from device memory, written to each rank's shared memory through
//   cluster.map_shared_rank) and the interpolation's last (read from the
//   ranks, written to device memory), with cluster.sync() around them.  The
//   first round reads device memory and the last writes it, so a transform
//   of b <= 18 layers reads its input once and writes each output once;
//   above 18 it takes two passes, a strided one of the layers above 17
//   (2^S strided positions in runs of 2^c, 2^(S+c) >= 2^13 words a block)
//   and the contiguous one.  ops/fft_cuda.py `plan` chooses every pass's
//   shape and hands it to circle_fft below, which checks it.
// - Loads and stores of 16 bytes a thread where a thread's eight points are
//   neighbours (the interpolation's first round, the evaluation's last),
//   else one word a point with neighbouring threads on neighbouring
//   points; an int64 value is read as its low word.  Positions within a
//   column are 32-bit (at most 2^27), a column's base 64-bit: a (16, 2^27)
//   output passes 2^31 elements.
// A block takes the same tile of up to eight columns, so the twiddles it
// reads serve all of them from the caches; columns are the grid's second
// axis.  Output is out of place, canonical int64; the caller's input is only
// read.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "m31.cuh"

namespace cg = cooperative_groups;

namespace {

using poseidon2_m31::add;
using poseidon2_m31::mul;
using poseidon2_m31::sub;

constexpr int kMaxLog = 27;         // positions a column: at most 2^27
constexpr int kMaxSources = 8;      // source blocks of one call
constexpr int kMaxPasses = 2;
constexpr int kMaxBlockLog = 14;    // words of a block's tile
constexpr int kMaxClusterLog = 4;   // blocks of a cluster (16: a non-portable size)
constexpr int kWordsPerThread = 64;
constexpr int kMaxThreads = (1 << kMaxBlockLog) / kWordsPerThread;
constexpr int kPointsInFlight = 32;  // a thread's points of a round in registers at once
constexpr int kMaxColsPerBlock = 8;
constexpr int64_t kTargetThreads = 132 * 2048 * 2;  // two waves of full SMs before columns share a block
constexpr int kMaxGridY = 65535;
constexpr int kTwiddleThreads = 256;

// Positions in the `scalars` array (ops/fft_cuda.py writes it).
enum Scalar {
  kMode = 0,    // enum Mode
  kCols,        // columns, the sources' rows together
  kLogSegment,  // b: layers 0 .. b-1 within segments of 2^b
  kSegments,    // G: segments a column (a power of two for the table modes)
  kSources,     // source blocks
  kScale,       // interpolation: 1/2^b
  kPasses,      // passes of the plan
  kPlan,        // pass i's (k0, S, c, U, R, Bt) at kPlan + kPassFields i, in the order they run
  kPassFields = 6,
  kSourceRows = kPlan + kPassFields * kMaxPasses,  // rows of source block k
  kSourceStride = kSourceRows + kMaxSources,       // row stride of source block k, in elements
  kScalars = kSourceStride + kMaxSources,
};

// Positions in the `ptrs` array.
enum Ptr {
  kOut = 0,   // (cols, G 2^b) int64
  kTable,     // int32 twiddles: circle_fft_host's of the G 2^b domain (table modes), scratch (kTiles)
  kBx,        // (G,) int64 tile base points (kTiles)
  kBy,
  kTx,        // (2^b,) int64 tile table (kTiles)
  kTy,
  kSource,    // source block k: (rows, >= 2^b) int64 at its row stride
  kPtrs = kSource + kMaxSources,
};

enum Mode { kInterpolate = 0, kEvaluate = 1, kTiles = 2 };

// One pass: layers [k0, k0 + S) of every column.  A cluster tile is 2^(U+S+c)
// elements e = (u << (S+c)) | (m << c) | l: 2^U units of 2^S positions
// (U > 0 only when k0 = 0), m the index a layer k0 + q pairs on its bit q, l
// the run of 2^c contiguous positions (c = 0 when k0 = 0).  Rank rho of a
// cluster of 2^R blocks holds the elements rho 2^Bt ... (R > 0 only when k0 =
// 0 and U = 0): the layers of m's top R bits run across the ranks.
struct Pass {
  int b;
  int k0, S, c, U, R, Bt;
  uint32_t n_total;  // positions a column, G 2^b
  int64_t cols;
  bool from_source;  // the first pass reads the sources, the second the output
  bool vec_source;   // every source row starts on 16 bytes
  const int64_t* source[kMaxSources];
  int64_t source_stride[kMaxSources];
  int64_t source_end[kMaxSources];  // rows of blocks 0 .. k
  int64_t* out;
  uint32_t scale;       // the last pass of an interpolation multiplies by it; 0: none
  const uint32_t* tw;   // layer k's twiddles at n_total - (n_total >> k), by position >> (k + 1)
};

// What a block knows of its tile.
struct Tile {
  int t, nth, Bt, c, k0;
  uint32_t rho;      // rank in the cluster
  uint32_t pbase;    // position of the cluster tile's element 0
  uint32_t n_total;
  const uint32_t* tw;

  // position of cluster element E
  __device__ __forceinline__ uint32_t position(uint32_t E) const {
    return pbase + ((E >> c) << k0) + (E & ((1u << c) - 1));
  }
};

// Shared-memory word of tile element e: a pad word after each 32.  The map
// is additive over disjoint bits, so a group's words are its first's plus
// per-round constants.
__device__ __forceinline__ uint32_t phys(uint32_t e) { return e + ((e >> 5) << 2); }

__host__ __device__ constexpr int smem_words(int Bt) { return (1 << Bt) + ((1 << Bt) >> 3); }

// x -> 2x^2 - 1, the x coordinate of the doubled point
__device__ __forceinline__ uint32_t double_x(uint32_t x) {
  const uint32_t sq = mul(x, x);
  return sub(add(sq, sq), 1u);
}

// int64 values of canonical residues, read as their low words (coherent
// loads: a second pass reads what the first wrote)
__device__ __forceinline__ uint32_t ld_value(const int64_t* a) { return __ldcg(reinterpret_cast<const unsigned int*>(a)); }

__device__ __forceinline__ void ld_values8(const int64_t* a, uint32_t (&v)[8]) {
  const uint4* q = reinterpret_cast<const uint4*>(a);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const uint4 w = __ldcg(q + h);
    v[2 * h] = w.x;
    v[2 * h + 1] = w.z;
  }
}

__device__ __forceinline__ void st_value(int64_t* a, uint32_t v) { *reinterpret_cast<uint2*>(a) = make_uint2(v, 0u); }

__device__ __forceinline__ void st_values8(int64_t* a, const uint32_t (&v)[8]) {
  uint4* q = reinterpret_cast<uint4*>(a);
#pragma unroll
  for (int h = 0; h < 4; ++h) q[h] = make_uint4(v[2 * h], 0u, v[2 * h + 1], 0u);
}

// The 2^Q - 1 twiddles of a group of 2^Q points whose first is at position
// p0 (bits k .. k+Q-1 clear): layer k + l's 2^(Q-1-l) consecutive words at
// w[2^Q - 2^(Q-l)], read 16 bytes at a time where there are four or more.
// Their index is a multiple of their count (ops/fft_cuda.py `_table` and the
// scratch table start on 16 bytes).
template <int Q>
__device__ __forceinline__ void load_twiddles(const Tile& x, int k, uint32_t p0, uint32_t (&w)[(1 << Q) - 1]) {
#pragma unroll
  for (int l = 0; l < Q; ++l) {
    const uint32_t idx = x.n_total - (x.n_total >> (k + l)) + (p0 >> (k + l + 1));
    constexpr int kN = 1 << Q;
    const int at = kN - (kN >> l), count = 1 << (Q - 1 - l);
    if (count >= 4) {
#pragma unroll
      for (int h = 0; h < count / 4; ++h) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(x.tw + idx) + h);
        w[at + 4 * h] = q.x, w[at + 4 * h + 1] = q.y, w[at + 4 * h + 2] = q.z, w[at + 4 * h + 3] = q.w;
      }
    } else if (count == 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(x.tw + idx));
      w[at] = q.x, w[at + 1] = q.y;
    } else {
      w[at] = __ldg(x.tw + idx);
    }
  }
}

// Layers k .. k+Q-1 of a group held in registers: v[j] at p0 + j 2^k.
template <int Q, bool kInverse>
__device__ __forceinline__ void butterflies(uint32_t (&v)[1 << Q], const uint32_t (&w)[(1 << Q) - 1]) {
  constexpr int kN = 1 << Q;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int l = kInverse ? i : Q - 1 - i;
    const int half = 1 << l;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (j & half) continue;
      const uint32_t t = w[kN - (kN >> l) + (j >> (l + 1))];
      if (kInverse) {
        const uint32_t a = v[j], b = v[j + half];
        v[j] = add(a, b);
        v[j + half] = mul(sub(a, b), t);
      } else {
        const uint32_t tb = mul(v[j + half], t);
        v[j + half] = sub(v[j], tb);
        v[j] = add(v[j], tb);
      }
    }
  }
}

// One round within a block: layers k0 + q0 .. k0 + q0 + Q - 1 on m's bits
// q0 .. q0+Q-1, element bits s = q0 + c.  Group g's first element inserts Q
// clear bits at s into g; a thread takes groups t, t + nth, ...  Its points
// come from device memory (`in`, positions masked to the source) or shared
// memory and go to device memory (`dst`, times `scale` when not 0) or shared
// memory.
template <int Q, bool kInverse, bool kLoadGlobal, bool kStoreGlobal>
__device__ __forceinline__ void local_round(const Tile& x, uint32_t* smem, int q0, const int64_t* in, uint32_t mask,
                                            bool vec_in, int64_t* dst, uint32_t scale) {
  constexpr int kN = 1 << Q;
  const int s = q0 + x.c, k = x.k0 + q0;
  const uint32_t groups = 1u << (x.Bt - Q), low = (1u << s) - 1;
  // byte offsets in shared memory of the group's points past its first (an
  // access is then one add), and whether they are eight neighbours (a
  // vector access)
  uint32_t d[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) d[j] = 4 * phys((uint32_t)j << s);
  char* const bytes = reinterpret_cast<char*>(smem);
  const bool vec = Q == 3 && s == 0;
#pragma unroll(kPointsInFlight >> Q)
  for (int i = 0; i < (kWordsPerThread >> Q); ++i) {
    const uint32_t g = x.t + i * x.nth;
    if (g >= groups) break;
    const uint32_t e0 = (g & low) | ((g & ~low) << Q);
    const uint32_t p0 = x.position((x.rho << x.Bt) | e0);
    const uint32_t s0 = phys(e0);
    char* const row = bytes + 4 * s0;
    uint32_t v[kN];
    if constexpr (kLoadGlobal) {
      const int64_t* src = in + (p0 & mask);
      if constexpr (Q == 3) {
        if (vec && vec_in) {
          ld_values8(src, v);
        } else {
#pragma unroll
          for (int j = 0; j < kN; ++j) v[j] = ld_value(src + ((uint32_t)j << k));
        }
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j) v[j] = ld_value(src + ((uint32_t)j << k));
      }
    } else {
      if constexpr (Q == 3) {
        if (vec) {
          const uint4 lo = *reinterpret_cast<const uint4*>(row);
          const uint4 hi = *reinterpret_cast<const uint4*>(row + 16);
          v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w, v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
        } else {
#pragma unroll
          for (int j = 0; j < kN; ++j) v[j] = *reinterpret_cast<const uint32_t*>(row + d[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j) v[j] = *reinterpret_cast<const uint32_t*>(row + d[j]);
      }
    }
    uint32_t w[kN - 1];
    load_twiddles<Q>(x, k, p0, w);
    butterflies<Q, kInverse>(v, w);
    if (kStoreGlobal) {
      if (scale) {
#pragma unroll
        for (int j = 0; j < kN; ++j) v[j] = mul(v[j], scale);
      }
      int64_t* out = dst + p0;
      if constexpr (Q == 3) {
        if (vec) {
          st_values8(out, v);
        } else {
#pragma unroll
          for (int j = 0; j < kN; ++j) st_value(out + ((uint32_t)j << k), v[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j) st_value(out + ((uint32_t)j << k), v[j]);
      }
    } else {
      if constexpr (Q == 3) {
        if (vec) {
          *reinterpret_cast<uint4*>(row) = make_uint4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<uint4*>(row + 16) = make_uint4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int j = 0; j < kN; ++j) *reinterpret_cast<uint32_t*>(row + d[j]) = v[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j) *reinterpret_cast<uint32_t*>(row + d[j]) = v[j];
      }
    }
  }
}

template <bool kInverse, bool kLoadGlobal, bool kStoreGlobal>
__device__ __forceinline__ void local_round(int Q, const Tile& x, uint32_t* smem, int q0, const int64_t* in,
                                            uint32_t mask, bool vec_in, int64_t* dst, uint32_t scale) {
  if (Q == 3) {
    local_round<3, kInverse, kLoadGlobal, kStoreGlobal>(x, smem, q0, in, mask, vec_in, dst, scale);
  } else if (Q == 2) {
    local_round<2, kInverse, kLoadGlobal, kStoreGlobal>(x, smem, q0, in, mask, vec_in, dst, scale);
  } else {
    local_round<1, kInverse, kLoadGlobal, kStoreGlobal>(x, smem, q0, in, mask, vec_in, dst, scale);
  }
}

// The cluster's round: layers Bt .. Bt+R-1 of a contiguous pass, a group the
// 2^R points at one offset o of every rank's tile (positions pbase + o + j
// 2^Bt).  Rank rho takes the offsets rho 2^(Bt-R) .. (rho+1) 2^(Bt-R) - 1.  The
// evaluation reads device memory and writes each rank's shared memory; the
// interpolation reads the ranks and writes device memory.
template <int R, bool kInverse>
__device__ __forceinline__ void cluster_round(const Tile& x, uint32_t* smem, const int64_t* in, uint32_t mask,
                                              int64_t* dst, uint32_t scale) {
  constexpr int kN = 1 << R;
  const int k = x.Bt;
  cg::cluster_group cluster = cg::this_cluster();
  uint32_t* rank[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) rank[j] = cluster.map_shared_rank(smem, j);
#pragma unroll(kPointsInFlight >> R)
  for (int i = 0; i < (kWordsPerThread >> R); ++i) {
    if ((uint32_t)(x.t + i * x.nth) >= (1u << (x.Bt - R))) break;
    const uint32_t o = (x.rho << (x.Bt - R)) + x.t + i * x.nth;
    const uint32_t p0 = x.pbase + o, s0 = phys(o);
    uint32_t v[kN];
    if (kInverse) {
#pragma unroll
      for (int j = 0; j < kN; ++j) v[j] = rank[j][s0];
    } else {
      const int64_t* src = in + (p0 & mask);
#pragma unroll
      for (int j = 0; j < kN; ++j) v[j] = ld_value(src + ((uint32_t)j << k));
    }
    uint32_t w[kN - 1];
    load_twiddles<R>(x, k, p0, w);
    butterflies<R, kInverse>(v, w);
    if (kInverse) {
#pragma unroll
      for (int j = 0; j < kN; ++j) st_value(dst + p0 + ((uint32_t)j << k), scale ? mul(v[j], scale) : v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) rank[j][s0] = v[j];
    }
  }
}

template <bool kInverse, bool kWide>
__device__ __forceinline__ void cluster_round(int R, const Tile& x, uint32_t* smem, const int64_t* in, uint32_t mask,
                                              int64_t* dst, uint32_t scale) {
  if (kWide && R == kMaxClusterLog) {
    cluster_round<kMaxClusterLog, kInverse>(x, smem, in, mask, dst, scale);
  } else if (R == 3) {
    cluster_round<3, kInverse>(x, smem, in, mask, dst, scale);
  } else if (R == 2) {
    cluster_round<2, kInverse>(x, smem, in, mask, dst, scale);
  } else {
    cluster_round<1, kInverse>(x, smem, in, mask, dst, scale);
  }
}

// One pass (Pass above) over every column.  Interpolation (kInverse) runs
// the rounds up: m's bits [0, 3), [3, 6), ... of the block, then the
// cluster's round; evaluation and tiles run them down.  A block takes
// columns blockIdx.y, + gridDim.y, ...; its cluster's blocks take the same.
// Every instance is held to three blocks an SM (at most 85 registers): a
// block's phases (device loads, rounds, device stores) then overlap with
// two others'.  Clusters of 16 (kWide, the radix-16 round) have an
// instance of their own, which keeps the smaller rounds too (built with the
// radix-16 round alone it took twice as long on the card).
template <bool kInverse, bool kWide>
__global__ void __launch_bounds__(kMaxThreads, 3) fft_pass_kernel(const __grid_constant__ Pass a) {
  extern __shared__ uint4 smem_vec[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_vec);
  Tile x;
  x.t = threadIdx.x;
  x.nth = blockDim.x;
  x.Bt = a.Bt;
  x.c = a.c;
  x.k0 = a.k0;
  const uint32_t tile = blockIdx.x >> a.R;
  x.rho = blockIdx.x & ((1u << a.R) - 1);
  const uint32_t hi = tile >> (a.k0 - a.c), lo = tile & ((1u << (a.k0 - a.c)) - 1);
  x.pbase = (hi << (a.k0 + a.S + a.U)) + (lo << a.c);
  x.n_total = a.n_total;
  x.tw = a.tw;
  const int local = a.S - a.R, rounds = (local + 2) / 3;  // rounds r: m's bits [3r, min(3r + 3, local))

  if (a.R) cg::this_cluster().sync();  // every rank running before any writes another's shared memory

  // column col's input: a row of a source block (positions mod 2^b), or
  // the output a first pass wrote
  const uint32_t mask = a.from_source ? (1u << a.b) - 1 : ~0u;
  auto input = [&](int64_t col) -> const int64_t* {
    if (!a.from_source) return a.out + col * (int64_t)a.n_total;
    int k = 0;
    while (col >= a.source_end[k]) ++k;
    return a.source[k] + (col - (k ? a.source_end[k - 1] : 0)) * a.source_stride[k];
  };
  const bool vec_in = !a.from_source || a.vec_source;

  for (int64_t col = blockIdx.y; col < a.cols; col += gridDim.y) {
    const int64_t* in = input(col);
    int64_t* dst = a.out + col * (int64_t)a.n_total;

    if (a.S == 0) {  // b = 0: a copy (the interpolation's scale is 1)
      for (uint32_t e = x.t; e < (1u << a.Bt); e += x.nth) {
        const uint32_t p = x.position(e);
        st_value(dst + p, ld_value(in + (p & mask)));
      }
      continue;
    }
    if (!kInverse) {
      if (a.R) {
        cluster_round<false, kWide>(a.R, x, smem, in, mask, nullptr, 0);
        cg::this_cluster().sync();
      }
      for (int r = rounds - 1; r >= 0; --r) {
        const int q0 = 3 * r, Q = min(3, local - q0);
        const bool first = r == rounds - 1 && !a.R, last = r == 0;
        if (first && last) {
          local_round<false, true, true>(Q, x, smem, q0, in, mask, vec_in, dst, 0);
        } else if (first) {
          local_round<false, true, false>(Q, x, smem, q0, in, mask, vec_in, dst, 0);
        } else if (last) {
          local_round<false, false, true>(Q, x, smem, q0, in, mask, vec_in, dst, 0);
        } else {
          local_round<false, false, false>(Q, x, smem, q0, in, mask, vec_in, dst, 0);
        }
        if (!last) __syncthreads();
      }
    } else {
      for (int r = 0; r < rounds; ++r) {
        const int q0 = 3 * r, Q = min(3, local - q0);
        const bool first = r == 0, last = r == rounds - 1 && !a.R;
        if (first && last) {
          local_round<true, true, true>(Q, x, smem, q0, in, mask, vec_in, dst, a.scale);
        } else if (first) {
          local_round<true, true, false>(Q, x, smem, q0, in, mask, vec_in, dst, 0);
        } else if (last) {
          local_round<true, false, true>(Q, x, smem, q0, in, mask, vec_in, dst, a.scale);
        } else {
          local_round<true, false, false>(Q, x, smem, q0, in, mask, vec_in, dst, 0);
        }
        if (r < rounds - 1) __syncthreads();
      }
      if (a.R) {
        cg::this_cluster().sync();
        cluster_round<true, kWide>(a.R, x, smem, in, mask, dst, a.scale);
      }
    }
    // the next column's first round writes what this one's last read: in
    // this block, or in the cluster's ranks
    if (a.R) {
      cg::this_cluster().sync();
    } else if (rounds > 1) {
      __syncthreads();
    }
  }
}

// The tile table of `_tile_twiddles`, laid out as the pass kernel reads it:
// N = G 2^b, layer k's twiddle of tile g's group i at N - (N >> k) + g
// 2^(b-k-1) + i.  Thread (g, j) takes the even point 2j of tile g (base point
// times tile-table point 2j, not conjugated): its y is layer 0's twiddle j;
// for j even its x is layer 1's j/2, and one doubling a layer carries it up
// while the index stays even.
__global__ void __launch_bounds__(kTwiddleThreads)
    fft_tile_twiddle_kernel(const int64_t* bx, const int64_t* by, const int64_t* tx, const int64_t* ty,
                            uint32_t* tw, int b, int64_t G) {
  const int64_t id = blockIdx.x * (int64_t)kTwiddleThreads + threadIdx.x;
  if (id >= (G << (b - 1))) return;
  const uint32_t g = (uint32_t)(id >> (b - 1)), j = (uint32_t)id & ((1u << (b - 1)) - 1);
  const uint32_t n = (uint32_t)(G << b);
  const uint32_t gx = (uint32_t)bx[g], gy = (uint32_t)by[g];
  const uint32_t px = (uint32_t)tx[2 * j], py = (uint32_t)ty[2 * j];
  tw[(g << (b - 1)) + j] = add(mul(gx, py), mul(gy, px));
  if (b < 2 || (j & 1)) return;
  uint32_t xk = sub(mul(gx, px), mul(gy, py)), i = j >> 1;
  for (int k = 1;; ++k) {
    tw[n - (n >> k) + (g << (b - 1 - k)) + i] = xk;
    if (k + 1 >= b || (i & 1)) break;
    i >>= 1;
    xk = double_x(xk);
  }
}

template <bool kInverse, bool kWide>
int launch(const Pass& p, cudaStream_t stream) {
  static bool configured = false;
  const int bytes = smem_words(p.Bt) * 4;
  if (!configured) {
    int err = (int)cudaFuncSetAttribute(fft_pass_kernel<kInverse, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        smem_words(kMaxBlockLog) * 4);
    if (err == 0) {
      // the most shared memory an SM can give, so that a cluster's blocks
      // share SMs
      err = (int)cudaFuncSetAttribute(fft_pass_kernel<kInverse, kWide>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                      cudaSharedmemCarveoutMaxShared);
    }
    if (err == 0 && kWide) {
      err = (int)cudaFuncSetAttribute(fft_pass_kernel<kInverse, kWide>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != 0) return err;
    configured = true;
  }
  const int threads = (1 << p.Bt) / kWordsPerThread < 32 ? 32 : (1 << p.Bt) / kWordsPerThread;
  const int64_t blocks = ((int64_t)p.n_total >> (p.U + p.S + p.c)) << p.R;
  // columns share a block (and its twiddles in the caches) only once the
  // tiles alone fill the card
  int64_t per_block = blocks * threads * p.cols / kTargetThreads;
  per_block = per_block < 1 ? 1 : per_block > kMaxColsPerBlock ? kMaxColsPerBlock : per_block;
  int64_t ys = (p.cols + per_block - 1) / per_block;
  if (ys > kMaxGridY) ys = kMaxGridY;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)ys, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << p.R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, fft_pass_kernel<kInverse, kWide>, p);
  return err != 0 ? err : (int)cudaGetLastError();
}

int trailing_zeros(int64_t x) {
  int n = 0;
  while (!((x >> n) & 1)) ++n;
  return n;
}

// A pass of the plan the kernel can run: the shapes above, a tile of at
// most 2^15 words (2^5 a thread), a whole number of tiles a column.
bool valid_pass(int b, int64_t n_total, int k0, int S, int c, int U, int R, int Bt) {
  if (k0 < 0 || S < 0 || c < 0 || U < 0 || R < 0 || R > kMaxClusterLog || Bt < 0 || Bt > kMaxBlockLog) return false;
  if (k0 + S > b || c > k0 || Bt != U + S + c - R) return false;
  if (k0 == 0 && c != 0) return false;
  if (k0 > 0 && U != 0) return false;
  if (R > 0 && (U != 0 || k0 != 0 || Bt < R)) return false;
  return U + S + c <= trailing_zeros(n_total);
}

}  // namespace

// scalars: kScalars int64 (the Scalar positions above); ptrs: kPtrs device
// pointers (unused entries 0; kTable the scratch of G 2^b - G words for
// kTiles).  Launches the tile twiddles (kTiles) and the plan's passes on
// `stream` in order and writes the number of passes to *passes; returns
// the first launch's error, or cudaErrorInvalidValue for a shape or a plan
// past the kernel's limits.
extern "C" int circle_fft(const int64_t* scalars, const int64_t* ptrs, void* stream, int64_t* passes) {
  *passes = 0;
  const int mode = (int)scalars[kMode];
  const int64_t cols = scalars[kCols], G = scalars[kSegments];
  const int b = (int)scalars[kLogSegment], n_sources = (int)scalars[kSources];
  const int n_passes = (int)scalars[kPasses];
  if (mode < kInterpolate || mode > kTiles || b < 0 || b > kMaxLog || G < 1 || G > (1ll << (kMaxLog - b)) ||
      cols < 0 || n_sources < 1 || n_sources > kMaxSources || (mode == kInterpolate && G != 1) ||
      (mode != kTiles && (G & (G - 1)) != 0) || n_passes < 1 || n_passes > kMaxPasses) {
    return (int)cudaErrorInvalidValue;
  }
  Pass p{};
  p.b = b;
  p.n_total = (uint32_t)(G << b);
  p.cols = cols;
  p.vec_source = true;
  int64_t rows = 0;
  for (int k = 0; k < n_sources; ++k) {
    p.source[k] = (const int64_t*)ptrs[kSource + k];
    p.source_stride[k] = scalars[kSourceStride + k];
    rows += scalars[kSourceRows + k];
    p.source_end[k] = rows;
    if (scalars[kSourceRows + k] < 0 || (scalars[kSourceRows + k] > 0 && p.source[k] == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
    if (scalars[kSourceRows + k] > 0 && (ptrs[kSource + k] % 16 != 0 || p.source_stride[k] % 2 != 0)) {
      p.vec_source = false;
    }
  }
  if (rows != cols) return (int)cudaErrorInvalidValue;
  // the plan: its passes cover layers [0, b) once, up for an interpolation,
  // down otherwise
  int covered = 0;
  for (int i = 0; i < n_passes; ++i) {
    const int64_t* f = scalars + kPlan + kPassFields * i;
    const int k0 = (int)f[0], S = (int)f[1];
    if (!valid_pass(b, p.n_total, k0, S, (int)f[2], (int)f[3], (int)f[4], (int)f[5])) return (int)cudaErrorInvalidValue;
    const int want = mode == kInterpolate ? covered : b - covered - S;
    if (k0 != want) return (int)cudaErrorInvalidValue;
    covered += S;
  }
  if (covered != b) return (int)cudaErrorInvalidValue;
  p.out = (int64_t*)ptrs[kOut];
  p.tw = (const uint32_t*)ptrs[kTable];
  if (cols == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;

  if (mode == kTiles && b > 0) {
    const int64_t threads = G << (b - 1);
    fft_tile_twiddle_kernel<<<(unsigned)((threads + kTwiddleThreads - 1) / kTwiddleThreads), kTwiddleThreads, 0, s>>>(
        (const int64_t*)ptrs[kBx], (const int64_t*)ptrs[kBy], (const int64_t*)ptrs[kTx], (const int64_t*)ptrs[kTy],
        (uint32_t*)ptrs[kTable], b, G);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  for (int i = 0; i < n_passes; ++i) {
    const int64_t* f = scalars + kPlan + kPassFields * i;
    p.k0 = (int)f[0], p.S = (int)f[1], p.c = (int)f[2], p.U = (int)f[3], p.R = (int)f[4], p.Bt = (int)f[5];
    p.from_source = i == 0;
    p.scale = mode == kInterpolate && i == n_passes - 1 ? (uint32_t)scalars[kScale] : 0u;
    const bool wide = p.R == kMaxClusterLog;
    const int err = mode == kInterpolate ? (wide ? launch<true, true>(p, s) : launch<true, false>(p, s))
                                         : (wide ? launch<false, true>(p, s) : launch<false, false>(p, s));
    if (err != 0) return err;
    ++*passes;
  }
  return 0;
}
