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
// An evaluation of 2^b coefficients on a domain of 2^T > 2^b points is the
// evaluation of the zero-padded coefficients: its layers b .. T-1 have a
// zero second operand and only copy, so the kernel skips them and reads
// position p's value from coefficient p mod 2^b; each of the G = 2^(T-b)
// segments of 2^b outputs then runs layers b-1 .. 0 with its own twiddles.
// The streamed provers' tiles are such segments (prover/tiles.py): a tile's
// twiddles follow from its points, base point times the tile table, as
// stream.py `_tile_twiddles` derives them: layer 0 the y of the even
// points, layer k >= 1 the x of the points at multiples of 2^(k+1), doubled
// k - 1 times (x -> 2x^2 - 1).  Whole columns read the per-layer tables of
// circle_fft_host `_twiddles` / `_inv_twiddles`, flattened (layer k at
// 2^T - 2^(T-k)), as int32.
//
// What bounds it on an H100: device memory.  A butterfly is one modular
// product and two sums on 4-byte values staged in shared memory; the int64
// columns are read and written once a pass (ops/fft_cuda.py counts both).
// The design: a block stages a tile of 2^12 words of one column in shared
// memory and runs up to 12 consecutive layers on it.  The first pass of an
// interpolation (the last of an evaluation) takes contiguous tiles, layers 0
// .. 11; the layers above are split evenly over strided passes of at most 8
// layers, whose tiles are 2^S strides of 2^(12-S) contiguous positions (at
// least 16, a 128-byte line of int64).  A transform of 2^27 points is three
// passes over device memory, against about six a layer eager.  A thread
// issues all eight of its loads before it stores one to shared memory.  A
// block stages its tile's twiddles (2^S - 1 of S layers) once and takes up
// to eight columns with them once the tiles alone fill the card; columns
// are the grid's second axis.
// Output is out of place, canonical int64; the caller's input is only read.
// Position arithmetic is 64-bit: a (16, 2^27) output passes 2^31 elements.

#include <cstdint>

#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

using poseidon2_m31::add;
using poseidon2_m31::mul;
using poseidon2_m31::sub;

constexpr int kThreads = 512;
constexpr int kTileLog = 12;    // words of a block's tile
constexpr int kPerThread = (1 << kTileLog) / kThreads;
constexpr int kMinContigLog = 4;  // contiguous positions of a strided tile: at least 16
constexpr int kStridedLayers = kTileLog - kMinContigLog;
constexpr int kMaxLog = 27;     // positions a column: at most 2^27
constexpr int kMaxSources = 8;  // source blocks of one call
constexpr int kMaxColsPerBlock = 8;
constexpr int64_t kTargetBlocks = 132 * 8;  // two waves of four blocks an SM before columns share a block
constexpr int kMaxGridY = 65535;

// Positions in the `scalars` array (ops/fft_cuda.py writes it).
enum Scalar {
  kMode = 0,    // enum Mode
  kCols,        // columns, the sources' rows together
  kLogSegment,  // b: layers 0 .. b-1 within segments of 2^b
  kSegments,    // G: segments a column (a power of two for the table modes)
  kSources,     // source blocks
  kScale,       // interpolation: 1/2^b
  kSourceRows,                               // rows of source block k
  kSourceStride = kSourceRows + kMaxSources,  // row stride of source block k, in elements
  kScalars = kSourceStride + kMaxSources,
};

// Positions in the `ptrs` array.
enum Ptr {
  kOut = 0,  // (cols, G 2^b) int64
  kTable,    // flattened int32 twiddles of the 2^(b + log G) domain (table modes)
  kBx,       // (G,) int64 tile base points (kTiles)
  kBy,
  kTx,       // (2^b,) int64 tile table (kTiles)
  kTy,
  kSource,   // source block k: (rows, >= 2^b) int64 at its row stride
  kPtrs = kSource + kMaxSources,
};

enum Mode { kInterpolate = 0, kEvaluate = 1, kTiles = 2 };

struct Pass {
  int b;             // layers 0 .. b-1 within segments of 2^b
  int log_total;     // table modes: the domain's log, b + log G
  int64_t n_total;   // positions a column: G 2^b
  int k0, S, c, U;   // layers [k0, k0 + S), 2^c contiguous positions, 2^U segments a tile
  int64_t cols;
  bool from_source;  // the first pass reads the sources, the others the output
  int n_sources;
  const int64_t* source[kMaxSources];
  int64_t source_stride[kMaxSources];
  int64_t source_end[kMaxSources];  // rows of blocks 0 .. k
  int64_t* out;
  uint32_t scale;  // the last pass of an interpolation multiplies by it; 0: none
  const int32_t* table;
  const int64_t *bx, *by, *tx, *ty;

  __device__ __forceinline__ int tile_log() const { return U + S + c; }

  // Position of a tile's element e: a contiguous tile is 2^(U+S) positions
  // in order; a strided one has e = (m << c) | l at hi 2^(k0+S) + m 2^k0 +
  // lo 2^c + l, the tile's index being (hi, lo).
  __device__ __forceinline__ int64_t position(int64_t tile, int e) const {
    if (k0 == 0) return (tile << (U + S)) + e;
    const int64_t hi = tile >> (k0 - c), lo = tile & ((1ll << (k0 - c)) - 1);
    return (hi << (k0 + S)) + ((int64_t)(e >> c) << k0) + (lo << c) + (e & ((1 << c) - 1));
  }
};

// x -> 2x^2 - 1, the x coordinate of the doubled point
__device__ __forceinline__ uint32_t double_x(uint32_t x) {
  const uint32_t sq = mul(x, x);
  return sub(add(sq, sq), 1u);
}

// The twiddle of global layer k for the group whose first position is p.
template <bool kTileTwiddles>
__device__ __forceinline__ uint32_t twiddle(const Pass& a, int k, int64_t p) {
  if (!kTileTwiddles) {
    const int T = a.log_total;
    return (uint32_t)a.table[(1ll << T) - (1ll << (T - k)) + (p >> (k + 1))];
  }
  // the point at the group's first position of its tile: base times table
  // (r even, so not conjugated)
  const int64_t g = p >> a.b;
  const int64_t r = ((p & ((1ll << a.b) - 1)) >> (k + 1)) << (k + 1);
  const uint32_t bx = (uint32_t)a.bx[g], by = (uint32_t)a.by[g];
  const uint32_t tx = (uint32_t)a.tx[r], ty = (uint32_t)a.ty[r];
  if (k == 0) return add(mul(bx, ty), mul(by, tx));
  uint32_t x = sub(mul(bx, tx), mul(by, ty));
  for (int i = 1; i < k; ++i) x = double_x(x);
  return x;
}

// One pass: layers [k0, k0 + S) of every column on the block's tile.  The
// tile's twiddles are staged first, segment u's layer kk (local) at u 2^S +
// 2^S - 2^(S-kk), one a group of the layer.
template <bool kInverse, bool kTileTwiddles>
__global__ void __launch_bounds__(kThreads) fft_pass_kernel(const __grid_constant__ Pass a) {
  __shared__ uint32_t v[1 << kTileLog];
  __shared__ uint32_t tw[1 << kTileLog];
  const int t = threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int S = a.S, c = a.c, n_el = 1 << a.tile_log();

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int s = t + i * kThreads;
    const int r = s & ((1 << S) - 1), u = s >> S;
    if (s >= (1 << (a.U + S)) || r == (1 << S) - 1) continue;
    const int kk = S - 1 - (31 - __clz((1 << S) - 1 - r));
    const int j = r - ((1 << S) - (1 << (S - kk)));
    const int e_first = (u << (S + c)) | ((j << (kk + 1)) << c);
    tw[s] = twiddle<kTileTwiddles>(a, a.k0 + kk, a.position(tile, e_first));
  }
  __syncthreads();

  for (int64_t col = blockIdx.y; col < a.cols; col += gridDim.y) {
    const int64_t* in;
    int64_t mask;
    if (a.from_source) {
      int k = 0;
      while (col >= a.source_end[k]) ++k;
      in = a.source[k] + (col - (k ? a.source_end[k - 1] : 0)) * a.source_stride[k];
      mask = (1ll << a.b) - 1;
    } else {
      in = a.out + col * a.n_total;
      mask = -1;
    }
    // every load of the thread in flight before the first store
    uint32_t x[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = t + i * kThreads;
      if (e < n_el) x[i] = (uint32_t)in[a.position(tile, e) & mask];
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (t + i * kThreads < n_el) v[t + i * kThreads] = x[i];
    }
    __syncthreads();
    for (int i = 0; i < S; ++i) {
      const int kk = kInverse ? i : S - 1 - i;
      for (int bf = t; bf < n_el / 2; bf += kThreads) {
        const int rest = bf >> c, mm = rest & ((1 << (S - 1)) - 1), u = rest >> (S - 1);
        const int m0 = ((mm >> kk) << (kk + 1)) | (mm & ((1 << kk) - 1));
        const int e0 = (u << (S + c)) | (m0 << c) | (bf & ((1 << c) - 1));
        const int e1 = e0 | (1 << (kk + c));
        const uint32_t w = tw[(u << S) + (1 << S) - (1 << (S - kk)) + (m0 >> (kk + 1))];
        const uint32_t x0 = v[e0], x1 = v[e1];
        if (kInverse) {
          v[e0] = add(x0, x1);
          v[e1] = mul(sub(x0, x1), w);
        } else {
          const uint32_t wx1 = mul(x1, w);
          v[e0] = add(x0, wx1);
          v[e1] = sub(x0, wx1);
        }
      }
      __syncthreads();
    }
    int64_t* dst = a.out + col * a.n_total;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = t + i * kThreads;
      if (e < n_el) dst[a.position(tile, e)] = a.scale ? mul(v[e], a.scale) : v[e];
    }
    __syncthreads();  // the next column's loads overwrite the tile
  }
}

template <bool kInverse, bool kTileTwiddles>
int launch(const Pass& p, cudaStream_t stream) {
  // columns share a block (and its staged twiddles) only once the tiles
  // alone fill the card
  const int64_t tiles = p.n_total >> (p.U + p.S + p.c);
  int64_t per_block = tiles * p.cols / kTargetBlocks;
  per_block = per_block < 1 ? 1 : per_block > kMaxColsPerBlock ? kMaxColsPerBlock : per_block;
  int64_t ys = (p.cols + per_block - 1) / per_block;
  if (ys > kMaxGridY) ys = kMaxGridY;
  fft_pass_kernel<kInverse, kTileTwiddles><<<dim3((unsigned)tiles, (unsigned)ys), kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

int trailing_zeros(int64_t x) {
  int n = 0;
  while (!((x >> n) & 1)) ++n;
  return n;
}

}  // namespace

// scalars: kScalars int64 (the Scalar positions above); ptrs: kPtrs device
// pointers (unused entries 0).  Launches the transform's passes on `stream`
// in order and writes their number to *passes; returns the first launch's
// error, or cudaErrorInvalidValue for a shape past the kernel's limits.
extern "C" int circle_fft(const int64_t* scalars, const int64_t* ptrs, void* stream, int64_t* passes) {
  *passes = 0;
  const int mode = (int)scalars[kMode];
  const int64_t cols = scalars[kCols], G = scalars[kSegments];
  const int b = (int)scalars[kLogSegment], n_sources = (int)scalars[kSources];
  if (mode < kInterpolate || mode > kTiles || b < 0 || b > kMaxLog || G < 1 || G > (1ll << (kMaxLog - b)) ||
      cols < 0 || n_sources < 1 || n_sources > kMaxSources || (mode == kInterpolate && G != 1) ||
      (mode != kTiles && (G & (G - 1)) != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  Pass p{};
  p.b = b;
  p.n_total = G << b;
  p.log_total = b + trailing_zeros(G);
  p.cols = cols;
  p.n_sources = n_sources;
  int64_t rows = 0;
  for (int k = 0; k < n_sources; ++k) {
    p.source[k] = (const int64_t*)ptrs[kSource + k];
    p.source_stride[k] = scalars[kSourceStride + k];
    rows += scalars[kSourceRows + k];
    p.source_end[k] = rows;
    if (scalars[kSourceRows + k] < 0 || (scalars[kSourceRows + k] > 0 && p.source[k] == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (rows != cols) return (int)cudaErrorInvalidValue;
  p.out = (int64_t*)ptrs[kOut];
  p.table = (const int32_t*)ptrs[kTable];
  p.bx = (const int64_t*)ptrs[kBx];
  p.by = (const int64_t*)ptrs[kBy];
  p.tx = (const int64_t*)ptrs[kTx];
  p.ty = (const int64_t*)ptrs[kTy];
  if (cols == 0) return 0;

  // the passes, in the order they run: an interpolation's contiguous pass
  // first, then strided passes up; an evaluation's strided passes from the
  // top down, then its contiguous pass.  The layers above the contiguous
  // pass's 12 are split evenly over as few strided passes as take at most 8
  // each; a strided tile's contiguous run fills the rest of its 2^12 words.
  int plan[kMaxLog + 1][4];  // (k0, S, c, U)
  int n = 0;
  const int S0 = b < kTileLog ? b : kTileLog;
  int U0 = kTileLog - S0;
  if (U0 > trailing_zeros(G)) U0 = trailing_zeros(G);
  const int strided = b - S0, n_strided = (strided + kStridedLayers - 1) / kStridedLayers;
  int layers[kMaxLog];
  for (int i = 0; i < n_strided; ++i) layers[i] = strided / n_strided + (i < strided % n_strided ? 1 : 0);
  if (mode == kInterpolate) {
    plan[n][0] = 0, plan[n][1] = S0, plan[n][2] = 0, plan[n][3] = U0, ++n;
    for (int i = 0, k0 = S0; i < n_strided; k0 += layers[i++]) {
      plan[n][0] = k0, plan[n][1] = layers[i], plan[n][2] = kTileLog - layers[i], plan[n][3] = 0, ++n;
    }
  } else {
    for (int i = 0, k_hi = b; i < n_strided; k_hi -= layers[i++]) {
      plan[n][0] = k_hi - layers[i], plan[n][1] = layers[i], plan[n][2] = kTileLog - layers[i], plan[n][3] = 0, ++n;
    }
    plan[n][0] = 0, plan[n][1] = S0, plan[n][2] = 0, plan[n][3] = U0, ++n;
  }
  for (int i = 0; i < n; ++i) {
    p.k0 = plan[i][0], p.S = plan[i][1], p.c = plan[i][2], p.U = plan[i][3];
    p.from_source = i == 0;
    p.scale = mode == kInterpolate && i == n - 1 ? (uint32_t)scalars[kScale] : 0u;
    const cudaStream_t s = (cudaStream_t)stream;
    const int err = mode == kInterpolate ? launch<true, false>(p, s)
                    : mode == kEvaluate  ? launch<false, false>(p, s)
                                         : launch<false, true>(p, s);
    if (err != 0) return err;
    ++*passes;
  }
  return 0;
}
