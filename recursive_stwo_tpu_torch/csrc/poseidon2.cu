// Poseidon2-16 kernels for Hopper (sm_90a), bound through a plain C interface
// (ops/build.py compiles this file with nvcc; ops/poseidon_cuda.py loads it
// with ctypes).  States are int64 tensors of canonical M31 residues, read and
// written in that dtype, so the PyTorch side needs no conversion pass.
//
// What bounds them on an H100: integer ALU work.  One permutation is 1,360
// modular adds, 142 x^5 S-boxes (426 widening multiplies) and 210 rotations,
// about 9.2k int32 operations, against 64 bytes of words in and 64 out
// (128 + 128 here, as int64): about 0.27 ns of issue per permutation on 132
// SMs at 128 lanes and 1.98 GHz, against 0.08 ns of memory at 3.35 TB/s, so
// both kernels are compute bound.  Every schedule keeps a state's words in
// registers through all 22 unrolled rounds and touches no device memory
// between its load and its store.  A tail of N not divisible by the block
// size is masked, never padded.

#include <cstdint>

#include <cuda_runtime.h>

#include "poseidon2.cuh"

namespace {

constexpr int kThreads = 128;

// K1, the twin of recursive_stwo_tpu/ops/poseidon_pallas.py::_kernel (entered
// through permute / permute_lane_major).  The TPU kernel wants states
// lane-major in (16, R, 128) tiles; here a state is a row of 16 words,
// (N, 16) row-major, the layout the transcript and the Merkle commits hand
// over, so there is no transpose.  Two schedules of the same arithmetic;
// ops/poseidon_cuda.py picks one by N: the quad schedule below 2^16 rows,
// the tile schedule from there up.  Measured on an H100 SXM at 700 W
// (tools/kernel_times.py, profiler device time): quad 7.2 us against tile
// 23.4 us at 1024 rows, where a lane's chain of 22 rounds is the time; the
// two cross between 2^15 and 2^16 rows (21.5 / 26.7 us, 37.9 / 36.6 us);
// from 2^17 up the tile schedule wins by 14-22% (0.435 / 0.532 ms at 2^20,
// 3.26 / 4.19 ms at 2^23), since the quad lanes repeat word 0's S-box of
// every partial round and add 8 shuffles to each mds16.
//
// Quad schedule: four lanes to a state.  Lane q of a quad holds words
// 4q..4q+3 (one M4 block of mds16) and reads and writes bytes [32q, 32q+32)
// of its row as two 16-byte accesses, so a warp covers 8 consecutive rows,
// 1 KB contiguous: coalesced with no shared memory.  A state's dependency
// chain is a quarter as long (4 S-boxes a lane per full round) and a small
// N fills four times the blocks.  The full rounds' constants differ between
// the four lanes, which __constant__ memory would serialise, so the block
// stages them in shared memory.  Lanes past N load nothing and store
// nothing but still run every round: each xor-shuffle needs the full warp.
__global__ void __launch_bounds__(kThreads)
permute_rows_quad_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                         int64_t n) {
  using namespace poseidon2_m31;
  __shared__ uint4 rc_full[8][4];
  if (threadIdx.x < 32) {
    const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
    const uint32_t* rc = r < 4 ? FIRST_FOUR_ROUND_RC[r] : LAST_FOUR_ROUNDS_RC[r - 4];
    rc_full[r][q] = make_uint4(rc[4 * q], rc[4 * q + 1], rc[4 * q + 2], rc[4 * q + 3]);
  }
  __syncthreads();
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int q = threadIdx.x & 3;
  const bool live = row < n;
  uint32_t s[4] = {0, 0, 0, 0};
  if (live) {
    const longlong2* src = reinterpret_cast<const longlong2*>(in + row * 16 + 4 * q);
    const longlong2 a = src[0], b = src[1];
    s[0] = (uint32_t)a.x;
    s[1] = (uint32_t)a.y;
    s[2] = (uint32_t)b.x;
    s[3] = (uint32_t)b.y;
  }
  poseidon2_m31_permute_quad(s, q, rc_full);
  if (live) {
    longlong2* dst = reinterpret_cast<longlong2*>(out + row * 16 + 4 * q);
    dst[0] = make_longlong2(s[0], s[1]);
    dst[1] = make_longlong2(s[2], s[3]);
  }
}

// Tile schedule: one thread to a state, as in the first K1, but the block's
// kThreads rows (a contiguous 16 KB of int64) come in and go out through
// shared memory with coalesced 16-byte accesses, as uint32 words in rows
// padded to 17 so that the threads' row reads fall in distinct banks.
constexpr int kTileStride = 17;

__global__ void __launch_bounds__(kThreads)
permute_rows_tile_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                         int64_t n) {
  __shared__ uint32_t tile[kThreads * kTileStride];
  const int64_t row0 = (int64_t)blockIdx.x * kThreads;
  const int64_t left = n - row0;
  const int rows = left < kThreads ? (int)left : kThreads;
  const longlong2* src = reinterpret_cast<const longlong2*>(in + row0 * 16);
  for (int c = threadIdx.x; c < rows * 8; c += kThreads) {
    const longlong2 v = src[c];
    uint32_t* t = tile + (c >> 3) * kTileStride + (c & 7) * 2;
    t[0] = (uint32_t)v.x;
    t[1] = (uint32_t)v.y;
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    uint32_t* t = tile + threadIdx.x * kTileStride;
    uint32_t s[16];
#pragma unroll
    for (int w = 0; w < 16; ++w) s[w] = t[w];
    poseidon2_m31_permute16(s);
#pragma unroll
    for (int w = 0; w < 16; ++w) t[w] = s[w];
  }
  __syncthreads();
  longlong2* dst = reinterpret_cast<longlong2*>(out + row0 * 16);
  for (int c = threadIdx.x; c < rows * 8; c += kThreads) {
    const uint32_t* t = tile + (c >> 3) * kTileStride + (c & 7) * 2;
    dst[c] = make_longlong2(t[0], t[1]);
  }
}

// Twin of recursive_stwo_tpu/ops/poseidon_pallas.py::_kernel4 (K2, entered
// through permute_state4).  The TPU kernel runs a grid (L, R/r_blk) over
// (L, 16, R, 128) lane-major tiles.  Here the states are word-major
// (L, 16, N): word w of state (l, n) is at l*16*N + w*N + n, so the 32
// threads of a warp read 32 neighbouring int64s for every word.
__global__ void permute_wordmajor_kernel(const int64_t* __restrict__ in,
                                         int64_t* __restrict__ out,
                                         int64_t n_lanes, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes * n) return;
  int64_t l = i / n;
  int64_t base = l * 16 * n + (i - l * n);
  uint32_t s[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) s[w] = (uint32_t)in[base + w * n];
  poseidon2_m31_permute16(s);
#pragma unroll
  for (int w = 0; w < 16; ++w) out[base + w * n] = (int64_t)s[w];
}

unsigned int blocks_for(int64_t states) {
  return (unsigned int)((states + kThreads - 1) / kThreads);
}

}  // namespace

// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success) for the caller to check.
// The row kernels read and write 16-byte vectors: in and out must be 16-byte
// aligned (the wrapper checks).
extern "C" int p2_permute_rows_quad(const void* in, void* out, int64_t n,
                                    void* stream) {
  if (n > 0) {
    permute_rows_quad_kernel<<<blocks_for(4 * n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)in, (int64_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int p2_permute_rows_tile(const void* in, void* out, int64_t n,
                                    void* stream) {
  if (n > 0) {
    permute_rows_tile_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)in, (int64_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int p2_permute_wordmajor(const void* in, void* out, int64_t n_lanes,
                                    int64_t n, void* stream) {
  if (n_lanes * n > 0) {
    permute_wordmajor_kernel<<<blocks_for(n_lanes * n), kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const int64_t*)in, (int64_t*)out, n_lanes, n);
  }
  return (int)cudaGetLastError();
}
