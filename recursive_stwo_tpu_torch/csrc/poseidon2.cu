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
// ops/poseidon_cuda.py picks one by N: the quad schedule below 2^15 rows,
// the tile schedule from there up.  Measured on an H100 SXM at 700 W
// (tools/kernel_times.py, profiler device time): quad 4.3 us against tile
// 10.0 us at 1024 rows, where a lane's chain of 22 rounds is the time; the
// two cross between 2^14 and 2^15 rows (8.3 / 11.2 us, 13.1 / 12.6 us);
// from 2^16 up the tile schedule wins by 11-25% (0.276 / 0.344 ms at 2^20,
// 2.04 / 2.72 ms at 2^23), since the quad lanes repeat word 0's S-box of
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

// ---------------------------------------------------------------------------
// The hash phase's scans: K2 and the jax.lax.scan around it
// (recursive_stwo_tpu/verifier/hashplan.py, absorb_packed :206 and walk_scan
// :427) in one launch per pass.  The host packs every walk (or column chain)
// into a few lanes of straight-line micro-ops, each one permutation; the
// op table (lanes, steps, kFields) int64 (verifier/hashplan.py builds it,
// ops/poseidon_cuda.py turns its source indices into pointers) holds per op
// the flags, the output slot and three descriptors that read the op's
// inputs in place: word w of slot n of an input is at
// ptr + n*stride_n + w*stride_w, and words at or past n_words read as 0
// (a (8, N) word-major digest, one level of (B, Q, depth, 8) sibling
// hashes, an 8-column chunk of a (B, Q, n_cols) chain), and the query bit is
// (queries[n*stride_n] >> level) & 1.  Step t of lane l does, for every
// slot n, what the reference's scan body does:
//   A = in_a if kAIn else carry_s
//   B = carry_b | in_a | in_b | carry_s (b_sel), or 0 if kStart
//   (left, right) = bit & kSwap ? (B, A) : (A, B)
//   kept = rate or capacity half of P(left || right)
//   carry_b = kept if kWriteB else carry_s = kept
//   out[slot][:, n] = carry_s, if the op has an output slot
// Lanes run blockIdx.y, slots blockIdx.x: a step's op is uniform across a
// block and only the query bit varies, as a select.  The carries stay in
// registers for all the steps; a lane's program ends at its first op
// without kActive.  What bounds it is the arithmetic, as for K1 and K2
// (128 + 64 or so bytes a permutation against 9.2k int32 operations); the
// scan adds nothing to it but the descriptors' uniform loads, and removes
// the per-step launches and the carries' round trips through memory.
//
// One thread to a slot.  Measured on an H100 SXM at 700 W
// (tools/kernel_times.py, profiler device time) it reaches 53-54% of the
// bound at the main path's 2^14 slots a lane and 56-58% from 2^17 up: at
// 4 x 2^14 slots one thread a slot already keeps the integer pipes busy.  A
// quad schedule (four lanes to a slot, as K1's) was slower from 2^14 up
// (43-48% of the bound), since its lanes repeat word 0's S-box and add
// shuffles; it won only below 2^14 slots, which no caller runs.
// ---------------------------------------------------------------------------

constexpr int kFields = 16;
constexpr int kFlags = 0, kOut = 1, kA = 2, kB = 7, kQ = 12;  // descriptor: ptr, (offset), sn, sw, nw
constexpr int64_t kAIn = 1, kWriteB = 8, kStart = 16, kSwap = 32, kActive = 64;
constexpr int kBSelShift = 1;  // 2 bits: 0 carry_b, 1 in_a, 2 in_b, 3 carry_s

struct Desc {
  const int64_t* ptr;
  int64_t sn, sw, nw;
};

__device__ __forceinline__ Desc desc_at(const int64_t* op, int f) {
  return Desc{reinterpret_cast<const int64_t*>(op[f]), op[f + 2], op[f + 3], op[f + 4]};
}

__device__ __forceinline__ uint32_t word_at(const Desc& d, int64_t n, int w) {
  return w < d.nw ? (uint32_t)d.ptr[n * d.sn + w * d.sw] : 0u;
}

__device__ __forceinline__ bool query_bit(const int64_t* op, int64_t n) {
  const int64_t* q = reinterpret_cast<const int64_t*>(op[kQ]);
  return (q[n * op[kQ + 2]] >> op[kQ + 3]) & 1;
}

// One thread to a slot: the 16 words of a state, both 8-word carries.
__global__ void __launch_bounds__(kThreads)
wordmajor_scan_kernel(const int64_t* __restrict__ ops, int64_t steps, int64_t n,
                      int keep_capacity, int64_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t* prog = ops + (int64_t)blockIdx.y * steps * kFields;
  uint32_t cs[8], cb[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) cs[w] = cb[w] = 0;
  for (int64_t t = 0; t < steps; ++t) {
    const int64_t* op = prog + t * kFields;
    const int64_t flags = op[kFlags];
    if (!(flags & kActive)) break;
    const int bsel = (int)(flags >> kBSelShift) & 3;
    uint32_t ia[8], ib[8];
    const Desc da = desc_at(op, kA), db = desc_at(op, kB);
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      ia[w] = ((flags & kAIn) || bsel == 1) ? word_at(da, i, w) : 0u;
      ib[w] = bsel == 2 ? word_at(db, i, w) : 0u;
    }
    const bool swap = (flags & kSwap) && query_bit(op, i);
    uint32_t s[16];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const uint32_t a = (flags & kAIn) ? ia[w] : cs[w];
      uint32_t b = bsel == 0 ? cb[w] : bsel == 1 ? ia[w] : bsel == 2 ? ib[w] : cs[w];
      b = (flags & kStart) ? 0u : b;
      s[w] = swap ? b : a;
      s[8 + w] = swap ? a : b;
    }
    poseidon2_m31_permute16(s);
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const uint32_t kept = keep_capacity ? s[8 + w] : s[w];
      if (flags & kWriteB) cb[w] = kept;
      else cs[w] = kept;
    }
    const int64_t slot = op[kOut];
    if (slot >= 0) {
      int64_t* dst = out + slot * 8 * n + i;
#pragma unroll
      for (int w = 0; w < 8; ++w) dst[w * n] = cs[w];
    }
  }
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

// ops: the (lanes, steps, 16) op table on the device, pointers resolved;
// out: (n_out, 8, n) int64, zeroed by the caller (a slot no op writes stays 0).
extern "C" int p2_wordmajor_scan(const void* ops, int64_t lanes, int64_t steps,
                                 int64_t n, int keep_capacity, void* out, void* stream) {
  if (lanes > 0 && steps > 0 && n > 0) {
    const dim3 grid(blocks_for(n), (unsigned int)lanes);
    wordmajor_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)ops, steps, n, keep_capacity, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}
