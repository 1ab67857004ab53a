// One level of the provers' Poseidon31 Merkle trees, for Hopper (sm_90a),
// bound through a plain C interface (ops/build.py compiles this file with
// nvcc; ops/merkle_cuda.py loads it with ctypes).
//
// Replaces what XLA compiled on the TPU from
// recursive_stwo_tpu/prover/device_prove.py `_absorb_columns` (:49-63) and
// `_commit_levels` (:66-87), and the Poseidon31 flavour of
// recursive_stwo_tpu/prover/stream.py `_commit_chunk_jit` (:252-333): the
// reference's K1 calls (ops/poseidon_pallas.py::_kernel) on (n, 16) states
// built from the columns.  Hash semantics are commit_host._hash_leaf_level /
// _hash_node_level's:
//   leaf:  absorb the n_cols columns 8 a permutation into an 8-word digest
//          (the last chunk zero-padded), then h = P([0; digest])[:8];
//   node:  h = P(left child || right child)[:8], then, if columns of this
//          size are merged in, absorb them and h = P([h; digest])[:8].
// A chunk's permutation is P([chunk; digest]) and keeps its capacity half,
// [8:], as the next digest.
//
// One thread a node, the whole state in registers from the first
// permutation to the last: a node's permutations are one loop over steps
// (the child pair, each 8-column chunk, the final [h; digest]) around one
// copy of csrc/poseidon2.cuh's poseidon2_m31_permute16, K1's tile-schedule
// arithmetic.  The quad form (four lanes a state) repeats word 0's S-box on
// every lane and adds shuffles to each mds16; K1 measured it slower from
// 2^15 states up, and a level's cost is at its leaves, 2^20 and more.  The
// columns are read in place, (n_cols, n) int64 of any row stride (a
// streamed tree's chunk is a view), word j of a column at thread j:
// neighbouring threads, neighbouring addresses.  A child pair is one
// thread's 128 contiguous bytes, read as 16-byte vectors; the digest goes out
// as 64.  There is no (n, 16) state in device memory and no blocking of rows.
//
// What bounds it on an H100: integer ALU work, 7,476 int32 operations a
// permutation (ops/poseidon_cuda.py) against 8 bytes a column word, 128 a
// child pair and 64 a digest (ops/merkle_cuda.py counts both).

#include <cstdint>

#include <cuda_runtime.h>

#include "poseidon2.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
merkle_level_kernel(const int64_t* __restrict__ children, const int64_t* __restrict__ cols, int64_t n_cols,
                    int64_t col_stride, int64_t* __restrict__ out, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const bool node = children != nullptr;
  const bool absorb = !node || n_cols > 0;
  const int64_t chunks = absorb ? (n_cols + 7) / 8 : 0;
  // steps: the child pair (nodes), the chunks, the final [h or 0; digest]
  const int64_t first_chunk = node ? 1 : 0;
  const int64_t steps = first_chunk + (absorb ? chunks + 1 : 0);
  uint32_t s[16], h[8];
#pragma unroll
  for (int w = 0; w < 16; ++w) s[w] = 0u;
#pragma unroll
  for (int w = 0; w < 8; ++w) h[w] = 0u;
  for (int64_t t = 0; t < steps; ++t) {
    if (node && t == 0) {
      const longlong2* src = reinterpret_cast<const longlong2*>(children + j * 16);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const longlong2 v = src[w];
        s[2 * w] = (uint32_t)v.x;
        s[2 * w + 1] = (uint32_t)v.y;
      }
    } else if (t - first_chunk < chunks) {
      const int64_t c0 = (t - first_chunk) * 8;
      if (t == first_chunk) {
#pragma unroll
        for (int w = 8; w < 16; ++w) s[w] = 0u;  // the digest starts at zero
      }
#pragma unroll
      for (int w = 0; w < 8; ++w) s[w] = c0 + w < n_cols ? (uint32_t)cols[(c0 + w) * col_stride + j] : 0u;
    } else {
      if (chunks == 0) {
#pragma unroll
        for (int w = 8; w < 16; ++w) s[w] = 0u;  // a leaf without columns: digest zero
      }
#pragma unroll
      for (int w = 0; w < 8; ++w) s[w] = h[w];
    }
    poseidon2_m31_permute16(s);
    if (node && t == 0) {
#pragma unroll
      for (int w = 0; w < 8; ++w) h[w] = s[w];
    }
  }
  longlong2* dst = reinterpret_cast<longlong2*>(out + j * 8);
#pragma unroll
  for (int w = 0; w < 4; ++w) dst[w] = make_longlong2(s[2 * w], s[2 * w + 1]);
}

}  // namespace

// children: (2n, 8) int64 child digests, contiguous and 16-byte aligned, or
// null at the leaf level; cols: (n_cols, n) int64, column c's word j at
// c * col_stride + j, or null (n_cols 0); out: (n, 8) int64, contiguous and
// 16-byte aligned, written.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int merkle_level(const void* children, const void* cols, int64_t n_cols, int64_t col_stride, void* out,
                            int64_t n, void* stream) {
  if (n < 1 || n_cols < 0 || (n_cols > 0 && !cols)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  merkle_level_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)children, (const int64_t*)cols, n_cols, col_stride, (int64_t*)out, n);
  return (int)cudaGetLastError();
}
