// The Poseidon31 channel's proof-of-work grind for Hopper (sm_90a), bound
// through a plain C interface (ops/build.py compiles this file with nvcc;
// ops/poseidon_cuda.py `p31_grind` loads it with ctypes).
//
// Replaces no Pallas kernel: it is the fused form of prover/channel.py
// `grind_device` (the twin of the JAX package's `_grind_batch_jit` /
// `grind_device`, which build 2^22 states a block in device memory, permute
// them on K1 and read the first hit back), and takes the place of the native
// host scan (native/poseidon31.cpp `poseidon2_grind`) below 22 bits.  It
// returns the smallest nonce n >= start whose absorption, the state
// (n mod 2^22, (n >> 22) mod 2^21, (n >> 43) mod 2^21, 0 x 5, digest[0..8])
// permuted, leaves word 8 with `pow_bits` low zero bits: the native scan's
// test and its nonce.
//
// What bounds it on an H100: int32 instruction throughput alone.  A nonce
// is one permutation, and nothing is read or written but a chunk counter
// and the result word.  So a nonce lives in registers, its limbs computed
// from the 64-bit nonce itself, and the work the answer cannot depend on is
// left out:
//   - the initial mds16: words 3-7 are 0 and words 8-15 the digest, kernel
//     arguments, so the M4 of the digest's two blocks and their sum are loop
//     invariants computed once a thread, block 1's M4 is 0, and block 0's
//     M4 folds its zero word (27 modular adds a nonce where mds16 has 84);
//   - only word 8 of the final mds16 is read, so the compiler keeps its four
//     position-0 M4 outputs and one sum (44 adds where mds16 has 84).
// The 4 + 14 + 4 rounds are poseidon2.cuh's `poseidon2_m31_rounds16`, the
// arithmetic of K1, the Merkle level kernel and the transcript.  That leaves
// 7,191 int32 operations a nonce (ops/poseidon_cuda.py
// GRIND_INT_OPS_PER_NONCE; 7,476 a permutation): 2^28 nonces in 57.7 ms at
// 132 SMs x 128 lanes x 1.98 GHz.
//
// Order, so that the smallest nonce wins (sha256_grind.cu's scheme): a
// persistent grid (as many blocks of kThreads as fit on each SM) claims
// chunks of kChunk nonces in increasing order from a device counter, and a
// hit does an atomicMin on the 64-bit result.  A block stops claiming once
// its next chunk starts at or above the result, so every chunk below the
// final result has been claimed and scanned to its end, in whatever order
// the blocks ran.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "poseidon2.cuh"

namespace {

using namespace poseidon2_m31;

constexpr int kThreads = 256;
constexpr uint64_t kChunk = 1u << 11;  // nonces a claim: 8 a thread
constexpr uint32_t kLimb0 = (1u << 22) - 1, kLimb = (1u << 21) - 1;

struct Digest {
  uint32_t w[8];
};

// mds16's M4 of one block: (t3 + t5, t5, t2 + t4, t4).
__device__ __forceinline__ void m4(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3, uint32_t t[4]) {
  const uint32_t t0 = add(x0, x1);
  const uint32_t t1 = add(x2, x3);
  const uint32_t t2 = add(add(x1, x1), t1);
  const uint32_t t3 = add(add(x3, x3), t0);
  const uint32_t t1d = add(t1, t1);
  const uint32_t t0d = add(t0, t0);
  const uint32_t t4 = add(add(t1d, t1d), t3);
  const uint32_t t5 = add(add(t0d, t0d), t2);
  t[0] = add(t3, t5);
  t[1] = t5;
  t[2] = add(t2, t4);
  t[3] = t4;
}

// mds16 of (l0, l1, l2, 0, 0, 0, 0, 0, digest): tail holds the digest
// blocks' M4 (words 8-15), inv[pos] = tail[pos] + tail[4 + pos].  Block 0's
// M4 with x3 = 0 has t1 = l2 and t3 = t0, both already canonical (l2 < 2^21);
// block 1's M4 is 0, so its words are the sums.
__device__ __forceinline__ void first_layer(uint32_t s[16], uint32_t l0, uint32_t l1, uint32_t l2,
                                            const uint32_t tail[8], const uint32_t inv[4]) {
  const uint32_t t0 = add(l0, l1);
  const uint32_t t2 = add(add(l1, l1), l2);
  const uint32_t t1d = add(l2, l2);
  const uint32_t t0d = add(t0, t0);
  const uint32_t t4 = add(add(t1d, t1d), t0);
  const uint32_t t5 = add(add(t0d, t0d), t2);
  const uint32_t b[4] = {add(t0, t5), t5, add(t2, t4), t4};
#pragma unroll
  for (int pos = 0; pos < 4; ++pos) {
    const uint32_t sum = add(b[pos], inv[pos]);
    s[pos] = add(b[pos], sum);
    s[4 + pos] = sum;
    s[8 + pos] = add(tail[pos], sum);
    s[12 + pos] = add(tail[4 + pos], sum);
  }
}

// state[0]: the chunk counter (0 at the launch); state[1]: the result
// (2^64 - 1 at the launch, which also reads as "no hit").  Every thread of a
// block scans nonces base + threadIdx.x + kThreads * k of its chunk in
// increasing order and stops at its first hit.
__global__ void __launch_bounds__(kThreads)
poseidon2_grind_kernel(Digest digest, uint32_t mask, uint64_t start, unsigned long long* __restrict__ state) {
  __shared__ uint64_t s_base;
  __shared__ int s_stop;
  unsigned long long* counter = state;
  unsigned long long* result = state + 1;
  uint32_t tail[8], inv[4];
  m4(digest.w[0], digest.w[1], digest.w[2], digest.w[3], tail);
  m4(digest.w[4], digest.w[5], digest.w[6], digest.w[7], tail + 4);
#pragma unroll
  for (int pos = 0; pos < 4; ++pos) inv[pos] = add(tail[pos], tail[4 + pos]);
  const uint64_t last_claim = (~0ull - start) / kChunk;  // base = start + c * kChunk stays below 2^64
  for (;;) {
    if (threadIdx.x == 0) {
      const uint64_t c = atomicAdd(counter, 1ull);
      const uint64_t base = start + c * kChunk;
      // a chunk at or above a hit, or past 2^64, holds no smaller nonce
      s_stop = c > last_claim || base >= *(volatile unsigned long long*)result;
      s_base = base;
    }
    __syncthreads();
    const uint64_t base = s_base;
    const int stop = s_stop;
    __syncthreads();
    if (stop) return;
#pragma unroll 1
    for (uint32_t j = threadIdx.x; j < kChunk; j += kThreads) {
      const uint64_t n = base + j;
      if (n < base) break;  // past 2^64
      uint32_t s[16];
      first_layer(s, (uint32_t)n & kLimb0, (uint32_t)(n >> 22) & kLimb, (uint32_t)(n >> 43) & kLimb, tail, inv);
      poseidon2_m31_rounds16(s);
      if ((s[8] & mask) == 0) {
        atomicMin(result, (unsigned long long)n);
        break;
      }
    }
  }
}

}  // namespace

// digest: the channel's 8 digest words (canonical M31 residues); mask: the
// low pow_bits bits; state: 2 x uint64 on the device, reset here on `stream`
// (the counter to 0, the result to 2^64 - 1), where the kernel then leaves
// the smallest hit.  The grid is as many blocks as fit on every SM at once.
// Returns the first CUDA error, else 0.
extern "C" int p2_grind(const uint32_t* digest, uint32_t mask, uint64_t start, void* state, void* stream) {
  Digest d;
  std::memcpy(d.w, digest, sizeof d.w);
  const cudaStream_t s = (cudaStream_t)stream;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, poseidon2_grind_kernel, kThreads, 0);
  if (err == cudaSuccess) err = cudaMemsetAsync(state, 0, 8, s);
  if (err == cudaSuccess) err = cudaMemsetAsync((char*)state + 8, 0xFF, 8, s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  poseidon2_grind_kernel<<<blocks, kThreads, 0, s>>>(d, mask, start, (unsigned long long*)state);
  return (int)cudaGetLastError();
}
