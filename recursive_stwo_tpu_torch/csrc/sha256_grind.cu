// The SHA-256 channel's proof-of-work grind for Hopper (sm_90a), bound
// through a plain C interface (ops/build.py compiles this file with nvcc;
// ops/sha256_cuda.py `sha256_grind` loads it with ctypes).
//
// Replaces no TPU kernel: the JAX package grinds this PoW on the host
// (recursive_stwo_tpu/prover/prove_sha256.py `grind_pow`, on
// native/sha256.cpp's AVX-512 scan `sha256_grind`), and so did the port.  It
// returns the smallest nonce n >= start whose mix into the channel,
// sha256(le8(n) || 24 zero bytes || digest), leaves `pow_bits` trailing zero
// bits in the little-endian reading of the new digest's first word
// (verifier/sha256_channel.py `trailing_zeros`), the nonce the host scan
// returns.
//
// What bounds it on an H100: integer ALU work alone.  A nonce is two
// compressions, and nothing is read or written but a chunk counter and the
// result word.  So a nonce lives in registers, and the work the answer
// cannot depend on is left out:
//   - the first block is W0 = bswap(lo32(n)), W1 = bswap(hi32(n)), W2-W7 = 0
//     and W8-W15 the digest's eight big-endian words, kernel arguments: the
//     zeros fold away, and the terms of the schedule and of rounds 8-15 that
//     hold only digest words are loop invariants, which the compiler hoists
//     out of the nonce loop (the schedule's sums are grouped so that they
//     are);
//   - the second block is the constant padding (W0 = 0x80000000, W15 = 512),
//     so its schedule is gone and K + W is one constant a round (kPadKW);
//   - only the final state's word 0 is read, so the last round computes `a`
//     alone and the other seven final additions are gone.
// That leaves 3,768 int32 operations a nonce (ops/sha256_cuda.py
// GRIND_INT_OPS_PER_NONCE; 4,592 for two of csrc/sha256.cu's general
// compressions): 2^28 nonces in 30.2 ms at 132 SMs x 128 lanes x 1.98 GHz.
// A nonce hits when (bswap(H[0] + a) & mask) == 0, native/sha256.cpp's test.
//
// Order, so that the smallest nonce wins: a persistent grid (as many blocks
// of kThreads as fit on each SM) claims chunks of kChunk nonces in increasing
// order from a device counter, and a hit does an atomicMin on the 64-bit
// result.  A block stops claiming once its next chunk starts at or above the
// result, so every chunk below the final result has been claimed and scanned
// to its end, in whatever order the blocks ran.  Nonces are 64-bit: the high
// word comes from each nonce, so a chunk that crosses 2^32 is exact.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kChunk = 1u << 13;  // nonces a claim: 32 a thread

__constant__ uint32_t kRound[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
};

__constant__ uint32_t kInit[8] = {
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
};

// K[i] + W[i] of the padding block's message schedule, mod 2^32
__constant__ uint32_t kPadKW[64] = {
    0xC28A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF374, 0x649B69C1, 0xF0FE4786,
    0x0FE1EDC6, 0x240CF254, 0x4FE9346F, 0x6CC984BE, 0x61B9411E, 0x16F988FA,
    0xF2C65152, 0xA88E5A6D, 0xB019FC65, 0xB9D99EC7, 0x9A1231C3, 0xE70EEAA0,
    0xFDB1232B, 0xC7353EB0, 0x3069BAD5, 0xCB976D5F, 0x5A0F118F, 0xDC1EEEFD,
    0x0A35B689, 0xDE0B7A04, 0x58F4CA9D, 0xE15D5B16, 0x007F3E86, 0x37088980,
    0xA507EA32, 0x6FAB9537, 0x17406110, 0x0D8CD6F1, 0xCDAA3B6D, 0xC0BBBE37,
    0x83613BDA, 0xDB48A363, 0x0B02E931, 0x6FD15CA7, 0x521AFACA, 0x31338431,
    0x6ED41A95, 0x6D437890, 0xC39C91F2, 0x9ECCABBD, 0xB5C9A0E6, 0x532FB63C,
    0xD2C741C6, 0x07237EA3, 0xA4954B68, 0x4C191D76,
};

struct Digest {
  uint32_t w[8];
};

// Written as shifts, so that a rotation of a literal folds away; the
// compiler emits one funnel shift for each.
__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }
__device__ __forceinline__ uint32_t big_sigma0(uint32_t a) { return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22); }
__device__ __forceinline__ uint32_t big_sigma1(uint32_t e) { return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25); }
__device__ __forceinline__ uint32_t sigma0(uint32_t w) { return rotr(w, 7) ^ rotr(w, 18) ^ (w >> 3); }
__device__ __forceinline__ uint32_t sigma1(uint32_t w) { return rotr(w, 17) ^ rotr(w, 19) ^ (w >> 10); }
__device__ __forceinline__ uint32_t ch(uint32_t e, uint32_t f, uint32_t g) { return (e & f) ^ (~e & g); }
__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) { return (a & b) ^ (a & c) ^ (b & c); }
__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// One round on s = (a, b, c, d, e, f, g, h); kw = K[i] + W[i].
__device__ __forceinline__ void sha_round(uint32_t s[8], uint32_t kw) {
  const uint32_t t1 = s[7] + big_sigma1(s[4]) + ch(s[4], s[5], s[6]) + kw;
  const uint32_t t2 = big_sigma0(s[0]) + maj(s[0], s[1], s[2]);
  s[7] = s[6];
  s[6] = s[5];
  s[5] = s[4];
  s[4] = s[3] + t1;
  s[3] = s[2];
  s[2] = s[1];
  s[1] = s[0];
  s[0] = t1 + t2;
}

// The first block, le8(n) || 24 zero bytes || digest, compressed from H0:
// the chaining state in h.  The schedule is rolling (w[i & 15] holds W[i - 16]
// until step i replaces it) and each step sums (sigma1(W[i-2]) + W[i-7]) +
// (sigma0(W[i-15]) + W[i-16]), so that a pair of digest-only terms is one
// loop invariant.
__device__ __forceinline__ void first_block(uint32_t h[8], uint32_t w0, uint32_t w1, const Digest& d) {
  uint32_t w[16] = {w0, w1, 0, 0, 0, 0, 0, 0, d.w[0], d.w[1], d.w[2], d.w[3], d.w[4], d.w[5], d.w[6], d.w[7]};
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = kInit[i];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      w[i & 15] = (sigma1(w[(i - 2) & 15]) + w[(i - 7) & 15]) + (sigma0(w[(i - 15) & 15]) + w[i & 15]);
    }
    sha_round(s, kRound[i] + w[i & 15]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = kInit[i] + s[i];
}

// Word 0 of the digest: the padding block compressed from h, its last round
// computing `a` alone.
__device__ __forceinline__ uint32_t second_block_word0(const uint32_t h[8]) {
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = h[i];
#pragma unroll
  for (int i = 0; i < 63; ++i) sha_round(s, kPadKW[i]);
  const uint32_t t1 = s[7] + big_sigma1(s[4]) + ch(s[4], s[5], s[6]) + kPadKW[63];
  return h[0] + t1 + big_sigma0(s[0]) + maj(s[0], s[1], s[2]);
}

// state[0]: the chunk counter (0 at the launch); state[1]: the result
// (2^64 - 1 at the launch, which also reads as "no hit").  Every thread of a
// block scans nonces base + threadIdx.x + kThreads * k of its chunk in
// increasing order and stops at its first hit.
__global__ void __launch_bounds__(kThreads)
sha256_grind_kernel(Digest digest, uint32_t mask, uint64_t start, unsigned long long* __restrict__ state) {
  __shared__ uint64_t s_base;
  __shared__ int s_stop;
  unsigned long long* counter = state;
  unsigned long long* result = state + 1;
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
      uint32_t h[8];
      first_block(h, bswap((uint32_t)n), bswap((uint32_t)(n >> 32)), digest);
      if ((bswap(second_block_word0(h)) & mask) == 0) {
        atomicMin(result, (unsigned long long)n);
        break;
      }
    }
  }
}

}  // namespace

// digest: 8 host words; mask: the low pow_bits bits; state: 2 x uint64 on the
// device, reset here on `stream` (the counter to 0, the result to 2^64 - 1),
// where the kernel then leaves the smallest hit.  The grid is as many blocks
// as fit on every SM at once.  Returns the first CUDA error, else 0.
extern "C" int sha256_grind(const uint32_t* digest, uint32_t mask, uint64_t start, void* state, void* stream) {
  Digest d;
  std::memcpy(d.w, digest, sizeof d.w);
  const cudaStream_t s = (cudaStream_t)stream;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sha256_grind_kernel, kThreads, 0);
  if (err == cudaSuccess) err = cudaMemsetAsync(state, 0, 8, s);
  if (err == cudaSuccess) err = cudaMemsetAsync((char*)state + 8, 0xFF, 8, s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  sha256_grind_kernel<<<blocks, kThreads, 0, s>>>(d, mask, start, (unsigned long long*)state);
  return (int)cudaGetLastError();
}
