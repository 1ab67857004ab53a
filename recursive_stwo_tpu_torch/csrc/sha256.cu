// SHA-256 Merkle tree levels for Hopper (sm_90a), bound through a plain C
// interface (ops/build.py compiles this file with nvcc; ops/sha256_cuda.py
// loads it with ctypes).
//
// Replaces what XLA compiled on the TPU from recursive_stwo_tpu/core/sha256.py
// `_compress_traced` and `sha256_words`, reached from the JAX package's
// streamed prover (prover/stream.py:278-298): one level of a SHA-256 Merkle
// tree under the rules of verifier/sha256_merkle.py.  A leaf is
// sha256(col_0 || col_1 || ...), a node sha256(left || right), or
// sha256(left || right || col_0 || ...) where columns of its log size are
// merged in.  Words are big-endian uint32, so a message word is the
// schedule's W[i] as it stands; the padding is the word 0x80000000, zeros,
// and the 64-bit bit length as two words, in (K + 3 + 15) / 16 blocks for K
// message words.
//
// What bounds it on an H100: integer ALU work, narrowly.  One compression is
// 2,296 int32 operations as written below (48 schedule steps at 13, 64
// rounds at 26, 8 final adds): about 0.069 ns of issue on 132 SMs at 128
// lanes and 1.98 GHz.  A node reads 16 child words and writes 8, as int64
// 192 bytes, 0.057 ns at 3.35 TB/s; a leaf of 40 columns is three
// compressions (0.21 ns) against 384 bytes (0.11 ns).  So one thread
// computes one output node: its 8 state words and
// a 16-word rolling message schedule stay in registers through the 64
// unrolled rounds, the rotations are funnel shifts, and the message words
// are read in place, from the (2n, 8) children and the (n_cols, n) column
// tensor, as the schedule needs them; no padded copy of the message is ever
// built in memory.  Neighbouring threads read neighbouring column entries
// (coalesced); a thread's 16 child words are 128 contiguous bytes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One compression of the 16-word block w (overwritten by the rolling
// schedule: w[i & 15] holds W[i - 16] until step i replaces it with W[i]).
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t wi = w[i & 15];
    if (i >= 16) {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wi += s0 + w[(i - 7) & 15] + s1;
      w[i & 15] = wi;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + kRound[i] + wi;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// Thread `node` of n: message word j is child word j (j < n_child, 16 with
// children, else 0), then column j - n_child at this row, then the padding.
// Inputs are int64 residues and digest words in [0, 2^32); the low 32 bits
// are the word.  The output is (n, 8) int64 words in [0, 2^32).
__global__ void __launch_bounds__(kThreads)
sha256_level_kernel(const int64_t* __restrict__ children, const int64_t* __restrict__ cols,
                    int64_t col_stride, int n_cols, int64_t n, int64_t* __restrict__ out) {
  const int64_t node = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;
  const int n_child = children != nullptr ? 16 : 0;
  const int k = n_child + n_cols;
  const int n_words = 16 * ((k + 3 + 15) / 16);
  const int64_t* kids = children != nullptr ? children + node * 16 : nullptr;
  const int64_t* row = cols != nullptr ? cols + node : nullptr;
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = kInit[i];
  for (int base = 0; base < n_words; base += 16) {
    uint32_t w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int j = base + t;
      uint32_t v = 0;  // zero padding, and the bit length's high word (k < 2^27)
      if (j < n_child) {
        v = (uint32_t)kids[j];
      } else if (j < k) {
        v = (uint32_t)row[(int64_t)(j - n_child) * col_stride];
      } else if (j == k) {
        v = 0x80000000u;
      } else if (j == n_words - 1) {
        v = 32u * (uint32_t)k;
      }
      w[t] = v;
    }
    compress(st, w);
  }
  int64_t* dst = out + node * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = st[i];
}

}  // namespace

// children: (2n, 8) int64 or null; cols: n_cols rows of n int64 entries,
// row r at cols + r * col_stride, or null with n_cols 0; out: (n, 8) int64.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int sha256_level(const void* children, const void* cols, int64_t col_stride,
                            int64_t n_cols, int64_t n, void* out, void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  sha256_level_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)children, (const int64_t*)cols, col_stride, (int)n_cols, n, (int64_t*)out);
  return (int)cudaGetLastError();
}
