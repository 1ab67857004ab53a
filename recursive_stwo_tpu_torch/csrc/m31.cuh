// M31 (p = 2^31 - 1) arithmetic on canonical residues in registers, and the
// two linear layers of Poseidon2-16 (the external mds16 and the internal
// diagonal layer), shared by poseidon2.cuh, qm31.cuh, composition.cu,
// fold.cu and circle_fft.cu.
//
// The header holds no __constant__ data, so more than one translation unit
// may include it.  Every operation takes and gives canonical residues, and
// is written for a short dependent chain: a reduction is an unsigned minimum,
// not a compare and a select, and a product is one widening IMAD and one fold
// with 2^31 == 1 (mod p).
#pragma once

#include <cstdint>

namespace poseidon2_m31 {

constexpr uint32_t P = 0x7FFFFFFFu;

// a, b in [0, p): a + b < 2p <= 2^32 - 2, and of s and s - p (wrapping) the
// unsigned minimum is the residue.  Both sums issue together, so an add is
// two dependent steps deep.
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return min(s, s - P);
}

// a - b: of a - b and a - b + p (both wrapping) the unsigned minimum.
__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;
  return min(d, d + P);
}

__device__ __forceinline__ uint32_t neg(uint32_t a) { return a ? P - a : 0u; }

// a, b in [0, p): x = a b <= (p - 1)^2, so (x & p) + (x >> 31) <= p + (p - 2)
// < 2p, and one fold leaves a value add's minimum reduces.
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  const uint64_t x = (uint64_t)a * b;
  const uint32_t r = ((uint32_t)x & P) + (uint32_t)(x >> 31);
  return min(r, r - P);
}

// a^(p-2) by the addition chain of core/m31.py::inv; inv(0) = 0.
__device__ __forceinline__ uint32_t sqn(uint32_t a, int k) {
  for (int i = 0; i < k; ++i) a = mul(a, a);
  return a;
}

__device__ __forceinline__ uint32_t inv(uint32_t a) {
  const uint32_t t0 = mul(sqn(a, 2), a);
  const uint32_t t1 = mul(sqn(t0, 1), t0);
  const uint32_t t2 = mul(sqn(t1, 3), t0);
  const uint32_t t3 = mul(sqn(t2, 1), t0);
  const uint32_t t4 = mul(sqn(t3, 8), t3);
  const uint32_t t5 = mul(sqn(t4, 8), t3);
  return mul(sqn(t5, 7), t2);
}

// a * 2^k mod p for canonical a, 1 <= k <= 16: a 31-bit rotation.
__device__ __forceinline__ uint32_t mul_pow2(uint32_t a, int k) {
  return ((a << k) & P) + (a >> (31 - k));
}

__device__ __forceinline__ uint32_t pow5(uint32_t a) {
  uint32_t b = mul(a, a);
  return mul(mul(b, b), a);
}

// The external round matrix circ(2*M4, M4, M4, M4): per block of four words
// the outputs (t6, t5, t7, t4) of M4, then each word plus the sum of its
// position over the four blocks.
__device__ __forceinline__ void mds16(uint32_t s[16]) {
  uint32_t t[16];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint32_t x0 = s[4 * g], x1 = s[4 * g + 1], x2 = s[4 * g + 2], x3 = s[4 * g + 3];
    uint32_t t0 = add(x0, x1);
    uint32_t t1 = add(x2, x3);
    uint32_t t2 = add(add(x1, x1), t1);
    uint32_t t3 = add(add(x3, x3), t0);
    uint32_t t1d = add(t1, t1);
    uint32_t t0d = add(t0, t0);
    uint32_t t4 = add(add(t1d, t1d), t3);
    uint32_t t5 = add(add(t0d, t0d), t2);
    t[4 * g + 0] = add(t3, t5);
    t[4 * g + 1] = t5;
    t[4 * g + 2] = add(t2, t4);
    t[4 * g + 3] = t4;
  }
#pragma unroll
  for (int pos = 0; pos < 4; ++pos) {
    uint32_t sum = add(add(t[pos], t[4 + pos]), add(t[8 + pos], t[12 + pos]));
#pragma unroll
    for (int g = 0; g < 4; ++g) s[4 * g + pos] = add(t[4 * g + pos], sum);
  }
}

// The internal round matrix: the lane sum plus the diagonal
// [3, 2^2, ..., 2^16] (MAT_DIAG16_M_1), words 1..15 as 31-bit rotations.
__device__ __forceinline__ void internal16(uint32_t s[16]) {
  uint32_t total = s[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) total = add(total, s[i]);
  s[0] = add(total, add(add(s[0], s[0]), s[0]));
#pragma unroll
  for (int i = 1; i < 16; ++i) s[i] = add(total, mul_pow2(s[i], i + 1));
}

}  // namespace poseidon2_m31
