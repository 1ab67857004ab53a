// Poseidon2-16 permutation over M31 (p = 2^31 - 1), one state in registers.
//
// Bit-exact twin of recursive_stwo_tpu/ops/poseidon_pallas.py::_kernel and of
// recursive_stwo_tpu/core/poseidon2.py::permute: initial MDS16, 4 full rounds,
// 14 partial rounds (x^5 on word 0, then the lane sum plus the diagonal
// [3, 2^2, ..., 2^16], words 1..15 as 31-bit rotations), 4 full rounds.
//
// The TPU kernel splits every product into 16-bit limbs because the TPU
// vector unit has no 32x32->64 multiply.  Here a product is one widening
// IMAD and one fold with 2^31 == 1 (mod p) (m31.cuh, which also holds the
// linear layers).
#pragma once

#include <cstdint>

#include "m31.cuh"

namespace poseidon2_m31 {

// Round constants, the same tables as FIRST_FOUR_ROUND_RC, PARTIAL_ROUNDS_RC
// and LAST_FOUR_ROUNDS_RC in recursive_stwo_tpu/core/poseidon2.py (a CPU test
// parses these three initialisers and compares them with the reference).
// `static`: each translation unit that includes this header (poseidon2.cu,
// transcript.cu) holds its own copy, so the host-side symbols do not clash.
static __constant__ uint32_t FIRST_FOUR_ROUND_RC[4][16] = {
    {0x768bab52, 0x70e0ab7d, 0x3d266c8a, 0x6da42045, 0x600fef22, 0x41dace6b,
     0x64f9bdd4, 0x5d42d4fe, 0x76b1516d, 0x6fc9a717, 0x70ac4fb6, 0x00194ef6,
     0x22b644e2, 0x1f7916d5, 0x47581be2, 0x2710a123},
    {0x6284e867, 0x018d3afe, 0x5df99ef3, 0x4c1e467b, 0x566f6abc, 0x2994e427,
     0x538a6d42, 0x5d7bf2cf, 0x7fda2dab, 0x0fd854c4, 0x46922fca, 0x3d7763a1,
     0x19fd05ca, 0x0a4bbb43, 0x15075851, 0x3d903d76},
    {0x2d290ff7, 0x40809fa0, 0x59dac6ec, 0x127927a2, 0x6bbf0ea0, 0x0294140f,
     0x24742976, 0x6e84c081, 0x22484f4a, 0x354cae59, 0x0453ffe1, 0x3f47a3cc,
     0x0088204e, 0x6066e109, 0x3b7c4b80, 0x6b55665d},
    {0x3bc4b897, 0x735bf378, 0x508daf42, 0x1884fc2b, 0x7214f24c, 0x7498be0a,
     0x1a60e640, 0x3303f928, 0x29b46376, 0x5c96bb68, 0x65d097a5, 0x1d358e9f,
     0x4a9a9017, 0x4724cf76, 0x347af70f, 0x1e77e59a},
};

static __constant__ uint32_t PARTIAL_ROUNDS_RC[14] = {
    0x7f7ec4bf, 0x0421926f, 0x5198e669, 0x34db3148, 0x4368bafd, 0x66685c7f,
    0x78d3249a, 0x60187881, 0x76dad67a, 0x0690b437, 0x1ea95311, 0x40e5369a,
    0x38f103fc, 0x1d226a21,
};

static __constant__ uint32_t LAST_FOUR_ROUNDS_RC[4][16] = {
    {0x57090613, 0x1fa42108, 0x17bbef50, 0x1ff7e11c, 0x047b24ca, 0x4e140275,
     0x4fa086f5, 0x079b309c, 0x1159bd47, 0x6d37e4e5, 0x075d8dce, 0x12121ca0,
     0x7f6a7c40, 0x68e182ba, 0x5493201b, 0x0444a80e},
    {0x0064f4c6, 0x6467abe6, 0x66975762, 0x2af68f9b, 0x345b33be, 0x1b70d47f,
     0x053db717, 0x381189cb, 0x43b915f8, 0x20df3694, 0x0f459d26, 0x77a0e97b,
     0x2f73e739, 0x1876c2f9, 0x65a0e29a, 0x4cabefbe},
    {0x5abd1268, 0x4d34a760, 0x12771799, 0x69a0c9ac, 0x39091e55, 0x7f611cd0,
     0x3af055da, 0x7ac0bbdf, 0x6e0f3a24, 0x41e3b6f7, 0x49b3756d, 0x568bc538,
     0x20c079d8, 0x1701c72c, 0x7670dc6c, 0x5a439035},
    {0x7c93e00e, 0x561fbb4d, 0x1178907b, 0x02737406, 0x32fb24f1, 0x6323b60a,
     0x6ab12418, 0x42c99cea, 0x155a0b97, 0x53d1c6aa, 0x2bd20347, 0x279b3d73,
     0x4f5f3c70, 0x0245af6c, 0x238359d3, 0x49966a59},
};

__device__ __forceinline__ void full_round(uint32_t s[16], const uint32_t rc[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = pow5(add(s[i], rc[i]));
  mds16(s);
}

__device__ __forceinline__ void partial_round(uint32_t s[16], uint32_t rc) {
  s[0] = pow5(add(s[0], rc));
  internal16(s);
}

// ---------------------------------------------------------------------------
// Quad form: one state spread over four neighbouring lanes of a warp (lanes
// 4k..4k+3, so the quad index q is lane & 3).  Lane q holds words 4q..4q+3,
// which is exactly block q of mds16's circ(2*M4, M4, M4, M4).  A sum over the
// four blocks is two xor-shuffles; every lane of the warp must take part.
// It is written for a short critical path, since K1's quad schedule and the
// transcript kernel's chain both wait on one state's rounds.  The partial
// rounds keep word 0 replicated on all four lanes: each lane computes the
// real S-box while the quad sums the other fifteen words, and since word 0
// after a round is total + 3 y = S15 + 4 y, the next S-box's input is
// (S15 + rc) + 4 y, one rotation and one add after the S-box.
// ---------------------------------------------------------------------------

// Sum of v over the four lanes of this lane's quad, the same on all four.
__device__ __forceinline__ uint32_t quad_sum(uint32_t v) {
  v = add(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1));
  return add(v, __shfl_xor_sync(0xFFFFFFFFu, v, 2));
}

// mds16 on the quad: the M4 of this lane's block locally (mds16's first
// loop for g = q), then t[g][pos] + sum over g' of t[g'][pos].
__device__ __forceinline__ void quad_mds16(uint32_t s[4]) {
  const uint32_t x0 = s[0], x1 = s[1], x2 = s[2], x3 = s[3];
  const uint32_t t0 = add(x0, x1);
  const uint32_t t1 = add(x2, x3);
  const uint32_t t2 = add(add(x1, x1), t1);
  const uint32_t t3 = add(add(x3, x3), t0);
  const uint32_t t4 = add(mul_pow2(t1, 2), t3);  // 4 t1 + t3
  const uint32_t t5 = add(mul_pow2(t0, 2), t2);
  const uint32_t t[4] = {add(t3, t5), t5, add(t2, t4), t4};
#pragma unroll
  for (int pos = 0; pos < 4; ++pos) s[pos] = add(t[pos], quad_sum(t[pos]));
}

// rc: this lane's four round constants, words 4q..4q+3 of the round.
__device__ __forceinline__ void quad_full_round(uint32_t s[4], uint4 rc) {
  s[0] = pow5(add(s[0], rc.x));
  s[1] = pow5(add(s[1], rc.y));
  s[2] = pow5(add(s[2], rc.z));
  s[3] = pow5(add(s[3], rc.w));
  quad_mds16(s);
}

// The 14 partial rounds.  w0, word 0, on every lane of the quad; lane q's
// own word 4q + k takes total + its rotation by 4q + k + 1 (lane 0's k = 0
// slot is word 0's and is set from w0 at the end).
__device__ __forceinline__ void quad_partial_rounds(uint32_t s[4], int q) {
  uint32_t w0 = __shfl_sync(0xFFFFFFFFu, s[0], 0, 4);
  uint32_t x = add(w0, PARTIAL_ROUNDS_RC[0]);
#pragma unroll
  for (int r = 0; r < 14; ++r) {
    const uint32_t y = pow5(x);
    // the other fifteen words, summed while the S-box runs
    const uint32_t own0 = q == 0 ? 0u : s[0];
    const uint32_t s15 = quad_sum(add(add(s[1], s[2]), add(s[3], own0)));
    const uint32_t total = add(s15, y);
    const uint32_t y4 = mul_pow2(y, 2);
    w0 = add(s15, y4);
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = add(total, mul_pow2(s[k], 4 * q + k + 1));
    if (r < 13) x = add(add(s15, PARTIAL_ROUNDS_RC[r + 1]), y4);
  }
  if (q == 0) s[0] = w0;
}

}  // namespace poseidon2_m31

// The whole permutation on one state held by a quad of lanes: lane q gives
// and gets words 4q..4q+3.  rc_full[r][q] are lane q's constants of full
// round r (the four first rounds, then the four last).
__device__ __forceinline__ void poseidon2_m31_permute_quad(uint32_t s[4], int q, const uint4 (*rc_full)[4]) {
  using namespace poseidon2_m31;
  quad_mds16(s);
#pragma unroll
  for (int r = 0; r < 4; ++r) quad_full_round(s, rc_full[r][q]);
  quad_partial_rounds(s, q);
#pragma unroll
  for (int r = 4; r < 8; ++r) quad_full_round(s, rc_full[r][q]);
}

// The permutation after its initial mds16: the 4 + 14 + 4 rounds, on 16
// canonical words held in registers (poseidon2_grind.cu builds the initial
// layer itself).
__device__ __forceinline__ void poseidon2_m31_rounds16(uint32_t s[16]) {
  using namespace poseidon2_m31;
#pragma unroll
  for (int r = 0; r < 4; ++r) full_round(s, FIRST_FOUR_ROUND_RC[r]);
#pragma unroll
  for (int r = 0; r < 14; ++r) partial_round(s, PARTIAL_ROUNDS_RC[r]);
#pragma unroll
  for (int r = 0; r < 4; ++r) full_round(s, LAST_FOUR_ROUNDS_RC[r]);
}

// The whole permutation on 16 canonical words held in registers.
__device__ __forceinline__ void poseidon2_m31_permute16(uint32_t s[16]) {
  poseidon2_m31::mds16(s);
  poseidon2_m31_rounds16(s);
}
