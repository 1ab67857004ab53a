// The OODS quotient's ("FRI answer's") line coefficients and denominator,
// shared by fold.cu (the verifier's quotients at its queries) and
// quotients.cu (the provers' first-layer quotients over a whole domain).
//
// Twin of verifier/quotients.py `fri_answers_for_group`: a sample batch
// (shift, trace log) of a group samples its columns at the OODS point
// shifted by the batch's point, (px, py) = (ox, oy) + (cx, cy); its k-th
// column (k counted from 0 over the group's columns in walk order, restarting
// each group) sampled at value v = v0 + v1 u has alpha = -2u rc^k and the
// line coefficients C = alpha y1, A = alpha v1, B = alpha (v0 y1 - v1 y0)
// with py = y0 + y1 u.  At a domain point (dx, dy) the batch's share is
// (sum of C val - (A dy + B)) / ((px.re - dx) py.im - (py.re - dy) px.im).
// The header holds no __constant__ data, so more than one translation unit
// may include it.
#pragma once

#include <cstdint>

#include "qm31.cuh"

namespace quotient {

using namespace qm31;

__device__ __forceinline__ Q load_q(const int64_t* p) {
  return Q{(uint32_t)p[0], (uint32_t)p[1], (uint32_t)p[2], (uint32_t)p[3]};
}

__device__ __forceinline__ void store_q(int64_t* p, Q v) {
  p[0] = v.a;
  p[1] = v.b;
  p[2] = v.c;
  p[3] = v.d;
}

// alpha_k = -2u rc^k for k = lane, lane + 32, ... below n, the lane's share
// of a warp's table: rc^lane by its index's bits, then steps of rc^32 (every
// lane taking each k from rc^0 would repeat the same squarings 32 times).
__device__ __forceinline__ void alpha_powers(Q rc, int lane, int n, Q* alpha) {
  const Q minus_2u = Q{0u, 0u, poseidon2_m31::P - 2u, 0u};
  Q p = q_one(), sq = rc;
#pragma unroll
  for (int bit = 0; bit < 5; ++bit) {
    if ((lane >> bit) & 1) p = q_mul(p, sq);
    sq = q_mul(sq, sq);
  }
  for (int k = lane; k < n; k += 32) {
    alpha[k] = q_mul(p, minus_2u);
    p = q_mul(p, sq);
  }
}

// The batch's sample point: the OODS point plus the batch's shift (cx, cy)
// (points.py add_constant_point; the identity (1, 0) for the OODS batch).
__device__ __forceinline__ void batch_point(Q ox, Q oy, uint32_t cx, uint32_t cy, Q& px, Q& py) {
  px = q_sub(q_mul_m31(ox, cx), q_mul_m31(oy, cy));
  py = q_add(q_mul_m31(ox, cy), q_mul_m31(oy, cx));
}

struct LineCoeffs {
  Q c, a, b;
};

// C, A and B of a column sampled at value sv in the batch whose point has y
// coordinate py, at its alpha.
__device__ __forceinline__ LineCoeffs line_coeffs(Q alpha, Q sv, Q py) {
  const C y0{py.a, py.b}, y1{py.c, py.d}, v0{sv.a, sv.b}, v1{sv.c, sv.d};
  return LineCoeffs{q_mul_cm31(alpha, y1), q_mul_cm31(alpha, v1), q_mul_cm31(alpha, c_sub(c_mul(v0, y1), c_mul(v1, y0)))};
}

// The batch's denominator at the domain point (dx, dy):
// (px.re - dx) py.im - (py.re - dy) px.im, a CM31.
__device__ __forceinline__ C denominator(Q px, Q py, uint32_t dx, uint32_t dy) {
  return c_sub(c_mul(C{sub(px.a, dx), px.b}, C{py.c, py.d}), c_mul(C{sub(py.a, dy), py.b}, C{px.c, px.d}));
}

}  // namespace quotient
