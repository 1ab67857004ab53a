// CM31 and QM31 arithmetic on canonical residues in registers, shared by
// composition_air.cuh, fold.cu, transcript.cu and quotient.cuh.
//
// Twin of core/qm31.py:
//   CM31 = M31[i] / (i^2 + 1),  (re, im) = re + im i
//   QM31 = CM31[u] / (u^2 - (2 + i)),  (a, b, c, d) = (a + b i) + (c + d i) u
// Every value is a canonical residue, so a correct field operation gives the
// eager version's residue whatever its order of evaluation.  The header holds
// no __constant__ data, so more than one translation unit may include it.
#pragma once

#include <cstdint>

#include "m31.cuh"

namespace qm31 {

using poseidon2_m31::add;
using poseidon2_m31::inv;
using poseidon2_m31::mul;
using poseidon2_m31::neg;
using poseidon2_m31::sub;

struct C {
  uint32_t re, im;
};

__device__ __forceinline__ C c_sub(C x, C y) { return C{sub(x.re, y.re), sub(x.im, y.im)}; }

// (x0 + x1 i)(y0 + y1 i) = (x0 y0 - x1 y1) + (x0 y1 + x1 y0) i
__device__ __forceinline__ C c_mul(C x, C y) {
  return C{sub(mul(x.re, y.re), mul(x.im, y.im)), add(mul(x.re, y.im), mul(x.im, y.re))};
}

// 1/(a + b i) = (a - b i) / (a^2 + b^2); c_inv(0) = 0, as m31 inv(0) = 0.
__device__ __forceinline__ C c_inv(C x) {
  const uint32_t ninv = inv(add(mul(x.re, x.re), mul(x.im, x.im)));
  return C{mul(x.re, ninv), mul(neg(x.im), ninv)};
}

// (a + b i) + (c + d i) u, i^2 = -1, u^2 = 2 + i
struct Q {
  uint32_t a, b, c, d;
};

__device__ __forceinline__ Q q_zero() { return Q{0u, 0u, 0u, 0u}; }
__device__ __forceinline__ Q q_one() { return Q{1u, 0u, 0u, 0u}; }
__device__ __forceinline__ Q q_m31(uint32_t v) { return Q{v, 0u, 0u, 0u}; }

__device__ __forceinline__ Q q_add(Q x, Q y) {
  return Q{add(x.a, y.a), add(x.b, y.b), add(x.c, y.c), add(x.d, y.d)};
}

__device__ __forceinline__ Q q_sub(Q x, Q y) {
  return Q{sub(x.a, y.a), sub(x.b, y.b), sub(x.c, y.c), sub(x.d, y.d)};
}

__device__ __forceinline__ Q q_neg(Q x) { return Q{neg(x.a), neg(x.b), neg(x.c), neg(x.d)}; }

__device__ __forceinline__ bool q_eq(Q x, Q y) { return x.a == y.a && x.b == y.b && x.c == y.c && x.d == y.d; }

__device__ __forceinline__ Q q_mul_m31(Q x, uint32_t s) {
  return Q{mul(x.a, s), mul(x.b, s), mul(x.c, s), mul(x.d, s)};
}

// (p + q u) s = p s + (q s) u for a CM31 s
__device__ __forceinline__ Q q_mul_cm31(Q x, C s) {
  const C p = c_mul(C{x.a, x.b}, s), q = c_mul(C{x.c, x.d}, s);
  return Q{p.re, p.im, q.re, q.im};
}

// (p + q u)(r + s u) = p r + (2 + i) q s + (p s + q r) u, each CM31 product
// (x0 + x1 i)(y0 + y1 i) = (x0 y0 - x1 y1) + (x0 y1 + x1 y0) i.
__device__ __forceinline__ Q q_mul(Q x, Q y) {
  const uint32_t pr_re = sub(mul(x.a, y.a), mul(x.b, y.b));
  const uint32_t pr_im = add(mul(x.a, y.b), mul(x.b, y.a));
  const uint32_t qs_re = sub(mul(x.c, y.c), mul(x.d, y.d));
  const uint32_t qs_im = add(mul(x.c, y.d), mul(x.d, y.c));
  const uint32_t ps_re = sub(mul(x.a, y.c), mul(x.b, y.d));
  const uint32_t ps_im = add(mul(x.a, y.d), mul(x.b, y.c));
  const uint32_t qr_re = sub(mul(x.c, y.a), mul(x.d, y.b));
  const uint32_t qr_im = add(mul(x.c, y.b), mul(x.d, y.a));
  // (2 + i)(re + im i) = (2 re - im) + (2 im + re) i
  const uint32_t t_re = sub(add(qs_re, qs_re), qs_im);
  const uint32_t t_im = add(add(qs_im, qs_im), qs_re);
  return Q{add(pr_re, t_re), add(pr_im, t_im), add(ps_re, qr_re), add(ps_im, qr_im)};
}

// 1/(p + q u) = (p - q u) / (p^2 - (2 + i) q^2), and 1/(a + b i) =
// (a - b i) / (a^2 + b^2)
__device__ __forceinline__ Q q_inv(Q x) {
  const uint32_t pp_re = sub(mul(x.a, x.a), mul(x.b, x.b));
  const uint32_t pp_im = add(mul(x.a, x.b), mul(x.b, x.a));
  const uint32_t qq_re = sub(mul(x.c, x.c), mul(x.d, x.d));
  const uint32_t qq_im = add(mul(x.c, x.d), mul(x.d, x.c));
  const uint32_t n_re = sub(pp_re, sub(add(qq_re, qq_re), qq_im));
  const uint32_t n_im = sub(pp_im, add(add(qq_im, qq_im), qq_re));
  const uint32_t ninv = inv(add(mul(n_re, n_re), mul(n_im, n_im)));
  const uint32_t i_re = mul(n_re, ninv), i_im = mul(neg(n_im), ninv);
  const uint32_t nc = neg(x.c), nd = neg(x.d);
  return Q{sub(mul(x.a, i_re), mul(x.b, i_im)), add(mul(x.a, i_im), mul(x.b, i_re)),
           sub(mul(nc, i_re), mul(nd, i_im)), add(mul(nc, i_im), mul(nd, i_re))};
}

// x -> 2 x^2 - 1, the x-coordinate of the doubled point (points.py)
__device__ __forceinline__ Q q_double_x(Q x) {
  const Q sq = q_mul(x, x);
  return q_sub(q_add(sq, sq), q_one());
}

}  // namespace qm31
