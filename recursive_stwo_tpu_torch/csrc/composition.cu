// The composition check at the OODS point and the provers' composition
// evaluation over the 2^bound domain, for Hopper (sm_90a), bound through a
// plain C interface (ops/build.py compiles this file with nvcc;
// ops/composition_cuda.py loads it with ctypes).
//
// Replaces what XLA compiled on the TPU from
// recursive_stwo_tpu/verifier/composition.py (`composition_check` :533-582,
// `composition_check_np` :280-317, with the evaluators and the two
// lax.scans at :437 and :529) and from
// recursive_stwo_tpu/prover/device_prove.py (`_ProverEval` :202-274,
// `_stage_composition_jit` :417-474).  The AIRs themselves are in
// composition_air.cuh, shared by both kernels.
//
// The check kernel: one thread per proof.  It reads its proof's row of
// samples_flat (B, S, 4) through an index table (entry k names the sample of
// the k-th mask the evaluators read, in the order the eager `_Eval._gather`
// visits them, then the 8 composition samples), and (B, n_params, 4) QM31
// parameters: the components' total sums, z, alpha, random_coeff and the
// OODS point's x.  It runs one x -> 2x^2 - 1 chain to bound - 2 doublings,
// keeping each component's vanishing value on the way, inverts those, folds
// every constraint into the Horner value and compares it with the committed
// left + right * x^(2^(bound-2)) in every limb.  Writes the (B,) bool and
// the (B, 4) Horner value.
//
// What bounds it on an H100: integer ALU work, about 0.12M int32 operations a
// proof of the with-Poseidon pair (ops/composition_cuda.py counts them), and
// the latency of one thread's chain when B is small: B = 1024 fills 32 SMs
// with one warp each.
//
// The domain kernel: one thread per point of the domain.  It reads one AIR
// table's LDE rows (pre, trace, interaction limb rows; M31 values, so a
// QM31 mask is (v, 0, 0, 0) and an interaction mask the four limb rows as
// they stand), the previous-row point `perm[j]` for the last interaction
// mask, and the M31 1/vanishing of its point, and folds the AIR's
// constraints into the (4, N) accumulator, which it reads (unless `first`)
// and writes, so the with-Poseidon pair is two launches, plonk then
// poseidon.  Neighbouring threads read neighbouring entries of every row
// (coalesced); the previous-row gather is not.

#include <cstdint>

#include <cuda_runtime.h>

#include "composition_air.cuh"

namespace {

using namespace composition;

constexpr int kCheckThreads = 32;
constexpr int kDomainThreads = 128;

enum Flavour { kWithPoseidon = 0, kWithoutPoseidon = 1 };
enum Air { kPlonk = 0, kPoseidon = 1, kPlonkNp = 2 };

__device__ __forceinline__ Q load_q(const int64_t* p) {
  return Q{(uint32_t)p[0], (uint32_t)p[1], (uint32_t)p[2], (uint32_t)p[3]};
}

// The sample the k-th entry of the index table names, in one proof's row.
__device__ __forceinline__ Q sample(const int64_t* row, const int32_t* tab, int k) {
  return load_q(row + 4 * (int64_t)__ldg(tab + k));
}

// One proof's samples through the index table: a component's masks start
// at table positions pre0, tr0 and ext0; a non-last interaction mask m is
// four entries (one a column), the last one eight (previous then current
// row, column by column), as the eager _Eval reads them.
struct CheckSrc {
  const int64_t* row;
  const int32_t* tab;
  int pre0, tr0, ext0;
  Q dinv;

  __device__ __forceinline__ Q at(int k) const { return sample(row, tab, k); }
  __device__ __forceinline__ Q pre(int i) const { return at(pre0 + i); }
  __device__ __forceinline__ Q tr(int i) const { return at(tr0 + i); }
  __device__ __forceinline__ Q ext(int m) const {
    const int k = ext0 + 4 * m;
    return q_combine4(at(k), at(k + 1), at(k + 2), at(k + 3));
  }
  __device__ __forceinline__ void ext_pair(int m, Q& prev, Q& cur) const {
    const int k = ext0 + 4 * m;
    prev = q_combine4(at(k), at(k + 2), at(k + 4), at(k + 6));
    cur = q_combine4(at(k + 1), at(k + 3), at(k + 5), at(k + 7));
  }
  __device__ __forceinline__ Q scale(Q v) const { return q_mul(v, dinv); }
};

// One point j of the domain: row i of a (rows, n) block at i * n + j.
struct DomainSrc {
  const int64_t* pre_rows;
  const int64_t* tr_rows;
  const int64_t* inter_rows;
  int64_t n, j, prev_j;
  uint32_t dinv;

  __device__ __forceinline__ Q pre(int i) const { return q_m31((uint32_t)pre_rows[i * n + j]); }
  __device__ __forceinline__ Q tr(int i) const { return q_m31((uint32_t)tr_rows[i * n + j]); }
  __device__ __forceinline__ Q limbs(int m, int64_t at) const {
    const int64_t* r = inter_rows + 4 * m * n + at;
    return Q{(uint32_t)r[0], (uint32_t)r[n], (uint32_t)r[2 * n], (uint32_t)r[3 * n]};
  }
  __device__ __forceinline__ Q ext(int m) const { return limbs(m, j); }
  __device__ __forceinline__ void ext_pair(int m, Q& prev, Q& cur) const {
    prev = limbs(m, prev_j);
    cur = limbs(m, j);
  }
  __device__ __forceinline__ Q scale(Q v) const { return q_mul_m31(v, dinv); }
};

struct CheckArgs {
  int n_samples, n_params;
  int van_steps[2];  // doublings to each component's vanishing value
  int x_steps;       // bound - 2
  uint32_t inv2n[2];  // 1 / 2^log_size of each component
};

// One proof's check: the thread body of composition_check_kernel.
template <int FLAVOUR>
__device__ __forceinline__ void check_proof(const int64_t* row, const int32_t* tab, const int64_t* par,
                                            const CheckArgs& a, bool* ok, int64_t* out) {
  constexpr int kComponents = FLAVOUR == kWithPoseidon ? 2 : 1;
  const Q z = load_q(par + 4 * kComponents), alpha = load_q(par + 4 * (kComponents + 1));
  const Q rc = load_q(par + 4 * (kComponents + 2)), x = load_q(par + 4 * (kComponents + 3));

  // one doubling chain: each component's vanishing value on the way to
  // x^(2^(bound-2))
  Q van[kComponents];
  Q v = x;
  for (int k = 0;; ++k) {
#pragma unroll
    for (int c = 0; c < kComponents; ++c) {
      if (k == a.van_steps[c]) van[c] = v;
    }
    if (k == a.x_steps) break;
    v = q_double_x(v);
  }

  // the components' masks, then the 8 composition samples, in table order
  Horner h{q_zero(), rc};
  int pos = 0;
  if constexpr (FLAVOUR == kWithPoseidon) {
    const CheckSrc plonk{row, tab, pos, pos + kPlonkPre, pos + kPlonkPre + kPlonkTrace, q_inv(van[0])};
    evaluate_plonk(plonk, h, z, alpha, q_mul_m31(load_q(par), a.inv2n[0]));
    pos += kPlonkPre + kPlonkTrace + interaction_reads(kPlonkFracs, kPlonkBatch);
    const CheckSrc poseidon{row, tab, pos, pos + kPoseidonPre, pos + kPoseidonPre + kPoseidonTrace,
                            q_inv(van[1])};
    evaluate_poseidon(poseidon, h, z, alpha, q_mul_m31(load_q(par + 4), a.inv2n[1]));
    pos += kPoseidonPre + kPoseidonTrace + interaction_reads(kPoseidonFracs, kPoseidonBatch);
  } else {
    const CheckSrc np{row, tab, pos, pos + kNpPre, pos + kNpPre + kNpTrace, q_inv(van[0])};
    evaluate_plonk_np(np, h, z, alpha, q_mul_m31(load_q(par), a.inv2n[0]));
    pos += kNpPre + kNpTrace + interaction_reads(kNpFracs, kNpBatch);
  }

  // the committed split values: left + right * x^(2^(bound-2))
  const Q left = q_combine4(sample(row, tab, pos), sample(row, tab, pos + 1), sample(row, tab, pos + 2),
                            sample(row, tab, pos + 3));
  const Q right = q_combine4(sample(row, tab, pos + 4), sample(row, tab, pos + 5), sample(row, tab, pos + 6),
                             sample(row, tab, pos + 7));
  const Q expected = q_add(left, q_mul(right, v));
  const Q got = h.acc;
  *ok = got.a == expected.a && got.b == expected.b && got.c == expected.c && got.d == expected.d;
  out[0] = got.a;
  out[1] = got.b;
  out[2] = got.c;
  out[3] = got.d;
}

struct DomainArgs {
  Q total, z, alpha, rc;
  uint32_t inv2n;
};

// One point's evaluation: the thread body of composition_domain_kernel.
template <int AIR>
__device__ __forceinline__ void domain_point(const DomainSrc& src, const DomainArgs& a, int64_t* acc, int first) {
  const int64_t n = src.n, j = src.j;
  Horner h{first ? q_zero() : Q{(uint32_t)acc[j], (uint32_t)acc[n + j], (uint32_t)acc[2 * n + j],
                                (uint32_t)acc[3 * n + j]},
           a.rc};
  const Q shift = q_mul_m31(a.total, a.inv2n);
  if constexpr (AIR == kPlonk) {
    evaluate_plonk(src, h, a.z, a.alpha, shift);
  } else if constexpr (AIR == kPoseidon) {
    evaluate_poseidon(src, h, a.z, a.alpha, shift);
  } else {
    evaluate_plonk_np(src, h, a.z, a.alpha, shift);
  }
  acc[j] = h.acc.a;
  acc[n + j] = h.acc.b;
  acc[2 * n + j] = h.acc.c;
  acc[3 * n + j] = h.acc.d;
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

template <int FLAVOUR>
__global__ void __launch_bounds__(kCheckThreads)
composition_check_kernel(const int64_t* __restrict__ samples, const int32_t* __restrict__ tab,
                         const int64_t* __restrict__ params, int64_t batch, CheckArgs a,
                         bool* __restrict__ ok, int64_t* __restrict__ value) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  check_proof<FLAVOUR>(samples + b * a.n_samples * 4, tab, params + b * a.n_params * 4, a, ok + b,
                       value + 4 * b);
}

template <int AIR>
__global__ void __launch_bounds__(kDomainThreads)
composition_domain_kernel(const int64_t* __restrict__ pre, const int64_t* __restrict__ tr,
                          const int64_t* __restrict__ inter, const int64_t* __restrict__ perm,
                          const int64_t* __restrict__ dinv, int64_t* __restrict__ acc, int first,
                          int64_t n, DomainArgs a) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  domain_point<AIR>(DomainSrc{pre, tr, inter, n, j, perm[j], (uint32_t)dinv[j]}, a, acc, first);
}

Q q_of(const int64_t* v) { return Q{(uint32_t)v[0], (uint32_t)v[1], (uint32_t)v[2], (uint32_t)v[3]}; }

}  // namespace

// flavour 0: the with-Poseidon pair (plonk then poseidon), 1: the
// without-Poseidon AIR.  samples: (batch, n_samples, 4) int64; table: the
// index table, int32 on the device; params: (batch, n_params, 4) int64;
// steps: (van_plonk_or_np, van_poseidon, bound - 2) doublings; inv2n: each
// component's 1 / 2^log_size; ok: (batch,) bool; value: (batch, 4) int64.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int composition_check(int flavour, const void* samples, int64_t n_samples, const void* table,
                                 const void* params, int64_t n_params, int64_t batch, const int64_t* steps,
                                 const int64_t* inv2n, void* ok, void* value, void* stream) {
  if (batch == 0) return 0;
  CheckArgs a{(int)n_samples, (int)n_params, {(int)steps[0], (int)steps[1]}, (int)steps[2],
              {(uint32_t)inv2n[0], (uint32_t)inv2n[1]}};
  const unsigned blocks = (unsigned)((batch + kCheckThreads - 1) / kCheckThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t* smp = (const int64_t*)samples;
  const int32_t* tab = (const int32_t*)table;
  const int64_t* par = (const int64_t*)params;
  if (flavour == kWithPoseidon) {
    composition_check_kernel<kWithPoseidon><<<blocks, kCheckThreads, 0, s>>>(
        smp, tab, par, batch, a, (bool*)ok, (int64_t*)value);
  } else if (flavour == kWithoutPoseidon) {
    composition_check_kernel<kWithoutPoseidon><<<blocks, kCheckThreads, 0, s>>>(
        smp, tab, par, batch, a, (bool*)ok, (int64_t*)value);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// air 0: plonk, 1: poseidon, 2: without-Poseidon.  pre, tr, inter: (rows, n)
// int64 LDE blocks; perm, dinv: (n,) int64; acc: (4, n) int64, read unless
// `first`, then written; consts (host): total sum, z, alpha, random_coeff
// (four limbs each), then 1 / 2^log_size.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int composition_domain(int air, const void* pre, const void* tr, const void* inter,
                                  const void* perm, const void* dinv, void* acc, int first, int64_t n,
                                  const int64_t* consts, void* stream) {
  if (n == 0) return 0;
  DomainArgs a{q_of(consts), q_of(consts + 4), q_of(consts + 8), q_of(consts + 12), (uint32_t)consts[16]};
  const unsigned blocks = (unsigned)((n + kDomainThreads - 1) / kDomainThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t *p = (const int64_t*)pre, *t = (const int64_t*)tr, *x = (const int64_t*)inter;
  const int64_t *pm = (const int64_t*)perm, *d = (const int64_t*)dinv;
  int64_t* out = (int64_t*)acc;
  if (air == kPlonk) {
    composition_domain_kernel<kPlonk><<<blocks, kDomainThreads, 0, s>>>(p, t, x, pm, d, out, first, n, a);
  } else if (air == kPoseidon) {
    composition_domain_kernel<kPoseidon><<<blocks, kDomainThreads, 0, s>>>(p, t, x, pm, d, out, first, n, a);
  } else if (air == kPlonkNp) {
    composition_domain_kernel<kPlonkNp><<<blocks, kDomainThreads, 0, s>>>(p, t, x, pm, d, out, first, n, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
