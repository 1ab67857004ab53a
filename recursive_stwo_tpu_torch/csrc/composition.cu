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
// The check kernel: a warp a proof, its constraints spread over the lanes.
// The warp stages its proof's samples in shared memory in the order of an
// index table (entry k names the sample of the k-th mask the evaluators
// read, in the order the eager `_Eval._gather` visits them, then the 8
// composition samples), and reads (B, n_params, 4) QM31 parameters: the
// components' total sums, z, alpha, random_coeff and the OODS point's x.
// The serial parts run on every lane: one x -> 2x^2 - 1 chain to bound - 2 doublings, keeping
// each component's vanishing value on the way, and their inverses.  The
// Horner fold becomes a weighted sum, acc = sum of c_i rc^(n-1-i) (exact
// over M31, so the order of the sum is free): the lanes build the per-proof
// table of rc's powers in shared memory together, each lane weights the
// constraints it computes, keeps one partial sum a component, multiplies
// each by the component's 1/vanishing once, and a shuffle reduction gives
// the value.  The poseidon AIR's 16-word blocks put word i on lane i (and
// lane 16 + i): its first round, full rounds, the 14 partial rounds' S-boxes
// (each on its own lane) and their output block; the partial rounds' linear
// chain (the committed inter[r], not the S-box, goes into word 0) runs a
// word a lane, summing over the half-warp by shuffles.  The plonk AIR, the
// without-Poseidon AIR and the poseidon AIR's logup run on every lane
// through the straight-line evaluators (a Capture sink) and go to lanes by a
// select.  Which lane computes which constraint at which stage, and with
// which power of rc, is the lane table that follows the index table
// (ops/composition_cuda.py `lane_table`).  Writes the (B,) bool and the
// (B, 4) value; every lane but lane 0 of the warp stores nothing.
//
// What bounds it on an H100: integer ALU work, about 88k int32 operations a
// proof of the with-Poseidon pair (ops/composition_cuda.py counts them), and
// the latency of a warp's dependent instructions: B = 1 takes about as long
// as B = 1024.  ops/composition_cuda.py `latency_floor_ms` gives the floor
// of a proof's longest chain (the doublings and the inverse, or the partial
// rounds' 14 shuffle sums).
//

// The domain kernel: one thread per point of the domain.  It reads one AIR
// table's LDE rows (pre, trace, interaction limb rows; M31 values, so a
// QM31 mask is (v, 0, 0, 0) and an interaction mask the four limb rows as
// they stand), the previous-row point `perm[j]` for the last interaction
// mask, and the M31 1/vanishing of its point, and folds the AIR's n
// constraints into the (4, N) accumulator, which it reads (unless `first`)
// and writes, so the with-Poseidon pair is two launches, plonk then
// poseidon.  Horner's acc rc^n + sum of c_i rc^(n-1-i) / vanishing is a
// weighted sum (composition_air.cuh `PowerSum`): the launch's table of rc^0
// .. rc^n, built on the host, is a __grid_constant__ argument, read as a
// broadcast; the 78 M31-valued constraints of the poseidon AIR cost four
// lazy 64-bit products each, the two logup constraints a QM31 product; the
// 1/vanishing and acc rc^n multiply once a point.  Neighbouring threads read
// neighbouring entries of every row (coalesced); the previous-row gather is
// not.
//
// What bounds the domain kernel: integer ALU work on the poseidon table
// (ops/composition_cuda.py `domain_ops`), the bytes of its rows on the plonk
// and without-Poseidon tables.

#include <cstdint>

#include <cuda_runtime.h>

#include "composition_air.cuh"

namespace {

using namespace composition;

constexpr int kCheckWarps = 4;  // proofs a block
constexpr int kCheckThreads = 32 * kCheckWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;
// a warp's power table and staged samples: the with-Poseidon pair's
// constraints, and its index table (its masks' reads and the 8 composition
// samples)
constexpr int kMaxConstraints = n_constraints(kPlonkConstraints) + n_constraints(kPoseidonConstraints);
constexpr int kMaxReads = kPlonkPre + kPlonkTrace + interaction_reads(kPlonkFracs, kPlonkBatch) + kPoseidonPre +
                          kPoseidonTrace + interaction_reads(kPoseidonFracs, kPoseidonBatch) + 8;
constexpr int kDomainThreads = 128;

enum Flavour { kWithPoseidon = 0, kWithoutPoseidon = 1 };
enum Air { kPlonk = 0, kPoseidon = 1, kPlonkNp = 2 };

__device__ __forceinline__ Q load_q(const int64_t* p) {
  return Q{(uint32_t)p[0], (uint32_t)p[1], (uint32_t)p[2], (uint32_t)p[3]};
}

// One proof's samples in index-table order (the warp stages them in shared
// memory): a component's masks start at table positions pre0, tr0 and ext0;
// a non-last interaction mask m is four entries (one a column), the last one
// eight (previous then current row, column by column), as the eager _Eval
// reads them.
struct CheckSrc {
  const Q* smp;
  int pre0, tr0, ext0;

  __device__ __forceinline__ Q at(int k) const { return smp[k]; }
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
};

// One point j of the domain: row i of a (rows, n) block at i * n + j.
struct DomainSrc {
  using V = Q;
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
};

struct CheckArgs {
  int n_samples, n_params;
  int van_steps[2];  // doublings to each component's vanishing value
  int x_steps;       // bound - 2
  uint32_t inv2n[2];  // 1 / 2^log_size of each component
};

// ---------------------------------------------------------------------------
// the check kernel's warp
// ---------------------------------------------------------------------------

__device__ __forceinline__ Q shfl_q(Q v, int src, int width = 32) {
  return Q{__shfl_sync(kFull, v.a, src, width), __shfl_sync(kFull, v.b, src, width),
           __shfl_sync(kFull, v.c, src, width), __shfl_sync(kFull, v.d, src, width)};
}

__device__ __forceinline__ Q shfl_xor_q(Q v, int m) {
  return Q{__shfl_xor_sync(kFull, v.a, m), __shfl_xor_sync(kFull, v.b, m), __shfl_xor_sync(kFull, v.c, m),
           __shfl_xor_sync(kFull, v.d, m)};
}

__device__ __forceinline__ Q q_select(bool c, Q x, Q y) {
  return Q{c ? x.a : y.a, c ? x.b : y.b, c ? x.c : y.c, c ? x.d : y.d};
}

// v[lane] for lane < K, from values every lane holds (a select chain, no
// indexed register array).
template <int K>
__device__ __forceinline__ Q pick(const Q (&v)[K], int lane) {
  Q r = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) r = q_select(lane == k, v[k], r);
  return r;
}

// mds16 over each half-warp, word w = lane & 15 on lane w: the M4 of the
// lane's block of four (its words by shuffle), then the sum of its position
// over the four blocks (xor 4 and 8).
__device__ __forceinline__ Q mds16_lanes(Q v, int lane) {
  const int base = lane & ~3, pos = lane & 3;
  const Q x0 = shfl_q(v, base), x1 = shfl_q(v, base + 1), x2 = shfl_q(v, base + 2), x3 = shfl_q(v, base + 3);
  const Q t0 = q_add(x0, x1), t1 = q_add(x2, x3);
  const Q t2 = q_add(q_add(x1, x1), t1), t3 = q_add(q_add(x3, x3), t0);
  const Q t1d = q_add(t1, t1), t0d = q_add(t0, t0);
  const Q t4 = q_add(q_add(t1d, t1d), t3), t5 = q_add(q_add(t0d, t0d), t2);
  const Q t = q_select(pos == 0, q_add(t3, t5), q_select(pos == 1, t5, q_select(pos == 2, q_add(t2, t4), t4)));
  Q sum = q_add(t, shfl_xor_q(t, 4));
  sum = q_add(sum, shfl_xor_q(sum, 8));
  return q_add(t, sum);
}

// The 14 partial rounds' linear chain over each half-warp from the input
// state st (word w = lane & 15 on lane w): in round r word 0 is first kept
// (xr, on lane r: the S-box input less its constant), then replaced by the
// committed inter[r] (inter_w: word w of inter), then the internal matrix.
// Returns the state after round 14.
__device__ __forceinline__ Q partial_chain(Q st, Q inter_w, int w, Q& xr) {
  using poseidon2_m31::mul_pow2;
  xr = Q{};
  const int k = w == 0 ? 1 : w + 1;  // word 0's 3 s is 2 s + s
#pragma unroll
  for (int r = 0; r < 14; ++r) {
    xr = q_select(w == r, shfl_q(st, 0, 16), xr);
    st = q_select(w == 0, shfl_q(inter_w, r, 16), st);
    Q total = st;
#pragma unroll
    for (int m = 1; m < 16; m <<= 1) total = q_add(total, shfl_xor_q(total, m));
    const Q d{mul_pow2(st.a, k), mul_pow2(st.b, k), mul_pow2(st.c, k), mul_pow2(st.d, k)};
    st = q_add(total, q_select(w == 0, q_add(d, st), d));
  }
  return st;
}

// The weighted sum of one proof's constraints: per component, the lane's
// constraints each times its power of rc (pw, the proof's table), summed.
template <int C>
struct Weighted {
  const Q* pw;
  const int32_t* lanes;  // the lane table: (component << 16 | exponent), or -1, a stage x 32 lanes
  int lane;
  Q acc[C];

  __device__ __forceinline__ void add(int stage, Q c) {
    const int32_t e = __ldg(lanes + 32 * stage + lane);
    const Q t = q_mul(c, e >= 0 ? pw[e & 0xFFFF] : Q{});
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] = q_select((e >> 16) == k, q_add(acc[k], t), acc[k]);
  }
};

// The poseidon AIR's round blocks (kPoseidonLanes: lanes 0-15 the first
// round, then the first full round, lanes 16-31 the full round's output,
// lanes 0-13 the partial rounds' S-boxes and lanes 16-31 the partial rounds'
// output), and `misc` (the plonk AIR's and the logup constraints, on every
// lane) on lanes 0-7 beside the full round's output.
constexpr LaneBlock kFirstLanes = lane_block(kPoseidonLanes, 1, kFirstRound);
constexpr LaneBlock kFullLanes = lane_block(kPoseidonLanes, 1, kFullRound);
constexpr LaneBlock kFullOutLanes = lane_block(kPoseidonLanes, 1, kFullRoundOut);
constexpr LaneBlock kPartialLanes = lane_block(kPoseidonLanes, 1, kPartialRound);
constexpr LaneBlock kPartialOutLanes = lane_block(kPoseidonLanes, 1, kPartialOut);
// a round block's word w is on lane w, or on lane 16 + w beside another block
static_assert(kFirstLanes.lane0 == 0 && kFullLanes.lane0 == 0 && kPartialLanes.lane0 == 0 &&
                  kFullOutLanes.lane0 == 16 && kPartialOutLanes.lane0 == 16,
              "poseidon_lanes computes a round block on lanes 0-15 or 16-31");
static_assert(kPartialLanes.stage == kPartialOutLanes.stage, "the partial rounds and their output share a stage");
// misc[k] on lane k: the plonk AIR's constraints, then the poseidon logup
static_assert(lane_block(kPoseidonLanes, 0, kEnforceCm31).lane0 == 0 &&
                  lane_block(kPoseidonLanes, 0, kGate).lane0 == 3 && lane_block(kPoseidonLanes, 0, kLogup).lane0 == 4 &&
                  lane_block(kPoseidonLanes, 1, kLogup).lane0 == 6,
              "misc is the plonk AIR's constraints, then the poseidon logup, from lane 0");
static_assert(lane_block(kPoseidonLanes, 0, kEnforceCm31).stage == kFullOutLanes.stage &&
                  lane_block(kPoseidonLanes, 0, kGate).stage == kFullOutLanes.stage &&
                  lane_block(kPoseidonLanes, 0, kLogup).stage == kFullOutLanes.stage &&
                  lane_block(kPoseidonLanes, 1, kLogup).stage == kFullOutLanes.stage,
              "misc shares the full round output's stage");
static_assert(kFirstLanes.stage != kFullLanes.stage && kFirstLanes.stage != kFullOutLanes.stage &&
                  kFirstLanes.stage != kPartialLanes.stage && kFullLanes.stage != kFullOutLanes.stage &&
                  kFullLanes.stage != kPartialLanes.stage && kFullOutLanes.stage != kPartialLanes.stage,
              "each sum.add below has a stage of its own");
// the stages as scalars, for device code
constexpr int kFirstStage = kFirstLanes.stage, kFullStage = kFullLanes.stage, kFullOutStage = kFullOutLanes.stage,
              kPartialStage = kPartialLanes.stage, kNpStage = lane_block(kNpLanes, 0, kA4).stage;
// the without-Poseidon AIR's constraints on lanes 0-6 of one stage, in order
static_assert(lane_block(kNpLanes, 0, kA4).lane0 == 0 && lane_block(kNpLanes, 0, kGate).lane0 == 4 &&
                  lane_block(kNpLanes, 0, kLogup).lane0 == 5 && lane_block(kNpLanes, 0, kGate).stage == kNpStage &&
                  lane_block(kNpLanes, 0, kLogup).stage == kNpStage,
              "check_warp puts the without-Poseidon AIR's k-th constraint on lane k of one stage");

template <int C, int K>
__device__ __forceinline__ void poseidon_lanes(const CheckSrc& s, int lane, const Q (&misc)[K], Weighted<C>& sum) {
  const int w = lane & 15;
  const bool hi = lane >= 16;
  const Q one = Q{1u, 0u, 0u, 0u};
  const Q is_first = s.pre(0), is_full = s.pre(2);
  const Q is_partial = q_sub(q_sub(one, is_first), is_full);
  const Q swap = s.tr(kInter);
  const Q in_w = s.tr(kIn + w), inter_w = s.tr(kInter + w), out_w = s.tr(kOut + w);
  const Q rc0_w = s.pre(kRc0 + w), rc1_w = s.pre(kRc1 + w);

  // the first round's mds16 of the swapped input (lanes 0-15), and
  // mds16(inter) for the full round (lanes 16-31)
  const Q swapped = q_add(q_mul(in_w, q_sub(one, swap)), q_mul(s.tr(kIn + ((w + 8) & 15)), swap));
  const Q m = mds16_lanes(q_select(hi, inter_w, swapped), lane);
  sum.add(kFirstStage, q_mul(is_first, q_sub(m, out_w)));

  // the S-boxes, in + rc0 (lanes 0-15: inter - pow5) and
  // mds16(inter) + rc1 (lanes 16-31)
  const Q y = q_pow5(q_add(q_select(hi, m, in_w), q_select(hi, rc1_w, rc0_w)));
  sum.add(kFullStage, q_mul(is_full, q_sub(inter_w, y)));

  // out - mds16(pow5(...)) (lanes 16-31); misc on lanes 0-7
  const Q full = q_mul(is_full, q_sub(out_w, mds16_lanes(y, lane)));
  sum.add(kFullOutStage, q_select(hi, full, pick(misc, lane)));

  // the partial rounds' S-boxes (lanes 0-13) and output (16-31)
  Q xr;
  const Q st = partial_chain(in_w, inter_w, w, xr);
  const Q part = q_select(hi, q_sub(out_w, st), q_sub(inter_w, q_pow5(q_add(xr, rc0_w))));
  sum.add(kPartialStage, q_mul(is_partial, part));
}

// One proof's check on a warp: the body of composition_check_kernel.  pw and
// smp are the warp's power table and staged samples in shared memory.
template <int FLAVOUR>
__device__ __forceinline__ void check_warp(const int64_t* row, const int32_t* tab, const int64_t* par,
                                           const CheckArgs& a, int lane, Q* pw, Q* smp, bool* ok, int64_t* out) {
  constexpr int kComponents = FLAVOUR == kWithPoseidon ? 2 : 1;
  constexpr int kN = FLAVOUR == kWithPoseidon ? n_constraints(kPlonkConstraints) + n_constraints(kPoseidonConstraints)
                                              : n_constraints(kNpConstraints);
  constexpr int kPlonkReads = kPlonkPre + kPlonkTrace + interaction_reads(kPlonkFracs, kPlonkBatch);
  constexpr int kPoseidonReads = kPoseidonPre + kPoseidonTrace + interaction_reads(kPoseidonFracs, kPoseidonBatch);
  constexpr int kNpReads = kNpPre + kNpTrace + interaction_reads(kNpFracs, kNpBatch);
  constexpr int kCompositionPos = FLAVOUR == kWithPoseidon ? kPlonkReads + kPoseidonReads : kNpReads;
  const Q z = load_q(par + 4 * kComponents), alpha = load_q(par + 4 * (kComponents + 1));
  const Q rc = load_q(par + 4 * (kComponents + 2)), x = load_q(par + 4 * (kComponents + 3));
  // the proof's samples in table order, one load a lane at a time
  for (int k = lane; k < kCompositionPos + 8; k += 32) smp[k] = load_q(row + 4 * (int64_t)__ldg(tab + k));

  // the powers rc^e, e < kN: lane l computes rc^l, then each 32 more
  {
    Q p = Q{1u, 0u, 0u, 0u}, sq = rc;
#pragma unroll
    for (int bit = 0; bit < 5; ++bit) {
      p = q_select((lane >> bit) & 1, q_mul(p, sq), p);
      sq = q_mul(sq, sq);
    }
#pragma unroll
    for (int base = 0; base < kN; base += 32) {
      if (base + lane < kN) pw[base + lane] = p;
      if (base + 32 < kN) p = q_mul(p, sq);
    }
  }

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
  __syncwarp();  // the samples and the power table

  Weighted<kComponents> sum{pw, tab + kCompositionPos + 8, lane, {}};
#pragma unroll
  for (int c = 0; c < kComponents; ++c) sum.acc[c] = Q{};
  if constexpr (FLAVOUR == kWithPoseidon) {
    const CheckSrc plonk{smp, 0, kPlonkPre, kPlonkPre + kPlonkTrace};
    Capture<n_constraints(kPlonkConstraints)> pc;
    evaluate_plonk(plonk, pc, z, alpha, q_mul_m31(load_q(par), a.inv2n[0]));
    const CheckSrc poseidon{smp, kPlonkReads, kPlonkReads + kPoseidonPre,
                            kPlonkReads + kPoseidonPre + kPoseidonTrace};
    Capture<2> lc;
    {
      Component<CheckSrc, Capture<2>, kPoseidonFracs, kPoseidonBatch> ev(poseidon, lc, z, alpha,
                                                                        q_mul_m31(load_q(par + 4), a.inv2n[1]));
      poseidon_logup(poseidon, ev);
    }
    const Q misc[8] = {pc.v[0], pc.v[1], pc.v[2], pc.v[3], pc.v[4], pc.v[5], lc.v[0], lc.v[1]};
    poseidon_lanes(poseidon, lane, misc, sum);
  } else {
    const CheckSrc np{smp, 0, kNpPre, kNpPre + kNpTrace};
    Capture<kN> nc;
    evaluate_plonk_np(np, nc, z, alpha, q_mul_m31(load_q(par), a.inv2n[0]));
    sum.add(kNpStage, pick(nc.v, lane));
  }

  // each component's sum over 1 / vanishing, summed over the warp
  Q got = Q{};
#pragma unroll
  for (int c = 0; c < kComponents; ++c) got = q_add(got, q_mul(sum.acc[c], q_inv(van[c])));
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) got = q_add(got, shfl_xor_q(got, m));
  if (lane != 0) return;

  // the committed split values: left + right * x^(2^(bound-2))
  const int pos = kCompositionPos;
  const Q left = q_combine4(smp[pos], smp[pos + 1], smp[pos + 2], smp[pos + 3]);
  const Q right = q_combine4(smp[pos + 4], smp[pos + 5], smp[pos + 6], smp[pos + 7]);
  const Q expected = q_add(left, q_mul(right, v));
  *ok = q_eq(got, expected);
  out[0] = got.a;
  out[1] = got.b;
  out[2] = got.c;
  out[3] = got.d;
}

// The largest AIR's constraints: a domain launch's power table has one more
// entry.
constexpr int kMaxDomainConstraints = n_constraints(kPoseidonConstraints);

template <int AIR>
__host__ __device__ constexpr int domain_constraints() {
  return AIR == kPlonk ? n_constraints(kPlonkConstraints)
                       : AIR == kPoseidon ? n_constraints(kPoseidonConstraints) : n_constraints(kNpConstraints);
}

struct DomainArgs {
  Q total, z, alpha;
  uint32_t inv2n;
  Q pw[kMaxDomainConstraints + 1];  // rc^0 .. rc^n, n the AIR's constraints

  __device__ __forceinline__ Q power(int k) const { return pw[k]; }
};

// One point's evaluation: the thread body of composition_domain_kernel.
template <int AIR>
__device__ __forceinline__ void domain_point(const DomainSrc& src, const DomainArgs& a, int64_t* acc, int first) {
  constexpr int kN = domain_constraints<AIR>();
  const int64_t n = src.n, j = src.j;
  PowerSum<DomainArgs, kN> sum(a);
  const Q shift = q_mul_m31(a.total, a.inv2n);
  if constexpr (AIR == kPlonk) {
    evaluate_plonk(src, sum, a.z, a.alpha, shift);
  } else if constexpr (AIR == kPoseidon) {
    evaluate_poseidon(src, sum, a.z, a.alpha, shift);
  } else {
    evaluate_plonk_np(src, sum, a.z, a.alpha, shift);
  }
  Q v = q_mul_m31(sum.value(), src.dinv);
  if (!first) {
    const Q in{(uint32_t)acc[j], (uint32_t)acc[n + j], (uint32_t)acc[2 * n + j], (uint32_t)acc[3 * n + j]};
    v = q_add(q_mul(in, a.pw[kN]), v);
  }
  acc[j] = v.a;
  acc[n + j] = v.b;
  acc[2 * n + j] = v.c;
  acc[3 * n + j] = v.d;
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

template <int FLAVOUR>
__global__ void __launch_bounds__(kCheckThreads)
composition_check_kernel(const int64_t* __restrict__ samples, const int32_t* __restrict__ tab,
                         const int64_t* __restrict__ params, int64_t batch, CheckArgs a,
                         bool* __restrict__ ok, int64_t* __restrict__ value) {
  __shared__ Q pw[kCheckWarps][kMaxConstraints];
  __shared__ Q smp[kCheckWarps][kMaxReads];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kCheckWarps + warp;
  if (b >= batch) return;  // the whole warp
  check_warp<FLAVOUR>(samples + b * a.n_samples * 4, tab, params + b * a.n_params * 4, a, lane, pw[warp], smp[warp],
                      ok + b, value + 4 * b);
}

template <int AIR>
__global__ void __launch_bounds__(kDomainThreads)
composition_domain_kernel(const int64_t* __restrict__ pre, const int64_t* __restrict__ tr,
                          const int64_t* __restrict__ inter, const int64_t* __restrict__ perm,
                          const int64_t* __restrict__ dinv, int64_t* __restrict__ acc, int first,
                          int64_t n, const __grid_constant__ DomainArgs a) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  domain_point<AIR>(DomainSrc{pre, tr, inter, n, j, perm[j], (uint32_t)dinv[j]}, a, acc, first);
}

Q q_of(const int64_t* v) { return Q{(uint32_t)v[0], (uint32_t)v[1], (uint32_t)v[2], (uint32_t)v[3]}; }

// One domain launch of AIR: consts holds its n + 1 powers from position 13.
template <int AIR>
int launch_domain(const int64_t* pre, const int64_t* tr, const int64_t* inter, const int64_t* perm,
                  const int64_t* dinv, int64_t* acc, int first, int64_t n, const int64_t* consts, cudaStream_t s) {
  DomainArgs a{q_of(consts), q_of(consts + 4), q_of(consts + 8), (uint32_t)consts[12], {}};
  for (int k = 0; k <= domain_constraints<AIR>(); ++k) a.pw[k] = q_of(consts + 13 + 4 * k);
  const unsigned blocks = (unsigned)((n + kDomainThreads - 1) / kDomainThreads);
  composition_domain_kernel<AIR><<<blocks, kDomainThreads, 0, s>>>(pre, tr, inter, perm, dinv, acc, first, n, a);
  return (int)cudaGetLastError();
}

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
  const unsigned blocks = (unsigned)((batch + kCheckWarps - 1) / kCheckWarps);
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
// `first`, then written; consts (host): total sum, z, alpha (four limbs
// each), 1 / 2^log_size, then random_coeff's powers rc^0 .. rc^k (four limbs
// each), k the AIR's constraints.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int composition_domain(int air, const void* pre, const void* tr, const void* inter,
                                  const void* perm, const void* dinv, void* acc, int first, int64_t n,
                                  const int64_t* consts, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t *p = (const int64_t*)pre, *t = (const int64_t*)tr, *x = (const int64_t*)inter;
  const int64_t *pm = (const int64_t*)perm, *d = (const int64_t*)dinv;
  int64_t* out = (int64_t*)acc;
  if (air == kPlonk) return launch_domain<kPlonk>(p, t, x, pm, d, out, first, n, consts, s);
  if (air == kPoseidon) return launch_domain<kPoseidon>(p, t, x, pm, d, out, first, n, consts, s);
  if (air == kPlonkNp) return launch_domain<kPlonkNp>(p, t, x, pm, d, out, first, n, consts, s);
  return (int)cudaErrorInvalidValue;
}
