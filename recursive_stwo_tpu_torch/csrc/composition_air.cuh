// The three composition AIRs, emitting their constraints straight into a
// sink, over the QM31 arithmetic of qm31.cuh.
//
// Twin of recursive_stwo_tpu/verifier/composition.py (`_Eval`,
// `evaluate_plonk` :176-210, `evaluate_plonk_np` :230-277,
// `evaluate_poseidon` :373-501 with its partial-round scan at :437, and the
// Horner scan `_horner` :508-530), which XLA fused on the TPU, and of the
// port's eager version (verifier/composition.py).  Every value is a
// canonical residue, so a correct field operation gives the eager version's
// residue whatever its order of evaluation; what must match is the set of
// constraints and their emission order, which is the Horner order:
//   plonk     3 enforce_c_m31, the gate, 2 logup
//   poseidon  16 first-round, 16 + 16 full-round, 14 partial, 16
//             partial-out, 2 logup
//   np        4 a^4 - b, the gate, 2 logup
// Blocks go out lane by lane, and the partial rounds' constraints are
// emitted as each round computes them (nothing else is emitted between
// them, so the order is the reference's block order).  The Horner value of
// n constraints from acc, acc rc^n + sum of c_i rc^(n-1-i), is the same
// residue as the fold acc = acc rc + c_i (exact over M31), so a sink may
// weight each constraint by its power of rc instead of folding.
//
// A source supplies a component's masks (ops below): the verifier's reads one
// proof's samples at the OODS point through an index table, the prover's one
// point of the evaluation domain from LDE rows, or one row of the base trace.
// A sink takes each constraint: `PowerSum` (the domain kernel) weights it by
// the launch's power table and sums; `Capture` (the check kernel) keeps it,
// for the check weights every constraint by its power of rc on the lane that
// computes it.  A sink whose `kGenerate` is true (interaction.cu's, the
// generation mode of the JAX package's `_InteractionEval`) takes each logup
// batch's fraction p / q instead, and no constraint: `Component::emit` does
// nothing for it, so the constraints' arithmetic is dead code the compiler
// drops, and the poseidon AIR skips its rounds outright.  The other sinks'
// code is unchanged by the mode (`if constexpr`).
//
// kPlonkConstraints, kPoseidonConstraints and kNpConstraints below list each
// AIR's constraints in emission order as (kind, count) blocks: the order the
// straight-line evaluators emit and the check kernel's lane table
// (ops/composition_cuda.py `AIR_CONSTRAINTS`, `lane_table`, which a CPU test
// holds to this table and to the reference's emission) weights.
#pragma once

#include <cstdint>

#include "qm31.cuh"

namespace composition {

using poseidon2_m31::add;
using poseidon2_m31::mul;
using poseidon2_m31::neg;
using poseidon2_m31::sub;
using namespace qm31;

__device__ __forceinline__ Q q_pow5(Q x) {
  const Q x2 = q_mul(x, x);
  return q_mul(q_mul(x2, x2), x);
}

// v0 + v1 i + v2 u + v3 i u (q_combine4)
__device__ __forceinline__ Q q_combine4(Q v0, Q v1, Q v2, Q v3) {
  const Q s_i = Q{neg(v1.b), v1.a, neg(v1.d), v1.c};
  // (p + q u) u = (2 + i) q + p u
  const Q s_j = Q{sub(add(v2.c, v2.c), v2.d), add(add(v2.d, v2.d), v2.c), v2.a, v2.b};
  const Q v3i = Q{neg(v3.b), v3.a, neg(v3.d), v3.c};
  const Q s_ij = Q{sub(add(v3i.c, v3i.c), v3i.d), add(add(v3i.d, v3i.d), v3i.c), v3i.a, v3i.b};
  return q_add(q_add(v0, s_i), q_add(s_j, s_ij));
}

// A 16-word QM31 state, limb-major, so that the linear layers (adds and
// constant scalings only) run limb by limb through m31.cuh.
struct State {
  uint32_t l[4][16];
};

__device__ __forceinline__ Q get(const State& s, int i) {
  return Q{s.l[0][i], s.l[1][i], s.l[2][i], s.l[3][i]};
}

__device__ __forceinline__ void set(State& s, int i, Q v) {
  s.l[0][i] = v.a;
  s.l[1][i] = v.b;
  s.l[2][i] = v.c;
  s.l[3][i] = v.d;
}

__device__ __forceinline__ void mds16(State& s) {
#pragma unroll
  for (int k = 0; k < 4; ++k) poseidon2_m31::mds16(s.l[k]);
}

__device__ __forceinline__ void internal16(State& s) {
#pragma unroll
  for (int k = 0; k < 4; ++k) poseidon2_m31::internal16(s.l[k]);
}

// Constraint kinds (ops/composition_cuda.py KINDS, in this order).
enum Kind { kEnforceCm31 = 0, kGate, kLogup, kFirstRound, kFullRound, kFullRoundOut, kPartialRound, kPartialOut, kA4 };
struct Block {
  Kind kind;
  int count;
};
constexpr Block kPlonkConstraints[] = {{kEnforceCm31, 3}, {kGate, 1}, {kLogup, 2}};
constexpr Block kPoseidonConstraints[] = {{kFirstRound, 16}, {kFullRound, 16}, {kFullRoundOut, 16},
                                          {kPartialRound, 14}, {kPartialOut, 16}, {kLogup, 2}};
constexpr Block kNpConstraints[] = {{kA4, 4}, {kGate, 1}, {kLogup, 2}};

template <int K>
__host__ __device__ constexpr int n_constraints(const Block (&blocks)[K]) {
  int n = 0;
  for (int i = 0; i < K; ++i) n += blocks[i].count;
  return n;
}

// The check kernel's lanes (composition.cu `check_warp`, `poseidon_lanes`):
// each block of one component's constraints of one kind, in emission order,
// on lanes lane0 .. lane0 + count - 1 of one stage.  The kernel takes its
// stages and lanes from here (static_asserts tie its code to the lanes), and
// ops/composition_cuda.py `LANE_BLOCKS`, which gives each (stage, lane) its
// power of rc, is this table (a CPU test parses it).
struct LaneBlock {
  int stage, lane0, component;
  Kind kind;
  int count;
};
constexpr LaneBlock kPoseidonLanes[] = {
    {0, 0, 1, kFirstRound, 16},   {1, 0, 1, kFullRound, 16},    {2, 0, 0, kEnforceCm31, 3}, {2, 3, 0, kGate, 1},
    {2, 4, 0, kLogup, 2},         {2, 6, 1, kLogup, 2},         {2, 16, 1, kFullRoundOut, 16},
    {3, 0, 1, kPartialRound, 14}, {3, 16, 1, kPartialOut, 16}};
constexpr LaneBlock kNpLanes[] = {{0, 0, 0, kA4, 4}, {0, 4, 0, kGate, 1}, {0, 5, 0, kLogup, 2}};

// The block of (component, kind) in a lane table; stage -1 if none.
template <int K>
__host__ __device__ constexpr LaneBlock lane_block(const LaneBlock (&t)[K], int component, Kind kind) {
  for (int i = 0; i < K; ++i) {
    if (t[i].component == component && t[i].kind == kind) return t[i];
  }
  return LaneBlock{-1, -1, component, kind, 0};
}

// The domain kernel's sink: S = sum of c_i rc^(N-1-i) over an AIR's N
// constraints, i the emission index, from the launch's power table (Pw's
// power(k) = rc^k, the same at every point).  On the prover's M31 rows every
// constraint but the logup's is M31-valued (limbs b, c and d zero, which the
// compiler sees): such a constraint costs four 32 x 32 -> 64-bit products
// into four lazy limb sums; any other a QM31 product, its canonical limbs
// added.  Every third constraint folds the sums below 2^62 + 4 (2^62 = 1
// mod p), so the next three products, each below 2^62 - 2^33 + 5, cannot
// overflow 64 bits.
template <class Pw, int N>
struct PowerSum {
  static constexpr bool kGenerate = false;
  const Pw& pw;
  uint64_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  int i = 0;

  __device__ __forceinline__ explicit PowerSum(const Pw& p) : pw(p) {}

  template <class Src>
  __device__ __forceinline__ void emit(const Src&, Q c) {
    const Q p = pw.power(N - 1 - i);
    if ((c.b | c.c | c.d) == 0) {
      s0 += (uint64_t)c.a * p.a;
      s1 += (uint64_t)c.a * p.b;
      s2 += (uint64_t)c.a * p.c;
      s3 += (uint64_t)c.a * p.d;
    } else {
      const Q t = q_mul(c, p);
      s0 += t.a;
      s1 += t.b;
      s2 += t.c;
      s3 += t.d;
    }
    if (++i % 3 == 0) {
      s0 = fold62(s0);
      s1 = fold62(s1);
      s2 = fold62(s2);
      s3 = fold62(s3);
    }
  }

  __device__ __forceinline__ static uint64_t fold62(uint64_t x) { return (x & ((1ull << 62) - 1)) + (x >> 62); }

  // x mod p: x = lo + mid 2^31 + hi 2^62 = lo + mid + hi (mod p), below 2^32 + 2
  __device__ __forceinline__ static uint32_t reduce(uint64_t x) {
    const uint64_t t = (x & poseidon2_m31::P) + ((x >> 31) & poseidon2_m31::P) + (x >> 62);
    const uint32_t r = (uint32_t)(t & poseidon2_m31::P) + (uint32_t)(t >> 31);
    return min(r, r - poseidon2_m31::P);
  }

  __device__ __forceinline__ Q value() const { return Q{reduce(s0), reduce(s1), reduce(s2), reduce(s3)}; }
};

// The first K constraints emitted, unscaled (the check kernel).
template <int K>
struct Capture {
  static constexpr bool kGenerate = false;
  Q v[K];
  int n = 0;

  template <class Src>
  __device__ __forceinline__ void emit(const Src&, Q c) {
    v[n++] = c;
  }
};

// Interaction masks a component of n fractions in batches of bs reads: one
// row of four columns a batch, and the previous row too for the last.
__host__ __device__ constexpr int interaction_reads(int n, int bs) { return 4 * ((n + bs - 1) / bs) + 4; }

// One component (one AIR over one table): `Src` has pre(i), tr(i) (the
// component's i-th preprocessed / trace mask), ext(m) (the m-th interaction
// mask, four columns combined) and ext_pair(m, prev, cur) (its previous and
// current row).  N fractions, batched by BS: each relation folds into its
// batch's running fraction p / q as it is produced (finalize_logup's p = p
// den + num q, q = q den), and the relation that ends a batch emits the
// batch's constraint, each batch but the last against one interaction row
// (the running column sums), the last against its previous and current row.
// The AIRs emit no constraint between relations, so the order is finalize's.
// In generation mode (Sink::kGenerate) a batch's end hands the sink its
// fraction instead, `h.batch(b, p, q)`, and reads no interaction
// mask.
template <class Src, class Sink, int N, int BS>
struct Component {
  static constexpr int kBatches = (N + BS - 1) / BS;
  const Src& src;
  Sink& h;
  Q z, alpha, alpha2, shift;  // lookup elements, alpha^2 and the cumsum_shift
  Q p, q, prev_cum;           // the open batch's fraction, the last batch's row
  int n;                      // relations so far

  __device__ __forceinline__ Component(const Src& s, Sink& hh, Q z_, Q alpha_, Q shift_)
      : src(s), h(hh), z(z_), alpha(alpha_), alpha2(q_mul(alpha_, alpha_)), shift(shift_), prev_cum(q_zero()),
        n(0) {}

  __device__ __forceinline__ void emit(Q v) {
    if constexpr (!Sink::kGenerate) h.emit(src, v);
  }

  // add_to_relation: values[0] + alpha values[1] (+ alpha^2 values[2]) - z
  __device__ __forceinline__ void relation(Q mult, Q v0, Q v1) {
    fraction(mult, q_sub(q_add(v0, q_mul(alpha, v1)), z));
  }

  __device__ __forceinline__ void relation(Q mult, Q v0, Q v1, Q v2) {
    fraction(mult, q_sub(q_add(q_add(v0, q_mul(alpha, v1)), q_mul(alpha2, v2)), z));
  }

  __device__ __forceinline__ void fraction(Q num, Q den) {
    if (n % BS == 0) {
      p = num;
      q = den;
    } else {
      p = q_add(q_mul(p, den), q_mul(num, q));
      q = q_mul(q, den);
    }
    ++n;
    if (n % BS != 0 && n != N) return;
    const int b = (n - 1) / BS;
    if constexpr (Sink::kGenerate) {
      h.batch(b, p, q);
    } else if (b < kBatches - 1) {
      const Q cur = src.ext(b);
      const Q diff = q_sub(cur, prev_cum);
      prev_cum = cur;
      emit(q_sub(q_mul(diff, q), p));
    } else {
      Q prev_row, cur;
      src.ext_pair(b, prev_row, cur);
      const Q fixed = q_add(q_sub(q_sub(cur, prev_row), prev_cum), shift);
      emit(q_sub(q_mul(fixed, q), p));
    }
  }
};

// ---------------------------------------------------------------------------
// plonk AIR: 10 preprocessed, 12 trace columns, 4 fractions in batches of 2
// ---------------------------------------------------------------------------
constexpr int kPlonkPre = 10, kPlonkTrace = 12, kPlonkFracs = 4, kPlonkBatch = 2;

template <class Src, class Sink>
__device__ __forceinline__ void evaluate_plonk(const Src& s, Sink& h, Q z, Q alpha, Q shift) {
  Component<Src, Sink, kPlonkFracs, kPlonkBatch> ev(s, h, z, alpha, shift);
  const Q a_wire = s.pre(0), b_wire = s.pre(1), c_wire = s.pre(2), op = s.pre(3);
  const Q mult_a = s.pre(4), mult_b = s.pre(5), mult_c = s.pre(6);
  const Q poseidon_wire = s.pre(7), mult_poseidon = s.pre(8), enforce_c_m31 = s.pre(9);

  ev.emit(q_mul(enforce_c_m31, s.tr(9)));
  ev.emit(q_mul(enforce_c_m31, s.tr(10)));
  ev.emit(q_mul(enforce_c_m31, s.tr(11)));

  const Q a_val = q_combine4(s.tr(0), s.tr(1), s.tr(2), s.tr(3));
  const Q b_val = q_combine4(s.tr(4), s.tr(5), s.tr(6), s.tr(7));
  const Q c_val = q_combine4(s.tr(8), s.tr(9), s.tr(10), s.tr(11));
  const Q gate = q_sub(q_sub(c_val, q_mul(op, q_add(a_val, b_val))),
                       q_mul(q_mul(q_sub(q_one(), op), a_val), b_val));
  ev.emit(gate);

  ev.relation(mult_a, a_val, a_wire);
  ev.relation(mult_b, b_val, b_wire);
  ev.relation(mult_c, c_val, c_wire);
  ev.relation(q_neg(mult_poseidon), poseidon_wire, a_val, b_val);
}

// ---------------------------------------------------------------------------
// PlonkWithoutPoseidon AIR: 8 preprocessed, 12 trace columns, 3 fractions in
// batches of 2
// ---------------------------------------------------------------------------
constexpr int kNpPre = 8, kNpTrace = 12, kNpFracs = 3, kNpBatch = 2;

template <class Src, class Sink>
__device__ __forceinline__ void evaluate_plonk_np(const Src& s, Sink& h, Q z, Q alpha, Q shift) {
  Component<Src, Sink, kNpFracs, kNpBatch> ev(s, h, z, alpha, shift);
  const Q a_wire = s.pre(0), b_wire = s.pre(1), c_wire = s.pre(2);
  const Q op1 = s.pre(3), op2 = s.pre(4), op3 = s.pre(5), op4 = s.pre(6), mult_c = s.pre(7);
  Q a4[4], b4[4], c4[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a4[k] = s.tr(k);
    b4[k] = s.tr(4 + k);
    c4[k] = s.tr(8 + k);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Q a2 = q_mul(a4[k], a4[k]);
    ev.emit(q_mul(op2, q_sub(q_mul(a2, a2), b4[k])));
  }

  Q hh[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) hh[k] = q_mul(a4[k], b4[k]);
  // _m4_list
  const Q t0 = q_add(hh[0], hh[1]);
  const Q t1 = q_add(hh[2], hh[3]);
  const Q t2 = q_add(q_add(hh[1], hh[1]), t1);
  const Q t3 = q_add(q_add(hh[3], hh[3]), t0);
  const Q t02 = q_add(t0, t0), t12 = q_add(t1, t1);
  const Q t4 = q_add(q_add(t12, t12), t3);
  const Q t5 = q_add(q_add(t02, t02), t2);
  const Q m4 = q_combine4(q_add(t3, t5), t5, q_add(t2, t4), t4);
  const Q gs = q_add(q_add(q_add(a4[0], a4[1]), q_add(a4[2], a4[3])),
                     q_add(q_add(b4[0], b4[1]), q_add(b4[2], b4[3])));

  const Q a_val = q_combine4(a4[0], a4[1], a4[2], a4[3]);
  const Q b_val = q_combine4(b4[0], b4[1], b4[2], b4[3]);
  const Q c_val = q_combine4(c4[0], c4[1], c4[2], c4[3]);
  const Q one = q_one();
  const Q one_m_op3 = q_sub(one, op3), one_m_op4 = q_sub(one, op4);
  const Q is_arith = q_mul(one_m_op3, one_m_op4);
  const Q is_m4 = q_mul(op3, one_m_op4);
  const Q is_hadamard = q_mul(one_m_op3, op4);
  const Q is_grandsum = q_mul(op3, op4);
  const Q expected = q_add(
      q_add(q_add(q_mul(is_arith, q_mul(op1, q_add(a_val, b_val))),
                  q_mul(q_mul(q_sub(one, op1), a_val), b_val)),
            q_mul(is_m4, m4)),
      q_add(q_mul(is_hadamard, q_combine4(hh[0], hh[1], hh[2], hh[3])),
            q_mul(is_grandsum, q_combine4(gs, gs, gs, gs))));
  ev.emit(q_sub(c_val, expected));

  ev.relation(one, a_val, a_wire);
  ev.relation(one, b_val, b_wire);
  ev.relation(mult_c, c_val, c_wire);
}

// ---------------------------------------------------------------------------
// poseidon AIR: 40 preprocessed (is_first, is_last, is_full, round_id, rc0
// x16, rc1 x16, ext1, ext2, ext1_nz, ext2_nz), 48 trace columns (in_state,
// inter, out_state, 16 each), 5 fractions in batches of 3
// ---------------------------------------------------------------------------
constexpr int kPoseidonPre = 40, kPoseidonTrace = 48, kPoseidonFracs = 5, kPoseidonBatch = 3;
constexpr int kRc0 = 4, kRc1 = 20, kExt = 36;     // preprocessed positions
constexpr int kIn = 0, kInter = 16, kOut = 32;    // trace positions

template <class Src>
__device__ __forceinline__ Q quarter(const Src& s, int base, int i) {
  return q_combine4(s.tr(base + 4 * i), s.tr(base + 4 * i + 1), s.tr(base + 4 * i + 2),
                    s.tr(base + 4 * i + 3));
}

// The poseidon AIR's 78 round constraints (every block but the logup).
template <class Src, class Ev>
__device__ __forceinline__ void poseidon_rounds(const Src& s, Ev& ev) {
  const Q one = q_one();
  const Q is_first = s.pre(0), is_full = s.pre(2);
  const Q is_partial = q_sub(q_sub(one, is_first), is_full);
  const Q swap_bit_value = s.tr(kInter);

  // first round: swap halves (in_state rolled by 8 where the bit is set),
  // then the external matrix
  {
    const Q nsw = q_sub(one, swap_bit_value);
    State st;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      set(st, i, q_add(q_mul(s.tr(kIn + i), nsw), q_mul(s.tr(kIn + ((i + 8) & 15)), swap_bit_value)));
    }
    mds16(st);
#pragma unroll
    for (int i = 0; i < 16; ++i) ev.emit(q_mul(is_first, q_sub(get(st, i), s.tr(kOut + i))));
  }

  // full round: inter = pow5(in + rc0), out = mds16(pow5(mds16(inter) + rc1))
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const Q frs = q_pow5(q_add(s.tr(kIn + i), s.pre(kRc0 + i)));
    ev.emit(q_mul(is_full, q_sub(s.tr(kInter + i), frs)));
  }
  {
    State st;
#pragma unroll
    for (int i = 0; i < 16; ++i) set(st, i, s.tr(kInter + i));
    mds16(st);
#pragma unroll
    for (int i = 0; i < 16; ++i) set(st, i, q_pow5(q_add(get(st, i), s.pre(kRc1 + i))));
    mds16(st);
#pragma unroll
    for (int i = 0; i < 16; ++i) ev.emit(q_mul(is_full, q_sub(s.tr(kOut + i), get(st, i))));
  }

  // 14 partial rounds: inter[r] - pow5(state[0] + rc0[r]), then the
  // committed inter[r] (not the S-box) goes into word 0 before the internal
  // matrix; then out_state - state
  {
    State st;
#pragma unroll
    for (int i = 0; i < 16; ++i) set(st, i, s.tr(kIn + i));
#pragma unroll 1
    for (int r = 0; r < 14; ++r) {
      const Q inter_r = s.tr(kInter + r);
      ev.emit(q_mul(is_partial, q_sub(inter_r, q_pow5(q_add(get(st, 0), s.pre(kRc0 + r))))));
      set(st, 0, inter_r);
      internal16(st);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) ev.emit(q_mul(is_partial, q_sub(s.tr(kOut + i), get(st, i))));
  }
}

// The poseidon AIR's lookup relations and their 2 logup constraints.
template <class Src, class Ev>
__device__ __forceinline__ void poseidon_logup(const Src& s, Ev& ev) {
  const Q one = q_one();
  const Q is_first = s.pre(0), is_last = s.pre(1);
  const Q is_not_first = q_sub(one, is_first), is_not_last = q_sub(one, is_last);
  const Q swap_bit_value = s.tr(kInter);
  const Q round_id = s.pre(3);
  const Q ext1 = s.pre(kExt), ext2 = s.pre(kExt + 1), ext1_nz = s.pre(kExt + 2), ext2_nz = s.pre(kExt + 3);
  const Q in_left_id = q_add(round_id, round_id);
  const Q in_right_id = q_add(in_left_id, one);
  const Q out_left_id = q_add(in_right_id, one);
  const Q out_right_id = q_add(out_left_id, one);

  ev.relation(q_sub(q_mul(ext1_nz, is_first), is_not_first),
              q_add(q_mul(is_first, ext1), q_mul(is_not_first, in_left_id)),
              quarter(s, kIn, 0), quarter(s, kIn, 1));
  ev.relation(q_sub(q_mul(ext2_nz, is_first), is_not_first),
              q_add(q_mul(is_first, ext2), q_mul(is_not_first, in_right_id)),
              quarter(s, kIn, 2), quarter(s, kIn, 3));
  ev.relation(q_add(q_mul(ext1_nz, is_last), is_not_last),
              q_add(q_mul(is_last, ext1), q_mul(is_not_last, out_left_id)),
              quarter(s, kOut, 0), quarter(s, kOut, 1));
  ev.relation(q_add(q_mul(ext2_nz, is_last), is_not_last),
              q_add(q_mul(is_last, ext2), q_mul(is_not_last, out_right_id)),
              quarter(s, kOut, 2), quarter(s, kOut, 3));
  ev.relation(q_mul(is_first, is_not_last), swap_bit_value, s.pre(kRc0));
}

template <class Src, class Sink>
__device__ __forceinline__ void evaluate_poseidon(const Src& s, Sink& h, Q z, Q alpha, Q shift) {
  Component<Src, Sink, kPoseidonFracs, kPoseidonBatch> ev(s, h, z, alpha, shift);
  if constexpr (!Sink::kGenerate) poseidon_rounds(s, ev);
  poseidon_logup(s, ev);
}

}  // namespace composition
