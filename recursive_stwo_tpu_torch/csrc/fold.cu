// The verifier's fold phase for Hopper (sm_90a), bound through a plain C
// interface (ops/build.py compiles this file with nvcc; ops/fold_cuda.py
// loads it with ctypes): the OODS quotients ("FRI answers") of every
// first-layer group, the first layer's circle folds, the inner layers' line
// folds and the last-layer polynomial check, in one launch a batch.
//
// Replaces what XLA compiled on the TPU from recursive_stwo_tpu/verifier/
// verify.py `fold_phase` (:97-126): points.py `half_index_points` (:79-160,
// with its lax.scans at :119 and :155), quotients.py `fri_answers_for_group`
// (:109-183, the rc power scan at :105), fri.py `verify_fri` (:58-207, the
// inner-layer scan at :139) and the batched inversion of core/m31.py (:195).
// The port's eager version of the same steps (verifier/points.py,
// quotients.py, fri.py, verify.fold_values_plain) is the plain version.
//
// One thread a (proof, query) slot, everything in registers.  The thread
// walks the half-index chain A_M ... A_{M - n_inner} of its query once,
// from the largest first-layer log size M down:
//   - at each group's log size L it evaluates the group's quotient at the
//     column-domain point 2 A_L (sample batch by sample batch, in
//     quotients_host.group_batches' order, rc^k a running product that
//     restarts at 1 for every group), folds it with its first-layer sibling
//     by 1/y, and adds it into the running fold with alpha_{M-L}^2;
//   - below M, inner layer i = M - 1 - L writes the running fold as its
//     self value and folds it with its sibling by 1/x of A_L;
//   - then it evaluates the last-layer polynomial at the x of 2 A_{M -
//     n_inner} (the reference's pairwise folds, as a binary counter over the
//     coefficients) and compares.
// Every value is a canonical residue and every step a field operation, so
// the results are the plain version's residues.  inv(0) = 0: a zero fold
// denominator or quotient denominator gives 0, as in the reference.
//
// Reads: per slot its raw query, its row of every tree column block of
// every group (in place, through the pointer table), its first- and
// inner-layer sibling values; per proof its samples, its QM31 parameters
// (OODS point, random coefficient, FRI alphas) and its last-layer
// polynomial.  Writes (G, B, Q, 4) answers, (n_inner, B, Q, 4) self values
// and a (B, Q) last-layer equality.
//
// What bounds it on an H100: integer ALU work, about 28k int32 operations a
// slot and 90k a proof at small_proof (ops/fold_cuda.py counts them); its
// 33 MB of int64 traffic at B = 1024 binds below that.  This first kernel
// recomputes the per-proof quotient coefficients (rc powers, the line
// coefficients of every column) in each of a proof's Q threads, Q times the
// operations the bound counts for them, and keeps the last layer's
// coefficient stack in local memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "qm31.cuh"

namespace {

using namespace qm31;

constexpr int kThreads = 128;
constexpr int kMaxLog = 31;       // log sizes of the circle's subgroups
constexpr int kMaxGroups = 8;     // first-layer log sizes
constexpr int kMaxBlocks = 32;    // tree column blocks over every group
constexpr int kMaxInner = 32;     // inner FRI layers
constexpr int kMaxLastLog = 16;   // log of the last-layer polynomial's length

// Positions in the `scalars` array (ops/fold_cuda.py writes it).
enum Scalar {
  kBatch = 0,
  kQueries,
  kSamples,
  kParams,
  kFirstLog,   // M, the largest first-layer log size
  kInner,      // n_inner
  kGroups,
  kLastLog,
  kBatchTab,   // where the batch rows start in the index table
  kInitX,      // Coset.half_odds(M).initial
  kInitY,
  kJx,         // J (points_host._J)
  kJy,
  kStep = 16,                             // point(2^(30-k)): x at kStep + 2k, y at + 1
  kGroupLog = kStep + 2 * kMaxLog,        // group g's log size
  kGroupBatch = kGroupLog + kMaxGroups,   // group g's batches: [kGroupBatch + g, kGroupBatch + g + 1)
  kBlockWidth = kGroupBatch + kMaxGroups + 1,
  kScalars = kBlockWidth + kMaxBlocks,
};

// Positions in the `ptrs` array.
enum Ptr {
  kRaw = 0,
  kSamplesPtr,
  kParamsPtr,
  kLastPoly,
  kTab,
  kAnswers,
  kSelfVals,
  kLastEq,
  kBlocks,
  kFirstSib = kBlocks + kMaxBlocks,
  kInnerSib = kFirstSib + kMaxGroups,
  kPtrs = kInnerSib + kMaxInner,
};

struct FoldArgs {
  int64_t batch;
  int n_queries, n_samples, n_params, max_log, n_inner, n_groups, last_log, batch_tab;
  uint32_t init_x, init_y, j_x, j_y;
  uint32_t step[kMaxLog][2];
  int group_log[kMaxGroups];
  int group_batch[kMaxGroups + 1];
  int block_width[kMaxBlocks];
  const int64_t* raw;        // (B, Q) raw queries
  const int64_t* samples;    // (B, n_samples, 4)
  const int64_t* params;     // (B, n_params, 4): OODS x, OODS y, random coeff, FRI alphas
  const int64_t* last_poly;  // (B, 2^last_log, 4)
  // index table: a row of 4 a sampled column in walk order (block, column
  // in the block, sample index, 0; a column sampled at two points is two
  // rows), then from batch_tab a row of 4 a sample batch (first row, rows,
  // shift point x, y; the identity (1, 0) for the OODS batch)
  const int32_t* tab;
  const int64_t* blocks[kMaxBlocks];     // (B, Q, width) tree column blocks
  const int64_t* first_sib[kMaxGroups];  // (B, Q, 4)
  const int64_t* inner_sib[kMaxInner];   // (B, Q, 4)
  int64_t* answers;                      // (n_groups, B, Q, 4)
  int64_t* self_vals;                    // (n_inner, B, Q, 4)
  bool* last_eq;                         // (B, Q)
};

__device__ __forceinline__ Q load_q(const int64_t* p) {
  return Q{(uint32_t)p[0], (uint32_t)p[1], (uint32_t)p[2], (uint32_t)p[3]};
}

__device__ __forceinline__ void store_q(int64_t* p, Q v) {
  p[0] = v.a;
  p[1] = v.b;
  p[2] = v.c;
  p[3] = v.d;
}

// (x, y) + (cx, cy) on the circle
__device__ __forceinline__ void point_add(uint32_t& x, uint32_t& y, uint32_t cx, uint32_t cy) {
  const uint32_t nx = sub(mul(x, cx), mul(y, cy));
  y = add(mul(x, cy), mul(y, cx));
  x = nx;
}

// (x, y) -> (x^2 - y^2, 2 x y)
__device__ __forceinline__ void point_double(uint32_t& x, uint32_t& y) {
  const uint32_t nx = sub(mul(x, x), mul(y, y));
  const uint32_t xy = mul(x, y);
  y = add(xy, xy);
  x = nx;
}

// (l + r) + alpha (l - r) / x, with (l, r) = (v, sib) swapped iff bit0
// (fri.py _fold)
__device__ __forceinline__ Q fold(bool bit0, Q v, Q sib, uint32_t x_inv, Q alpha) {
  const Q l = bit0 ? sib : v, r = bit0 ? v : sib;
  return q_add(q_add(l, r), q_mul(q_mul_m31(q_sub(l, r), x_inv), alpha));
}

// Group g's quotient at one slot, whose column-domain point is (dx, dy)
// (dy negated iff the query's bit 0): per sample batch, sum over its columns
// of C val - (A dy + B), with alpha_k = -2u rc^k, A = alpha_k v1, B =
// alpha_k (v0 y1 - v1 y0), C = alpha_k y1 at the batch's point (px, py),
// times 1 / ((px.re - dx) py.im - (py.re - dy) px.im) (quotients.py).
__device__ __forceinline__ Q group_answer(const FoldArgs& a, int g, const int64_t* smp, int64_t slot,
                                          uint32_t dx, uint32_t dy, Q ox, Q oy, Q rc) {
  const Q minus_2u = Q{0u, 0u, poseidon2_m31::P - 2u, 0u};
  Q acc = q_zero(), pw = q_one();
  for (int bt = a.group_batch[g]; bt < a.group_batch[g + 1]; ++bt) {
    const int32_t* row = a.tab + a.batch_tab + 4 * bt;
    const int first = row[0], n = row[1];
    const uint32_t cx = (uint32_t)row[2], cy = (uint32_t)row[3];
    // the OODS point plus the batch's shift (points.py add_constant_point)
    const Q px = q_sub(q_mul_m31(ox, cx), q_mul_m31(oy, cy));
    const Q py = q_add(q_mul_m31(ox, cy), q_mul_m31(oy, cx));
    const C y0{py.a, py.b}, y1{py.c, py.d};
    Q num = q_zero();
    for (int k = first; k < first + n; ++k) {
      const int32_t* col = a.tab + 4 * k;
      const Q sv = load_q(smp + 4 * (int64_t)col[2]);
      const C v0{sv.a, sv.b}, v1{sv.c, sv.d};
      const Q alpha = q_mul(pw, minus_2u);
      pw = q_mul(pw, rc);
      const C b_c = c_sub(c_mul(v0, y1), c_mul(v1, y0));
      const uint32_t val = (uint32_t)a.blocks[col[0]][slot * a.block_width[col[0]] + col[1]];
      const Q term = q_sub(q_mul_m31(q_mul_cm31(alpha, y1), val),
                           q_add(q_mul_m31(q_mul_cm31(alpha, v1), dy), q_mul_cm31(alpha, b_c)));
      num = q_add(num, term);
    }
    const C ta = c_mul(C{sub(px.a, dx), px.b}, C{py.c, py.d});
    const C tb = c_mul(C{sub(py.a, dy), py.b}, C{px.c, px.d});
    acc = q_add(acc, q_mul_cm31(num, c_inv(c_sub(ta, tb))));
  }
  return acc;
}

// The last-layer polynomial of length 2^d at x: the reference folds pairs
// (c_2m, c_2m+1) -> c_2m + c_2m+1 f with f the (d-1)-th doubling of x
// first, then the (d-2)-th, ...; here as a binary counter over the
// coefficients, a merge at level l with the (d-1-l)-th doubling.
__device__ __forceinline__ Q last_layer_eval(const int64_t* coeffs, int d, uint32_t x) {
  uint32_t dbl[kMaxLastLog];
  Q stack[kMaxLastLog + 1];
  if (d > 0) dbl[0] = x;
  for (int t = 1; t < d; ++t) {
    const uint32_t sq = mul(dbl[t - 1], dbl[t - 1]);
    dbl[t] = sub(add(sq, sq), 1u);
  }
  for (int j = 0; j < (1 << d); ++j) {
    Q cur = load_q(coeffs + 4 * j);
    int l = 0;
    for (; (j >> l) & 1; ++l) cur = q_add(stack[l], q_mul_m31(cur, dbl[d - 1 - l]));
    stack[l] = cur;
  }
  return stack[d];
}

// One (proof, query) slot: the thread body of fold_kernel.
__device__ __forceinline__ void fold_slot(const FoldArgs& a, int64_t slot) {
  const int64_t b = slot / a.n_queries;
  const int64_t n_slots = a.batch * a.n_queries;
  const int M = a.max_log;
  const uint32_t qmax = (uint32_t)(a.raw[slot] & ((1ll << M) - 1));
  const int64_t* par = a.params + b * a.n_params * 4;
  const Q ox = load_q(par), oy = load_q(par + 4), rc = load_q(par + 8);
  const int64_t* alphas = par + 12;
  const int64_t* smp = a.samples + b * a.n_samples * 4;

  // A_M = initial + sum over bits k >= 1 of qmax of point(2^(30-k))
  uint32_t x = a.init_x, y = a.init_y;
  for (int k = 1; k < M; ++k) {
    if ((qmax >> k) & 1u) point_add(x, y, a.step[k][0], a.step[k][1]);
  }

  Q folded = q_zero();
  int g = 0;
  for (int L = M; L >= M - a.n_inner; --L) {
    const uint32_t q = qmax >> (M - L);  // the query at log size L
    if (L < M) {
      // A_L = 2 (A_{L+1} + J if bit 0 of q_L)
      if (q & 1u) point_add(x, y, a.j_x, a.j_y);
      point_double(x, y);
      // inner layer i: its leaf value, then its fold at A_L's x
      const int i = M - 1 - L;
      store_q(a.self_vals + (i * n_slots + slot) * 4, folded);
      folded = fold(q & 1u, folded, load_q(a.inner_sib[i] + 4 * slot), inv(x), load_q(alphas + 4 * (i + 1)));
    }
    if (g < a.n_groups && a.group_log[g] == L) {
      // the column-domain point 2 A_L, y negated iff bit 0 of q_L
      uint32_t dx = x, dy = y;
      point_double(dx, dy);
      const Q ans = group_answer(a, g, smp, slot, dx, (q & 1u) ? neg(dy) : dy, ox, oy, rc);
      store_q(a.answers + (g * n_slots + slot) * 4, ans);
      // the circle fold by 1/y, entering the line folds before layer M - L
      const Q alpha = load_q(alphas + 4 * (M - L));
      const Q circle = fold(q & 1u, ans, load_q(a.first_sib[g] + 4 * slot), inv(dy), alpha);
      if (M - L < a.n_inner) folded = q_add(q_mul(folded, q_mul(alpha, alpha)), circle);
      ++g;
    }
  }

  // the last layer at the x of 2 A_{M - n_inner}
  const uint32_t lx = sub(mul(x, x), mul(y, y));
  const Q expect = last_layer_eval(a.last_poly + (b << a.last_log) * 4, a.last_log, lx);
  a.last_eq[slot] = q_eq(folded, expect);
}

// ---------------------------------------------------------------------------
// kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) fold_kernel(const __grid_constant__ FoldArgs a) {
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (slot < a.batch * a.n_queries) fold_slot(a, slot);
}

}  // namespace

// scalars: kScalars int64 (the Scalar positions above); ptrs: kPtrs device
// pointers (the Ptr positions; unused entries 0).  Launches on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a shape past the
// kernel's limits.
extern "C" int fold_phase(const int64_t* scalars, const int64_t* ptrs, void* stream) {
  FoldArgs a{};
  a.batch = scalars[kBatch];
  a.n_queries = (int)scalars[kQueries];
  a.n_samples = (int)scalars[kSamples];
  a.n_params = (int)scalars[kParams];
  a.max_log = (int)scalars[kFirstLog];
  a.n_inner = (int)scalars[kInner];
  a.n_groups = (int)scalars[kGroups];
  a.last_log = (int)scalars[kLastLog];
  a.batch_tab = (int)scalars[kBatchTab];
  if (a.max_log < 1 || a.max_log >= kMaxLog || a.n_inner < 0 || a.n_inner > kMaxInner || a.n_inner >= a.max_log ||
      a.n_groups < 1 || a.n_groups > kMaxGroups || a.last_log < 0 || a.last_log > kMaxLastLog ||
      a.n_params != 3 + a.n_inner + 1) {
    return (int)cudaErrorInvalidValue;
  }
  a.init_x = (uint32_t)scalars[kInitX];
  a.init_y = (uint32_t)scalars[kInitY];
  a.j_x = (uint32_t)scalars[kJx];
  a.j_y = (uint32_t)scalars[kJy];
  for (int k = 0; k < kMaxLog; ++k) {
    a.step[k][0] = (uint32_t)scalars[kStep + 2 * k];
    a.step[k][1] = (uint32_t)scalars[kStep + 2 * k + 1];
  }
  for (int g = 0; g < kMaxGroups; ++g) a.group_log[g] = (int)scalars[kGroupLog + g];
  for (int g = 0; g <= kMaxGroups; ++g) a.group_batch[g] = (int)scalars[kGroupBatch + g];
  for (int k = 0; k < kMaxBlocks; ++k) a.block_width[k] = (int)scalars[kBlockWidth + k];
  a.raw = (const int64_t*)ptrs[kRaw];
  a.samples = (const int64_t*)ptrs[kSamplesPtr];
  a.params = (const int64_t*)ptrs[kParamsPtr];
  a.last_poly = (const int64_t*)ptrs[kLastPoly];
  a.tab = (const int32_t*)ptrs[kTab];
  for (int k = 0; k < kMaxBlocks; ++k) a.blocks[k] = (const int64_t*)ptrs[kBlocks + k];
  for (int g = 0; g < kMaxGroups; ++g) a.first_sib[g] = (const int64_t*)ptrs[kFirstSib + g];
  for (int i = 0; i < kMaxInner; ++i) a.inner_sib[i] = (const int64_t*)ptrs[kInnerSib + i];
  a.answers = (int64_t*)ptrs[kAnswers];
  a.self_vals = (int64_t*)ptrs[kSelfVals];
  a.last_eq = (bool*)ptrs[kLastEq];
  const int64_t n = a.batch * a.n_queries;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fold_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
