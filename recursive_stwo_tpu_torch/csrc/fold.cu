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
// What bounds it on an H100: its int64 traffic (every input read once) and
// its integer ALU work, about equally (ops/fold_cuda.py counts both: 64k
// int32 operations a proof and 8k-22k a (proof, query) slot at the
// fixtures' shapes).  A third to a half of a proof's operations are
// per-proof: the quotients' line coefficients of every sampled column
// (142 at small_proof and the deep fixture), which do not depend on the
// query.  At the batches verifiers run (128-1024 proofs, a block each) a
// block's latency, not the card's rate, sets the time.
//
// The design: a block a proof, 128 threads, every intermediate in shared
// memory (ops/fold_cuda.py `smem_layout` places it; no local memory).
// Done once a proof, by the whole block:
//   - alpha_k = -2u rc^k for k below the largest group's column count (a
//     warp: lane l rc^l by square-and-multiply, then steps of rc^32; every
//     thread taking its own k would repeat the same squarings 128 times,
//     which at 1024 proofs costs more issue slots than the rest of this
//     step), each sample batch's shifted OODS
//     point (px, py), and for every sampled column in walk order
//     (quotients_host.group_batches', rc^k restarting at 1 each group) its
//     C = alpha_k y1, A = alpha_k v1 and B = alpha_k (v0 y1 - v1 y0); then
//     each batch's SA = sum of A and SB = sum of B (a warp a batch).  A
//     slot's batch numerator sum of C val - (A dy + B) is then
//     sum of C val - (SA dy + SB): one M31 x QM31 product a column a slot;
//   - the FRI alphas, and, for up to 2^10 of them, its last-layer
//     coefficients, staged in shared memory.
// Each chunk of the proof's queries (all of them when Q <= 128) has its
// siblings and its rows of every tree column block staged too, by 4-byte
// asynchronous copies (cp.async, the low word of each canonical int64) that
// the block issues before the work that does not need them (the first
// chunk's, and the coefficients', at the block's start), so that no step
// waits on device memory in a loop.  Then per chunk:
//   1. a thread a query walks the half-index chain A_M ... A_{M - n_inner}
//      once and writes what needs an inverse (each inner layer's x, each
//      group's y, each batch's denominator norm), each batch's
//      denominator and the last layer's doublings;
//   2. the block inverts every value of the chunk, a value a thread (none
//      on a fold's critical path);
//   3. W lanes a query (fold_cuda.lanes_per_query: 8 at Q = 16, 16 at Q = 8)
//      split each batch's columns (lane w the columns first + w, first + w +
//      W, ..., each read from the staged rows through the entry's offset and
//      width), scale their partial sums by the batch's 1 / denominator,
//      lane 0 taking the batch's -(SA dy + SB); a shuffle sum per group
//      gives the answer;
//   4. a thread a query runs the fold chain: each group's circle fold by
//      1/dy, each inner layer's self value and line fold by 1/x, a QM31
//      product a layer;
//   5. W lanes a query evaluate the last-layer polynomial at the x of 2
//      A_{M - n_inner}: lane w the coefficients j = w mod W (bank-conflict
//      free), folded with the doublings of the high levels (an unrolled
//      tree of 8 and a product of doublings a block of 8), then a shuffle
//      combine with the doublings of the low levels; lane 0 compares.
// The alpha powers, shifted points, line coefficients and denominators are
// quotient.cuh's, which quotients.cu shares for the provers' quotients.
// Every value is a canonical residue and every step a field operation, so
// the results are the plain version's residues whatever the order of the
// sums.  inv(0) = 0: a zero fold denominator or quotient denominator gives
// 0, as in the reference.
//
// Reads: per slot its raw query, its row of every tree column block of
// every group (in place, through the pointer table), its first- and
// inner-layer sibling values; per proof its samples, its QM31 parameters
// (OODS point, random coefficient, FRI alphas) and its last-layer
// polynomial.  Writes (G, B, Q, 4) answers, (n_inner, B, Q, 4) self values
// and a (B, Q) last-layer equality.

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "quotient.cuh"

namespace {

using namespace qm31;
using quotient::load_q;
using quotient::store_q;

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 8;  // 1024 proofs in one wave on 132 SMs: at most 64 registers a thread
constexpr int kMaxLog = 31;       // log sizes of the circle's subgroups
constexpr int kMaxGroups = 8;     // first-layer log sizes
constexpr int kMaxBlocks = 32;    // tree column blocks over every group
constexpr int kMaxInner = 32;     // inner FRI layers
constexpr int kMaxLastLog = 16;   // log of the last-layer polynomial's length
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSmemMax = 232448;  // an H100 block's shared memory

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
  kEntries,    // sampled columns in walk order; the batch rows follow them in the table
  kInitX,      // Coset.half_odds(M).initial
  kInitY,
  kJx,         // J (points_host._J)
  kJy,
  kLanes,      // W, lanes a query in steps 3 and 5
  kChunk,      // queries a chunk
  kAlphaRows,  // rows of the alpha_k table
  kStep,                                  // point(2^(30-k)): x at kStep + 2k, y at + 1
  kGroupLog = kStep + 2 * kMaxLog,        // group g's log size
  kGroupBatch = kGroupLog + kMaxGroups,   // group g's batches: [kGroupBatch + g, kGroupBatch + g + 1)
  kBlockWidth = kGroupBatch + kMaxGroups + 1,
  kLayout = kBlockWidth + kMaxBlocks,     // shared-memory offsets in words (enum Region), then the bytes
  kScalars = kLayout + 20,
};

// Shared-memory regions, in the order of kLayout's offsets
// (ops/fold_cuda.py SMEM_REGIONS).  Q-valued regions first, 16-byte aligned.
// A and B, needed only for the batch sums before step 1, share the space
// of the chunk's scratch (kRAns .. kRDbl), which step 1 writes first.
enum Region {
  kRAlpha = 0,  // alpha_k (kAlphaRows Q)
  kRC,          // C of each entry (Q)
  kRPxy,        // (px, py) of each batch (2 Q)
  kRSums,       // (SA, SB) of each batch (2 Q)
  kRFri,        // the n_inner + 1 FRI alphas (Q)
  kRCoef,       // the staged last-layer coefficients (2^last_log Q, or none)
  kRSib,        // (n_groups + n_inner) x chunk siblings (Q): the first layer's, then the inner layers'
  kRAns,        // n_groups x chunk answers (Q)
  kRFolded,     // chunk folded values (Q)
  kRInv,        // chunk x n_inv values, then their inverses: x_i, y_g, batch norms
  kRDy,         // chunk x n_groups signed dy
  kRDen,        // chunk x n_batches x 2 denominators (re, im)
  kRDbl,        // chunk x last_log doublings f_l (level l's)
  kRCols,       // the chunk's rows of each tree column block, block k at chunk x (widths before k)
  kRColAt,      // each entry's (place in kRCols of query 0's row, width)
  kRA,          // A of each entry (Q), over kRAns ..
  kRB,          // B of each entry (Q)
  kRegions,
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
  int n_queries, n_samples, n_params, max_log, n_inner, n_groups, last_log, n_entries;
  int lanes, lanes_log, chunk, alpha_rows, staged, last_lanes_log;
  int region[kRegions];
  int smem_bytes;
  uint32_t init_x, init_y, j_x, j_y;
  uint32_t step[kMaxLog][2];
  int group_log[kMaxGroups];
  int group_batch[kMaxGroups + 1];
  int block_width[kMaxBlocks];
  int n_blocks;
  int block_at[kMaxBlocks];  // block k's rows in kRCols: chunk x the widths before k
  const int64_t* raw;        // (B, Q) raw queries
  const int64_t* samples;    // (B, n_samples, 4)
  const int64_t* params;     // (B, n_params, 4): OODS x, OODS y, random coeff, FRI alphas
  const int64_t* last_poly;  // (B, 2^last_log, 4)
  // index table: a row of 4 a sampled column in walk order (block, column
  // in the block, sample index, its batch; a column sampled at two points is
  // two rows), then a row of 4 a sample batch (first row, rows, shift point
  // x, y; the identity (1, 0) for the OODS batch)
  const int32_t* tab;
  const int64_t* blocks[kMaxBlocks];     // (B, Q, width) tree column blocks
  const int64_t* first_sib[kMaxGroups];  // (B, Q, 4)
  const int64_t* inner_sib[kMaxInner];   // (B, Q, 4)
  int64_t* answers;                      // (n_groups, B, Q, 4)
  int64_t* self_vals;                    // (n_inner, B, Q, 4)
  bool* last_eq;                         // (B, Q)

  __device__ __forceinline__ int n_batches() const { return group_batch[n_groups]; }
  __device__ __forceinline__ int n_inv() const { return n_inner + n_groups + n_batches(); }
  __device__ __forceinline__ const int32_t* batch_row(int bt) const { return tab + 4 * (n_entries + bt); }
};

__device__ __forceinline__ Q shfl_xor_q(Q v, int m) {
  return Q{__shfl_xor_sync(kFull, v.a, m), __shfl_xor_sync(kFull, v.b, m), __shfl_xor_sync(kFull, v.c, m),
           __shfl_xor_sync(kFull, v.d, m)};
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

// One block's view of its shared memory.
struct Smem {
  uint32_t* base;
  const FoldArgs& a;

  __device__ __forceinline__ Q* q(Region r) const { return reinterpret_cast<Q*>(base + a.region[r]); }
  __device__ __forceinline__ uint32_t* w(Region r) const { return base + a.region[r]; }
};

// ---------------------------------------------------------------------------
// once a proof
// ---------------------------------------------------------------------------

// The proof's quotient coefficients and their batch sums, its shifted
// points and FRI alphas (see the head of this file).  Ends before a
// __syncthreads the caller makes.
__device__ __forceinline__ void proof_coefficients(const FoldArgs& a, const Smem& sm, int64_t b) {
  const int t = threadIdx.x;
  const int64_t* par = a.params + b * a.n_params * 4;
  const Q ox = load_q(par), oy = load_q(par + 4), rc = load_q(par + 8);

  // alpha_k = -2u rc^k, on the last warp (the rest of the block has its own
  // work): lane l takes rc^l by its index's bits, then k = l, l + 32, ...
  if (t >= kThreads - 32) quotient::alpha_powers(rc, t - (kThreads - 32), a.alpha_rows, sm.q(kRAlpha));
  // each batch's point: the OODS point plus the batch's shift
  // (points.py add_constant_point)
  Q* pxy = sm.q(kRPxy);
  for (int bt = t; bt < a.n_batches(); bt += kThreads) {
    const int32_t* row = a.batch_row(bt);
    quotient::batch_point(ox, oy, (uint32_t)row[2], (uint32_t)row[3], pxy[2 * bt], pxy[2 * bt + 1]);
  }
  uint32_t* fri = sm.w(kRFri);
  for (int k = t; k < 4 * (a.n_inner + 1); k += kThreads) fri[k] = (uint32_t)par[12 + k];
  __syncthreads();

  // C, A and B of every sampled column
  const int64_t* smp = a.samples + b * a.n_samples * 4;
  const Q* alpha = sm.q(kRAlpha);
  for (int e = t; e < a.n_entries; e += kThreads) {
    const int32_t* row = a.tab + 4 * e;
    const int bt = row[3];
    sm.w(kRColAt)[2 * e] = a.block_at[row[0]] + row[1];
    sm.w(kRColAt)[2 * e + 1] = a.block_width[row[0]];
    int g = 0;
    while (a.group_batch[g + 1] <= bt) ++g;
    const Q al = alpha[e - a.batch_row(a.group_batch[g])[0]];
    const Q sv = load_q(smp + 4 * (int64_t)row[2]);
    const quotient::LineCoeffs lc = quotient::line_coeffs(al, sv, pxy[2 * bt + 1]);
    sm.q(kRC)[e] = lc.c;
    sm.q(kRA)[e] = lc.a;
    sm.q(kRB)[e] = lc.b;
  }
  __syncthreads();

  // SA and SB of each batch, a warp a batch
  const int warp = t >> 5, lane = t & 31;
  for (int bt = warp; bt < a.n_batches(); bt += kThreads / 32) {
    const int32_t* row = a.batch_row(bt);
    Q sa = q_zero(), sb = q_zero();
    for (int k = row[0] + lane; k < row[0] + row[1]; k += 32) {
      sa = q_add(sa, sm.q(kRA)[k]);
      sb = q_add(sb, sm.q(kRB)[k]);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      sa = q_add(sa, shfl_xor_q(sa, m));
      sb = q_add(sb, shfl_xor_q(sb, m));
    }
    if (lane == 0) {
      sm.q(kRSums)[2 * bt] = sa;
      sm.q(kRSums)[2 * bt + 1] = sb;
    }
  }
}

// ---------------------------------------------------------------------------
// per chunk of queries
// ---------------------------------------------------------------------------

// Copies the low words of n int64 values at src to dst in shared memory,
// the block's threads in turn, asynchronously (cp.async; the caller commits
// and waits).
__device__ __forceinline__ void copy_low_words(uint32_t* dst, const int64_t* src, int n) {
  for (int k = threadIdx.x; k < n; k += kThreads) __pipeline_memcpy_async(dst + k, src + k, sizeof(uint32_t));
}

// Issues the copies of a chunk's first-layer and inner-layer siblings and
// of its rows of every tree column block (each a contiguous run of the
// (B, Q, width) block).
__device__ __forceinline__ void stage_chunk(const FoldArgs& a, const Smem& sm, int64_t b, int q0, int nq) {
  const int64_t row = b * a.n_queries + q0;
  for (int s = 0; s < a.n_groups + a.n_inner; ++s) {
    const int64_t* src = s < a.n_groups ? a.first_sib[s] : a.inner_sib[s - a.n_groups];
    copy_low_words(sm.w(kRSib) + 4 * a.chunk * s, src + row * 4, 4 * nq);
  }
  for (int k = 0; k < a.n_blocks; ++k) {
    copy_low_words(sm.w(kRCols) + a.block_at[k], a.blocks[k] + row * a.block_width[k], nq * a.block_width[k]);
  }
  __pipeline_commit();
}

__device__ __forceinline__ uint32_t masked_query(const FoldArgs& a, int64_t slot) {
  return (uint32_t)(a.raw[slot] & ((1ll << a.max_log) - 1));
}

// Step 1 for query lq of the chunk (slot `slot`): the half-index chain, from
// the largest first-layer log size M down.
__device__ __forceinline__ void walk(const FoldArgs& a, const Smem& sm, int64_t slot, int lq) {
  const int M = a.max_log, G = a.n_groups;
  const uint32_t qmax = masked_query(a, slot);
  // A_M = initial + sum over bits k >= 1 of qmax of point(2^(30-k))
  uint32_t x = a.init_x, y = a.init_y;
  for (int k = 1; k < M; ++k) {
    if ((qmax >> k) & 1u) point_add(x, y, a.step[k][0], a.step[k][1]);
  }
  uint32_t* to_invert = sm.w(kRInv) + lq * a.n_inv();
  uint32_t* dys = sm.w(kRDy) + lq * G;
  uint32_t* den = sm.w(kRDen) + lq * 2 * a.n_batches();
  const Q* pxy = sm.q(kRPxy);
  int g = 0;
  for (int L = M; L >= M - a.n_inner; --L) {
    const uint32_t q = qmax >> (M - L);  // the query at log size L
    if (L < M) {
      // A_L = 2 (A_{L+1} + J if bit 0 of q_L); inner layer M - 1 - L folds by 1/x
      if (q & 1u) point_add(x, y, a.j_x, a.j_y);
      point_double(x, y);
      to_invert[M - 1 - L] = x;
    }
    if (g < G && a.group_log[g] == L) {
      // the column-domain point 2 A_L: the circle fold divides by its y, the
      // quotients take y negated iff bit 0 of q_L
      uint32_t dx = x, dy = y;
      point_double(dx, dy);
      to_invert[a.n_inner + g] = dy;
      if (q & 1u) dy = neg(dy);
      dys[g] = dy;
      // each batch's denominator (px.re - dx) py.im - (py.re - dy) px.im
      for (int bt = a.group_batch[g]; bt < a.group_batch[g + 1]; ++bt) {
        const Q px = pxy[2 * bt], py = pxy[2 * bt + 1];
        const C d = quotient::denominator(px, py, dx, dy);
        den[2 * bt] = d.re;
        den[2 * bt + 1] = d.im;
        to_invert[a.n_inner + G + bt] = add(mul(d.re, d.re), mul(d.im, d.im));
      }
      ++g;
    }
  }
  // the last layer's doublings of the x of 2 A_{M - n_inner}: level l of the
  // pairwise folds uses the (d-1-l)-th
  const int d = a.last_log;
  uint32_t* dbl = sm.w(kRDbl) + lq * d;
  uint32_t v = sub(mul(x, x), mul(y, y));
  for (int k = 0; k < d; ++k) {
    dbl[d - 1 - k] = v;
    const uint32_t sq = mul(v, v);
    v = sub(add(sq, sq), 1u);
  }
}

// Step 3: the answers of query lq = threadIdx.x / W of the chunk, W lanes a
// query.  Every lane of the block runs the same loops (the shuffles need the
// whole warp); lanes of no query read and write nothing.
__device__ __forceinline__ void quotients(const FoldArgs& a, const Smem& sm, int64_t b, int q0, int nq) {
  const int W = a.lanes, lq = threadIdx.x >> a.lanes_log, w = threadIdx.x & (W - 1);
  const bool active = lq < nq;
  const int64_t slot = b * a.n_queries + q0 + lq;
  const int64_t n_slots = a.batch * a.n_queries;
  const uint32_t* norm_inv = sm.w(kRInv) + lq * a.n_inv() + a.n_inner + a.n_groups;
  const uint32_t* den = sm.w(kRDen) + lq * 2 * a.n_batches();
  const Q* ctab = sm.q(kRC);
  const Q* sums = sm.q(kRSums);
  const uint32_t* cols = sm.w(kRCols);
  const uint32_t* col_at = sm.w(kRColAt);
  for (int g = 0; g < a.n_groups; ++g) {
    const uint32_t dy = active ? sm.w(kRDy)[lq * a.n_groups + g] : 0u;
    Q acc = q_zero();
    for (int bt = a.group_batch[g]; bt < a.group_batch[g + 1]; ++bt) {
      const int32_t* row = a.batch_row(bt);
      const int first = row[0], n = row[1];
      Q part = q_zero();
      if (active) {
        for (int k = first + w; k < first + n; k += W) {
          const uint32_t val = cols[col_at[2 * k] + lq * col_at[2 * k + 1]];
          part = q_add(part, q_mul_m31(ctab[k], val));
        }
      }
      // lane 0 takes the batch's -(SA dy + SB); times 1 / denominator
      const Q cst = q_add(q_mul_m31(sums[2 * bt], dy), sums[2 * bt + 1]);
      part = q_sub(part, w == 0 ? cst : q_zero());
      const uint32_t ninv = active ? norm_inv[bt] : 0u;
      const uint32_t re = active ? den[2 * bt] : 0u, im = active ? den[2 * bt + 1] : 0u;
      acc = q_add(acc, q_mul_cm31(part, C{mul(re, ninv), mul(neg(im), ninv)}));
    }
    for (int m = 1; m < W; m <<= 1) acc = q_add(acc, shfl_xor_q(acc, m));
    if (active && w == 0) {
      sm.q(kRAns)[g * a.chunk + lq] = acc;
      store_q(a.answers + (g * n_slots + slot) * 4, acc);
    }
  }
}

// Step 4 for query lq of the chunk: the fold chain from log size M down.
__device__ __forceinline__ void fold_chain(const FoldArgs& a, const Smem& sm, int64_t slot, int lq) {
  const int M = a.max_log, G = a.n_groups;
  const int64_t n_slots = a.batch * a.n_queries;
  const uint32_t qmax = masked_query(a, slot);
  const uint32_t* inverses = sm.w(kRInv) + lq * a.n_inv();
  const Q* sib = sm.q(kRSib);
  const Q* fri = sm.q(kRFri);
  Q folded = q_zero();
  int g = 0;
  for (int L = M; L >= M - a.n_inner; --L) {
    const uint32_t q = qmax >> (M - L);
    if (L < M) {
      // inner layer i: its leaf value, then its fold at A_L's x
      const int i = M - 1 - L;
      store_q(a.self_vals + (i * n_slots + slot) * 4, folded);
      folded = fold(q & 1u, folded, sib[(G + i) * a.chunk + lq], inverses[i], fri[i + 1]);
    }
    if (g < G && a.group_log[g] == L) {
      // the circle fold by 1/y, entering the line folds before layer M - L
      const Q alpha = fri[M - L];
      const Q circle = fold(q & 1u, sm.q(kRAns)[g * a.chunk + lq], sib[g * a.chunk + lq],
                            inverses[a.n_inner + g], alpha);
      if (M - L < a.n_inner) folded = q_add(q_mul(folded, q_mul(alpha, alpha)), circle);
      ++g;
    }
  }
  sm.q(kRFolded)[lq] = folded;
}

// Step 5: the last-layer polynomial of query lq = threadIdx.x / W, compared
// with its folded value.  The reference folds pairs (c_2m, c_2m+1) -> c_2m +
// c_2m+1 f_0, then the results' pairs with f_1, ..., f_l the (d-1-l)-th
// doubling of x: the value is the sum of c_j times the f_l of every set bit
// l of j.  Lane w < 2^lw (lw = min(log W, d)) sums the c_j with j = w mod
// 2^lw, j = jh 2^lw + w, over the high levels lw.. of jh's bits; the lanes
// then combine with the low levels, lane 0 last.
__device__ __forceinline__ void last_layer(const FoldArgs& a, const Smem& sm, int64_t b, int q0, int nq) {
  const int lq = threadIdx.x >> a.lanes_log, w = threadIdx.x & (a.lanes - 1);
  const bool active = lq < nq;
  const int d = a.last_log, lw = a.last_lanes_log, D = d - lw;
  const uint32_t* f = sm.w(kRDbl) + lq * d;
  const Q* staged = sm.q(kRCoef);
  const int64_t* coeffs = a.last_poly + (b << d) * 4;
  Q s = q_zero();
  if (active && w < (1 << lw)) {
    const uint32_t f0 = lw < d ? f[lw] : 0u, f1 = lw + 1 < d ? f[lw + 1] : 0u, f2 = lw + 2 < d ? f[lw + 2] : 0u;
    const int n = 1 << D;
    for (int blk = 0; blk < n; blk += 8) {
      Q c[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = ((blk + i) << lw) | w;
        c[i] = blk + i >= n ? q_zero() : a.staged ? staged[j] : load_q(coeffs + 4 * (int64_t)j);
      }
      const Q t0 = q_add(c[0], q_mul_m31(c[1], f0)), t1 = q_add(c[2], q_mul_m31(c[3], f0));
      const Q t2 = q_add(c[4], q_mul_m31(c[5], f0)), t3 = q_add(c[6], q_mul_m31(c[7], f0));
      const Q u0 = q_add(t0, q_mul_m31(t1, f1)), u1 = q_add(t2, q_mul_m31(t3, f1));
      const Q v = q_add(u0, q_mul_m31(u1, f2));
      // the block's levels above the tree
      uint32_t m = 1u;
      for (int bit = 0; (blk >> (3 + bit)) != 0; ++bit) {
        if ((blk >> (3 + bit)) & 1) m = mul(m, f[lw + 3 + bit]);
      }
      s = q_add(s, q_mul_m31(v, m));
    }
  }
  for (int l = 0; l < lw; ++l) s = q_add(s, q_mul_m31(shfl_xor_q(s, 1 << l), active ? f[l] : 0u));
  if (active && w == 0) a.last_eq[b * a.n_queries + q0 + lq] = q_eq(sm.q(kRFolded)[lq], s);
}

// ---------------------------------------------------------------------------
// kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) fold_kernel(const __grid_constant__ FoldArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem sm{smem, a};
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  if (a.staged) copy_low_words(sm.w(kRCoef), a.last_poly + (b << a.last_log) * 4, 4 << a.last_log);
  stage_chunk(a, sm, b, 0, min(a.chunk, a.n_queries));
  proof_coefficients(a, sm, b);
  for (int q0 = 0; q0 < a.n_queries; q0 += a.chunk) {
    const int nq = min(a.chunk, a.n_queries - q0);
    __syncthreads();  // the proof's tables, and the chunk's scratch free
    if (q0 > 0) stage_chunk(a, sm, b, q0, nq);
    if (t < nq) walk(a, sm, b * a.n_queries + q0 + t, t);
    __syncthreads();
    uint32_t* vals = sm.w(kRInv);
    for (int k = t; k < nq * a.n_inv(); k += kThreads) vals[k] = inv(vals[k]);
    __pipeline_wait_prior(0);  // this thread's copies; the barrier makes them everyone's
    __syncthreads();
    quotients(a, sm, b, q0, nq);
    __syncthreads();
    if (t < nq) fold_chain(a, sm, b * a.n_queries + q0 + t, t);
    __syncthreads();
    last_layer(a, sm, b, q0, nq);
  }
}

}  // namespace

// scalars: kScalars int64 (the Scalar positions above); ptrs: kPtrs device
// pointers (the Ptr positions; unused entries 0).  Launches a block a proof
// on `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape past the kernel's limits.
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
  a.n_entries = (int)scalars[kEntries];
  a.lanes = (int)scalars[kLanes];
  a.chunk = (int)scalars[kChunk];
  a.alpha_rows = (int)scalars[kAlphaRows];
  for (int r = 0; r < kRegions; ++r) a.region[r] = (int)scalars[kLayout + r];
  a.smem_bytes = (int)scalars[kLayout + kRegions];
  a.staged = a.region[kRCoef] != a.region[kRCoef + 1];
  a.lanes_log = 0;
  while ((1 << a.lanes_log) < a.lanes) ++a.lanes_log;
  a.last_lanes_log = a.lanes_log < a.last_log ? a.lanes_log : a.last_log;
  if (a.max_log < 1 || a.max_log >= kMaxLog || a.n_inner < 0 || a.n_inner > kMaxInner || a.n_inner >= a.max_log ||
      a.n_groups < 1 || a.n_groups > kMaxGroups || a.last_log < 0 || a.last_log > kMaxLastLog ||
      a.n_params != 3 + a.n_inner + 1 || a.lanes < 1 || a.lanes > 32 || (1 << a.lanes_log) != a.lanes ||
      a.chunk < 1 || a.chunk * a.lanes > kThreads || a.smem_bytes > kSmemMax) {
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
  for (int k = 0; k < kMaxBlocks; ++k) {
    a.block_width[k] = (int)scalars[kBlockWidth + k];
    a.block_at[k] = k ? a.block_at[k - 1] + a.chunk * a.block_width[k - 1] : 0;
    if (a.block_width[k]) a.n_blocks = k + 1;
  }
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
  if (a.batch == 0 || a.n_queries == 0) return 0;
  if (a.smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  fold_kernel<<<(unsigned)a.batch, kThreads, a.smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
