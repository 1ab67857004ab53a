// The verifier's Fiat-Shamir transcript for Hopper (sm_90a), bound through a
// plain C interface (ops/build.py compiles this file with nvcc;
// ops/transcript_cuda.py loads it with ctypes): the Poseidon31 channel's
// digest chain over every value a proof mixes in, every draw, and the
// per-proof scalar tail beside them (the OODS point, the public inputs'
// logup sum, the PoW and total-sum checks), in one launch a batch.
//
// Replaces what XLA compiled on the TPU from recursive_stwo_tpu/verifier/
// transcript.py: `digest_chain` (:97-122, the lax.scan at :121 around the
// Pallas kernel K1) with `run_transcript`'s batched draw (:159) and the np
// twin (:246-290), together with points.py `oods_point_from_t` (:31) and the
// public-input loop of verify.py (:50-63) / verify_np.py (:37-47).  The
// port's eager version of the same steps (verifier/transcript.py
// `run_transcript[_np]`, `input_sum`, points.py `oods_point_from_t`) is the
// plain version.
//
// One proof's chain is T sequential Poseidon2-16 permutations (T mixed
// rows); a draw's state (n_sent, 0, ..., 0 ‖ digest after row r) feeds
// nothing back, so it is off the chain.  Eight lanes a proof: quad 0 (lanes
// 0-3 of the octet) runs the digest chain, quad 1 (lanes 4-7) the draws, each
// quad one state in K1's quad layout (lane q holds words 4q..4q+3).  At step
// t quad 0 permutes row t while quad 1 permutes the draw that follows row
// t - 1, whose digest it takes from quad 0 by one shuffle; the draws after
// the last row go two at a time, one a quad, so the chain is T + ceil(k / 2)
// permutations for k such draws (T + 1 on every spec here), down from T + D.
// The permutation is poseidon2.cuh's quad form, whose partial rounds keep
// word 0 replicated over the quad so the other words' sum overlaps the
// S-box.  The row and draw tables are staged in shared memory; row t + 1's
// operand words are loaded before row t's permutation, so the loads overlap
// it.
//
// Operands are read in place, through a row table built on the host and
// cached per spec (ops/transcript_cuda.py `row_table`): each half of a row
// (4 words) names a source tensor (commitments, total sums, samples, FRI
// roots, last-layer coefficients, nonce limbs) or a constant, an element
// offset within a proof, and a word count; words past it read 0.  Draws
// follow the rows in the table, one row of 4 each: the row they follow,
// n_sent, their first output column and the words they store.  Every draw
// but those after the last row follows a row of its own (the wrapper checks).
//
// Writes one (B, width) int64 row of canonical residues a proof: z, alpha,
// random_coeff, oods_t, the after-sampled-values coefficient, the FRI alphas,
// the raw queries, the post-nonce digest's word 0, the OODS point (x, y) and
// the input sum; and a (B, 2) bool: the PoW check, the total-sum check.
//
// What bounds it on an H100: at B = 1024 the int32 operations of 104-231
// permutations a proof (ops/transcript_cuda.py `transcript_bound_ms`: about
// 29-65 us), far below the chain's latency: T + 1 permutations one after
// another, each a chain of 22 rounds (ops/transcript_cuda.py `latency_floor_ms`
// counts its dependent steps).  Every value is a canonical residue and every
// step a field operation, so the results are the plain version's residues;
// inv(0) = 0 (qm31.cuh `q_inv`), as in the reference.

#include <cstdint>

#include <cuda_runtime.h>

#include "poseidon2.cuh"
#include "qm31.cuh"

namespace {

using namespace qm31;

constexpr int kThreads = 128;
constexpr int kLanes = 8;  // a proof's lanes: the chain's quad, then the draws'
// the row and draw table in shared memory, within the 48 KB a launch gets
// without opting in (ops/transcript_cuda.py MAX_TABLE_BYTES)
constexpr size_t kMaxTableBytes = 48 * 1024 - 8 * 4 * 16;

// Sources a row half may name (ops/transcript_cuda.py SOURCES); kConst
// reads its offset as word 0.
enum Source {
  kCommitments = 0,  // (B, 4, 8)
  kPlonkSum,         // (B, 4)
  kPoseidonSum,      // (B, 4)
  kSamples,          // (B, S, 4)
  kFirstLayer,       // (B, 8)
  kInner,            // (B, n_inner, 8)
  kLastPoly,         // (B, L, 4)
  kNonce,            // (B, 3)
  kSources,
  kConst = kSources,
};

// Fixed output columns (ops/transcript_cuda.py writes the others).
constexpr int kZCol = 0, kAlphaCol = 4, kOodsTCol = 12;

// Positions in the `scalars` array.
enum Scalar {
  kBatch = 0,
  kRows,
  kDraws,
  kWidth,
  kPowCol,   // the post-nonce digest's word 0
  kTailCol,  // OODS x, OODS y, input sum: 12 columns
  kInputs,
  kPowBits,
  kWithPoseidon,
  kStride,  // elements a proof of each source
  kScalars = kStride + kSources,
};

// Positions in the `ptrs` array.
enum Ptr {
  kSrc = 0,  // each source's first element
  kTab = kSrc + kSources,
  kInputsPtr,
  kOut,
  kOk,
  kPtrs,
};

struct TranscriptArgs {
  int64_t batch;
  int n_rows, n_draws, width, pow_col, tail_col, n_inputs, pow_bits;
  bool with_poseidon;
  int64_t stride[kSources];
  const int64_t* src[kSources];
  // n_rows rows of 6 (per half: source, offset, words), then n_draws rows of
  // 4 (row, n_sent, first output column, words stored)
  const int32_t* tab;
  const int64_t* inputs;  // (n_inputs, 5): index, the value's four limbs
  int64_t* out;           // (B, width)
  bool* ok;               // (B, 2)
};

// The four words of one row half of proof b (h in shared memory).
__device__ __forceinline__ void load_half(const TranscriptArgs& a, const int32_t* h, int64_t b, uint32_t w[4]) {
  const int src = h[0], off = h[1], n = h[2];
  if (src == kConst) {
    w[0] = (uint32_t)off;
    w[1] = w[2] = w[3] = 0u;
    return;
  }
  const int64_t* p = n ? a.src[src] + b * a.stride[src] + off : nullptr;
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = k < n ? (uint32_t)p[k] : 0u;
}

// A draw's state on lane q of its quad: (n_sent, 0, 0, 0 | 0 | digest).
__device__ __forceinline__ void draw_state(uint32_t s[4], int q, int32_t n_sent, const uint32_t digest[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) s[k] = q < 2 ? (q == 0 && k == 0 ? (uint32_t)n_sent : 0u) : digest[k];
}

// The rate words of a permuted draw state (lanes q = 0, 1), dr its row.
__device__ __forceinline__ void store_draw(int64_t* out, const int32_t* dr, int q, const uint32_t s[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (4 * q + k < dr[3]) out[dr[2] + 4 * q + k] = s[k];
  }
}

// Eight lanes a proof (o, the lane within the octet): quad 0 the chain,
// lanes 0 and 1 the rate half of each row, lanes 2 and 3 the digest; quad 1
// the draws.  Every lane of the warp runs every step (the shuffles need the
// full warp); lanes of a proof past the batch load and store nothing.  tab
// is the row and draw table in shared memory.
__device__ __forceinline__ void chain_octet(const TranscriptArgs& a, const int32_t* tab, int64_t b, int o, bool live,
                                            const uint4 (*rc_full)[4]) {
  int64_t* out = a.out + b * a.width;
  const int q = o & 3;
  const bool draws_quad = o >= 4, rate = q < 2;
  const int32_t* draws = tab + 6 * a.n_rows;
  uint32_t s[4], digest[4] = {0u, 0u, 0u, 0u}, nxt[4] = {0u, 0u, 0u, 0u};
  if (live && rate && !draws_quad) load_half(a, tab + 3 * q, b, nxt);
  int d = 0;
  for (int t = 0; t < a.n_rows; ++t) {
    // quad 1 takes the draw after row t - 1, with quad 0's digest after it
    uint32_t dg[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) dg[k] = __shfl_xor_sync(0xFFFFFFFFu, digest[k], 4);
    const int32_t* dr = draws + 4 * min(d, a.n_draws - 1);
    const bool drawn = d < a.n_draws && dr[0] == t - 1;
    if (draws_quad) {
      draw_state(s, q, dr[1], dg);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) s[k] = rate ? nxt[k] : digest[k];
      if (live && rate && t + 1 < a.n_rows) load_half(a, tab + 6 * (t + 1) + 3 * q, b, nxt);
    }
    poseidon2_m31_permute_quad(s, q, rc_full);
    if (!draws_quad) {
#pragma unroll
      for (int k = 0; k < 4; ++k) digest[k] = rate ? digest[k] : s[k];
    } else if (drawn && live && rate) {
      store_draw(out, dr, q, s);
    }
    d += drawn;
  }
  // the draws after the last row, two at a time: quad 0 takes draw d, quad 1
  // draw d + 1, both with the last digest
  uint32_t dg[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dg[k] = __shfl_xor_sync(0xFFFFFFFFu, digest[k], 4);
    dg[k] = draws_quad ? dg[k] : digest[k];
  }
  for (; d < a.n_draws; d += 2) {
    const int mine = draws_quad ? d + 1 : d;
    const int32_t* dr = draws + 4 * min(mine, a.n_draws - 1);
    draw_state(s, q, dr[1], dg);
    poseidon2_m31_permute_quad(s, q, rc_full);
    if (mine < a.n_draws && live && rate) store_draw(out, dr, q, s);
  }
  if (live && o == 2) out[a.pow_col] = digest[0];
}

__device__ __forceinline__ Q load_q(const int64_t* p) {
  return Q{(uint32_t)p[0], (uint32_t)p[1], (uint32_t)p[2], (uint32_t)p[3]};
}

__device__ __forceinline__ void store_q(int64_t* p, Q v) {
  p[0] = v.a;
  p[1] = v.b;
  p[2] = v.c;
  p[3] = v.d;
}

// Sum of v over the eight lanes of this lane's octet, the same on all eight.
__device__ __forceinline__ uint32_t octet_sum(uint32_t v) {
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) v = poseidon2_m31::add(v, __shfl_xor_sync(0xFFFFFFFFu, v, m));
  return v;
}

// The scalar tail of proof b, read back from its output row: the sum over
// public inputs i = o, o + 8, ... of 1 / (val_i + alpha idx_i - z), summed
// over the octet's lanes, then on lane 0 the OODS point ((1 - t^2), 2 t) /
// (1 + t^2) at t = oods_t, the total-sum check (input sum + the total sums
// == 0) and the PoW check.
__device__ __forceinline__ void tail(const TranscriptArgs& a, int64_t b, int o, bool live) {
  int64_t* out = a.out + b * a.width;
  Q z = q_zero(), alpha = q_zero();
  if (live) {
    z = load_q(out + kZCol);
    alpha = load_q(out + kAlphaCol);
  }
  Q sum = q_zero();
  for (int i = o; i < a.n_inputs; i += kLanes) {
    const int64_t* in = a.inputs + 5 * i;
    const uint32_t idx = (uint32_t)in[0];
    const Q term{sub(add((uint32_t)in[1], mul(alpha.a, idx)), z.a), sub(add((uint32_t)in[2], mul(alpha.b, idx)), z.b),
                 sub(add((uint32_t)in[3], mul(alpha.c, idx)), z.c), sub(add((uint32_t)in[4], mul(alpha.d, idx)), z.d)};
    sum = q_add(sum, q_inv(term));
  }
  sum = Q{octet_sum(sum.a), octet_sum(sum.b), octet_sum(sum.c), octet_sum(sum.d)};
  if (!live || o != 0) return;
  const Q t = load_q(out + kOodsTCol);
  const Q t2 = q_mul(t, t);
  const Q den = q_inv(q_add(t2, q_one()));
  store_q(out + a.tail_col, q_mul(q_sub(q_one(), t2), den));
  store_q(out + a.tail_col + 4, q_mul(q_add(t, t), den));
  store_q(out + a.tail_col + 8, sum);
  Q total = q_add(sum, load_q(a.src[kPlonkSum] + b * a.stride[kPlonkSum]));
  if (a.with_poseidon) total = q_add(total, load_q(a.src[kPoseidonSum] + b * a.stride[kPoseidonSum]));
  const uint64_t mask = (1ull << a.pow_bits) - 1ull;
  a.ok[2 * b] = ((uint64_t)out[a.pow_col] & mask) == 0ull;
  a.ok[2 * b + 1] = q_eq(total, q_zero());
}

// ---------------------------------------------------------------------------
// kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) transcript_kernel(const __grid_constant__ TranscriptArgs a) {
  using namespace poseidon2_m31;
  __shared__ uint4 rc_full[8][4];
  extern __shared__ int32_t tab[];  // the row and draw table
  if (threadIdx.x < 32) {
    const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
    const uint32_t* rc = r < 4 ? FIRST_FOUR_ROUND_RC[r] : LAST_FOUR_ROUNDS_RC[r - 4];
    rc_full[r][q] = make_uint4(rc[4 * q], rc[4 * q + 1], rc[4 * q + 2], rc[4 * q + 3]);
  }
  for (int i = threadIdx.x; i < 6 * a.n_rows + 4 * a.n_draws; i += blockDim.x) tab[i] = a.tab[i];
  __syncthreads();
  const int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int o = threadIdx.x % kLanes;
  const bool live = b < a.batch;
  chain_octet(a, tab, b, o, live, rc_full);
  __syncwarp();  // the octet's stores of z, alpha, oods_t and the digest word, seen by all eight lanes
  tail(a, b, o, live);
}

}  // namespace

// scalars: kScalars int64 (the Scalar positions above); ptrs: kPtrs device
// pointers (the Ptr positions; a source the spec never reads may be 0).
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside the kernel's limits.
extern "C" int transcript_replay(const int64_t* scalars, const int64_t* ptrs, void* stream) {
  TranscriptArgs a{};
  a.batch = scalars[kBatch];
  a.n_rows = (int)scalars[kRows];
  a.n_draws = (int)scalars[kDraws];
  a.width = (int)scalars[kWidth];
  a.pow_col = (int)scalars[kPowCol];
  a.tail_col = (int)scalars[kTailCol];
  a.n_inputs = (int)scalars[kInputs];
  a.pow_bits = (int)scalars[kPowBits];
  a.with_poseidon = scalars[kWithPoseidon] != 0;
  if (a.batch < 0 || a.n_rows < 1 || a.n_draws < 1 || a.n_inputs < 0 || a.pow_bits < 0 || a.pow_bits > 32 ||
      a.tail_col + 12 != a.width || a.pow_col >= a.tail_col) {
    return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k < kSources; ++k) {
    a.stride[k] = scalars[kStride + k];
    a.src[k] = (const int64_t*)ptrs[kSrc + k];
  }
  a.tab = (const int32_t*)ptrs[kTab];
  a.inputs = (const int64_t*)ptrs[kInputsPtr];
  a.out = (int64_t*)ptrs[kOut];
  a.ok = (bool*)ptrs[kOk];
  if (a.batch == 0) return 0;
  const size_t smem = sizeof(int32_t) * (6 * (size_t)a.n_rows + 4 * (size_t)a.n_draws);
  if (smem > kMaxTableBytes) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((a.batch * kLanes + kThreads - 1) / kThreads);
  transcript_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
