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
// One proof's chain is T + D sequential Poseidon2-16 permutations (T mixed
// rows, D draws), so the kernel is bound by the latency of that chain, not
// by the card's throughput.  Four lanes a proof, as K1's quad schedule
// (poseidon2.cu), the full rounds' constants staged in shared memory: lanes
// 0 and 1 read the rate half of each row (words 0-3 and 4-7), lanes 2 and 3
// hold the digest (words 8-15) in registers across every step.  (One thread
// a proof, the whole state in its registers, took five times as long at B =
// 1, 512 and 1024 on an H100: PERF.md.)  Row t + 1's operand words are
// loaded before row t's permutation, so the loads overlap it.  A draw at row r permutes (n_sent, 0, ..., 0 ‖ digest
// after row r) when the chain passes r; the digest itself is kept, so no
// (T, B, 8) table of digests is written.
//
// Operands are read in place, through a row table built on the host and
// cached per spec (ops/transcript_cuda.py `row_table`): each half of a row
// (4 words) names a source tensor (commitments, total sums, samples, FRI
// roots, last-layer coefficients, nonce limbs) or a constant, an element
// offset within a proof, and a word count; words past it read 0.  Draws
// follow the rows in the table, one row of 4 each: the row they follow,
// n_sent, their first output column and the words they store.
//
// Writes one (B, width) int64 row of canonical residues a proof: z, alpha,
// random_coeff, oods_t, the after-sampled-values coefficient, the FRI alphas,
// the raw queries, the post-nonce digest's word 0, the OODS point (x, y) and
// the input sum; and a (B, 2) bool: the PoW check, the total-sum check.
//
// What bounds it on an H100: at B = 1024 the int32 operations of 104-231
// permutations a proof (ops/transcript_cuda.py `transcript_bound_ms`: about
// 29-65 us), far below the chain's latency: T + D permutations one after
// another, each a chain of 22 rounds.  Every value is a canonical residue
// and every step a field operation, so the results are the plain version's
// residues; inv(0) = 0 (qm31.cuh `q_inv`), as in the reference.

#include <cstdint>

#include <cuda_runtime.h>

#include "poseidon2.cuh"
#include "qm31.cuh"

namespace {

using namespace qm31;

constexpr int kThreads = 128;

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

// The four words of one row half of proof b.
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

__device__ __forceinline__ const int32_t* draw_row(const TranscriptArgs& a, int d) {
  return a.tab + 6 * a.n_rows + 4 * d;
}

// Four lanes a proof, lane q holding words 4q..4q+3 of the state: lanes 0
// and 1 the rate half of each row, lanes 2 and 3 the digest.  Every lane of
// the warp runs every step (the permutation's shuffles need the full warp);
// lanes of a proof past the batch load and store nothing.
__device__ __forceinline__ void chain_quad(const TranscriptArgs& a, int64_t b, int q, bool live,
                                           const uint4 (*rc_full)[4]) {
  int64_t* out = a.out + b * a.width;
  const bool rate = q < 2;
  uint32_t s[4], digest[4] = {0u, 0u, 0u, 0u}, nxt[4] = {0u, 0u, 0u, 0u};
  if (live && rate) load_half(a, a.tab + 3 * q, b, nxt);
  int d = 0;
  for (int t = 0; t < a.n_rows; ++t) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = rate ? nxt[k] : digest[k];
    if (live && rate && t + 1 < a.n_rows) load_half(a, a.tab + 6 * (t + 1) + 3 * q, b, nxt);
    poseidon2_m31_permute_quad(s, q, rc_full);
#pragma unroll
    for (int k = 0; k < 4; ++k) digest[k] = rate ? digest[k] : s[k];
    for (; d < a.n_draws && draw_row(a, d)[0] == t; ++d) {
      const int32_t* dr = draw_row(a, d);
#pragma unroll
      for (int k = 0; k < 4; ++k) s[k] = rate ? (q == 0 && k == 0 ? (uint32_t)dr[1] : 0u) : digest[k];
      poseidon2_m31_permute_quad(s, q, rc_full);
      if (live && rate) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (4 * q + k < dr[3]) out[dr[2] + 4 * q + k] = s[k];
        }
      }
    }
  }
  if (live && q == 2) out[a.pow_col] = digest[0];
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

// The scalar tail of proof b, read back from its output row: the sum over
// public inputs i = q, q + 4, ... of 1 / (val_i + alpha idx_i - z), summed
// over the quad's lanes, then on lane 0 the OODS point ((1 - t^2), 2 t) /
// (1 + t^2) at t = oods_t, the total-sum check (input sum + the total sums
// == 0) and the PoW check.
__device__ __forceinline__ void tail(const TranscriptArgs& a, int64_t b, int q, bool live) {
  int64_t* out = a.out + b * a.width;
  Q z = q_zero(), alpha = q_zero();
  if (live) {
    z = load_q(out + kZCol);
    alpha = load_q(out + kAlphaCol);
  }
  Q sum = q_zero();
  for (int i = q; i < a.n_inputs; i += 4) {
    const int64_t* in = a.inputs + 5 * i;
    const uint32_t idx = (uint32_t)in[0];
    const Q term{sub(add((uint32_t)in[1], mul(alpha.a, idx)), z.a), sub(add((uint32_t)in[2], mul(alpha.b, idx)), z.b),
                 sub(add((uint32_t)in[3], mul(alpha.c, idx)), z.c), sub(add((uint32_t)in[4], mul(alpha.d, idx)), z.d)};
    sum = q_add(sum, q_inv(term));
  }
  using poseidon2_m31::quad_sum;
  sum = Q{quad_sum(sum.a), quad_sum(sum.b), quad_sum(sum.c), quad_sum(sum.d)};
  if (!live || q != 0) return;
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
  if (threadIdx.x < 32) {
    const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
    const uint32_t* rc = r < 4 ? FIRST_FOUR_ROUND_RC[r] : LAST_FOUR_ROUNDS_RC[r - 4];
    rc_full[r][q] = make_uint4(rc[4 * q], rc[4 * q + 1], rc[4 * q + 2], rc[4 * q + 3]);
  }
  __syncthreads();
  const int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int q = threadIdx.x & 3;
  const bool live = b < a.batch;
  chain_quad(a, b, q, live, rc_full);
  __syncwarp();  // the quad's stores of z, alpha, oods_t and the digest word, seen by all four lanes
  tail(a, b, q, live);
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
  const unsigned blocks = (unsigned)((a.batch * 4 + kThreads - 1) / kThreads);
  transcript_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
