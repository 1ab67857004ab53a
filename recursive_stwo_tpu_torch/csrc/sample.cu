// The provers' out-of-domain sampling of coefficient columns, every block
// and point of a proof in one launch, for Hopper (sm_90a), bound through a
// plain C interface (ops/build.py compiles this file with nvcc;
// ops/sample_cuda.py loads it with ctypes).
//
// Replaces what XLA compiled on the TPU from
// recursive_stwo_tpu/prover/device.py (`_sample_jit` :244-279, called by
// `sample_columns` :282-293 and at prover/device_prove.py:789-804): for a
// column of 2^n M31 coefficients c_i and a point given by its n QM31 ladder
// factors f_k (prove._factors_at_point), the sample sum of c_i basis[i],
// basis[i] the product of f_k over the set bits k of i (the order of
// device.py:257-266, vals_{k+1} = [vals_k, vals_k * f_k]).
//
// A job is a block of C columns of 2^n coefficients (row stride `stride`,
// unit stride along a row) sampled at one or two points; the interaction
// blocks' two points read each coefficient once.  Index i splits into its
// low L = min(n, 10) bits and its high n - L bits, and the high bits into a
// block's H = min(n - L, 6) bits and the rest (`chunk`):
//   basis[i] = Lo[i & (2^L - 1)] * Hi[(i >> L) & (2^H - 1)] * Top[chunk].
// A CUDA block takes one column and one chunk: 2^(L + H) coefficients, up
// to 2^16.  It builds Lo (2^L entries) and Hi (2^H) of each point in shared
// memory by doubling; each warp takes a run of 2^L coefficients at a time
// (one Hi entry), its lanes reading neighbouring coefficients (coalesced),
// and sums coeff * Lo in four 64-bit limb sums a point.  The run's sum,
// reduced, times its Hi entry is added to the lane's total; a shuffle and
// shared-memory reduction gives the block's sum, which thread 0 multiplies by
// Top (the chunk's bits, at most 11 products) and adds into the (rows, 4)
// output with 64-bit atomics on reduced residues (at most 2^11 blocks a
// column, far from 2^33).  An exact integer sum is the same residue in any
// order, so the result is bit-exact with `_sample_jit`'s pairwise tree.  A
// second kernel reduces the sums mod p in place.  n = 0 (a constant
// polynomial) is the same code: Lo, Hi and Top are 1, and the sample is the
// coefficient in limb 0.
//
// The lazy limb sums: a coefficient and a Lo limb are canonical, below p =
// 2^31 - 1, so a product is at most (p - 1)^2 = 2^62 - 2^33 + 4.  A lane adds
// at most four products to a sum between folds s -> (s & p) + (s >> 31)
// (the same residue, as 2^31 = 1 mod p), which leave s below 2^31 + 2^33 <
// 2^34; 2^34 + 4 (2^62 - 2^33 + 4) = 2^64 - 2^34 + 16 < 2^64, so no sum
// overflows.  The lane totals add at most 2^H / 8 = 8 reduced values.
//
// What bounds it on an H100: the bytes of the coefficients, each read once
// (ops/sample_cuda.py `bound_ms`); a coefficient costs four 32 x 32 -> 64-bit
// multiply-adds a point.

#include <cstdint>

#include <cuda_runtime.h>

#include "qm31.cuh"

namespace {

using namespace qm31;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoLog = 10;  // a Lo table of 2^10 QM31s a point, 16 KB
constexpr int kHiLog = 6;   // a block's Hi table of 2^6
constexpr int kMaxLog = 27;
constexpr int kMaxJobs = 12;
constexpr int kMaxLadders = 6;
constexpr int kMaxPoints = 2;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kP = poseidon2_m31::P;

struct Job {
  const int64_t* coeffs;
  int64_t stride;          // row stride of the block
  int64_t first_block;     // the job's first CUDA block
  int32_t cols, log, points, out_row;  // the sample of column c at point p is output row out_row + p cols + c
  int32_t ladder[kMaxPoints];          // each point's ladder of factors
};

struct Args {
  int32_t n_jobs;
  Job jobs[kMaxJobs];
  Q ladders[kMaxLadders][kMaxLog];  // factor k of each ladder; a job of log n reads factors 0 .. n - 1
};

__host__ __device__ constexpr int lo_log(int n) { return n < kLoLog ? n : kLoLog; }
__host__ __device__ constexpr int hi_log(int n) { return n - lo_log(n) < kHiLog ? n - lo_log(n) : kHiLog; }

// s -> (s & p) + (s >> 31): the same residue, below 2^34
__device__ __forceinline__ uint64_t fold(uint64_t s) { return (s & kP) + (s >> 31); }

// s mod p for any 64-bit s: s = lo + mid 2^31 + hi 2^62 = lo + mid + hi (mod p)
__device__ __forceinline__ uint32_t reduce(uint64_t s) {
  const uint64_t t = (s & kP) + ((s >> 31) & kP) + (s >> 62);
  const uint32_t r = (uint32_t)(t & kP) + (uint32_t)(t >> 31);
  return min(r, r - (uint32_t)kP);
}

__device__ __forceinline__ Q shfl_xor_q(Q v, int m) {
  return Q{__shfl_xor_sync(kFull, v.a, m), __shfl_xor_sync(kFull, v.b, m), __shfl_xor_sync(kFull, v.c, m),
           __shfl_xor_sync(kFull, v.d, m)};
}

template <int M>
__device__ __forceinline__ void sample_block(const Args& a, const Job& job, int64_t b, Q (*lo)[1 << kLoLog],
                                             Q (*hi)[1 << kHiLog], Q (*warp_sum)[kMaxPoints],
                                             unsigned long long* __restrict__ out) {
  const int n = job.log, L = lo_log(n), H = hi_log(n), rest = n - L - H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t col = b >> rest, chunk = b & ((int64_t(1) << rest) - 1);
  const Q* f[M];
#pragma unroll
  for (int p = 0; p < M; ++p) f[p] = a.ladders[job.ladder[p]];

  // Lo[i] (i < 2^L) and Hi[i] (i < 2^H) by doubling: entry 2^k + i is entry
  // i times factor k (factor L + k for Hi)
  if (tid == 0) {
#pragma unroll
    for (int p = 0; p < M; ++p) lo[p][0] = hi[p][0] = q_one();
  }
  __syncthreads();
  for (int k = 0; k < L; ++k) {
    for (int i = tid; i < (1 << k); i += kThreads) {
#pragma unroll
      for (int p = 0; p < M; ++p) {
        lo[p][(1 << k) + i] = q_mul(lo[p][i], f[p][k]);
        if (k < H) hi[p][(1 << k) + i] = q_mul(hi[p][i], f[p][L + k]);
      }
    }
    __syncthreads();
  }

  // each warp: runs of 2^L coefficients, one Hi entry each
  const int64_t* row = job.coeffs + col * job.stride + (chunk << (L + H));
  uint64_t tot[M][4];
#pragma unroll
  for (int p = 0; p < M; ++p) tot[p][0] = tot[p][1] = tot[p][2] = tot[p][3] = 0;
  for (int h = warp; h < (1 << H); h += kWarps) {
    const int64_t* run = row + ((int64_t)h << L);
    uint64_t s[M][4];
#pragma unroll
    for (int p = 0; p < M; ++p) s[p][0] = s[p][1] = s[p][2] = s[p][3] = 0;
    for (int k0 = lane; k0 < (1 << L); k0 += 128) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + 32 * u;
        if (k < (1 << L)) {
          const uint64_t c = __ldg(reinterpret_cast<const uint32_t*>(run + k));  // the low word
#pragma unroll
          for (int p = 0; p < M; ++p) {
            const Q w = lo[p][k];
            s[p][0] += c * w.a;
            s[p][1] += c * w.b;
            s[p][2] += c * w.c;
            s[p][3] += c * w.d;
          }
        }
      }
#pragma unroll
      for (int p = 0; p < M; ++p) {
#pragma unroll
        for (int l = 0; l < 4; ++l) s[p][l] = fold(s[p][l]);
      }
    }
#pragma unroll
    for (int p = 0; p < M; ++p) {
      const Q v = q_mul(Q{reduce(s[p][0]), reduce(s[p][1]), reduce(s[p][2]), reduce(s[p][3])}, hi[p][h]);
      tot[p][0] += v.a;
      tot[p][1] += v.b;
      tot[p][2] += v.c;
      tot[p][3] += v.d;
    }
  }

  // the block's sum: over the warp by shuffles, over the warps in shared
  // memory; times Top; added into the output
#pragma unroll
  for (int p = 0; p < M; ++p) {
    Q v{reduce(tot[p][0]), reduce(tot[p][1]), reduce(tot[p][2]), reduce(tot[p][3])};
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v = q_add(v, shfl_xor_q(v, m));
    if (lane == 0) warp_sum[warp][p] = v;
  }
  __syncthreads();
  if (tid != 0) return;
#pragma unroll
  for (int p = 0; p < M; ++p) {
    Q v = warp_sum[0][p];
    for (int w = 1; w < kWarps; ++w) v = q_add(v, warp_sum[w][p]);
    for (int k = 0; k < rest; ++k) {
      if ((chunk >> k) & 1) v = q_mul(v, f[p][L + H + k]);
    }
    unsigned long long* o = out + 4 * ((int64_t)job.out_row + (int64_t)p * job.cols + col);
    atomicAdd(o, (unsigned long long)v.a);
    atomicAdd(o + 1, (unsigned long long)v.b);
    atomicAdd(o + 2, (unsigned long long)v.c);
    atomicAdd(o + 3, (unsigned long long)v.d);
  }
}

__global__ void __launch_bounds__(kThreads)
sample_kernel(const __grid_constant__ Args a, unsigned long long* __restrict__ out) {
  __shared__ Q lo[kMaxPoints][1 << kLoLog];
  __shared__ Q hi[kMaxPoints][1 << kHiLog];
  __shared__ Q warp_sum[kWarps][kMaxPoints];
  int j = 0;
  while (j + 1 < a.n_jobs && (int64_t)blockIdx.x >= a.jobs[j + 1].first_block) ++j;
  const Job& job = a.jobs[j];
  const int64_t b = (int64_t)blockIdx.x - job.first_block;
  if (job.points == 2) {
    sample_block<2>(a, job, b, lo, hi, warp_sum, out);
  } else {
    sample_block<1>(a, job, b, lo, hi, warp_sum, out);
  }
}

// the 64-bit sums of reduced residues -> canonical residues, in place
__global__ void __launch_bounds__(kThreads) sample_finish_kernel(int64_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = (int64_t)((uint64_t)out[i] % kP);
}

}  // namespace

// jobs: n_jobs rows of 7 int64 (coefficient pointer, row stride, columns,
// log size, points, ladder of point 0, ladder of point 1); ladders:
// n_ladders x 27 x 4 int64 factor limbs; out: (rows, 4) int64, zeroed and
// written, each job's samples from row sum of the earlier jobs' columns x
// points.  Launches a fill, the sampling kernel and the finishing kernel on
// `stream` and returns the first CUDA error (cudaErrorInvalidValue for
// arguments past the limits above).
extern "C" int sample_columns(const int64_t* jobs, int64_t n_jobs, const int64_t* ladders, int64_t n_ladders,
                              void* out, int64_t rows, void* stream) {
  if (n_jobs < 1 || n_jobs > kMaxJobs || n_ladders < 1 || n_ladders > kMaxLadders) return (int)cudaErrorInvalidValue;
  Args a{};
  a.n_jobs = (int32_t)n_jobs;
  int64_t blocks = 0, out_row = 0;
  for (int j = 0; j < n_jobs; ++j) {
    const int64_t* r = jobs + 7 * j;
    Job& job = a.jobs[j];
    job.coeffs = (const int64_t*)r[0];
    job.stride = r[1];
    job.cols = (int32_t)r[2];
    job.log = (int32_t)r[3];
    job.points = (int32_t)r[4];
    if (job.cols < 1 || job.log < 0 || job.log > kMaxLog || job.points < 1 || job.points > kMaxPoints) {
      return (int)cudaErrorInvalidValue;
    }
    for (int p = 0; p < kMaxPoints; ++p) {
      job.ladder[p] = p < job.points ? (int32_t)r[5 + p] : 0;
      if (job.ladder[p] < 0 || job.ladder[p] >= n_ladders) return (int)cudaErrorInvalidValue;
    }
    job.first_block = blocks;
    job.out_row = (int32_t)out_row;
    blocks += (int64_t)job.cols << (job.log - lo_log(job.log) - hi_log(job.log));
    out_row += (int64_t)job.cols * job.points;
  }
  if (out_row != rows || blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_ladders; ++l) {
    for (int k = 0; k < kMaxLog; ++k) {
      const int64_t* v = ladders + 4 * (kMaxLog * l + k);
      a.ladders[l][k] = Q{(uint32_t)v[0], (uint32_t)v[1], (uint32_t)v[2], (uint32_t)v[3]};
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(out, 0, (size_t)rows * 4 * sizeof(int64_t), s);
  if (err != 0) return err;
  sample_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a, (unsigned long long*)out);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t n = rows * 4;
  sample_finish_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>((int64_t*)out, n);
  return (int)cudaGetLastError();
}
