// Latency probe for the latency floors of the two chain kernels (the
// transcript kernel, transcript.cu, and the composition check kernel,
// composition.cu), bound through a plain C interface (ops/latency_cuda.py).
// One warp runs `steps` dependent operations of one kind (m31.cuh's add,
// mul, mul_pow2, or a xor-shuffle) between two clock64 reads and reports
// the cycles; a floor is a chain's dependent steps of each kind times these
// (ops/transcript_cuda.py, ops/composition_cuda.py `latency_floor_ms`).  Not
// on any verifier or prover path.

#include <cstdint>

#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

// ops/latency_cuda.py KINDS, in this order
enum Kind { kAdd = 0, kMul, kRot, kShfl, kKinds };

template <int KIND>
__device__ __forceinline__ uint32_t step(uint32_t x, uint32_t y) {
  using namespace poseidon2_m31;
  if constexpr (KIND == kAdd) return add(x, y);
  if constexpr (KIND == kMul) return mul(x, y);
  if constexpr (KIND == kRot) return mul_pow2(x, 5);
  return __shfl_xor_sync(0xFFFFFFFFu, x, 1);
}

template <int KIND>
__global__ void latency_kernel(int64_t steps, const int64_t* __restrict__ seed, int64_t* __restrict__ out) {
  uint32_t x = (uint32_t)seed[threadIdx.x], y = (uint32_t)seed[32 + threadIdx.x];
  __syncwarp();
  const long long t0 = clock64();
  for (int64_t i = 0; i < steps; i += 16) {
#pragma unroll
    for (int k = 0; k < 16; ++k) x = step<KIND>(x, y);
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x;  // keeps the chain
  if (threadIdx.x == 0) out[32] = t1 - t0;
}

}  // namespace

// kind: Kind; steps: a multiple of 16; seed: (64,) int64 canonical residues;
// out: (33,) int64, the lanes' last values then the cycles.  One warp, on
// `stream`; returns cudaGetLastError().
extern "C" int latency_probe(int kind, int64_t steps, const void* seed, void* out, void* stream) {
  if (steps <= 0 || steps % 16) return (int)cudaErrorInvalidValue;
  const int64_t* s = (const int64_t*)seed;
  int64_t* o = (int64_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case kAdd: latency_kernel<kAdd><<<1, 32, 0, st>>>(steps, s, o); break;
    case kMul: latency_kernel<kMul><<<1, 32, 0, st>>>(steps, s, o); break;
    case kRot: latency_kernel<kRot><<<1, 32, 0, st>>>(steps, s, o); break;
    case kShfl: latency_kernel<kShfl><<<1, 32, 0, st>>>(steps, s, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
