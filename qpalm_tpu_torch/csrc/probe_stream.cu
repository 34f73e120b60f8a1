// Memory-plan probes of K1's streaming tier, on a batch of problems.
//
// Replaces the two Pallas probes of scripts/probe_mosaic_scratch.py, which
// checked and sized the TPU streaming kernel's memory plan: `scratch_probe`
// (:42-93, an (n, n) scratch per lane filled with seed + row, 8 rank-1
// updates v v' with v = iota / n applied in row chunks, row sums out) and
// `dma_probe` (:106-175, M = A' diag(w) A with A streamed from HBM in
// double-buffered row panels, M's row sums out).  The plain versions are
// qpalm_tpu_torch/probe.py:scratch_probe_plain and assembly_probe_plain.
//
// Here the plan under test is the one fused_palm.cu's streaming tier uses:
// one 256-thread block per problem, M in a per-problem global scratch that
// the wrapper allocates, A read straight from global memory, w in shared
// memory.  The scratch probe makes the Cholesky's access pattern (a warp per
// row of M, its lanes across the row, a block barrier after every rank-1
// update); the assembly probe calls the very Schur assembly of that tier
// (common.cuh:schur_tiles), so its time is that tier's assembly time under
// its plan.  Both are bound by L2 and device-memory traffic to M.

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;

// out[j] = sum_k M[j, k], one warp per row
__device__ __forceinline__ void row_sums(const float* M, float* out, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < n; j += NWARP) {
    float s = 0.0f;
    for (int k = lane; k < n; k += 32) s += M[j * n + k];
    s = warp_sum(s);
    if (lane == 0) out[j] = s;
  }
}

__global__ void __launch_bounds__(NT) scratch_probe_kernel(
    const float* __restrict__ seed, float* __restrict__ gM,
    float* __restrict__ out, int n) {
  const size_t pb = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* M = gM + pb * n * n;
  const float s = seed[pb];
  const float fn = (float)n;
  for (int j = warp; j < n; j += NWARP)
    for (int k = lane; k < n; k += 32) M[j * n + k] = s + (float)j;
  __syncthreads();
  for (int r = 0; r < 8; ++r) {
    for (int j = warp; j < n; j += NWARP) {
      const float vj = (float)j / fn;
      for (int k = lane; k < n; k += 32) M[j * n + k] -= vj * ((float)k / fn);
    }
    __syncthreads();
  }
  row_sums(M, out + pb * n, n);
}

__global__ void __launch_bounds__(NT) assembly_probe_kernel(
    const float* __restrict__ gA, const float* __restrict__ gw,
    float* __restrict__ gM, float* __restrict__ out, int n, int m) {
  extern __shared__ __align__(16) float w[];
  const size_t pb = blockIdx.x;
  float* M = gM + pb * n * n;
  for (int i = threadIdx.x; i < m; i += NT) w[i] = gw[pb * m + i];
  __syncthreads();
  schur_tiles(M, nullptr, gA + pb * m * n, w, n, m);
  __syncthreads();
  row_sums(M, out + pb * n, n);
}

}  // namespace

// seed (B,), M a (B, n, n) scratch, out (B, n)
extern "C" int qp_scratch_probe(const float* seed, float* M, float* out,
                                int B, int n, void* stream) {
  if (B == 0) return 0;
  scratch_probe_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(seed, M, out, n);
  return (int)cudaGetLastError();
}

// A (B, m, n) and M (B, n, n) 16-byte aligned with n % 4 == 0, w (B, m),
// out (B, n)
extern "C" int qp_assembly_probe(const float* A, const float* w, float* M,
                                 float* out, int B, int n, int m,
                                 void* stream) {
  if (B == 0) return 0;
  if (n % 4 || (size_t)A % 16 || (size_t)M % 16)
    return (int)cudaErrorInvalidValue;
  const int smem = m * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      &assembly_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  assembly_probe_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(A, w, M, out,
                                                               n, m);
  return (int)cudaGetLastError();
}
