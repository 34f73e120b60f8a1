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
// Both run one 256-thread block per problem with M in a per-problem global
// scratch that the wrapper allocates.  The scratch probe makes the access
// pattern of the rank-1 plan the streaming tier's Cholesky used until its
// blocked redesign (chol_upper_inplace on a global M: a warp per row of M,
// its lanes across the row, a block barrier after every rank-1 update), and
// is bound by L2 and device-memory traffic to M.  The assembly probe calls
// the streaming tier's own Schur assembly (stream.cuh:schur_stream: A in
// double-buffered row panels of PROBE_P rows brought into shared memory by
// bulk asynchronous copies, 8x8 register tiles of M's upper triangle), so
// its time is that tier's assembly time; its row sums read the symmetric
// completion of the upper triangle.

#include "common.cuh"
#include "stream.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int PROBE_P = 16;  // A's rows per staging panel, as the tier's

// shared memory of the assembly probe, in floats: w, two mbarriers, the
// panels and 4 floats for the reads of a 4-wide edge tile
int assembly_probe_floats(int n, int m) {
  return ((m + 3) & ~3) + 4 + 2 * PROBE_P * n + 4;
}

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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* M = gM + pb * n * n;
  uint64_t* bars = reinterpret_cast<uint64_t*>(w + ((m + 3) & ~3));
  for (int i = threadIdx.x; i < m; i += NT) w[i] = gw[pb * m + i];
  __syncthreads();
  stream::schur_stream(M, gA + pb * m * n, w,
                       reinterpret_cast<float*>(bars) + 4, bars, n, m,
                       PROBE_P);
  __syncthreads();
  // row sums of the symmetric completion, one warp per row
  for (int j = warp; j < n; j += NWARP) {
    float s = 0.0f;
    for (int k = lane; k < n; k += 32)
      s += k >= j ? M[j * n + k] : M[k * n + j];
    s = warp_sum(s);
    if (lane == 0) out[pb * n + j] = s;
  }
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
  const int smem = assembly_probe_floats(n, m) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      &assembly_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  assembly_probe_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(A, w, M, out,
                                                               n, m);
  return (int)cudaGetLastError();
}
