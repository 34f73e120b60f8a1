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
// The scratch probe keeps its scratch on chip: a problem's rows are dealt
// to independent 256-thread blocks, SCRATCH_ROWS rows a block (fewer where
// n is large), each block's rows of M in its shared memory; the block
// fills them, applies each entry's 8 subtractions in the plain order, one
// pass over its rows and a block barrier an update (a warp a row, its
// lanes across the row), and sums each row.  Nothing goes through global
// memory but the seed in and the sums out, so it measures passes over an
// on-chip scratch spread over the SMs.  The assembly probe runs one
// 256-thread block per problem with M in a per-problem global scratch
// that the wrapper allocates.  It calls
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
constexpr int SCRATCH_ROWS = 32;  // rows of M a block of the scratch probe
constexpr int SMEM_LIMIT = 232448;

// rows of a problem's M a block of the scratch probe takes: SCRATCH_ROWS,
// fewer where they and the row of k / n would not fit SMEM_LIMIT (0: not
// even one row fits)
int scratch_rows(int n) {
  const int fit = SMEM_LIMIT / (4 * (n > 0 ? n : 1)) - 1;
  return fit < SCRATCH_ROWS ? fit : SCRATCH_ROWS;
}

// shared memory of the assembly probe, in floats: w, two mbarriers, the
// panels and 4 floats for the reads of a 4-wide edge tile
int assembly_probe_floats(int n, int m) {
  return ((m + 3) & ~3) + 4 + 2 * PROBE_P * n + 4;
}

// rows j0 .. j0 + rows - 1 of problem blockIdx.x's M, in shared memory
// (M[(j - j0) n + k]): filled with seed + j, 8 times M[j, k] -= (j / n) (k /
// n), then out[j] = sum_k M[j, k]; a warp a row, its lanes across it.  The
// row of k / n is divided once a block, into shared memory beside M.
__global__ void __launch_bounds__(NT) scratch_probe_kernel(
    const float* __restrict__ seed, float* __restrict__ out, int n,
    int rows_per_block) {
  extern __shared__ __align__(16) float M[];
  float* vk = M + rows_per_block * n;
  const size_t pb = blockIdx.x;
  const int j0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, n - j0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float s = seed[pb];
  const float fn = (float)n;
  for (int k = threadIdx.x; k < n; k += NT) vk[k] = (float)k / fn;
  for (int r = warp; r < rows; r += NWARP)
    for (int k = lane; k < n; k += 32) M[r * n + k] = s + (float)(j0 + r);
  __syncthreads();
  for (int u = 0; u < 8; ++u) {
    for (int r = warp; r < rows; r += NWARP) {
      const float vj = (float)(j0 + r) / fn;
      for (int k = lane; k < n; k += 32) M[r * n + k] -= vj * vk[k];
    }
    __syncthreads();
  }
  for (int r = warp; r < rows; r += NWARP) {
    float acc = 0.0f;
    for (int k = lane; k < n; k += 32) acc += M[r * n + k];
    acc = warp_sum(acc);
    if (lane == 0) out[pb * n + j0 + r] = acc;
  }
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

// seed (B,), out (B, n); n whose row does not fit a block's shared memory
// is refused
extern "C" int qp_scratch_probe(const float* seed, float* out, int B, int n,
                                void* stream) {
  if (B == 0 || n == 0) return 0;
  const int rows = scratch_rows(n);
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const int smem = (rows + 1) * n * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      &scratch_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  scratch_probe_kernel<<<dim3(B, (n + rows - 1) / rows), NT, smem,
                         (cudaStream_t)stream>>>(seed, out, n, rows);
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
