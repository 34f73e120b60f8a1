// Kernel K2: batched unpivoted Cholesky factor and solve, f32.
//
// Replaces qpalm_tpu/linalg/pallas_chol.py: `_chol_kernel_loop` (launched
// by `_chol_pallas`) and `_solve_kernel_loop` (by `_solve_pallas`).  On the
// TPU a grid step held 8 matrices in VMEM and swept them with lane-wide
// vector ops; here one block owns one matrix in shared memory.
//
// What bounds it on an H100: at the polish's shapes (B=512, n=64) the data
// is 8 MB, read once, so the kernels are latency bound, not bandwidth
// bound: the factor is n rows of one block barrier each, every entry's
// subtractions a chain in one thread's registers (common.cuh), and the
// solve is 2n dependent steps per right-hand side.  The design keeps
// every step in shared memory (16 KB per matrix at n=64, so several blocks
// share an SM and hide each other's barriers), and the solve gives each
// right-hand side its own thread, so the identity right-hand sides of the
// polish's explicit inverse run as 64 independent threads with no barrier.
//
// Entry points (plain C, for ctypes) launch on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int CHOL_THREADS = 256;

__global__ void __launch_bounds__(CHOL_THREADS)
chol_kernel(const float* __restrict__ gM, float* __restrict__ gR, int n) {
  extern __shared__ float sm[];
  float* M = sm;
  const size_t off = (size_t)blockIdx.x * n * n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) M[e] = gM[off + e];
  __syncthreads();
  chol_upper_inplace(M, n);
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) gR[off + e] = M[e];
}

// R'R x = b for one matrix and one block of `cols` right-hand-side columns;
// thread c owns column c: forward substitution in saxpy form over rows of
// R, then backward substitution by inner products (the order of
// _solve_kernel_loop).  b and x are (n, k) row-major per matrix.
__global__ void chol_solve_kernel(const float* __restrict__ gR,
                                  const float* __restrict__ gb,
                                  float* __restrict__ gx, int n, int k,
                                  int cols) {
  extern __shared__ float sm[];
  float* R = sm;
  float* X = sm + n * n;  // X[l * cols + c]
  const int c = threadIdx.x;
  const int col = blockIdx.y * cols + c;
  const size_t roff = (size_t)blockIdx.x * n * n;
  const size_t boff = (size_t)blockIdx.x * n * k;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) R[e] = gR[roff + e];
  const bool active = col < k;
  if (active)
    for (int l = 0; l < n; ++l) X[l * cols + c] = gb[boff + (size_t)l * k + col];
  __syncthreads();
  if (!active) return;
  for (int j = 0; j < n; ++j) {
    const float yj = X[j * cols + c] / R[j * n + j];
    for (int l = j + 1; l < n; ++l) X[l * cols + c] -= yj * R[j * n + l];
    X[j * cols + c] = yj;
  }
  for (int r = n - 1; r >= 0; --r) {
    float dot = 0.0f;
    for (int l = r + 1; l < n; ++l) dot += R[r * n + l] * X[l * cols + c];
    X[r * cols + c] = (X[r * cols + c] - dot) / R[r * n + r];
  }
  for (int l = 0; l < n; ++l) gx[boff + (size_t)l * k + col] = X[l * cols + c];
}

}  // namespace

extern "C" int qp_chol(const float* M, float* R, int B, int n, void* stream) {
  if (B == 0 || n == 0) return 0;
  const int smem = (int)((size_t)n * n * sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  chol_kernel<<<B, CHOL_THREADS, smem, (cudaStream_t)stream>>>(M, R, n);
  return (int)cudaGetLastError();
}

extern "C" int qp_chol_solve(const float* R, const float* b, float* x, int B,
                             int n, int k, int cols, void* stream) {
  if (B == 0 || n == 0 || k == 0) return 0;
  const int smem = (int)((size_t)(n * n + n * cols) * sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B, (k + cols - 1) / cols);
  chol_solve_kernel<<<grid, cols, smem, (cudaStream_t)stream>>>(R, b, x, n, k,
                                                                cols);
  return (int)cudaGetLastError();
}
