// Device helpers shared by the port's kernels (chol.cu, fused_palm.cu).
#pragma once

#include <cuda_runtime.h>
#include <float.h>

#define QP_FULL_MASK 0xffffffffu

// max that propagates NaN, as jnp.max and torch.amax do
static __device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// xor-butterfly sum: every lane ends with the same, order-fixed total
static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(QP_FULL_MASK, v, o);
  return v;
}

// Upper Cholesky factor in place, by the outer-product recurrence of
// qpalm_tpu/linalg/pallas_chol.py:_chol_kernel_loop.  M is n x n, row-major,
// in shared memory, SPD; on return it holds R (R'R = M) with a zero lower
// triangle.  rt is n floats of shared scratch.  Every thread of the block
// calls it.  Step k scales row k by 1/sqrt(M[k][k]) and subtracts its outer
// product from the trailing upper triangle: two barriers per step.
static __device__ void chol_upper_inplace(float* M, float* rt, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  for (int k = 0; k < n; ++k) {
    const float akk = M[k * n + k];
    const float inv = 1.0f / sqrtf(akk);  // not rsqrtf: that is approximate
    for (int l = k + 1 + tid; l < n; l += nt) rt[l] = M[k * n + l] * inv;
    __syncthreads();
    for (int j = k + 1 + warp; j < n; j += nw) {
      const float rj = rt[j];
      for (int l = j + lane; l < n; l += 32) M[j * n + l] -= rj * rt[l];
    }
    for (int l = tid; l < n; l += nt)
      M[k * n + l] = l > k ? rt[l] : (l == k ? akk * inv : 0.0f);
    __syncthreads();
  }
}
