// Device helpers shared by the port's kernels (chol.cu, fused_palm.cu,
// probe_stream.cu).
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

// sqrt correctly rounded, in the element type
static __device__ __forceinline__ float qp_sqrt(float v) { return sqrtf(v); }
static __device__ __forceinline__ double qp_sqrt(double v) { return sqrt(v); }

// Upper Cholesky factor in place, each entry's arithmetic and order that of
// linalg/chol.py:cholesky_upper_plain (the outer-product recurrence of
// qpalm_tpu/linalg/pallas_chol.py:_chol_kernel_loop): entry (k, l) less
// R[i][k] R[i][l] for i = 0, 1, ..., k - 1 in turn, each product and each
// difference rounded, then times inv = 1 / sqrt of the pivot so reduced
// (not rsqrt: that is approximate), the diagonal pivot * inv.  M is n x n,
// row-major, SPD, in shared memory; on return it holds R (R'R = M) with a
// zero lower triangle.  T is float or double.  Every thread of the block
// calls it.  Row by row, left-looking: thread t forms entry (k, k + t)
// from R's finished rows, with the pivot's sum beside its own, so a row's
// subtractions are chains in registers, not steps between barriers: one
// barrier a row, and one before the first.  A row's pivot is read a row
// ahead, since its diagonal is overwritten while the row is formed.  The
// unrolling is the compiler's: one loop under `#pragma unroll UNROLL` (for
// a global-memory plan since replaced) made K2a 55% and the on-chip K1 27%
// slower at UNROLL = 1 (tools/stream_ab.py, PERF.md).
template <typename T>
static __device__ void chol_upper_inplace(T* M, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  for (int j = warp; j < n; j += nw)
    for (int l = lane; l < j; l += 32) M[j * n + l] = T(0);
  T mkk = M[0];
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    T* rk = M + k * n;
    const T mnext = k + 1 < n ? rk[n + k + 1] : T(0);
    for (int l = k + tid; l < n; l += nt) {
      T akk = mkk, v = rk[l];
      for (int i = 0; i < k; ++i) {
        const T a = M[i * n + k];
        akk -= a * a;
        v -= a * M[i * n + l];
      }
      const T inv = T(1) / qp_sqrt(akk);
      rk[l] = l == k ? akk * inv : v * inv;
    }
    mkk = mnext;
    __syncthreads();
  }
}

// Schur assembly M = M0 + A' diag(w) A, n x n row-major, n a multiple of 4:
// one 4x4 tile of M per thread and pass, float4 loads of A's rows, and the
// m rows of A summed in order into registers that start at M0's tile (K1's
// on-chip tier; the streaming tier has its own, stream.cuh).  M0, A, w and
// M may each lie in shared or global memory (16-byte aligned).  The caller
// synchronises after.
static __device__ __forceinline__ void schur_tiles(float* M, const float* M0,
                                                   const float* A,
                                                   const float* w, int n,
                                                   int m) {
  const int nq = n >> 2;
  for (int tile = threadIdx.x; tile < nq * nq; tile += blockDim.x) {
    const int r0 = (tile / nq) * 4, c0 = (tile % nq) * 4;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 qr =
          *reinterpret_cast<const float4*>(M0 + (r0 + r) * n + c0);
      acc[r][0] = qr.x; acc[r][1] = qr.y; acc[r][2] = qr.z; acc[r][3] = qr.w;
    }
    for (int i = 0; i < m; ++i) {
      const float wi = w[i];
      const float4 ar = *reinterpret_cast<const float4*>(A + i * n + r0);
      const float4 ac = *reinterpret_cast<const float4*>(A + i * n + c0);
      const float wa[4] = {wi * ar.x, wi * ar.y, wi * ar.z, wi * ar.w};
      const float bc[4] = {ac.x, ac.y, ac.z, ac.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += wa[r] * bc[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(M + (r0 + r) * n + c0) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}
