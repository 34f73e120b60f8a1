// Kernel K2: batched unpivoted Cholesky factor and solve, f32 and f64.
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
// solve is 2n dependent steps per right-hand side.  The factor keeps every
// step in shared memory (16 KB per matrix at n=64, so several blocks share
// an SM and hide each other's barriers).
//
// The solve gives each right-hand-side column its own thread, with no
// block barrier after R is staged; a block takes the columns of one
// matrix.  For n a multiple of PANEL (the polish's n_pad=64 among them)
// it is blocked: the column lives in shared memory, and each step of a
// rolled loop brings one panel of PANEL entries into registers and applies
// a PANEL x PANEL block of R to it, read as float4 loads that every thread
// of the warp shares (a broadcast).  R comes in by one bulk asynchronous
// copy while the threads load their columns, and is transposed in shared
// memory for the backward pass, so that both passes read rows.  A block
// takes 32 or 64 columns (the wrapper takes 32 where 64 would leave SMs
// idle, as at the polish's B=64 second round).  Other n keep the column
// in shared memory entry by entry.  Both run one order, which
// linalg/chol.py:cholesky_solve_plain repeats: forward substitution in
// saxpy form over rows of R (x_l -= y_j R_jl for j = 0, 1, ...), then
// backward substitution in column form (x_l /= R_ll, then x_r -= R_rl x_l
// for r < l, for l = n - 1 down to 0), each product and each difference
// rounded (built --fmad=false), and a true division: blocking moves no
// subtraction of an entry past another.
//
// A design that held the whole column in registers, every loop unrolled
// at compile time, ran 0.040 ms at (512, 64, 64) and at (64, 64, 64)
// whatever the order of its loads; the blocked loops are short and run
// 0.0305 and 0.0208 ms there (PERF.md, NVIDIA H100 80GB HBM3, 700 W).
//
// The factor and the entry-by-entry solve are templates on the element
// type: f64 instantiations of the shared-memory plan take n <= 170 (the
// factor's n x n doubles in 227 KB).  Their dynamic shared memory is
// declared as floats and cast: declared as bytes, the f32 factor ran 25%
// slower with the same arithmetic (0.0564 against 0.0453 ms at
// (512, 64, 64), tools/stream_ab.py --kernel chol, PERF.md).  Past shared memory (f32 n > 241,
// f64 n > 170) a global-memory plan keeps R in global memory, one block
// per matrix (chol_global_kernel, chol_solve_global_kernel, below), in
// the same order of operations.  linalg/chol.py picks the plan.
//
// Entry points (plain C, for ctypes) launch on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include "common.cuh"
#include "stream.cuh"

namespace {

constexpr int CHOL_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(CHOL_THREADS)
chol_kernel(const T* __restrict__ gM, T* __restrict__ gR, int n) {
  extern __shared__ __align__(16) float smf[];
  T* M = reinterpret_cast<T*>(smf);
  const size_t off = (size_t)blockIdx.x * n * n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) M[e] = gM[off + e];
  __syncthreads();
  chol_upper_inplace(M, n);
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) gR[off + e] = M[e];
}

// R'R x = b for one matrix and one block of `cols` right-hand-side columns,
// the column in shared memory (any n); thread c owns column c.  b and x are
// (n, k) row-major per matrix.
template <typename T>
__global__ void chol_solve_kernel(const T* __restrict__ gR,
                                  const T* __restrict__ gb,
                                  T* __restrict__ gx, int n, int k,
                                  int cols) {
  extern __shared__ __align__(16) float smf[];
  T* R = reinterpret_cast<T*>(smf);
  T* X = R + n * n;  // X[l * cols + c]
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
    const T yj = X[j * cols + c] / R[j * n + j];
    for (int l = j + 1; l < n; ++l) X[l * cols + c] -= yj * R[j * n + l];
    X[j * cols + c] = yj;
  }
  for (int l = n - 1; l >= 0; --l) {
    const T xl = X[l * cols + c] / R[l * n + l];
    X[l * cols + c] = xl;
    for (int r = 0; r < l; ++r) X[r * cols + c] -= R[r * n + l] * xl;
  }
  for (int l = 0; l < n; ++l) gx[boff + (size_t)l * k + col] = X[l * cols + c];
}

constexpr int PANEL = 8;

__device__ __forceinline__ void load8(float (&v)[PANEL], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[PANEL]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// n / d, rounded as `/` is.  The identity right-hand sides of the polish
// give a zero n at every forward pivot above the column's 1, and a warp
// whose threads divide zeros took longer in the forward pass than in the
// backward one, which has as many operations (cycle stamps, PERF.md):
// the division's check sends a zero numerator down its slow path.
// The quotient of a zero by a finite nonzero d is the zero of their
// signs, formed here without dividing.
__device__ __forceinline__ float div_rn(float n, float d) {
  const bool zero = n == 0.0f && fabsf(d) > 0.0f && fabsf(d) < INFINITY;
  const float q = __fdiv_rn(zero ? 1.0f : n, d);
  return zero ? __int_as_float((__float_as_int(n) ^ __float_as_int(d)) &
                               0x80000000)
              : q;
}

// xq[t] -= a[i] * rows[i][t] for i = 0, ..., PANEL - 1 in turn (in
// descending i where `down`): the PANEL rows of the block are loaded
// first, so that their loads are in flight together
template <bool down>
__device__ __forceinline__ void apply_block(float (&xq)[PANEL],
                                            const float (&a)[PANEL],
                                            const float* rows, int stride) {
  float blk[PANEL][PANEL];
#pragma unroll
  for (int i = 0; i < PANEL; ++i) load8(blk[i], rows + i * stride);
#pragma unroll
  for (int s = 0; s < PANEL; ++s) {
    const int i = down ? PANEL - 1 - s : s;
#pragma unroll
    for (int t = 0; t < PANEL; ++t) xq[t] = xq[t] - blk[i][t] * a[i];
  }
}

// dynamic shared memory of the blocked solve: R (n x n), its transpose T
// and the columns X (rows of n + 4 floats, 16-byte aligned and, read as
// float4, free of bank conflicts); two mbarriers take 16 bytes more
__host__ __device__ constexpr size_t panel_smem_floats(int n, int cols) {
  return (size_t)n * n + (size_t)(n + cols) * (n + 4);
}

// R'R x = b by panels, n a multiple of PANEL, R 16-byte aligned per matrix;
// thread c owns column blockIdx.y * cols + c.
__global__ void __launch_bounds__(64)
chol_solve_panel_kernel(const float* __restrict__ gR,
                        const float* __restrict__ gb, float* __restrict__ gx,
                        int n, int k, int cols) {
  extern __shared__ float sm[];  // 16-byte aligned, as every offset below
  const int ts = n + 4;
  float* R = sm;          // n x n
  float* T = R + n * n;   // n x ts, T[l][r] = R[r][l]
  float* X = T + n * ts;  // cols x ts, thread c's column from X + c * ts
  __shared__ uint64_t bars[2];
  if (threadIdx.x == 0) {
    stream::bars_init(bars);
    stream::bulk_load(R, gR + (size_t)blockIdx.x * n * n,
                      (uint32_t)(n * n * sizeof(float)), bars);
  }
  const int col = blockIdx.y * cols + threadIdx.x;
  const bool active = col < k;
  const size_t boff = (size_t)blockIdx.x * n * k;
  float* xc = X + threadIdx.x * ts;
  if (active) {
#pragma unroll 16
    for (int l = 0; l < n; ++l) xc[l] = gb[boff + (size_t)l * k + col];
  }
  __syncthreads();  // the barrier's init before the waits
  stream::bar_wait(bars, 0);
  for (int e = threadIdx.x; e < n * n / 4; e += blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(R)[e];
    const int r = 4 * e / n, c0 = 4 * e % n;
    T[(c0 + 0) * ts + r] = v.x;
    T[(c0 + 1) * ts + r] = v.y;
    T[(c0 + 2) * ts + r] = v.z;
    T[(c0 + 3) * ts + r] = v.w;
  }
  __syncthreads();
  if (!active) return;
  const int np = n / PANEL;
  // forward: panel p's pivots, then their rows of R applied to panels q > p
  for (int p = 0; p < np; ++p) {
    const int p0 = p * PANEL;
    float xb[PANEL];
    load8(xb, xc + p0);
#pragma unroll
    for (int i = 0; i < PANEL; ++i) {
      float rv[PANEL];
      load8(rv, R + (p0 + i) * n + p0);
      const float y = div_rn(xb[i], rv[i]);
#pragma unroll
      for (int t = i + 1; t < PANEL; ++t) xb[t] = xb[t] - y * rv[t];
      xb[i] = y;
    }
    store8(xc + p0, xb);
    for (int q0 = p0 + PANEL; q0 < n; q0 += PANEL) {
      float xq[PANEL];
      load8(xq, xc + q0);
      apply_block<false>(xq, xb, R + p0 * n + q0, n);
      store8(xc + q0, xq);
    }
  }
  // backward: panel p's values (last panel first), then their columns of R
  // (rows of T) applied to panels q < p
  for (int p = np - 1; p >= 0; --p) {
    const int p0 = p * PANEL;
    float xb[PANEL];
    load8(xb, xc + p0);
#pragma unroll
    for (int i = PANEL - 1; i >= 0; --i) {
      float tv[PANEL];
      load8(tv, T + (p0 + i) * ts + p0);
      const float xl = div_rn(xb[i], tv[i]);
#pragma unroll
      for (int t = 0; t < i; ++t) xb[t] = xb[t] - tv[t] * xl;
      xb[i] = xl;
    }
    store8(xc + p0, xb);
    for (int q0 = 0; q0 < p0; q0 += PANEL) {
      float xq[PANEL];
      load8(xq, xc + q0);
      apply_block<true>(xq, xb, T + p0 * ts + q0, ts);
      store8(xc + q0, xq);
    }
  }
#pragma unroll 8
  for (int l = 0; l < n; ++l) gx[boff + (size_t)l * k + col] = xc[l];
}

// The global-memory plan, for n whose matrix does not fit a block's shared
// memory (f32 n > 241, f64 n > 170); one block per matrix, R in global
// memory (0.92 MB at n = 480 f32, so mostly in L2).  The factor copies M
// to R and runs chol_upper_inplace there, each chain unrolled by 8 so
// that its loads are in flight together: every entry's operations and
// their order are the shared-memory plan's, and so the twin's.
constexpr int GLOBAL_THREADS = 512;

template <typename T>
__global__ void __launch_bounds__(GLOBAL_THREADS)
chol_global_kernel(const T* __restrict__ gM, T* gR, int n) {
  const size_t off = (size_t)blockIdx.x * n * n;
  T* R = gR + off;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) R[e] = gM[off + e];
  __syncthreads();
  chol_upper_inplace<8>(R, n);
}

// R'R x = b for one matrix and one right-hand-side column (blockIdx.y),
// R in global memory, the column in shared memory as two vectors of n:
// w, the column being reduced, and y, each step's finished value.  The
// threads share each step's entries, one barrier a step.  Forward in
// saxpy form (y_j = w_j / R_jj, then w_l -= y_j R_jl for l > j), backward
// in column form on y (x_l = y_l / R_ll, then y_r -= R_rl x_l for r < l,
// x_l into w): the order of linalg/chol.py:cholesky_solve_plain, each
// product and each difference rounded.
template <typename T>
__global__ void __launch_bounds__(GLOBAL_THREADS)
chol_solve_global_kernel(const T* __restrict__ gR, const T* __restrict__ gb,
                         T* __restrict__ gx, int n, int k) {
  extern __shared__ __align__(16) float smf[];
  T* w = reinterpret_cast<T*>(smf);
  T* y = w + n;
  const int tid = threadIdx.x, nt = blockDim.x, c = blockIdx.y;
  const T* R = gR + (size_t)blockIdx.x * n * n;
  const size_t boff = (size_t)blockIdx.x * n * k;
  for (int l = tid; l < n; l += nt) w[l] = gb[boff + (size_t)l * k + c];
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const T* rj = R + (size_t)j * n;
    const T yj = w[j] / rj[j];
    for (int l = j + 1 + tid; l < n; l += nt) w[l] = w[l] - yj * rj[l];
    if (tid == 0) y[j] = yj;
    __syncthreads();
  }
  for (int l = n - 1; l >= 0; --l) {
    const T xl = y[l] / R[(size_t)l * n + l];
    for (int r = tid; r < l; r += nt) y[r] = y[r] - R[(size_t)r * n + l] * xl;
    if (tid == 0) w[l] = xl;
    __syncthreads();
  }
  for (int l = tid; l < n; l += nt) gx[boff + (size_t)l * k + c] = w[l];
}

template <typename T>
int launch_chol(const T* M, T* R, int B, int n, void* stream) {
  if (B == 0 || n == 0) return 0;
  const int smem = (int)((size_t)n * n * sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      chol_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  chol_kernel<T><<<B, CHOL_THREADS, smem, (cudaStream_t)stream>>>(M, R, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chol_solve_entry(const T* R, const T* b, T* x, int B, int n,
                            int k, int cols, cudaStream_t s) {
  const dim3 grid(B, (k + cols - 1) / cols);
  const int smem = (int)((size_t)(n * n + n * cols) * sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      chol_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  chol_solve_kernel<T><<<grid, cols, smem, s>>>(R, b, x, n, k, cols);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_global(const T* M, T* R, int B, int n, void* stream) {
  if (B == 0 || n == 0) return 0;
  const int threads = n < GLOBAL_THREADS ? (n + 31) / 32 * 32
                                         : GLOBAL_THREADS;
  chol_global_kernel<T><<<B, threads, 0, (cudaStream_t)stream>>>(M, R, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve_global(const T* R, const T* b, T* x, int B, int n, int k,
                        void* stream) {
  if (B == 0 || n == 0 || k == 0) return 0;
  const int smem = (int)(2 * (size_t)n * sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      chol_solve_global_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = n < 256 ? (n + 31) / 32 * 32 : 256;
  chol_solve_global_kernel<T><<<dim3(B, k), threads, smem,
                                (cudaStream_t)stream>>>(R, b, x, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point takes the element type as a flag: f64 picks double.
extern "C" int qp_chol(const void* M, void* R, int B, int n, int f64,
                       void* stream) {
  return f64 ? launch_chol((const double*)M, (double*)R, B, n, stream)
             : launch_chol((const float*)M, (float*)R, B, n, stream);
}

// the global-memory plan
extern "C" int qp_chol_global(const void* M, void* R, int B, int n, int f64,
                              void* stream) {
  return f64 ? launch_global((const double*)M, (double*)R, B, n, stream)
             : launch_global((const float*)M, (float*)R, B, n, stream);
}

extern "C" int qp_chol_solve_global(const void* R, const void* b, void* x,
                                    int B, int n, int k, int f64,
                                    void* stream) {
  return f64 ? launch_solve_global((const double*)R, (const double*)b,
                                   (double*)x, B, n, k, stream)
             : launch_solve_global((const float*)R, (const float*)b,
                                   (float*)x, B, n, k, stream);
}

// The shared-memory solve, `cols` right-hand sides per block; `panel`
// picks the blocked kernel (f32, n a multiple of PANEL, cols 32 or 64, R
// 16-byte aligned), else the entry-by-entry kernel with cols <= 64.
extern "C" int qp_chol_solve(const void* R, const void* b, void* x, int B,
                             int n, int k, int cols, int panel, int f64,
                             void* stream) {
  if (B == 0 || n == 0 || k == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64) {
    if (panel) return (int)cudaErrorInvalidValue;
    return launch_chol_solve_entry((const double*)R, (const double*)b,
                                   (double*)x, B, n, k, cols, s);
  }
  const float *Rf = (const float*)R, *bf = (const float*)b;
  float* xf = (float*)x;
  if (panel) {
    const dim3 grid(B, (k + cols - 1) / cols);
    const int smem = (int)(panel_smem_floats(n, cols) * sizeof(float));
    cudaError_t e = cudaFuncSetAttribute(
        chol_solve_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    const int threads = k < cols ? (k + 31) / 32 * 32 : cols;
    chol_solve_panel_kernel<<<grid, threads, smem, s>>>(Rf, bf, xf, n, k,
                                                        cols);
    return (int)cudaGetLastError();
  }
  return launch_chol_solve_entry(Rf, bf, xf, B, n, k, cols, s);
}
