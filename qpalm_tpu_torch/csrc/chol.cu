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
// The f32 solve gives each right-hand-side column its own thread, with no
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
// (512, 64, 64), tools/stream_ab.py --kernel chol, PERF.md).  Every f64
// solve whose R fits shared memory (n <= 170), any k and either parity of
// n (the general loop's one vector, the stage sweeps' nb columns, the
// polish's identity), takes a warp a column, W warps a block sharing one
// staged R (chol_solve_warp_kernel); at f64 the entry-by-entry kernel is
// reachable only through qp_chol_solve kind 0.  Past shared
// memory (f32 n > 241, f64 n > 170) the factor runs right-looking in
// panels across a thread block cluster (chol_cluster_kernel) and the solve
// keeps R in global memory, one block a column (chol_solve_global_kernel),
// in the same order of operations: each thread loads its own entries of R
// for step s + D at step s, into a ring of registers, so that no load of R
// lies on the chain of 2n dependent steps, and R's diagonal sits in shared
// memory beside the column.  Past those (the "wide" plans) no n is
// refused, and the whole card works on each matrix: where a panel of 8
// rows no longer fits a CTA (f32 n > 7264, f64 n > 3632) the grid factor
// (chol_grid_kernel: one CTA an SM, a grid barrier a step), and past the
// global solve's shared vectors or its ring's entries (f64 n > 14528, n >
// 16384), or where few columns make it the faster, the stripe solve
// (chol_solve_stripe_kernel: a CTA a stripe of each column, the stripes
// handing their values on by flags).  linalg/chol.py picks the plan (and
// the global solve's threads and entries a thread, global_solve_shape).
//
// Entry points (plain C, for ctypes) launch on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include <cooperative_groups.h>

#include "common.cuh"
#include "stream.cuh"

namespace cg = cooperative_groups;

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

// R'R x = b at f64 for every n <= 32 WARP_E whose R fits shared memory,
// one warp a right-hand-side column and W warps a block (the f64 plan
// for any k and either parity of n; linalg/chol.py:solve_plan picks W).
// The grid is (B, ceil(k / W)): a block stages matrix b's R in shared
// memory once, rows s = warp_solve_stride(n) apart, and its W warps
// solve columns blockIdx.y W + w against it.  s / 2 is odd for even n, so
// a column's entries fall in eight bank pairs (rows n apart put a 64-row
// column in one); at odd n, s = n is odd and a column read is two bank
// wavefronts, the least a warp's 32 doubles take.  R comes in by bulk
// asynchronous copies on an mbarrier: a copy a row where s != n (rows of
// 8n bytes, a multiple of 32), else the matrix as one span in chunks of
// WARP_CHUNK bytes, its first and last entries loaded by ordinary loads
// where they lie off a 16-byte boundary (an odd-n matrix starts 8 bytes
// off every other time, and the last matrix of an odd B n^2 ends 8 bytes
// short of one: no copy reads past it).  Coalesced loads by the block's
// threads, a warp a row, ran slower at every stage shape (PERF.md).  The
// columns of b and x are strided by k, read and written once.  Lane t
// owns entries t, t + 32, ... of its column in registers, E = ceil(n /
// 32) of them.  The order of chol_solve_global_kernel (below): forward
// in saxpy form (y_j = w_j / R_jj, then w_l -= y_j R_jl for l > j),
// backward in column form (x_l = y_l / R_ll, then y_r -= R_rl x_l for r
// < l), each product and each difference rounded: bit for bit
// linalg/chol.py:cholesky_solve_plain, column by column.  What bounds it
// is the chain of 2n dependent divisions.  So that no shuffle lies on
// that chain, every lane holds the step's numerator u and forms the next
// one itself, from the next entry as it stood before the step (shuffled
// from its owner while the division runs) less the step's one term,
// exactly as the owner forms it; R's row or column for a step is loaded
// a step ahead (the chain's diagonal entry too ran 4-8% slower at n =
// 119, PERF.md).  It replaces one thread a column doing every step alone
// (chol_solve_kernel, PR 6's entry plan, still reachable at f64 through
// qp_chol_solve kind 0 only), R copied in element by element.
constexpr int WARP_E = 6;       // entries of a column a lane: n <= 192
constexpr int WARP_W_MAX = 16;  // warps (columns) a block
constexpr uint32_t WARP_CHUNK = 16384;  // bytes a bulk copy of a span

__host__ __device__ inline int warp_solve_stride(int n) {
  return n % 4 ? n : n + 2;
}

// __launch_bounds__ names one block an SM: with the bound on threads
// alone ptxas held E = 3 and 4 to 64 registers and spilled; with it each
// E takes 55-90 registers and none spills (tools/ptxas_attrs.py)
template <typename T, int E>
__global__ void __launch_bounds__(32 * WARP_W_MAX, 1)
chol_solve_warp_kernel(const T* __restrict__ gR, const T* __restrict__ gb,
                       T* __restrict__ gx, int n, int k) {
  extern __shared__ __align__(16) float smf[];
  __shared__ uint64_t bars[2];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5, s = warp_solve_stride(n);
  const size_t nn = (size_t)n * n;
  const T* src = gR + blockIdx.x * nn;
  // a span whose first entry lies 8 bytes off a 16-byte boundary is
  // staged one entry on, so that the copy's destination is aligned too
  const int head = s == n && ((uintptr_t)src & 15) ? 1 : 0;
  T* R = reinterpret_cast<T*>(smf) + head;  // row r from R + r * s
  const bool rows = s != n;
  const int tail = rows ? 0 : (int)((nn - head) & 1);
  const uint32_t bytes = (uint32_t)((nn - head - tail) * sizeof(T));
  if (threadIdx.x == 0) {
    stream::bars_init(bars);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(stream::smem_addr(bars)), "r"(bytes)
                 : "memory");
  }
  __syncthreads();  // the barrier's init and expected bytes first
  if (w == 0) {
    const uint32_t row_bytes = (uint32_t)(n * sizeof(T));
    const int copies = rows ? n : (int)((bytes + WARP_CHUNK - 1) / WARP_CHUNK);
    for (int c = lane; c < copies; c += 32) {
      const size_t at = rows ? (size_t)c * s
                             : head + (size_t)c * (WARP_CHUNK / sizeof(T));
      const size_t from = rows ? (size_t)c * n : at;
      const uint32_t size =
          rows ? row_bytes : min(WARP_CHUNK, bytes - c * WARP_CHUNK);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes [%0], [%1], %2, [%3];\n" ::"r"(stream::smem_addr(R + at)),
          "l"(src + from), "r"(size), "r"(stream::smem_addr(bars))
          : "memory");
    }
  }
  if (threadIdx.x == 0 && head) R[0] = src[0];
  if (threadIdx.x == 0 && tail) R[nn - 1] = src[nn - 1];
  const int col = blockIdx.y * W + w;
  const bool active = col < k;
  const T* bv = gb + blockIdx.x * (size_t)n * k + col;
  T v[E], rv[E], rn[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int l = lane + 32 * e;
    v[e] = active && l < n ? bv[(size_t)l * k] : T(0);
  }
  stream::bar_wait(bars, 0);
  __syncthreads();  // the ordinary stores of R
  if (!active) return;
  // forward: v holds w (entries > j) and y (entries <= j), rv row j of R,
  // u = w_j
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int l = lane + 32 * e;
    rv[e] = l < n ? R[l] : T(0);
  }
  T u = __shfl_sync(QP_FULL_MASK, v[0], 0);
#pragma unroll
  for (int e0 = 0; e0 < E; ++e0) {
    for (int jj = 0; jj < 32; ++jj) {
      const int j = 32 * e0 + jj;
      if (j >= n) break;
      const T wn = __shfl_sync(
          QP_FULL_MASK, jj < 31 ? v[e0] : v[e0 + 1 < E ? e0 + 1 : e0],
          (j + 1) & 31);
      const T djj = R[j * s + j], dn = j + 1 < n ? R[j * s + j + 1] : T(0);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int l = lane + 32 * e;
        rn[e] = j + 1 < n && l < n ? R[(j + 1) * s + l] : T(0);
      }
      const T yj = u / djj;
      u = wn - yj * dn;  // w_{j+1}, as its owner forms it below
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int l = lane + 32 * e;
        if (l > j && l < n) v[e] = v[e] - yj * rv[e];
        if (l == j) v[e] = yj;
        rv[e] = rn[e];
      }
    }
  }
  // backward: v holds y (entries < l) and x (entries >= l), rv column l
  // of R, u = y_l
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = lane + 32 * e;
    rv[e] = r < n ? R[r * s + n - 1] : T(0);
  }
#pragma unroll
  for (int e0 = E - 1; e0 >= 0; --e0) {
    for (int jj = 31; jj >= 0; --jj) {
      const int l = 32 * e0 + jj;
      if (l >= n) continue;
      if (l == n - 1) u = __shfl_sync(QP_FULL_MASK, v[e0], jj);
      const T yp = __shfl_sync(
          QP_FULL_MASK, jj > 0 ? v[e0] : v[e0 > 0 ? e0 - 1 : 0],
          (l - 1) & 31);
      const T dll = R[l * s + l], dp = l > 0 ? R[(l - 1) * s + l] : T(0);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = lane + 32 * e;
        rn[e] = l > 0 && r < n ? R[r * s + l - 1] : T(0);
      }
      const T xl = u / dll;
      u = yp - dp * xl;  // y_{l-1}, as its owner forms it below
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = lane + 32 * e;
        if (r < l) v[e] = v[e] - rv[e] * xl;
        if (r == l) v[e] = xl;
        rv[e] = rn[e];
      }
    }
  }
  T* xv = gx + blockIdx.x * (size_t)n * k + col;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int l = lane + 32 * e;
    if (l < n) xv[(size_t)l * k] = v[e];
  }
}

// The shared memory of a block: R's n rows s apart, and one entry more
// for a span staged one entry on (linalg/chol.py:warp_smem_bytes, beside
// the static mbarriers).
inline size_t warp_smem(int n) {
  return ((size_t)n * warp_solve_stride(n) + 1) * sizeof(double);
}

template <int E>
int launch_solve_warp(const double* R, const double* b, double* x, int B,
                      int n, int k, int W, cudaStream_t s) {
  const int smem = (int)warp_smem(n);
  cudaError_t e = cudaFuncSetAttribute(
      chol_solve_warp_kernel<double, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B, (k + W - 1) / W);
  chol_solve_warp_kernel<double, E><<<grid, 32 * W, smem, s>>>(R, b, x, n, k);
  return (int)cudaGetLastError();
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

// The global-memory factor, for n whose matrix does not fit one block's
// shared memory (f32 n > 241, f64 n > 170): right-looking in panels of b
// rows (b a multiple of CTILE), one cluster of C CTAs a matrix, one launch.
// It replaces a left-looking plan that ran every entry's whole chain (up
// to n terms, from L2 or HBM) in one block a matrix, 64 of 132 SMs busy
// at the general loop's B = 64 (6.975 ms at f32 n = 480, PERF.md).
//
// The schedule, for panel rows p..p+bb-1:
//  - every CTA gathers the panel (columns p..n-1 of rows p..p+bb-1 of R,
//    which carry every earlier panel's update; of M for the first panel)
//    into its own shared memory and factors it there, row by row,
//    left-looking, one block barrier a row: the CTAs compute the same
//    numbers, so no finished panel has to be published and waited for,
//    and each CTA needs all of it for its trailing tiles;
//  - each CTA updates its own tiles of the trailing upper triangle, CTILE x
//    CTILE in registers, each loaded once and stored once into R,
//    subtracting the panel's bb products in row order;
//  - one cluster barrier (barrier.cluster.arrive.release / wait.acquire);
//  - the CTAs write the panel's rows of R (zeros left of the diagonal).
// The trailing triangle is dealt to the CTAs by tile column (tile column
// tc to rank tc % C), so that the shrinking triangle stays balanced, and a
// CTA's threads take its tiles in turn.
//
// What bounds it (cycle counters, tools/chol_plans.py): the panel rows'
// chain (n rows of up to b subtractions, 1 / sqrt, a division and a
// barrier; about half the time at n = 480) and the trailing updates.  A
// variant that kept the trailing triangle in the cluster's shared memory
// (4-8 CTAs a matrix at n = 480) ran in several waves at the general
// loop's B = 64 and lost to one wave of 2-CTA clusters with the triangle
// in R, which L2 holds (PERF.md).  linalg/chol.py:global_plan picks C and
// b (and mirrors cluster_smem_bytes); where not even a panel of CTILE rows
// fits a CTA (f32 n > 7264, f64 n > 3632) it picks the grid factor below.  Every entry gets
// the twin's arithmetic in the twin's order: entry (k, l) less R_ik R_il for
// i = 0, 1, ..., k - 1 (the earlier panels' in the trailing updates, this
// panel's in its row), each product and each difference rounded, then times
// 1 / sqrt of the pivot so reduced (not rsqrt), the diagonal pivot * inv:
// bit for bit linalg/chol.py:cholesky_upper_plain, as
// stream.cuh:chol_blocked is.
constexpr int CTILE = 8;
constexpr int CLUSTER_THREADS = 256;
constexpr int CLUSTER_MAX = 8;  // the portable cluster size

// the panel of a CTA of the cluster factor, b rows of CTILE * ceil(n /
// CTILE) elements of es bytes: its dynamic shared memory
__host__ __device__ inline size_t cluster_smem_bytes(int n, int es, int b) {
  return (size_t)b * ((n + CTILE - 1) / CTILE) * CTILE * es;
}

// CTILE consecutive elements of the panel (16-byte aligned), as 16-byte
// loads and stores
template <typename T>
__device__ __forceinline__ void ld8(T (&v)[CTILE], const T* p) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double2 d = reinterpret_cast<const double2*>(p)[i];
      v[2 * i] = d.x;
      v[2 * i + 1] = d.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ void st8(T* p, const T (&v)[CTILE]) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<double2*>(p)[i] = make_double2(v[2 * i], v[2 * i + 1]);
  }
}

// CTILE elements from p on (16-byte aligned) as 16-byte loads through L2
// only (other CTAs wrote them)
template <typename T>
__device__ __forceinline__ void ldcg8(T (&v)[CTILE], const T* p) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double2 d = __ldcg(reinterpret_cast<const double2*>(p) + i);
      v[2 * i] = d.x;
      v[2 * i + 1] = d.y;
    }
  }
}

// CTILE elements of a row of a matrix in global memory, from column col
// on; `vec` where the row's first element is 16-byte aligned and all CTILE
// lie in the row (ldcg8), else element by element, those past column n - 1
// read as 0 and not written
template <typename T>
__device__ __forceinline__ void gload8(T (&v)[CTILE], const T* row, int col,
                                       int n, bool vec) {
  if (vec && col + CTILE <= n) {
    ldcg8(v, row + col);
    return;
  }
#pragma unroll
  for (int y = 0; y < CTILE; ++y)
    v[y] = col + y < n ? __ldcg(row + col + y) : T(0);
}

template <typename T>
__device__ __forceinline__ void gstore8(T* row, int col, int n, bool vec,
                                        const T (&v)[CTILE]) {
  if (vec && col + CTILE <= n) {
    st8(row + col, v);
    return;
  }
#pragma unroll
  for (int y = 0; y < CTILE; ++y)
    if (col + y < n) row[col + y] = v[y];
}

// One matrix a cluster (grid B * C, cluster (C, 1, 1)).  R gets the upper
// factor with a zero lower triangle.  PROF (a separate instantiation, as
// K1's profiled one): thread 0 of each CTA adds up its cycles by section
// (CLUSTER_SECTIONS in linalg/chol.py) into prof[8 blockIdx.x + s].
template <typename T, bool PROF>
__global__ void __launch_bounds__(CLUSTER_THREADS)
chol_cluster_kernel(const T* __restrict__ gM, T* __restrict__ gR, int n,
                    int b, long long* prof) {
  extern __shared__ __align__(16) float smf[];
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nb = (n + CTILE - 1) / CTILE, pw = CTILE * nb;
  T* pan = reinterpret_cast<T*>(smf);  // the panel, pan[r * pw + column]
  const bool vec = n % (16 / (int)sizeof(T)) == 0;  // rows 16-byte aligned
  const size_t off = (size_t)(blockIdx.x / C) * n * n;
  const T* M = gM + off;
  T* R = gR + off;
  // f(tr, tc) for this rank's tiles of rows and columns q.. (tr <= tc),
  // column by column, thread g taking the g-th, (g + nt)-th, ...
  auto own_tiles = [&](int q, auto&& f) {
    int tc = q + ((rank - q) % C + C) % C, first = 0;
    for (int g = tid;; g += nt) {
      while (tc < nb && g >= first + tc - q + 1) {
        first += tc - q + 1;
        tc += C;
      }
      if (tc >= nb) break;
      f(q + g - first, tc);
    }
  };
  long long cycles[5] = {0, 0, 0, 0, 0}, tick = 0;
  if constexpr (PROF) tick = clock64();
  auto stamp = [&](int section) {
    if constexpr (PROF) {
      const long long now = clock64();
      cycles[section] += now - tick;
      tick = now;
    }
  };

  // The first panel reads M, and its trailing update writes R.
  for (int p = 0; p < n; p += b) {
    const int bb = min(b, n - p), q0 = p / CTILE;
    const T* src = p == 0 ? M : R;  // where the trailing rows are
    // the panel's rows, tile by tile (upper tiles only: the entries left of
    // the diagonal are never read)
    const int ncols = nb - q0;
    for (int e = tid; e < bb * ncols; e += nt) {
      const int r = e / ncols, tc = q0 + e % ncols, row = p + r;
      if (tc < row / CTILE) continue;
      T v[CTILE];
      gload8(v, src + (size_t)row * n, CTILE * tc, n, vec);
      st8(pan + r * pw + CTILE * tc, v);
    }
    __syncthreads();
    stamp(0);
    // the panel's rows, left-looking, one barrier a row: every thread forms
    // the diagonal itself beside its first two entries.  Thread 0 stores a
    // row's diagonal a row later, after the barrier, since every thread
    // reads the unreduced one at the row's start.
    T dprev = T(0);
    for (int k = 0; k < bb; ++k) {
      const int c = p + k;
      if (tid == 0 && k > 0) pan[(k - 1) * pw + c - 1] = dprev;
      const int l0 = c + 1 + tid, l1 = l0 + nt;
      T akk = pan[k * pw + c];
      T a0 = l0 < n ? pan[k * pw + l0] : T(0);
      T a1 = l1 < n ? pan[k * pw + l1] : T(0);
#pragma unroll 4
      for (int i = 0; i < k; ++i) {
        const T ri = pan[i * pw + c];
        akk -= ri * ri;
        if (l0 < n) a0 -= ri * pan[i * pw + l0];
        if (l1 < n) a1 -= ri * pan[i * pw + l1];
      }
      const T inv = T(1) / qp_sqrt(akk);  // not rsqrt: that is approximate
      if (l0 < n) pan[k * pw + l0] = a0 * inv;
      if (l1 < n) pan[k * pw + l1] = a1 * inv;
      for (int l = l1 + nt; l < n; l += nt) {
        T acc = pan[k * pw + l];
        for (int i = 0; i < k; ++i) acc -= pan[i * pw + c] * pan[i * pw + l];
        pan[k * pw + l] = acc * inv;
      }
      dprev = akk * inv;
      __syncthreads();
    }
    if (tid == 0) pan[(bb - 1) * pw + p + bb - 1] = dprev;
    stamp(1);
    // this rank's tiles of the trailing upper triangle
    const int t0 = p + bb;
    if (t0 < n) own_tiles(t0 / CTILE, [&](int tr, int tc) {
      T acc[CTILE][CTILE];
#pragma unroll
      for (int x = 0; x < CTILE; ++x) {
        const int row = CTILE * tr + x;
        if (row < n) gload8(acc[x], src + (size_t)row * n, CTILE * tc, n, vec);
      }
      for (int r = 0; r < bb; ++r) {
        T a[CTILE], cv[CTILE];
        ld8(a, pan + r * pw + CTILE * tr);
        ld8(cv, pan + r * pw + CTILE * tc);
#pragma unroll
        for (int x = 0; x < CTILE; ++x)
#pragma unroll
          for (int y = 0; y < CTILE; ++y) acc[x][y] -= a[x] * cv[y];
      }
#pragma unroll
      for (int x = 0; x < CTILE; ++x) {
        const int row = CTILE * tr + x;
        if (row < n)
          gstore8(R + (size_t)row * n, CTILE * tc, n, vec, acc[x]);
      }
    });
    stamp(2);
    // every rank's gather of this panel and update of its tiles are done
    cl.sync();
    stamp(3);
    // the panel's rows of R, the cluster's threads in turn
    for (int e = rank * nt + tid; e < bb * n; e += C * nt) {
      const int r = e / n, col = e - r * n;
      R[(size_t)(p + r) * n + col] = col >= p + r ? pan[r * pw + col] : T(0);
    }
    __syncthreads();  // before the next gather overwrites pan
    stamp(4);
  }
  if constexpr (PROF)
    if (tid == 0)
      for (int section = 0; section < 5; ++section)
        prof[8 * blockIdx.x + section] = cycles[section];
}

// The grid factor ("wide" in linalg/chol.py:factor_plan: f32 n > 7264,
// f64 n > 3632, where not even a panel of CTILE rows fits a CTA of the
// cluster factor; and below that, few matrices from the n where it
// measured faster, linalg/chol.py:global_plan).  It replaces
// `_chol_kernel_loop` of qpalm_tpu/linalg/pallas_chol.py there, as the
// cluster factor does elsewhere.  What bounds a factor at B = 1 on this
// card is how many SMs work on the one matrix: the cluster factor's 8 CTAs
// left 124 of 132 SMs idle (74.680 ms at f64 n = 3640 against an
// operations bound of 0.47 ms on the whole card, PERF.md).  So this
// kernel is persistent, one CTA an SM, launched cooperatively so that
// every CTA is resident and a grid barrier can order them; the CTAs are
// shared out over the matrices, `per` a matrix.  Right-looking in panels
// of BR rows, for panel rows p..p+BR-1:
//  1. every CTA loads the panel's BR x BR diagonal triangle and one warp
//     factors it (factor_triangle), a warp barrier a row: every CTA
//     computes the same numbers, so none is published;
//  2. each CTA computes the panel rows at its own contiguous slice of the
//     columns right of the triangle, a thread a column, the column's BR
//     entries in registers, and writes them to R: entry (p + k, l) needs
//     only the triangle and column l, so the CTAs do not wait on each other;
//  3. a grid barrier;
//  4. CTA 0 of the matrix writes the triangle (zeros below its diagonal),
//     the CTAs write the zeros left of it, and the trailing upper triangle
//     is dealt to them in blocks of GRID_TB x GRID_TB tiles of CTILE x
//     CTILE (round robin, column by column): a CTA brings the panel rows at
//     the block's tile rows and tile columns into shared memory once, and
//     each thread takes one tile in registers less the panel's BR products
//     in row order, so that a tile reads the panel from shared memory and
//     not, 2 BR CTILE elements a tile, from L2;
//  5. a grid barrier (none after the last panel).
// Everything another CTA wrote is read through L2 (__ldcg), never L1.
// Every entry gets the twin's arithmetic in the twin's order, as in the
// cluster factor: entry (k, l) less R_ik R_il for i = 0, 1, ..., k - 1
// (the earlier panels' in the trailing updates, this panel's in the
// triangle or the slice), each product and each difference rounded, then
// times 1 / sqrt of the pivot (not rsqrt), the diagonal pivot * inv: bit
// for bit linalg/chol.py:cholesky_upper_plain.  PROF: thread 0 of each CTA
// adds up its cycles by section (GRID_SECTIONS in linalg/chol.py) into
// prof[8 blockIdx.x + s].  Measured on an NVIDIA H100 80GB HBM3 at 700.00
// W (tools/stream_ab.py --kernel chol_wide, A B B A against the cluster
// factor it replaces): f64 (1, 3640) 6.015 ms (75.38; torch.linalg.cholesky
// 5.2), f32 (1, 7272) 14.66 ms (321.30; 11.4), panels of 64 rows; by its
// counters the triangle's chain and the barriers' wait for the slowest
// CTA's blocks are most of what is left (PERF.md).
constexpr int GRID_TB = 16;  // tiles a side of a block: a thread a tile
constexpr int GRID_THREADS = GRID_TB * GRID_TB;

// the strips' CTILE-element groups, padded by 16 bytes, so that the 16-byte
// loads of 8 lanes with 8 consecutive groups fall in distinct banks
template <typename T>
__host__ __device__ constexpr int grid_group_stride() {
  return CTILE + 16 / (int)sizeof(T);
}

template <typename T, int BR>
__host__ __device__ constexpr int grid_smem_bytes() {
  return 2 * BR * GRID_TB * grid_group_stride<T>() * (int)sizeof(T);
}

// A CTILE x CTILE tile at (r0, c0) of an n x n row-major matrix into acc
// (LOAD, through L2) or out of it: `whole` where every row of it is
// 16-byte aligned and its columns lie inside the matrix (its rows do, as
// r0 <= c0), else entry by entry, those outside read as 0, not written
template <bool LOAD, typename T>
__device__ __forceinline__ void grid_tile_io(T (&acc)[CTILE][CTILE],
                                             const T* A, int n, int r0,
                                             int c0, bool whole) {
  T* W = const_cast<T*>(A);
  if (whole) {
#pragma unroll
    for (int x = 0; x < CTILE; ++x) {
      if constexpr (LOAD)
        ldcg8(acc[x], A + (size_t)(r0 + x) * n + c0);
      else
        st8(W + (size_t)(r0 + x) * n + c0, acc[x]);
    }
    return;
  }
#pragma unroll
  for (int x = 0; x < CTILE; ++x)
#pragma unroll
    for (int y = 0; y < CTILE; ++y) {
      const bool in = r0 + x < n && c0 + y < n;
      const size_t at = (size_t)(r0 + x) * n + c0 + y;
      if constexpr (LOAD)
        acc[x][y] = in ? __ldcg(A + at) : T(0);
      else if (in)
        W[at] = acc[x][y];
    }
}

// The panel's diagonal triangle (bb <= BR rows of tri, its upper part
// loaded) factored in place by one warp, left-looking, row by row: lane t
// forms entries (k, c) for c = k + t, k + t + 32, ..., each less R_ik R_ic
// for i = 0..k-1 in turn (the products off the chain: only the
// differences wait on each other), then every lane takes 1 / sqrt of the
// pivot (shuffled from lane 0) and scales its entries.  A warp barrier a
// row; the inner loop only loads, so its loads run ahead.  invs[k] gets
// row k's 1 / sqrt.
template <typename T, int BR>
__device__ __forceinline__ void factor_triangle(T (*tri)[BR + 1], T* invs,
                                                int bb) {
  constexpr int H = BR / 32;
  const int lane = threadIdx.x;
  for (int k = 0; k < bb; ++k) {
    T acc[H];
    bool on[H];  // the lane's entries (k, k + lane + 32 h) of the row
#pragma unroll
    for (int h = 0; h < H; ++h) {
      on[h] = k + lane + 32 * h < bb;
      acc[h] = on[h] ? tri[k][k + lane + 32 * h] : T(0);
    }
    // unrolled, so that the loads of eight terms are in flight at once
#pragma unroll 8
    for (int i = 0; i < k; ++i) {
      const T rik = tri[i][k];
#pragma unroll
      for (int h = 0; h < H; ++h)
        if (on[h]) acc[h] = acc[h] - rik * tri[i][k + lane + 32 * h];
    }
    const T inv = T(1) / qp_sqrt(__shfl_sync(QP_FULL_MASK, acc[0], 0));
#pragma unroll
    for (int h = 0; h < H; ++h)  // at c = k the pivot times inv
      if (on[h]) tri[k][k + lane + 32 * h] = acc[h] * inv;
    if (lane == 0) invs[k] = inv;
    __syncwarp();
  }
}

// column-major position f of the upper triangle of tiles -> (row i, column
// j), i <= j, f = j (j + 1) / 2 + i
__device__ __forceinline__ void tri_tile(long long f, int& i, int& j) {
  int jj = (int)((sqrt(8.0 * (double)f + 1.0) - 1.0) * 0.5);
  while ((long long)jj * (jj + 1) / 2 > f) --jj;
  while ((long long)(jj + 1) * (jj + 2) / 2 <= f) ++jj;
  j = jj;
  i = (int)(f - (long long)jj * (jj + 1) / 2);
}

template <typename T, int BR, bool PROF>
__global__ void __launch_bounds__(GRID_THREADS, 1)
chol_grid_kernel(const T* __restrict__ gM, T* __restrict__ gR, int B, int n,
                 int per, long long* prof) {
  static_assert(BR % CTILE == 0, "panels of whole tiles");
  __shared__ T tri[BR][BR + 1];  // the panel's diagonal triangle
  __shared__ T invs[BR];         // 1 / sqrt of each of its pivots
  // the panel rows at a block's tile rows (pr) and tile columns (pc): BR
  // rows of GRID_TB groups of CTILE elements, groups gs apart
  constexpr int gs = grid_group_stride<T>(), gpw = GRID_TB * gs;
  extern __shared__ __align__(16) float smf[];
  T* pr = reinterpret_cast<T*>(smf);
  T* pc = pr + BR * gpw;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int groups = (int)gridDim.x / per, group = blockIdx.x / per,
            rank = blockIdx.x % per;
  const int nb = (n + CTILE - 1) / CTILE;
  const bool vec = n % (16 / (int)sizeof(T)) == 0;  // rows 16-byte aligned
  long long cycles[5] = {0, 0, 0, 0, 0}, tick = 0;
  if constexpr (PROF) tick = clock64();
  auto stamp = [&](int section) {
    if constexpr (PROF) {
      const long long now = clock64();
      cycles[section] += now - tick;
      tick = now;
    }
  };

  // every group takes one matrix a round; all run the same barriers
  for (int m0 = 0; m0 < B; m0 += groups) {
    const int m = m0 + group;
    const bool active = m < B;
    const size_t off = (size_t)(active ? m : 0) * n * n;
    const T* M = gM + off;
    T* R = gR + off;
    for (int p = 0; p < n; p += BR) {
      const int bb = min(BR, n - p), t0 = p + bb;
      const T* src = p == 0 ? M : R;  // where the trailing rows are
      if (active) {
        // 1. the diagonal triangle (its upper part only)
        for (int e = tid; e < bb * bb; e += GRID_THREADS) {
          const int r = e / bb, c = e - r * bb;
          if (c >= r) tri[r][c] = __ldcg(src + (size_t)(p + r) * n + p + c);
        }
        __syncthreads();
        if (tid < 32) factor_triangle<T, BR>(tri, invs, bb);
        __syncthreads();
        stamp(0);
        // 2. the panel rows at this CTA's columns (none at the last panel,
        // so that bb == BR here)
        const int ncols = n - t0, chunk = (ncols + per - 1) / per;
        const int lo = t0 + rank * chunk, hi = min(n, lo + chunk);
        for (int l = lo + tid; l < hi; l += GRID_THREADS) {
          T acc[BR];
#pragma unroll
          for (int k = 0; k < BR; ++k)
            acc[k] = __ldcg(src + (size_t)(p + k) * n + l);
#pragma unroll
          for (int k = 0; k < BR; ++k) {
            const T pk = acc[k] * invs[k];
            acc[k] = pk;
#pragma unroll
            for (int j = k + 1; j < BR; ++j) acc[j] = acc[j] - tri[k][j] * pk;
            // no row's loads of tri ahead of this row: hoisted, they spilled
            asm volatile("" ::: "memory");
          }
#pragma unroll
          for (int k = 0; k < BR; ++k) R[(size_t)(p + k) * n + l] = acc[k];
        }
        stamp(1);
      }
      grid.sync();
      stamp(3);
      if (active) {
        // 4. the triangle and the zeros left of it, then the trailing tiles
        if (rank == 0)
          for (int e = tid; e < bb * bb; e += GRID_THREADS) {
            const int r = e / bb, c = e - r * bb;
            R[(size_t)(p + r) * n + p + c] = c >= r ? tri[r][c] : T(0);
          }
        for (int e = rank * GRID_THREADS + tid; e < bb * p;
             e += per * GRID_THREADS) {
          const int r = e / p, c = e - r * p;
          R[(size_t)(p + r) * n + c] = T(0);
        }
        stamp(4);
        if (t0 < n) {
          const int q = t0 / CTILE, nc = nb - q;
          const int nbk = (nc + GRID_TB - 1) / GRID_TB;
          const int x = tid / GRID_TB, y = tid % GRID_TB;
          const T* P = R + (size_t)p * n;  // the panel rows, final
          for (int f = rank; f < nbk * (nbk + 1) / 2; f += per) {
            int bi, bj;
            tri_tile(f, bi, bj);
            const int c0r = CTILE * (q + GRID_TB * bi),
                      c0c = CTILE * (q + GRID_TB * bj);
            __syncthreads();  // the last block's reads of the strips
#pragma unroll 4
            for (int e = tid; e < BR * GRID_TB * CTILE; e += GRID_THREADS) {
              const int r = e / (GRID_TB * CTILE), ci = e % (GRID_TB * CTILE);
              const int at = r * gpw + ci / CTILE * gs + ci % CTILE;
              pr[at] = c0r + ci < n ? __ldcg(P + (size_t)r * n + c0r + ci)
                                    : T(0);
              pc[at] = c0c + ci < n ? __ldcg(P + (size_t)r * n + c0c + ci)
                                    : T(0);
            }
            __syncthreads();
            const int tr = q + GRID_TB * bi + x, tc = q + GRID_TB * bj + y;
            if (tr > tc || tc >= nb) continue;
            // a tile inside the matrix with 16-byte aligned rows, or not:
            // one branch a tile, so that the two ways of loading and
            // storing it never hold registers at once (they spilled)
            const bool whole = vec && CTILE * tc + CTILE <= n;
            T acc[CTILE][CTILE];
            grid_tile_io<true>(acc, src, n, CTILE * tr, CTILE * tc, whole);
#pragma unroll 1
            for (int r = 0; r < BR; ++r) {
              T a[CTILE], cv[CTILE];
              ld8(a, pr + r * gpw + x * gs);
              ld8(cv, pc + r * gpw + y * gs);
#pragma unroll
              for (int xx = 0; xx < CTILE; ++xx)
#pragma unroll
                for (int yy = 0; yy < CTILE; ++yy)
                  acc[xx][yy] = acc[xx][yy] - a[xx] * cv[yy];
            }
            grid_tile_io<false>(acc, R, n, CTILE * tr, CTILE * tc, whole);
          }
        }
        stamp(2);
      }
      if (t0 < n) {  // 5. (uniform over the grid: every matrix has this n)
        grid.sync();
        stamp(3);
      }
    }
  }
  if constexpr (PROF)
    if (tid == 0)
      for (int section = 0; section < 5; ++section)
        prof[8 * blockIdx.x + section] = cycles[section];
}

// The global solve's shape, picked by linalg/chol.py:global_solve_shape
// and passed in: nt threads a block (a multiple of 32, at most
// GS_THREADS_MAX) and E entries a thread (a power of two, at most
// GS_E_MAX).  The threads are picked for GS_ENTRY_BYTES of R a thread a
// step (2 f32 entries, 1 f64), so E is larger only at GS_THREADS_MAX
// threads, which the kernel then takes as a constant.  The ring's depth D
// follows from E: GS_RING_BYTES of R a thread, 1 to GS_DEPTH_MAX entries
// deep (deeper rings spilled or ran slower, PERF.md).
constexpr int GS_THREADS_MAX = 512, GS_E_MAX = 32, GS_ENTRY_BYTES = 8;
constexpr int GS_RING_BYTES = 64, GS_DEPTH_MAX = 8;

template <typename T>
__host__ __device__ constexpr int gs_depth(int E) {
  const int d = GS_RING_BYTES / (E * (int)sizeof(T));
  return d < 1 ? 1 : d > GS_DEPTH_MAX ? GS_DEPTH_MAX : d;
}

// n / d rounded as `/` is, a zero n by a finite nonzero d without dividing
// (div_rn above; the polish's identity right-hand sides give zero
// numerators): the zero of their signs is their product
__device__ __forceinline__ double div_rn(double n, double d) {
  const bool zero = n == 0.0 && fabs(d) > 0.0 && fabs(d) < INFINITY;
  const double q = __ddiv_rn(zero ? 1.0 : n, d);
  return zero ? n * d : q;
}

// R'R x = b for one matrix and one right-hand-side column (blockIdx.y),
// R in global memory: the 2n dependent steps of linalg/chol.py:
// cholesky_solve_plain, forward in saxpy form (y_j = w_j / R_jj, then w_l
// -= y_j R_jl for l > j), backward in column form (x_l = y_l / R_ll, then
// y_r -= R_rl x_l for r < l), each product and each difference rounded.
// One barrier a step.  The column lives in shared memory (v: w, then y,
// then x), R's diagonal beside it, both loaded once.  Thread t owns entries
// t, t + nt, ..., E of them: only it writes them, and the others read
// entry j at step j.  A step's quotient goes into its entry a step later
// (every thread holds it), so that no thread overwrites an entry another
// may still be reading.  R's reads come in a fixed order (row j forward,
// column l backward), so each thread loads the entries of step s + D at
// step s, its own only, into a ring of D registers an entry, and no load
// of R lies on the chain; the loop is unrolled by D so that every ring
// index is static.  Backward reads a column, one element in each 32-byte
// sector, and is left so.  A step's chain is the barrier, two
// shared-memory loads, the division, one owner's update and its store.
// Its measurements and the variants tried: PERF.md.
template <typename T, int E>
__global__ void __launch_bounds__(GS_THREADS_MAX)
chol_solve_global_kernel(const T* __restrict__ gR, const T* __restrict__ gb,
                         T* __restrict__ gx, int n, int k) {
  constexpr int D = gs_depth<T>(E);
  extern __shared__ __align__(16) float smf[];
  T* v = reinterpret_cast<T*>(smf);
  T* dg = v + n;
  // a constant block size puts each entry's offset into its load's
  // immediate rather than a register: large E spilled without it
  const int tid = threadIdx.x, c = blockIdx.y,
            nt = E * (int)sizeof(T) > GS_ENTRY_BYTES ? GS_THREADS_MAX
                                                        : blockDim.x;
  const T* R = gR + (size_t)blockIdx.x * n * n;
  const size_t boff = (size_t)blockIdx.x * n * k;
  // this thread's entries of R for combined step s (forward j = s, backward
  // l = 2n - 1 - s), 0 where the step does not update the entry
  auto fetch = [&](T (&dst)[E], int s) {
    if (s < n) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int l = tid + nt * e;
        dst[e] = l > s && l < n ? R[(size_t)s * n + l] : T(0);
      }
    } else {
      const int l = 2 * n - 1 - s;  // < 0 past the last step: no entry
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = tid + nt * e;
        dst[e] = r < l ? R[(size_t)r * n + l] : T(0);
      }
    }
  };
  T ring[D][E];
#pragma unroll
  for (int d = 0; d < D; ++d) fetch(ring[d], d);
  for (int l = tid; l < n; l += nt) {
    v[l] = gb[boff + (size_t)l * k + c];
    dg[l] = R[(size_t)l * n + l];
  }
  __syncthreads();
  T prev = T(0);  // the last step's quotient
  for (int s0 = 0; s0 < 2 * n; s0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int s = s0 + d;
      if (s >= 2 * n) break;
      if (s < n) {
        const T q = div_rn(v[s], dg[s]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int l = tid + nt * e;
          if (l > s && l < n) v[l] = v[l] - q * ring[d][e];
          if (l == s - 1) v[l] = prev;
        }
        prev = q;
      } else {
        const int l = 2 * n - 1 - s;
        const T q = div_rn(s == n ? prev : v[l], dg[l]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int r = tid + nt * e;
          if (r < l) v[r] = v[r] - ring[d][e] * q;
          if (r == l + 1 && s > n) v[r] = prev;  // x_{l+1}; y_{n-1} unused
        }
        prev = q;
      }
      fetch(ring[d], s + D);
      __syncthreads();
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int l = tid + nt * e;
    if (l < n) gx[boff + (size_t)l * k + c] = l == 0 ? prev : v[l];
  }
}

// The stripe solve ("wide" in linalg/chol.py:solve_plan: f64 n > 14528,
// whose two vectors outgrow the global solve's shared memory, f32 n >
// GS_THREADS_MAX * GS_E_MAX, past its ring's entries a thread, and the
// solves of few columns where it beats the global solve).  It replaces
// `_solve_kernel_loop` of qpalm_tpu/linalg/pallas_chol.py there.  What
// bounds a solve of one column is its chain of 2n dependent divisions;
// one SM a column (the global solve) also spends each step on that SM's
// traffic of the step's row or column of R, about 4 us a step at f64 n =
// 14536 (PERF.md).  So a column's n entries are cut into stripes of W, a
// CTA of W threads a stripe, the stripes of every column of every matrix
// at once, over the whole card.  Each pass is one launch: forward, then
// backward (the launch boundary makes the forward pass final for the
// backward one).  A CTA draws its stripe from an atomic ticket, one counter
// a column a pass, in the order the pass needs (forward ascending,
// backward descending), and so waits only on stripes that CTAs already
// running took: no deadlock, whatever the card keeps resident.  Forward,
// stripe s applies the tiles R[pW:(p+1)W, sW:(s+1)W] for p = 0..s-1 in
// turn (w_l -= y_j R_jl, j ascending), each once stripe p's flag is set;
// backward, the tiles R[sW:(s+1)W, pW:(p+1)W] for p from the last stripe
// down (y_r -= R_rk x_k, k descending), a thread walking its row of the
// tile.  Each tile comes into shared memory by cp.async, one tile ahead of
// its use (the next stripe's tile does not wait on any flag), rows padded
// to W + 1 elements, entries past n zero-filled (a zero term leaves an
// entry as it is).  Then one warp solves the stripe's diagonal block as
// chol_solve_warp_kernel does (every lane forms the next numerator
// itself, so no shuffle lies on the chain of divisions), writes the
// stripe's values into x's column, and sets its flag (stores, fence,
// release); a waiter's thread 0 spins on an acquire load, and its CTA
// reads the published values through L2 (__ldcg).  Every entry gets the
// twin's terms in the twin's order, each product and each difference
// rounded, and a true division: bit for bit
// linalg/chol.py:cholesky_solve_plain.  The wrapper zeroes the tickets and
// flags (sync: 2 passes x B k columns x (1 ticket + S flags) ints).
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (tools/stream_ab.py
// --kernel chol_wide against the kernel it replaces, tools/chol_plans.py
// --solve): f64 n = 14536 4.344 ms in stripes of 32 (120.65;
// torch.cholesky_solve 4.12), f32 n = 16392 3.619 ms in stripes of 64
// (139.32; 4.19), f64 (1, 3640) 1.082 ms against the global solve's
// 7.276; what bounds it is the chain of divisions and a flag hand-off a
// stripe (PERF.md).
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// one element by cp.async, zeros where !ok
template <typename T>
__device__ __forceinline__ void cp_elem(T* dst, const T* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   stream::smem_addr(dst)),
               "l"(src), "n"((int)sizeof(T)), "r"(ok ? (int)sizeof(T) : 0)
               : "memory");
}

// tiles of W x (W + 1) elements: two (one ahead) where they fit
template <typename T, int W>
__host__ __device__ constexpr int stripe_bufs() {
  return (2 * W * (W + 1) + W) * (int)sizeof(T) <= 232448 ? 2 : 1;
}

template <typename T, int W>
__host__ __device__ constexpr int stripe_smem_bytes() {
  return (stripe_bufs<T, W>() * W * (W + 1) + W) * (int)sizeof(T);
}

template <typename T, int W>
__global__ void __launch_bounds__(W)
chol_solve_stripe_kernel(const T* __restrict__ gR, const T* __restrict__ gb,
                         T* __restrict__ gx, int n, int k, int bwd,
                         int* __restrict__ sync) {
  constexpr int LD = W + 1, NBUF = stripe_bufs<T, W>(), E = W / 32;
  extern __shared__ __align__(16) float smf[];
  T* tiles = reinterpret_cast<T*>(smf);  // NBUF tiles, row r at r * LD
  T* ys = tiles + NBUF * W * LD;  // a tile's published values, then v
  __shared__ int s_ticket;
  const int tid = threadIdx.x, S = (n + W - 1) / W;
  const int c = blockIdx.y, m = blockIdx.z;
  int* ticket =
      sync + ((size_t)bwd * gridDim.z * k + (size_t)m * k + c) * (S + 1);
  int* flag = ticket + 1;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int s = bwd ? S - 1 - s_ticket : s_ticket;
  const int r0 = s * W, ns = min(W, n - r0);
  const T* R = gR + (size_t)m * n * n;
  T* x = gx + (size_t)m * n * k + c;  // entry l at x[l k]
  // this thread's entry: w (forward, from b) or y (backward, from x)
  T v = T(0);
  if (tid < ns)
    v = bwd ? x[(size_t)(r0 + tid) * k]
            : gb[(size_t)m * n * k + (size_t)(r0 + tid) * k + c];
  // the tiles in the order of use, then the diagonal block (item nt)
  const int nt = bwd ? S - 1 - s : s;
  auto issue = [&](int it) {
    T* dst = tiles + (it % NBUF) * W * LD;
    int row0 = r0, nrows = ns, col0 = r0, ncols = ns;
    if (it < nt) {
      const int p = bwd ? S - 1 - it : it, pw = min(W, n - p * W);
      if (bwd) {
        col0 = p * W;
        ncols = pw;
      } else {
        row0 = p * W;
        nrows = pw;
      }
    }
    for (int rr = 0; rr < W; ++rr) {
      const bool ok = rr < nrows && tid < ncols;
      cp_elem(dst + rr * LD + tid,
              ok ? R + (size_t)(row0 + rr) * n + col0 + tid : R, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  issue(0);
  for (int it = 0;; ++it) {
    const bool ahead = NBUF == 2 && it < nt;
    if (ahead) issue(it + 1);
    if (it < nt) {
      const int p = bwd ? S - 1 - it : it, pw = min(W, n - p * W);
      if (tid == 0)
        while (ld_acquire(flag + p) == 0) {
        }
      __syncthreads();
      ys[tid] = tid < pw ? __ldcg(x + (size_t)(p * W + tid) * k) : T(0);
    }
    if (ahead)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (it == nt) break;
    const T* tl = tiles + (it % NBUF) * W * LD;
    if (bwd) {
#pragma unroll
      for (int kk = W - 1; kk >= 0; --kk) v = v - tl[tid * LD + kk] * ys[kk];
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) v = v - ys[j] * tl[j * LD + tid];
    }
    __syncthreads();
    if (NBUF == 1) issue(it + 1);
  }
  ys[tid] = v;
  __syncthreads();
  if (tid >= 32) return;
  // the diagonal block, lane t owning entries t, t + 32, ... of the stripe
  const int lane = tid;
  const T* D = tiles + (nt % NBUF) * W * LD;
  T e[E];
#pragma unroll
  for (int i = 0; i < E; ++i) e[i] = ys[lane + 32 * i];
  if (!bwd) {
    // y_j = w_j / D_jj, then w_l -= y_j D_jl for l > j; u = w_j
    T u = __shfl_sync(QP_FULL_MASK, e[0], 0);
#pragma unroll
    for (int i0 = 0; i0 < E; ++i0) {
      for (int jj = 0; jj < 32; ++jj) {
        const int j = 32 * i0 + jj;
        if (j >= ns) break;
        const T wn = __shfl_sync(
            QP_FULL_MASK, jj < 31 ? e[i0] : e[i0 + 1 < E ? i0 + 1 : i0],
            (j + 1) & 31);
        const T djj = D[j * LD + j], dn = j + 1 < ns ? D[j * LD + j + 1] : T(0);
        const T yj = div_rn(u, djj);
        u = wn - yj * dn;  // w_{j+1}, as its owner forms it below
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int l = lane + 32 * i;
          if (l > j && l < ns) e[i] = e[i] - yj * D[j * LD + l];
          if (l == j) e[i] = yj;
        }
      }
    }
  } else {
    // x_l = y_l / D_ll, then y_r -= D_rl x_l for r < l; u = y_l
    T u = T(0);
#pragma unroll
    for (int i0 = E - 1; i0 >= 0; --i0) {
      for (int jj = 31; jj >= 0; --jj) {
        const int l = 32 * i0 + jj;
        if (l >= ns) continue;
        if (l == ns - 1) u = __shfl_sync(QP_FULL_MASK, e[i0], jj);
        const T yp = __shfl_sync(
            QP_FULL_MASK, jj > 0 ? e[i0] : e[i0 > 0 ? i0 - 1 : 0],
            (l - 1) & 31);
        const T dll = D[l * LD + l], dp = l > 0 ? D[(l - 1) * LD + l] : T(0);
        const T xl = div_rn(u, dll);
        u = yp - dp * xl;  // y_{l-1}, as its owner forms it below
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int r = lane + 32 * i;
          if (r < l) e[i] = e[i] - D[r * LD + l] * xl;
          if (r == l) e[i] = xl;
        }
      }
    }
  }
  // publish the stripe's values, then its flag
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int l = lane + 32 * i;
    if (l < ns) x[(size_t)(r0 + l) * k] = e[i];
  }
  __threadfence();
  __syncwarp();
  if (lane == 0) st_release(flag + s, 1);
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

template <typename T, bool PROF>
int launch_cluster(const T* M, T* R, int B, int n, int C, int b,
                   cudaStream_t s, long long* prof) {
  const int smem = (int)cluster_smem_bytes(n, sizeof(T), b);
  auto kern = chol_cluster_kernel<T, PROF>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)C);
  cfg.blockDim = dim3(CLUSTER_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, M, R, n, b, prof);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves nothing to report later
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// b rows a panel must fit a CTA's shared memory
template <typename T>
int launch_global(const T* M, T* R, int B, int n, int C, int b,
                  void* stream, long long* prof) {
  if (C < 1 || C > CLUSTER_MAX || b < CTILE || b % CTILE ||
      cluster_smem_bytes(n, sizeof(T), b) > 232448)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return prof ? launch_cluster<T, true>(M, R, B, n, C, b, s, prof)
              : launch_cluster<T, false>(M, R, B, n, C, b, s, nullptr);
}

template <typename T, int E>
int launch_gs(const T* R, const T* b, T* x, int B, int n, int k, int nt,
              cudaStream_t s) {
  const int smem = (int)(2 * (size_t)n * sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      chol_solve_global_kernel<T, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  chol_solve_global_kernel<T, E><<<dim3(B, k), nt, smem, s>>>(R, b, x, n, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve_global(const T* R, const T* b, T* x, int B, int n, int k,
                        int nt, int E, void* stream) {
  if (B == 0 || n == 0 || k == 0) return 0;
  if (nt < 32 || nt > GS_THREADS_MAX || nt % 32 || (long long)nt * E < n ||
      (E * (int)sizeof(T) > GS_ENTRY_BYTES && nt != GS_THREADS_MAX))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (E) {
    case 1: return launch_gs<T, 1>(R, b, x, B, n, k, nt, s);
    case 2: return launch_gs<T, 2>(R, b, x, B, n, k, nt, s);
    case 4: return launch_gs<T, 4>(R, b, x, B, n, k, nt, s);
    case 8: return launch_gs<T, 8>(R, b, x, B, n, k, nt, s);
    case 16: return launch_gs<T, 16>(R, b, x, B, n, k, nt, s);
    case GS_E_MAX: return launch_gs<T, GS_E_MAX>(R, b, x, B, n, k, nt, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int W>
int launch_stripe_w(const T* R, const T* b, T* x, int B, int n, int k,
                    int* sync, cudaStream_t s) {
  const int S = (n + W - 1) / W, smem = stripe_smem_bytes<T, W>();
  auto kern = chol_solve_stripe_kernel<T, W>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  for (int bwd = 0; bwd < 2; ++bwd) {
    kern<<<dim3(S, k, B), W, smem, s>>>(R, b, x, n, k, bwd, sync);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
int launch_solve_stripe(const T* R, const T* b, T* x, int B, int n, int k,
                        int w, int* sync, void* stream) {
  if (B == 0 || n == 0 || k == 0) return 0;
  if (B > 65535 || k > 65535 || !sync) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (w) {
    case 32: return launch_stripe_w<T, 32>(R, b, x, B, n, k, sync, s);
    case 64: return launch_stripe_w<T, 64>(R, b, x, B, n, k, sync, s);
    case 128: return launch_stripe_w<T, 128>(R, b, x, B, n, k, sync, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int BR, bool PROF>
int launch_grid_b(const T* M, T* R, int B, int n, int ctas, cudaStream_t s,
                  long long* prof) {
  const int groups = B < ctas ? B : ctas, per = ctas / groups;
  const int smem = grid_smem_bytes<T, BR>();
  auto kern = chol_grid_kernel<T, BR, PROF>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&M, (void*)&R, (void*)&B, (void*)&n, (void*)&per,
                  (void*)&prof};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(groups * per),
                                  dim3(GRID_THREADS), args, smem, s);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves nothing to report later
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// ctas CTAs in all (one an SM; the card refuses more than it keeps
// resident), panels of b rows (GRID_BS in linalg/chol.py)
template <typename T>
int launch_grid(const T* M, T* R, int B, int n, int ctas, int b,
                void* stream, long long* prof) {
  if (ctas < 1 || (b != 32 && b != 64)) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (b == 32)
    return prof ? launch_grid_b<T, 32, true>(M, R, B, n, ctas, s, prof)
                : launch_grid_b<T, 32, false>(M, R, B, n, ctas, s, nullptr);
  return prof ? launch_grid_b<T, 64, true>(M, R, B, n, ctas, s, prof)
              : launch_grid_b<T, 64, false>(M, R, B, n, ctas, s, nullptr);
}

}  // namespace

// Every entry point takes the element type as a flag: f64 picks double.
extern "C" int qp_chol(const void* M, void* R, int B, int n, int f64,
                       void* stream) {
  return f64 ? launch_chol((const double*)M, (double*)R, B, n, stream)
             : launch_chol((const float*)M, (float*)R, B, n, stream);
}

// the global-memory plan: a cluster of `cluster` CTAs a matrix, panels of
// b rows in shared memory, the trailing triangle in R; prof (8 B cluster
// int64s, or null) takes the cycle counters of the profiled instantiation
extern "C" int qp_chol_global(const void* M, void* R, int B, int n, int f64,
                              int cluster, int b, void* prof, void* stream) {
  long long* pr = (long long*)prof;
  return f64 ? launch_global((const double*)M, (double*)R, B, n, cluster, b,
                             stream, pr)
             : launch_global((const float*)M, (float*)R, B, n, cluster, b,
                             stream, pr);
}

// the global-memory solve: threads a block and entries a thread as
// linalg/chol.py:global_solve_shape picks them
extern "C" int qp_chol_solve_global(const void* R, const void* b, void* x,
                                    int B, int n, int k, int threads,
                                    int entries, int f64, void* stream) {
  return f64 ? launch_solve_global((const double*)R, (const double*)b,
                                   (double*)x, B, n, k, threads, entries,
                                   stream)
             : launch_solve_global((const float*)R, (const float*)b,
                                   (float*)x, B, n, k, threads, entries,
                                   stream);
}

// the grid factor: ctas CTAs shared out over the B matrices, panels of b
// rows; prof (8 ctas int64s, or null) takes the cycle counters of the
// profiled instantiation
extern "C" int qp_chol_grid(const void* M, void* R, int B, int n, int f64,
                            int ctas, int b, void* prof, void* stream) {
  long long* pr = (long long*)prof;
  return f64 ? launch_grid((const double*)M, (double*)R, B, n, ctas, b,
                           stream, pr)
             : launch_grid((const float*)M, (float*)R, B, n, ctas, b, stream,
                           pr);
}

// the stripe solve, stripes of w entries (32, 64 or 128); sync: 2 B k
// (ceil(n / w) + 1) zeroed ints; x must not overlap b
extern "C" int qp_chol_solve_stripe(const void* R, const void* b, void* x,
                                    int B, int n, int k, int w, void* sync,
                                    int f64, void* stream) {
  return f64 ? launch_solve_stripe((const double*)R, (const double*)b,
                                   (double*)x, B, n, k, w, (int*)sync, stream)
             : launch_solve_stripe((const float*)R, (const float*)b,
                                   (float*)x, B, n, k, w, (int*)sync, stream);
}

// The shared-memory solve, `cols` right-hand sides per block.  kind 1:
// the blocked kernel (f32, n a multiple of PANEL, cols 32 or 64, R 16-byte
// aligned); kind 2: a warp a column, `cols` warps a block (f64, n <= 32
// WARP_E, any k, cols a power of two up to WARP_W_MAX, R 16-byte aligned
// where n is a multiple of 4); kind 0: the entry-by-entry kernel with
// cols <= 64 (f32 off the blocked kernel's n; at f64 no plan takes it).
// A shape a kind cannot take returns cudaErrorInvalidValue.
extern "C" int qp_chol_solve(const void* R, const void* b, void* x, int B,
                             int n, int k, int cols, int kind, int f64,
                             void* stream) {
  if (B == 0 || n == 0 || k == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64) {
    if (kind == 2) {
      // W = cols warps a block, a power of two up to WARP_W_MAX; row
      // copies (n a multiple of 4) need R 16-byte aligned
      const int W = cols;
      if (n > 32 * WARP_E || W < 1 || W > WARP_W_MAX || (W & (W - 1)) ||
          (k + W - 1) / W > 65535 || ((uintptr_t)R & 7) ||
          (n % 4 == 0 && ((uintptr_t)R & 15)))
        return (int)cudaErrorInvalidValue;
      const double *Rd = (const double*)R, *bd = (const double*)b;
      double* xd = (double*)x;
      switch ((n + 31) / 32) {
        case 1: return launch_solve_warp<1>(Rd, bd, xd, B, n, k, W, s);
        case 2: return launch_solve_warp<2>(Rd, bd, xd, B, n, k, W, s);
        case 3: return launch_solve_warp<3>(Rd, bd, xd, B, n, k, W, s);
        case 4: return launch_solve_warp<4>(Rd, bd, xd, B, n, k, W, s);
        case 5: return launch_solve_warp<5>(Rd, bd, xd, B, n, k, W, s);
        default: return launch_solve_warp<6>(Rd, bd, xd, B, n, k, W, s);
      }
    }
    if (kind) return (int)cudaErrorInvalidValue;
    return launch_chol_solve_entry((const double*)R, (const double*)b,
                                   (double*)x, B, n, k, cols, s);
  }
  const float *Rf = (const float*)R, *bf = (const float*)b;
  float* xf = (float*)x;
  if (kind == 1) {
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
  if (kind) return (int)cudaErrorInvalidValue;
  return launch_chol_solve_entry(Rf, bf, xf, B, n, k, cols, s);
}
