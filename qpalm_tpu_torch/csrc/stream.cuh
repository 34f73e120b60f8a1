// Device code of K1's streaming tier (fused_palm.cu, template STREAM) and of
// the assembly probe (probe_stream.cu): the Schur assembly of the upper
// triangle with A staged through shared memory by bulk asynchronous copies,
// the Gershgorin bound of its symmetric completion, a blocked right-looking
// Cholesky of a matrix in global memory, and the two triangular solves with
// the factor's rows staged through shared memory.
//
// What bounded the plan these replace (schur_tiles, chol_upper_inplace and
// chol_solve_warp on a global M): every 4x4 tile pass re-read all of A from
// L2 with per-thread loads, both triangles were formed, each of the
// Cholesky's n rank-1 steps read and wrote the whole trailing triangle
// through L2, and each of the solves' 2n dependent steps waited on L2.
// Here:
//  - A comes in row panels of P rows (P n 4 contiguous bytes), one
//    cp.async.bulk per panel that completes on an mbarrier, double-buffered
//    so panel k+1 is in flight while panel k is consumed; the counterpart of
//    the reference's double-buffered DMA sweep (qpalm_tpu/solver/fused.py
//    :220-248);
//  - each thread holds an 8x8 tile of M's upper triangle in registers, so a
//    pass over A serves 256 tiles and M is written once;
//  - the Cholesky factors b rows at a time in shared memory and then
//    updates the trailing upper triangle tile by tile: each entry is loaded
//    once per panel, gets the panel's b products subtracted in order, and is
//    stored once;
//  - the solves' warp reads R from row panels brought in the same way.
// Every entry keeps the arithmetic of the plain order (products and sums
// rounded separately, the kernels build with --fmad=false): the assembly
// sums (w_i A_ij) A_ik over i = 0..m-1 from 0, the Cholesky subtracts
// r_kj r_kl in k order, the solves are chol_solve_warp's, so all are
// bit-identical to schur_tiles' upper triangle, to chol_upper_inplace and
// to chol_solve_warp.  M's lower triangle is never read.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace stream {

constexpr int TILE = 8;  // register tile of M, TILE x TILE entries a thread

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: two mbarriers, each expecting one arrival (the thread that
// starts a copy) plus the copy's bytes.  The threads that wait on them then
// run proxy_fence_shared() and synchronise before the first copy.
static __device__ __forceinline__ void bars_init(uint64_t* bars) {
  for (int k = 0; k < 2; ++k)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(bars + k))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The staging memory was written by ordinary stores before: order them
// before the copies' writes.
static __device__ __forceinline__ void proxy_fence_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One thread, after the last wait on them (and a barrier after it), before
// their memory serves anything else.
static __device__ __forceinline__ void bars_inval(uint64_t* bars) {
  for (int k = 0; k < 2; ++k)
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(
                     smem_addr(bars + k))
                 : "memory");
}

// One thread: copy `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global src to shared dst, completing on bar.
static __device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                                 uint32_t bytes,
                                                 uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

static __device__ __forceinline__ void bar_wait(uint64_t* bar,
                                                uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Tile t of the upper triangle of an nb x nb grid of tiles, row by row:
// (tile row, tile column) with column >= row.
static __device__ __forceinline__ void upper_tile(int t, int nb, int& tr,
                                                  int& tc) {
  tr = 0;
  while (t >= nb - tr) {
    t -= nb - tr;
    ++tr;
  }
  tc = tr + t;
}

// Global tile I/O: rows r0.., columns c0.. of an n x n row-major matrix;
// rw, cw are 4 or 8 (n is a multiple of 4 and tiles start at multiples of
// 4).  Entries outside stay as they are (loads) or are not written.
static __device__ __forceinline__ void tile_load(float (&acc)[TILE][TILE],
                                                 const float* M, int n,
                                                 int r0, int c0, int rw,
                                                 int cw) {
#pragma unroll
  for (int x = 0; x < TILE; ++x) {
    float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
    if (x < rw) {
      const float* row = M + (size_t)(r0 + x) * n + c0;
      lo = *reinterpret_cast<const float4*>(row);
      if (cw > 4) hi = *reinterpret_cast<const float4*>(row + 4);
    }
    acc[x][0] = lo.x; acc[x][1] = lo.y; acc[x][2] = lo.z; acc[x][3] = lo.w;
    acc[x][4] = hi.x; acc[x][5] = hi.y; acc[x][6] = hi.z; acc[x][7] = hi.w;
  }
}

static __device__ __forceinline__ void tile_store(
    const float (&acc)[TILE][TILE], float* M, int n, int r0, int c0, int rw,
    int cw) {
#pragma unroll
  for (int x = 0; x < TILE; ++x) {
    if (x < rw) {
      float* row = M + (size_t)(r0 + x) * n + c0;
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
      if (cw > 4)
        *reinterpret_cast<float4*>(row + 4) =
            make_float4(acc[x][4], acc[x][5], acc[x][6], acc[x][7]);
    }
  }
}

// 8 consecutive floats of shared memory (16-byte aligned)
static __device__ __forceinline__ void load8(float (&v)[TILE],
                                             const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Upper triangle of M = A' diag(w) A into global M (n x n row-major, n a
// multiple of 4; the 8x8 tiles on the diagonal are written whole, the rest
// of the lower triangle is not touched).  A (m x n) is in global memory,
// 16-byte aligned; w (m) in shared memory.  stage holds 2 P n + 4 floats of
// shared memory (16-byte aligned; the 4 absorb the reads of a 4-wide edge
// tile past its row), bars two 8-byte-aligned mbarrier slots.  Entry (j, k)
// is the sum over i = 0..m-1, in order from 0, of (w_i A_ij) A_ik.  Every
// thread of the block calls it; the caller synchronises after.
static __device__ void schur_stream(float* M, const float* A, const float* w,
                                    float* stage, uint64_t* bars, int n,
                                    int m, int P) {
  const int nb = (n + TILE - 1) / TILE;
  const int ntiles = nb * (nb + 1) / 2;
  const int npan = (m + P - 1) / P;
  uint32_t phases = 0u;  // bit s: the parity buffer s waits for next
  __syncthreads();  // stage may overlap scratch a reduction just read
  if (threadIdx.x == 0) bars_init(bars);
  proxy_fence_shared();
  __syncthreads();
  for (int base = 0; base < ntiles; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const bool active = t < ntiles;
    int tr = 0, tc = 0;
    if (active) upper_tile(t, nb, tr, tc);
    const int r0 = tr * TILE, c0 = tc * TILE;
    float acc[TILE][TILE];
#pragma unroll
    for (int x = 0; x < TILE; ++x)
#pragma unroll
      for (int y = 0; y < TILE; ++y) acc[x][y] = 0.0f;
    if (threadIdx.x == 0)
      for (int k = 0; k < 2 && k < npan; ++k)
        bulk_load(stage + (size_t)k * P * n, A + (size_t)k * P * n,
                  (uint32_t)(min(P, m - k * P) * n * sizeof(float)),
                  bars + k);
    for (int k = 0; k < npan; ++k) {
      const int s = k & 1;
      float* pan = stage + (size_t)s * P * n;
      bar_wait(bars + s, (phases >> s) & 1u);
      phases ^= 1u << s;
      const int rows = min(P, m - k * P);
      if (active) {
        const float* wk = w + k * P;
        for (int i = 0; i < rows; ++i) {
          float ar[TILE], ac[TILE];
          load8(ar, pan + i * n + r0);
          load8(ac, pan + i * n + c0);
          const float wi = wk[i];
#pragma unroll
          for (int x = 0; x < TILE; ++x) {
            const float wa = wi * ar[x];
#pragma unroll
            for (int y = 0; y < TILE; ++y) acc[x][y] += wa * ac[y];
          }
        }
      }
      __syncthreads();  // buffer s is free again
      if (threadIdx.x == 0 && k + 2 < npan)
        bulk_load(pan, A + (size_t)(k + 2) * P * n,
                  (uint32_t)(min(P, m - (k + 2) * P) * n * sizeof(float)),
                  bars + s);
    }
    if (active)
      tile_store(acc, M, n, r0, c0, min(TILE, n - r0), min(TILE, n - c0));
  }
  if (threadIdx.x == 0) bars_inval(bars);
}

// Gershgorin bound of the symmetric completion of M's upper triangle, row by
// row: g_j = sum_{k<j} |M[k][j]| (thread j, k in order) + sum_{k>=j}
// |M[j][k]| (a warp, lane-strided and butterflied as warp_sum).  Into the
// same pass: M[j][k] += Q[j][k] on the upper triangle and M[j][j] += ginv.
// colsum is n floats of shared scratch.  Returns the block's largest g_j
// (NaN-propagating), reduced by the caller; this is the per-thread part.
// Every thread calls it; it synchronises inside, the caller after.
static __device__ __forceinline__ float gershgorin_add_q(float* M,
                                                         const float* Q,
                                                         float ginv,
                                                         float* colsum,
                                                         int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < j; ++k) s += fabsf(M[(size_t)k * n + j]);
    colsum[j] = s;
  }
  __syncthreads();  // the column sums read M before Q is added
  float g = 0.0f;
  for (int j = warp; j < n; j += nw) {
    float s = 0.0f;
    float* row = M + (size_t)j * n;
    for (int k = j + lane; k < n; k += 32) {
      const float awa = row[k];
      s += fabsf(awa);
      row[k] = awa + Q[(size_t)j * n + k];
    }
    // the lanes' partial sums are those of k = lane, lane + 32, ... with
    // the entries left of the diagonal read as 0: lane (k - j) % 32 here
    // holds what lane k % 32 would, so rotate them back before the
    // butterfly
    s = __shfl_sync(QP_FULL_MASK, s, (lane - j) & 31);
    g = nmax(g, colsum[j] + warp_sum(s));
    if (lane == 0) row[j] += ginv;
  }
  return g;
}

// Upper Cholesky factor of the n x n row-major SPD matrix M in global
// memory, in place, right-looking in panels of b rows (b a multiple of 4,
// n of 4): a panel's rows, which carry every earlier update, come into the
// shared pan (b n + 4 floats, 16-byte aligned) and factor there row by row,
// left-looking; they go back to M, and the trailing upper
// triangle is updated in 8x8 tiles, each entry loaded once, the panel's b
// products subtracted in order, stored once.  The result's upper triangle
// is bit-identical to chol_upper_inplace's; the lower triangle is left
// as it was (nothing reads it).  Every thread of the block calls it; it
// synchronises before it returns.  With `prof` (thread 0 of a profiled
// launch) it adds its cycles in the panels (load, factor, write back) and
// in the trailing updates to t_panel and t_trail.
static __device__ void chol_blocked(float* M, float* pan, int n, int b,
                                    bool prof, long long& t_panel,
                                    long long& t_trail) {
  const int tid = threadIdx.x, nt = blockDim.x;
  __syncthreads();  // pan may overlap scratch a reduction just read
  long long tick = prof ? clock64() : 0;
  for (int p = 0; p < n; p += b) {
    const int bb = min(b, n - p), w4 = (n - p) >> 2;
    // the panel, columns p..n-1
    for (int e = tid; e < bb * w4; e += nt) {
      const int r = e / w4, c = p + 4 * (e - r * w4);
      *reinterpret_cast<float4*>(pan + r * n + c) =
          *reinterpret_cast<const float4*>(M + (size_t)(p + r) * n + c);
    }
    __syncthreads();
    // row k of the panel, left-looking: each entry gets the products of
    // the panel's earlier rows subtracted in row order (the order in which
    // the rank-1 steps would subtract them), then is scaled; every thread
    // forms the diagonal itself, so one barrier a row
    for (int k = 0; k < bb; ++k) {
      const int c = p + k;
      // the diagonal and this thread's first two columns in one loop, so
      // their chains of subtractions overlap
      const int l0 = c + 1 + tid, l1 = l0 + nt;
      float akk = pan[k * n + c];
      float a0 = l0 < n ? pan[k * n + l0] : 0.0f;
      float a1 = l1 < n ? pan[k * n + l1] : 0.0f;
#pragma unroll 4
      for (int i = 0; i < k; ++i) {
        const float ri = pan[i * n + c];
        akk -= ri * ri;
        if (l0 < n) a0 -= ri * pan[i * n + l0];
        if (l1 < n) a1 -= ri * pan[i * n + l1];
      }
      const float inv = 1.0f / sqrtf(akk);  // not rsqrtf: that is approximate
      if (l0 < n) pan[k * n + l0] = a0 * inv;
      if (l1 < n) pan[k * n + l1] = a1 * inv;
      for (int l = l1 + nt; l < n; l += nt) {
        float acc = pan[k * n + l];
        for (int i = 0; i < k; ++i) acc -= pan[i * n + c] * pan[i * n + l];
        pan[k * n + l] = acc * inv;
      }
      if (tid == 0) pan[k * n + c] = akk * inv;
      __syncthreads();
    }
    // the factored rows back to M
    for (int e = tid; e < bb * w4; e += nt) {
      const int r = e / w4, c = p + 4 * (e - r * w4);
      *reinterpret_cast<float4*>(M + (size_t)(p + r) * n + c) =
          *reinterpret_cast<const float4*>(pan + r * n + c);
    }
    if (prof) {
      const long long now = clock64();
      t_panel += now - tick;
      tick = now;
    }
    // the trailing upper triangle, rows and columns t0..n-1
    const int t0 = p + bb;
    const int nb = (n - t0 + TILE - 1) / TILE;
    const int ntiles = nb * (nb + 1) / 2;
    for (int t = tid; t < ntiles; t += nt) {
      int tr, tc;
      upper_tile(t, nb, tr, tc);
      const int r0 = t0 + tr * TILE, c0 = t0 + tc * TILE;
      const int rw = min(TILE, n - r0), cw = min(TILE, n - c0);
      float acc[TILE][TILE];
      tile_load(acc, M, n, r0, c0, rw, cw);
      for (int r = 0; r < bb; ++r) {
        float a[TILE], cv[TILE];
        load8(a, pan + r * n + r0);
        load8(cv, pan + r * n + c0);
#pragma unroll
        for (int x = 0; x < TILE; ++x)
#pragma unroll
          for (int y = 0; y < TILE; ++y) acc[x][y] -= a[x] * cv[y];
      }
      tile_store(acc, M, n, r0, c0, rw, cw);
    }
    // after the last stores to M, before bulk copies (solve_stream) read it
    if (t0 >= n) asm volatile("fence.proxy.async;\n" ::: "memory");
    __syncthreads();
    if (prof) {
      const long long now = clock64();
      t_trail += now - tick;
      tick = now;
    }
  }
}

// R'z = d then R x = d with the upper factor R (n x n row-major, global,
// 16-byte aligned, n a multiple of 4), in warp 0 only, exactly as
// fused_palm.cu's chol_solve_warp computes it, but with R's rows staged
// through shared memory: row panels of P rows (contiguous, P n 4 bytes)
// come in by bulk asynchronous copies, double-buffered, in row order for
// the forward pass and in reverse for the backward one, so each of the 2n
// dependent steps reads shared memory instead of waiting on L2.  stage and
// bars as for schur_stream; x overwrites d, z goes to zf.  The caller
// synchronises after.
static __device__ void solve_stream(const float* R, float* d, float* zf,
                                    float* stage, uint64_t* bars, int n,
                                    int P) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int npan = (n + P - 1) / P;
  if (lane == 0) bars_init(bars);
  proxy_fence_shared();
  __syncwarp();
  uint32_t phases = 0u;
  // panel q of the rows, into buffer s
  auto fetch = [&](int q, int s) {
    bulk_load(stage + (size_t)s * P * n, R + (size_t)q * P * n,
              (uint32_t)(min(P, n - q * P) * n * sizeof(float)), bars + s);
  };
  auto wait = [&](int s) {
    bar_wait(bars + s, (phases >> s) & 1u);
    phases ^= 1u << s;
    return stage + (size_t)s * P * n;
  };
  if (lane == 0)
    for (int t = 0; t < 2 && t < npan; ++t) fetch(t, t);
  for (int q = 0; q < npan; ++q) {
    const float* pan = wait(q & 1);
    const int rows = min(P, n - q * P);
    for (int jj = 0; jj < rows; ++jj) {
      const int j = q * P + jj;
      const float* row = pan + jj * n;
      const float bj = d[j] / row[j];
      for (int l = j + 1 + lane; l < n; l += 32) d[l] -= bj * row[l];
      if (lane == 0) zf[j] = bj;
      __syncwarp();
    }
    if (lane == 0 && q + 2 < npan) fetch(q + 2, q & 1);
  }
  if (lane == 0)
    for (int t = 0; t < 2 && t < npan; ++t) fetch(npan - 1 - t, t);
  for (int t = 0; t < npan; ++t) {
    const int q = npan - 1 - t;
    const float* pan = wait(t & 1);
    for (int jj = min(P, n - q * P) - 1; jj >= 0; --jj) {
      const int k = q * P + jj;
      const float* row = pan + jj * n;
      float s = 0.0f;
      for (int l = k + 1 + lane; l < n; l += 32) s += row[l] * d[l];
      s = warp_sum(s);
      if (lane == 0) d[k] = (zf[k] - s) / row[k];
      __syncwarp();
    }
    if (lane == 0 && t + 2 < npan) fetch(npan - 1 - (t + 2), t & 1);
  }
  if (lane == 0) bars_inval(bars);
}

}  // namespace stream
