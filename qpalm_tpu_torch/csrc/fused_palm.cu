// Kernel K1: T whole P-ALM iterations of a batch of dense QPs in one launch,
// f32, in two memory tiers.
//
// Replaces the Pallas kernel of qpalm_tpu/solver/fused.py (`_make_kernel`'s
// inner `kernel`, launched per 128-lane block by `fused_chunk`) in both of
// its memory tiers, all on chip (qa_panel = 0) and streaming (qa_panel > 0,
// fused.py:217-284, 390-425, 443-454): residuals and termination norms, both
// infeasibility certificates, sigma / y / inner-tolerance updates,
// dual-objective termination (a Cholesky of Q on outer trips), the gamma
// step or boost (convex) or the eps_k ladder under per-problem gamma pins
// (nonconvex), Schur assembly M = Q + A'diag(w)A + I/g with its Gershgorin
// bound,
// Cholesky and two triangular solves, Qd and Ad, the 26-step
// Newton/bisection linesearch, and the masked state writes.  It computes
// what fused.py:538-906 computes; the plain twin is
// qpalm_tpu_torch/solver/fused.py:fused_palm_plain.  Every per-problem value
// that lives across iterations is in nst, mst or sc, so T-iteration launches
// in a row (host chunking) resume exactly.
//
// Design.  The TPU kernel put one problem in each of 128 vector lanes.  Here
// one block of 256 threads owns one problem, batch first: Q, A, the Schur
// matrix M and the ~37 state and scratch vectors sit in dynamic shared
// memory (69 KB at n=64, m=96; three blocks per SM), loaded once and written
// back once.  A block leaves its loop as soon as its own problem is done,
// which changes no problem's iteration count.  Every per-problem scalar is
// computed redundantly by all threads from the same reductions, so control
// flow is uniform within a block.
//
// What bounds it on an H100: not bandwidth (each problem's 40 KB of data is
// read once for ~100 iterations) and not f32 throughput (~1 MFLOP per
// iteration), but the chain of dependent steps of one iteration, which its
// cycle counters split (fused_palm.profile): the Cholesky's n rows, the
// solves' 2n steps, the linesearch's 28 reductions, and a dozen more.
// Reductions carry several values per barrier and double-buffer their
// scratch, so each costs one barrier, and the linesearch carries each
// proposal's hinge sums into the next step instead of summing them again;
// the Cholesky is left-looking, one barrier a row, each entry's
// subtractions a chain in one thread's registers (common.cuh); the
// triangular solves run in one warp without block barriers, each step's
// newest value in a register; the Schur assembly (the only O(n^2 m) step)
// uses 4x4 register tiles over float4 shared loads.  At three blocks per
// SM the kernel has 80 registers a thread: designs that hold more live
// values (a one-warp linesearch, register-resident solves, batched loads
// in the Cholesky) spill and run slower (their times are in PERF.md).

// The streaming tier (template STREAM) takes the shapes whose on-chip plan
// exceeds a block's 227 KB: the Schur matrix alone is n^2 x 4 B, 496 KB at
// n=352.  Q and A stay in global memory, M lives in a per-problem global
// scratch that the wrapper allocates, and the vectors, the reduction scratch
// and a staging region sit in shared memory (stream_plan; 92 KB at n = m =
// 352).  The staging region holds, in turn, two row panels of A brought in
// by bulk asynchronous copies for the Schur assembly, a panel of M's rows
// for the blocked Cholesky, and two row panels of the factor for the
// triangular solves (stream.cuh); it overlaps the vectors and the reduction
// scratch that are dead while those run.  Only M's upper triangle is
// formed.  The tier follows the reference's streaming assembly order, not
// the on-chip one: the tiles start at 0, Gershgorin reads |A'WA| (here the
// symmetric completion of its upper triangle), then M += Q, then the
// diagonal += 1/gamma; the two orders round differently.  Per iteration it
// reads A once per 256 upper 8x8 tiles of M (4 times at n=352) and M's
// trailing triangle once per Cholesky panel; it is bound by the FP32
// instruction rate in the assembly and by chains of dependent steps in the
// Cholesky panels and the solves.

// Numerics.  No fast math.  Reductions are warp butterflies plus a fixed
// combine of the warp partials, never atomics, so reruns are bit-identical.
// 1/sqrtf replaces rsqrt (rsqrtf is approximate).  Products with FLT_MIN in
// the linesearch are flushed to zero as the reference (TPU, XLA) does, and
// the bisection's sign test is one fused multiply-add.  Masked updates are
// branches on uniform flags, never multiplications by a 0/1 mask, so a NaN
// on a masked-off path cannot reach the state.  Padded rows keep their
// +-1e21 bounds, finite in f32 like QPALM_INFTY = 1e20.

#include <string.h>

#include <algorithm>

#include "common.cuh"
#include "stream.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int RED_K = 12;  // most values one block reduction carries
constexpr float INFTY = 1e20f;
constexpr int SMEM_LIMIT = 232448;  // bytes one block may use on Hopper
// the streaming tier's panels: A's rows per staging panel, M's rows per
// Cholesky panel (a multiple of 8), each at most, and b at least
constexpr int STREAM_P_MAX = 16, STREAM_B_MAX = 32, STREAM_B_MIN = 8;
// a profiled launch's cycle counters, the whole loop last.  Streaming:
// assembly, Gershgorin + Q, Cholesky panels, Cholesky trailing updates,
// solves.  On chip: assembly, Gershgorin + I/gamma, Cholesky, solves, Qd
// and Ad with the breakpoints, linesearch.  solver/fused.py names them.
constexpr int PROF_STREAM = 6, PROF_SMEM = 7;

// The streaming tier's shared memory, in floats: the 18 n- and 19 m-vectors
// and the reduction scratch as on chip, and the staging region at offset
// `stage` (after the 15th m-vector, 16-byte aligned): two mbarriers (4
// floats), max(2 P n, b n) floats of panels (A's for the assembly, M's for
// the Cholesky, the factor's for the solves) and 4 floats that absorb the
// reads of a 4-wide edge tile.  The staging region overlaps the last four
// m-vectors (Ad, sad, alo, ahi) and the reduction scratch, all dead while
// the assembly and the Cholesky run.  P and b take what the vectors leave
// under SMEM_LIMIT, at least 1 and STREAM_B_MIN; `floats` over SMEM_LIMIT / 4
// means no plan.  solver/fused.py:stream_plan mirrors it.
struct StreamPlan {
  int P, b, stage, floats;
};

StreamPlan stream_plan(int n, int m) {
  StreamPlan p;
  p.stage = (18 * n + 15 * m + 3) & ~3;
  const int avail = SMEM_LIMIT / 4 - p.stage - 8;
  p.P = std::max(1, std::min(STREAM_P_MAX, avail / (2 * n)));
  p.b = std::max(STREAM_B_MIN, std::min(STREAM_B_MAX, avail / n / 8 * 8));
  const int vec = 18 * n + 19 * m + 2 * RED_K * NWARP;
  p.floats = std::max(vec, p.stage + 8 + std::max(2 * p.P * n, p.b * n));
  return p;
}

// scalar-state rows (qpalm_tpu/solver/fused.py:68-70)
enum {
  GAMMA, EPSA_IN, EPSR_IN, DONE, ITER, PREV_ITER, NO_CHANGE, GAMMA_MAXED,
  ITER_OUT, GERSH, NB_CHANGED, PRI_NORM, DUA_NORM, STATUS, GAMMA_MAX,
  EPSK_ABS, EPSK_REL, COBJ, SC_ROWS
};
static_assert(SC_ROWS == 18, "the reference's sc has 18 rows");

struct FSet {  // the order of solver/fused.py:_float_settings
  float eps_abs, eps_rel, eps_pinf, eps_dinf, rho, theta, delta, sigma_max,
      gamma_upd, e2, dual_limit;
};

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < FLT_MIN ? 0.0f : v;
}

// Reduce K per-thread values over the block at once: bit k of max_mask
// picks a NaN-propagating max, else a sum.  Every thread gets the results.
// The two scratch halves alternate, so one barrier per call is enough.
template <int K>
__device__ __forceinline__ void block_reduce(float (&v)[K], unsigned max_mask,
                                             float* red, int& parity) {
  static_assert(K <= RED_K, "too many values for one reduction");
  float* buf = red + parity * (RED_K * NWARP);
  parity ^= 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool mx = (max_mask >> k) & 1u;
    float a = v[k];
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float b = __shfl_xor_sync(QP_FULL_MASK, a, o);
      a = mx ? nmax(a, b) : a + b;
    }
    if (lane == 0) buf[k * NWARP + warp] = a;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool mx = (max_mask >> k) & 1u;
    float a = buf[k * NWARP];
    for (int w = 1; w < NWARP; ++w) {
      const float b = buf[k * NWARP + w];
      a = mx ? nmax(a, b) : a + b;
    }
    v[k] = a;
  }
}

// Hinge sums of the linesearch derivative at tau (fused.py:475-489):
// a = eta + sum dd over active hinges, b = beta - sum of their offsets.
__device__ __forceinline__ void ab_at(float tau, float eta, float beta,
                                      const float* sad, const float* alo,
                                      const float* ahi, int m, float* red,
                                      int& rp, float& a, float& b) {
  float v[2] = {0.0f, 0.0f};
  for (int i = threadIdx.x; i < m; i += NT) {
    const float s = sad[i], lo = alo[i], hi = ahi[i];
    const float st = ftz(s * tau);
    const bool act1 = (-st - lo) > 0.0f;
    const bool act2 = (st - hi) > 0.0f;
    const float dd = s * s;
    v[0] += (act1 ? dd : 0.0f) + (act2 ? dd : 0.0f);
    v[1] += (act1 ? -s * lo : 0.0f) + (act2 ? s * hi : 0.0f);
  }
  block_reduce<2>(v, 0u, red, rp);
  a = eta + v[0];
  b = beta - v[1];
}

// R'z = d then R x = z with the upper factor R in M, in warp 0 only: the
// forward pass in saxpy form over the rows of R (z in zf), the backward one
// by inner products; x overwrites d.  Each step's newest value travels in a
// register, not through shared memory and a __syncwarp: the pivot d_j,
// which lane 0 updated last, is shuffled from lane 0, and every lane
// computes x_k itself, so lane 0's next partial takes x_{k+1} from its
// register.  The caller synchronises after.
__device__ __forceinline__ void chol_solve_warp(const float* M, float* d,
                                                float* zf, int n) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  float piv = d[0];  // on lane 0, d_j as the last step left it
  for (int j = 0; j < n; ++j) {
    const float* Rj = M + j * n;
    const float bj = __shfl_sync(QP_FULL_MASK, piv, 0) / Rj[j];
    for (int l = j + 1 + lane; l < n; l += 32) {
      const float v = d[l] - bj * Rj[l];
      d[l] = v;
      if (l == j + 1) piv = v;
    }
    if (lane == 0) zf[j] = bj;
    __syncwarp();
  }
  float xn = 0.0f;  // x_{k+1}, on every lane
  for (int k = n - 1; k >= 0; --k) {
    const float* Rk = M + k * n;
    float s = 0.0f;
    for (int l = k + 1 + lane; l < n; l += 32)
      s += Rk[l] * (l == k + 1 ? xn : d[l]);
    s = warp_sum(s);
    xn = (zf[k] - s) / Rk[k];
    if (lane == 0) d[k] = xn;
    __syncwarp();
  }
}

// The on-chip plan in floats: Q, A, M, 18 n-vectors, 19 m-vectors and the
// reduction scratch.  A profiled on-chip launch keeps its counters in
// 8-byte slots after it, from the next even float.
__host__ __device__ constexpr long long smem_plan_floats(int n, int m) {
  return 2LL * n * n + (long long)m * n + 18LL * n + 19LL * m +
         2 * RED_K * NWARP;
}

// PROF builds the on-chip tier's counters into a kernel of its own, so that
// the unprofiled one keeps none, and keeps them in shared memory, since its
// registers are short (the streaming tier tests gprof at run time and keeps
// them in registers)
template <bool STREAM, bool PROF>
__global__ void __launch_bounds__(NT, STREAM ? 1 : 3) fused_palm_kernel(
    const float* __restrict__ gQ, const float* __restrict__ gA,
    const float* __restrict__ gq, const float* __restrict__ gbmin,
    const float* __restrict__ gbmax, const float* __restrict__ gDinv,
    const float* __restrict__ gEinv, const float* __restrict__ gcinv,
    float* __restrict__ gnst, float* __restrict__ gmst,
    float* __restrict__ gsc, float* __restrict__ gM,
    long long* __restrict__ gprof, const FSet fs, const int n, const int m,
    const int T, const int inner_max_iter, const int max_iter,
    const int scaling_on, const int prox, const int nonconvex,
    const int enable_dual, const int P, const int b, const int stage_at) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t pb = blockIdx.x;

  // ---- memory layout (qp_fused_smem_bytes and qp_fused_stream_smem_bytes
  // count the shared part): on chip, Q, A and M lead the shared memory; in
  // the streaming tier they are this problem's slices of global memory ----
  const float* Q = STREAM ? gQ + pb * n * n : sm;
  const float* A = STREAM ? gA + pb * m * n : sm + n * n;
  float* M = STREAM ? gM + pb * n * n : sm + n * n + m * n;
  float* nv = STREAM ? sm : M + n * n;  // 18 n-vectors; 8 are nst's rows
  float* x = nv;
  float* x0 = nv + n;
  float* Qx = nv + 2 * n;
  float* aty = nv + 3 * n;
  float* xprev = nv + 4 * n;
  float* tqd = nv + 5 * n;
  float* td = nv + 6 * n;
  float* certx = nv + 7 * n;
  float* q = nv + 8 * n;
  float* Dinv = nv + 9 * n;
  float* d = nv + 10 * n;
  float* zf = nv + 11 * n;
  float* Atyh = nv + 12 * n;
  float* dphi = nv + 13 * n;
  float* df = nv + 14 * n;
  float* Qd = nv + 15 * n;
  float* Qdp = nv + 16 * n;
  float* rt = nv + 17 * n;
  float* mv = nv + 18 * n;  // 19 m-vectors; the first 7 are mst's rows
  float* y = mv;
  float* Ax = mv + m;
  float* sig = mv + 2 * m;
  float* prin = mv + 3 * m;
  float* actold = mv + 4 * m;
  float* tad = mv + 5 * m;
  float* certy = mv + 6 * m;
  float* bmin = mv + 7 * m;
  float* bmax = mv + 8 * m;
  float* Einv = mv + 9 * m;
  float* yh = mv + 10 * m;
  float* pri = mv + 11 * m;
  float* Axys = mv + 12 * m;
  float* signew = mv + 13 * m;
  float* w = mv + 14 * m;
  float* Ad = mv + 15 * m;
  float* sad = mv + 16 * m;
  float* alo = mv + 17 * m;
  float* ahi = mv + 18 * m;
  float* red = mv + 19 * m;  // 2 * RED_K * NWARP
  // streaming: the staging region, two mbarriers then the panels
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + stage_at);
  float* stg = sm + stage_at + 4;

  // a profiled launch: thread 0 sums clock64() cycles by section
  constexpr int NPROF = STREAM ? PROF_STREAM : PROF_SMEM;
  // the solves' section; on chip the Cholesky is 2, Qd/Ad 4, linesearch 5
  constexpr int S_SOLVE = STREAM ? 4 : 3;
  long long prof_r[STREAM ? NPROF : 1] = {}, tick = 0;
  long long* prof_s =
      reinterpret_cast<long long*>(sm + ((smem_plan_floats(n, m) + 1) & ~1));
  auto prof = [&](int s) -> long long& {
    if constexpr (STREAM) return prof_r[s];
    else return prof_s[s];
  };
  const bool profiling = (STREAM || PROF) && gprof != nullptr && tid == 0;
  if (profiling && !STREAM)
    for (int k = 0; k < NPROF; ++k) prof(k) = 0;
  auto mark = [&](int s) {
    if (profiling) {
      const long long now = clock64();
      if (s >= 0) prof(s) += now - tick;
      tick = now;
    }
  };

  // ---- load ----
  if (!STREAM) {
    const float4* gQ4 = reinterpret_cast<const float4*>(gQ + pb * n * n);
    const float4* gA4 = reinterpret_cast<const float4*>(gA + pb * m * n);
    float4* Q4 = reinterpret_cast<float4*>(sm);
    float4* A4 = reinterpret_cast<float4*>(sm + n * n);
    for (int e = tid; e < n * n / 4; e += NT) Q4[e] = gQ4[e];
    for (int e = tid; e < m * n / 4; e += NT) A4[e] = gA4[e];
  }
  for (int e = tid; e < 8 * n; e += NT) nv[e] = gnst[pb * 8 * n + e];
  for (int e = tid; e < 7 * m; e += NT) mv[e] = gmst[pb * 7 * m + e];
  for (int j = tid; j < n; j += NT) {
    q[j] = gq[pb * n + j];
    Dinv[j] = gDinv[pb * n + j];
  }
  for (int i = tid; i < m; i += NT) {
    bmin[i] = gbmin[pb * m + i];
    bmax[i] = gbmax[pb * m + i];
    Einv[i] = gEinv[pb * m + i];
  }
  const float* scp = gsc + pb * SC_ROWS;
  float gamma = scp[GAMMA], epsa_in = scp[EPSA_IN], epsr_in = scp[EPSR_IN];
  float done = scp[DONE], iter = scp[ITER], prev_iter = scp[PREV_ITER];
  float no_change = scp[NO_CHANGE], gmaxed = scp[GAMMA_MAXED];
  float iter_out = scp[ITER_OUT], gersh = scp[GERSH];
  float nbch = scp[NB_CHANGED], pri_norm_s = scp[PRI_NORM];
  float dua_norm_s = scp[DUA_NORM], status = scp[STATUS];
  float epsk_abs = scp[EPSK_ABS], epsk_rel = scp[EPSK_REL];
  const float gmax = scp[GAMMA_MAX], cobj = scp[COBJ];
  const float cinv = gcinv[pb];
  const float cs = scaling_on ? 1.0f / cinv : 1.0f;
  int rp = 0;  // reduction scratch parity
  __syncthreads();
  const long long t_loop = profiling ? clock64() : 0;

  for (int t = 0; t < T && !(done > 0.5f); ++t) {
    // ---- residuals (iteration.c:24-48) and the m-side norms ----
    float pri_norm, axz_max, pn_uns, eps_p, oob;
    {
      float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = tid; i < m; i += NT) {
        const float si = sig[i], yi = y[i], axi = Ax[i], ei = Einv[i];
        const float lo = bmin[i], hi = bmax[i];
        const float axys = axi + yi * (1.0f / si);
        const float z = fminf(fmaxf(axys, lo), hi);
        const float p = axi - z;
        const float yhi = yi + si * p;
        Axys[i] = axys;
        pri[i] = p;
        yh[i] = yhi;
        const float ev = 1.0f / ei;
        const float dy = yhi - yi;
        v[0] = nmax(v[0], fabsf(ei * p));
        v[1] = nmax(v[1], fabsf(ei * axi));
        v[2] = nmax(v[2], fabsf(ei * z));
        v[3] = nmax(v[3], fabsf(p));
        v[4] = nmax(v[4], fabsf(ev * dy));
        const bool has_ub = hi < ev * INFTY, has_lb = lo > -ev * INFTY;
        v[5] += (has_ub ? hi * fmaxf(dy, 0.0f) : 0.0f) +
                (has_lb ? lo * fminf(dy, 0.0f) : 0.0f);
      }
      block_reduce<6>(v, 0x1Fu, red, rp);  // also publishes yh
      pri_norm = v[0];
      axz_max = nmax(v[1], v[2]);
      pn_uns = v[3];
      eps_p = fs.eps_pinf * v[4];
      oob = v[5];
    }

    // ---- A'yh, gradients and the n-side norms (termination.c) ----
    float dua_norm, dua2_norm, max_norm, atdy_max, eps_d, dxdx, dxQdx, qdx;
    {
      float v[10] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                     0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = tid; j < n; j += NT) {
        float at = 0.0f;
        for (int i = 0; i < m; ++i) at += A[i * n + j] * yh[i];
        Atyh[j] = at;
        const float xj = x[j], x0j = x0[j], qj = q[j], dj = Dinv[j];
        const float Qxj = Qx[j];
        float dfj = Qxj + qj;
        if (prox) dfj = dfj - x0j / gamma;
        df[j] = dfj;
        const float dp = dfj + at;
        dphi[j] = dp;
        const float ddj = prox ? dp - (xj - x0j) / gamma : dp;
        v[0] = nmax(v[0], fabsf(dj * ddj));
        v[1] = nmax(v[1], fabsf(dj * dp));
        v[2] = nmax(v[2], fabsf(dj * Qxj));
        v[3] = nmax(v[3], fabsf(dj * qj));
        v[4] = nmax(v[4], fabsf(dj * at));
        v[5] = nmax(v[5], fabsf(dj * (at - aty[j])));
        const float dx = xj - xprev[j];
        const float ddx = (1.0f / dj) * dx;
        v[6] = nmax(v[6], fabsf(ddx));
        v[7] += ddx * ddx;
        v[8] += dx * tqd[j];
        v[9] += qj * dx;
      }
      block_reduce<10>(v, 0x7Fu, red, rp);
      dua_norm = v[0] * cinv;
      dua2_norm = v[1] * cinv;
      max_norm = nmax(v[2], nmax(v[3], v[4])) * cinv;
      atdy_max = v[5];
      eps_d = fs.eps_dinf * v[6];
      dxdx = v[7];
      dxQdx = v[8];
      qdx = v[9];
    }
    const float eps_pri = fs.eps_abs + fs.eps_rel * axz_max;
    const float eps_dua = fs.eps_abs + fs.eps_rel * max_norm;
    const float eps_dua_in = epsa_in + epsr_in * max_norm;
    const bool solved = pri_norm < eps_pri && dua_norm < eps_dua;
    const bool pinf =
        eps_p > 0.0f && atdy_max <= eps_p && oob <= -eps_p && !solved;

    // ---- dual infeasibility (termination.c:184-240) ----
    bool viol;
    {
      float v[1] = {0.0f};
      for (int i = tid; i < m; i += NT) {
        const float ev = 1.0f / Einv[i];
        const bool has_ub = bmax[i] < ev * INFTY;
        const bool has_lb = bmin[i] > -ev * INFTY;
        const float adx = Einv[i] * tad[i];
        v[0] = nmax(v[0], (has_ub && adx >= eps_d ? 1.0f : 0.0f) +
                              (has_lb && adx <= -eps_d ? 1.0f : 0.0f));
      }
      block_reduce<1>(v, 1u, red, rp);
      viol = v[0] > 0.5f;
    }
    const bool curv = (dxQdx <= -cs * fs.e2 * dxdx) ||
                      (dxQdx <= cs * fs.e2 * dxdx && qdx <= -cs * eps_d);
    const bool dinf = eps_d > 0.0f && !viol && curv && !solved && !pinf;

    pri_norm_s = pri_norm;
    dua_norm_s = dua_norm;
    if (solved || pinf || dinf) {
      if (pinf)
        for (int i = tid; i < m; i += NT)
          certy[i] = (1.0f / Einv[i]) * (cinv * (yh[i] - y[i]));
      if (dinf)
        for (int j = tid; j < n; j += NT)
          certx[j] = (1.0f / Dinv[j]) * (x[j] - xprev[j]);
      status = solved ? 1.0f : (pinf ? -3.0f : -4.0f);
      done = 1.0f;
      break;
    }
    if (!(iter < (float)max_iter)) break;  // no live trip is left

    const bool outer = dua2_norm <= eps_dua_in || no_change >= 3.0f;
    const bool exhausted = iter == prev_iter + (float)inner_max_iter;
    const bool b_outer = outer, b_exh = !outer && exhausted;
    const bool b_inner = !outer && !exhausted, b_sig = b_outer || b_exh;
    const bool sig_enabled = b_sig && iter_out > 0.0f && pri_norm > eps_pri;
    // the boost; a nonconvex solve never boosts (its gamma is pinned)
    const bool check = prox && !nonconvex && b_outer && gmaxed < 0.5f &&
                       iter_out > 0.0f && nbch < 0.5f && pri_norm < eps_pri;

    // ---- sigma update (iteration.c:86-145), outer y, active sets ----
    float nb2, nact2, nb_inner;
    {
      float v[3] = {0.0f, 0.0f, 0.0f};
      for (int i = tid; i < m; i += NT) {
        const float si = sig[i], p = pri[i], ao = actold[i];
        float sn = si;
        if (sig_enabled && fabsf(p) > fs.theta * fabsf(prin[i]) && ao > 0.5f) {
          const float mult = fmaxf(1.0f, fs.delta * fabsf(p) / (pn_uns + 1e-6f));
          sn = fminf(mult * si, fs.sigma_max);
        }
        signew[i] = sn;
        const float yn = b_outer ? yh[i] : y[i];
        if (prox) {
          const float axys2 = Ax[i] + yn * (1.0f / sn);
          const float a2 = (axys2 <= bmin[i] || axys2 >= bmax[i]) ? 1.0f : 0.0f;
          v[0] += fabsf(a2 - ao);
          v[1] += a2;
        }
        const float act =
            (Axys[i] <= bmin[i] || Axys[i] >= bmax[i]) ? 1.0f : 0.0f;
        v[2] += fabsf(act - ao);
        w[i] = act * sn;
        y[i] = yn;
        if (b_sig) {
          sig[i] = sn;
          prin[i] = p;
        }
        if (b_inner) actold[i] = act;
      }
      block_reduce<3>(v, 0u, red, rp);  // also publishes w
      nb2 = v[0];
      nact2 = v[1];
      nb_inner = v[2];
    }

    // ---- dual-objective termination on outer trips (fused.py:683-710,
    // iteration.c:272-299): dobj from v = Q^-1 g, g = A'yh + q, by the
    // in-place Cholesky of Q in M, which the Newton step rebuilds anyway.
    // A Q that is not PD gives NaN, and a NaN dobj never terminates. ----
    bool dual_term = false;
    if (enable_dual && b_outer) {
      {
        const float4* Q4 = reinterpret_cast<const float4*>(Q);
        float4* M4 = reinterpret_cast<float4*>(M);
        for (int e = tid; e < n * n / 4; e += NT) M4[e] = Q4[e];
      }
      for (int j = tid; j < n; j += NT) d[j] = Atyh[j] + q[j];
      __syncthreads();
      mark(-1);
      if (STREAM)
        stream::chol_blocked(M, stg, n, b, profiling, prof(2), prof(3));
      else
        chol_upper_inplace(M, n);
      mark(STREAM ? -1 : 2);
      if (STREAM)
        stream::solve_stream(M, d, zf, stg, bars, n, P);
      else
        chol_solve_warp(M, d, zf, n);
      __syncthreads();
      mark(S_SOLVE);
      float v[2] = {0.0f, 0.0f};
      for (int j = tid; j < n; j += NT) v[0] += (Atyh[j] + q[j]) * d[j];
      for (int i = tid; i < m; i += NT) {
        const float yi = yh[i];
        v[1] += yi > 0.0f ? yi * bmax[i] : yi * bmin[i];
      }
      block_reduce<2>(v, 0u, red, rp);
      const float dobj = (-0.5f * v[0] - v[1]) * cinv + cobj;
      dual_term = isfinite(dobj) && dobj > fs.dual_limit;
    }

    // ---- outer update and gamma (qpalm.c:515-644) ----
    const float epsa_new = b_outer ? fmaxf(fs.eps_abs, fs.rho * epsa_in) : epsa_in;
    const float epsr_new = b_outer ? fmaxf(fs.eps_rel, fs.rho * epsr_in) : epsr_in;
    float gamma_new = gamma, gmaxed_new = gmaxed, nbch_new = nbch;
    bool x0_moves = prox && b_sig;
    if (nonconvex) {
      // gamma pinned per problem (nonconvex.c:171-183): the proximal centre
      // moves only once pri_res meets its own shrinking eps_k ladder
      // (qpalm.c:586-609); exhausted trips still step gamma to its cap
      const float eps_k = epsk_abs + epsk_rel * axz_max;
      x0_moves = b_outer && pri_norm < eps_k;
      if (x0_moves) {
        epsk_abs = fmaxf(fs.eps_abs, fs.rho * epsk_abs);
        epsk_rel = fmaxf(fs.eps_rel, fs.rho * epsk_rel);
      }
      const float stepped = gamma < gmax ? fminf(gamma * fs.gamma_upd, gmax) : gamma;
      gamma_new = b_exh ? stepped : gamma;
    } else if (prox) {
      const bool boost = check && nb2 < 0.5f;
      const float boosted =
          nact2 > 0.5f ? fmaxf(gmax, 1e14f / fmaxf(gersh, 1e-30f)) : 1e12f;
      const float stepped = gamma < gmax ? fminf(gamma * fs.gamma_upd, gmax) : gamma;
      gamma_new = b_outer ? (boost ? boosted : stepped) : (b_exh ? stepped : gamma);
      if (boost && nact2 > 0.5f) gmaxed_new = 1.0f;
      if (check) nbch_new = fminf(nb2, 1.0f);
    }
    if (b_sig) {
      const float diff = 1.0f / gamma_new - 1.0f / gamma;
      const bool changed = gamma_new != gamma;
      for (int j = tid; j < n; j += NT) {
        if (b_outer) aty[j] = Atyh[j];
        if (changed) Qx[j] = Qx[j] + diff * x[j];
        if (x0_moves) x0[j] = x[j];
      }
    }
    const float no_change_after = b_sig ? 0.0f : no_change;
    const float no_change_new =
        b_inner ? (nbch_new > 0.5f ? 0.0f : no_change_after + 1.0f)
                : no_change_after;
    const float nbch_final = b_inner ? fminf(nb_inner, 1.0f) : nbch_new;

    // ---- inner Newton step (qpalm.c:662-678) ----
    if (b_inner) {
      for (int j = tid; j < n; j += NT) d[j] = -dphi[j];
      mark(-1);
      // on chip M = Q + A' diag(w) A; streaming the upper triangle of
      // A' diag(w) A
      if (STREAM)
        stream::schur_stream(M, A, w, stg, bars, n, m, P);
      else
        schur_tiles(M, Q, A, w, n, m);
      __syncthreads();
      mark(0);
      // Gershgorin bound of A'WA by rows (on chip M - Q, streaming the
      // symmetric completion of M, which then gets + Q), then
      // M += I / gamma
      float gersh_new;
      {
        const float ginv = prox ? 1.0f / gamma : 0.0f;
        float v[1] = {0.0f};
        if (STREAM) {
          v[0] = stream::gershgorin_add_q(M, Q, ginv, rt, n);
        } else {
          for (int j = warp; j < n; j += NWARP) {
            float s = 0.0f;
            for (int k = lane; k < n; k += 32)
              s += fabsf(M[j * n + k] - Q[j * n + k]);
            v[0] = nmax(v[0], warp_sum(s));
            if (lane == (j & 31)) M[j * n + j] += ginv;
          }
        }
        block_reduce<1>(v, 1u, red, rp);  // also publishes M
        gersh_new = v[0];
      }
      mark(1);
      if (STREAM)
        stream::chol_blocked(M, stg, n, b, profiling, prof(2), prof(3));
      else
        chol_upper_inplace(M, n);
      mark(STREAM ? -1 : 2);
      if (STREAM)  // d = M^-1 (-dphi)
        stream::solve_stream(M, d, zf, stg, bars, n, P);
      else
        chol_solve_warp(M, d, zf, n);
      __syncthreads();
      mark(S_SOLVE);
      // Qd (+ d / gamma), Ad, and the linesearch's breakpoints
      float eta, beta;
      {
        float v[2] = {0.0f, 0.0f};
        for (int j = warp; j < n; j += NWARP) {
          float s = 0.0f;
          for (int k = lane; k < n; k += 32) s += Q[j * n + k] * d[k];
          s = warp_sum(s);
          if (lane == 0) {
            Qdp[j] = s;
            const float qdj = prox ? s + d[j] / gamma : s;
            Qd[j] = qdj;
            v[0] += d[j] * qdj;
            v[1] += d[j] * df[j];
          }
        }
        for (int i = warp; i < m; i += NWARP) {
          float s = 0.0f;
          for (int k = lane; k < n; k += 32) s += A[i * n + k] * d[k];
          s = warp_sum(s);
          if (lane == 0) {
            const float sn = signew[i], sq = sqrtf(sn), yn = y[i], axi = Ax[i];
            Ad[i] = s;
            sad[i] = sq * s;
            alo[i] = (yn + sn * (axi - bmin[i])) / sq;
            ahi[i] = (-yn + sn * (bmax[i] - axi)) / sq;
          }
        }
        block_reduce<2>(v, 0u, red, rp);  // also publishes Qd, Ad, sad...
        eta = v[0];
        beta = v[1];
      }
      mark(STREAM ? -1 : 4);

      // ---- sort-free exact linesearch (fused.py:467-536).  Step t + 1
      // evaluates the hinge sums at step t's proposal, which step t has just
      // evaluated: they are carried, not summed again (27 evaluations, not
      // 53; the same inputs in the same order give the same bits) ----
      float tau;
      {
        const float tiny = FLT_MIN;
        float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = tid; i < m; i += NT) {
          const float s = sad[i], lo = alo[i], hi = ahi[i], dd = s * s;
          const float st = ftz(s * tiny);
          const bool act1 = (-st - lo) > 0.0f, act2 = (st - hi) > 0.0f;
          v[0] += (act1 ? dd : 0.0f) + (act2 ? dd : 0.0f);
          v[1] += (act1 ? -s * lo : 0.0f) + (act2 ? s * hi : 0.0f);
          const bool f1 = -s > 0.0f, f2 = s > 0.0f;
          v[2] += (f1 ? dd : 0.0f) + (f2 ? dd : 0.0f);
          v[3] += (f1 ? -s * lo : 0.0f) + (f2 ? s * hi : 0.0f);
          const float s1 = lo / (-s), s2 = hi / s;
          v[4] = nmax(v[4], (s1 > 0.0f && s1 < 1e30f) ? s1 : 0.0f);
          v[5] = nmax(v[5], (s2 > 0.0f && s2 < 1e30f) ? s2 : 0.0f);
        }
        block_reduce<6>(v, 0x30u, red, rp);
        const float a0 = eta + v[0], b0 = beta - v[1];
        const float a_fin = eta + v[2], b_fin = beta - v[3];
        const float smax = nmax(v[4], v[5]);
        const float tau_fin = -b_fin / fmaxf(a_fin, tiny);
        float hi_t = fmaxf(nmax(smax, tau_fin), 1.0f) * 1.01f + 1.0f;
        float lo_t = 0.0f;
        tau = fminf(-b0 / fmaxf(a0, tiny), hi_t);
        tau = tau > 0.0f ? tau : 0.5f * hi_t;
        float a, b;  // the hinge sums at tau
        ab_at(tau, eta, beta, sad, alo, ahi, m, red, rp, a, b);
        for (int it = 0; it < 26; ++it) {
          float prop = -b / fmaxf(a, tiny);
          const float mid = 0.5f * (lo_t + hi_t);
          prop = (prop > lo_t && prop < hi_t) ? prop : mid;
          ab_at(prop, eta, beta, sad, alo, ahi, m, red, rp, a, b);
          const bool pos = fmaf(a, prop, b) > 0.0f;
          lo_t = pos ? lo_t : prop;
          hi_t = pos ? prop : hi_t;
          tau = prop;
        }
        const float tau_star = -b / fmaxf(a, tiny);
        tau = (ftz(a0 * tiny) + b0 > 0.0f) ? -b0 / a0 : tau_star;
      }
      mark(STREAM ? -1 : 5);

      for (int j = tid; j < n; j += NT) {
        const float xj = x[j], dj = d[j];
        xprev[j] = xj;
        x[j] = xj + tau * dj;
        Qx[j] = Qx[j] + tau * Qd[j];
        tqd[j] = tau * Qdp[j];
        td[j] = tau * dj;
      }
      for (int i = tid; i < m; i += NT) {
        const float adi = Ad[i];
        Ax[i] = Ax[i] + tau * adi;
        tad[i] = tau * adi;
      }
      gersh = gersh_new;
    }

    // ---- scalar state; the terminating trip is not counted, and a dual-
    // terminating one still made its outer update above (fused.py:865-883)
    if (b_sig) prev_iter = iter;
    if (dual_term) {
      status = 2.0f;  // QPALM_DUAL_TERMINATED
      done = 1.0f;
    } else {
      iter += 1.0f;
    }
    iter_out += b_sig ? 1.0f : 0.0f;
    gamma = gamma_new;
    epsa_in = epsa_new;
    epsr_in = epsr_new;
    no_change = no_change_new;
    gmaxed = gmaxed_new;
    nbch = nbch_final;
    __syncthreads();
  }

  // ---- write back ----
  __syncthreads();
  if (profiling) {
    prof(NPROF - 1) = clock64() - t_loop;
    for (int k = 0; k < NPROF; ++k) gprof[pb * NPROF + k] = prof(k);
  }
  for (int e = tid; e < 8 * n; e += NT) gnst[pb * 8 * n + e] = nv[e];
  for (int e = tid; e < 7 * m; e += NT) gmst[pb * 7 * m + e] = mv[e];
  if (tid == 0) {
    float* s = gsc + pb * SC_ROWS;
    s[GAMMA] = gamma;
    s[EPSA_IN] = epsa_in;
    s[EPSR_IN] = epsr_in;
    s[DONE] = done;
    s[ITER] = iter;
    s[PREV_ITER] = prev_iter;
    s[NO_CHANGE] = no_change;
    s[GAMMA_MAXED] = gmaxed;
    s[ITER_OUT] = iter_out;
    s[GERSH] = gersh;
    s[NB_CHANGED] = nbch;
    s[PRI_NORM] = pri_norm_s;
    s[DUA_NORM] = dua_norm_s;
    s[STATUS] = status;
    s[EPSK_ABS] = epsk_abs;
    s[EPSK_REL] = epsk_rel;
  }
}

}  // namespace

extern "C" int qp_fused_smem_bytes(int n, int m) {
  return (int)(sizeof(float) * smem_plan_floats(n, m));
}

extern "C" int qp_fused_stream_smem_bytes(int n, int m) {
  return (int)sizeof(float) * stream_plan(n, m).floats;
}

// out[0] = P, out[1] = b, out[2] = the staging region's offset in floats
extern "C" int qp_fused_stream_plan(int n, int m, int* out) {
  const StreamPlan p = stream_plan(n, m);
  out[0] = p.P;
  out[1] = p.b;
  out[2] = p.stage;
  return 0;
}

// tier 0 runs the on-chip kernel (M unused, may be null); tier 1 the
// streaming one, with M a (B, n, n) float scratch (only its upper triangle
// is meaningful after a launch).  prof is null or an int64 array that
// receives each block's clock64() cycles by section, the dual check's
// Cholesky of Q and its solves included: (B, 6) streaming (the assembly,
// the Gershgorin pass with + Q, the Cholesky's panels and its trailing
// updates, the solves, the whole loop), (B, 7) on chip (the assembly, the
// Gershgorin pass with + I/gamma, the Cholesky, the solves, Qd and Ad with
// the breakpoints, the linesearch, the whole loop; a profiled on-chip
// launch takes up to 60 bytes of shared memory more than the plan).
extern "C" int qp_fused_palm(const float* Q, const float* A, const float* q,
                             const float* bmin, const float* bmax,
                             const float* Dinv, const float* Einv,
                             const float* cinv, float* nst, float* mst,
                             float* sc, float* M, long long* prof,
                             const float* fset, int B, int n, int m, int T,
                             int inner_max_iter, int max_iter, int scaling_on,
                             int proximal, int nonconvex, int enable_dual,
                             int tier, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (n % 4 || (tier && (M == nullptr || (size_t)M % 16 || (size_t)A % 16)))
    return (int)cudaErrorInvalidValue;
  FSet fs;
  memcpy(&fs, fset, sizeof(FSet));
  const StreamPlan plan = stream_plan(n, m);
  const int smem =
      tier ? qp_fused_stream_smem_bytes(n, m)
           : qp_fused_smem_bytes(n, m) + (prof ? 4 + 8 * PROF_SMEM : 0);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = tier ? &fused_palm_kernel<true, false>
                     : (prof ? &fused_palm_kernel<false, true>
                             : &fused_palm_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      Q, A, q, bmin, bmax, Dinv, Einv, cinv, nst, mst, sc, M, prof, fs, n, m,
      T, inner_max_iter, max_iter, scaling_on, proximal, nonconvex,
      enable_dual, tier ? plan.P : 0, tier ? plan.b : 0,
      tier ? plan.stage : 0);
  return (int)cudaGetLastError();
}
