// The two per-pair passes of one CVO align iteration (cvo.cpp:122-334),
// as device functions over one work item: TILE rows of the fixed cloud x
// (one thread per row) against a range of column tiles of the moving cloud
// y, staged in shared memory. flow_step.cu launches them as kernels;
// align_fused.cu calls them inside its persistent loop, with the moving
// cloud transformed by the current pose while it is staged.
//
//   pass 1 (flow): for every kept pair, a = the joint kernel, and the row
//     accumulates d_i = sum_j a_ij (y_j - x_i) (locally small, so the flow
//     does not cancel when clouds sit metres from the origin) and its
//     integer keep count. The work item writes 12 partials, the cross
//     moments sum_i x_a d_b (9) and sum_i d_b (3), and its count; then
//     omega = antisym(sum x d^T) / c, v = sum d / d.
//   pass 2 (step): recompute the gate and the kernel, then per kept pair
//     the four dots xi^k z_j . (x_i - y_j) and the quartic terms beta,
//     gamma, delta, epsilon; the work item writes the partial B, C, D, E.
//
// Gate and kernel follow the Pallas `_pair_tile` (pallas_kernels.py:106):
// distances by the dot identity with FMA-chain dots, one fused clamped
// exponential; ops/pairwise.cvo_kernel repeats them operation by operation.
// Partials are summed in a fixed order (finalize_flow, finalize_step): no
// float atomics, two runs give bitwise-equal results.

#pragma once

#include "pair_math.cuh"

namespace {

constexpr int N_FLOW = 12;   // flow partials per work item
constexpr int N_STEP = 4;    // step partials per work item (B, C, D, E)

// one tile of TILE moving columns
struct Cols {
  float p[3][TILE];      // positions (transformed in align_fused)
  float f[5][TILE];      // features
  float psq[TILE];
  float fsq[TILE];
  unsigned char m[TILE];
  // step pass only
  float u[4][3][TILE];   // xi^k z, k = 1..4
  float uy[4][TILE];     // xi^k z . y
  float nz[3][TILE];     // |xiz|^2, -xiz.xi2z, |xi2z|^2 + 2 xiz.xi3z
};

// y = y0 R + Tt (update_tf + transform_pcd, cvo.cpp:106-110, :336)
struct Pose {
  float R[9];    // row-major
  float Tt[3];   // -R^T T
};

struct Row {
  float x[3], f[5], xx, ff;
  bool on;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ x,
                                        const float* __restrict__ fx,
                                        const unsigned char* __restrict__ mx,
                                        int N, int i) {
  Row r;
  const bool in = i < N;
  for (int c = 0; c < 3; ++c) r.x[c] = in ? x[i * 3 + c] : 0.f;
  for (int c = 0; c < 5; ++c) r.f[c] = in ? fx[i * 5 + c] : 0.f;
  r.xx = sq3(r.x);
  r.ff = sq5(r.f);
  r.on = in && mx[i] != 0;
  return r;
}

// omega x a
__device__ __forceinline__ void cross_w(const float* w, const float* a,
                                        float* out) {
  out[0] = w[1] * a[2] - w[2] * a[1];
  out[1] = w[2] * a[0] - w[0] * a[2];
  out[2] = w[0] * a[1] - w[1] * a[0];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Stage column tile t (thread tid takes column t * TILE + tid). MOVE: the
// columns are transformed by `pose`; STEP: also the per-column terms of
// the step pass for the flow (w, v).
template <bool MOVE, bool STEP>
__device__ void stage_cols(Cols& s, const float* __restrict__ y,
                           const float* __restrict__ fy,
                           const unsigned char* __restrict__ my, int M, int t,
                           const Pose& pose, const float* w, const float* v) {
  const int tid = threadIdx.x;
  const int j = t * TILE + tid;
  const bool in = j < M;
  float q[3], f[5];
  for (int c = 0; c < 3; ++c) q[c] = in ? y[j * 3 + c] : 0.f;
  for (int c = 0; c < 5; ++c) f[c] = in ? fy[j * 5 + c] : 0.f;
  if (MOVE) {
    const float q0[3] = {q[0], q[1], q[2]};
    for (int c = 0; c < 3; ++c)
      q[c] = q0[0] * pose.R[c] + q0[1] * pose.R[3 + c] + q0[2] * pose.R[6 + c]
             + pose.Tt[c];
  }
  for (int c = 0; c < 3; ++c) s.p[c][tid] = q[c];
  for (int c = 0; c < 5; ++c) s.f[c][tid] = f[c];
  s.psq[tid] = sq3(q);
  s.fsq[tid] = sq5(f);
  s.m[tid] = in ? my[j] : 0;
  if (STEP) {
    float u[4][3];
    cross_w(w, q, u[0]);
    for (int c = 0; c < 3; ++c) u[0][c] = u[0][c] + v[c];
    for (int k = 1; k < 4; ++k) cross_w(w, u[k - 1], u[k]);
    for (int k = 0; k < 4; ++k) {
      for (int c = 0; c < 3; ++c) s.u[k][c][tid] = u[k][c];
      s.uy[k][tid] = dot3(u[k], q);
    }
    s.nz[0][tid] = dot3(u[0], u[0]);
    s.nz[1][tid] = -dot3(u[0], u[1]);
    s.nz[2][tid] = dot3(u[1], u[1]) + 2.f * dot3(u[0], u[2]);
  }
}

// the joint kernel a of pair (row r, column k) and whether the pair is
// kept: gate (geometric, colour, masks) and a > sp_thres
__device__ __forceinline__ bool keep_pair(const Row& r, const Cols& s, int k,
                                          float d2t, float den,
                                          const Consts& c, float& a) {
  if (!s.m[k]) return false;
  const float d2 = ident_d2(r.xx, s.psq[k], r.x, s.p, k, 3);
  if (!(d2 < d2t)) return false;
  const float d2c = ident_d2(r.ff, s.fsq[k], r.f, s.f, k, 5);
  if (!(d2c < c.d2ct)) return false;
  a = clamped_kernel(c.s2cs2, -(d2 / den + d2c / c.two_cl2));
  return a > c.sp_thres;
}

// Pass 1 over row tile rt and column tiles [t0, t1): writes the work
// item's 12 flow partials and its keep count. Every thread of the block
// calls it.
template <bool MOVE>
__device__ void flow_item(const float* __restrict__ x,
                          const float* __restrict__ fx,
                          const unsigned char* __restrict__ mx, int N,
                          const float* __restrict__ y,
                          const float* __restrict__ fy,
                          const unsigned char* __restrict__ my, int M, int rt,
                          int t0, int t1, const Pose& pose, float ell,
                          const Consts& c, Cols& s, float* fbuf, int* ibuf,
                          float* fpart, int* npart) {
  const int tid = threadIdx.x;
  const Row r = load_row(x, fx, mx, N, rt * TILE + tid);
  const float d2t = -2.f * ell * ell * c.log_ratio;
  const float den = 2.f * ell * ell;
  float d[3] = {0.f, 0.f, 0.f};
  int n = 0;
  for (int t = t0; t < t1; ++t) {
    stage_cols<MOVE, false>(s, y, fy, my, M, t, pose, nullptr, nullptr);
    __syncthreads();
    if (r.on) {
      for (int k = 0; k < TILE; ++k) {
        float a;
        if (!keep_pair(r, s, k, d2t, den, c, a)) continue;
        ++n;
        for (int q = 0; q < 3; ++q) d[q] += a * (s.p[q][k] - r.x[q]);
      }
    }
    __syncthreads();
  }
  for (int q = 0; q < N_FLOW; ++q) {
    const float val = q < 9 ? r.x[q / 3] * d[q % 3] : d[q - 9];
    const float bs = block_sum(val, fbuf);
    if (tid == 0) __stcg(fpart + q, bs);
  }
  const int bc = block_count(n, ibuf);
  if (tid == 0) __stcg(npart, bc);
}

// Pass 2 over row tile rt and column tiles [t0, t1) for the flow (w, v):
// writes the work item's partial B, C, D, E.
template <bool MOVE>
__device__ void step_item(const float* __restrict__ x,
                          const float* __restrict__ fx,
                          const unsigned char* __restrict__ mx, int N,
                          const float* __restrict__ y,
                          const float* __restrict__ fy,
                          const unsigned char* __restrict__ my, int M, int rt,
                          int t0, int t1, const Pose& pose, float ell,
                          const float* w, const float* v, const Consts& c,
                          Cols& s, float* fbuf, float* spart) {
  const int tid = threadIdx.x;
  const Row r = load_row(x, fx, mx, N, rt * TILE + tid);
  const float d2t = -2.f * ell * ell * c.log_ratio;
  const float den = 2.f * ell * ell;
  const float tc = 1.f / (2.f * ell * ell);
  float acc[N_STEP] = {0.f, 0.f, 0.f, 0.f};
  for (int t = t0; t < t1; ++t) {
    stage_cols<MOVE, true>(s, y, fy, my, M, t, pose, w, v);
    __syncthreads();
    if (r.on) {
      for (int k = 0; k < TILE; ++k) {
        float a;
        if (!keep_pair(r, s, k, d2t, den, c, a)) continue;
        float dk[4];   // xi^k z . (x_i - y_j)
        for (int q = 0; q < 4; ++q)
          dk[q] = (r.x[0] * s.u[q][0][k] + r.x[1] * s.u[q][1][k]
                   + r.x[2] * s.u[q][2][k]) - s.uy[q][k];
        const float beta = (-2.f * tc) * dk[0];
        const float gamma = (-tc) * (s.nz[0][k] + 2.f * dk[1]);
        const float delta = (2.f * tc) * (s.nz[1][k] - dk[2]);
        const float epsil = (-tc) * (s.nz[2][k] + 2.f * dk[3]);
        const float b2 = beta * beta;
        acc[0] += a * beta;
        acc[1] += a * (gamma + b2 * 0.5f);
        acc[2] += a * (delta + beta * gamma + b2 * beta / 6.f);
        acc[3] += a * (epsil + beta * delta + 0.5f * b2 * gamma
                       + 0.5f * gamma * gamma + b2 * b2 / 24.f);
      }
    }
    __syncthreads();
  }
  for (int q = 0; q < N_STEP; ++q) {
    const float bs = block_sum(acc[q], fbuf);
    if (tid == 0) __stcg(spart + q, bs);
  }
}

// Sum the flow partials of n_items work items in item order (threads
// 0..12, every other thread idles), then omega, v (thread 0). wv: omega
// (3), v (3); nnz: the keep count. The partials are read past L1 (they
// were written by other blocks). Ends with __syncthreads.
__device__ void finalize_flow(const float* fpart, const int* npart,
                              int n_items, float c, float d, float* S,
                              float* wv, int* nnz) {
  const int q = threadIdx.x;
  if (q < N_FLOW) {
    float acc = 0.f;
    for (int b = 0; b < n_items; ++b) acc += __ldcg(fpart + b * N_FLOW + q);
    S[q] = acc;
  } else if (q == N_FLOW) {
    int n = 0;
    for (int b = 0; b < n_items; ++b) n += __ldcg(npart + b);
    *nnz = n;
  }
  __syncthreads();
  if (q == 0) {
    // S[3a + b] = sum_i x_a d_b; (x x d)_0 = x_1 d_2 - x_2 d_1, ...
    wv[0] = (S[1 * 3 + 2] - S[2 * 3 + 1]) / c;
    wv[1] = (S[2 * 3 + 0] - S[0 * 3 + 2]) / c;
    wv[2] = (S[0 * 3 + 1] - S[1 * 3 + 0]) / c;
    for (int b = 0; b < 3; ++b) wv[3 + b] = S[9 + b] / d;
  }
  __syncthreads();
}

// Sum the step partials in item order (threads 0..3). Ends with
// __syncthreads.
__device__ void finalize_step(const float* spart, int n_items, float* bcde) {
  const int q = threadIdx.x;
  if (q < N_STEP) {
    float acc = 0.f;
    for (int b = 0; b < n_items; ++b) acc += __ldcg(spart + b * N_STEP + q);
    bcde[q] = acc;
  }
  __syncthreads();
}

}  // namespace
