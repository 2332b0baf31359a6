// Inner-product suite of compute_innerproduct, for sm_90a.
//
// ip_suite_launch replaces: cvo_slam_tpu/cvo/pallas_kernels.py:ip_suite (kernel body
// _ip_suite_kernel), whose XLA twin is ops/pairwise.py:ip_suite. For four
// pair sets — pre (y vs x), post (yt vs x), fixed (x vs x), moving (y vs y)
// — it sums the gated joint kernel ck * k and counts the gated pairs (no
// sp_thres test, cvo.cpp:416-447); over the post set it also forms the
// 13x13 Hessian moment matrix G = U(yt)^T W U(x) with
// W_ij = gate * sigma^2 exp(max(-d2 / 2 ell^2, -20)) * (fy_j . fx_i) and
// U = [1, p, vec(p p^T)]. inliers = the post count.
//
// Gate decisions follow the pairwise.ip_suite formulation exactly:
// d2 = max(|a|^2 + |b|^2 - 2 a.b, 0) in full fp32, the dot products a chain
// of fused multiply-adds coordinate by coordinate (the rounding of XLA's
// f32 dot). The file is compiled with -fmad=false so every other operation
// rounds as in the plain PyTorch version, and the counts agree exactly.
//
// What bounds it: arithmetic. At CAP 3072 one launch visits 4 x 9.4 M
// pairs (~30 operations for the two distances of each, two exponentials
// for a gated pair) plus 13 multiply-adds of W U(x) for each gated post
// pair, and reads ~0.3 MB. The design:
//   * pass 1: one thread owns one row (moving point j for pre / post / G,
//     fixed point j for the fixed self set); tiles of TILE columns of x,
//     then of y, are staged in shared memory with their squared norms, and
//     every thread reads the same column at once. Per thread the 4 sums,
//     4 counts and the 13 entries of (W U(x))_j live in registers. The
//     column range is split into gridDim.y chunks to fill the SMs. Each
//     block reduces its sums and counts in a fixed tree order and writes
//     one partial; each thread writes its 13 W U(x) partials;
//   * pass 2: per block of rows, G_partial = U(yt)^T (sum over chunks, in
//     chunk order, of W U(x));
//   * pass 3: one block sums the partials of G, the sums and the counts in
//     a fixed order.
// No float atomics anywhere: two runs give bitwise-equal results.
// Any capacity works: rows and columns past the end are masked.

#include "pair_math.cuh"

namespace {

constexpr int NU = 13;
constexpr int NG = NU * NU;

__device__ __forceinline__ float lift(const float* p, int a) {
  if (a == 0) return 1.f;
  if (a < 4) return p[a - 1];
  const int q = a - 4;
  return p[q / 3] * p[q % 3];
}

__global__ void __launch_bounds__(TILE)
suite_pass(const float* __restrict__ x, const float* __restrict__ fx,
           const unsigned char* __restrict__ mx,
           const float* __restrict__ y, const float* __restrict__ fy,
           const unsigned char* __restrict__ my,
           const float* __restrict__ yt, const float* __restrict__ ell_ptr,
           int N, int M, int x_tiles_per_chunk, int y_tiles_per_chunk,
           Consts k, float* __restrict__ sum_part, int* __restrict__ cnt_part,
           float* __restrict__ wu_part) {
  __shared__ float cp[3][TILE];
  __shared__ float cf[5][TILE];
  __shared__ float csq[TILE];
  __shared__ float cfsq[TILE];
  __shared__ unsigned char cm[TILE];
  __shared__ float fbuf[TILE];
  __shared__ int ibuf[TILE];

  const int tid = threadIdx.x;
  const int r = blockIdx.x * TILE + tid;
  const int chunk = blockIdx.y;
  const float ell = *ell_ptr;
  const float d2t = -2.f * ell * ell * k.log_ratio;
  const float den = 2.f * ell * ell;

  // moving row r: y, yt, fy
  const bool mrow = r < M && my[r] != 0;
  float yr[3] = {0.f, 0.f, 0.f}, ytr[3] = {0.f, 0.f, 0.f};
  float fyr[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (r < M) {
    for (int c = 0; c < 3; ++c) yr[c] = y[r * 3 + c];
    for (int c = 0; c < 3; ++c) ytr[c] = yt[r * 3 + c];
    for (int c = 0; c < 5; ++c) fyr[c] = fy[r * 5 + c];
  }
  const float yy = sq3(yr), ytyt = sq3(ytr), fyy = sq5(fyr);
  // fixed row r: x, fx
  const bool xrow = r < N && mx[r] != 0;
  float xr[3] = {0.f, 0.f, 0.f};
  float fxr[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (r < N) {
    for (int c = 0; c < 3; ++c) xr[c] = x[r * 3 + c];
    for (int c = 0; c < 5; ++c) fxr[c] = fx[r * 5 + c];
  }
  const float xx = sq3(xr), fxx = sq5(fxr);

  float s_pre = 0.f, s_post = 0.f, s_fix = 0.f, s_mov = 0.f;
  int n_pre = 0, n_post = 0, n_fix = 0, n_mov = 0;
  float wu[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) wu[a] = 0.f;

  // ---- columns of x: pre, post (+ W U(x)), fixed self --------------------
  const int nxt = (N + TILE - 1) / TILE;
  const int xt0 = chunk * x_tiles_per_chunk;
  const int xt1 = min(xt0 + x_tiles_per_chunk, nxt);
  for (int t = xt0; t < xt1; ++t) {
    const int i = t * TILE + tid;
    const bool in = i < N;
    float p[3], f[5];
    for (int c = 0; c < 3; ++c) p[c] = in ? x[i * 3 + c] : 0.f;
    for (int c = 0; c < 5; ++c) f[c] = in ? fx[i * 5 + c] : 0.f;
    for (int c = 0; c < 3; ++c) cp[c][tid] = p[c];
    for (int c = 0; c < 5; ++c) cf[c][tid] = f[c];
    csq[tid] = sq3(p);
    cfsq[tid] = sq5(f);
    cm[tid] = in ? mx[i] : 0;
    __syncthreads();
    for (int kk = 0; kk < TILE; ++kk) {
      if (!cm[kk]) continue;
      if (mrow) {
        const float cdot = col_dot(fyr, cf, kk, 5);
        const float d2c = fmaxf(fyy + cfsq[kk] - 2.f * cdot, 0.f);
        if (d2c < k.d2ct) {
          const float ck = clamped_kernel(k.cs2, -d2c / k.two_cl2);
          const float d2_pre = ident_d2(yy, csq[kk], yr, cp, kk, 3);
          if (d2_pre < d2t) {
            const float kv = clamped_kernel(k.s2, -d2_pre / den);
            s_pre += ck * kv;
            ++n_pre;
          }
          const float d2_post = ident_d2(ytyt, csq[kk], ytr, cp, kk, 3);
          if (d2_post < d2t) {
            const float kv = clamped_kernel(k.s2, -d2_post / den);
            s_post += ck * kv;
            ++n_post;
            const float w = kv * cdot;
            const float px[3] = {cp[0][kk], cp[1][kk], cp[2][kk]};
#pragma unroll
            for (int a = 0; a < NU; ++a) wu[a] += w * lift(px, a);
          }
        }
      }
      if (xrow) {
        const float d2c = ident_d2(fxx, cfsq[kk], fxr, cf, kk, 5);
        if (d2c < k.d2ct) {
          const float d2 = ident_d2(xx, csq[kk], xr, cp, kk, 3);
          if (d2 < d2t) {
            const float ck = clamped_kernel(k.cs2, -d2c / k.two_cl2);
            const float kv = clamped_kernel(k.s2, -d2 / den);
            s_fix += ck * kv;
            ++n_fix;
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- columns of y: moving self ----------------------------------------
  const int nyt = (M + TILE - 1) / TILE;
  const int yt0 = chunk * y_tiles_per_chunk;
  const int yt1 = min(yt0 + y_tiles_per_chunk, nyt);
  for (int t = yt0; t < yt1; ++t) {
    const int i = t * TILE + tid;
    const bool in = i < M;
    float p[3], f[5];
    for (int c = 0; c < 3; ++c) p[c] = in ? y[i * 3 + c] : 0.f;
    for (int c = 0; c < 5; ++c) f[c] = in ? fy[i * 5 + c] : 0.f;
    for (int c = 0; c < 3; ++c) cp[c][tid] = p[c];
    for (int c = 0; c < 5; ++c) cf[c][tid] = f[c];
    csq[tid] = sq3(p);
    cfsq[tid] = sq5(f);
    cm[tid] = in ? my[i] : 0;
    __syncthreads();
    if (mrow) {
      for (int kk = 0; kk < TILE; ++kk) {
        if (!cm[kk]) continue;
        const float d2c = ident_d2(fyy, cfsq[kk], fyr, cf, kk, 5);
        if (!(d2c < k.d2ct)) continue;
        const float d2 = ident_d2(yy, csq[kk], yr, cp, kk, 3);
        if (!(d2 < d2t)) continue;
        const float ck = clamped_kernel(k.cs2, -d2c / k.two_cl2);
        const float kv = clamped_kernel(k.s2, -d2 / den);
        s_mov += ck * kv;
        ++n_mov;
      }
    }
    __syncthreads();
  }

  if (r < M) {
#pragma unroll
    for (int a = 0; a < NU; ++a)
      wu_part[((size_t)chunk * NU + a) * M + r] = wu[a];
  }
  const float sums[4] = {s_pre, s_post, s_fix, s_mov};
  const int cnts[4] = {n_pre, n_post, n_fix, n_mov};
  const int part = chunk * gridDim.x + blockIdx.x;
  for (int s = 0; s < 4; ++s) {
    const float bs = block_sum(sums[s], fbuf);
    const int bc = block_count(cnts[s], ibuf);
    if (tid == 0) {
      sum_part[part * 4 + s] = bs;
      cnt_part[part * 4 + s] = bc;
    }
  }
}

// One block per TILE rows: G_partial[a][b] = sum_j U(yt_j)[a] * WU_j[b],
// WU_j summed over chunks in chunk order.
__global__ void suite_g_partial(const float* __restrict__ yt,
                                const float* __restrict__ wu_part, int M,
                                int n_chunks, float* __restrict__ g_part) {
  const int e = threadIdx.x;
  if (e >= NG) return;
  const int a = e / NU, b = e % NU;
  const int j0 = blockIdx.x * TILE;
  const int j1 = min(j0 + TILE, M);
  float acc = 0.f;
  for (int j = j0; j < j1; ++j) {
    float w = wu_part[(size_t)b * M + j];
    for (int c = 1; c < n_chunks; ++c)
      w += wu_part[((size_t)c * NU + b) * M + j];
    const float p[3] = {yt[j * 3], yt[j * 3 + 1], yt[j * 3 + 2]};
    acc += lift(p, a) * w;
  }
  g_part[blockIdx.x * NG + e] = acc;
}

// One block: out_f[0:169] = G, out_f[169:173] = the four sums,
// out_n[0:4] = the four counts, each summed over its partials in order.
__global__ void suite_finalize(const float* __restrict__ g_part,
                               int n_row_blocks,
                               const float* __restrict__ sum_part,
                               const int* __restrict__ cnt_part, int n_parts,
                               float* __restrict__ out_f,
                               int* __restrict__ out_n) {
  const int e = threadIdx.x;
  if (e < NG) {
    float s = 0.f;
    for (int b = 0; b < n_row_blocks; ++b) s += g_part[b * NG + e];
    out_f[e] = s;
  } else if (e < NG + 4) {
    const int q = e - NG;
    float s = 0.f;
    int n = 0;
    for (int b = 0; b < n_parts; ++b) {
      s += sum_part[b * 4 + q];
      n += cnt_part[b * 4 + q];
    }
    out_f[e] = s;
    out_n[q] = n;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches the three passes on
// `stream`; returns the CUDA error code of the launches (0 = success).
// Scratch sizes: sum_part and cnt_part n_chunks * ceil(max(N,M)/128) * 4,
// wu_part n_chunks * 13 * M, g_part ceil(M/128) * 169; out_f 173 floats,
// out_n 4 ints.
extern "C" int ip_suite_launch(
    const float* x, const float* fx, const unsigned char* mx, const float* y,
    const float* fy, const unsigned char* my, const float* yt,
    const float* ell, int N, int M, int n_chunks, float log_ratio, float d2ct,
    float s2, float cs2, float two_cl2, float* sum_part, int* cnt_part,
    float* wu_part, float* g_part, float* out_f, int* out_n,
    cudaStream_t stream) {
  if (N <= 0 || M <= 0 || n_chunks <= 0) return (int)cudaErrorInvalidValue;
  const int rows = N > M ? N : M;
  const dim3 grid((rows + TILE - 1) / TILE, n_chunks);
  const int nxt = (N + TILE - 1) / TILE, nyt = (M + TILE - 1) / TILE;
  const Consts k{log_ratio, d2ct, s2, cs2, two_cl2};
  suite_pass<<<grid, TILE, 0, stream>>>(
      x, fx, mx, y, fy, my, yt, ell, N, M, (nxt + n_chunks - 1) / n_chunks,
      (nyt + n_chunks - 1) / n_chunks, k, sum_part, cnt_part, wu_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  suite_g_partial<<<nyt, 192, 0, stream>>>(yt, wu_part, M, n_chunks, g_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  suite_finalize<<<1, 192, 0, stream>>>(g_part, nyt, sum_part, cnt_part,
                                        n_chunks * grid.x, out_f, out_n);
  return (int)cudaGetLastError();
}
