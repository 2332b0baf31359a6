// The moment form's O(M) epilogue and the align loop's state update, for
// sm_90a. With the moment kernel's two passes (moment_flow_step.cu) they
// make one `pallas_mom` align iteration on the card in four launches, with
// no PyTorch operation and no host read (cvo/engine.align_loop_moment_cuda).
//
// Replaces no Pallas kernel: the JAX package runs both as XLA operations
// around its moment kernel (cvo_slam_tpu/ops/pairwise.py:286
// flow_and_step_from_moments; cvo_slam_tpu/cvo/engine.py:197-247, the
// while_loop's body). Their plain PyTorch versions,
// ops/pairwise.flow_and_step_from_moments and cvo/engine._update with the
// transform of engine.align_loop, make ~1000-1400 launches an iteration.
//
// moment_epilogue_kernel: (omega, v, B, C, D, E) from the moment matrix Mom
//   (M, 35) of the moved cloud y (M, 3), the fixed cloud's centroid and
//   ell, as ops/pairwise.flow_and_step_from_moments computes them. Per
//   moving point j:
//     D_j = Mom[j, 1:4] - (y_j - center) Mom[j, 0],
//     v = -(1/d) sum_j D_j,  omega = (1/c) sum_j D_j x y_j;
//   then the affine Taylor factors beta, gamma, delta, epsilon of the step
//   expansion in xt = x - center, and the per-j quartic polynomials
//     PB = beta,  PC = gamma + beta^2/2,  PD = delta + beta gamma + beta^3/6,
//     PE = epsilon + beta delta + beta^2 gamma/2 + gamma^2/2 + beta^4/24,
//   each contracted with Mom[j, :] (the moments of xt up to degree 4) term
//   by term: a product P Q contracts as sum_{m in P, n in Q} P_m Q_n
//   Mom[j, m + n] over their monomials, so only beta^2 is expanded into
//   coefficients; B..E are the sums over j.
//   A cooperative launch of ceil(M / EPI_THREADS) blocks, one moving point
//   a thread: every block sums the flow over all of j (the same bits in
//   every block), then B..E over its own points; after the grid barrier
//   block 0 adds the blocks' sums in block order.
//
// moment_state_kernel: one iteration's state update, align_state.cuh's
//   epilogue as align_fused runs it, at iteration k (passed in, so the
//   anneal needs no read), on the alignment's state; a stopped alignment
//   stays frozen, as engine._update gates on ~done. Then the next
//   iteration's moving cloud y0 R + Tt (flow_step.cuh's move_point, as
//   align_fused stages it). With k < 0 it only takes the initial state and
//   writes the initial cloud. It writes a new state (R, T, ell, the 4x4
//   transform [R^T | -R^T T]; done, iters, nnz) and a new cloud and leaves
//   its inputs as they are, so each iteration's cloud and ell stay what
//   they were for whoever kept them (the benchmark's kernel calls).
//
// What bounds them: latency, at one wave. The epilogue spends ~700 fp32
// operations a moving point (3072 at CAP 3072) on 12 blocks, then one grid
// barrier; the state update is one thread's scalar chain (a cubic root,
// Exp_SEK3, the se3 distance), run redundantly by thread 0 of every block,
// then 3 x M products.
//
// Float32 throughout, compiled -fmad=false like its siblings, IEEE
// division and square roots, no float atomics: every sum runs in one fixed
// order, so two launches give bitwise-equal results.

#include <cooperative_groups.h>

#include "align_state.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NMOM = 35;
constexpr int EPI_THREADS = 256;   // moving points per epilogue block
constexpr int EPI_WARPS = EPI_THREADS / 32;
constexpr int STATE_THREADS = 256;

// the index of the monomial xt_0^a xt_1^b xt_2^c in ops/pairwise.
// _MONOMIALS: by degree, then the exponent of xt_0 descending, then that of
// xt_1 descending (the sorted index tuples in lexicographic order)
__host__ __device__ constexpr int mono(int a, int b, int c) {
  const int d = a + b + c;
  int i = d * (d + 1) * (d + 2) / 6;   // the monomials of lower degree
  for (int a2 = d; a2 > a; --a2) i += d - a2 + 1;
  return i + (d - a - b);
}
static_assert(mono(0, 0, 0) == 0 && mono(0, 0, 1) == 3 && mono(2, 0, 0) == 4
                  && mono(0, 2, 0) == 7 && mono(1, 1, 1) == 14
                  && mono(0, 0, 3) == 19 && mono(4, 0, 0) == 20
                  && mono(0, 0, 4) == NMOM - 1,
              "monomial order of ops/pairwise._MONOMIALS");

// f(a, b, c) for each monomial of degree <= D, in index order
template <int D, typename F>
__device__ __forceinline__ void each_mono(F&& f) {
#pragma unroll
  for (int d = 0; d <= D; ++d)
#pragma unroll
    for (int a = d; a >= 0; --a)
#pragma unroll
      for (int b = d - a; b >= 0; --b) f(a, b, d - a - b);
}

// sum_m P_m mom[m] over the monomials of P (degree <= DP)
template <int DP>
__device__ __forceinline__ float contract(const float* P, const float* mom) {
  float s = 0.f;
  each_mono<DP>([&](int a, int b, int c) {
    s += P[mono(a, b, c)] * mom[mono(a, b, c)];
  });
  return s;
}

// the contraction of the product P Q: sum_m P_m (sum_n Q_n mom[m + n])
template <int DP, int DQ>
__device__ __forceinline__ float contract(const float* P, const float* Q,
                                          const float* mom) {
  float s = 0.f;
  each_mono<DP>([&](int a, int b, int c) {
    float t = 0.f;
    each_mono<DQ>([&](int e, int f, int g) {
      t += Q[mono(e, f, g)] * mom[mono(a + e, b + f, c + g)];
    });
    s += P[mono(a, b, c)] * t;
  });
  return s;
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// an affine factor const + vec . xt as the coefficients of 1, xt_0, xt_1,
// xt_2 (monomials 0..3)
__device__ __forceinline__ void affine(float k, float s, const float* u,
                                       float* out) {
  out[0] = k;
  for (int c = 0; c < 3; ++c) out[1 + c] = s * u[c];
}

// moving point j's terms of B, C, D, E
__device__ void step_terms(const float* __restrict__ mom_j, const float* yj,
                           const float* dy, const float* w, const float* v,
                           float tc, float* bcde) {
  float m[NMOM];
#pragma unroll
  for (int q = 0; q < NMOM; ++q) m[q] = __ldg(mom_j + q);
  // xiz = omega x y + v and xi{k+1}z = omega x xi{k}z
  float xz[3], x2[3], x3[3], x4[3];
  cross3(w, yj, xz);
  for (int c = 0; c < 3; ++c) xz[c] = xz[c] + v[c];
  cross3(w, xz, x2);
  cross3(w, x2, x3);
  cross3(w, x3, x4);
  const float two_tc = 2.f * tc;
  // beta = -2tc xiz . (x - y) = 2tc xiz . dy - 2tc xiz . xt, and so on
  float be[4], ga[4], de[4], ep[4];
  affine(two_tc * dot3(xz, dy), -two_tc, xz, be);
  affine(-tc * dot3(xz, xz) + two_tc * dot3(x2, dy), -two_tc, x2, ga);
  affine(-two_tc * dot3(xz, x2) + two_tc * dot3(x3, dy), -two_tc, x3, de);
  affine(-tc * (dot3(x2, x2) + 2.f * dot3(xz, x3)) + two_tc * dot3(x4, dy),
         -two_tc, x4, ep);
  // beta^2 as coefficients of the monomials of degree <= 2
  float b2[10];
  for (int q = 0; q < 10; ++q) b2[q] = 0.f;
  each_mono<1>([&](int a, int b, int c) {
    each_mono<1>([&](int e, int f, int g) {
      b2[mono(a + e, b + f, c + g)] += be[mono(a, b, c)] * be[mono(e, f, g)];
    });
  });
  bcde[0] = contract<1>(be, m);
  bcde[1] = contract<1>(ga, m) + 0.5f * contract<2>(b2, m);
  bcde[2] = contract<1>(de, m) + contract<1, 1>(be, ga, m)
            + contract<2, 1>(b2, be, m) * (1.f / 6.f);
  bcde[3] = contract<1>(ep, m) + contract<1, 1>(be, de, m)
            + 0.5f * contract<2, 1>(b2, ga, m)
            + 0.5f * contract<1, 1>(ga, ga, m)
            + contract<2, 2>(b2, b2, m) * (1.f / 24.f);
}

__global__ void __launch_bounds__(EPI_THREADS)
moment_epilogue_kernel(const float* __restrict__ mom,
                       const float* __restrict__ y,
                       const float* __restrict__ center,
                       const float* __restrict__ ell_ptr, int M, float c,
                       float d, float* __restrict__ part,
                       float* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float buf[EPI_WARPS * 6];
  __shared__ float flow[6], sums[4];
  const int tid = threadIdx.x;
  const float cen[3] = {__ldg(center), __ldg(center + 1), __ldg(center + 2)};
  // the flow (cvo.cpp:222-223) from the degree-<=1 columns, in every block
  float f[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = tid; j < M; j += EPI_THREADS) {
    const float* mj = mom + (size_t)j * NMOM;
    const float m0 = __ldg(mj);
    float yj[3], Dj[3], cr[3];
    for (int e = 0; e < 3; ++e) {
      yj[e] = __ldg(y + (size_t)j * 3 + e);
      Dj[e] = __ldg(mj + 1 + e) - (yj[e] - cen[e]) * m0;
    }
    cross3(Dj, yj, cr);
    for (int e = 0; e < 3; ++e) {
      f[e] += Dj[e];
      f[3 + e] += cr[e];
    }
  }
  block_sum_n<EPI_WARPS>(f, buf, flow);
  const float v[3] = {-flow[0] / d, -flow[1] / d, -flow[2] / d};
  const float w[3] = {flow[3] / c, flow[4] / c, flow[5] / c};
  // the step coefficients (cvo.cpp:239-315) of this block's points
  const float ell = __ldg(ell_ptr);
  const float tc = 1.f / (2.f * ell * ell);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = blockIdx.x * EPI_THREADS + tid; j < M;
       j += gridDim.x * EPI_THREADS) {
    float yj[3], dy[3], t[4];
    for (int e = 0; e < 3; ++e) {
      yj[e] = __ldg(y + (size_t)j * 3 + e);
      dy[e] = yj[e] - cen[e];
    }
    step_terms(mom + (size_t)j * NMOM, yj, dy, w, v, tc, t);
    for (int q = 0; q < 4; ++q) s[q] += t[q];
  }
  block_sum_n<EPI_WARPS>(s, buf, sums);
  if (tid < 4) part[blockIdx.x * 4 + tid] = sums[tid];
  __threadfence();
  grid.sync();
  if (blockIdx.x == 0) {
    if (tid < 4) {
      float t = part[tid];
      for (int b = 1; b < (int)gridDim.x; ++b) t += part[b * 4 + tid];
      out[6 + tid] = t;
    } else if (tid < 7) {
      out[tid - 4] = w[tid - 4];
    } else if (tid < 10) {
      out[tid - 4] = v[tid - 7];
    }
  }
}

__global__ void __launch_bounds__(STATE_THREADS)
moment_state_kernel(const float* __restrict__ R, const float* __restrict__ T,
                    const float* __restrict__ ell, const int* __restrict__ n,
                    const float* __restrict__ omega,
                    const float* __restrict__ v, const float* __restrict__ B,
                    const float* __restrict__ C, const float* __restrict__ D,
                    const float* __restrict__ E,
                    const int* __restrict__ nnz_k, int k, AlignParams prm,
                    const float* __restrict__ y0, int M,
                    float* __restrict__ st_f, int* __restrict__ st_n,
                    float* __restrict__ y) {
  __shared__ Pose pose;
  if (threadIdx.x == 0) {
    State st;
    for (int i = 0; i < 9; ++i) st.R[i] = R[i];
    for (int i = 0; i < 3; ++i) st.T[i] = T[i];
    st.ell = *ell;
    st.done = n ? n[0] : 0;
    st.iters = n ? n[1] : prm.max_iter;
    st.nnz = n ? n[2] : 0;
    if (k >= 0 && !st.done) {
      const float wv[6] = {omega[0], omega[1], omega[2], v[0], v[1], v[2]};
      const float bcde[4] = {*B, *C, *D, *E};
      epilogue(st, k, wv, *nnz_k, bcde, prm);
    }
    pose = pose_of(st);
    if (blockIdx.x == 0) {
      for (int i = 0; i < 9; ++i) st_f[i] = st.R[i];
      for (int i = 0; i < 3; ++i) st_f[9 + i] = st.T[i];
      st_f[12] = st.ell;
      // the transform [R^T | -R^T T] (update_tf, cvo.cpp:106-110, :817)
      float* tf = st_f + 13;
      for (int r = 0; r < 3; ++r) {
        for (int q = 0; q < 3; ++q) tf[4 * r + q] = st.R[3 * q + r];
        tf[4 * r + 3] = pose.Tt[r];
      }
      for (int q = 0; q < 4; ++q) tf[12 + q] = q == 3 ? 1.f : 0.f;
      st_n[0] = st.done;
      st_n[1] = st.iters;
      st_n[2] = st.nnz;
    }
  }
  __syncthreads();
  for (int i = blockIdx.x * STATE_THREADS + threadIdx.x; i < M;
       i += gridDim.x * STATE_THREADS) {
    float q[3] = {y0[3 * (size_t)i], y0[3 * (size_t)i + 1],
                  y0[3 * (size_t)i + 2]};
    move_point(pose, q);
    for (int e = 0; e < 3; ++e) y[3 * (size_t)i + e] = q[e];
  }
}

// the resident blocks of the epilogue kernel (per SM x SMs), once per
// device; refuses a card without cooperative launch
cudaError_t epilogue_resident(int* blocks) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, moment_epilogue_kernel, EPI_THREADS, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  if (dev < 64) cached[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

// Plain C entry point (loaded with ctypes): the moment epilogue, one
// cooperative launch on `stream`. mom (M, 35), y (M, 3), center (3), ell (a
// float on the device), c and d the flow's scales; part: 4 floats for each
// of ceil(M / 256) blocks (scratch); out (10 floats): omega, v, B, C, D, E.
// Returns the CUDA error code (0 = success).
extern "C" int moment_epilogue_launch(const float* mom, const float* y,
                                      const float* center, const float* ell,
                                      int M, float c, float d, float* part,
                                      float* out, cudaStream_t stream) {
  if (M < 0) return (int)cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t err = epilogue_resident(&resident);
  if (err != cudaSuccess) return (int)err;
  int grid = (M + EPI_THREADS - 1) / EPI_THREADS;
  if (grid < 1) grid = 1;
  if (grid > resident) grid = resident;
  void* args[] = {(void*)&mom, (void*)&y,    (void*)&center,
                  (void*)&ell, (void*)&M,    (void*)&c,
                  (void*)&d,   (void*)&part, (void*)&out};
  err = cudaLaunchCooperativeKernel((const void*)moment_epilogue_kernel,
                                    dim3(grid), dim3(EPI_THREADS), args, 0,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Plain C entry point (loaded with ctypes): one state update on `stream`.
// The state in: R (9 floats, row-major), T (3), ell (1) and n (3 ints:
// done, iters, nnz), all on the device; n null for the initial state
// (done 0, iters max_iter, nnz 0). omega (3 floats), v (3), B, C, D, E (1
// each) and nnz_k (1 int), each anywhere on the device: the iteration's
// pass output, read when k >= 0; k < 0 only takes the state. hf (14
// floats) and hi (5 ints) on the host, as align_fused_launch takes them
// (align_state.cuh's align_params). y0 (M, 3) the moving cloud. Out: st_f (29 floats: R, T, ell, the 4x4 transform),
// st_n (3 ints: done, iters, nnz), y (M, 3) the moved cloud. Returns the
// CUDA error code (0 = success).
extern "C" int moment_state_launch(const float* R, const float* T,
                                   const float* ell, const int* n,
                                   const float* omega, const float* v,
                                   const float* B, const float* C,
                                   const float* D, const float* E,
                                   const int* nnz_k, int k, const float* hf,
                                   const int* hi, const float* y0, int M,
                                   float* st_f, int* st_n, float* y,
                                   cudaStream_t stream) {
  if (M < 0 || (k >= 0 && (!omega || !v || !B || !C || !D || !E || !nnz_k
                           || !n)))
    return (int)cudaErrorInvalidValue;
  const AlignParams prm = align_params(hf, hi);
  int grid = (M + STATE_THREADS - 1) / STATE_THREADS;
  if (grid < 1) grid = 1;
  moment_state_kernel<<<grid, STATE_THREADS, 0, stream>>>(
      R, T, ell, n, omega, v, B, C, D, E, nnz_k, k, prm, y0, M, st_f, st_n,
      y);
  return (int)cudaGetLastError();
}
