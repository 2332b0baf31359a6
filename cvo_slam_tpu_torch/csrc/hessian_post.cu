// Hessian epilogue of the inner products, for sm_90a.
//
// hessian_post_launch replaces no Pallas kernel. It is the JAX package's
// plain hessian_postprocess (cvo_slam_tpu/cvo/engine.py:264, the eigenvalue
// floor of se3_Hessian, cvo.cpp:726-754), which XLA runs there as fused
// device ops and a while loop. Its plain PyTorch version
// (cvo/kernels.hessian_post_plain: ops/jacobi.eigvalsh_jacobi, one copy of
// the eigenvalues to the host and a float32 shift loop there) issues ~1530
// launches and one synchronisation per call, which on this card set the
// time of a tracked frame; this kernel does the same work in one launch.
//
// For each lane l of a stack (S, 6, 6):
//   H    = H_raw[l] * scale;
//   lam  = the diagonal after 8 fixed Jacobi sweeps of (H + H^T) * 0.5;
//   the shift loop: at most 64 times, while |lam_min| < floor (lam_min the
//        eigenvalue of least |lam|, numpy's argmin: the first such index,
//        or the first NaN), shift = 1 - lam_min, lam += shift, total +=
//        shift;
//   post = inliers[l] > 0 ? H + total * I : I.
// It writes post (S, 6, 6) and total (S,).
//
// What bounds it: latency. A lane is 40 dependent rotation rounds (8 sweeps
// of the 5 rounds of a 6x6's round-robin schedule, each a division and two
// square roots on the round's three pairs, then 72 products and sums a
// mixing) and a few shift steps; it reads 148 bytes and writes 148 a lane.
// Bytes and flops are negligible at any lane count the port uses.
//
// The design: one thread per lane, the 6x6 in 36 registers, the schedule of
// ops/jacobi._round_robin_pairs(6) as template arguments (straight-line
// code, no shared memory, no synchronisation).
//
// Bit for bit with the plain version on the card: -fmad=false, IEEE
// division and square roots (no fast-math flags), and each of torch's
// elementwise ops repeated one for one: the constants as torch casts them
// to float32 (1e-30f, the scale, 0.5f), c as torch's reciprocal of the
// square root, torch.sign as c10::signum ((0 < x) - (x < 0), so sign(-0)
// is 0), every one of the 36 entries updated (the plain path's matrix need
// not stay exactly symmetric), rows mixed and then columns, each entry as
// two rounded products and their rounded sum, the shift added as
// H + total * (1 or 0).

#include <cuda_runtime.h>

namespace {

constexpr int N = 6;
constexpr int SWEEPS = 8;
constexpr int MAX_STEPS = 64;
constexpr int THREADS = 64;

// One round: rotate the disjoint pairs (P0, Q0), (P1, Q1), (P2, Q2) at once,
// A <- G^T A G with G[p][p] = G[q][q] = c, G[p][q] = s, G[q][p] = -s.
template <int P0, int Q0, int P1, int Q1, int P2, int Q2>
__device__ __forceinline__ void jacobi_round(float (&a)[N * N]) {
  constexpr int ps[3] = {P0, P1, P2};
  constexpr int qs[3] = {Q0, Q1, Q2};
  float c[3], s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int p = ps[k], q = qs[k];
    const float apq = a[p * N + q];
    const float app = a[p * N + p];
    const float aqq = a[q * N + q];
    // Rutishauser's stable rotation: t = sign(tau)/(|tau|+sqrt(1+tau^2))
    const bool small = fabsf(apq) < 1e-30f;
    const float denom = small ? 1.0f : 2.0f * apq;
    const float tau = (aqq - app) / denom;
    const float sg = (float)((0.0f < tau) - (tau < 0.0f));
    const float t = sg / (fabsf(tau) + sqrtf(1.0f + tau * tau));
    const float ck = (1.0f / sqrtf(t * t + 1.0f)) * 1.0f;
    const float sk = t * ck;
    c[k] = small ? 1.0f : ck;
    s[k] = small ? 0.0f : sk;
  }
  // rows: row p of G^T A is c A_p - s A_q, row q is c A_q + s A_p
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int p = ps[k], q = qs[k];
    const float sp = s[k] * -1.0f, sq = s[k] * 1.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float ap = a[p * N + j], aq = a[q * N + j];
      a[p * N + j] = c[k] * ap + sp * aq;
      a[q * N + j] = c[k] * aq + sq * ap;
    }
  }
  // columns, the same on (G^T A) G
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int p = ps[k], q = qs[k];
    const float sp = s[k] * -1.0f, sq = s[k] * 1.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float ap = a[i * N + p], aq = a[i * N + q];
      a[i * N + p] = ap * c[k] + aq * sp;
      a[i * N + q] = aq * c[k] + ap * sq;
    }
  }
}

// numpy's argmin of |lam|: the first index of the least, or of the first NaN
__device__ __forceinline__ int argmin_abs(const float (&lam)[N]) {
  int best = 0;
  float least = fabsf(lam[0]);
  if (isnan(least)) return 0;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const float v = fabsf(lam[k]);
    if (isnan(v)) return k;
    if (v < least) {
      least = v;
      best = k;
    }
  }
  return best;
}

__global__ void __launch_bounds__(THREADS)
hessian_post_kernel(const float* __restrict__ h_raw,
                    const int* __restrict__ inliers, int lanes,
                    int inliers_stride, float scale, float floor_abs,
                    float* __restrict__ post, float* __restrict__ totals) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= lanes) return;
  const float* h = h_raw + (size_t)l * N * N;
  float a[N * N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      a[i * N + j] = (h[i * N + j] * scale + h[j * N + i] * scale) * 0.5f;
  // ops/jacobi._round_robin_pairs(6)
#pragma unroll 1
  for (int sweep = 0; sweep < SWEEPS; ++sweep) {
    jacobi_round<0, 5, 1, 4, 2, 3>(a);
    jacobi_round<0, 4, 1, 2, 3, 5>(a);
    jacobi_round<0, 3, 1, 5, 2, 4>(a);
    jacobi_round<0, 2, 1, 3, 4, 5>(a);
    jacobi_round<0, 1, 2, 5, 3, 4>(a);
  }
  float lam[N];
#pragma unroll
  for (int i = 0; i < N; ++i) lam[i] = a[i * N + i];
  float total = 0.0f;
  for (int step = 0; step < MAX_STEPS; ++step) {
    const float lam_min = lam[argmin_abs(lam)];
    if (!(fabsf(lam_min) < floor_abs)) break;
    const float shift = 1.0f - lam_min;
#pragma unroll
    for (int k = 0; k < N; ++k) lam[k] = lam[k] + shift;
    total = total + shift;
  }
  totals[l] = total;
  const bool keep = inliers[(size_t)l * inliers_stride] > 0;
  float* out = post + (size_t)l * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      out[i * N + j] = keep ? h[i * N + j] * scale + total * eye : eye;
    }
}

}  // namespace

// Launches the epilogue of `lanes` lanes on `stream`: h_raw (lanes, 6, 6)
// contiguous f32, inliers (lanes,) i32 `inliers_stride` elements apart;
// writes post (lanes, 6, 6) and totals (lanes,). Returns the launch error.
extern "C" int hessian_post_launch(const float* h_raw, const int* inliers,
                                   int lanes, int inliers_stride, float scale,
                                   float floor_abs, float* post,
                                   float* totals, cudaStream_t stream) {
  if (lanes < 0) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return (int)cudaSuccess;
  const int blocks = (lanes + THREADS - 1) / THREADS;
  hessian_post_kernel<<<blocks, THREADS, 0, stream>>>(
      h_raw, inliers, lanes, inliers_stride, scale, floor_abs, post, totals);
  return (int)cudaGetLastError();
}
