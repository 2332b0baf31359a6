// The whole CVO align loop (cvo.cpp:763-821) in one launch, for sm_90a.
//
// Replaces: cvo_slam_tpu/cvo/pallas_align.py:align_fused (kernel body
// _align_kernel), the align of the `pallas` backend and of loop-closure
// verification under `pallas` and `pallas_iter`. Its plain PyTorch version
// is cvo/kernels.align_fused_plain: engine.align_loop over
// ops/pairwise.flow_and_step, ops/cubic and ops/se3.
//
// A persistent cooperative kernel: the grid is at most as large as the
// card can hold at once (occupancy x SMs), launched with
// cudaLaunchCooperativeKernel, and every block loops over the work items
// (row tile x column chunk, flow_step.cuh) of both passes. Per iteration:
//   1. every block transforms the moving columns it stages, y = y0 R + Tt
//      with Tt = -R^T T, with no global write;
//   2. pass 1 (flow_step.cuh): the gate sweep, the keep bitmask and the
//      flow partials; grid.sync();
//   3. every block sums the flow partials in the same fixed order, so every
//      block holds bit-identical omega, v and nnz;
//   4. pass 2 over the set bits of the bitmask, partials, grid.sync();
//   5. every block sums B..E and runs the scalar epilogue redundantly on
//      thread 0: the smallest positive root of the step cubic (cvo.cpp:
//      317-333), Exp_SEK3 (LieGroup.cpp:159-186), the se3 distance of the
//      increment (cvo.cpp:94-104), both stop rules and the ell anneal
//      (cvo.cpp:782, :804, :810-812). Every block reaches the same `done`,
//      so no third barrier is needed: the next iteration's pass 1 writes
//      flow partials and bitmask words that every block finished reading
//      before step 4's barrier, and pass 2 writes step partials only after
//      the next pass-1 barrier.
// The epilogue mirrors pallas_align.py:67-181 (and the plain ops/cubic,
// ops/se3) with CUDA's acosf and cbrtf. Every tile is computed: the Pallas
// kernel's tile skipping is left to a later optimisation (skipped tiles
// hold no gated pair, so the result is the same).
//
// What bounds it: arithmetic, as flow_step.cu, times the iterations; the
// clouds (~0.2 MB) and the bitmask (1.2 MB at CAP 3072) stay in L2.
//
// The design, against what held the first version back:
//   1. the card is filled: the plan (cvo/kernels.plan_split) sizes the
//      work items to the resident grid that align_fused_geometry reports
//      (occupancy x SMs), so roughly every resident block has one item
//      (576 items at CAP 3072, where the first version's 192 blocks left
//      most of the card empty);
//   2. the gate is tested once per iteration: pass 1 records the kept
//      pairs in the bitmask and pass 2 walks only its set bits (0.14% of
//      the pairs at ell 0.15), in a fixed order;
//   3. the finalize is parallel: all threads of every block sum the
//      partials, a fixed strided share each, then the block's tree; every
//      block gets bit-identical sums;
//   4. rows are register-blocked and column tiles packed and staged with
//      double-buffered cp.async (flow_step.cuh);
//   5. no tensor cores: the gate's d^2 must round as the FMA chain of the
//      plain version, and the kept-pair sums are too sparse for an MMA.

#include <cooperative_groups.h>

#include "flow_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float PI_F = 3.14159265358979323846f;
constexpr float BIG = 3.0e38f;
constexpr float TOL = 1e-6f;   // LieGroup.cpp:18

struct AlignParams {
  Consts k;
  float c, d, eps, eps_2, min_step, max_step;
  float anneal_value[3];
  int anneal_iter[3];
  int max_iter;
};

// smallest positive real root of a s^3 + b s^2 + c s + d, else fallback;
// clamped at `clamp` (ops/cubic.min_positive_root_or)
__device__ float min_pos_root(float a, float b, float c, float d,
                              float fallback, float clamp) {
  const bool lead = fabsf(a) > 0.f;
  const float safe_a = lead ? a : 1.f;
  const float p = b / safe_a, q = c / safe_a, r = d / safe_a;
  const float pt = q - p * p / 3.f;
  const float qt = 2.f * (p * p * p) / 27.f - p * q / 3.f + r;
  const float h = qt / 2.f, g = pt / 3.f;
  const float disc = h * h + g * g * g;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float t_single = cbrtf(-qt / 2.f + sq) + cbrtf(-qt / 2.f - sq);
  const float m = fmaxf(-pt / 3.f, 1e-30f);
  const float sm = sqrtf(m);
  const float pt_safe = fabsf(pt) > 1e-30f ? pt : -3.f * m;
  const float cos_arg =
      fminf(fmaxf(3.f * qt / (2.f * pt_safe * sm), -1.f), 1.f);
  const float ang = acosf(cos_arg) / 3.f;
  const bool three = disc <= 0.f;
  float best = BIG;
  for (int kk = 0; kk < 3; ++kk) {
    float root;
    if (three)
      root = 2.f * sm * cosf(ang - 2.f * PI_F * kk / 3.f) - p / 3.f;
    else
      root = kk == 0 ? t_single - p / 3.f : BIG;
    if (!lead) root = BIG;
    if (root > 0.f) best = fminf(best, root);
  }
  return fminf(best < 0.5f * BIG ? best : fallback, clamp);
}

// c0 I + c1 skew(w) + c2 skew(w)^2, row-major (skew^2 = w w^T - |w|^2 I)
__device__ void so3_terms(const float* w, float c0, float c1, float c2,
                          float* M) {
  const float ww = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  M[0] = c0 + c2 * (w[0] * w[0] - ww);
  M[1] = c1 * (-w[2]) + c2 * w[0] * w[1];
  M[2] = c1 * w[1] + c2 * w[0] * w[2];
  M[3] = c1 * w[2] + c2 * w[0] * w[1];
  M[4] = c0 + c2 * (w[1] * w[1] - ww);
  M[5] = c1 * (-w[0]) + c2 * w[1] * w[2];
  M[6] = c1 * (-w[1]) + c2 * w[0] * w[2];
  M[7] = c1 * w[0] + c2 * w[1] * w[2];
  M[8] = c0 + c2 * (w[2] * w[2] - ww);
}

__device__ void matvec3(const float* M, const float* v, float* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2];
}

// Exp_SEK3(w, v, dt) (ops/se3.exp_sek3): dR, dT
__device__ void exp_sek3(const float* w, const float* v, float dt, float* dR,
                         float* dT) {
  const float theta = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  float Jl[9];
  if (theta >= TOL) {
    const float st = sinf(dt * theta), ct = cosf(dt * theta);
    const float one_m_ct_t2 = (1.f - ct) / (theta * theta);
    so3_terms(w, 1.f, st / theta, one_m_ct_t2, dR);
    so3_terms(w, dt, one_m_ct_t2,
              (dt * theta - st) / (theta * theta * theta), Jl);
  } else {
    so3_terms(w, 1.f, 0.f, 0.f, dR);
    so3_terms(w, dt, 0.f, 0.f, Jl);
  }
  matvec3(Jl, v, dT);
}

// Frobenius norm of the 4x4 matrix log of (R, t) (ops/se3.dist_se3)
__device__ float dist_se3(const float* R, const float* t) {
  const float tr = R[0] + R[4] + R[8];
  const float theta = acosf(fminf(fmaxf(0.5f * (tr - 1.f), -1.f), 1.f));
  float w[3] = {0.f, 0.f, 0.f};
  if (theta >= TOL) {
    const float coef = theta / (2.f * sinf(theta));
    w[0] = coef * (R[7] - R[5]);
    w[1] = coef * (R[2] - R[6]);
    w[2] = coef * (R[3] - R[1]);
  }
  const float tw = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  float J[9];
  if (tw >= TOL)
    so3_terms(w, 1.f, -0.5f,
              1.f / (tw * tw) - (1.f + cosf(tw)) / (2.f * tw * sinf(tw)), J);
  else
    so3_terms(w, 1.f, 0.f, 0.f, J);
  float u[3];
  matvec3(J, t, u);
  return sqrtf(2.f * (w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
               + (u[0] * u[0] + u[1] * u[1] + u[2] * u[2]));
}

// the loop state every block keeps (identically) in shared memory
struct State {
  float R[9], T[3], ell;
  int done, iters, nnz;
};

// one iteration's epilogue (thread 0 of each block)
__device__ void epilogue(State& st, int k, const float* wv, int nnz_k,
                         const float* bcde, const AlignParams& prm) {
  const float* w = wv;
  const float* v = wv + 3;
  const float step = min_pos_root(4.f * bcde[3], 3.f * bcde[2],
                                  2.f * bcde[1], bcde[0], prm.min_step,
                                  prm.max_step);
  // stop 1: flow norms below eps (cvo.cpp:782), before the update
  const bool stop1 = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]) < prm.eps
      && sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]) < prm.eps;
  float dR[9], dT[3];
  exp_sek3(w, v, step, dR, dT);
  bool stop2 = false;
  if (!stop1) {
    float RdT[3], Rn[9];
    matvec3(st.R, dT, RdT);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Rn[3 * i + j] = st.R[3 * i] * dR[j] + st.R[3 * i + 1] * dR[3 + j]
                        + st.R[3 * i + 2] * dR[6 + j];
    for (int i = 0; i < 3; ++i) st.T[i] = RdT[i] + st.T[i];
    for (int i = 0; i < 9; ++i) st.R[i] = Rn[i];
    // stop 2: se3 distance of the increment below eps_2 (cvo.cpp:804)
    stop2 = dist_se3(dR, dT) < prm.eps_2;
  }
  st.nnz = nnz_k;
  if (stop1 || stop2) {
    st.done = 1;
    st.iters = k;
    return;   // the anneal follows the break (cvo.cpp:810-812)
  }
  for (int i = 0; i < 3; ++i)
    if (k > prm.anneal_iter[i]) st.ell = prm.anneal_value[i];
}

// at most 102 registers, so 5 blocks fit on an SM and the 576 work items at
// CAP 3072 run at once on 132 SMs (unbounded, ptxas takes 128 registers and
// 4 blocks per SM: 37.8 against 33.5 us per iteration on the H100)
__global__ void __launch_bounds__(THREADS, 5)
align_kernel(Clouds cl, Split sp, const float* __restrict__ init,
             AlignParams prm, unsigned* __restrict__ bits,
             float* __restrict__ fpart, int* __restrict__ npart,
             float* __restrict__ spart, float* __restrict__ out_f,
             int* __restrict__ out_n) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Stage s;
  __shared__ RowColours rows;
  __shared__ Red red;
  __shared__ State st;
  __shared__ float wv[6], bcde[N_STEP];
  __shared__ int nnz_k;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 9; ++i) st.R[i] = init[i];
    for (int i = 0; i < 3; ++i) st.T[i] = init[9 + i];
    st.ell = init[12];
    st.done = 0;
    st.iters = prm.max_iter;
    st.nnz = 0;
  }
  __syncthreads();

  for (int k = 0; k < prm.max_iter; ++k) {
    Pose pose;
    for (int i = 0; i < 9; ++i) pose.R[i] = st.R[i];
    for (int i = 0; i < 3; ++i)
      pose.Tt[i] = -(st.R[i] * st.T[0] + st.R[3 + i] * st.T[1]
                     + st.R[6 + i] * st.T[2]);
    const float ell = st.ell;
    for (int item = blockIdx.x; item < sp.items; item += gridDim.x)
      flow_item<true>(cl, sp, item, pose, ell, prm.k, s, rows, red, bits,
                      fpart, npart);
    __threadfence();
    grid.sync();
    finalize_flow(fpart, npart, sp.items, prm.c, prm.d, red, wv, &nnz_k);
    for (int item = blockIdx.x; item < sp.items; item += gridDim.x)
      step_item<true>(cl, sp, item, pose, ell, wv, wv + 3, prm.k, rows, red,
                      bits, spart);
    __threadfence();
    grid.sync();
    finalize_step(spart, sp.items, red, bcde);
    if (tid == 0) epilogue(st, k, wv, nnz_k, bcde, prm);
    __syncthreads();
    if (st.done) break;
  }
  if (blockIdx.x == 0 && tid == 0) {
    for (int i = 0; i < 9; ++i) out_f[i] = st.R[i];
    for (int i = 0; i < 3; ++i) out_f[9 + i] = st.T[i];
    out_f[12] = st.ell;
    out_n[0] = st.iters;
    out_n[1] = st.nnz;
  }
}

// the resident grid: blocks per SM of align_kernel and SMs; refuses a card
// without cooperative launch and a kernel that fits no block on an SM
cudaError_t resident(int* per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, align_kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return err;
  return *per_sm < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

}  // namespace

// Plain C entry point (loaded with ctypes): the geometry the wrapper plans
// the split with. out (4 ints): resident blocks per SM of the align kernel,
// SMs, rows per work item, columns per tile. Returns the CUDA error code.
extern "C" int align_fused_geometry(int* out) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = resident(&per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = ROWS;
  out[3] = CT;
  return (int)cudaSuccess;
}

// Plain C entry point (loaded with ctypes): one cooperative launch on
// `stream` for one alignment of the moving cloud y0/fy/my (M, each 16-byte
// aligned) against the fixed cloud x/fx/mx (N), over the split of `chunks`
// chunks of per_chunk column tiles. init (13 floats on the device): R0
// (row-major), T0, ell0. hf (host, 14 floats): log_ratio, d2ct, two_cl2,
// s2cs2, sp_thres, c, d, eps, eps_2, min_step, max_step, the 3 anneal
// values; hi (host, 4 ints): the 3 anneal iterations, max_iter. Scratch,
// items = ceil(N/512) * chunks: bits ceil(M/32) * N words, fpart 6 * items
// floats, npart items ints, spart 4 * items floats. out_f (13 floats): R,
// T, ell; out_n (2 ints): iters, nnz. info (host, 4 ints): grid, blocks
// per SM, SMs, work items. Returns the CUDA error code (0 = success); a
// card without cooperative launch, or a kernel that fits no block on an
// SM, is refused before anything runs.
extern "C" int align_fused_launch(
    const float* x, const float* fx, const unsigned char* mx,
    const float* y0, const float* fy, const unsigned char* my, int N, int M,
    int chunks, int per_chunk, const float* init, const float* hf,
    const int* hi, unsigned* bits, float* fpart, int* npart,
    float* spart, float* out_f, int* out_n, int* info,
    cudaStream_t stream) {
  Split sp;
  if (!make_split(N, M, chunks, per_chunk, sp))
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)y0) | ((uintptr_t)fy) | ((uintptr_t)my)) & 15)
    return (int)cudaErrorMisalignedAddress;
  int per_sm = 0, sms = 0;
  cudaError_t err = resident(&per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  const int grid = sp.items < per_sm * sms ? sp.items : per_sm * sms;
  info[0] = grid;
  info[1] = per_sm;
  info[2] = sms;
  info[3] = sp.items;

  AlignParams prm{};
  prm.k.log_ratio = hf[0];
  prm.k.d2ct = hf[1];
  prm.k.two_cl2 = hf[2];
  prm.k.s2cs2 = hf[3];
  prm.k.sp_thres = hf[4];
  prm.c = hf[5];
  prm.d = hf[6];
  prm.eps = hf[7];
  prm.eps_2 = hf[8];
  prm.min_step = hf[9];
  prm.max_step = hf[10];
  for (int i = 0; i < 3; ++i) {
    prm.anneal_value[i] = hf[11 + i];
    prm.anneal_iter[i] = hi[i];
  }
  prm.max_iter = hi[3];
  Clouds cl{x, fx, mx, y0, fy, my};
  void* args[] = {(void*)&cl,    (void*)&sp,    (void*)&init,
                  (void*)&prm,   (void*)&bits,  (void*)&fpart,
                  (void*)&npart, (void*)&spart, (void*)&out_f,
                  (void*)&out_n};
  err = cudaLaunchCooperativeKernel((const void*)align_kernel, dim3(grid),
                                    dim3(THREADS), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
