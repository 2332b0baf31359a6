// The align loop's state and its scalar update, shared by the two backends
// that keep the loop state on the card: align_fused.cu (the `pallas`
// backend, the whole loop in one launch) and moment_step.cu (the
// `pallas_mom` backend, one state launch per iteration after the moment
// kernel and its epilogue). One algorithm in one place, so the two cannot
// drift.
//
//   State        R, T, ell and done, iters, nnz of one alignment;
//   epilogue     one iteration's update from the pass output (omega, v,
//                nnz, B, C, D, E) at iteration k: the smallest positive
//                root of the step cubic (cvo.cpp:317-333), Exp_SEK3
//                (LieGroup.cpp:159-186), the se3 distance of the increment
//                (cvo.cpp:94-104), both stop rules and the ell anneal
//                (cvo.cpp:782, :804, :810-812); the caller runs it only
//                while the alignment has not stopped;
//   pose_of      the pose that moves the moving cloud, y = y0 R + Tt with
//                Tt = -R^T T (update_tf + transform_pcd, cvo.cpp:106-110,
//                :336), for flow_step.cuh's move_point;
//   align_params the kernels' parameters from the wrappers' host arrays.
//
// The helpers mirror pallas_align.py:67-181 (and the plain ops/cubic,
// ops/se3, cvo/engine._update) with CUDA's acosf and cbrtf.

#pragma once

#include "flow_step.cuh"

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
  int skip;   // 1: tile skipping (flow_step.cuh); 0: every tile pair
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

// the loop state of one lane, which every block keeps (identically) in
// shared memory
struct State {
  float R[9], T[3], ell;
  int done, iters, nnz;
};

// one iteration's epilogue of one lane
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

// the moving cloud y0 R + Tt of a lane's state (update_tf + transform_pcd)
__device__ __forceinline__ Pose pose_of(const State& st) {
  Pose pose;
  for (int i = 0; i < 9; ++i) pose.R[i] = st.R[i];
  for (int i = 0; i < 3; ++i)
    pose.Tt[i] = -(st.R[i] * st.T[0] + st.R[3 + i] * st.T[1]
                   + st.R[6 + i] * st.T[2]);
  return pose;
}

// the parameters from the wrappers' host arrays (cvo/kernels._align_params):
// hf (14 floats) log_ratio, d2ct, two_cl2, s2cs2, sp_thres, c, d, eps,
// eps_2, min_step, max_step, the 3 anneal values; hi (5 ints) the 3 anneal
// iterations, max_iter, skip
inline AlignParams align_params(const float* hf, const int* hi) {
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
  prm.skip = hi[4];
  return prm;
}

}  // namespace
