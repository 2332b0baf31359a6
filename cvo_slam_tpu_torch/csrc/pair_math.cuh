// The pair math shared by every pairwise kernel of the port (through
// flow_step.cuh: flow_step.cu, align_fused.cu, moment_flow_step.cu, and
// through pair_stats.cuh pair_stats.cu and ip_suite.cu): gate constants,
// squared norms, the dot-product distance identity over an FMA-chain dot,
// the clamped kernel exponential and the fixed-order block reduction.
//
// Every source that includes it is compiled with -fmad=false, so each
// operation rounds as the same operation of the plain PyTorch versions
// (ops/pairwise.py): gate decisions, and hence all pair counts, agree bit
// for bit.

#pragma once

#include <cuda_runtime.h>

namespace {

struct Consts {
  float log_ratio;  // log(sp_thres / sigma^2)
  float d2ct;       // colour gate
  float s2;         // sigma^2
  float cs2;        // c_sigma^2
  float two_cl2;    // 2 c_ell^2
  float s2cs2;      // sigma^2 c_sigma^2 (joint kernel of the align passes)
  float sp_thres;   // sparsification threshold (align passes)
};

__device__ __forceinline__ float sq3(const float* a) {
  float s = a[0] * a[0];
  s = s + a[1] * a[1];
  s = s + a[2] * a[2];
  return s;
}

__device__ __forceinline__ float sq5(const float* a) {
  float s = a[0] * a[0];
  for (int c = 1; c < 5; ++c) s = s + a[c] * a[c];
  return s;
}

// max(rsq + csq - 2 r . c, 0), the dot a chain of fused multiply-adds in
// coordinate order (pairwise.pair_dots; -fmad=false leaves explicit
// __fmaf_rn alone), for a row r and a column c of dim coordinates
__device__ __forceinline__ float ident_d2_reg(float rsq, float csq,
                                              const float* r, const float* c,
                                              int dim) {
  float dot = r[0] * c[0];
  for (int q = 1; q < dim; ++q) dot = __fmaf_rn(r[q], c[q], dot);
  return fmaxf(rsq + csq - 2.f * dot, 0.f);
}

// scale * exp(max(arg, -20)): the clamp is exact for every gated pair
// (the gates bound the exponent at ~-5) and keeps gate-free values finite
__device__ __forceinline__ float clamped_kernel(float scale, float arg) {
  return scale * expf(fmaxf(arg, -20.f));
}

// fixed-order reduction of NV values per thread over a block of NWARPS
// full warps: a butterfly of shuffles inside each warp (every lane ends
// with the same bits: IEEE addition commutes exactly), then the warps' sums,
// last warp first (the order of flow_step.cuh's sums). buf: NWARPS * NV
// slots; out[q] is valid for every thread on return.
template <int NWARPS, typename T, int NV>
__device__ void block_sum_n(T (&v)[NV], T* buf, T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NV; ++q)
    for (int o = 16; o > 0; o >>= 1)
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
  if (lane == 0)
    for (int q = 0; q < NV; ++q) buf[warp * NV + q] = v[q];
  __syncthreads();
  if ((int)threadIdx.x < NV) {
    T s = buf[(NWARPS - 1) * NV + threadIdx.x];
    for (int w = NWARPS - 2; w >= 0; --w) s += buf[w * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

}  // namespace
