// One CVO align iteration in per-pair form, for sm_90a, in three modes:
//
//   mode 0, both passes: replaces cvo_slam_tpu/cvo/pallas_kernels.py:
//     flow_and_step (kernel body _iter_kernel), the align iteration of the
//     pallas_iter backend: (omega, v, nnz) from pass 1, then (B, C, D, E)
//     from pass 2 with the fresh omega, v;
//   mode 1, flow only: replaces pallas_kernels.py:flow (_flow_kernel),
//     (omega, v, nnz);
//   mode 2, step only: replaces pallas_kernels.py:step_coeffs
//     (_step_kernel), (B, C, D, E) for a given omega, v.
// The passes are the device functions of flow_step.cuh; their plain
// PyTorch versions are ops/pairwise.flow, step_coeffs and flow_and_step.
//
// What bounds it: arithmetic. At CAP 3072 each pass visits 9.4 M pairs,
// ~11 operations for the geometric distance of every valid pair, ~15 for
// the colour distance inside the geometric gate, ~8 for the joint kernel of
// a gated pair, then 9 (pass 1) or ~60 (pass 2) for a kept pair; it reads
// ~0.2 MB. The design, as the suite kernel's: one thread owns one fixed
// point (row) and keeps its accumulators in registers; tiles of TILE moving
// points (positions, features, norms and, in pass 2, the 19 per-column
// step terms xi^k z, xi^k z . y, |xiz|^2, ...) are staged in shared memory,
// and every thread reads the same column at once; the column range is split
// into gridDim.y chunks to fill the SMs (24 x 8 blocks at CAP 3072); each
// block writes its partials, and a one-block pass sums them in a fixed
// order. Any capacity works: rows and columns past the end are masked.

#include "flow_step.cuh"

namespace {

__global__ void __launch_bounds__(TILE)
flow_pass(const float* __restrict__ x, const float* __restrict__ fx,
          const unsigned char* __restrict__ mx, const float* __restrict__ y,
          const float* __restrict__ fy, const unsigned char* __restrict__ my,
          const float* __restrict__ ell_ptr, int N, int M,
          int tiles_per_chunk, Consts c, float* __restrict__ fpart,
          int* __restrict__ npart) {
  __shared__ Cols s;
  __shared__ float fbuf[TILE];
  __shared__ int ibuf[TILE];
  const int item = blockIdx.y * gridDim.x + blockIdx.x;
  const int nt = (M + TILE - 1) / TILE;
  const int t0 = blockIdx.y * tiles_per_chunk;
  const int t1 = min(t0 + tiles_per_chunk, nt);
  const Pose none{};
  flow_item<false>(x, fx, mx, N, y, fy, my, M, blockIdx.x, t0, t1, none,
                   *ell_ptr, c, s, fbuf, ibuf, fpart + item * N_FLOW,
                   npart + item);
}

__global__ void __launch_bounds__(TILE)
step_pass(const float* __restrict__ x, const float* __restrict__ fx,
          const unsigned char* __restrict__ mx, const float* __restrict__ y,
          const float* __restrict__ fy, const unsigned char* __restrict__ my,
          const float* __restrict__ ell_ptr, const float* __restrict__ wv,
          int N, int M, int tiles_per_chunk, Consts c,
          float* __restrict__ spart) {
  __shared__ Cols s;
  __shared__ float fbuf[TILE];
  __shared__ float w_v[6];
  if (threadIdx.x < 6) w_v[threadIdx.x] = __ldcg(wv + threadIdx.x);
  __syncthreads();
  const int item = blockIdx.y * gridDim.x + blockIdx.x;
  const int nt = (M + TILE - 1) / TILE;
  const int t0 = blockIdx.y * tiles_per_chunk;
  const int t1 = min(t0 + tiles_per_chunk, nt);
  const Pose none{};
  step_item<false>(x, fx, mx, N, y, fy, my, M, blockIdx.x, t0, t1, none,
                   *ell_ptr, w_v, w_v + 3, c, s, fbuf,
                   spart + item * N_STEP);
}

// out_f[0:6] = omega, v; out_n[0] = nnz
__global__ void flow_finalize(const float* __restrict__ fpart,
                              const int* __restrict__ npart, int n_items,
                              float c, float d, float* __restrict__ out_f,
                              int* __restrict__ out_n) {
  __shared__ float S[N_FLOW];
  __shared__ float wv[6];
  __shared__ int nnz;
  finalize_flow(fpart, npart, n_items, c, d, S, wv, &nnz);
  if (threadIdx.x < 6) out_f[threadIdx.x] = wv[threadIdx.x];
  if (threadIdx.x == 0) out_n[0] = nnz;
}

// out_f[6:10] = B, C, D, E
__global__ void step_finalize(const float* __restrict__ spart, int n_items,
                              float* __restrict__ out_f) {
  __shared__ float bcde[N_STEP];
  finalize_step(spart, n_items, bcde);
  if (threadIdx.x < N_STEP) out_f[6 + threadIdx.x] = bcde[threadIdx.x];
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches the passes of `mode`
// (0 both, 1 flow, 2 step) on `stream`; returns the CUDA error code of the
// launches (0 = success). Rows x/fx/mx (N), columns y/fy/my (M). wv_in:
// omega, v (6 floats on the device) for mode 2. Scratch: fpart
// n_chunks * ceil(N/128) * 12 floats, npart n_chunks * ceil(N/128) ints,
// spart n_chunks * ceil(N/128) * 4 floats. out_f (10 floats): omega, v,
// B, C, D, E; out_n (1 int): nnz. A mode writes only its own outputs.
extern "C" int flow_and_step_launch(
    int mode, const float* x, const float* fx, const unsigned char* mx,
    const float* y, const float* fy, const unsigned char* my,
    const float* ell, int N, int M, int n_chunks, float log_ratio,
    float d2ct, float two_cl2, float s2cs2, float sp_thres, float c, float d,
    const float* wv_in, float* fpart, int* npart, float* spart, float* out_f,
    int* out_n, cudaStream_t stream) {
  if (N <= 0 || M <= 0 || n_chunks <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const int row_tiles = (N + TILE - 1) / TILE;
  const int nt = (M + TILE - 1) / TILE;
  const int per_chunk = (nt + n_chunks - 1) / n_chunks;
  const int n_items = row_tiles * n_chunks;
  const dim3 grid(row_tiles, n_chunks);
  Consts k{};
  k.log_ratio = log_ratio;
  k.d2ct = d2ct;
  k.two_cl2 = two_cl2;
  k.s2cs2 = s2cs2;
  k.sp_thres = sp_thres;
  cudaError_t err;
  if (mode != 2) {
    flow_pass<<<grid, TILE, 0, stream>>>(x, fx, mx, y, fy, my, ell, N, M,
                                         per_chunk, k, fpart, npart);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    flow_finalize<<<1, 32, 0, stream>>>(fpart, npart, n_items, c, d, out_f,
                                        out_n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (mode != 1) {
    step_pass<<<grid, TILE, 0, stream>>>(x, fx, mx, y, fy, my, ell,
                                         mode == 0 ? out_f : wv_in, N, M,
                                         per_chunk, k, spart);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    step_finalize<<<1, 32, 0, stream>>>(spart, n_items, out_f);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
