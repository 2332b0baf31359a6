// Moment pass of one CVO align iteration, for sm_90a.
//
// Replaces: cvo_slam_tpu/cvo/pallas_kernels.py:moment_flow_step
// (kernel body _moment_kernel). For every pair (i of the fixed cloud x,
// j of the transformed moving cloud y):
//   gate  = |x_i - y_j|^2 < d2t(ell)  and  |fx_i - fy_j|^2 < d2ct
//           and both masks set
//   a     = s2cs2 * exp(max(-(d2 / 2 ell^2 + d2c / 2 c_ell^2), -20))
//   keep  = gate and a > sp_thres
// and writes Mom[j, 0:35] = sum_i keep * a * U[i, 0:35] (U = the 35
// centred monomials of x, degree <= 4) and nnz = sum keep. The O(M)
// epilogue (flow and quartic step coefficients) stays in PyTorch
// (ops/pairwise.flow_and_step_from_moments).
//
// What bounds it: arithmetic. At CAP 3072 one launch visits 9.4 M pairs
// with ~8 subtractions and ~8 multiply-adds for the two distances, one
// exponential, and 35 multiply-adds into the moment accumulators for each
// kept pair, while it reads only ~0.6 MB of clouds. The design keeps every
// operand of the inner loop on chip:
//   * one thread owns one moving point j and keeps its 35 moment sums in
//     registers across the whole loop over i;
//   * tiles of TILE fixed points (positions, features, mask and the 35 U
//     columns, 22.5 KB) are staged in shared memory, and every thread of
//     the block reads the same element at once (a broadcast);
//   * the i range is split into gridDim.y chunks so that CAP 3072 makes
//     24 x 8 blocks for the 132 SMs; each chunk writes its partial Mom and
//     a second pass sums the chunks in a fixed order (no float atomics:
//     two runs give bitwise-equal results);
//   * the geometric test runs first, so the exponential and the moment
//     update are paid only for pairs inside the gate radius.
// Distances are explicit differences, as in the Pallas kernel. The file is
// compiled with -fmad=false so every float operation rounds exactly as in
// the plain PyTorch version (cvo/kernels.py): the gate and keep decisions,
// and hence nnz, are identical.
// Any capacity works: rows and columns past the end are masked.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int NMOM = 35;

__global__ void __launch_bounds__(TILE)
moment_pass(const float* __restrict__ x, const float* __restrict__ fx,
            const unsigned char* __restrict__ mx,
            const float* __restrict__ U,
            const float* __restrict__ y, const float* __restrict__ fy,
            const unsigned char* __restrict__ my,
            const float* __restrict__ ell_ptr, int N, int M,
            int tiles_per_chunk, float log_ratio, float d2ct, float inv2cl2,
            float s2cs2, float sp_thres,
            float* __restrict__ mom_part, int* __restrict__ nnz_part) {
  __shared__ float sx[3][TILE];
  __shared__ float sf[5][TILE];
  __shared__ float su[NMOM][TILE];
  __shared__ unsigned char sm[TILE];
  __shared__ int warp_cnt[TILE / 32];

  const int tid = threadIdx.x;
  const int j = blockIdx.x * TILE + tid;
  const int chunk = blockIdx.y;
  const float ell = *ell_ptr;
  const float d2t = -2.f * ell * ell * log_ratio;
  const float inv2l2 = 1.f / (2.f * ell * ell);

  const bool row_ok = j < M && my[j] != 0;
  float yj[3] = {0.f, 0.f, 0.f};
  float fyj[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (j < M) {
    for (int c = 0; c < 3; ++c) yj[c] = y[j * 3 + c];
    for (int c = 0; c < 5; ++c) fyj[c] = fy[j * 5 + c];
  }
  float acc[NMOM];
#pragma unroll
  for (int m = 0; m < NMOM; ++m) acc[m] = 0.f;
  int cnt = 0;

  const int n_tiles = (N + TILE - 1) / TILE;
  const int t0 = chunk * tiles_per_chunk;
  const int t1 = min(t0 + tiles_per_chunk, n_tiles);
  for (int t = t0; t < t1; ++t) {
    const int i = t * TILE + tid;
    const bool in = i < N;
    for (int c = 0; c < 3; ++c) sx[c][tid] = in ? x[i * 3 + c] : 0.f;
    for (int c = 0; c < 5; ++c) sf[c][tid] = in ? fx[i * 5 + c] : 0.f;
    for (int m = 0; m < NMOM; ++m) su[m][tid] = in ? U[i * NMOM + m] : 0.f;
    sm[tid] = in ? mx[i] : 0;
    __syncthreads();
    if (row_ok) {
      for (int k = 0; k < TILE; ++k) {
        if (!sm[k]) continue;
        const float e0 = sx[0][k] - yj[0];
        const float e1 = sx[1][k] - yj[1];
        const float e2 = sx[2][k] - yj[2];
        float d2 = e0 * e0;
        d2 = d2 + e1 * e1;
        d2 = d2 + e2 * e2;
        if (!(d2 < d2t)) continue;
        float d2c = 0.f;
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          const float g = sf[c][k] - fyj[c];
          d2c = c == 0 ? g * g : d2c + g * g;
        }
        if (!(d2c < d2ct)) continue;
        const float a =
            s2cs2 * expf(fmaxf(-(d2 * inv2l2 + d2c * inv2cl2), -20.f));
        if (!(a > sp_thres)) continue;
        ++cnt;
#pragma unroll
        for (int m = 0; m < NMOM; ++m) acc[m] += a * su[m][k];
      }
    }
    __syncthreads();
  }

  if (j < M) {
#pragma unroll
    for (int m = 0; m < NMOM; ++m)
      mom_part[((size_t)chunk * NMOM + m) * M + j] = acc[m];
  }
  // integer count: order-free, so a plain shuffle tree is exact
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if ((tid & 31) == 0) warp_cnt[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int w = 0; w < TILE / 32; ++w) s += warp_cnt[w];
    nnz_part[chunk * gridDim.x + blockIdx.x] = s;
  }
}

// Mom^T[m, j] = sum over chunks, in chunk order; thread 0 of block 0 also
// sums the per-block pair counts.
__global__ void moment_reduce(const float* __restrict__ mom_part,
                              const int* __restrict__ nnz_part, int M,
                              int n_chunks, int n_count_parts,
                              float* __restrict__ momT,
                              int* __restrict__ nnz) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = NMOM * M;
  if (e < total) {
    float s = mom_part[e];
    for (int c = 1; c < n_chunks; ++c) s += mom_part[(size_t)c * total + e];
    momT[e] = s;
  }
  if (e == 0) {
    int s = 0;
    for (int b = 0; b < n_count_parts; ++b) s += nnz_part[b];
    *nnz = s;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches both passes on
// `stream` and returns the CUDA error code of the launches (0 = success).
// mom_part: n_chunks * 35 * M floats; nnz_part: n_chunks * ceil(M/128) ints.
extern "C" int moment_flow_step_launch(
    const float* x, const float* fx, const unsigned char* mx, const float* U,
    const float* y, const float* fy, const unsigned char* my,
    const float* ell, int N, int M, int n_chunks, float log_ratio,
    float d2ct, float inv2cl2, float s2cs2, float sp_thres, float* mom_part,
    int* nnz_part, float* momT, int* nnz, cudaStream_t stream) {
  if (N <= 0 || M <= 0 || n_chunks <= 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = (N + TILE - 1) / TILE;
  const int tiles_per_chunk = (n_tiles + n_chunks - 1) / n_chunks;
  const dim3 grid((M + TILE - 1) / TILE, n_chunks);
  moment_pass<<<grid, TILE, 0, stream>>>(
      x, fx, mx, U, y, fy, my, ell, N, M, tiles_per_chunk, log_ratio, d2ct,
      inv2cl2, s2cs2, sp_thres, mom_part, nnz_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = NMOM * M;
  moment_reduce<<<(total + 255) / 256, 256, 0, stream>>>(
      mom_part, nnz_part, M, n_chunks, n_chunks * grid.x, momT, nnz);
  return (int)cudaGetLastError();
}
