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
// epilogue (flow and quartic step coefficients) is moment_step.cu's
// moment_epilogue_kernel on the card, launched after both passes by the
// same wrapper (cvo/kernels.moment_flow_step); its plain version is
// ops/pairwise.flow_and_step_from_moments.
//
// What bounds it: arithmetic. At CAP 3072 one launch visits 9.4 M pairs,
// ~9 instructions each for the geometric distance by explicit differences;
// the colour distance, the exponential and the 35 moment products are
// paid only inside the gates (0.14% of pairs are kept at ell 0.15). It
// reads ~0.9 MB (the clouds and U) and writes Mom (0.4 MB).
//
// The design, against what held the first version back (a 24 x 8 grid of
// 128-thread blocks, one moving point and 35 sums per thread, all of U
// staged for every tile, and a second launch over 3.4 MB of partials):
//   pass 1 (moment_keep_pass): the gate sweep on flow_step.cuh's work split
//     and staging. A work item is a tile of ROWS moving points (rows j, RB
//     per thread in registers, colours in shared memory) against a chunk of
//     32-column tiles of fixed points (columns i, staged with double-
//     buffered cp.async); the plan sizes the items to the card's resident
//     grid (moment_geometry, cvo/kernels.plan_split): 576 items at CAP 3072
//     where the first version ran 192 blocks. It writes the keep bitmask
//     (rows j, words over i: word bits[t * M + j], bit k column 32 t + k;
//     1.2 MB at CAP 3072, held in L2) and the item's integer count. No U
//     is staged.
//   pass 2 (moment_sum_pass): one warp per row j walks the row's words in
//     ascending i. For each non-empty word, the lanes of its set bits
//     recompute a with pass 1's float operations (one pair each); then, in
//     ascending i, every lane adds a * U[i, m] for its moments m = lane and
//     lane + 32, reading the U row from global memory (coalesced, L2-
//     resident). Each sum of Mom is a row's kept pairs in ascending i,
//     whatever the split; block 0 sums the items' counts into nnz.
// Two launches per call, no partials of Mom. Pass 1 skips the tile pairs
// whose boxes lie beyond the gate, with flow_step.cuh's slack (the rows'
// box taken as they load, each fixed-point tile's as it is packed), so
// skipping adds no launch and changes no bit.
//
// The gate uses explicit differences, as the Pallas kernel and
// kernels.moment_pass_plain: (x - y)^2 summed coordinate by coordinate,
// then the 5 colour differences, then one fused clamped exponential. (The
// per-pair align kernels use the dot identity instead; their distance
// functions are not used here.) A masked or missing point gets position
// +inf: its distance to a finite point is +inf, to another +inf NaN, and
// both fail d2 < d2t with no branch. The file is compiled with -fmad=false
// so every float operation rounds exactly as in the plain PyTorch version:
// the keep decisions, and hence the bitmask and nnz, are identical. No
// float atomics: two launches give bitwise-equal results. Any capacity
// works: rows and columns past the end are masked.

#include "flow_step.cuh"

namespace {

constexpr int NMOM = 35;
constexpr int SUM_WARPS = 8;   // rows per block of pass 2

struct MomentConsts {
  float log_ratio;  // log(sp_thres / sigma^2)
  float d2ct;       // colour gate
  float inv2cl2;    // 1 / (2 c_ell^2)
  float s2cs2;      // sigma^2 c_sigma^2
  float sp_thres;   // sparsification threshold
};

// the rows of a moment item: positions in registers (+inf when masked),
// colours in shared memory (each thread reads only its own rows)
struct MomentRows {
  float y[RB][3];
};

struct MomentRowColours {
  float f[5][ROWS];
};

// the squared norm of an unmasked point as a box takes it: FLT_MAX where
// it overflows, so the tile pair is computed (flow_step.cuh's slack note)
__device__ __forceinline__ float box_sq(const float* q) {
  return fminf(sq3(q), 3.402823466e38f);
}

// cl.x / fx / mx: the moving cloud (rows); cl.y / fy / my: the fixed cloud
// (the staged columns). With skip, each warp's box of its rows into s
// (store_rows_box).
__device__ __forceinline__ void load_moment_rows(const Clouds& cl,
                                                 const Split& sp, int rt,
                                                 bool skip, MomentRows& R,
                                                 MomentRowColours& F,
                                                 Stage& s) {
  Box b = empty_box();
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int j = row_index(rt, r);
    const int lr = r * THREADS + threadIdx.x;
    const bool on = j < sp.N && cl.mx[j] != 0;
    for (int c = 0; c < 3; ++c) R.y[r][c] = on ? cl.x[j * 3 + c] : inf_f();
    for (int c = 0; c < 5; ++c) F.f[c][lr] = on ? cl.fx[j * 5 + c] : 0.f;
    if (skip && on)
      box_add(b, R.y[r][0], R.y[r][1], R.y[r][2], box_sq(R.y[r]));
  }
  if (skip) store_rows_box(b, s);
}

// pack a raw column tile: positions (+inf when masked; w the squared norm
// the sweep's column box takes, +inf when masked), colours as they are
__device__ __forceinline__ void pack_moment_tile(const RawTile& raw,
                                                 PackedTile& pk) {
  const int k = threadIdx.x;
  if (k >= CT) return;
  const bool on = raw.m[k] != 0;
  float q[3], f[5];
  for (int c = 0; c < 3; ++c) q[c] = on ? raw.p[3 * k + c] : inf_f();
  for (int c = 0; c < 5; ++c) f[c] = raw.f[5 * k + c];
  pk.p[k] = make_float4(q[0], q[1], q[2], on ? box_sq(q) : inf_f());
  pk.fa[k] = make_float4(f[0], f[1], f[2], f[3]);
  pk.fb[k] = make_float2(f[4], 0.f);
}

// sum over c of (x_c - y_c)^2, coordinate by coordinate (moment_pass_plain)
__device__ __forceinline__ float diff_d2(float x0, float x1, float x2,
                                         const float* y) {
  float e = x0 - y[0];
  float d2 = e * e;
  e = x1 - y[1];
  d2 = d2 + e * e;
  e = x2 - y[2];
  d2 = d2 + e * e;
  return d2;
}

__device__ __forceinline__ float diff_d2c(const float* fx, const float* fy) {
  float g = fx[0] - fy[0];
  float d2c = g * g;
  for (int c = 1; c < 5; ++c) {
    g = fx[c] - fy[c];
    d2c = d2c + g * g;
  }
  return d2c;
}

// the joint kernel of a pair inside both gates
__device__ __forceinline__ float moment_a(float d2, float d2c, float inv2l2,
                                          const MomentConsts& c) {
  return clamped_kernel(c.s2cs2, -(d2 * inv2l2 + d2c * c.inv2cl2));
}

// Pass 1 over one work item (blockIdx.x): the keep bitmask of its rows and
// column tiles (zero words for a tile pair that is not live: flow_step.cuh's
// tile skipping, with skip), its keep count npart[item] and its live tiles
// npart[items + item].
__global__ void __launch_bounds__(THREADS)
moment_keep_pass(Clouds cl, Split sp, const float* __restrict__ ell_ptr,
                 MomentConsts c, int skip, unsigned* __restrict__ bits,
                 int* __restrict__ npart) {
  __shared__ Stage s;
  __shared__ MomentRowColours F;
  __shared__ Red red;
  const Item it = item_of(sp, blockIdx.x);
  MomentRows R;
  load_moment_rows(cl, sp, it.rt, skip != 0, R, F, s);
  const float ell = *ell_ptr;
  const float d2t = -2.f * ell * ell * c.log_ratio;
  const float inv2l2 = 1.f / (2.f * ell * ell);
  int n = 0;
  const auto pack = [](const RawTile& raw, PackedTile& pk) {
    pack_moment_tile(raw, pk);
  };
  const int tiles = sweep_packed(
      cl, sp, it, s, skip != 0, d2t, pack,
      [&](int t, const PackedTile& pk, bool live) {
    unsigned word[RB] = {};
#pragma unroll 2
    for (int k = 0; live && k < CT; ++k) {
      const float4 p = pk.p[k];
      float d2[RB];
      bool any = false;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        d2[r] = diff_d2(p.x, p.y, p.z, R.y[r]);
        any |= d2[r] < d2t;
      }
      if (!any) continue;
      const float fx[5] = {pk.fa[k].x, pk.fa[k].y, pk.fa[k].z, pk.fa[k].w,
                           pk.fb[k].x};
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (!(d2[r] < d2t)) continue;
        const int lr = r * THREADS + threadIdx.x;
        const float fy[5] = {F.f[0][lr], F.f[1][lr], F.f[2][lr], F.f[3][lr],
                             F.f[4][lr]};
        const float d2c = diff_d2c(fx, fy);
        if (!(d2c < c.d2ct)) continue;
        if (!(moment_a(d2[r], d2c, inv2l2, c) > c.sp_thres)) continue;
        word[r] |= 1u << k;
        ++n;
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int j = row_index(it.rt, r);
      if (j < sp.N) __stcg(bits + (size_t)t * sp.N + j, word[r]);
    }
  });
  int cnt[1] = {n};
  block_sum_n<NWARPS>(cnt, red.i, &red.iout);
  if (threadIdx.x == 0) {
    __stcg(npart + blockIdx.x, red.iout);
    __stcg(npart + sp.items + blockIdx.x, tiles);
  }
}

// Pass 2: warp w of block b owns moving point j = b * SUM_WARPS + w and
// writes Mom[j, 0:35] from pass 1's bitmask; block 0 first sums the
// `items` keep counts into nnz[0] and their live tiles into nnz[1].
__global__ void __launch_bounds__(SUM_WARPS * 32)
moment_sum_pass(const float* __restrict__ x, const float* __restrict__ fx,
                const float* __restrict__ U, const float* __restrict__ y,
                const float* __restrict__ fy,
                const float* __restrict__ ell_ptr, int N, int M,
                MomentConsts c, const unsigned* __restrict__ bits,
                const int* __restrict__ npart, int items,
                float* __restrict__ mom, int* __restrict__ nnz) {
  __shared__ int warp_cnt[2][SUM_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x == 0) {   // integer counts: any order is exact
    int s[2] = {0, 0};
    for (int b = threadIdx.x; b < items; b += SUM_WARPS * 32) {
      s[0] += __ldg(npart + b);
      s[1] += __ldg(npart + items + b);
    }
    for (int q = 0; q < 2; ++q) {
      s[q] = __reduce_add_sync(0xffffffffu, s[q]);
      if (lane == 0) warp_cnt[q][warp] = s[q];
    }
    __syncthreads();
    if (threadIdx.x < 2) {
      int t = 0;
      for (int w = 0; w < SUM_WARPS; ++w) t += warp_cnt[threadIdx.x][w];
      nnz[threadIdx.x] = t;
    }
  }
  const int j = blockIdx.x * SUM_WARPS + warp;
  if (j >= M) return;
  const float ell = *ell_ptr;
  const float inv2l2 = 1.f / (2.f * ell * ell);
  float yj[3], fyj[5];
  for (int e = 0; e < 3; ++e) yj[e] = __ldg(y + j * 3 + e);
  for (int e = 0; e < 5; ++e) fyj[e] = __ldg(fy + j * 5 + e);
  const int words = (N + CT - 1) / CT;
  float acc0 = 0.f, acc1 = 0.f;   // moments lane and lane + 32
  for (int t0 = 0; t0 < words; t0 += 32) {
    const unsigned w =
        t0 + lane < words ? __ldg(bits + (size_t)(t0 + lane) * M + j) : 0u;
    unsigned live = __ballot_sync(0xffffffffu, w != 0u);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const int t = t0 + src;
      unsigned word = __shfl_sync(0xffffffffu, w, src);
      // lane k: a of column 32 t + k when its bit is set
      float a = 0.f;
      if ((word >> lane) & 1u) {
        const int i = t * CT + lane;
        float fxi[5];
        for (int e = 0; e < 5; ++e) fxi[e] = __ldg(fx + i * 5 + e);
        a = moment_a(diff_d2(__ldg(x + i * 3), __ldg(x + i * 3 + 1),
                             __ldg(x + i * 3 + 2), yj),
                     diff_d2c(fxi, fyj), inv2l2, c);
      }
      while (word) {   // ascending i
        const int k = __ffs(word) - 1;
        word &= word - 1;
        const float ak = __shfl_sync(0xffffffffu, a, k);
        const float* u = U + (size_t)(t * CT + k) * NMOM;
        acc0 += ak * __ldg(u + lane);
        if (lane < NMOM - 32) acc1 += ak * __ldg(u + 32 + lane);
      }
    }
  }
  mom[(size_t)j * NMOM + lane] = acc0;
  if (lane < NMOM - 32) mom[(size_t)j * NMOM + 32 + lane] = acc1;
}

}  // namespace

// Plain C entry point (loaded with ctypes): the geometry the wrapper plans
// pass 1's split with. out (4 ints): resident blocks per SM of pass 1,
// SMs, rows per work item, columns per tile. Returns the CUDA error code.
extern "C" int moment_geometry(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, moment_keep_pass, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = ROWS;
  out[3] = CT;
  return (int)cudaSuccess;
}

// Plain C entry point (loaded with ctypes). Launches both passes on
// `stream` and returns the CUDA error code of the launches (0 = success).
// Fixed cloud x/fx/mx (N, the staged columns: each 16-byte aligned), U
// (N, 35); moving cloud y/fy/my (M, the rows). Pass 1's split: rows in
// tiles of ROWS, `chunks` chunks of per_chunk column tiles,
// items = ceil(M / ROWS) * chunks. skip: 1 skips the tile pairs whose boxes
// lie beyond the gate (flow_step.cuh), 0 computes every pair; the outputs
// are the same bit for bit. Scratch: bits ceil(N/32) * M words (on return,
// pass 1's keep bitmask), npart 2 * items ints. Out: mom (M, 35) floats,
// nnz 2 ints: the keep count and the tile pairs pass 1 computed (of
// ceil(M / ROWS) * ceil(N/32)).
extern "C" int moment_flow_step_launch(
    const float* x, const float* fx, const unsigned char* mx, const float* U,
    const float* y, const float* fy, const unsigned char* my,
    const float* ell, int N, int M, int chunks, int per_chunk,
    float log_ratio, float d2ct, float inv2cl2, float s2cs2, float sp_thres,
    int skip, unsigned* bits, int* npart, float* mom, int* nnz,
    cudaStream_t stream) {
  Split sp;
  if (!make_split(M, N, chunks, per_chunk, sp))
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)x) | ((uintptr_t)fx) | ((uintptr_t)mx)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const MomentConsts c{log_ratio, d2ct, inv2cl2, s2cs2, sp_thres};
  const Clouds cl{y, fy, my, x, fx, mx};   // rows: moving; columns: fixed
  moment_keep_pass<<<sp.items, THREADS, 0, stream>>>(cl, sp, ell, c, skip,
                                                     bits, npart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moment_sum_pass<<<(M + SUM_WARPS - 1) / SUM_WARPS, SUM_WARPS * 32, 0,
                    stream>>>(x, fx, U, y, fy, ell, N, M, c, bits, npart,
                              sp.items, mom, nnz);
  return (int)cudaGetLastError();
}
