// Pair stats of compute_innerproduct_lc, for sm_90a.
//
// Replaces: cvo_slam_tpu/cvo/pallas_kernels.py:pair_stats (kernel body
// _stats_kernel), whose plain twin is ops/pairwise.py:pair_stats, and, as
// pair_stats_launch of several lanes, its vmapped form (the JAX package's
// lc_verify_batch, cvo_slam_tpu/cvo/engine.py:443-470). Rows xa
// (the transformed moving cloud) against columns xb: over the pairs that
// pass the geometric and colour gates (no sp_thres test, cvo.cpp:416-447)
// the sum of ck * k and the pair count and, when with_moments is set,
// G = U(xa)^T W U(xb) with W_ij = gate * sigma^2 exp(max(-d2 / 2 ell^2,
// -20)) * (fa_i . fb_j) and U = [1, p, vec(p p^T)].
//
// What bounds it: arithmetic. At CAP 3072 one launch visits 9.4 M pairs:
// ~6 instructions each for the geometric distance (an FMA-chain dot and
// the identity); the colour distance, two exponentials and, with moments,
// the 13 products of W U(xb) are paid only inside the geometric gate. It
// reads ~0.2 MB.
//
// The design, against what held the first version back (a 24 x 8 grid of
// 128-thread blocks with one row per thread, then one or two more launches
// to reduce the partials serially): one launch per call in both modes, on
// flow_step.cuh's work split, sized to the card's resident grid
// (pair_stats_geometry, per template; cvo/kernels.plan_split). The sweep
// over the work items (with tile skipping), the per-item G and the
// two-level ticket finalize are pair_stats.cuh's, which the suite
// (ip_suite.cu) runs over its four pair sets in one launch; here a launch
// holds one set.
//
// Lanes: one launch computes the pair stats of S cloud pairs
// (compute_innerproduct_lc over the loop-closure candidates of a round,
// vmap's grid dimension of the Pallas kernel). Rows and columns are each a
// stack of S clouds at a lane stride in points, or one cloud of every
// lane (stride 0); ell is per lane. Each lane keeps the one-lane plan and
// its own scratch, tickets and outputs at a fixed stride, so each lane
// equals its launch alone bit for bit; the one-lane call is the launch of
// S = 1, on a kernel without the lane offsets (its registers and speed
// unchanged).
//
// The geometric gate is tested first because it is the cheaper test and
// passes far fewer pairs (the colour gate passes almost every pair of a
// scene); each value is computed with the first version's float
// operations and a pair is counted only when both gates pass, so the order
// of the tests changes no result. -fmad=false, integer counts, no float
// atomics, f32 sums in one fixed order: two launches give bitwise-equal
// results.

#include "pair_stats.cuh"

namespace {

// one pair set per launch (pair_stats.cuh's sweep_sets), with or without
// moments; LANES: the launch of several lanes
template <bool MOM, bool LANES>
__global__ void __launch_bounds__(THREADS)
pair_stats_sweep(const __grid_constant__ Sweep w) {
  __shared__ SweepShared<MOM> sh;
  sweep_sets<MOM ? 1 : 0, LANES>(w, sh);
}

}  // namespace

// Plain C entry point (loaded with ctypes): the geometry the wrapper plans
// the split with, for the template of `with_moments` (one lane; the lanes
// keep its plan). out (4 ints): resident blocks per SM, SMs, rows per work
// item, columns per tile. Returns the CUDA error code.
extern "C" int pair_stats_geometry(int with_moments, int* out) {
  return with_moments ? sweep_geometry(pair_stats_sweep<true, false>, out)
                      : sweep_geometry(pair_stats_sweep<false, false>, out);
}

// Plain C entry point (loaded with ctypes): `lanes` pair sets in one launch
// (lanes >= 1). Lane l's rows are xa/fa/ma + l a_lane points (N of them),
// its columns xb/fb/mb + l b_lane points (M, each lane's arrays 16-byte
// aligned); a lane stride is at least the point count, or 0 for one cloud
// of every lane. ell + l is lane l's ell. One block per work item of the
// split and lane (chunks chunks of per_chunk column tiles; items =
// ceil(N / ROWS) * chunks), the finalize in groups of `group` items
// (groups = ceil(items / group)). NF = 170 floats per partial with
// moments, else 1. skip: 1 tile skipping, 0 every tile pair (the outputs
// are the same bit for bit). Scratch a lane, lane after lane: fpart
// items * NF floats, npart items ints, gpart groups * NF floats, gnpart
// groups ints. out_f (170 floats a lane): G at 0:169 (with moments only),
// the sum at 169; out_n (3 + groups ints a lane): the count, the tile
// pairs computed, then the tickets; this function zeroes it on `stream`
// before the launch. Returns the CUDA error code (0 = success).
extern "C" int pair_stats_launch(
    const float* xa, const float* fa, const unsigned char* ma,
    const float* xb, const float* fb, const unsigned char* mb,
    const float* ell, int N, int M, int lanes, int a_lane, int b_lane,
    int chunks, int per_chunk, int group, int with_moments, int skip,
    float log_ratio, float d2ct, float s2, float cs2, float two_cl2,
    float* fpart, int* npart, float* gpart, int* gnpart, float* out_f,
    int* out_n, cudaStream_t stream) {
  if (lanes < 1 || (a_lane != 0 && a_lane < N) || (b_lane != 0 && b_lane < M))
    return (int)cudaErrorInvalidValue;
  PairSet set;
  cudaError_t err = make_set(xa, fa, ma, xb, fb, mb, N, M, chunks, per_chunk,
                             group, with_moments != 0, 0, 0, 0, 0, set);
  if (err != cudaSuccess) return (int)err;
  set.row_lane = a_lane;
  set.col_lane = b_lane;
  if (!lanes_aligned(set, lanes)) return (int)cudaErrorMisalignedAddress;
  set.out_g = out_f;
  set.out_sum = out_f + NG;
  set.out_n = out_n;
  set.out_tiles = out_n + 1;
  Sweep w;
  const int items = make_sweep(&set, 1, w);
  const int groups = set_groups(set), nf = set_nf(set);
  w.lanes = lanes;
  w.lane_fpart = items * nf;
  w.lane_npart = items;
  w.lane_gpart = groups * nf;
  w.lane_gnpart = groups;
  w.lane_out_f = NG + 1;
  w.lane_out_n = 3 + groups;
  w.level2 = out_n + 2;
  w.level1 = out_n + 3;
  w.fpart = fpart;
  w.npart = npart;
  w.gpart = gpart;
  w.gnpart = gnpart;
  w.ell = ell;
  w.c = Consts{};
  w.c.log_ratio = log_ratio;
  w.c.d2ct = d2ct;
  w.c.s2 = s2;
  w.c.cs2 = cs2;
  w.c.two_cl2 = two_cl2;
  w.skip = skip;
  err = cudaMemsetAsync(out_n, 0, (size_t)lanes * w.lane_out_n * sizeof(int),
                        stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(lanes * items);
  if (with_moments) {
    if (lanes == 1)
      pair_stats_sweep<true, false><<<grid, THREADS, 0, stream>>>(w);
    else
      pair_stats_sweep<true, true><<<grid, THREADS, 0, stream>>>(w);
  } else {
    if (lanes == 1)
      pair_stats_sweep<false, false><<<grid, THREADS, 0, stream>>>(w);
    else
      pair_stats_sweep<false, true><<<grid, THREADS, 0, stream>>>(w);
  }
  return (int)cudaGetLastError();
}
