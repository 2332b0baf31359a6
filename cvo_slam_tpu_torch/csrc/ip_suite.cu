// Inner-product suite of compute_innerproduct, for sm_90a.
//
// ip_suite_launch replaces: cvo_slam_tpu/cvo/pallas_kernels.py:ip_suite
// (kernel body _ip_suite_kernel), whose XLA twin is ops/pairwise.py:ip_suite.
// For four pair sets — pre (rows y, columns x), post (rows yt, columns x),
// fixed (x, x) and moving (y, y) — it sums the gated joint kernel ck * k and
// counts the gated pairs (no sp_thres test, cvo.cpp:416-447); over the post
// set it also forms the 13x13 Hessian moment matrix G = U(yt)^T W U(x) with
// W_ij = gate * sigma^2 exp(max(-d2 / 2 ell^2, -20)) * (fy_i . fx_j) and
// U = [1, p, vec(p p^T)]. inliers = the post count. Each set is exactly one
// pair-stats call (ops/pairwise.py:pair_stats over the same float
// operations): pre = pair_stats(y, x), post = pair_stats(yt, x) with
// moments, fixed = pair_stats(x, x), moving = pair_stats(y, y).
//
// What bounds it: arithmetic. At CAP 3072 one call visits 4 x 9.4 M pairs:
// ~8 instructions each for the geometric distance; the colour distance, two
// exponentials and, for post, the 36 of W U(x) are paid only inside the
// geometric gate. It reads ~0.3 MB.
//
// The design, against what held the first version back (one row per
// thread on a 24 x 8 grid of 128-thread blocks, the colour gate tested
// before the geometric one, 13 W U(x) sums per row written out and read
// back serially, three launches per call): the four sets are the work items
// of pair_stats.cuh's sweep, in one launch. The blocks take the post set
// first (its items are the longest), then pre, fixed and moving; a block
// finds its set from blockIdx.x. The split is one plan for the four sets
// together (kernels.plan_sets, on the resident grid of suite_geometry), so
// they fill the card as one grid: 4 x 576 items of one 32-column tile at
// CAP 3072. One finalize serves the four sets: the last group of the lane
// sums each set's groups in item order into out_f / out_n. Every block has
// the moment items' shared memory (pair_stats.cuh's Moments). The scratch
// layout, each set's offsets into the partials and tickets, is the
// wrapper's (kernels.suite_scratch); the launch refuses a set that does not
// fit the lengths it is given.
//
// Lanes: one launch computes the suite of S cloud pairs (the lockstep
// tracker's requests of one round; vmap's grid dimension of the Pallas
// kernel). Its blocks are the 4 S sets' items, the post sets of every lane
// first, then pre, fixed and moving, each set lane after lane; a block
// finds its set and lane from blockIdx.x. Each lane keeps the one-lane
// plan and its own scratch, its two-level ticket finalize and its outputs,
// each at a fixed stride, so each lane's 10-tuple equals its launch alone
// bit for bit; the one-lane suite is the launch of S = 1. The clouds of
// the lanes lie a lane stride apart (in points, at least the capacity:
// cvo/engine.stack_clouds rounds it up to 16 points, so a stack of clouds
// of any capacity has every lane 16-byte aligned).
//
// Tile skipping, as the Pallas suite's four sets of flags
// (pallas_kernels.py:782-787): each of the four sets skips the tile pairs
// whose boxes lie beyond the gate radius (pair_stats.cuh), the post set's
// rows the moving cloud under the registration result as given (yt); its
// Hessian moments come from the same sweep, so they share its tiles. Each
// set of each lane counts the tile pairs it computed.
//
// -fmad=false, integer counts, no float atomics, f32 sums in one fixed
// order: two launches give bitwise-equal results. Any capacity works: rows
// and columns past the end are masked.

#include "pair_stats.cuh"

namespace {

enum { PRE, POST, FIXED, MOVING, N_SETS };

constexpr int PLAN_INTS = 7;   // plan ints of one set

// LANES: the launch of several lanes; one lane takes the sweep without
// the lane offsets, so the one-lane suite keeps its registers and speed.
// At most 102 registers, so 5 blocks fit on an SM either way (the lane
// offsets took ptxas to 128 registers and 4 blocks), with tile skipping
// too: kernels.plan_sets sizes the split from this residency, so it keeps
// every sum's order.
template <bool LANES>
__global__ void __launch_bounds__(THREADS, 5)
suite_sweep(const __grid_constant__ Sweep w) {
  __shared__ SweepShared<true> sh;
  sweep_sets<2, LANES>(w, sh);
}

// a lane's out_n: the four counts, the four sets' tile pairs, the
// level-2 ticket, the level-1 tickets
constexpr int OUT_TILES = N_SETS, OUT_LEVEL2 = 2 * N_SETS,
              OUT_LEVEL1 = 2 * N_SETS + 1;

// whether the set's partials and tickets lie inside the scratch of
// `sizes` (fpart, npart, gpart, gnpart, out_n)
bool fits(const PairSet& t, const int* sizes) {
  const long items = t.sp.items, groups = set_groups(t), nf = set_nf(t);
  return t.f0 >= 0 && t.n0 >= 0 && t.gf0 >= 0 && t.group0 >= 0 &&
         t.f0 + items * nf <= sizes[0] && t.n0 + items <= sizes[1] &&
         t.gf0 + groups * nf <= sizes[2] && t.group0 + groups <= sizes[3] &&
         OUT_LEVEL1 + t.group0 + groups <= sizes[4];
}

}  // namespace

// Plain C entry point (loaded with ctypes): the geometry the wrapper plans
// the split with. out (4 ints): resident blocks per SM, SMs, rows per work
// item, columns per tile. Returns the CUDA error code.
extern "C" int suite_geometry(int* out) {
  return sweep_geometry(suite_sweep<false>, out);
}

// Plain C entry point (loaded with ctypes). `lanes` suites in one launch
// (lanes >= 1): lane l's fixed cloud x/fx/mx + l x_lane points (N of them;
// x_lane >= N, or 0 for one fixed cloud of every lane), its moving cloud
// y/fy/my + l y_lane points (M of them, y_lane >= M), each lane's arrays
// 16-byte aligned (both are staged as columns), yt + 3 l y_lane its moving
// positions under the registration result and ell + l its ell. skip: 1
// tile skipping, 0 every tile pair (the outputs are the same bit for
// bit). plan (28 ints), the same for
// every lane: for pre, post, fixed and moving in turn the split's chunks,
// column tiles per chunk and items per level-1 group, then the set's
// first float of fpart, count of npart, float of gpart and group of
// gnpart (and of the level-1 tickets); partials are NG + 1 floats for
// post, else 1. sizes (5 ints): one lane's lengths of fpart, npart, gpart,
// gnpart and out_n; each buffer holds `lanes` of them, lane after lane.
// out_f (173 floats a lane): G at 0:169, the four sums at 169:173; out_n:
// a lane's four counts, the four sets' tile pairs computed, its level-2
// ticket, then its level-1 tickets; this function zeroes it on `stream`
// before the launch. Returns the CUDA error code (0 = success).
extern "C" int ip_suite_launch(
    const float* x, const float* fx, const unsigned char* mx, const float* y,
    const float* fy, const unsigned char* my, const float* yt,
    const float* ell, int N, int M, int lanes, int x_lane, int y_lane,
    int skip, const int* plan, const int* sizes, float log_ratio,
    float d2ct, float s2, float cs2, float two_cl2, float* fpart,
    int* npart, float* gpart, int* gnpart, float* out_f, int* out_n,
    cudaStream_t stream) {
  // rows and columns of each set
  const float* ra[N_SETS] = {y, yt, x, y};
  const float* rf[N_SETS] = {fy, fy, fx, fy};
  const unsigned char* rm[N_SETS] = {my, my, mx, my};
  const float* ca[N_SETS] = {x, x, x, y};
  const float* cf[N_SETS] = {fx, fx, fx, fy};
  const unsigned char* cm[N_SETS] = {mx, mx, mx, my};
  const int rows[N_SETS] = {M, M, N, M}, cols[N_SETS] = {N, N, N, M};
  // the lane strides (points) of each set's rows and columns
  const int row_lane[N_SETS] = {y_lane, y_lane, x_lane, y_lane};
  const int col_lane[N_SETS] = {x_lane, x_lane, x_lane, y_lane};
  if (lanes < 1 || (x_lane != 0 && x_lane < N) || y_lane < M)
    return (int)cudaErrorInvalidValue;
  PairSet sets[N_SETS];
  for (int s = 0; s < N_SETS; ++s) {
    const int* q = plan + PLAN_INTS * s;
    const cudaError_t err =
        make_set(ra[s], rf[s], rm[s], ca[s], cf[s], cm[s], rows[s], cols[s],
                 q[0], q[1], q[2], s == POST, q[3], q[4], q[5], q[6], sets[s]);
    if (err != cudaSuccess) return (int)err;
    if (!fits(sets[s], sizes)) return (int)cudaErrorInvalidValue;
    sets[s].row_lane = row_lane[s];
    sets[s].col_lane = col_lane[s];
    if (!lanes_aligned(sets[s], lanes))
      return (int)cudaErrorMisalignedAddress;
    sets[s].out_g = out_f;
    sets[s].out_sum = out_f + NG + s;
    sets[s].out_n = out_n + s;
    sets[s].out_tiles = out_n + OUT_TILES + s;
  }
  Sweep w;
  // the post set first: its items are the longest
  const PairSet order[N_SETS] = {sets[POST], sets[PRE], sets[FIXED],
                                 sets[MOVING]};
  const int items = make_sweep(order, N_SETS, w);
  w.lanes = lanes;
  w.lane_fpart = sizes[0];
  w.lane_npart = sizes[1];
  w.lane_gpart = sizes[2];
  w.lane_gnpart = sizes[3];
  w.lane_out_f = NG + N_SETS;
  w.lane_out_n = sizes[4];
  w.level2 = out_n + OUT_LEVEL2;
  w.level1 = out_n + OUT_LEVEL1;
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
  const cudaError_t err =
      cudaMemsetAsync(out_n, 0, (size_t)lanes * sizes[4] * sizeof(int),
                      stream);
  if (err != cudaSuccess) return (int)err;
  if (lanes == 1)
    suite_sweep<false><<<items, THREADS, 0, stream>>>(w);
  else
    suite_sweep<true><<<lanes * items, THREADS, 0, stream>>>(w);
  return (int)cudaGetLastError();
}
