// The whole CVO align loop (cvo.cpp:763-821) in one launch, for sm_90a,
// over S lanes: lane l aligns moving cloud l against fixed cloud l (or one
// fixed cloud shared by every lane), each lane as its solo run.
//
// Replaces: cvo_slam_tpu/cvo/pallas_align.py:align_fused (kernel body
// _align_kernel), the align of the `pallas` backend and of loop-closure
// verification under `pallas` and `pallas_iter`; its lanes replace the
// grid dimension that vmap prepends to it (the lockstep tracker,
// parallel/batch.batched_align, engine.lc_verify_batch). Its plain PyTorch
// version is cvo/kernels.align_fused_plain (per lane: align_fused_lanes_
// plain): engine.align_loop over ops/pairwise.flow_and_step, ops/cubic and
// ops/se3.
//
// A persistent cooperative kernel: the grid is at most as large as the
// card can hold at once (occupancy x SMs), launched with
// cudaLaunchCooperativeKernel, and every block loops over the work items
// (row tile x column chunk, flow_step.cuh) of both passes of every lane
// still running. Per iteration:
//   1. every block transforms the moving columns it stages, y = y0 R + Tt
//      with Tt = -R^T T of the item's lane, with no global write;
//   2. pass 1 (flow_step.cuh): the gate sweep, the keep bitmask and the
//      flow partials of each running lane; grid.sync();
//   3. every block sums each running lane's flow partials in the same fixed
//      order, so every block holds bit-identical omega, v and nnz;
//   4. pass 2 over the set bits of the bitmasks, partials, grid.sync();
//   5. every block sums each running lane's B..E and runs the lanes'
//      scalar epilogues redundantly, one thread per lane: the smallest
//      positive root of the step cubic (cvo.cpp:317-333), Exp_SEK3
//      (LieGroup.cpp:159-186), the se3 distance of the increment (cvo.cpp:
//      94-104), both stop rules and the ell anneal (cvo.cpp:782, :804,
//      :810-812). Every block reaches the same `done` of every lane, so no
//      third barrier is needed: the next iteration's pass 1 writes flow
//      partials and bitmask words that every block finished reading before
//      step 4's barrier, and pass 2 writes step partials only after the
//      next pass-1 barrier.
// The state and its epilogue are align_state.cuh's, which the pallas_mom
// loop's state launch (moment_step.cu) shares; they mirror
// pallas_align.py:67-181 (and the plain ops/cubic, ops/se3) with CUDA's
// acosf and cbrtf.
//
// Tile skipping. Pass 1 computes only the (row tile, column tile) pairs
// whose boxes lie within the gate radius plus flow_step.cuh's rounding
// slack; a skipped pair writes zero bitmask words (pass 2 then walks no
// bit of it) and adds nothing to any partial, so iterations, ell, nnz and
// the transform are those of the unskipped launch, bit for bit (skip = 0
// keeps it reachable). The Pallas kernel takes its flags once per call
// from the warm-start pose, for each ell of the anneal schedule, with the
// radius widened by skip_margin, bounds the accumulated motion (rmax, cum)
// and computes every tile once that bound passes the margin
// (pallas_align.py:196-210, :379-382, :408-461): on a TPU the tile lists
// must be fixed before the grid runs. Here every block already stages and
// transforms the moving columns itself at each iteration (step 1), so the
// column tile's box is taken from the transformed columns as warp 0 packs
// them, and the row tile's box once per item: the flags are those of the
// current pose and ell, with no margin, no motion bound and no fall-back,
// and no launch or host work is added. Each block counts the tile pairs
// its pass-1 items computed, lane by lane, and adds them to the lane's
// count when the loop ends (integer atomics; block 0 zeroes the counts
// before the first grid barrier).
//
// Lanes (vmap of the while loop): each lane keeps the solo plan
// (cvo/kernels.plan_split), its own bitmask, flow, count and step
// partials, and its state (R, T, ell, done, iters, nnz) in every block's
// shared memory, and reads its clouds at the lanes' strides (points, at
// least the capacity: cvo/engine.stack_clouds rounds a stack's up to 16
// points, so every lane is 16-byte aligned at any capacity). A lane that
// has stopped is frozen: its items are skipped and its state no longer
// changes, but every block still reaches each
// grid.sync(); the loop ends when every lane has stopped or at max_iter,
// and each lane reports its own iteration count. The items of the running
// lanes are dealt to the blocks as one list, lane after lane, so a stopped
// lane leaves no block idle. Each lane's sums run in the solo order, so
// every lane equals its solo launch bit for bit, and the solo wrapper is
// the launch of one lane.
//
// What bounds it: arithmetic, as flow_step.cu, times the iterations; the
// clouds (~0.2 MB a lane) and the bitmask (1.2 MB a lane at CAP 3072) stay
// in L2.
//
// The design, against what held the first version back:
//   1. the card is filled: the plan (cvo/kernels.plan_split) sizes the
//      work items to the resident grid that align_fused_geometry reports
//      (occupancy x SMs), so roughly every resident block has one item
//      (576 items at CAP 3072, where the first version's 192 blocks left
//      most of the card empty); S lanes give S times the items;
//   2. the gate is tested once per iteration: pass 1 records the kept
//      pairs in the bitmask and pass 2 walks only its set bits (0.14% of
//      the pairs at ell 0.15), in a fixed order;
//   3. the finalize is parallel: all threads of every block sum a lane's
//      partials, a fixed strided share each, then the block's tree; every
//      block gets bit-identical sums (lane after lane: each block reads
//      S x 576 partials of each pass);
//   4. rows are register-blocked and column tiles packed and staged with
//      double-buffered cp.async (flow_step.cuh);
//   5. no tensor cores: the gate's d^2 must round as the FMA chain of the
//      plain version, and the kept-pair sums are too sparse for an MMA.

#include <cooperative_groups.h>

#include "align_state.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LANES = 32;   // lanes of one launch (kernels.MAX_LANES)

// the clouds of lane l at the lane strides (points): moving cloud l
// (y_lane >= M), fixed cloud l (x_lane >= N, or 0 for one fixed cloud of
// every lane)
__device__ __forceinline__ Clouds lane_clouds(const Clouds& cl, int l,
                                              int x_lane, int y_lane) {
  const size_t xo = (size_t)l * x_lane, yo = (size_t)l * y_lane;
  return Clouds{cl.x + 3 * xo, cl.fx + 5 * xo, cl.mx + xo,
                cl.y + 3 * yo, cl.fy + 5 * yo, cl.my + yo};
}

// the lanes still running, in lane order (thread 0); the caller syncs
__device__ __forceinline__ void list_running(const State* st, int lanes,
                                             int* running, int* n_running) {
  if (threadIdx.x == 0) {
    int n = 0;
    for (int l = 0; l < lanes; ++l)
      if (!st[l].done) running[n++] = l;
    *n_running = n;
  }
}

// at most 102 registers, so 5 blocks fit on an SM and the 576 work items at
// CAP 3072 run at once on 132 SMs (unbounded, ptxas takes 128 registers and
// 4 blocks per SM: 37.8 against 33.5 us per iteration on the H100).
// LANES: the launch of several lanes (the running lanes listed in shared
// memory after every epilogue); one lane takes the loop without the list,
// so the one-lane align keeps its speed. Both run the same arithmetic.
template <bool LANES>
__global__ void __launch_bounds__(THREADS, 5)
align_kernel(Clouds cl, int x_lane, int y_lane, Split sp, int lanes,
             const float* __restrict__ init, AlignParams prm,
             unsigned* __restrict__ bits, float* __restrict__ fpart,
             int* __restrict__ npart, float* __restrict__ spart,
             float* __restrict__ out_f, int* __restrict__ out_n) {
  constexpr int L = LANES ? MAX_LANES : 1;
  cg::grid_group grid = cg::this_grid();
  __shared__ Stage s;
  __shared__ RowColours rows;
  __shared__ Red red;
  __shared__ State st[L];
  __shared__ float wv[L][6], bcde[L][N_STEP];
  __shared__ int nnz_k[L];
  __shared__ int tiles[L];   // the lanes' tile pairs this block computed
  __shared__ int running[L];
  __shared__ int n_running;

  const int tid = threadIdx.x;
  const int items = sp.items;
  // each lane's scratch
  const size_t lane_bits = (size_t)sp.col_tiles * sp.N;
  if (tid < (LANES ? lanes : 1)) {
    const float* in = init + 13 * tid;
    State& q = st[tid];
    for (int i = 0; i < 9; ++i) q.R[i] = in[i];
    for (int i = 0; i < 3; ++i) q.T[i] = in[9 + i];
    q.ell = in[12];
    q.done = 0;
    q.iters = prm.max_iter;
    q.nnz = 0;
    tiles[tid] = 0;
    if (blockIdx.x == 0) out_n[3 * tid + 2] = 0;   // before any grid.sync
  }
  __syncthreads();
  if constexpr (LANES) {
    list_running(st, lanes, running, &n_running);
    __syncthreads();
  }

  for (int k = 0; k < prm.max_iter; ++k) {
    const int n_run = LANES ? n_running : 1;
    const int work = n_run * items;
    const Pose pose = pose_of(st[0]);   // lane 0's (LANES: per item)
    for (int a = blockIdx.x; a < work; a += gridDim.x) {
      if constexpr (LANES) {
        const int l = running[a / items];
        const int t = flow_item<true>(
            lane_clouds(cl, l, x_lane, y_lane), sp, a % items,
            pose_of(st[l]), st[l].ell, prm.k, prm.skip != 0, s, rows, red,
            bits + l * lane_bits, fpart + l * N_FLOW * items,
            npart + l * items);
        if (tid == 0) tiles[l] += t;
      } else {
        const int t = flow_item<true>(cl, sp, a, pose, st[0].ell, prm.k,
                                      prm.skip != 0, s, rows, red, bits,
                                      fpart, npart);
        if (tid == 0) tiles[0] += t;
      }
    }
    __threadfence();
    grid.sync();
    for (int j = 0; j < n_run; ++j) {
      const int l = LANES ? running[j] : 0;
      finalize_flow(fpart + l * N_FLOW * items, npart + l * items, items,
                    prm.c, prm.d, red, wv[l], &nnz_k[l]);
    }
    for (int a = blockIdx.x; a < work; a += gridDim.x) {
      if constexpr (LANES) {
        const int l = running[a / items];
        step_item<true>(lane_clouds(cl, l, x_lane, y_lane), sp, a % items,
                        pose_of(st[l]), st[l].ell, wv[l], wv[l] + 3, prm.k,
                        rows, red, bits + l * lane_bits,
                        spart + l * N_STEP * items);
      } else {
        step_item<true>(cl, sp, a, pose, st[0].ell, wv[0], wv[0] + 3,
                        prm.k, rows, red, bits, spart);
      }
    }
    __threadfence();
    grid.sync();
    for (int j = 0; j < n_run; ++j) {
      const int l = LANES ? running[j] : 0;
      finalize_step(spart + l * N_STEP * items, items, red, bcde[l]);
    }
    if (tid < n_run) {
      const int l = LANES ? running[tid] : 0;
      epilogue(st[l], k, wv[l], nnz_k[l], bcde[l], prm);
    }
    __syncthreads();
    if constexpr (LANES) {
      list_running(st, lanes, running, &n_running);
      __syncthreads();
      if (n_running == 0) break;
    } else if (st[0].done) {
      break;
    }
  }
  if (tid < (LANES ? lanes : 1) && tiles[tid] != 0)
    atomicAdd(out_n + 3 * tid + 2, tiles[tid]);   // an integer count
  if (blockIdx.x == 0 && tid < (LANES ? lanes : 1)) {
    const State& q = st[tid];
    for (int i = 0; i < 9; ++i) out_f[13 * tid + i] = q.R[i];
    for (int i = 0; i < 3; ++i) out_f[13 * tid + 9 + i] = q.T[i];
    out_f[13 * tid + 12] = q.ell;
    out_n[3 * tid] = q.iters;
    out_n[3 * tid + 1] = q.nnz;
  }
}

// the resident grid: blocks per SM of align_kernel and SMs; refuses a card
// without cooperative launch and a kernel that fits no block on an SM
template <bool LANES>
cudaError_t resident(int* per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, align_kernel<LANES>, THREADS, 0);
  if (err != cudaSuccess) return err;
  return *per_sm < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

}  // namespace

// Plain C entry point (loaded with ctypes): the geometry the wrapper plans
// the split with. out (4 ints): resident blocks per SM of the align kernel,
// SMs, rows per work item, columns per tile. Returns the CUDA error code.
extern "C" int align_fused_geometry(int* out) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = resident<false>(&per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = ROWS;
  out[3] = CT;
  return (int)cudaSuccess;
}

// Plain C entry point (loaded with ctypes): one cooperative launch on
// `stream` for `lanes` alignments (1 <= lanes <= MAX_LANES): moving cloud
// l, y0/fy/my + l y_lane points (M of them, y_lane >= M; each lane's
// arrays 16-byte aligned), against fixed cloud l, x/fx/mx + l x_lane
// points (N of them, x_lane >= N, or 0 when every lane aligns against one
// fixed cloud), over the split of `chunks` chunks
// of per_chunk column tiles. init (13 floats a lane, on the device): R0
// (row-major), T0, ell0. hf (host, 14 floats): log_ratio, d2ct, two_cl2,
// s2cs2, sp_thres, c, d, eps, eps_2, min_step, max_step, the 3 anneal
// values; hi (host, 5 ints): the 3 anneal iterations, max_iter, skip (1:
// tile skipping, 0: every tile pair; the outputs are the same bit for
// bit). Scratch a lane, items = ceil(N/512) * chunks: bits ceil(M/32) * N
// words, fpart 6 * items floats, npart items ints, spart 4 * items floats,
// lane after lane. out_f (13 floats a lane): R, T, ell; out_n (3
// ints a lane): iters, nnz, and the tile pairs pass 1 computed over the
// lane's iterations (of ceil(N/512) * ceil(M/32) an iteration). info
// (host, 4 ints): grid, blocks per SM, SMs, work items of the
// launch. Returns the CUDA error code (0 = success); a card without
// cooperative launch, or a kernel that fits no block on an SM, is refused
// before anything runs.
extern "C" int align_fused_launch(
    const float* x, const float* fx, const unsigned char* mx,
    const float* y0, const float* fy, const unsigned char* my, int N, int M,
    int lanes, int x_lane, int y_lane, int chunks, int per_chunk,
    const float* init,
    const float* hf, const int* hi, unsigned* bits, float* fpart,
    int* npart, float* spart, float* out_f, int* out_n, int* info,
    cudaStream_t stream) {
  Split sp;
  if (!make_split(N, M, chunks, per_chunk, sp) || lanes < 1
      || lanes > MAX_LANES || (x_lane != 0 && x_lane < N) || y_lane < M)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < lanes; ++l) {
    const size_t o = (size_t)l * y_lane;
    if ((((uintptr_t)(y0 + 3 * o)) | ((uintptr_t)(fy + 5 * o))
         | ((uintptr_t)(my + o))) & 15)
      return (int)cudaErrorMisalignedAddress;
  }
  int per_sm = 0, sms = 0;
  cudaError_t err = lanes == 1 ? resident<false>(&per_sm, &sms)
                               : resident<true>(&per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  const int work = lanes * sp.items;
  const int grid = work < per_sm * sms ? work : per_sm * sms;
  info[0] = grid;
  info[1] = per_sm;
  info[2] = sms;
  info[3] = work;

  AlignParams prm = align_params(hf, hi);
  Clouds cl{x, fx, mx, y0, fy, my};
  void* args[] = {(void*)&cl,     (void*)&x_lane, (void*)&y_lane,
                  (void*)&sp,     (void*)&lanes,  (void*)&init,
                  (void*)&prm,    (void*)&bits,   (void*)&fpart,
                  (void*)&npart,  (void*)&spart,  (void*)&out_f,
                  (void*)&out_n};
  const void* kernel = lanes == 1 ? (const void*)align_kernel<false>
                                  : (const void*)align_kernel<true>;
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(THREADS), args,
                                    0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
