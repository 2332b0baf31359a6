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
// What bounds it: arithmetic. At CAP 3072 the gate sweep visits 9.4 M
// pairs: ~11 operations for the geometric distance of every valid pair,
// ~15 for the colour distance inside the geometric gate, ~8 for the joint
// kernel of a gated pair; a kept pair (0.14% at ell 0.15) adds ~10 (flow)
// and ~67 (step). It reads ~0.2 MB.
//
// The design, against what held the first version back:
//   1. the card is filled: the grid is the plan's work items (row tile x
//      column chunk), sized from the sweep kernel's occupancy x SMs
//      (flow_step_geometry, cvo/kernels.plan_split): 576 blocks at CAP
//      3072 where the first version ran 192;
//   2. the gate is tested once per iteration: pass 1 records the kept
//      pairs in a bitmask (N x ceil(M/32) words, 1.2 MB at CAP 3072, held
//      in L2) and pass 2 walks only its set bits, in column order, so the
//      order of its sums is fixed; mode 2 has no pass 1 and sweeps the gate;
//   3. the finalize is parallel: the last block of each pass (an integer
//      ticket after a thread fence) sums the partials with all its threads,
//      a fixed strided share each, then the block's tree: 2 launches per
//      iteration where the first version made 4;
//   4. rows are register-blocked (4 rows per thread, so each column read
//      from shared memory serves 4 FMA chains) and column tiles are packed
//      for 16-byte loads and staged with double-buffered cp.async;
//   5. no tensor cores: the gate's d^2 must round as the FMA chain of the
//      plain version (a TF32 or 3xTF32 product rounds otherwise and flips
//      gates), and the kept-pair sums are too sparse for an MMA;
//   6. tile skipping, as the Pallas kernels skip (flow_step.cuh): the gate
//      sweep computes only the (row tile, column tile) pairs whose boxes
//      lie within the gate radius, plus a stated slack; the boxes are taken
//      inside the kernel (rows once per item, each column tile as it is
//      packed), so skipping adds no launch.
// -fmad=false, no float atomics, integer counts; any capacity by masking.

#include "flow_step.cuh"

namespace {

// pass 1: the item's partials and bitmask words, its computed tile pairs
// added to out_n[3]; the last block sums the partials into out_f[0:6] =
// omega, v and out_n[0] = nnz
__global__ void __launch_bounds__(THREADS)
flow_pass(Clouds cl, Split sp, const float* __restrict__ ell_ptr, Consts c,
          float cc, float dd, int skip, unsigned* __restrict__ bits,
          float* __restrict__ fpart, int* __restrict__ npart,
          float* __restrict__ out_f, int* __restrict__ out_n) {
  __shared__ Stage s;
  __shared__ RowColours rows;
  __shared__ Red red;
  __shared__ float wv[6];
  __shared__ int nnz, last;
  const Pose none{};
  const int tiles = flow_item<false>(cl, sp, blockIdx.x, none, *ell_ptr, c,
                                     skip != 0, s, rows, red, bits, fpart,
                                     npart);
  if (threadIdx.x == 0) atomicAdd(out_n + 3, tiles);   // an integer count
  if (!last_block(out_n + 1, sp.items, &last)) return;
  finalize_flow(fpart, npart, sp.items, cc, dd, red, wv, &nnz);
  if (threadIdx.x < 6) out_f[threadIdx.x] = wv[threadIdx.x];
  if (threadIdx.x == 0) out_n[0] = nnz;
}

// pass 2 for the flow wv_in = (omega, v): from pass 1's bitmask (FROM_BITS)
// or by its own gate sweep (its computed tile pairs added to out_n[3]); the
// last block sums out_f[6:10] = B, C, D, E
template <bool FROM_BITS>
__global__ void __launch_bounds__(THREADS)
step_pass(Clouds cl, Split sp, const float* __restrict__ ell_ptr,
          const float* __restrict__ wv_in, Consts c, int skip,
          const unsigned* __restrict__ bits, float* __restrict__ spart,
          float* __restrict__ out_f, int* __restrict__ out_n) {
  __shared__ RowColours rows;
  __shared__ Red red;
  __shared__ float w_v[6], bcde[N_STEP];
  __shared__ int last;
  if (threadIdx.x < 6) w_v[threadIdx.x] = __ldcg(wv_in + threadIdx.x);
  __syncthreads();
  const float ell = *ell_ptr;
  if constexpr (FROM_BITS) {
    const Pose none{};
    step_item<false>(cl, sp, blockIdx.x, none, ell, w_v, w_v + 3, c, rows,
                     red, bits, spart);
  } else {
    __shared__ Stage s;
    const int tiles = step_sweep_item(cl, sp, blockIdx.x, ell, w_v, w_v + 3,
                                      c, skip != 0, s, rows, red, spart);
    if (threadIdx.x == 0) atomicAdd(out_n + 3, tiles);
  }
  if (!last_block(out_n + 2, sp.items, &last)) return;
  finalize_step(spart, sp.items, red, bcde);
  if (threadIdx.x < N_STEP) out_f[6 + threadIdx.x] = bcde[threadIdx.x];
}

}  // namespace

// Plain C entry point (loaded with ctypes): the geometry the wrapper plans
// the split with. out (4 ints): resident blocks per SM of the sweep kernel,
// SMs, rows per work item, columns per tile. Returns the CUDA error code.
extern "C" int flow_step_geometry(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flow_pass,
                                                      THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = ROWS;
  out[3] = CT;
  return (int)cudaSuccess;
}

// Plain C entry point (loaded with ctypes). Launches the passes of `mode`
// (0 both, 1 flow, 2 step) on `stream`, one block per work item of the
// split (chunks chunks of per_chunk column tiles); returns the CUDA error
// code of the launches (0 = success). Rows x/fx/mx (N), columns y/fy/my
// (M, each 16-byte aligned). wv_in: omega, v (6 floats on the device) for
// mode 2. skip: 1 skips the tile pairs whose boxes lie beyond the gate
// (flow_step.cuh), 0 computes every pair; the outputs are the same bit for
// bit. Scratch, items = ceil(N/512) * chunks: bits ceil(M/32) * N words
// (modes 0, 1; on return, pass 1's keep bitmask), fpart 6 * items
// floats, npart items ints, spart 4 * items floats. out_f (10 floats):
// omega, v, B, C, D, E; out_n (4 ints, zero on entry): nnz, the two
// passes' tickets and the tile pairs the gate sweep computed (of
// ceil(N/512) * ceil(M/32)).
// A mode writes only its own outputs.
extern "C" int flow_and_step_launch(
    int mode, const float* x, const float* fx, const unsigned char* mx,
    const float* y, const float* fy, const unsigned char* my,
    const float* ell, int N, int M, int chunks, int per_chunk,
    float log_ratio, float d2ct, float two_cl2, float s2cs2, float sp_thres,
    float c, float d, int skip, const float* wv_in, unsigned* bits,
    float* fpart, int* npart, float* spart, float* out_f, int* out_n,
    cudaStream_t stream) {
  Split sp;
  if (mode < 0 || mode > 2 || !make_split(N, M, chunks, per_chunk, sp))
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)y) | ((uintptr_t)fy) | ((uintptr_t)my)) & 15)
    return (int)cudaErrorMisalignedAddress;
  Consts k{};
  k.log_ratio = log_ratio;
  k.d2ct = d2ct;
  k.two_cl2 = two_cl2;
  k.s2cs2 = s2cs2;
  k.sp_thres = sp_thres;
  const Clouds cl{x, fx, mx, y, fy, my};
  cudaError_t err;
  if (mode != 2) {
    flow_pass<<<sp.items, THREADS, 0, stream>>>(cl, sp, ell, k, c, d, skip,
                                                bits, fpart, npart, out_f,
                                                out_n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (mode == 0) {
    step_pass<true><<<sp.items, THREADS, 0, stream>>>(
        cl, sp, ell, out_f, k, skip, bits, spart, out_f, out_n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  } else if (mode == 2) {
    step_pass<false><<<sp.items, THREADS, 0, stream>>>(
        cl, sp, ell, wv_in, k, skip, nullptr, spart, out_f, out_n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
