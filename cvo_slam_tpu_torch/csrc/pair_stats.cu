// Pair stats of compute_innerproduct_lc, for sm_90a.
//
// Replaces: cvo_slam_tpu/cvo/pallas_kernels.py:pair_stats (kernel body
// _stats_kernel), whose plain twin is ops/pairwise.py:pair_stats. Rows xa
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
// to reduce the partials serially):
//   * one launch per call in both modes, on flow_step.cuh's work split: a
//     work item is a tile of ROWS rows (RB per thread: -2 xa and |xa|^2 in
//     registers, colours in shared memory) against a chunk of 32-column
//     tiles of xb, staged with double-buffered cp.async and packed for
//     16-byte loads; the plan sizes the items to the card's resident grid
//     (pair_stats_geometry, per template; cvo/kernels.plan_split);
//   * per row: the f32 sum, the integer count and, with moments, the 13
//     sums (W U(xb))_r, which live in shared memory (each thread touches
//     only its own rows);
//   * each item writes its partial sum and count and, with moments, its
//     169 entries of sum over its rows r of U(xa_r)^T (W U(xb))_r, only
//     over the rows with a gated pair (a bitmask walked with __ffs): warp
//     w takes the w-th quarter of the local rows, in order, a lane six
//     entries at once, and the warps' sums are added in warp order;
//   * the items' partials are summed in item order in two levels, each
//     with an integer ticket (flow_step.cuh's last_block): the last block
//     of each group of `group` consecutive items sums the group's items
//     into a group partial, and the last group to finish sums the groups
//     into out_f / out_n. A thread loads 32 partials at once before it adds
//     them in order, so neither level waits on one load after another.
// The per-pair float operations are those of the first version, each in
// its order: the FMA-chain colour dot, the colour gate, the distance by
// the dot identity (rounded as ident_d2, through -2 xa: exact), the
// geometric gate, the two clamped exponentials. The geometric gate is
// tested first because it is the cheaper test and passes far fewer pairs
// (the colour gate passes almost every pair of a scene); a pair is counted
// only when both pass, so the order of the tests changes no result. A
// masked or missing point gets |p|^2 = +inf (flow_step.cuh), so no gate
// passes. -fmad=false, integer counts, no float atomics, f32 sums in one
// fixed order: two launches give bitwise-equal results. Any capacity
// works: rows and columns past the end are masked.

#include <type_traits>

#include "flow_step.cuh"

namespace {

constexpr int NU = 13;
constexpr int NG = NU * NU;

__device__ __forceinline__ float lift(const float* p, int a) {
  if (a == 0) return 1.f;
  if (a < 4) return p[a - 1];
  const int q = a - 4;
  return p[q / 3] * p[q % 3];
}

// lift(p, a) as the product P[ia] * P[ib] of P = (1, p0, p1, p2): 1 * 1,
// p * 1 and the same two coordinates, so the same value bit for bit
__device__ __forceinline__ void lift_pair(int a, int& ia, int& ib) {
  if (a == 0) {
    ia = 0;
    ib = 0;
  } else if (a < 4) {
    ia = a;
    ib = 0;
  } else {
    ia = 1 + (a - 4) / 3;
    ib = 1 + (a - 4) % 3;
  }
}


constexpr int ROW_STRIDE = ROWS + 1;   // padded: one bank per quantity

// row positions, written over the row colours once the sweep is done:
// p[0] = 1, p[1 + c] = coordinate c, so that U(x)[a] = p[ia][r] * p[ib][r]
// with the index pair of lift_pair (every product is lift's, exactly)
struct RowPositions {
  float p[4 * ROW_STRIDE];
};

union RowShared {
  RowColours colours;
  RowPositions positions;
};

// with moments: (W U(xb))_r of every row of the item, and which rows have
// a gated pair (bit lane of word r * NWARPS + warp: local row
// r * THREADS + threadIdx.x)
struct Moments {
  float wu[NU * ROW_STRIDE];   // wu[b * ROW_STRIDE + local row]
  unsigned active[ROWS / 32];
};

constexpr int G_PER_LANE = (NG + 31) / 32;   // entries of G per lane
constexpr int G_WORDS = ROWS / 32 / NWARPS;   // active-row words per warp
static_assert(G_WORDS * NWARPS * 32 == ROWS, "the warps share the rows");
// the warps' partial G, written over the stage once the sweep is done
static_assert(sizeof(Stage) >= NWARPS * NG * sizeof(float),
              "the stage holds the warps' partial G");

constexpr int BATCH = 32;   // partials a thread loads before it adds them

// Partials q = tid, tid + THREADS, ... < NF of src (NF floats per item)
// summed over items [b0, b1) in item order into dst[q]; the items' counts
// (order-free integers) into *dst_n (thread 0). Every thread of the block
// calls it; it ends with __syncthreads.
template <int NF>
__device__ void sum_in_order(const float* src, const int* src_n, int b0,
                             int b1, Red& red, float* dst, int* dst_n) {
  for (int q = threadIdx.x; q < NF; q += THREADS) {
    float acc = 0.f;
    for (int base = b0; base < b1; base += BATCH) {
      float v[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k)
        v[k] = base + k < b1 ? __ldcg(src + (size_t)(base + k) * NF + q)
                             : 0.f;
#pragma unroll
      for (int k = 0; k < BATCH; ++k)
        if (base + k < b1) acc += v[k];
    }
    dst[q] = acc;
  }
  int n[1] = {0};
  for (int b = b0 + (int)threadIdx.x; b < b1; b += THREADS)
    n[0] += __ldcg(src_n + b);
  block_sum_n<NWARPS>(n, red.i, &red.iout);
  if (threadIdx.x == 0) *dst_n = red.iout;
  __syncthreads();
}

struct Empty {};

template <bool MOM>
__global__ void __launch_bounds__(THREADS)
pair_stats_sweep(Clouds cl, Split sp, int group,
                 const float* __restrict__ ell_ptr, Consts c,
                 float* __restrict__ fpart, int* __restrict__ npart,
                 float* __restrict__ gpart, int* __restrict__ gnpart,
                 float* __restrict__ out_f, int* __restrict__ out_n) {
  constexpr int NF = MOM ? NG + 1 : 1;   // floats per item partial
  using MomShared = typename std::conditional<MOM, Moments, Empty>::type;
  __shared__ Stage s;
  __shared__ RowShared rs;
  __shared__ MomShared ms;
  __shared__ Red red;
  __shared__ int last;
  const int item = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Item it = item_of(sp, item);
  Rows R;
  load_rows(cl, sp, it.rt, R, rs.colours);
  const float ell = *ell_ptr;
  const float cut = geo_cut(-2.f * ell * ell * c.log_ratio);
  const float den = 2.f * ell * ell;
  float sr[RB] = {};
  int nr[RB] = {};
  if constexpr (MOM) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
      for (int b = 0; b < NU; ++b)
        ms.wu[b * ROW_STRIDE + r * THREADS + tid] = 0.f;
  }
  const Pose none{};
  sweep<false>(cl, sp, it, none, s, [&](int, const PackedTile& pk) {
#pragma unroll 2
    for (int k = 0; k < CT; ++k) {
      const float4 p = pk.p[k];
      float z[RB];
      bool any = false;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        z[r] = geo_z(R, r, p);
        any |= z[r] < cut;
      }
      if (!any) continue;
      const float col[5] = {pk.fa[k].x, pk.fa[k].y, pk.fa[k].z, pk.fa[k].w,
                            pk.fb[k].x};
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (!(z[r] < cut)) continue;
        const int lr = r * THREADS + tid;
        const RowColours& F = rs.colours;
        float cdot = F.f[0][lr] * col[0];
        for (int q = 1; q < 5; ++q) cdot = __fmaf_rn(F.f[q][lr], col[q], cdot);
        const float d2c = fmaxf(F.ff[lr] + pk.fb[k].y - 2.f * cdot, 0.f);
        if (!(d2c < c.d2ct)) continue;
        const float d2 = fmaxf(z[r], 0.f);
        const float ck = clamped_kernel(c.cs2, -d2c / c.two_cl2);
        const float kv = clamped_kernel(c.s2, -d2 / den);
        sr[r] += ck * kv;
        ++nr[r];
        if constexpr (MOM) {
          const float w = kv * cdot;
          const float pb[3] = {p.x, p.y, p.z};
#pragma unroll
          for (int b = 0; b < NU; ++b)
            ms.wu[b * ROW_STRIDE + lr] += w * lift(pb, b);
        }
      }
    }
  });

  // the item's partials: the sum (rows in order, then the block's tree),
  // the count and, with moments, G over the rows with a gated pair
  float sv[1] = {0.f};
  int nv[1] = {0};
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    sv[0] += sr[r];
    nv[0] += nr[r];
  }
  block_sum_n<NWARPS>(sv, red.f, red.out);
  block_sum_n<NWARPS>(nv, red.i, &red.iout);
  if constexpr (MOM) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const unsigned b = __ballot_sync(0xffffffffu, nr[r] > 0);
      if (lane == 0) ms.active[r * NWARPS + warp] = b;
    }
    // the sweep ended with __syncthreads: the colours and the stage are
    // no longer read
    float* P = rs.positions.p;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float x[3];
      row_x(R, r, x);
      const int lr = r * THREADS + tid;
      P[lr] = 1.f;
      for (int q = 0; q < 3; ++q) P[(1 + q) * ROW_STRIDE + lr] = x[q];
    }
    __syncthreads();
    // lane entries e = lane + 32 k: G[a][b] += U(x_r)[a] * (W U)_r[b]
    int pa[G_PER_LANE], pb[G_PER_LANE], wb[G_PER_LANE];
    float g[G_PER_LANE];
#pragma unroll
    for (int k = 0; k < G_PER_LANE; ++k) {
      const int e = min(lane + 32 * k, NG - 1);
      int ia, ib;
      lift_pair(e / NU, ia, ib);
      pa[k] = ia * ROW_STRIDE;
      pb[k] = ib * ROW_STRIDE;
      wb[k] = (e % NU) * ROW_STRIDE;
      g[k] = 0.f;
    }
    // warp w: the active rows of the w-th quarter of the local rows
    for (int wd = warp * G_WORDS; wd < (warp + 1) * G_WORDS; ++wd) {
      unsigned word = ms.active[wd];
      while (word) {
        const int lr = wd * 32 + __ffs(word) - 1;
        word &= word - 1;
#pragma unroll
        for (int k = 0; k < G_PER_LANE; ++k)
          g[k] += (P[pa[k] + lr] * P[pb[k] + lr]) * ms.wu[wb[k] + lr];
      }
    }
    float* part = reinterpret_cast<float*>(&s);
#pragma unroll
    for (int k = 0; k < G_PER_LANE; ++k)
      if (lane + 32 * k < NG) part[warp * NG + lane + 32 * k] = g[k];
    __syncthreads();
    for (int e = tid; e < NG; e += THREADS) {
      float t = part[e];
      for (int w = 1; w < NWARPS; ++w) t += part[w * NG + e];
      __stcg(fpart + (size_t)item * NF + e, t);
    }
  }
  if (tid == 0) {
    __stcg(fpart + (size_t)item * NF + NF - 1, red.out[0]);
    __stcg(npart + item, red.iout);
  }

  __threadfence();   // every thread's partials, before the tickets

  // level 1: the last block of the item's group sums the group
  const int g = item / group;
  const int g0 = g * group, g1 = min(g0 + group, sp.items);
  if (!last_block(out_n + 2 + g, g1 - g0, &last)) return;
  sum_in_order<NF>(fpart, npart, g0, g1, red, gpart + (size_t)g * NF,
                   gnpart + g);
  __threadfence();
  // level 2: the last group sums the groups into out_f[NG + 1 - NF + q]
  // (G at 0:169 with moments, the sum at 169) and out_n[0] (the count)
  const int groups = (sp.items + group - 1) / group;
  if (!last_block(out_n + 1, groups, &last)) return;
  sum_in_order<NF>(gpart, gnpart, 0, groups, red, out_f + NG + 1 - NF,
                   out_n);
}

template <bool MOM>
int geometry_of(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pair_stats_sweep<MOM>, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = ROWS;
  out[3] = CT;
  return (int)cudaSuccess;
}

}  // namespace

// Plain C entry point (loaded with ctypes): the geometry the wrapper plans
// the split with, for the template of `with_moments`. out (4 ints):
// resident blocks per SM, SMs, rows per work item, columns per tile.
// Returns the CUDA error code.
extern "C" int pair_stats_geometry(int with_moments, int* out) {
  return with_moments ? geometry_of<true>(out) : geometry_of<false>(out);
}

// Plain C entry point (loaded with ctypes): rows xa/fa/ma (N), columns
// xb/fb/mb (M, each 16-byte aligned), one block per work item of the split
// (chunks chunks of per_chunk column tiles; items = ceil(N / ROWS) *
// chunks), the finalize in groups of `group` items (groups =
// ceil(items / group)). NF = 170 floats per partial with moments, else 1.
// Scratch: fpart items * NF floats, npart items ints, gpart groups * NF
// floats, gnpart groups ints. out_f (170 floats): G at 0:169 (with moments
// only), the sum at 169; out_n (2 + groups ints): the count, then the
// tickets, which this function zeroes on `stream` before the launch.
// Returns the CUDA error code (0 = success).
extern "C" int pair_stats_launch(
    const float* xa, const float* fa, const unsigned char* ma,
    const float* xb, const float* fb, const unsigned char* mb,
    const float* ell, int N, int M, int chunks, int per_chunk, int group,
    int with_moments, float log_ratio, float d2ct, float s2, float cs2,
    float two_cl2, float* fpart, int* npart, float* gpart, int* gnpart,
    float* out_f, int* out_n, cudaStream_t stream) {
  Split sp;
  if (!make_split(N, M, chunks, per_chunk, sp) || group <= 0)
    return (int)cudaErrorInvalidValue;
  const int groups = (sp.items + group - 1) / group;
  if ((((uintptr_t)xb) | ((uintptr_t)fb) | ((uintptr_t)mb)) & 15)
    return (int)cudaErrorMisalignedAddress;
  Consts k{};
  k.log_ratio = log_ratio;
  k.d2ct = d2ct;
  k.s2 = s2;
  k.cs2 = cs2;
  k.two_cl2 = two_cl2;
  const Clouds cl{xa, fa, ma, xb, fb, mb};
  cudaError_t err =
      cudaMemsetAsync(out_n, 0, (2 + groups) * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (with_moments) {
    pair_stats_sweep<true><<<sp.items, THREADS, 0, stream>>>(
        cl, sp, group, ell, k, fpart, npart, gpart, gnpart, out_f, out_n);
  } else {
    pair_stats_sweep<false><<<sp.items, THREADS, 0, stream>>>(
        cl, sp, group, ell, k, fpart, npart, gpart, gnpart, out_f, out_n);
  }
  return (int)cudaGetLastError();
}
