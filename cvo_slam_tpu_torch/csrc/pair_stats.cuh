// The pair-stats sweep as device functions over one launch of one or more
// pair sets, shared by pair_stats.cu (one set per launch) and ip_suite.cu
// (the suite's four sets in one launch).
//
// A pair set is rows xa against columns xb (each of xb, fb, mb 16-byte
// aligned). Over the pairs that pass the geometric and colour gates (no
// sp_thres test, cvo.cpp:416-447) it gives the sum of ck * k and the pair
// count and, with moments, G = U(xa)^T W U(xb) with W_ij = gate * sigma^2
// exp(max(-d2 / 2 ell^2, -20)) * (fa_i . fb_j) and U = [1, p, vec(p p^T)].
//
// A launch's blocks are the work items of its sets, set after set in the
// order of Sweep::set; a block finds its set from blockIdx.x against the
// sets' first blocks (a branch uniform per block). A launch of S lanes
// (the suite's lanes, sweep_sets<MOM, true>) repeats its sets for every
// lane: set after set, and within a set lane after lane, each lane's
// clouds, partials, tickets and outputs at a fixed stride (Sweep::lane_*,
// PairSet::row_lane / col_lane), each lane's sums in the one-lane order,
// so every lane equals its launch alone bit for bit. Per item
// (stats_item):
//   * a tile of ROWS rows (RB per thread: -2 xa and |xa|^2 in registers,
//     colours in shared memory) against a chunk of 32-column tiles of xb,
//     staged with flow_step.cuh's double-buffered cp.async sweep;
//   * per row the f32 sum, the integer count and, with moments, the 13
//     sums (W U(xb))_r in shared memory (each thread touches only its own
//     rows);
//   * the item writes its partial sum and count and, with moments, its 169
//     entries of sum over its rows r of U(xa_r)^T (W U(xb))_r, over the
//     rows with a gated pair only (a bitmask walked with __ffs): warp w
//     takes the w-th quarter of the local rows in order, a lane six entries
//     at once, and the warps' sums are added in warp order, over the stage
//     (free once the sweep is done).
// Then the finalize (sweep_sets): each set's partials are summed in item
// order in two levels, each with an integer ticket (flow_step.cuh's
// last_block). The last block of each group of `group` consecutive items
// of a set sums them into a group partial; the last group of the lane
// to finish sums every set's groups, in order, into the set's outputs. A
// thread loads 32 partials at once before it adds them in order, so
// neither level waits on one load after another.
//
// Per pair: the geometric gate first (geo_z against geo_cut: an FMA-chain
// dot through -2 xa and the identity, as ident_d2_reg rounds it); inside the
// gate the colour distance (the FMA-chain dot, the identity, the clamp) and
// the colour gate; then the two clamped exponentials. Each value is computed
// with the plain version's float operations, so the order of the tests
// changes no count. A masked or missing point gets |p|^2 = +inf
// (flow_step.cuh), so no gate passes. -fmad=false, integer counts, no
// float atomics, f32 sums in one fixed order: two launches give
// bitwise-equal results. Any capacity works: rows and columns past the end
// are masked.

#pragma once

#include <type_traits>

#include "flow_step.cuh"

namespace {

constexpr int NU = 13;
constexpr int NG = NU * NU;
constexpr int MAX_SETS = 4;   // pair sets of one launch

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

struct Empty {};

// a block's shared memory; the moments only where a set of the launch
// takes them
template <bool WITH_MOMENTS>
struct SweepShared {
  Stage s;
  RowShared rs;
  typename std::conditional<WITH_MOMENTS, Moments, Empty>::type ms;
  Red red;
  int last;
};

// One pair set of a launch and where its partials and results go.
struct PairSet {
  Clouds cl;       // rows x/fx/mx (sp.N), columns y/fy/my (sp.M)
  Split sp;
  int row_lane;    // points a lane of the rows and of the columns (lanes
  int col_lane;    // only; 0: one cloud of every lane)
  int mom;         // with moments: NG + 1 floats per partial, else 1
  int item0;       // the set's first block in the launch
  int group;       // items per level-1 group
  int group0;      // the set's first group in level1 and gnpart
  int f0, n0;      // the set's first float of fpart, count of npart
  int gf0;         // the set's first float of gpart
  float* out_g;    // G (NG floats), with moments
  float* out_sum;  // the sum
  int* out_n;      // the count
};

// floats per partial of a set, and its level-1 groups
__host__ __device__ inline int set_nf(const PairSet& t) {
  return t.mom ? NG + 1 : 1;
}
__host__ __device__ inline int set_groups(const PairSet& t) {
  return (t.sp.items + t.group - 1) / t.group;
}

// One launch: its sets in block order and the shared scratch; with lanes,
// the scratch, tickets and outputs of lane 0, and each lane's strides.
struct Sweep {
  PairSet set[MAX_SETS];
  int nsets;
  int groups;      // level-1 groups of the launch's sets (of one lane)
  int lanes;       // 1, or the lanes of a sweep_sets<MOM, true> launch
  int lane_fpart, lane_npart, lane_gpart, lane_gnpart;   // lane strides
  int lane_out_f, lane_out_n;
  int* level2;     // the launch's (lane's) level-2 ticket
  int* level1;     // level-1 tickets, by the set's group0 + group
  float* fpart;
  int* npart;
  float* gpart;
  int* gnpart;
  const float* ell;   // one a lane
  Consts c;
};

// Partials q = tid, tid + THREADS, ... < NF of src (NF floats per item)
// summed over items [b0, b1) in item order: q < NF - 1 (G) into dst_g[q],
// q = NF - 1 (the sum) into *dst_sum; the items' counts (order-free
// integers) into *dst_n (thread 0). Every thread of the block calls it; it
// ends with __syncthreads.
template <int NF>
__device__ void sum_in_order(const float* src, const int* src_n, int b0,
                             int b1, Red& red, float* dst_g, float* dst_sum,
                             int* dst_n) {
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
    *(q == NF - 1 ? dst_sum : dst_g + q) = acc;
  }
  int n[1] = {0};
  for (int b = b0 + (int)threadIdx.x; b < b1; b += THREADS)
    n[0] += __ldcg(src_n + b);
  block_sum_n<NWARPS>(n, red.i, &red.iout);
  if (threadIdx.x == 0) *dst_n = red.iout;
  __syncthreads();
}

// sum_in_order with NF = NG + 1 (mom) or 1; MOM as in sweep_sets
template <int MOM>
__device__ void sum_partials(bool mom, const float* src, const int* src_n,
                             int b0, int b1, Red& red, float* dst_g,
                             float* dst_sum, int* dst_n) {
  if constexpr (MOM == 0)
    sum_in_order<1>(src, src_n, b0, b1, red, dst_g, dst_sum, dst_n);
  else if constexpr (MOM == 1)
    sum_in_order<NG + 1>(src, src_n, b0, b1, red, dst_g, dst_sum, dst_n);
  else if (mom)
    sum_in_order<NG + 1>(src, src_n, b0, b1, red, dst_g, dst_sum, dst_n);
  else
    sum_in_order<1>(src, src_n, b0, b1, red, dst_g, dst_sum, dst_n);
}

// One work item of a set: the sweep, then the item's partials, the sum at
// fpart[NF - 1] (G at fpart[0:NG] with moments) and the count at *npart.
// Every thread of the block calls it. ms: the block's moments (MOM only).
template <bool MOM>
__device__ void stats_item(const Clouds& cl, const Split& sp, int item,
                           float ell, const Consts& c, Stage& s,
                           RowShared& rs, Moments* ms, Red& red,
                           float* __restrict__ fpart,
                           int* __restrict__ npart) {
  constexpr int NF = MOM ? NG + 1 : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Item it = item_of(sp, item);
  Rows R;
  load_rows(cl, sp, it.rt, R, rs.colours);
  const float cut = geo_cut(-2.f * ell * ell * c.log_ratio);
  const float den = 2.f * ell * ell;
  float sr[RB] = {};
  int nr[RB] = {};
  if constexpr (MOM) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
      for (int b = 0; b < NU; ++b)
        ms->wu[b * ROW_STRIDE + r * THREADS + tid] = 0.f;
  }
  const Pose none{};
  // every tile pair (the sweep's tile skipping is not taken here)
  sweep<false>(cl, sp, it, none, s, false, 0.f,
               [&](int, const PackedTile& pk, bool) {
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
            ms->wu[b * ROW_STRIDE + lr] += w * lift(pb, b);
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
      if (lane == 0) ms->active[r * NWARPS + warp] = b;
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
      unsigned word = ms->active[wd];
      while (word) {
        const int lr = wd * 32 + __ffs(word) - 1;
        word &= word - 1;
#pragma unroll
        for (int k = 0; k < G_PER_LANE; ++k)
          g[k] += (P[pa[k] + lr] * P[pb[k] + lr]) * ms->wu[wb[k] + lr];
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
      __stcg(fpart + e, t);
    }
  }
  if (tid == 0) {
    __stcg(fpart + NF - 1, red.out[0]);
    __stcg(npart, red.iout);
  }
}

// the clouds of a set in lane l
__device__ __forceinline__ Clouds set_clouds(const PairSet& t, int l) {
  const size_t ro = (size_t)l * t.row_lane, co = (size_t)l * t.col_lane;
  return Clouds{t.cl.x + 3 * ro, t.cl.fx + 5 * ro, t.cl.mx + ro,
                t.cl.y + 3 * co, t.cl.fy + 5 * co, t.cl.my + co};
}

// The block's work item and the finalize of the launch w. MOM: 0 no set
// of the launch takes moments, 1 every set does, 2 each set says
// (PairSet::mom). LANES: the launch's w.lanes lanes, each set's blocks
// lane after lane (else one lane, lane 0). Every thread of the block calls
// it.
template <int MOM, bool LANES = false>
__device__ void sweep_sets(const Sweep& w, SweepShared<MOM != 0>& sh) {
  const int S = LANES ? w.lanes : 1;
  int k = 0;
  for (int j = 1; j < w.nsets; ++j)
    if ((int)blockIdx.x >= S * w.set[j].item0) k = j;
  const PairSet& set = w.set[k];
  const int b = (int)blockIdx.x - S * set.item0;
  const int l = LANES ? b / set.sp.items : 0;
  const int item = LANES ? b % set.sp.items : b;
  const bool mom = MOM == 1 || (MOM == 2 && set.mom);
  const int nf = mom ? NG + 1 : 1;
  // a lane's partials, tickets and outputs lie l lane strides on
  const size_t lf = (size_t)l * w.lane_fpart, ln = (size_t)l * w.lane_npart;
  const float ell = w.ell[l];
  // the lane's clouds, in shared memory (read where they are used, as the
  // one-lane sweep reads them from the kernel's parameters)
  __shared__ Clouds lane_cl;
  if constexpr (LANES) {
    if (threadIdx.x == 0) lane_cl = set_clouds(set, l);
    __syncthreads();
  }
  const Clouds& cl = LANES ? lane_cl : set.cl;
  float* fp = w.fpart + lf + set.f0 + (size_t)item * nf;
  int* np = w.npart + ln + set.n0 + item;
  if constexpr (MOM == 0) {
    stats_item<false>(cl, set.sp, item, ell, w.c, sh.s, sh.rs, nullptr,
                      sh.red, fp, np);
  } else if (mom) {
    stats_item<true>(cl, set.sp, item, ell, w.c, sh.s, sh.rs, &sh.ms,
                     sh.red, fp, np);
  } else {
    stats_item<false>(cl, set.sp, item, ell, w.c, sh.s, sh.rs, nullptr,
                      sh.red, fp, np);
  }

  __threadfence();   // every thread's partials, before the tickets

  // level 1: the last block of the item's group sums the group
  const size_t lo = (size_t)l * w.lane_out_n;
  float* lane_gpart = w.gpart + (size_t)l * w.lane_gpart;
  int* lane_gnpart = w.gnpart + (size_t)l * w.lane_gnpart;
  const int g = item / set.group;
  const int g0 = g * set.group, g1 = min(g0 + set.group, set.sp.items);
  if (!last_block(w.level1 + lo + set.group0 + g, g1 - g0, &sh.last))
    return;
  float* gpart = lane_gpart + set.gf0 + (size_t)g * nf;
  sum_partials<MOM>(mom, w.fpart + lf + set.f0, w.npart + ln + set.n0, g0,
                    g1, sh.red, gpart, gpart + nf - 1,
                    lane_gnpart + set.group0 + g);
  __threadfence();
  // level 2: the last group of the lane sums each set's groups
  if (!last_block(w.level2 + lo, w.groups, &sh.last)) return;
  for (int j = 0; j < w.nsets; ++j) {
    const PairSet& t = w.set[j];
    sum_partials<MOM>(t.mom != 0, lane_gpart + t.gf0,
                      lane_gnpart + t.group0, 0, set_groups(t), sh.red,
                      t.out_g + (size_t)l * w.lane_out_f,
                      t.out_sum + (size_t)l * w.lane_out_f, t.out_n + lo);
  }
}

// host side: the set of rows (xa, fa, ma) x N against columns (xb, fb, mb)
// x M split into chunks of per_chunk column tiles, its level-1 groups of
// `group` items; its partials start at float f0 of fpart, count n0 of
// npart and float gf0 of gpart, its groups at group0 of gnpart and of the
// level-1 tickets. The columns are staged with 16-byte copies. Returns the
// CUDA error code of a bad split or alignment.
inline cudaError_t make_set(const float* xa, const float* fa,
                            const unsigned char* ma, const float* xb,
                            const float* fb, const unsigned char* mb, int N,
                            int M, int chunks, int per_chunk, int group,
                            bool mom, int f0, int n0, int gf0, int group0,
                            PairSet& set) {
  if (!make_split(N, M, chunks, per_chunk, set.sp) || group <= 0)
    return cudaErrorInvalidValue;
  if ((((uintptr_t)xb) | ((uintptr_t)fb) | ((uintptr_t)mb)) & 15)
    return cudaErrorMisalignedAddress;
  set.cl = Clouds{xa, fa, ma, xb, fb, mb};
  set.row_lane = 0;
  set.col_lane = 0;
  set.mom = mom;
  set.item0 = 0;
  set.group = group;
  set.f0 = f0;
  set.n0 = n0;
  set.gf0 = gf0;
  set.group0 = group0;
  return cudaSuccess;
}

// host side: the geometry a wrapper plans a launch of the sweep kernel
// `kernel` with. out (4 ints): resident blocks per SM, SMs, rows per work
// item, columns per tile. Returns the CUDA error code.
template <class Kernel>
int sweep_geometry(Kernel kernel, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = ROWS;
  out[3] = CT;
  return (int)cudaSuccess;
}

// host side: the launch of `nsets` sets in the given order (item0 and the
// launch's group count filled in) for one lane; returns its blocks
inline int make_sweep(const PairSet* sets, int nsets, Sweep& w) {
  int items = 0;
  w.nsets = nsets;
  w.groups = 0;
  w.lanes = 1;
  w.lane_fpart = w.lane_npart = w.lane_gpart = w.lane_gnpart = 0;
  w.lane_out_f = w.lane_out_n = 0;
  for (int j = 0; j < nsets; ++j) {
    w.set[j] = sets[j];
    w.set[j].item0 = items;
    items += sets[j].sp.items;
    w.groups += set_groups(sets[j]);
  }
  return items;
}

}  // namespace
