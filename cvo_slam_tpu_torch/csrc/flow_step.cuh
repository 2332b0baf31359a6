// The two per-pair passes of one CVO align iteration (cvo.cpp:122-334), as
// device functions over one work item, shared by flow_step.cu (one launch
// per pass) and align_fused.cu (inside its persistent loop, with the moving
// cloud transformed by the current pose as it is staged). The work split,
// the staging of column tiles (sweep_packed, with the caller's packing) and
// the last-block ticket serve the moment kernel (moment_flow_step.cu) and
// pair stats (pair_stats.cu) too.
//
// The work split. A work item is a row tile of ROWS = RB x THREADS fixed
// points against a chunk of column tiles of CT = 32 moving points. Thread t
// owns the RB rows t, t + THREADS, ... of the row tile and keeps them in
// registers, so every column it reads from shared memory serves RB rows,
// and a warp's row loads and bitmask stores are coalesced. The launch takes
// the split (chunks, tiles per chunk) from a plan made for the card's
// resident grid (cvo/kernels.plan_split) and checks it with make_split.
//
//   pass 1 (flow_item): the gate sweep. Every pair of the item: geometric
//     gate, colour gate, joint kernel a, keep = gate and a > sp_thres. A
//     kept pair adds a y_j and a to its row's sums and one to the keep
//     count, and sets its bit in the keep bitmask: word bits[t * N + i]
//     holds columns 32 t .. 32 t + 31 of row i, bit k column 32 t + k.
//     Then, as the plain version (ops/pairwise.flow), the row's
//     d_i = sum_j a_ij y_j - (sum_j a_ij) x_i over the item's columns, and
//     the item writes 6 partials (sum_i x_i x d_i (3), sum_i d_i (3)) and
//     its count; omega = sum x x d / c, v = sum d / d.
//   pass 2 (step_item): walks the set bits of its rows and column tiles
//     (__ffs), recomputes a with the same float operations (so the kept set
//     is pass 1's) and adds the quartic terms beta, gamma, delta, epsilon
//     of the flow (omega, v); the item writes its partial B, C, D, E.
//   step_sweep_item: pass 2 with no pass 1 before it (step_coeffs alone):
//     pass 1's gate sweep with the quartic terms in place of the flow
//     terms, summed in pass 2's order, so both give the same bits.
//
// Column tiles are staged with cp.async, double-buffered (tile t + 1 is in
// flight while tile t is computed), then packed so that one 16-byte load
// brings (x, y, z, |y|^2) and two more the colour terms.
//
// Tile skipping (the Pallas kernels' _tile_bounds / _skip_flags,
// pallas_kernels.py:449-473). The clouds are Morton-ordered by the
// frontend, so a row tile and a 32-column tile each cover a compact
// region. A sweep that skips takes the box of the item's rows (lo, hi per
// coordinate over the rows that can pass a gate, and their largest squared
// norm s: each warp's box as it loads its rows, the four combined by
// thread 0 at the first tile) and the box of each column tile as warp 0
// packs it: the columns as the gate sees them, so align_fused's boxes are
// those of the columns transformed by the lane's current pose, and no
// margin or motion bound is needed. Thread 0 decides each tile (one flag in
// shared memory, published by the barrier that follows the packing), so
// skipping adds no barrier. A (row tile, column tile) pair is computed only
// if the squared gap between the two boxes, gap2 = sum_c max(lo_col -
// hi_row, lo_row - hi_col, 0)^2, is below thr = d2t + 2^-18 ((d2t + s_row)
// + s_col) (box_live; d2t = -2 ell^2 log(sp_thres / sigma^2) as the gate
// computes it). A skipped pair sets no bit (its words are written as zeros)
// and adds nothing to any partial, so every output, and every sum's order,
// is that of the unskipped sweep, bit for bit. The unskipped sweep stays
// reachable (skip = 0), and each launch counts the pairs it computed (an
// integer count per block, added up by its caller).
//   The slack: no pair that the gate keeps may lie in a skipped tile pair.
// Such a pair has a true squared distance D >= the true gap2. The per-pair
// kernels test z = (|x|^2 + |y|^2) - 2 x . y < d2t (geo_z); each of |x|^2,
// |y|^2 and the 3-term dot rounds with at most 3 ulps of relative error
// (unit roundoff u = 2^-24), and the two additions add one each, so
// |z - D| <= 9 u (|x|^2 + |y|^2) <= 9 u S, S = s_row + s_col. The moment
// kernel's explicit differences give a d2 >= D (1 - 5 u). So a kept pair
// has D < d2t + 9 u S + 6 u d2t. The box edges are the points' own floats,
// and the computed gap2 exceeds the true one by at most 5 u of itself; thr
// rounds down by at most 2 u. Hence every kept pair's tile pair has
// computed gap2 < d2t + 64 u (d2t + S) <= thr: the slack 2^-18 = 64 u is
// six times what the argument needs. A point whose squared norm overflows
// never passes the per-pair gate, so those boxes leave it out; the moment
// kernel's boxes take s = FLT_MAX for it, so its tile pairs are computed.
// The box test takes fmaxf, which ignores a NaN, so a non-finite edge
// computes the pair. kernels.tile_flags_plain repeats the test in torch.
//
// Gate and kernel follow the Pallas `_pair_tile` (pallas_kernels.py:106):
// distances by the dot identity with FMA-chain dots, one fused clamped
// exponential; ops/pairwise.cvo_kernel repeats them operation by operation.
// A masked (or missing) point gets position 0 and squared norm +inf, so its
// distance to any finite point is +inf and no gate passes, with no branch.
//
// The sums. Every term and every sum is f32, in one fixed order for the
// plan's split: a row's kept pairs in column order, a thread's rows in
// order, the block's tree (block_sum_n: a shuffle butterfly, then the
// warps' sums, last warp first), then the items in finalize_* (a fixed
// strided share per thread, then the block's tree). No float atomics; two
// runs on the same split give bitwise-equal results, and every block of
// align_fused the same omega, v and B..E. Every fixed order is as valid as
// this one, but the align loop's stop rule and gate turn their last-bit
// differences into different iteration counts and end points: this order
// was picked on the card from 32 such orders as one that ends within 1e-4
// of the plain version on chip_smoke's pair (PERF.md §6).

#pragma once

#include <stdint.h>

#include "pair_math.cuh"

namespace {

constexpr int THREADS = 128;         // threads per block
constexpr int NWARPS = THREADS / 32;
constexpr int RB = 4;                // fixed rows per thread
constexpr int ROWS = RB * THREADS;   // rows per work item
constexpr int CT = 32;               // columns per tile: one bitmask word
constexpr int N_FLOW = 6;            // flow partials per work item
constexpr int N_STEP = 4;            // step partials per work item (B..E)
// the slack of the tile-skip test: 2^-18 of (d2t + s_row + s_col)
constexpr float SKIP_SLACK = 3.814697265625e-06f;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// the box of a set of points: lo, hi per coordinate and the largest squared
// norm s; empty: lo +inf, hi -inf, s 0 (its gap to any box is +inf)
struct Box {
  float lo[3], hi[3], s;
};
static_assert(sizeof(Box) == 7 * sizeof(float), "a Box is 7 floats");

__device__ __forceinline__ Box empty_box() {
  Box b;
  for (int c = 0; c < 3; ++c) {
    b.lo[c] = inf_f();
    b.hi[c] = -inf_f();
  }
  b.s = 0.f;
  return b;
}

__device__ __forceinline__ void box_add(Box& b, float x, float y, float z,
                                        float s) {
  const float q[3] = {x, y, z};
  for (int c = 0; c < 3; ++c) {
    b.lo[c] = fminf(b.lo[c], q[c]);
    b.hi[c] = fmaxf(b.hi[c], q[c]);
  }
  b.s = fmaxf(b.s, s);
}

// an int whose signed order is the order of the floats (every non-NaN
// float, the infinities included), and back
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_ordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// the box of the warp's boxes, in every lane: one warp-wide integer min or
// max (redux.sync) per bound, on the order-preserving ints (min and max
// are exact in any order)
__device__ __forceinline__ void warp_box(Box& b) {
  for (int c = 0; c < 3; ++c) {
    b.lo[c] = from_ordered(__reduce_min_sync(0xffffffffu, ordered(b.lo[c])));
    b.hi[c] = from_ordered(__reduce_max_sync(0xffffffffu, ordered(b.hi[c])));
  }
  b.s = from_ordered(__reduce_max_sync(0xffffffffu, ordered(b.s)));
}

// the work split of a launch
struct Split {
  int N, M;        // rows (fixed cloud), columns (moving cloud)
  int row_tiles;   // ceil(N / ROWS)
  int col_tiles;   // ceil(M / CT): also the bitmask words per row
  int per_chunk;   // column tiles per chunk
  int items;       // row_tiles * chunks
};

// host side: the split of N x M into `chunks` chunks of per_chunk column
// tiles; false unless it covers every column tile once with no empty chunk
inline bool make_split(int N, int M, int chunks, int per_chunk, Split& sp) {
  if (N <= 0 || M <= 0 || chunks <= 0 || per_chunk <= 0) return false;
  sp.N = N;
  sp.M = M;
  sp.row_tiles = (N + ROWS - 1) / ROWS;
  sp.col_tiles = (M + CT - 1) / CT;
  sp.per_chunk = per_chunk;
  sp.items = sp.row_tiles * chunks;
  return (long long)(chunks - 1) * per_chunk < sp.col_tiles
         && (long long)chunks * per_chunk >= sp.col_tiles;
}

// work item -> row tile (varies fastest) and column tiles [t0, t1)
struct Item {
  int rt, t0, t1;
};

__device__ __forceinline__ Item item_of(const Split& sp, int item) {
  Item it;
  it.rt = item % sp.row_tiles;
  it.t0 = (item / sp.row_tiles) * sp.per_chunk;
  it.t1 = min(it.t0 + sp.per_chunk, sp.col_tiles);
  return it;
}

struct Clouds {
  const float* x;            // fixed (rows): (N, 3), (N, 5), (N,)
  const float* fx;
  const unsigned char* mx;
  const float* y;            // moving (columns), each 16-byte aligned
  const float* fy;
  const unsigned char* my;
};

// y = y0 R + Tt (update_tf + transform_pcd, cvo.cpp:106-110, :336)
struct Pose {
  float R[9];    // row-major
  float Tt[3];   // -R^T T
};

__device__ __forceinline__ void move_point(const Pose& pose, float* q) {
  const float q0[3] = {q[0], q[1], q[2]};
  for (int c = 0; c < 3; ++c)
    q[c] = q0[0] * pose.R[c] + q0[1] * pose.R[3 + c] + q0[2] * pose.R[6 + c]
           + pose.Tt[c];
}

// the RB fixed rows of this thread: -2 x and |x|^2 in registers, the
// colour terms (read only inside the geometric gate) in shared memory,
// where each thread reads only its own rows. Scaling by -2 is exact, so the
// FMA chain over -2 x gives -2 (x . y) bit for bit and x = -0.5 (-2 x).
struct Rows {
  float m2x[RB][3], xx[RB];
};

__device__ __forceinline__ void row_x(const Rows& R, int r, float* x) {
  for (int c = 0; c < 3; ++c) x[c] = -0.5f * R.m2x[r][c];
}

struct RowColours {
  float f[5][ROWS];
  float ff[ROWS];
};

__device__ __forceinline__ int row_index(int rt, int r) {
  return rt * ROWS + r * THREADS + (int)threadIdx.x;
}

__device__ __forceinline__ void load_rows(const Clouds& cl, const Split& sp,
                                          int rt, Rows& R, RowColours& F) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int i = row_index(rt, r);
    const int lr = r * THREADS + threadIdx.x;
    const bool on = i < sp.N && cl.mx[i] != 0;
    float x[3], f[5];
    for (int c = 0; c < 3; ++c) x[c] = on ? cl.x[i * 3 + c] : 0.f;
    for (int c = 0; c < 5; ++c) f[c] = on ? cl.fx[i * 5 + c] : 0.f;
    for (int c = 0; c < 3; ++c) R.m2x[r][c] = -2.f * x[c];
    R.xx[r] = on ? sq3(x) : inf_f();
    for (int c = 0; c < 5; ++c) F.f[c][lr] = f[c];
    F.ff[lr] = sq5(f);
  }
}

// one column tile as it arrives (the inputs' own bytes) ...
struct __align__(16) RawTile {
  float p[CT * 3];
  float f[CT * 5];
  unsigned char m[CT];
};

// ... and packed for the sweep
struct __align__(16) PackedTile {
  float4 p[CT];    // x, y, z, |y|^2 (masked: 0, 0, 0, inf)
  float4 fa[CT];   // f0..f3
  float2 fb[CT];   // f4, |f|^2
};

struct Stage {
  RawTile raw[2];
  PackedTile pk;
  Box warps[NWARPS];   // the warps' boxes of the item's rows
  int live;            // thread 0's decision for the packed tile
};

// each warp's box of its threads' boxes `b` of the item's rows into
// s.warps (the sweep's first barrier publishes them). Every thread calls
// it.
__device__ __forceinline__ void store_rows_box(Box b, Stage& s) {
  warp_box(b);
  if ((threadIdx.x & 31) == 0) s.warps[threadIdx.x >> 5] = b;
}

// the item's row box: the warps' boxes combined
__device__ __forceinline__ Box rows_of(const Stage& s) {
  Box o = s.warps[0];
  for (int w = 1; w < NWARPS; ++w) {
    const Box& q = s.warps[w];
    for (int c = 0; c < 3; ++c) {
      o.lo[c] = fminf(o.lo[c], q.lo[c]);
      o.hi[c] = fmaxf(o.hi[c], q.hi[c]);
    }
    o.s = fmaxf(o.s, q.s);
  }
  return o;
}

// whether the tile pair of a row box and a column box is computed: the
// squared gap of the boxes below thr (module note; kernels.tile_flags_plain
// repeats these float operations in this order); d2t the gate's cut
__device__ __forceinline__ bool box_live(const Box& r, const Box& c,
                                         float d2t) {
  float gap2 = 0.f;
  for (int q = 0; q < 3; ++q) {
    const float g = fmaxf(fmaxf(c.lo[q] - r.hi[q], r.lo[q] - c.hi[q]), 0.f);
    gap2 = gap2 + g * g;
  }
  return gap2 < d2t + SKIP_SLACK * ((d2t + r.s) + c.s);
}

// the block's reduction scratch
struct Red {
  float f[NWARPS * N_FLOW];
  float out[N_FLOW];
  int i[NWARPS];
  int iout;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying column tile t into dst: 66 threads copy 16 bytes each (24
// of positions, 40 of features, 2 of masks), zero-filling past the end of
// the cloud (a zero mask byte is a masked column).
__device__ __forceinline__ void issue_tile(const Clouds& cl, int M, int t,
                                           RawTile& dst) {
  const int q = threadIdx.x;
  const char* src;
  char* out;
  long long off, total;
  if (q < 24) {
    src = (const char*)cl.y;
    out = (char*)dst.p + q * 16;
    off = (long long)t * CT * 12 + q * 16;
    total = (long long)M * 12;
  } else if (q < 64) {
    src = (const char*)cl.fy;
    out = (char*)dst.f + (q - 24) * 16;
    off = (long long)t * CT * 20 + (q - 24) * 16;
    total = (long long)M * 20;
  } else if (q < 66) {
    src = (const char*)cl.my;
    out = (char*)dst.m + (q - 64) * 16;
    off = (long long)t * CT + (q - 64) * 16;
    total = M;
  } else {
    return;
  }
  const long long left = total - off;
  const int bytes = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
  cp_async16(out, bytes > 0 ? src + off : src, bytes);
}

// pack a raw tile (threads 0..CT-1, one column each); MOVE: transform the
// positions by `pose` first
template <bool MOVE>
__device__ __forceinline__ void pack_tile(const RawTile& raw, PackedTile& pk,
                                          const Pose& pose) {
  const int k = threadIdx.x;
  if (k >= CT) return;
  float q[3], f[5];
  for (int c = 0; c < 3; ++c) q[c] = raw.p[3 * k + c];
  for (int c = 0; c < 5; ++c) f[c] = raw.f[5 * k + c];
  if (MOVE) move_point(pose, q);
  pk.p[k] = raw.m[k] != 0 ? make_float4(q[0], q[1], q[2], sq3(q))
                          : make_float4(0.f, 0.f, 0.f, inf_f());
  pk.fa[k] = make_float4(f[0], f[1], f[2], f[3]);
  pk.fb[k] = make_float2(f[4], sq5(f));
}

// The sweep of one item's column tiles: stage them (double-buffered
// cp.async), pack each with pack(raw tile, packed tile) and call
// visit(t, packed tile, live) once per tile. With skip, warp 0 takes the
// box of the packed columns whose squared norm (pk.p[k].w) is finite and
// thread 0 sets live = box_live(the item's row box, that box, d2t) (the
// warps stored their row boxes before the sweep, store_rows_box); without,
// every tile is live. A visit computes nothing for a tile that is not live.
// Returns the live tiles. Every thread of the block calls it.
template <class Pack, class Visit>
__device__ __forceinline__ int sweep_packed(const Clouds& cl,
                                            const Split& sp, const Item& it,
                                            Stage& s, bool skip, float d2t,
                                            Pack&& pack, Visit&& visit) {
  int live_tiles = 0;
  Box rows;   // thread 0's: the item's row box
  issue_tile(cl, sp.M, it.t0, s.raw[0]);
  cp_async_commit();
  for (int t = it.t0; t < it.t1; ++t) {
    const int b = (t - it.t0) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile t has landed; the last visit and pack are done
    if (t + 1 < it.t1) issue_tile(cl, sp.M, t + 1, s.raw[b ^ 1]);
    cp_async_commit();
    pack(s.raw[b], s.pk);
    if (skip && threadIdx.x < CT) {   // warp 0: the lanes that packed
      const float4 p = s.pk.p[threadIdx.x];
      Box cols = empty_box();
      if (p.w < inf_f()) box_add(cols, p.x, p.y, p.z, p.w);
      warp_box(cols);
      if (threadIdx.x == 0) {
        if (t == it.t0) rows = rows_of(s);
        s.live = box_live(rows, cols, d2t);
      }
    }
    __syncthreads();
    const bool live = !skip || s.live;
    live_tiles += live;
    visit(t, s.pk, live);
  }
  __syncthreads();     // the stage is free for the next item
  return live_tiles;
}

// the sweep with the per-pair passes' packing (pack_tile)
template <bool MOVE, class Visit>
__device__ __forceinline__ int sweep(const Clouds& cl, const Split& sp,
                                     const Item& it, const Pose& pose,
                                     Stage& s, bool skip, float d2t,
                                     Visit&& visit) {
  return sweep_packed(cl, sp, it, s, skip, d2t,
                      [&](const RawTile& raw, PackedTile& pk) {
                        pack_tile<MOVE>(raw, pk, pose);
                      },
                      visit);
}

// the row box of a per-pair item (before its sweep): the rows whose squared
// norm is finite (a masked row has +inf and passes no gate). Every thread
// calls it.
__device__ __forceinline__ void rows_box(const Rows& R, Stage& s) {
  Box b = empty_box();
#pragma unroll
  for (int r = 0; r < RB; ++r)
    if (R.xx[r] < inf_f())
      box_add(b, -0.5f * R.m2x[r][0], -0.5f * R.m2x[r][1],
              -0.5f * R.m2x[r][2], R.xx[r]);
  store_rows_box(b, s);
}

// the geometric distance of (row r, column p) before its clamp at 0:
// (|x|^2 + |y|^2) - 2 x . y, rounded as ident_d2_reg. With a positive d2t
// the gate max(z, 0) < d2t is z < d2t (geo_cut gives that cut).
__device__ __forceinline__ float geo_z(const Rows& R, int r, float4 p) {
  float dot = R.m2x[r][0] * p.x;
  dot = __fmaf_rn(R.m2x[r][1], p.y, dot);
  dot = __fmaf_rn(R.m2x[r][2], p.z, dot);
  return (R.xx[r] + p.w) + dot;
}

// the cut on geo_z: d2t, or -inf when d2t <= 0 (then no pair passes)
__device__ __forceinline__ float geo_cut(float d2t) {
  return d2t > 0.f ? d2t : -inf_f();
}

// inside the geometric gate: the colour gate, the joint kernel a, and
// whether the pair is kept (a > sp_thres)
__device__ __forceinline__ bool colour_keep(const RowColours& F, int r,
                                            float4 fa, float2 fb, float d2,
                                            float den, const Consts& c,
                                            float& a) {
  const int lr = r * THREADS + threadIdx.x;
  const float row[5] = {F.f[0][lr], F.f[1][lr], F.f[2][lr], F.f[3][lr],
                        F.f[4][lr]};
  const float col[5] = {fa.x, fa.y, fa.z, fa.w, fb.x};
  const float d2c = ident_d2_reg(F.ff[lr], fb.y, row, col, 5);
  if (!(d2c < c.d2ct)) return false;
  a = clamped_kernel(c.s2cs2, -(d2 / den + d2c / c.two_cl2));
  return a > c.sp_thres;
}

// the gate sweep of one packed tile: visit(r, k, a) for every kept pair of
// row r and column k, rows inner, columns in order; one branch per column
// while no row of the thread passes the geometric gate
template <class Kept>
__device__ __forceinline__ void kept_pairs(const Rows& R, const RowColours& F,
                                           const PackedTile& pk, float cut,
                                           float den, const Consts& c,
                                           Kept&& kept) {
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
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float a;
      if (!(z[r] < cut)) continue;
      if (!colour_keep(F, r, pk.fa[k], pk.fb[k], fmaxf(z[r], 0.f), den, c,
                       a))
        continue;
      kept(r, k, a, p);
    }
  }
}

// omega x a
__device__ __forceinline__ void cross_w(const float* w, const float* a,
                                        float* out) {
  out[0] = w[1] * a[2] - w[2] * a[1];
  out[1] = w[2] * a[0] - w[0] * a[2];
  out[2] = w[0] * a[1] - w[1] * a[0];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// the quartic terms of one kept pair (fixed point x, moved point q, joint
// kernel a) for the flow (w, v), each in f32, added to acc (cvo.cpp:239-
// 315): xi^k z by the recursive cross form, dk = xi^k z . (x - q)
__device__ __forceinline__ void step_terms(float* acc, float a,
                                           const float* x, const float* q,
                                           const float* w, const float* v,
                                           float tc) {
  float u[4][3];
  cross_w(w, q, u[0]);
  for (int c = 0; c < 3; ++c) u[0][c] = u[0][c] + v[c];
  for (int k = 1; k < 4; ++k) cross_w(w, u[k - 1], u[k]);
  float dk[4];
  for (int k = 0; k < 4; ++k)
    dk[k] = (x[0] * u[k][0] + x[1] * u[k][1] + x[2] * u[k][2])
            - dot3(u[k], q);
  const float nz0 = dot3(u[0], u[0]);
  const float nz1 = -dot3(u[0], u[1]);
  const float nz2 = dot3(u[1], u[1]) + 2.f * dot3(u[0], u[2]);
  const float beta = (-2.f * tc) * dk[0];
  const float gamma = (-tc) * (nz0 + 2.f * dk[1]);
  const float delta = (2.f * tc) * (nz1 - dk[2]);
  const float epsil = (-tc) * (nz2 + 2.f * dk[3]);
  const float b2 = beta * beta;
  acc[0] += a * beta;
  acc[1] += a * (gamma + b2 * 0.5f);
  acc[2] += a * (delta + beta * gamma + b2 * beta / 6.f);
  acc[3] += a * (epsil + beta * delta + 0.5f * b2 * gamma
                 + 0.5f * gamma * gamma + b2 * b2 / 24.f);
}

// Pass 1 over one work item: the keep bitmask of its rows and column tiles
// (zero words for a tile pair that is not live), its 6 flow partials
// (quantity-major: fpart[q * items + item]) and its keep count npart[item].
// Returns the tile pairs it computed. Every thread of the block calls it.
template <bool MOVE>
__device__ int flow_item(const Clouds& cl, const Split& sp, int item,
                          const Pose& pose, float ell, const Consts& c,
                          bool skip, Stage& s, RowColours& F, Red& red,
                          unsigned* __restrict__ bits,
                          float* __restrict__ fpart,
                          int* __restrict__ npart) {
  const Item it = item_of(sp, item);
  Rows R;
  load_rows(cl, sp, it.rt, R, F);
  if (skip) rows_box(R, s);
  const float d2t = -2.f * ell * ell * c.log_ratio;
  const float cut = geo_cut(d2t);
  const float den = 2.f * ell * ell;
  float d[RB][3] = {}, as[RB] = {};   // sum_j a y_j, sum_j a per row
  int n = 0;
  const int tiles = sweep<MOVE>(cl, sp, it, pose, s, skip, d2t,
                                [&](int t, const PackedTile& pk, bool live) {
    unsigned word[RB] = {};
    const auto kept = [&](int r, int k, float a, float4 p) {
      word[r] |= 1u << k;
      ++n;
      d[r][0] += a * p.x;
      d[r][1] += a * p.y;
      d[r][2] += a * p.z;
      as[r] += a;
    };
    if (live) kept_pairs(R, F, pk, cut, den, c, kept);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = row_index(it.rt, r);
      if (i < sp.N) __stcg(bits + (size_t)t * sp.N + i, word[r]);
    }
  });
  float v[N_FLOW] = {};
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float x[3];
    row_x(R, r, x);
    for (int q = 0; q < 3; ++q) d[r][q] = d[r][q] - as[r] * x[q];
    v[0] += x[1] * d[r][2] - x[2] * d[r][1];
    v[1] += x[2] * d[r][0] - x[0] * d[r][2];
    v[2] += x[0] * d[r][1] - x[1] * d[r][0];
    for (int q = 0; q < 3; ++q) v[3 + q] += d[r][q];
  }
  int cnt[1] = {n};
  block_sum_n<NWARPS>(v, red.f, red.out);
  block_sum_n<NWARPS>(cnt, red.i, &red.iout);
  if (threadIdx.x == 0) {
    for (int q = 0; q < N_FLOW; ++q)
      __stcg(fpart + q * sp.items + item, red.out[q]);
    __stcg(npart + item, red.iout);
  }
  return tiles;
}

// Pass 2 over one work item from pass 1's keep bitmask, for the flow
// (w, v): its partial B, C, D, E (spart[q * items + item]). A thread sums
// row by row, each row's kept pairs in column order.
template <bool MOVE>
__device__ void step_item(const Clouds& cl, const Split& sp, int item,
                          const Pose& pose, float ell, const float* w,
                          const float* v, const Consts& c, RowColours& F,
                          Red& red, const unsigned* __restrict__ bits,
                          float* __restrict__ spart) {
  const Item it = item_of(sp, item);
  Rows R;
  load_rows(cl, sp, it.rt, R, F);
  const float den = 2.f * ell * ell;
  const float tc = 1.f / (2.f * ell * ell);
  float acc[N_STEP] = {};
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int i = row_index(it.rt, r);
    float ar[N_STEP] = {};
    for (int t = it.t0; i < sp.N && t < it.t1; ++t) {
      unsigned word = __ldcg(bits + (size_t)t * sp.N + i);
      while (word) {
        const int j = t * CT + __ffs(word) - 1;
        word &= word - 1;
        float q[3], f[5];
        for (int e = 0; e < 3; ++e) q[e] = __ldg(cl.y + j * 3 + e);
        for (int e = 0; e < 5; ++e) f[e] = __ldg(cl.fy + j * 5 + e);
        if (MOVE) move_point(pose, q);
        const float4 p = make_float4(q[0], q[1], q[2], sq3(q));
        float a = 0.f, x[3];
        colour_keep(F, r, make_float4(f[0], f[1], f[2], f[3]),
                    make_float2(f[4], sq5(f)), fmaxf(geo_z(R, r, p), 0.f),
                    den, c, a);
        row_x(R, r, x);
        step_terms(ar, a, x, q, w, v, tc);
      }
    }
    for (int q = 0; q < N_STEP; ++q) acc[q] += ar[q];
  }
  block_sum_n<NWARPS>(acc, red.f, red.out);
  if (threadIdx.x == 0)
    for (int q = 0; q < N_STEP; ++q)
      __stcg(spart + q * sp.items + item, red.out[q]);
}

// Pass 2 with no bitmask (step_coeffs alone): the gate sweep of pass 1
// with the quartic terms of each kept pair, summed in step_item's order.
// Returns the tile pairs it computed.
__device__ int step_sweep_item(const Clouds& cl, const Split& sp, int item,
                               float ell, const float* w, const float* v,
                               const Consts& c, bool skip, Stage& s,
                               RowColours& F, Red& red,
                               float* __restrict__ spart) {
  const Item it = item_of(sp, item);
  Rows R;
  load_rows(cl, sp, it.rt, R, F);
  if (skip) rows_box(R, s);
  const float d2t = -2.f * ell * ell * c.log_ratio;
  const float cut = geo_cut(d2t);
  const float den = 2.f * ell * ell;
  const float tc = 1.f / (2.f * ell * ell);
  float ar[RB][N_STEP] = {};
  const Pose none{};
  const int tiles = sweep<false>(
      cl, sp, it, none, s, skip, d2t,
      [&](int, const PackedTile& pk, bool live) {
    if (!live) return;
    kept_pairs(R, F, pk, cut, den, c, [&](int r, int, float a, float4 p) {
      const float q[3] = {p.x, p.y, p.z};
      float x[3];
      row_x(R, r, x);
      step_terms(ar[r], a, x, q, w, v, tc);
    });
  });
  float acc[N_STEP] = {};
#pragma unroll
  for (int r = 0; r < RB; ++r)
    for (int q = 0; q < N_STEP; ++q) acc[q] += ar[r][q];
  block_sum_n<NWARPS>(acc, red.f, red.out);
  if (threadIdx.x == 0)
    for (int q = 0; q < N_STEP; ++q)
      __stcg(spart + q * sp.items + item, red.out[q]);
  return tiles;
}

// Whether this block is the last of n to finish (the thread-fence
// reduction): thread 0, which wrote the block's partials, makes them
// visible device-wide and takes a ticket. Every thread of the block calls
// it.
__device__ bool last_block(int* ticket, int n, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *flag = atomicAdd(ticket, 1) == n - 1;
  }
  __syncthreads();
  return *flag != 0;
}

// Sum the flow partials of `items` work items in a fixed order (thread t
// takes items t, t + THREADS, ... in turn, then the block's tree), then
// omega, v (thread 0): wv = omega (3), v (3); *nnz the keep count. The
// partials are read past L1 (other blocks wrote them). Every thread of the
// block calls it; it ends with __syncthreads.
__device__ void finalize_flow(const float* fpart, const int* npart,
                              int items, float c, float d, Red& red,
                              float* wv, int* nnz) {
  float v[N_FLOW] = {};
  int n[1] = {0};
  for (int b = threadIdx.x; b < items; b += THREADS) {
    for (int q = 0; q < N_FLOW; ++q) v[q] += __ldcg(fpart + q * items + b);
    n[0] += __ldcg(npart + b);
  }
  block_sum_n<NWARPS>(v, red.f, red.out);
  block_sum_n<NWARPS>(n, red.i, &red.iout);
  if (threadIdx.x == 0) {
    const float* S = red.out;   // sum_i x_i x d_i, sum_i d_i
    for (int b = 0; b < 3; ++b) wv[b] = S[b] / c;
    for (int b = 0; b < 3; ++b) wv[3 + b] = S[3 + b] / d;
    *nnz = red.iout;
  }
  __syncthreads();
}

// Sum the step partials in the same fixed order into bcde (shared). Every
// thread of the block calls it; it ends with __syncthreads.
__device__ void finalize_step(const float* spart, int items, Red& red,
                              float* bcde) {
  float v[N_STEP] = {};
  for (int b = threadIdx.x; b < items; b += THREADS)
    for (int q = 0; q < N_STEP; ++q) v[q] += __ldcg(spart + q * items + b);
  block_sum_n<NWARPS>(v, red.f, red.out);
  if (threadIdx.x < N_STEP) bcde[threadIdx.x] = red.out[threadIdx.x];
  __syncthreads();
}

}  // namespace
