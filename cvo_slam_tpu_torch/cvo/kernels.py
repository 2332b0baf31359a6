"""The pairwise passes of tracking and loop-closure verification:
hand-written CUDA kernels (csrc/*.cu), each beside its plain PyTorch
version.

  * `moment_flow_step`: one align iteration (cvo.cpp:187-334). The kernel
    computes the moment matrix Mom (M, 35) and the kept-pair count nnz; the
    O(M) epilogue gives (omega, v, nnz, B, C, D, E): on the card one launch
    of `moment_epilogue` (csrc/moment_step.cu), on the CPU its plain version
    ops.pairwise.flow_and_step_from_moments. The kernel's pass 1 writes the
    moment form's keep bitmask (`moment_keep_bits_plain`), pass 2 sums each
    row's kept pairs in ascending column order (`moment_from_bits_plain`).
  * `moment_state_init` / `moment_state_step` (csrc/moment_step.cu, on the
    card only): the pallas_mom align loop's state update (csrc/
    align_state.cuh's epilogue, shared with align_fused) and the moved
    cloud of the next iteration, one launch each, into new tensors
    (engine.align_loop_moment_cuda); their plain version is engine._update
    with engine.align_loop's transform.
  * `ip_suite` (csrc/ip_suite.cu): the pairwise work of
    compute_innerproduct (cvo.cpp:475-503): four gated inner products with
    their pair counts and the 13x13 Hessian moment matrix G, each pair set
    one pair-stats sweep, all four in one launch; `ip_suite_lanes`: the
    suites of S cloud pairs in one launch, each lane equal to its one-lane
    launch bit for bit (the one-lane suite is its S = 1 launch).
  * `pair_stats` (csrc/pair_stats.cu): one gated inner product of a cloud
    pair with its pair count and, on request, the Hessian moments G
    (function_inner_product and se3_Hessian, cvo.cpp:388-459, :620-759),
    in one launch; compute_innerproduct_lc launches it 6 + 2 times.
    `pair_stats_lanes`: the pair stats of S cloud pairs in one launch
    (compute_innerproduct_lc over the loop-closure candidates of a round,
    engine.compute_innerproduct_lc_lanes), each lane equal to its one-lane
    launch bit for bit (the one-lane call is its S = 1 launch).
  * `flow_and_step` (csrc/flow_step.cu): one align iteration in per-pair
    form, (omega, v, nnz) from the flow pass, then (B, C, D, E) from the
    step pass with the fresh omega, v (the pallas_iter backend). Its two
    passes are the kernels `flow` and `step_coeffs`, each launchable
    alone (modes 1 and 2 of the same entry point, which only the JAX
    package's tests call).
  * `align_fused` (csrc/align_fused.cu): the whole align loop in one
    cooperative launch (the pallas backend, and loop-closure verification
    under pallas and pallas_iter); its plain version is engine.align_loop
    over the plain flow_and_step. `align_fused_lanes`: S alignments in one
    launch (lockstep tracking, batched align, loop-closure candidates
    against one shared fixed cloud), a stopped lane frozen while the
    others run, each lane equal to its one-lane launch bit for bit (the
    one-lane align is its S = 1 launch).
  * `hessian_post` (csrc/hessian_post.cu): the Hessian epilogue of the
    inner products (the eigenvalue floor of se3_Hessian, cvo.cpp:726-754):
    scale, fixed-sweep Jacobi eigenvalues and the spectrum shift of a stack
    of S Hessians in one launch, one thread a lane. It replaces no Pallas
    kernel: its plain version (ops/jacobi.eigvalsh_jacobi, a host copy of
    the eigenvalues and a float32 shift loop there) issues ~1530 launches
    and one synchronisation a call.

Every kernel splits its pairs into work items, a row tile against a chunk
of 32-column tiles; `plan_split` sizes the items to the card's resident
grid, which the kernel's library reports (`*_geometry`), and `plan_sets`
sizes the suite's four pair sets together, as one grid.
The pass 1 of the align kernels and of the moment kernel records the kept
pairs in a bitmask (`pack_keep_bits` is its layout) that pass 2 walks.
The gate sweeps of all seven functions skip the (row tile, column tile)
pairs whose boxes lie beyond the gate radius, as the Pallas kernels skip:
every output is that of the sweep that computes every pair, bit for bit,
and each launch counts the tile pairs it computed (`launch_info`'s
`tiles`, a device tensor, against `tile_pairs` a sweep; the suite's per
set). `tile_flags_plain` is the test in torch; the wrappers' `tile_skip=
False` computes every pair (for the checks that hold the two sweeps
equal).

A lane launch takes a stack of clouds (S, CAP, .) whose lanes lie a fixed
stride apart, each lane's points contiguous: `stack_lanes` (and
engine.stack_clouds) lays them so, the stride CAP rounded up to LANE_POINTS
points, so every lane of a stack of any capacity starts 16-byte aligned,
as the kernels' 16-byte staging copies need.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel (building it on first use) or raises. Each
wrapper counts its launches in `KernelInfo.launches`, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .. import spans
from ..config import CvoParams
from ..ops import pairwise
from ..ops.jacobi import eigvalsh_jacobi
from . import cuda_build

KEEP_WORD = 32   # columns per word of the keep bitmask
NG = 169         # entries of the Hessian moment matrix G (13 x 13)


_count_lock = threading.Lock()


@dataclass
class KernelInfo:
    name: str
    source: str      # file under csrc/
    replaces: str    # the Pallas kernel's pallas_call, file:line
    launches: int = 0

    def count_launch(self):
        # wrappers run on the tracker's thread and on the pipelines'
        # worker threads (device.StreamWorker, the async backend)
        with _count_lock:
            self.launches += 1


MOMENT = KernelInfo("moment_flow_step", "moment_flow_step.cu",
                    "cvo_slam_tpu/cvo/pallas_kernels.py:973")
IP_SUITE = KernelInfo("ip_suite", "ip_suite.cu",
                      "cvo_slam_tpu/cvo/pallas_kernels.py:802")
PAIR_STATS = KernelInfo("pair_stats", "pair_stats.cu",
                        "cvo_slam_tpu/cvo/pallas_kernels.py:418")
FLOW_AND_STEP = KernelInfo("flow_and_step", "flow_step.cu",
                           "cvo_slam_tpu/cvo/pallas_kernels.py:651")
FLOW = KernelInfo("flow", "flow_step.cu",
                  "cvo_slam_tpu/cvo/pallas_kernels.py:204")
STEP = KernelInfo("step_coeffs", "flow_step.cu",
                  "cvo_slam_tpu/cvo/pallas_kernels.py:304")
ALIGN = KernelInfo("align_fused", "align_fused.cu",
                   "cvo_slam_tpu/cvo/pallas_align.py:477")
# the lane launches of the same two kernels (vmap's grid dimension of the
# Pallas kernels), counted apart from the one-lane calls
ALIGN_LANES = KernelInfo("align_fused_lanes", "align_fused.cu",
                         "cvo_slam_tpu/cvo/pallas_align.py:477")
IP_SUITE_LANES = KernelInfo("ip_suite_lanes", "ip_suite.cu",
                            "cvo_slam_tpu/cvo/pallas_kernels.py:802")
PAIR_STATS_LANES = KernelInfo("pair_stats_lanes", "pair_stats.cu",
                              "cvo_slam_tpu/cvo/pallas_kernels.py:418")
# no Pallas kernel: the JAX package's plain hessian_postprocess, on the card
HESSIAN_POST = KernelInfo("hessian_post", "hessian_post.cu",
                          "none (cvo_slam_tpu/cvo/engine.py:264, plain)")
# no Pallas kernel: the XLA operations around the JAX package's moment
# kernel, on the card
MOMENT_EPILOGUE = KernelInfo(
    "moment_epilogue", "moment_step.cu",
    "none (cvo_slam_tpu/ops/pairwise.py:286, plain)")
MOMENT_STATE = KernelInfo(
    "moment_state_step", "moment_step.cu",
    "none (cvo_slam_tpu/cvo/engine.py:197-247, plain)")
KERNELS = (MOMENT, IP_SUITE, PAIR_STATS, FLOW_AND_STEP, FLOW, STEP, ALIGN,
           ALIGN_LANES, IP_SUITE_LANES, PAIR_STATS_LANES, HESSIAN_POST,
           MOMENT_EPILOGUE, MOMENT_STATE)
MAX_LANES = 32   # lanes of one align_fused launch (csrc/align_fused.cu)
# a stack's lane stride is its capacity rounded up to this many points, so
# that every lane's positions (12 B a point), features (20 B) and mask
# (1 B) start 16-byte aligned
LANE_POINTS = 16


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def _as_ell(ell, device):
    return torch.as_tensor(ell, dtype=torch.float32, device=device).reshape(())


def _check_meta(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _check(name, t, dtype, shape, device):
    _check_meta(name, t, dtype, shape, device)
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_cloud(prefix, pos, feat, mask, n, device):
    _check(prefix + " positions", pos, torch.float32, (n, 3), device)
    _check(prefix + " features", feat, torch.float32, (n, 5), device)
    _check(prefix + " mask", mask, torch.bool, (n,), device)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    """The raw handle of the current stream on `device`, as torch's own
    generated code reads it (torch.cuda.current_stream builds a Stream
    object, ~10 us a call: several a pallas_mom iteration)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _check_staged(prefix, pos, feat, mask):
    """The kernels stage their column cloud with 16-byte copies; for a
    stack of clouds, every lane's (stack_lanes lays a stack so)."""
    for name, t in (("positions", pos), ("features", feat), ("mask", mask)):
        stacked = t.dim() > (1 if name == "mask" else 2) and t.shape[0] > 1
        lane = t.stride(0) * t.element_size() if stacked else 0
        if t.data_ptr() % 16 or lane % 16:
            raise ValueError(f"{prefix} {name} is not 16-byte aligned"
                             + (" in every lane (stack the clouds with "
                                "engine.stack_clouds)" if lane % 16 else ""))


def _check_lanes(lanes):
    """The lane kernels take 1 to MAX_LANES lanes a launch."""
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"{lanes} lanes: one launch takes 1 to {MAX_LANES}")


def _lane_layout(t, stride: int) -> bool:
    """Whether the stack t (S, n, ...) has each lane's points contiguous
    and its lanes `stride` points apart (a dimension of size 1 takes any
    stride)."""
    inner = math.prod(t.shape[2:])
    want = (stride * inner,) + tuple(
        math.prod(t.shape[d + 1:]) for d in range(1, t.dim()))
    return all(size == 1 or got == w
               for size, got, w in zip(t.shape, t.stride(), want))


def _at_lane_stride(t, stride: int):
    """The stack t (S, n, ...) with its lanes `stride` points apart: t
    itself when it is laid out so, else a padded copy."""
    if _lane_layout(t, stride):
        return t
    out = t.new_zeros((t.shape[0], stride) + tuple(t.shape[2:]))
    out[:, :t.shape[1]] = t
    return out[:, :t.shape[1]]


def stack_lanes(tensors):
    """S tensors (CAP, ...) of one shape as one (S, CAP, ...) tensor whose
    lanes lie CAP rounded up to LANE_POINTS points apart, each lane's
    points contiguous (a view of a zero-padded stack; torch.stack's own
    layout where CAP is a multiple of LANE_POINTS)."""
    t = torch.stack(list(tensors))
    return _at_lane_stride(t, -(-t.shape[1] // LANE_POINTS) * LANE_POINTS)


def _check_lane_cloud(prefix, pos, feat, mask, lanes, n, device):
    """A stack of `lanes` clouds of n points (S, n, .), each lane's
    points contiguous and the lanes one stride of at least n points apart
    in all three arrays (stack_lanes), or one cloud of every lane (n, .);
    returns the lane stride in points (0 for the one cloud)."""
    if pos.dim() == 2:
        _check_cloud(prefix, pos, feat, mask, n, device)
        return 0
    stride = mask.stride(0) if lanes > 1 else n
    for name, t, dtype, shape in (
            (" positions", pos, torch.float32, (lanes, n, 3)),
            (" features", feat, torch.float32, (lanes, n, 5)),
            (" mask", mask, torch.bool, (lanes, n))):
        _check_meta(prefix + name, t, dtype, shape, device)
        if stride < n or not _lane_layout(t, stride):
            raise ValueError(f"{prefix}{name}: not a stack of contiguous "
                             f"lanes {stride} points apart (stack the "
                             f"clouds with engine.stack_clouds)")
    return stride


_fns: Dict[Tuple[str, str], object] = {}


def _fn(kernel: KernelInfo, symbol: str, argtypes):
    """The C entry point `symbol` of the kernel's library, its types bound
    once per loaded library (every entry point returns a CUDA error)."""
    key = (kernel.source, symbol)
    if key not in _fns:
        fn = getattr(cuda_build.load(kernel.source), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[key] = fn
    return _fns[key]


# ---------------------------------------------------------------------------
# the work split of the per-pair kernels, and their keep bitmask
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SplitPlan:
    """Work items of a per-pair launch: row tile `rt` (varies fastest)
    against column tiles [t0, t1) of one chunk, as csrc/flow_step.cuh's
    item_of reads them."""
    n: int
    m: int
    rows_per_item: int
    cols_per_tile: int
    row_tiles: int
    col_tiles: int
    chunks: int
    tiles_per_chunk: int

    @property
    def items(self) -> int:
        return self.row_tiles * self.chunks

    def item(self, i: int) -> Tuple[int, int, int]:
        rt, chunk = i % self.row_tiles, i // self.row_tiles
        t0 = chunk * self.tiles_per_chunk
        return rt, t0, min(t0 + self.tiles_per_chunk, self.col_tiles)

    def scratch(self) -> Dict[str, Tuple[int, ...]]:
        """Shapes of the launch's scratch: flow partials (f32, quantity-
        major), keep counts (i32), step partials (f32) and the keep bitmask
        (i32 words, one per row and column tile)."""
        return dict(fpart=(6, self.items), npart=(self.items,),
                    spart=(4, self.items), bits=(self.col_tiles, self.n))


@functools.lru_cache(maxsize=256)
def plan_sets(shapes: Tuple[Tuple[int, int], ...], resident: int,
              rows_per_item: int, cols_per_tile: int
              ) -> Tuple[SplitPlan, ...]:
    """The splits of pair sets of (rows, columns) `shapes` launched as one
    grid on a card that holds `resident` blocks at once: one count of
    column tiles per chunk for every set, the one that minimises waves x
    tiles per item (waves: ceil(all sets' items / resident)), the finer
    split on a tie; in each set chunks of equal tile counts (at most the
    set's tiles), none empty. Cached: the per-iteration wrappers ask for
    the same few splits every call."""
    if not shapes or resident <= 0 or min(min(s) for s in shapes) <= 0:
        raise ValueError(f"no split of {shapes} on {resident} blocks")
    row_tiles = [-(-n // rows_per_item) for n, _ in shapes]
    col_tiles = [-(-m // cols_per_tile) for _, m in shapes]

    def items(per):
        return sum(r * -(-c // per) for r, c in zip(row_tiles, col_tiles))

    per_chunk = min(range(1, max(col_tiles) + 1), key=lambda per: (
        -(-items(per) // resident) * per, per))
    plans = []
    for (n, m), r, c in zip(shapes, row_tiles, col_tiles):
        per = min(per_chunk, c)
        plans.append(SplitPlan(n, m, rows_per_item, cols_per_tile, r, c,
                               -(-c // per), per))
    return tuple(plans)


def plan_split(n: int, m: int, resident: int, rows_per_item: int,
               cols_per_tile: int) -> SplitPlan:
    """The split of n rows x m columns for a card that holds `resident`
    blocks at once (plan_sets of one set)."""
    return plan_sets(((n, m),), resident, rows_per_item, cols_per_tile)[0]


def finalize_group(items: int) -> int:
    """Items per level-1 group of the two-level ticket finalize of pair
    stats and the suite: ~sqrt(items), so that both levels are short."""
    return math.isqrt(items - 1) + 1


def pack_keep_bits(keep):
    """(N, M) bool keep -> the kernels' keep bitmask, (ceil(M/32), N) int32:
    bit b of word [t, i] is keep[i, 32 t + b]."""
    n, m = keep.shape
    w = -(-m // KEEP_WORD)
    k = torch.zeros((n, w * KEEP_WORD), dtype=torch.int64,
                    device=keep.device)
    k[:, :m] = keep
    shifts = torch.arange(KEEP_WORD, device=keep.device)
    words = (k.reshape(n, w, KEEP_WORD) << shifts).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.T.to(torch.int32).contiguous()


def unpack_keep_bits(bits, m: int):
    """The (N, M) bool keep mask of a keep bitmask (pack_keep_bits)."""
    words = bits.to(torch.int64).T & 0xFFFFFFFF
    shifts = torch.arange(KEEP_WORD, device=bits.device)
    return ((words[:, :, None] >> shifts) & 1).reshape(
        words.shape[0], -1)[:, :m].bool()


def keep_bits_plain(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """The keep bitmask of pairwise.cvo_kernel: what pass 1 of the per-pair
    kernels records."""
    _, keep = pairwise.cvo_kernel(x, y, fx, fy, mx, my,
                                  _as_ell(ell, x.device), p)
    return pack_keep_bits(keep)


# the slack of the kernels' tile-skip test (csrc/flow_step.cuh's box_live)
SKIP_SLACK = 2.0 ** -18


def _tile_boxes(pos, mask, tile):
    """Per tile of `tile` consecutive points: (lo (T, 3), hi (T, 3), s (T,))
    over the masked-in points, s their largest squared norm (summed
    coordinate by coordinate, as the kernels' sq3); an empty tile gets lo
    +inf, hi -inf, s 0."""
    n = pos.shape[0]
    t = -(-n // tile)
    pad = t * tile - n
    m = torch.nn.functional.pad(mask, (0, pad)).reshape(t, tile, 1)
    p = torch.nn.functional.pad(pos, (0, 0, 0, pad)).reshape(t, tile, 3)
    inf = torch.tensor(float("inf"), dtype=pos.dtype, device=pos.device)
    sq = (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) \
        + p[..., 2] * p[..., 2]
    return (torch.where(m, p, inf).amin(1), torch.where(m, p, -inf).amax(1),
            torch.where(m[..., 0], sq, torch.zeros_like(sq)).amax(1))


def tile_flags_plain(x, mx, y, my, ell, rows: int, cols: int, p: CvoParams,
                     margin: float = 0.0, slack: bool = False):
    """(ceil(N/rows), ceil(M/cols)) bool: which (row tile, column tile)
    pairs of rows x/mx against columns y/my a skipping gate sweep computes,
    from the boxes of their masked-in points. slack=False: the JAX
    package's flags (pallas_kernels._skip_flags, and with a margin
    pallas_align._skip_flags_margin): the squared gap below d2t, or below
    (sqrt(d2t) + margin)^2. slack=True: the CUDA kernels' own test
    (csrc/flow_step.cuh's box_live), the squared gap below d2t + 2^-18
    ((d2t + s_row) + s_col), which keeps every tile pair holding a pair the
    gate keeps, whichever way the kernel rounds its distances."""
    ell = _as_ell(ell, x.device)
    d2t = pairwise.d2_threshold(ell, p)
    xlo, xhi, xs = _tile_boxes(x, mx, rows)
    ylo, yhi, ys = _tile_boxes(y, my, cols)
    gap = torch.fmax(torch.fmax(ylo[None] - xhi[:, None],
                                xlo[:, None] - yhi[None]),
                     torch.zeros((), dtype=x.dtype, device=x.device))
    g2 = gap * gap
    gap2 = (g2[..., 0] + g2[..., 1]) + g2[..., 2]
    if slack:
        return gap2 < d2t + SKIP_SLACK * ((d2t + xs[:, None]) + ys[None])
    if margin:
        radius = torch.sqrt(d2t) + margin
        return gap2 < radius * radius
    return gap2 < d2t


_geometry_cache: Dict[tuple, Tuple[int, int, int, int]] = {}


def _geometry(kernel: KernelInfo, symbol: str, device, *args: int):
    """(blocks per SM, SMs, rows per item, columns per tile) of a kernel on
    `device`, from its library's query `symbol`(*args, out) (once per
    device and args)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (symbol, index, args)
    if key not in _geometry_cache:
        fn = _fn(kernel, symbol, [ctypes.c_int] * len(args)
                 + [ctypes.POINTER(ctypes.c_int)])
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(index):
            _raise_on(fn(*args, out), kernel.name)
        if out[3] != KEEP_WORD:
            raise RuntimeError(f"{kernel.name}: {out[3]} columns per tile, "
                               f"the bitmask takes {KEEP_WORD}")
        _geometry_cache[key] = tuple(out)
    return _geometry_cache[key]


def _plans_for(kernel: KernelInfo, symbol: str, shapes, device, *args: int):
    """The splits of pair sets of (rows, columns) `shapes` launched as one
    grid of the kernel `symbol`(*args) reports on `device`: (plans, blocks
    per SM, SMs)."""
    per_sm, sms, rows, cols = _geometry(kernel, symbol, device, *args)
    return plan_sets(tuple(shapes), per_sm * sms, rows, cols), per_sm, sms


def _plan_for(kernel: KernelInfo, symbol: str, n, m, device, *args: int):
    """The split of n rows x m columns for the kernel's resident grid on
    `device`: (plan, blocks per SM, SMs)."""
    plans, per_sm, sms = _plans_for(kernel, symbol, ((n, m),), device, *args)
    return plans[0], per_sm, sms


def _scratch(plan: SplitPlan, device, bits=None, with_bits=True, lanes=1):
    """The scratch of a per-pair launch (plan.scratch()'s shapes; for more
    than one lane, each with a leading lane axis): the keep bitmask (`bits`
    when given), the f32 flow partials, the counts and the f32 step
    partials."""
    shapes = plan.scratch()
    if lanes > 1:
        shapes = {k: (lanes,) + v for k, v in shapes.items()}
    if bits is None and with_bits:
        bits = torch.empty(shapes["bits"], dtype=torch.int32, device=device)
    return (bits,
            torch.empty(shapes["fpart"], dtype=torch.float32, device=device),
            torch.empty(shapes["npart"], dtype=torch.int32, device=device),
            torch.empty(shapes["spart"], dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# moment pass of one align iteration
# ---------------------------------------------------------------------------

def _moment_a(x, y, fx, fy, ell, p: CvoParams):
    """(d2, d2c, a) of row-aligned pairs (x[k], y[k]) or of broadcast
    shapes: distances by explicit differences, coordinate by coordinate (as
    the Pallas kernel), one fused exponential with its clamp at -20."""
    def sq_diffs(a, b):
        e = a[..., 0] - b[..., 0]
        out = e * e
        for c in range(1, a.shape[-1]):
            e = a[..., c] - b[..., c]
            out = out + e * e
        return out

    d2 = sq_diffs(x, y)
    d2c = sq_diffs(fx, fy)
    inv2l2 = 1.0 / (2.0 * ell * ell)
    a = _s2cs2(p) * torch.exp(
        torch.clamp(-(d2 * inv2l2 + d2c * _inv2cl2(p)), min=-20.0))
    return d2, d2c, a


def _moment_gate(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """(keep (N, M), a (N, M)) of the moment form: gate and keep of every
    pair (fixed point i, moving point j)."""
    ell = _as_ell(ell, x.device)
    d2, d2c, a = _moment_a(x[:, None], y[None, :], fx[:, None], fy[None, :],
                           ell, p)
    gate = (d2 < pairwise.d2_threshold(ell, p)) \
        & (d2c < pairwise.d2_color_threshold(p)) & mx[:, None] & my[None, :]
    return gate & (a > p.sp_thres), a


def moment_pass_plain(x, y, fx, fy, mx, my, U, ell, p: CvoParams):
    """(Mom (M, 35), nnz int32): Mom[j] = sum_i keep_ij a_ij U[i],
    nnz = sum keep. Distances are explicit differences (as in the Pallas
    kernel), one fused exponential with its clamp at -20."""
    keep, a = _moment_gate(x, y, fx, fy, mx, my, ell, p)
    A = torch.where(keep, a, torch.zeros_like(a))
    return (U.T @ A).T, torch.sum(keep, dtype=torch.int32)


def moment_keep_bits_plain(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """The moment form's keep as the moment kernel's pass 1 records it:
    rows j of the moving cloud, words over the fixed points i, an int32
    (ceil(N/32), M) bitmask (pack_keep_bits of keep^T). It is not
    keep_bits_plain: the moment form measures distances by explicit
    differences, the per-pair kernels by the dot identity, and the two
    round differently."""
    keep, _ = _moment_gate(x, y, fx, fy, mx, my, ell, p)
    return pack_keep_bits(keep.T)


def moment_from_bits_plain(x, y, fx, fy, U, bits, ell, p: CvoParams):
    """Pass 2 of the moment kernel: (Mom (M, 35), nnz int32) from the keep
    bitmask `bits` (moment_keep_bits_plain's layout). Mom[j] sums a_ij U[i]
    over the kept i of row j in ascending i, one f32 addition after
    another, with a recomputed by pass 1's float operations; nnz is the
    bitmask's count."""
    ell = _as_ell(ell, x.device)
    m = y.shape[0]
    keep = unpack_keep_bits(bits, x.shape[0])          # (M, N)
    j, i = torch.nonzero(keep, as_tuple=True)          # i ascending per j
    _, _, a = _moment_a(x[i], y[j], fx[i], fy[j], ell, p)
    counts = torch.bincount(j, minlength=m)
    rank = torch.arange(j.numel(), device=x.device) \
        - (torch.cumsum(counts, 0) - counts)[j]
    mom = torch.zeros((m, pairwise.N_MOMENTS), dtype=torch.float32,
                      device=x.device)
    for k in range(int(counts.max()) if j.numel() else 0):
        sel = rank == k
        mom[j[sel]] = mom[j[sel]] + a[sel, None] * U[i[sel]]
    return mom, torch.sum(keep, dtype=torch.int32)


def _s2cs2(p: CvoParams) -> float:
    return p.sigma * p.sigma * p.c_sigma * p.c_sigma


def _inv2cl2(p: CvoParams) -> float:
    return 1.0 / (2.0 * p.c_ell * p.c_ell)


@functools.lru_cache(maxsize=16)
def _moment_consts(p: CvoParams):
    """The moment kernel's gate and kernel constants (once per params)."""
    return (pairwise.log_sp_ratio(p), pairwise.d2_color_threshold(p),
            _inv2cl2(p), _s2cs2(p), p.sp_thres)


def moment_pass_cuda(x, y, fx, fy, mx, my, U, ell, p: CvoParams,
                     keep_bits=None, launch_info=None, tile_skip=True):
    """The CUDA moment kernel: same function as moment_pass_plain, in two
    launches. keep_bits (int32 (ceil(N/32), M)) receives pass 1's keep
    bitmask; a launch_info dict receives pass 1's grid, blocks per SM, SMs,
    the split, the tile pairs pass 1 computed (`tiles`, a device tensor)
    and its tile pairs (`tile_pairs`). tile_skip=False computes every tile
    pair (the same outputs bit for bit)."""
    dev = x.device
    n, m = x.shape[0], y.shape[0]
    _check_cloud("fixed", x, fx, mx, n, dev)
    _check_cloud("moving", y, fy, my, m, dev)
    _check_staged("fixed", x, fx, mx)
    _check("U", U, torch.float32, (n, pairwise.N_MOMENTS), dev)
    words = -(-n // KEEP_WORD)
    if keep_bits is None:
        keep_bits = torch.empty((words, m), dtype=torch.int32, device=dev)
    _check("keep_bits", keep_bits, torch.int32, (words, m), dev)
    ell = _as_ell(ell, dev).contiguous()
    # rows: the moving points; staged columns: the fixed points
    plan, per_sm, sms = _plan_for(MOMENT, "moment_geometry", m, n, dev)
    fn = _fn(MOMENT, "moment_flow_step_launch",
             [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
             + [ctypes.c_float] * 5 + [ctypes.c_int]
             + [ctypes.c_void_p] * 5)
    npart = torch.empty((2, plan.items), dtype=torch.int32, device=dev)
    mom = torch.empty((m, pairwise.N_MOMENTS), dtype=torch.float32,
                      device=dev)
    counts = torch.empty((2,), dtype=torch.int32, device=dev)   # nnz, tiles
    err = fn(_ptr(x), _ptr(fx), _ptr(mx), _ptr(U), _ptr(y), _ptr(fy),
             _ptr(my), _ptr(ell), n, m, plan.chunks, plan.tiles_per_chunk,
             *_moment_consts(p), int(tile_skip),
             _ptr(keep_bits), _ptr(npart), _ptr(mom), _ptr(counts),
             _stream(dev))
    _raise_on(err, MOMENT.name)
    MOMENT.count_launch()
    if launch_info is not None:
        launch_info.update(grid=plan.items, blocks_per_sm=per_sm, sms=sms,
                           chunks=plan.chunks,
                           tiles_per_chunk=plan.tiles_per_chunk,
                           tiles=counts[1],
                           tile_pairs=plan.row_tiles * plan.col_tiles)
    return mom, counts[0]


def moment_pass(x, y, fx, fy, mx, my, U, ell, p: CvoParams):
    if x.device.type == "cpu":
        return moment_pass_plain(x, y, fx, fy, mx, my, U, ell, p)
    if x.device.type == "cuda":
        return moment_pass_cuda(x, y, fx, fy, mx, my, U, ell, p)
    raise ValueError(f"unsupported device {x.device}")


EPILOGUE_ROWS = 256   # moving points per block of the epilogue kernel


def moment_epilogue_cuda(Mom, y, center, ell, nnz, p: CvoParams):
    """The CUDA epilogue of the moment form (csrc/moment_step.cu): the same
    function and tuple as pairwise.flow_and_step_from_moments in one
    launch, the outputs views of one new (10,) tensor (omega, v, B, C, D,
    E) and nnz passed through."""
    dev = Mom.device
    m = y.shape[0]
    _check("Mom", Mom, torch.float32, (m, pairwise.N_MOMENTS), dev)
    _check("moving positions", y, torch.float32, (m, 3), dev)
    _check("center", center, torch.float32, (3,), dev)
    ell = _as_ell(ell, dev).contiguous()
    # the 10 outputs, then 4 partials for each block
    blocks = max(1, -(-m // EPILOGUE_ROWS))
    buf = torch.empty((10 + 4 * blocks,), dtype=torch.float32, device=dev)
    out = buf[:10]
    fn = _fn(MOMENT_EPILOGUE, "moment_epilogue_launch",
             [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_float] * 2
             + [ctypes.c_void_p] * 3)
    err = fn(_ptr(Mom), _ptr(y), _ptr(center), _ptr(ell), m, p.c, p.d,
             _ptr(buf[10:]), _ptr(out), _stream(dev))
    _raise_on(err, MOMENT_EPILOGUE.name)
    MOMENT_EPILOGUE.count_launch()
    return out[0:3], out[3:6], nnz, out[6], out[7], out[8], out[9]


def moment_epilogue(Mom, y, center, ell, nnz, p: CvoParams):
    """(omega, v, nnz, B, C, D, E) from the moment matrix Mom (M, 35) of
    the moved cloud y (cvo.cpp:187-334): one launch on the card, the plain
    version (pairwise.flow_and_step_from_moments) on the CPU."""
    if Mom.device.type == "cpu":
        return pairwise.flow_and_step_from_moments(Mom, y, center, ell, nnz,
                                                   p)
    if Mom.device.type == "cuda":
        return moment_epilogue_cuda(Mom, y, center, ell, nnz, p)
    raise ValueError(f"unsupported device {Mom.device}")


def moment_flow_step(x, y, fx, fy, mx, my, U, center, ell, p: CvoParams):
    """One align iteration: (omega, v, nnz, B, C, D, E).

    x/fx/mx: the fixed cloud; y: the moving positions transformed by the
    current estimate, fy/my its features and mask; (center, U): the fixed
    cloud's moment basis (pairwise.step_moment_basis)."""
    ell = _as_ell(ell, x.device)
    Mom, nnz = moment_pass(x, y, fx, fy, mx, my, U, ell, p)
    return moment_epilogue(Mom, y, center, ell, nnz, p)


def moment_flow_step_plain(x, y, fx, fy, mx, my, U, center, ell,
                           p: CvoParams):
    """moment_flow_step through the plain version on any device."""
    ell = _as_ell(ell, x.device)
    Mom, nnz = moment_pass_plain(x, y, fx, fy, mx, my, U, ell, p)
    return pairwise.flow_and_step_from_moments(Mom, y, center, ell, nnz, p)


# ---------------------------------------------------------------------------
# the pallas_mom align loop's state on the card
# ---------------------------------------------------------------------------

ANNEAL_STEPS = 3            # steps of the ell anneal the kernels take
ANNEAL_NEVER = 2 ** 31 - 1  # the iteration of a padding step: never passed


def anneal_schedule(p: CvoParams):
    """The ell anneal schedule (cvo.cpp:810-812) as csrc/align_state.cuh's
    epilogue takes it: (iterations, values), ANNEAL_STEPS of each; after
    iteration k, ell takes the value of every step whose iteration k
    exceeds, in step order. A shorter schedule is padded with steps that
    never fire."""
    its, vals = tuple(p.ell_anneal_iters), tuple(p.ell_anneal_values)
    if len(its) != len(vals) or len(its) > ANNEAL_STEPS:
        raise ValueError(f"the kernels take an ell anneal schedule of at "
                         f"most {ANNEAL_STEPS} (iteration, value) steps")
    pad = ANNEAL_STEPS - len(its)
    return (tuple(int(i) for i in its) + (ANNEAL_NEVER,) * pad,
            tuple(float(v) for v in vals) + (0.0,) * pad)


@functools.lru_cache(maxsize=16)
def _align_params(p: CvoParams, tile_skip=True):
    """(hf, hi): the host arrays of csrc/align_state.cuh's align_params,
    which align_fused and the pallas_mom state update take (once per params;
    the kernels' entry points only read them)."""
    iters, values = anneal_schedule(p)
    hf = (ctypes.c_float * 14)(
        pairwise.log_sp_ratio(p), pairwise.d2_color_threshold(p),
        2.0 * p.c_ell * p.c_ell, _s2cs2(p), p.sp_thres, p.c, p.d, p.eps,
        p.eps_2, p.min_step, p.max_step, *values)
    hi = (ctypes.c_int * 5)(*iters, p.max_iter, int(tile_skip))
    return hf, hi


class MomentState(NamedTuple):
    """The state of a pallas_mom alignment on the card, as the state
    launches write it: f (29,) float32, R (row-major), T, ell and the
    transform [R^T | -R^T T] (4 x 4); n (3,) int32, done, iters, nnz. The
    properties are views."""
    f: torch.Tensor
    n: torch.Tensor

    @property
    def R(self):
        return self.f[:9].view(3, 3)

    @property
    def T(self):
        return self.f[9:12]

    @property
    def ell(self):
        return self.f[12]

    @property
    def transform(self):
        return self.f[13:29].view(4, 4)

    @property
    def done(self):
        return self.n[0]

    @property
    def iters(self):
        return self.n[1]

    @property
    def nnz(self):
        return self.n[2]


def _state_launch(R, T, ell, n, out, k: int, y0, p: CvoParams):
    """One launch of the state kernel: from the state (R, T, ell; n the
    int32 (done, iters, nnz), None for an initial state) and, for k >= 0,
    iteration k's pass output `out` = (omega, v, nnz, B, C, D, E), a new
    MomentState and the moved cloud of y0 (a new (M, 3) tensor)."""
    dev = y0.device
    m = y0.shape[0]
    _check("moving positions", y0, torch.float32, (m, 3), dev)
    _check("R", R, torch.float32, (3, 3), dev)
    _check("T", T, torch.float32, (3,), dev)
    _check("ell", ell, torch.float32, (), dev)
    null = ctypes.c_void_p(None)
    n_ptr = null
    pass_ptrs = [null] * 7
    if n is not None:
        _check("state counts", n, torch.int32, (3,), dev)
        n_ptr = _ptr(n)
    if k >= 0:
        omega, v, nnz_k, B, C, D, E = out
        _check("omega", omega, torch.float32, (3,), dev)
        _check("v", v, torch.float32, (3,), dev)
        _check("nnz", nnz_k, torch.int32, (), dev)
        for name, t in zip("BCDE", (B, C, D, E)):
            _check(name, t, torch.float32, (), dev)
        pass_ptrs = [_ptr(t) for t in (omega, v, B, C, D, E, nnz_k)]
    hf, hi = _align_params(p)
    # the state's 29 floats and 3 ints in one new allocation
    words = torch.empty((32,), dtype=torch.float32, device=dev)
    st = MomentState(words[:29], words[29:].view(torch.int32))
    y = torch.empty((m, 3), dtype=torch.float32, device=dev)
    fn = _fn(MOMENT_STATE, "moment_state_launch",
             [ctypes.c_void_p] * 11 + [ctypes.c_int]
             + [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
             + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4)
    err = fn(_ptr(R), _ptr(T), _ptr(ell), n_ptr, *pass_ptrs, k, hf, hi,
             _ptr(y0), m, _ptr(st.f), _ptr(st.n), _ptr(y), _stream(dev))
    _raise_on(err, MOMENT_STATE.name)
    MOMENT_STATE.count_launch()
    return st, y


def moment_state_init(y0, R0, T0, ell0, p: CvoParams):
    """The initial state of a pallas_mom alignment on the card from (R0
    (3, 3), T0 (3,), ell0 ()) and the moving cloud y0 (M, 3) under it, in
    one launch: (MomentState, y)."""
    return _state_launch(R0, T0, ell0, None, None, -1, y0, p)


def moment_state_step(state: MomentState, out, y0, k: int, p: CvoParams):
    """Iteration k's state update on the card (engine._update's function:
    the step root, both stop tests and the anneal, a stopped alignment
    frozen) from its pass output out = (omega, v, nnz, B, C, D, E), and the
    moving cloud y0 under the new state, in one launch: (MomentState, y),
    both new tensors."""
    return _state_launch(state.R, state.T, state.ell, state.n, out, k, y0,
                         p)


# ---------------------------------------------------------------------------
# inner-product suite of compute_innerproduct
# ---------------------------------------------------------------------------

def ip_suite_plain(x, fx, mx, y, fy, my, yt, ell, p: CvoParams):
    """pairwise.ip_suite: the plain version of the suite kernel."""
    return pairwise.ip_suite(x, fx, mx, y, fy, my, yt,
                             _as_ell(ell, x.device), p)


# the suite's pair sets, in the order of csrc/ip_suite.cu's plan and
# outputs; post carries the moments
SUITE_SETS = ("pre", "post", "fixed", "moving")


def suite_shapes(n: int, m: int) -> Tuple[Tuple[int, int], ...]:
    """(rows, columns) of the suite's pair sets (SUITE_SETS) for a fixed
    cloud of n points and a moving one of m: pre (rows y, columns x), post
    (yt, x), fixed (x, x), moving (y, y)."""
    return ((m, n), (m, n), (n, n), (m, m))


def suite_scratch(plans):
    """The suite's scratch for the plans of its four sets (SUITE_SETS
    order), which csrc/ip_suite.cu takes as given: (shapes, offsets). Each
    set's partials lie after the other's: f32 item partials (NG + 1 floats
    for post, else 1), i32 item counts, f32 and i32 level-1 group partials;
    then the outputs (G, then the four sums) and out_n, the four counts,
    the four sets' tile pairs computed, the level-2 ticket and one level-1
    ticket per group. offsets[s]: the
    set's first float of fpart, count of npart, float of gpart and group of
    gnpart (and of the level-1 tickets)."""
    ends = [0, 0, 0, 0]
    offsets = []
    for name, q in zip(SUITE_SETS, plans):
        nf = NG + 1 if name == "post" else 1
        groups = -(-q.items // finalize_group(q.items))
        offsets.append(tuple(ends))
        ends = [e + k for e, k in zip(ends, (q.items * nf, q.items,
                                             groups * nf, groups))]
    shapes = dict(zip(("fpart", "npart", "gpart", "gnpart"),
                      ((e,) for e in ends)))
    shapes.update(out_f=(NG + 4,), out_n=(4 + 4 + 1 + ends[3],))
    return shapes, tuple(offsets)


def _suite_launch(x, fx, mx, y, fy, my, yt, ell, p: CvoParams, lanes,
                  launch_info=None, tile_skip=True):
    """One launch of csrc/ip_suite.cu for `lanes` lanes: x/fx/mx a stack of
    `lanes` fixed clouds or one fixed cloud of every lane, y/fy/my and yt
    stacks of `lanes` (yt is laid at y's lane stride), ell (lanes,).
    Returns (out_f (lanes, 173), out_n (lanes, ...)). A launch_info dict
    receives the grid, blocks per SM, SMs, each set's split, the tile pairs
    each set computed (`tiles`, a device tensor (lanes, 4) in SUITE_SETS
    order) and each set's tile pairs (`tile_pairs`). tile_skip=False
    computes every tile pair (the same outputs bit for bit)."""
    dev = y.device
    n, m = x.shape[-2], y.shape[1]
    x_lane = _check_lane_cloud("fixed", x, fx, mx, lanes, n, dev)
    y_lane = _check_lane_cloud("moving", y, fy, my, lanes, m, dev)
    _check_meta("yt", yt, torch.float32, (lanes, m, 3), dev)
    yt = _at_lane_stride(yt, y_lane)   # the post set's rows: yt, fy, my
    _check("ell", ell, torch.float32, (lanes,), dev)
    # both clouds are staged as columns: fixed for pre, post and fixed,
    # moving for the moving self set
    _check_staged("fixed", x, fx, mx)
    _check_staged("moving", y, fy, my)
    plans, per_sm, sms = _plans_for(IP_SUITE, "suite_geometry",
                                    suite_shapes(n, m), dev)
    fn = _fn(IP_SUITE, "ip_suite_launch",
             [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.POINTER(ctypes.c_int)] * 2
             + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 7)
    shapes, offsets = suite_scratch(plans)
    plan = (ctypes.c_int * 28)(*[v for q, o in zip(plans, offsets) for v in (
        q.chunks, q.tiles_per_chunk, finalize_group(q.items), *o)])
    sizes = (ctypes.c_int * 5)(*[shapes[k][0] for k in (
        "fpart", "npart", "gpart", "gnpart", "out_n")])
    fpart, gpart, out_f = (torch.empty((lanes,) + shapes[k],
                                       dtype=torch.float32, device=dev)
                           for k in ("fpart", "gpart", "out_f"))
    npart, gnpart, out_n = (torch.empty((lanes,) + shapes[k],
                                        dtype=torch.int32, device=dev)
                            for k in ("npart", "gnpart", "out_n"))
    err = fn(_ptr(x), _ptr(fx), _ptr(mx), _ptr(y), _ptr(fy), _ptr(my),
             _ptr(yt), _ptr(ell), n, m, lanes, x_lane, y_lane,
             int(tile_skip), plan, sizes,
             pairwise.log_sp_ratio(p), pairwise.d2_color_threshold(p),
             p.sigma * p.sigma, p.c_sigma * p.c_sigma,
             2.0 * p.c_ell * p.c_ell,
             _ptr(fpart), _ptr(npart), _ptr(gpart), _ptr(gnpart),
             _ptr(out_f), _ptr(out_n), _stream(dev))
    _raise_on(err, IP_SUITE.name)
    if launch_info is not None:
        launch_info.update(grid=lanes * sum(q.items for q in plans),
                           blocks_per_sm=per_sm, sms=sms, lanes=lanes,
                           chunks=tuple(q.chunks for q in plans),
                           tiles_per_chunk=tuple(q.tiles_per_chunk
                                                 for q in plans),
                           tiles=out_n[:, 4:8],
                           tile_pairs=tuple(q.row_tiles * q.col_tiles
                                            for q in plans))
    return out_f, out_n


def _suite_tuple(out_f, out_n):
    """The suite's 10-tuple from a launch's outputs, each with the lane
    axis first."""
    G = out_f[:, :NG].reshape(-1, 13, 13)
    s = out_f[:, NG:NG + 4]
    counts = out_n[:, :4]
    n_f = torch.where(counts == 0, torch.ones_like(counts), counts).float()
    return (s[:, 0], n_f[:, 0], s[:, 1], n_f[:, 1], s[:, 2], n_f[:, 2],
            s[:, 3], n_f[:, 3], G, out_n[:, 1])


def ip_suite_cuda(x, fx, mx, y, fy, my, yt, ell, p: CvoParams,
                  launch_info=None, tile_skip=True):
    """The CUDA suite kernel: same function and tuple as ip_suite_plain, in
    one launch over the four pair sets (the launch of one lane). A
    launch_info dict receives the grid, blocks per SM, SMs, each set's
    split, the tile pairs each set computed (`tiles`, a device tensor (4,)
    in SUITE_SETS order) and each set's tile pairs (`tile_pairs`).
    tile_skip=False computes every tile pair (the same outputs bit for
    bit)."""
    dev = x.device
    _check_cloud("fixed", x, fx, mx, x.shape[0], dev)
    _check("yt", yt, torch.float32, (y.shape[0], 3), dev)
    out_f, out_n = _suite_launch(
        x, fx, mx, y[None], fy[None], my[None], yt[None],
        _as_ell(ell, dev).reshape(1).contiguous(), p, 1, launch_info,
        tile_skip)
    IP_SUITE.count_launch()
    if launch_info is not None:
        launch_info["tiles"] = out_n[0, 4:8]
    return tuple(t[0] for t in _suite_tuple(out_f, out_n))


def ip_suite_lanes_plain(x, fx, mx, y, fy, my, yt, ell, p: CvoParams):
    """The plain version of the suite's lanes: ip_suite_plain lane by lane,
    each output stacked on a leading lane axis."""
    lanes = y.shape[0]
    ell = torch.as_tensor(ell, dtype=torch.float32, device=y.device)
    outs = [ip_suite_plain(*(_lane(t, l) for t in (x, fx, mx)), y[l], fy[l],
                           my[l], yt[l], ell[l], p) for l in range(lanes)]
    return tuple(torch.stack(v) for v in zip(*outs))


def ip_suite_lanes_cuda(x, fx, mx, y, fy, my, yt, ell, p: CvoParams,
                        launch_info=None, tile_skip=True):
    """The CUDA suite kernel over S lanes in one launch: same function and
    tuple as ip_suite_lanes_plain (launch_info and tile_skip:
    _suite_launch's)."""
    lanes = y.shape[0]
    _check_lanes(lanes)
    out_f, out_n = _suite_launch(x, fx, mx, y, fy, my, yt, ell, p, lanes,
                                 launch_info, tile_skip)
    IP_SUITE_LANES.count_launch()
    return _suite_tuple(out_f, out_n)


def ip_suite_lanes(x, fx, mx, y, fy, my, yt, ell, p: CvoParams):
    """The suites of S cloud pairs: y/fy/my (S, M, .) the moving clouds, yt
    (S, M, 3) their positions under each lane's registration result, ell
    (S,), and x/fx/mx (S, N, .) the fixed clouds or (N, .) one fixed cloud
    of every lane. Returns ip_suite's 10-tuple, each entry with a leading
    lane axis."""
    if y.device.type == "cpu":
        return ip_suite_lanes_plain(x, fx, mx, y, fy, my, yt, ell, p)
    if y.device.type == "cuda":
        return ip_suite_lanes_cuda(x, fx, mx, y, fy, my, yt, ell, p)
    raise ValueError(f"unsupported device {y.device}")


def _lane(t, l):
    """Lane l of a stack of clouds, or the one cloud of every lane (a
    fixed cloud with no lane axis)."""
    return t[l] if t.dim() == (2 if t.dtype == torch.bool else 3) else t


def ip_suite(x, fx, mx, y, fy, my, yt, ell, p: CvoParams):
    """(pre_v, pre_n, post_v, post_n, fixed_v, fixed_n, moving_v, moving_n,
    G, inliers): x/fx/mx the fixed cloud, y/fy/my the moving one, yt the
    moving positions under the registration result."""
    if x.device.type == "cpu":
        return ip_suite_plain(x, fx, mx, y, fy, my, yt, ell, p)
    if x.device.type == "cuda":
        return ip_suite_cuda(x, fx, mx, y, fy, my, yt, ell, p)
    raise ValueError(f"unsupported device {x.device}")


# ---------------------------------------------------------------------------
# pair stats of compute_innerproduct_lc (one pair set of the suite)
# ---------------------------------------------------------------------------

def pair_stats_plain(xa, fa, ma, xb, fb, mb, ell, p: CvoParams,
                     with_moments: bool = False):
    """pairwise.pair_stats: the plain version of the pair-stats kernel."""
    return pairwise.pair_stats(xa, fa, ma, xb, fb, mb,
                               _as_ell(ell, xa.device), p, with_moments)


def _pair_stats_launch(xa, fa, ma, xb, fb, mb, ell, p: CvoParams,
                       with_moments, lanes, launch_info=None,
                       tile_skip=True):
    """One launch of csrc/pair_stats.cu for `lanes` lanes: rows xa/fa/ma
    and columns xb/fb/mb each a stack of `lanes` clouds or one cloud of
    every lane, ell (lanes,). Returns (out_f (lanes, 170), out_n (lanes,
    3 + groups)). A launch_info dict receives the grid, blocks per SM, SMs,
    lanes, the split, the tile pairs each lane computed (`tiles`, a device
    tensor (lanes,)) and a sweep's tile pairs (`tile_pairs`).
    tile_skip=False computes every tile pair (the same outputs bit for
    bit)."""
    dev = xa.device
    n, m = xa.shape[-2], xb.shape[-2]
    a_lane = _check_lane_cloud("row", xa, fa, ma, lanes, n, dev)
    b_lane = _check_lane_cloud("column", xb, fb, mb, lanes, m, dev)
    _check_staged("column", xb, fb, mb)
    _check("ell", ell, torch.float32, (lanes,), dev)
    mom = int(with_moments)
    plan, per_sm, sms = _plan_for(PAIR_STATS, "pair_stats_geometry", n, m,
                                  dev, mom)
    fn = _fn(PAIR_STATS, "pair_stats_launch",
             [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
             + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 7)
    group = finalize_group(plan.items)
    groups = -(-plan.items // group)
    nf = NG + 1 if with_moments else 1
    fpart = torch.empty((lanes, plan.items, nf), dtype=torch.float32,
                        device=dev)
    npart = torch.empty((lanes, plan.items), dtype=torch.int32, device=dev)
    gpart = torch.empty((lanes, groups, nf), dtype=torch.float32, device=dev)
    gnpart = torch.empty((lanes, groups), dtype=torch.int32, device=dev)
    out_f = torch.empty((lanes, NG + 1), dtype=torch.float32, device=dev)
    out_n = torch.empty((lanes, 3 + groups), dtype=torch.int32, device=dev)
    err = fn(_ptr(xa), _ptr(fa), _ptr(ma), _ptr(xb), _ptr(fb), _ptr(mb),
             _ptr(ell), n, m, lanes, a_lane, b_lane, plan.chunks,
             plan.tiles_per_chunk, group, mom, int(tile_skip),
             pairwise.log_sp_ratio(p), pairwise.d2_color_threshold(p),
             p.sigma * p.sigma, p.c_sigma * p.c_sigma,
             2.0 * p.c_ell * p.c_ell, _ptr(fpart), _ptr(npart), _ptr(gpart),
             _ptr(gnpart), _ptr(out_f), _ptr(out_n), _stream(dev))
    _raise_on(err, PAIR_STATS.name)
    if launch_info is not None:
        launch_info.update(grid=lanes * plan.items, blocks_per_sm=per_sm,
                           sms=sms, lanes=lanes, chunks=plan.chunks,
                           tiles_per_chunk=plan.tiles_per_chunk,
                           tiles=out_n[:, 1],
                           tile_pairs=plan.row_tiles * plan.col_tiles)
    return out_f, out_n


def _pair_stats_tuple(out_f, out_n, with_moments):
    """Pair stats' (value, num[, G, inliers]) from a launch's outputs, each
    with the lane axis first."""
    count = out_n[:, 0]
    num = torch.where(count == 0, torch.ones_like(count), count).float()
    if not with_moments:
        return out_f[:, NG], num
    return out_f[:, NG], num, out_f[:, :NG].reshape(-1, 13, 13), count


def pair_stats_cuda(xa, fa, ma, xb, fb, mb, ell, p: CvoParams,
                    with_moments: bool = False, launch_info=None,
                    tile_skip=True):
    """The CUDA pair-stats kernel: same function and tuple as
    pair_stats_plain, in one launch (the launch of one lane). A
    launch_info dict receives the grid, blocks per SM, SMs, the split, the
    tile pairs computed (`tiles`, a device tensor) and a sweep's tile pairs
    (`tile_pairs`). tile_skip=False computes every tile pair (the same
    outputs bit for bit)."""
    dev = xa.device
    _check_cloud("row", xa, fa, ma, xa.shape[0], dev)
    out_f, out_n = _pair_stats_launch(
        xa, fa, ma, xb, fb, mb, _as_ell(ell, dev).reshape(1).contiguous(),
        p, with_moments, 1, launch_info, tile_skip)
    PAIR_STATS.count_launch()
    if launch_info is not None:
        launch_info["tiles"] = out_n[0, 1]
    return tuple(t[0] for t in _pair_stats_tuple(out_f, out_n,
                                                 with_moments))


def pair_stats(xa, fa, ma, xb, fb, mb, ell, p: CvoParams,
               with_moments: bool = False):
    """(value, num) of the gated inner product of rows xa/fa/ma against
    columns xb/fb/mb, and with `with_moments` also (G (13, 13), inliers)."""
    if xa.device.type == "cpu":
        return pair_stats_plain(xa, fa, ma, xb, fb, mb, ell, p, with_moments)
    if xa.device.type == "cuda":
        return pair_stats_cuda(xa, fa, ma, xb, fb, mb, ell, p, with_moments)
    raise ValueError(f"unsupported device {xa.device}")


def pair_stats_lanes_plain(xa, fa, ma, xb, fb, mb, ell, p: CvoParams,
                           with_moments: bool = False):
    """The plain version of the pair-stats lanes: pair_stats_plain lane by
    lane, each output stacked on a leading lane axis."""
    ell = torch.as_tensor(ell, dtype=torch.float32, device=xa.device)
    outs = [pair_stats_plain(*(_lane(t, l) for t in (xa, fa, ma, xb, fb,
                                                     mb)),
                             ell[l], p, with_moments)
            for l in range(ell.shape[0])]
    return tuple(torch.stack(v) for v in zip(*outs))


def pair_stats_lanes_cuda(xa, fa, ma, xb, fb, mb, ell, p: CvoParams,
                          with_moments: bool = False, launch_info=None,
                          tile_skip=True):
    """The CUDA pair-stats kernel over S lanes in one launch: same function
    and tuple as pair_stats_lanes_plain (launch_info and tile_skip:
    _pair_stats_launch's)."""
    lanes = ell.shape[0]
    _check_lanes(lanes)
    out_f, out_n = _pair_stats_launch(xa, fa, ma, xb, fb, mb, ell, p,
                                      with_moments, lanes, launch_info,
                                      tile_skip)
    PAIR_STATS_LANES.count_launch()
    return _pair_stats_tuple(out_f, out_n, with_moments)


def pair_stats_lanes(xa, fa, ma, xb, fb, mb, ell, p: CvoParams,
                     with_moments: bool = False):
    """The pair stats of S cloud pairs: rows xa/fa/ma and columns xb/fb/mb
    each a stack (S, N, .) / (S, M, .) (laid as stack_lanes lays one) or
    one cloud (N, .) / (M, .) of every lane, ell (S,). Returns pair_stats'
    tuple, each entry with a leading lane axis."""
    if xa.device.type == "cpu":
        return pair_stats_lanes_plain(xa, fa, ma, xb, fb, mb, ell, p,
                                      with_moments)
    if xa.device.type == "cuda":
        return pair_stats_lanes_cuda(xa, fa, ma, xb, fb, mb, ell, p,
                                     with_moments)
    raise ValueError(f"unsupported device {xa.device}")


# ---------------------------------------------------------------------------
# one align iteration in per-pair form: flow, step coefficients, both
# ---------------------------------------------------------------------------

_BOTH, _FLOW_ONLY, _STEP_ONLY = 0, 1, 2


def flow_plain(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """(omega, v, nnz): pairwise.flow, the plain version of the flow pass."""
    omega, v, _, nnz = pairwise.flow(x, y, fx, fy, mx, my,
                                     _as_ell(ell, x.device), p)
    return omega, v, nnz


def step_coeffs_plain(x, y, fx, fy, mx, my, omega, v, ell, p: CvoParams):
    """(B, C, D, E): pairwise.step_coeffs over pairwise.cvo_kernel, the
    plain version of the step pass."""
    ell = _as_ell(ell, x.device)
    A, _ = pairwise.cvo_kernel(x, y, fx, fy, mx, my, ell, p)
    return pairwise.step_coeffs(x, y, A, omega, v, ell)


def flow_and_step_plain(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """pairwise.flow_and_step: the plain version of the fused pass."""
    return pairwise.flow_and_step(x, y, fx, fy, mx, my,
                                  _as_ell(ell, x.device), p)


def _flow_step_cuda(mode, x, y, fx, fy, mx, my, ell, p: CvoParams, wv=None,
                    keep_bits=None, launch_info=None, tile_skip=True):
    """One call of csrc/flow_step.cu in `mode`; returns (out_f (10,):
    omega, v, B, C, D, E; out_n (4,): nnz, the passes' tickets and the tile
    pairs the gate sweep computed), each holding its mode's outputs.
    keep_bits: an int32 (ceil(M/32), N) tensor that receives pass 1's keep
    bitmask (modes 0, 1). A launch_info dict receives the grid, blocks per
    SM, SMs, the split, the computed tile pairs (`tiles`, a device tensor)
    and the sweep's tile pairs (`tile_pairs`). tile_skip=False computes
    every tile pair (the same outputs bit for bit)."""
    dev = x.device
    n, m = x.shape[0], y.shape[0]
    _check_cloud("fixed", x, fx, mx, n, dev)
    _check_cloud("moving", y, fy, my, m, dev)
    _check_staged("moving", y, fy, my)
    if wv is not None:
        _check("omega, v", wv, torch.float32, (6,), dev)
    if keep_bits is not None:
        _check("keep_bits", keep_bits, torch.int32, (-(-m // KEEP_WORD), n),
               dev)
    ell = _as_ell(ell, dev).contiguous()
    plan, per_sm, sms = _plan_for(FLOW_AND_STEP, "flow_step_geometry", n, m,
                                  dev)
    fn = _fn(FLOW_AND_STEP, "flow_and_step_launch",
             [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
             + [ctypes.c_float] * 7 + [ctypes.c_int]
             + [ctypes.c_void_p] * 8)
    bits, fpart, npart, spart = _scratch(plan, dev, keep_bits,
                                         mode != _STEP_ONLY)
    out_f = torch.zeros((10,), dtype=torch.float32, device=dev)
    out_n = torch.zeros((4,), dtype=torch.int32, device=dev)
    err = fn(mode, _ptr(x), _ptr(fx), _ptr(mx), _ptr(y), _ptr(fy), _ptr(my),
             _ptr(ell), n, m, plan.chunks, plan.tiles_per_chunk,
             pairwise.log_sp_ratio(p), pairwise.d2_color_threshold(p),
             2.0 * p.c_ell * p.c_ell, _s2cs2(p), p.sp_thres, p.c, p.d,
             int(tile_skip),
             ctypes.c_void_p(None if wv is None else wv.data_ptr()),
             ctypes.c_void_p(None if bits is None else bits.data_ptr()),
             _ptr(fpart), _ptr(npart), _ptr(spart), _ptr(out_f),
             _ptr(out_n), _stream(dev))
    _raise_on(err, FLOW_AND_STEP.name)
    if launch_info is not None:
        launch_info.update(grid=plan.items, blocks_per_sm=per_sm, sms=sms,
                           chunks=plan.chunks,
                           tiles_per_chunk=plan.tiles_per_chunk,
                           tiles=out_n[3],
                           tile_pairs=plan.row_tiles * plan.col_tiles)
    return out_f, out_n


def flow_cuda(x, y, fx, fy, mx, my, ell, p: CvoParams, launch_info=None,
              tile_skip=True):
    """The CUDA flow pass: same function and tuple as flow_plain
    (launch_info and tile_skip: _flow_step_cuda's)."""
    out_f, out_n = _flow_step_cuda(_FLOW_ONLY, x, y, fx, fy, mx, my, ell, p,
                                   launch_info=launch_info,
                                   tile_skip=tile_skip)
    FLOW.count_launch()
    return out_f[0:3], out_f[3:6], out_n[0]


def step_coeffs_cuda(x, y, fx, fy, mx, my, omega, v, ell, p: CvoParams,
                     launch_info=None, tile_skip=True):
    """The CUDA step pass: same function and tuple as step_coeffs_plain
    (launch_info and tile_skip: _flow_step_cuda's)."""
    wv = torch.cat([omega.reshape(3), v.reshape(3)]).to(
        device=x.device, dtype=torch.float32).contiguous()
    out_f, _ = _flow_step_cuda(_STEP_ONLY, x, y, fx, fy, mx, my, ell, p, wv,
                               launch_info=launch_info, tile_skip=tile_skip)
    STEP.count_launch()
    return out_f[6], out_f[7], out_f[8], out_f[9]


def flow_and_step_cuda(x, y, fx, fy, mx, my, ell, p: CvoParams,
                       keep_bits=None, launch_info=None, tile_skip=True):
    """Both passes in one call (two launches): same function and tuple as
    flow_and_step_plain. keep_bits (int32 (ceil(M/32), N)) receives the
    keep bitmask of pass 1; launch_info and tile_skip: _flow_step_cuda's."""
    out_f, out_n = _flow_step_cuda(_BOTH, x, y, fx, fy, mx, my, ell, p,
                                   keep_bits=keep_bits,
                                   launch_info=launch_info,
                                   tile_skip=tile_skip)
    FLOW_AND_STEP.count_launch()
    return (out_f[0:3], out_f[3:6], out_n[0], out_f[6], out_f[7], out_f[8],
            out_f[9])


def flow(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """(omega, v, nnz) of the fixed cloud x/fx/mx against the transformed
    moving cloud y/fy/my (compute_flow, cvo.cpp:187-236)."""
    if x.device.type == "cpu":
        return flow_plain(x, y, fx, fy, mx, my, ell, p)
    if x.device.type == "cuda":
        return flow_cuda(x, y, fx, fy, mx, my, ell, p)
    raise ValueError(f"unsupported device {x.device}")


def step_coeffs(x, y, fx, fy, mx, my, omega, v, ell, p: CvoParams):
    """(B, C, D, E) of the step-size quartic for the flow (omega, v)
    (compute_step_size, cvo.cpp:239-315)."""
    if x.device.type == "cpu":
        return step_coeffs_plain(x, y, fx, fy, mx, my, omega, v, ell, p)
    if x.device.type == "cuda":
        return step_coeffs_cuda(x, y, fx, fy, mx, my, omega, v, ell, p)
    raise ValueError(f"unsupported device {x.device}")


def flow_and_step(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """One align iteration in per-pair form: (omega, v, nnz, B, C, D, E)."""
    if x.device.type == "cpu":
        return flow_and_step_plain(x, y, fx, fy, mx, my, ell, p)
    if x.device.type == "cuda":
        return flow_and_step_cuda(x, y, fx, fy, mx, my, ell, p)
    raise ValueError(f"unsupported device {x.device}")


# ---------------------------------------------------------------------------
# the whole align loop in one launch
# ---------------------------------------------------------------------------

def align_fused_plain(x, fx, mx, y0, fy, my, R0, T0, ell0, p: CvoParams):
    """engine.align_loop over flow_and_step_plain (then ops/cubic and
    ops/se3 on the host): (R, T, ell, iters, nnz)."""
    from .engine import align_loop   # engine imports this module
    res = align_loop(
        lambda y, ell: flow_and_step_plain(x, y, fx, fy, mx, my, ell, p),
        y0, R0, T0, ell0, p)
    return res.R, res.T, res.ell, res.iters, res.nnz


def _align_launch(x, fx, mx, y0, fy, my, R0, T0, ell0, p: CvoParams, lanes,
                  launch_info=None, tile_skip=True):
    """One cooperative launch of csrc/align_fused.cu for `lanes` lanes:
    y0/fy/my stacks of `lanes` moving clouds, x/fx/mx a stack of fixed
    clouds or one fixed cloud of every lane, R0 (lanes, 3, 3), T0
    (lanes, 3), ell0 (lanes,). Returns (out_f (lanes, 13): R, T, ell;
    out_n (lanes, 3): iters, nnz and the tile pairs pass 1 computed over
    the lane's iterations). tile_skip=False computes every tile pair (the
    same outputs bit for bit)."""
    dev = y0.device
    n, m = x.shape[-2], y0.shape[1]
    _check_lanes(lanes)
    x_lane = _check_lane_cloud("fixed", x, fx, mx, lanes, n, dev)
    y_lane = _check_lane_cloud("moving", y0, fy, my, lanes, m, dev)
    _check_staged("moving", y0, fy, my)
    _check("R0", R0, torch.float32, (lanes, 3, 3), dev)
    _check("T0", T0, torch.float32, (lanes, 3), dev)
    _check("ell0", ell0, torch.float32, (lanes,), dev)
    hf, hi = _align_params(p, tile_skip)
    init = torch.cat([R0.reshape(lanes, 9), T0, ell0[:, None]],
                     dim=1).contiguous()
    info = (ctypes.c_int * 4)()
    plan, _, _ = _plan_for(ALIGN, "align_fused_geometry", n, m, dev)
    fn = _fn(ALIGN, "align_fused_launch",
             [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int)]
             + [ctypes.c_void_p] * 6
             + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    bits, fpart, npart, spart = _scratch(plan, dev, lanes=lanes)
    out_f = torch.empty((lanes, 13), dtype=torch.float32, device=dev)
    out_n = torch.empty((lanes, 3), dtype=torch.int32, device=dev)
    err = fn(_ptr(x), _ptr(fx), _ptr(mx), _ptr(y0), _ptr(fy), _ptr(my), n,
             m, lanes, x_lane, y_lane, plan.chunks, plan.tiles_per_chunk,
             _ptr(init),
             hf, hi, _ptr(bits), _ptr(fpart), _ptr(npart), _ptr(spart),
             _ptr(out_f), _ptr(out_n), info, _stream(dev))
    _raise_on(err, ALIGN.name)
    if launch_info is not None:
        launch_info.update(grid=info[0], blocks_per_sm=info[1], sms=info[2],
                           items=info[3], lanes=lanes, chunks=plan.chunks,
                           tiles_per_chunk=plan.tiles_per_chunk,
                           tiles=out_n[:, 2],
                           tile_pairs=plan.row_tiles * plan.col_tiles)
    return out_f, out_n


def align_fused_cuda(x, fx, mx, y0, fy, my, R0, T0, ell0, p: CvoParams,
                     launch_info: dict | None = None, tile_skip=True):
    """The cooperative align kernel: same function and tuple as
    align_fused_plain, in one launch (the launch of one lane). A
    `launch_info` dict receives the launch's grid, blocks per SM, SM count,
    work items, the split, the tile pairs pass 1 computed over the
    iterations (`tiles`, a device tensor of one lane) and the tile pairs of
    one sweep (`tile_pairs`). tile_skip=False computes every tile pair (the
    same outputs bit for bit)."""
    dev = x.device
    _check_cloud("fixed", x, fx, mx, x.shape[0], dev)
    _check_cloud("moving", y0, fy, my, y0.shape[0], dev)
    _check("R0", R0, torch.float32, (3, 3), dev)
    _check("T0", T0, torch.float32, (3,), dev)
    out_f, out_n = _align_launch(
        x, fx, mx, y0[None], fy[None], my[None], R0[None], T0[None],
        _as_ell(ell0, dev).reshape(1), p, 1, launch_info, tile_skip)
    ALIGN.count_launch()
    return (out_f[0, :9].reshape(3, 3), out_f[0, 9:12], out_f[0, 12],
            out_n[0, 0], out_n[0, 1])


def align_fused_lanes_plain(x, fx, mx, y0, fy, my, R0, T0, ell0,
                            p: CvoParams):
    """The plain version of the align lanes: align_fused_plain lane by
    lane, each output stacked on a leading lane axis."""
    lanes = y0.shape[0]
    ell0 = torch.as_tensor(ell0, dtype=torch.float32, device=y0.device)
    outs = [align_fused_plain(*(_lane(t, l) for t in (x, fx, mx)), y0[l],
                              fy[l], my[l], R0[l], T0[l], ell0[l], p)
            for l in range(lanes)]
    return tuple(torch.stack(v) for v in zip(*outs))


def align_fused_lanes_cuda(x, fx, mx, y0, fy, my, R0, T0, ell0,
                           p: CvoParams, launch_info: dict | None = None,
                           tile_skip=True):
    """The cooperative align kernel over S lanes in one launch: same
    function and tuple as align_fused_lanes_plain. A `launch_info` dict
    receives the grid, blocks per SM, SMs, work items, lanes, the split,
    each lane's computed tile pairs (`tiles`) and the tile pairs of one
    sweep (`tile_pairs`). tile_skip=False computes every tile pair (the
    same outputs bit for bit)."""
    lanes = y0.shape[0]
    out_f, out_n = _align_launch(x, fx, mx, y0, fy, my, R0, T0, ell0, p,
                                 lanes, launch_info, tile_skip)
    ALIGN_LANES.count_launch()
    return (out_f[:, :9].reshape(lanes, 3, 3), out_f[:, 9:12], out_f[:, 12],
            out_n[:, 0], out_n[:, 1])


def align_fused_lanes(x, fx, mx, y0, fy, my, R0, T0, ell0, p: CvoParams):
    """S align loops in one launch: lane l aligns y0/fy/my[l] (S, M, .)
    against x/fx/mx[l] (S, N, .), or against one fixed cloud x/fx/mx
    (N, .) of every lane, from (R0[l], T0[l], ell0[l]). A lane stops on its
    own stop rule and stays frozen while the others run. Returns (R, T,
    ell, iters, nnz), each with a leading lane axis."""
    if y0.device.type == "cpu":
        return align_fused_lanes_plain(x, fx, mx, y0, fy, my, R0, T0, ell0,
                                       p)
    if y0.device.type == "cuda":
        return align_fused_lanes_cuda(x, fx, mx, y0, fy, my, R0, T0, ell0, p)
    raise ValueError(f"unsupported device {y0.device}")


def align_fused(x, fx, mx, y0, fy, my, R0, T0, ell0, p: CvoParams):
    """The align loop (cvo.cpp:763-821) of the moving cloud y0/fy/my against
    the fixed cloud x/fx/mx from (R0, T0, ell0): (R, T, ell, iters, nnz)."""
    if x.device.type == "cpu":
        return align_fused_plain(x, fx, mx, y0, fy, my, R0, T0, ell0, p)
    if x.device.type == "cuda":
        return align_fused_cuda(x, fx, mx, y0, fy, my, R0, T0, ell0, p)
    raise ValueError(f"unsupported device {x.device}")


# ---------------------------------------------------------------------------
# Hessian epilogue of the inner products (cvo.cpp:726-755)
# ---------------------------------------------------------------------------

def hessian_post_plain(H_raw, inliers, p: CvoParams):
    """The plain version of the epilogue kernel: (post_hessian (S, 6, 6),
    total shift (S,)) of a stack H_raw (S, 6, 6) with inliers (S,).

    The eigenvalues come from one fixed-sweep Jacobi call over the stack on
    the device (which gives each matrix's eigenvalues bit for bit as alone)
    and one host copy; the shift loop (at most 64 steps, float32 like the
    device) runs on each lane's six host copies."""
    H = H_raw * p.hessian_scale
    lams = eigvalsh_jacobi(H)
    with spans.span("device.read"):
        lams = lams.cpu().numpy()
    totals = np.zeros(len(lams), np.float32)
    for j, lam in enumerate(lams):
        total = np.float32(0.0)
        for _ in range(64):
            lam_min = lam[np.argmin(np.abs(lam))]
            if not abs(lam_min) < p.hessian_min_abs_eig:
                break
            shift = np.float32(1.0) - lam_min
            lam = lam + shift
            total = np.float32(total + shift)
        totals[j] = total
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    totals = torch.as_tensor(totals, device=H.device)
    H = H + totals[:, None, None] * eye
    return torch.where(inliers.reshape(-1, 1, 1) > 0, H, eye), totals


def hessian_post_cuda(H_raw, inliers, p: CvoParams):
    """The CUDA epilogue kernel: same function and pair as
    hessian_post_plain, bit for bit, in one launch and no host read. H_raw
    (S, 6, 6) f32 contiguous, inliers (S,) int32 at any stride."""
    dev = H_raw.device
    lanes = H_raw.shape[0]
    _check("H_raw", H_raw, torch.float32, (lanes, 6, 6), dev)
    _check_meta("inliers", inliers, torch.int32, (lanes,), dev)
    post = torch.empty_like(H_raw)
    totals = torch.empty((lanes,), dtype=torch.float32, device=dev)
    fn = _fn(HESSIAN_POST, "hessian_post_launch",
             [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3)
    err = fn(_ptr(H_raw), _ptr(inliers), lanes, inliers.stride(0),
             p.hessian_scale, p.hessian_min_abs_eig, _ptr(post),
             _ptr(totals), _stream(dev))
    _raise_on(err, HESSIAN_POST.name)
    HESSIAN_POST.count_launch()
    return post, totals


def hessian_post(H_raw, inliers, p: CvoParams):
    """Scale a stack of raw Hessians H_raw (S, 6, 6) by hessian_scale, then
    shift each one's spectrum until its least |eigenvalue| reaches
    hessian_min_abs_eig (cvo.cpp:726-754); the identity for a lane with no
    inliers (S,). Returns (post_hessian (S, 6, 6), total shift (S,))."""
    if H_raw.device.type == "cpu":
        return hessian_post_plain(H_raw, inliers, p)
    if H_raw.device.type == "cuda":
        return hessian_post_cuda(H_raw, inliers, p)
    raise ValueError(f"unsupported device {H_raw.device}")
