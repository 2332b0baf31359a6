"""Port, per-pair kernels' bookkeeping (CPU): the work split that
cvo_slam_tpu_torch.cvo.kernels.plan_split makes for csrc/flow_step.cu,
csrc/align_fused.cu, csrc/moment_flow_step.cu (pass 1) and
csrc/pair_stats.cu, the joint split of the suite's four pair sets
(plan_sets, csrc/ip_suite.cu) with its scratch, and the keep bitmask that
the per-pair kernels' pass 1 writes and pass 2 walks.

The kernels read the split as csrc/flow_step.cuh's make_split and item_of
do, which SplitPlan.item repeats; the card's runs (chip_smoke.py) hold the
kernels' bitmask against keep_bits_plain bit for bit."""

import numpy as np
import pytest
import torch

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import kernels
from cvo_slam_tpu_torch.ops import pairwise
from test_pairwise import make_clouds

TP = from_reference(CvoParams())
# rows per work item and columns per tile of csrc/flow_step.cuh
ROWS, COLS = 512, 32
# (N, M) pairs at the capacities the port runs, with N != M
SHAPES = [(1, 129), (129, 1), (129, 3000), (3000, 3072), (3072, 3000),
          (3072, 3072)]


def _covered(plan):
    """Every (row tile, column tile) of the plan's items, in item order."""
    seen = []
    for i in range(plan.items):
        rt, t0, t1 = plan.item(i)
        assert t0 < t1, f"item {i} is empty"
        seen += [(rt, t) for t in range(t0, t1)]
    return seen


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("resident", [1, 7, 660, 10 ** 6])
def test_plan_covers_every_tile_once(n, m, resident):
    plan = kernels.plan_split(n, m, resident, ROWS, COLS)
    assert plan.row_tiles == -(-n // ROWS) and plan.col_tiles == -(-m // COLS)
    seen = _covered(plan)
    assert len(seen) == len(set(seen)) == plan.row_tiles * plan.col_tiles
    assert set(seen) == {(r, t) for r in range(plan.row_tiles)
                         for t in range(plan.col_tiles)}
    # the check of make_split: no empty chunk, every tile covered
    assert (plan.chunks - 1) * plan.tiles_per_chunk < plan.col_tiles \
        <= plan.chunks * plan.tiles_per_chunk
    # the plan minimises waves x tiles per item, the finer split on a tie

    def cost(per):
        items = plan.row_tiles * -(-plan.col_tiles // per)
        return -(-items // resident) * per

    best = min(cost(per) for per in range(1, plan.col_tiles + 1))
    assert cost(plan.tiles_per_chunk) == best
    assert all(cost(per) > best for per in range(1, plan.tiles_per_chunk))
    if resident >= plan.row_tiles * plan.col_tiles:
        assert plan.chunks == plan.col_tiles
    assert plan.scratch() == dict(fpart=(6, plan.items),
                                  npart=(plan.items,),
                                  spart=(4, plan.items),
                                  bits=(-(-m // 32), n))


@pytest.mark.parametrize("n,m", [(1, 129), (129, 3000), (3000, 3072),
                                 (3072, 3000)])
def test_scratch_of_the_plan(n, m):
    """The wrapper's scratch: f32 flow and step partials, i32 counts and
    bitmask words, in the plan's shapes; a caller's bitmask is used as
    given, and mode 2 (no pass 1) takes none."""
    plan = kernels.plan_split(n, m, 660, ROWS, COLS)
    shapes = plan.scratch()
    bits, fpart, npart, spart = kernels._scratch(plan, torch.device("cpu"))
    for t, key, dtype in ((bits, "bits", torch.int32),
                          (fpart, "fpart", torch.float32),
                          (npart, "npart", torch.int32),
                          (spart, "spart", torch.float32)):
        assert t.dtype == dtype and tuple(t.shape) == shapes[key]
    given = torch.zeros(shapes["bits"], dtype=torch.int32)
    assert kernels._scratch(plan, torch.device("cpu"), given)[0] is given
    assert kernels._scratch(plan, torch.device("cpu"),
                            with_bits=False)[0] is None


@pytest.mark.parametrize("resident", [660, 528])
def test_plan_of_the_main_path(resident):
    """CAP 3072 on a card that holds 5 or 4 blocks of the kernel on each of
    132 SMs: 6 row tiles x 96 chunks of one tile, 576 work items (at 528
    resident, two waves of one tile cost as much as one wave of two, and
    the finer split wins the tie)."""
    plan = kernels.plan_split(3072, 3072, resident, ROWS, COLS)
    assert (plan.row_tiles, plan.chunks, plan.tiles_per_chunk,
            plan.items) == (6, 96, 1, 576)
    with pytest.raises(ValueError):
        kernels.plan_split(0, 3072, 660, ROWS, COLS)


@pytest.mark.parametrize("resident", [660, 528])
@pytest.mark.parametrize("kernel,rows,cols,items", [
    # the moment kernel's pass 1: rows the moving points, columns the
    # fixed ones (3000 fixed points against 3072 moving ones: 94 tiles)
    ("moment", 3072, 3000, (6, 94, 1, 564)),
    ("moment", 3072, 3072, (6, 96, 1, 576)),
    # pair stats: rows xa, columns xb, with and without moments
    ("pair_stats", 3000, 3000, (6, 94, 1, 564)),
    ("pair_stats", 3072, 3072, (6, 96, 1, 576)),
])
def test_plan_of_the_redesigned_kernels(kernel, rows, cols, items,
                                        resident):
    """The moment and pair-stats kernels at CAP 3072 (and 3000) on a card
    that holds 5 or 4 of their blocks on each of 132 SMs: one column tile
    per item, 576 work items at CAP 3072 where the first versions ran a
    24 x 8 grid."""
    plan = kernels.plan_split(rows, cols, resident, ROWS, COLS)
    assert (plan.row_tiles, plan.chunks, plan.tiles_per_chunk,
            plan.items) == items
    assert len(_covered(plan)) == plan.row_tiles * plan.col_tiles


# (fixed, moving) capacities of the suite, with N != M and odd sizes
SUITE_SHAPES = [(1, 1), (1, 129), (129, 1), (250, 129), (129, 3000),
                (3000, 2999), (3072, 3000), (3072, 3072)]


def _suite_plans(n, m, resident):
    return kernels.plan_sets(kernels.suite_shapes(n, m), resident, ROWS, COLS)


@pytest.mark.parametrize("n,m", SUITE_SHAPES)
@pytest.mark.parametrize("resident", [1, 7, 660, 10 ** 6])
def test_suite_plan_covers_every_tile_once(n, m, resident):
    """The suite's four pair sets, planned as one grid: each set's (row
    tile, column tile) pairs covered once, rows and columns as the kernel
    reads them (pre y x, post yt x, fixed x x, moving y y), one count of
    tiles per chunk for every set (at most the set's tiles), the least
    waves x tiles per item over all sets' items, the finer on a tie."""
    plans = _suite_plans(n, m, resident)
    assert [(q.n, q.m) for q in plans] == [(m, n), (m, n), (n, n), (m, m)]
    for q in plans:
        assert q.row_tiles == -(-q.n // ROWS)
        assert q.col_tiles == -(-q.m // COLS)
        seen = _covered(q)
        assert len(seen) == len(set(seen)) == q.row_tiles * q.col_tiles
        assert (q.chunks - 1) * q.tiles_per_chunk < q.col_tiles \
            <= q.chunks * q.tiles_per_chunk
    per = max(q.tiles_per_chunk for q in plans)
    assert all(q.tiles_per_chunk == min(per, q.col_tiles) for q in plans)

    def cost(k):
        items = sum(q.row_tiles * -(-q.col_tiles // k) for q in plans)
        return -(-items // resident) * k

    best = min(cost(k) for k in range(1, max(q.col_tiles for q in plans) + 1))
    assert cost(per) == best
    assert all(cost(k) > best for k in range(1, per))


@pytest.mark.parametrize("n,m", [(1, 1), (129, 3000), (3000, 2999),
                                 (3072, 3072)])
@pytest.mark.parametrize("resident", [660, 528])
def test_suite_scratch_of_the_plan(n, m, resident):
    """The suite's scratch follows from its plans: per set its items'
    partials (170 floats for post, one for the others) and counts, its
    level-1 groups of ~sqrt(items) items, each set's partials right after
    the one before (the offsets the kernel is given), and out_n's four
    counts, the four sets' tile pairs computed, the level-2 ticket and one
    level-1 ticket per group."""
    plans = _suite_plans(n, m, resident)
    items = [q.items for q in plans]
    groups = [-(-i // kernels.finalize_group(i)) for i in items]
    nf = (1, 170, 1, 1)
    sizes = [(i * f, i, g * f, g) for i, g, f in zip(items, groups, nf)]
    shapes, offsets = kernels.suite_scratch(plans)
    assert shapes == dict(
        fpart=(sum(i * f for i, f in zip(items, nf)),),
        npart=(sum(items),),
        gpart=(sum(g * f for g, f in zip(groups, nf)),),
        gnpart=(sum(groups),),
        out_f=(173,),
        out_n=(4 + 4 + 1 + sum(groups),))
    assert offsets[0] == (0, 0, 0, 0)
    for s in range(1, 4):
        assert offsets[s] == tuple(o + k for o, k in zip(offsets[s - 1],
                                                         sizes[s - 1]))
    assert tuple(o + k for o, k in zip(offsets[3], sizes[3])) == tuple(
        shapes[k][0] for k in ("fpart", "npart", "gpart", "gnpart"))
    for i, g in zip(items, groups):
        group = kernels.finalize_group(i)
        assert (g - 1) * group < i <= g * group
        assert (group - 1) ** 2 < i <= group ** 2


@pytest.mark.parametrize("resident", [660, 528])
@pytest.mark.parametrize("cap,items", [(3072, (6, 96, 1, 576)),
                                       (3000, (6, 94, 1, 564))])
def test_plan_of_the_suite(cap, items, resident):
    """The suite at CAP 3072 (and 3000) on a card that holds 5 or 4 of its
    blocks on each of 132 SMs: every set one column tile per item, 4 x 576
    = 2304 work items in one launch at CAP 3072, where the first version
    ran a 24 x 8 grid and two more launches."""
    plans = _suite_plans(cap, cap, resident)
    assert all((q.row_tiles, q.chunks, q.tiles_per_chunk, q.items) == items
               for q in plans)
    assert sum(q.items for q in plans) == 4 * items[3]
    with pytest.raises(ValueError):
        kernels.plan_sets(kernels.suite_shapes(0, cap), resident, ROWS, COLS)
    with pytest.raises(ValueError):
        kernels.plan_sets((), resident, ROWS, COLS)


@pytest.mark.parametrize("n,m", SHAPES)
def test_plan_split_is_one_set(n, m):
    """pair stats' and the per-pair kernels' split is plan_sets of one set:
    the suite's rule, applied to one grid."""
    for resident in (1, 660):
        assert kernels.plan_split(n, m, resident, ROWS, COLS) \
            == kernels.plan_sets(((n, m),), resident, ROWS, COLS)[0]


@pytest.mark.parametrize("m", [1, 31, 32, 33, 129, 3000])
def test_keep_bits_layout(m):
    rng = np.random.default_rng(m)
    n = 37
    keep = torch.as_tensor(rng.random((n, m)) < 0.3)
    bits = kernels.pack_keep_bits(keep)
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (-(-m // 32), n)
    assert torch.equal(kernels.unpack_keep_bits(bits, m), keep)
    words = bits.numpy().astype(np.int64) & 0xFFFFFFFF
    for i, j in zip(rng.integers(0, n, 50), rng.integers(0, m, 50)):
        assert (words[j // 32, i] >> (j % 32)) & 1 == int(keep[i, j])
    # the bits past column m are zero
    tail = -(-m // 32) * 32 - m
    if tail:
        assert not (words[-1] >> (32 - tail)).any()


@pytest.mark.parametrize("cap,n,m,ell", [(256, 230, 210, 0.15),
                                          (129, 129, 100, 0.06),
                                          (300, 250, 300, 0.1)])
def test_keep_bits_plain_is_cvo_kernel_keep(cap, n, m, ell):
    x, fx, mx, y, fy, my = [torch.as_tensor(a) for a in
                            make_clouds(5, n, m, cap=cap)]
    bits = kernels.keep_bits_plain(x, y, fx, fy, mx, my, ell, TP)
    _, keep = pairwise.cvo_kernel(x, y, fx, fy, mx, my, torch.tensor(ell),
                                  TP)
    assert keep.any()
    assert torch.equal(kernels.unpack_keep_bits(bits, cap), keep)
    # the bitmask's count is the flow pass's nnz
    _, _, nnz = kernels.flow_plain(x, y, fx, fy, mx, my, ell, TP)
    unpacked = kernels.unpack_keep_bits(bits, cap)
    assert int(unpacked.sum()) == int(nnz)
