"""Port parity, tile skipping: kernels.tile_flags_plain (the test the CUDA
gate sweeps run, csrc/flow_step.cuh's box_live) against the JAX package's
skip flags (pallas_kernels._skip_flags, pallas_align._skip_flags_margin) at
the Pallas kernels' tiles (128 x 128; pair stats' 256 x 128; the suite's
four sets), and at the port's own tile shapes with the kernels' slack: no
pair that the per-pair gate (ops/pairwise.cvo_kernel), the moment form's
gate or pair stats' gates (ops/pairwise.pair_stats, every set of the
suite) keep lies in a skipped tile pair (CPU)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import pallas_align as jpa
from cvo_slam_tpu.cvo import pallas_kernels as jpk
from cvo_slam_tpu.ops import se3 as jse3
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import kernels
from cvo_slam_tpu_torch.ops import pairwise
from test_pallas import _morton_clouds

torch.set_num_threads(2)
P = CvoParams()
TP = from_reference(P)
ROWS, COLS = 512, 32    # a work item's rows and a column tile (flow_step.cuh)
CASES = [(seed, ell) for seed in (11, 13) for ell in (0.15, 0.10, 0.05)]


def _clouds(seed):
    """tests/test_pallas.py's Morton-ordered clusters (CAP 1024, the last 17
    points masked): the JAX arrays and the port's tensors."""
    arrays = _morton_clouds(seed)
    return arrays, [torch.as_tensor(np.array(a)) for a in arrays]


def _post_rows(y):
    """The suite's post rows: y under tests/test_pallas.py:197's small se3
    step (JAX array), as the JAX suite takes them."""
    tran = jse3.exp_se3(jnp.asarray(
        np.array([0.01, 0.02, -0.01, 0.03, -0.02, 0.01], np.float32)))
    return jse3.transform_points(tran, y)


def _suite_sets(x, mx, y, my, yt):
    """The suite's four pair sets (pre, post, fixed, moving) as (rows, row
    mask, columns, column mask), in the order of pallas_kernels.py:782-787
    and kernels.SUITE_SETS."""
    return ((y, my, x, mx), (yt, my, x, mx), (x, mx, x, mx), (y, my, y, my))


@pytest.mark.parametrize("seed,ell", CASES)
def test_flags_match_jax(seed, ell):
    """At 128 x 128 tiles the port's flags equal the JAX package's flag for
    flag: without a margin (_skip_flags, the per-pair and moment kernels)
    and with align_fused's skip_margin (_skip_flags_margin); some tile
    pairs are skipped and some computed in each."""
    (x, fx, mx, y, fy, my), (tx, _, tmx, ty, _, tmy) = _clouds(seed)
    want = np.asarray(jpk._skip_flags(x, mx, y, my, jnp.float32(ell), 128,
                                      P)).reshape(8, 8)
    got = kernels.tile_flags_plain(tx, tmx, ty, tmy, ell, 128, 128, TP)
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    assert 0 < int(got.sum()) < got.numel()
    margin = jnp.float32(P.skip_margin)
    want = np.asarray(jpa._skip_flags_margin(x, mx, y, my, jnp.float32(ell),
                                             128, margin, P)).reshape(8, 8)
    got = kernels.tile_flags_plain(tx, tmx, ty, tmy, ell, 128, 128, TP,
                                   margin=P.skip_margin)
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    assert 0 < int(got.sum()) < got.numel()
    # pair stats (pallas_kernels.py:394): 256-row strips, 128-column tiles
    want = np.asarray(jpk._skip_flags(x, mx, y, my, jnp.float32(ell), 256,
                                      P, tile_b=128)).reshape(4, 8)
    got = kernels.tile_flags_plain(tx, tmx, ty, tmy, ell, 256, 128, TP)
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    assert 0 < int(got.sum()) < got.numel()
    # the suite's four sets at 128 x 128, the post rows under a small step
    yt = _post_rows(y)
    ty_t = torch.as_tensor(np.array(yt))
    for (a, ma, b, mb), (ta, tma, tb, tmb) in zip(
            _suite_sets(x, mx, y, my, yt),
            _suite_sets(tx, tmx, ty, tmy, ty_t)):
        want = np.asarray(jpk._skip_flags(a, ma, b, mb, jnp.float32(ell),
                                          128, P)).reshape(8, 8)
        got = kernels.tile_flags_plain(ta, tma, tb, tmb, ell, 128, 128, TP)
        np.testing.assert_array_equal(got.numpy(), want.astype(bool))
        assert 0 < int(got.sum()) < got.numel()


def _covered(keep, flags, rows, cols):
    """Whether every kept pair (N, M) lies in a computed tile pair."""
    n, m = keep.shape
    live = flags.repeat_interleave(rows, 0)[:n].repeat_interleave(cols, 1)
    return not bool((keep & ~live[:, :m]).any())


@pytest.mark.parametrize("seed,ell", CASES)
def test_kernel_tiles_hold_every_kept_pair(seed, ell):
    """At the kernels' tiles (ROWS rows x COLS columns) with their slack,
    every pair kept by the per-pair gate (rows: the fixed cloud) and by the
    moment form's gate (rows: the moving cloud) lies in a computed tile
    pair, at least one tile pair is skipped, and the slack computes every
    pair the flags without it compute."""
    _, (x, fx, mx, y, fy, my) = _clouds(seed)
    e = torch.tensor(ell)
    _, keep = pairwise.cvo_kernel(x, y, fx, fy, mx, my, e, TP)
    flags = kernels.tile_flags_plain(x, mx, y, my, e, ROWS, COLS, TP,
                                     slack=True)
    assert int(keep.sum()) > 0
    assert _covered(keep, flags, ROWS, COLS)
    assert 0 < int(flags.sum()) < flags.numel()
    exact = kernels.tile_flags_plain(x, mx, y, my, e, ROWS, COLS, TP)
    assert not bool((exact & ~flags).any())
    # the moment kernel: rows the moving points, columns the fixed points
    mkeep = kernels.unpack_keep_bits(
        kernels.moment_keep_bits_plain(x, y, fx, fy, mx, my, e, TP),
        x.shape[0])
    mflags = kernels.tile_flags_plain(y, my, x, mx, e, ROWS, COLS, TP,
                                      slack=True)
    assert int(mkeep.sum()) > 0
    assert _covered(mkeep, mflags, ROWS, COLS)
    assert 0 < int(mflags.sum()) < mflags.numel()


def _stats_gate(xa, fa, ma, xb, fb, mb, ell):
    """The pairs pair stats counts (ops/pairwise.pair_stats's gates: the
    geometric and colour gates, both masks)."""
    cdot = pairwise.pair_dots(fa, fb)
    d2c = torch.clamp(pairwise.sq_norms(fa)[:, None]
                      + pairwise.sq_norms(fb)[None, :] - 2.0 * cdot, min=0.0)
    d2 = pairwise.pairwise_sq_dists(xa, xb)
    return (d2 < pairwise.d2_threshold(ell, TP)) \
        & (d2c < pairwise.d2_color_threshold(TP)) & ma[:, None] & mb[None, :]


@pytest.mark.parametrize("seed,ell", CASES)
def test_pair_stats_tiles_hold_every_gated_pair(seed, ell):
    """At the kernels' tiles with their slack, for each of the suite's four
    pair sets (pair stats' sweep, csrc/pair_stats.cuh): every pair that
    pair stats' gates pass lies in a computed tile pair, and at least one
    tile pair is skipped."""
    (_, _, _, y, _, _), (x, fx, mx, ty, fy, my) = _clouds(seed)
    yt = torch.as_tensor(np.array(_post_rows(y)))
    e = torch.tensor(ell)
    for rows, fr, mr, cols, fc, mc in (
            (ty, fy, my, x, fx, mx), (yt, fy, my, x, fx, mx),
            (x, fx, mx, x, fx, mx), (ty, fy, my, ty, fy, my)):
        gate = _stats_gate(rows, fr, mr, cols, fc, mc, e)
        flags = kernels.tile_flags_plain(rows, mr, cols, mc, e, ROWS, COLS,
                                         TP, slack=True)
        assert int(gate.sum()) > 0
        assert _covered(gate, flags, ROWS, COLS)
        assert 0 < int(flags.sum()) < flags.numel()


def test_masked_points_leave_no_box():
    """Masked points (test_pallas.py's clouds park them at 55 m) take no
    part in a box: a tile of masked points is skipped against every tile,
    and moving the masked points changes no flag."""
    _, (x, _, mx, y, _, my) = _clouds(11)
    flags = kernels.tile_flags_plain(x, mx, y, my, 0.15, 128, 128, TP,
                                     slack=True)
    moved = torch.where(my[:, None], y, torch.full_like(y, -3.0))
    assert torch.equal(flags, kernels.tile_flags_plain(
        x, mx, moved, my, 0.15, 128, 128, TP, slack=True))
    empty = torch.zeros_like(my)
    assert not bool(kernels.tile_flags_plain(
        x, mx, y, empty, 0.15, 128, 128, TP, slack=True).any())


# -- on the card -------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check")


def _skip_and_full(run):
    """run(tile_skip) -> (outputs, launch_info), skipping and not: the
    outputs bitwise equal; returns both tile counts and the skipping
    launch's info."""
    got, info = run(True)
    want, full = run(False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return int(info["tiles"].sum()), int(full["tiles"].sum()), info


@pytest.mark.gpu
@pytest.mark.parametrize("multi_tile", [False, True])
@pytest.mark.parametrize("seed,ell", [(11, 0.15), (13, 0.05)])
def test_cuda_skipping_is_exact(seed, ell, multi_tile, monkeypatch):
    """On a card, on the Morton clouds: the moment kernel, flow_and_step,
    flow, step_coeffs and align_fused skip tile pairs (at least one) and
    give the outputs and keep bitmasks of their tile_skip=False launches bit
    for bit; the per-pair kernels' and the moment kernel's counts of
    computed tile pairs equal tile_flags_plain's. multi_tile: every column
    tile of a row tile in one work item (the double-buffered staging)."""
    import dataclasses
    _need_card()
    _, cpu = _clouds(seed)
    x, fx, mx, y, fy, my = [t.cuda() for t in cpu]
    e = torch.tensor(ell, device="cuda")
    args = (x, y, fx, fy, mx, my)
    if multi_tile:
        plan_for = kernels._plan_for

        def one_item_per_row_tile(*a):
            plan, per_sm, sms = plan_for(*a)
            return dataclasses.replace(plan, chunks=1, tiles_per_chunk=(
                plan.col_tiles)), per_sm, sms
        monkeypatch.setattr(kernels, "_plan_for", one_item_per_row_tile)
    center, U = pairwise.step_moment_basis(x, mx)
    U = U.contiguous()
    words = (-(-x.shape[0] // 32), y.shape[0])

    def moment(skip):
        info, bits = {}, torch.empty(words, dtype=torch.int32, device="cuda")
        out = kernels.moment_pass_cuda(*args, U, e, TP, keep_bits=bits,
                                       launch_info=info, tile_skip=skip)
        return out + (bits,), info

    def both(skip):
        info, bits = {}, torch.empty(words, dtype=torch.int32, device="cuda")
        out = kernels.flow_and_step_cuda(*args, e, TP, keep_bits=bits,
                                         launch_info=info, tile_skip=skip)
        return out + (bits,), info

    omega, v, _ = kernels.flow_plain(*args, e, TP)

    def flow(skip):
        info = {}
        return kernels.flow_cuda(*args, e, TP, launch_info=info,
                                 tile_skip=skip), info

    def step(skip):
        info = {}
        return kernels.step_coeffs_cuda(*args, omega, v, e, TP,
                                        launch_info=info,
                                        tile_skip=skip), info

    rows_x = int(kernels.tile_flags_plain(x, mx, y, my, e, ROWS, COLS, TP,
                                          slack=True).sum())
    rows_y = int(kernels.tile_flags_plain(y, my, x, mx, e, ROWS, COLS, TP,
                                          slack=True).sum())
    for run, plain in ((moment, rows_y), (both, rows_x), (flow, rows_x),
                       (step, rows_x)):
        tiles, full, info = _skip_and_full(run)
        assert tiles == plain < full == info["tile_pairs"]

    def align(skip):
        info = {}
        out = kernels.align_fused_cuda(
            x, fx, mx, y, fy, my, torch.eye(3, device="cuda"),
            torch.zeros(3, device="cuda"), e, TP, launch_info=info,
            tile_skip=skip)
        return out, info
    tiles, full, info = _skip_and_full(align)
    assert tiles < full


@pytest.mark.gpu
@pytest.mark.parametrize("seed,ell", [(11, 0.15), (13, 0.05)])
def test_cuda_pair_stats_skipping_is_exact(seed, ell):
    """On a card, on the Morton clouds: pair stats (both modes), the suite
    (1 and 4 lanes) and pair stats' lanes skip tile pairs and give the
    outputs of their tile_skip=False launches bit for bit, each set's count
    of computed tile pairs equal to tile_flags_plain's; every lane equals
    its solo launch bit for bit."""
    _need_card()
    (_, _, _, y, _, _), cpu = _clouds(seed)
    x, fx, mx, ty, fy, my = [t.cuda() for t in cpu]
    yt = torch.as_tensor(np.array(_post_rows(y))).cuda()
    e = torch.tensor(ell, device="cuda")

    def flags(rows, mr, cols, mc, ell_l=e):
        return int(kernels.tile_flags_plain(rows, mr, cols, mc, ell_l, ROWS,
                                            COLS, TP, slack=True).sum())

    for mom in (False, True):
        def stats(skip):
            info = {}
            return kernels.pair_stats_cuda(yt, fy, my, x, fx, mx, e, TP, mom,
                                           launch_info=info,
                                           tile_skip=skip), info
        tiles, full, info = _skip_and_full(stats)
        assert tiles == flags(yt, my, x, mx) < full == info["tile_pairs"]

    def suite(skip):
        info = {}
        return kernels.ip_suite_cuda(x, fx, mx, ty, fy, my, yt, e, TP,
                                     launch_info=info, tile_skip=skip), info
    got, info = suite(True)
    want, full = suite(False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    sets = [flags(*s) for s in _suite_sets(x, mx, ty, my, yt)]
    assert info["tiles"].tolist() == sets
    assert full["tiles"].tolist() == list(full["tile_pairs"])
    assert sum(sets) < sum(full["tile_pairs"])

    # 4 lanes: moving clouds ty, yt, ty, yt; post rows each lane's own step
    S = 4
    movs = [ty, yt, ty, yt]
    posts = [yt, ty, yt, ty]
    ells = torch.tensor([ell, 0.1, ell, 0.06], device="cuda")
    mv = [kernels.stack_lanes(t) for t in (movs, [fy] * S, [my] * S)]
    post = kernels.stack_lanes(posts)
    solos = [kernels.ip_suite_cuda(x, fx, mx, movs[l], fy, my, posts[l],
                                   ells[l], TP) for l in range(S)]
    lanes = {}
    for skip in (True, False):
        info = {}
        lanes[skip] = (kernels.ip_suite_lanes_cuda(
            x, fx, mx, *mv, post, ells, TP, launch_info=info,
            tile_skip=skip), info)
    for l in range(S):
        for g, w, s in zip(lanes[True][0], lanes[False][0], solos[l]):
            assert torch.equal(g[l], w[l]) and torch.equal(g[l], s)
        assert lanes[True][1]["tiles"][l].tolist() == [
            flags(*q, ells[l]) for q in _suite_sets(x, mx, movs[l], my,
                                                    posts[l])]

    # pair stats' lanes: rows each lane's post, columns shared and stacked
    for mom in (False, True):
        for cols in ((x, fx, mx), mv):
            runs = {}
            for skip in (True, False):
                info = {}
                runs[skip] = (kernels.pair_stats_lanes_cuda(
                    post, mv[1], mv[2], *cols, ells, TP, mom,
                    launch_info=info, tile_skip=skip), info)
            for l in range(S):
                c = [t if t.dim() == (1 if t.dtype == torch.bool else 2)
                     else t[l] for t in cols]
                solo = kernels.pair_stats_cuda(posts[l], fy, my, *c,
                                               ells[l], TP, mom)
                for g, w, s in zip(runs[True][0], runs[False][0], solo):
                    assert torch.equal(g[l], w[l]) and torch.equal(g[l], s)
                assert int(runs[True][1]["tiles"][l]) == flags(
                    posts[l], my, c[0], c[2], ells[l])
