"""Port parity, tile skipping: kernels.tile_flags_plain (the test the CUDA
gate sweeps run, csrc/flow_step.cuh's box_live) against the JAX package's
skip flags (pallas_kernels._skip_flags, pallas_align._skip_flags_margin) at
the Pallas kernels' 128 x 128 tiles, and at the port's own tile shapes with
the kernels' slack: no pair that the per-pair gate (ops/pairwise.cvo_kernel)
or the moment form's gate keeps lies in a skipped tile pair (CPU)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import pallas_align as jpa
from cvo_slam_tpu.cvo import pallas_kernels as jpk
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
