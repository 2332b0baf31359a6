"""Port parity, kernel layer: the plain versions of the CUDA kernels
(cvo_slam_tpu_torch.cvo.kernels) against the JAX package's Pallas kernels
(interpret mode) and their XLA twins, on the same numpy clouds (CPU).

The CUDA kernels themselves run only on the card: the test that launches
them skips here, and chip_smoke.py holds each against its plain version at
the main path's shapes."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import pallas_kernels as pk
from cvo_slam_tpu.ops import pairwise as jpw
from cvo_slam_tpu.ops import se3 as jse3
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import kernels
from cvo_slam_tpu_torch.ops import pairwise as tpw
from tests.test_pairwise import make_clouds

torch.set_num_threads(2)
P = CvoParams()
TP = from_reference(P)
NAMES = ("omega", "v", "nnz", "B", "C", "D", "E")


def _pad_to(arrays, cap):
    """Pad (x, fx, mx, y, fy, my) to a Pallas-tileable capacity with masked
    slots (the JAX kernels need a multiple of 128)."""
    out = []
    for a in arrays:
        pad = [(0, cap - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, pad))
    return out


def _clouds(seed, cap, n, m):
    x, fx, mx, y, fy, my = make_clouds(seed, n, m, cap=cap)
    return x, fx, mx, y, fy, my


def _moment_refs(arrays, ell):
    """(JAX XLA moment path, JAX Pallas moment kernel) outputs."""
    x, fx, mx, y, fy, my = [jnp.asarray(a) for a in arrays]
    ck = jpw.color_kernel_gated(fx, fy, mx, my, P)
    center, U = jpw.step_moment_basis(x, mx)
    xla = jpw.flow_and_step_moments(x, y, ck, U, center, jnp.float32(ell), P)
    with pltpu.force_tpu_interpret_mode():
        c2, Upack = pk.pack_moment_basis(x, mx)
        pallas = pk.moment_flow_step(x, y, fx, fy, mx, my, Upack, c2,
                                     jnp.float32(ell), P)
    return xla, pallas


def _port_moment(arrays, ell):
    x, fx, mx, y, fy, my = [torch.as_tensor(a) for a in arrays]
    center, U = tpw.step_moment_basis(x, mx)
    return kernels.moment_flow_step(x, y, fx, fy, mx, my, U.contiguous(),
                                    center, ell, TP)


def _assert_moment(got, want):
    for name, g, r in zip(NAMES, got, want):
        if name == "nnz":
            assert int(g) == int(r), (int(g), int(r))
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                       rtol=2e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_moment_flow_step_parity(ell):
    arrays = _clouds(4, 256, 200, 180)
    xla, pallas = _moment_refs(arrays, ell)
    got = _port_moment(arrays, ell)
    _assert_moment(got, pallas)
    _assert_moment(got, xla)


@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_moment_flow_step_odd_capacity(ell):
    """Capacity 250 (not a multiple of 128) with a masked tail: the port
    takes it as is; the JAX kernel sees the same clouds padded to 256."""
    arrays = _clouds(11, 250, 230, 210)
    xla, pallas = _moment_refs(_pad_to(arrays, 256), ell)
    got = _port_moment(arrays, ell)
    _assert_moment(got, pallas)
    _assert_moment(got, xla)


def test_moment_pass_masked_slots_contribute_zero():
    """Changing what sits in masked slots changes nothing."""
    x, fx, mx, y, fy, my = _clouds(2, 256, 150, 140)
    a = _port_moment((x, fx, mx, y, fy, my), 0.1)
    x2, y2 = x.copy(), y.copy()
    x2[~mx] = 0.01
    y2[~my] = 0.02
    b = _port_moment((x2, fx, mx, y2, fy, my), 0.1)
    for g, r in zip(a, b):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def _suite_inputs(seed, cap, n, m):
    arrays = _clouds(seed, cap, n, m)
    tran = jse3.exp_se3(jnp.asarray(
        np.array([0.02, -0.01, 0.03, 0.05, 0.02, -0.04], np.float32)))
    yt = np.array(jse3.transform_points(tran, jnp.asarray(arrays[3])))
    return arrays, yt


def _suite_refs(arrays, yt, ell):
    x, fx, mx, y, fy, my = [jnp.asarray(a) for a in arrays]
    xla = jpw.ip_suite(x, fx, mx, y, fy, my, jnp.asarray(yt),
                       jnp.float32(ell), P)
    with pltpu.force_tpu_interpret_mode():
        pallas = pk.ip_suite(x, fx, mx, y, fy, my, jnp.asarray(yt),
                             jnp.float32(ell), P)
    return xla, pallas


def _assert_suite(got, want):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    for k in (0, 2, 4, 6):                       # the four sums
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    for k in (1, 3, 5, 7, 9):                    # counts and inliers
        assert int(got[k]) == int(want[k]), (k, got[k], want[k])
    scale = max(np.abs(want[8]).max(), 1.0)
    np.testing.assert_allclose(got[8] / scale, want[8] / scale, atol=1e-5)


@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_ip_suite_parity(ell):
    arrays, yt = _suite_inputs(9, 256, 200, 180)
    xla, pallas = _suite_refs(arrays, yt, ell)
    got = kernels.ip_suite(*[torch.as_tensor(a) for a in arrays],
                           torch.as_tensor(yt), ell, TP)
    _assert_suite(got, pallas)
    _assert_suite(got, xla)


def test_ip_suite_odd_capacity():
    arrays, yt = _suite_inputs(13, 250, 240, 190)
    xla, pallas = _suite_refs(_pad_to(arrays, 256),
                              np.pad(yt, ((0, 6), (0, 0))), 0.15)
    got = kernels.ip_suite(*[torch.as_tensor(a) for a in arrays],
                           torch.as_tensor(yt), 0.15, TP)
    _assert_suite(got, pallas)
    _assert_suite(got, xla)


def _stats_refs(arrays, ell, with_moments):
    """The Pallas pair_stats kernel (interpret mode) on rows y, columns x."""
    x, fx, mx, y, fy, my = [jnp.asarray(a) for a in arrays]
    with pltpu.force_tpu_interpret_mode():
        return pk.pair_stats(y, fy, my, x, fx, mx, jnp.float32(ell), P,
                             with_moments=with_moments)


def _port_stats(arrays, ell, with_moments):
    x, fx, mx, y, fy, my = [torch.as_tensor(a) for a in arrays]
    return kernels.pair_stats(y, fy, my, x, fx, mx, ell, TP, with_moments)


def _assert_stats(got, want, ell):
    """tests/test_pallas.py's bars: count exact, value rtol 1e-4, G / scale
    atol 1e-5, the assembled H / scale atol 1e-4."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert float(got[1]) == float(want[1]), (got[1], want[1])
    if len(want) == 2:
        return
    assert int(got[3]) == int(want[3]), (got[3], want[3])
    scale = max(np.abs(want[2]).max(), 1.0)
    np.testing.assert_allclose(got[2] / scale, want[2] / scale, atol=1e-5)
    H_g = tpw.assemble_hessian(torch.as_tensor(got[2]),
                               torch.tensor(np.float32(ell))).numpy()
    H_w = np.asarray(jpw.assemble_hessian(jnp.asarray(want[2]),
                                          jnp.float32(ell)))
    h_scale = max(np.abs(H_w).max(), 1.0)
    np.testing.assert_allclose(H_g / h_scale, H_w / h_scale, atol=1e-4)


@pytest.mark.parametrize("with_moments", [False, True])
@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_pair_stats_parity(ell, with_moments):
    """pair_stats_plain against the Pallas pair_stats kernel at CAP 256."""
    arrays = _clouds(17, 256, 220, 200)
    want = _stats_refs(arrays, ell, with_moments)
    got = _port_stats(arrays, ell, with_moments)
    assert int(got[1]) > 40     # the gates pass real pairs at both ell
    _assert_stats(got, want, ell)


@pytest.mark.parametrize("with_moments", [False, True])
def test_pair_stats_odd_capacity(with_moments):
    """CAP 250 with a masked tail; the Pallas side pads to 256 as
    engine._pad128 does."""
    arrays = _clouds(19, 250, 235, 205)
    want = _stats_refs(_pad_to(arrays, 256), 0.1, with_moments)
    got = _port_stats(arrays, 0.1, with_moments)
    _assert_stats(got, want, 0.1)


def test_pair_stats_views_match_xla():
    """inner_product / se3_hessian_raw (views of pair_stats) against the
    JAX package's XLA functions on the same pair."""
    arrays = _clouds(23, 256, 210, 190)
    x, fx, mx, y, fy, my = [jnp.asarray(a) for a in arrays]
    tx, tfx, tmx, ty, tfy, tmy = [torch.as_tensor(a) for a in arrays]
    ell = np.float32(0.1)
    v_w, n_w = jpw.inner_product(y, fy, my, x, fx, mx, jnp.float32(ell), P)
    v_g, n_g = tpw.inner_product(ty, tfy, tmy, tx, tfx, tmx,
                                 torch.tensor(ell), TP)
    np.testing.assert_allclose(float(v_g), float(v_w), rtol=1e-4)
    assert float(n_g) == float(n_w)
    H_w, i_w = jpw.se3_hessian_raw(y, fy, my, x, fx, mx, jnp.float32(ell), P)
    H_g, i_g = tpw.se3_hessian_raw(ty, tfy, tmy, tx, tfx, tmx,
                                   torch.tensor(ell), TP)
    assert int(i_g) == int(i_w)
    scale = np.abs(np.asarray(H_w)).max()
    np.testing.assert_allclose(H_g.numpy() / scale, np.asarray(H_w) / scale,
                               atol=1e-4)


def test_wrappers_reject_bad_inputs():
    """A CUDA launch validates shapes, dtypes and devices before any build:
    a wrong cloud raises instead of launching."""
    x, fx, mx, y, fy, my = [torch.as_tensor(a)
                            for a in _clouds(1, 256, 100, 100)]
    center, U = tpw.step_moment_basis(x, mx)
    with pytest.raises(ValueError):
        kernels.moment_pass_cuda(x, y, fx, fy, mx, my, U[:, :34], 0.1, TP)
    with pytest.raises(ValueError):
        kernels.ip_suite_cuda(x, fx, mx.float(), y, fy, my, y, 0.1, TP)
    with pytest.raises(ValueError):
        kernels.moment_pass(x.to("meta"), y, fx, fy, mx, my, U, 0.1, TP)
    with pytest.raises(ValueError):
        kernels.pair_stats_cuda(y, fy, my, x[:, :2], fx, mx, 0.1, TP)
    with pytest.raises(ValueError):
        kernels.pair_stats(y.to("meta"), fy, my, x, fx, mx, 0.1, TP)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check")


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """On a card: the moment and suite kernels against their plain versions
    (CAP 250)."""
    _need_card()
    arrays, yt = _suite_inputs(13, 250, 240, 190)
    x, fx, mx, y, fy, my = [torch.as_tensor(a).cuda() for a in arrays]
    center, U = tpw.step_moment_basis(x, mx)
    U = U.contiguous()
    for ell in (0.15, 0.06):
        got = kernels.moment_flow_step(x, y, fx, fy, mx, my, U, center,
                                       ell, TP)
        want = kernels.moment_flow_step_plain(x, y, fx, fy, mx, my, U,
                                              center, ell, TP)
        _assert_moment([g.cpu() for g in got], [w.cpu() for w in want])
        ytc = torch.as_tensor(yt).cuda()
        got = kernels.ip_suite(x, fx, mx, y, fy, my, ytc, ell, TP)
        want = kernels.ip_suite_plain(x, fx, mx, y, fy, my, ytc, ell, TP)
        _assert_suite([g.cpu() for g in got], [w.cpu() for w in want])


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [256, 250])
def test_pair_stats_cuda_matches_plain(cap):
    """On a card: the pair-stats kernel against its plain version, with
    and without moments, at both ells, with the CPU parity bars."""
    _need_card()
    arrays, yt = _suite_inputs(29, cap, 230, 200)
    x, fx, mx, _, fy, my = [torch.as_tensor(a).cuda() for a in arrays]
    ytc = torch.as_tensor(yt).cuda()
    for ell in (0.15, 0.06):
        for with_moments in (False, True):
            got = kernels.pair_stats(ytc, fy, my, x, fx, mx, ell, TP,
                                     with_moments)
            want = kernels.pair_stats_plain(ytc, fy, my, x, fx, mx, ell, TP,
                                            with_moments)
            _assert_stats([g.cpu() for g in got], [w.cpu() for w in want],
                          ell)
