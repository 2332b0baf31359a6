"""Port parity, kernel layer: the plain versions of the two CUDA kernels
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


def test_cuda_kernels_match_plain():
    """On a card: both kernels against their plain versions (CAP 250)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check")
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
