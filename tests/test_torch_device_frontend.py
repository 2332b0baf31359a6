"""Port parity, the device frontend: cvo_slam_tpu_torch.frontend.device
(on the CPU) against the port's host frontend and the JAX package's device
frontend on tests/test_device_frontend.py's 640x480 frame and
tests/test_eth3d_shapes.py's ragged ETH3D-shaped frame, at those files'
bars: pyramid atol 1e-4 (absgrad rtol 1e-5 / atol 1e-3), thresholds atol
1e-4, selection status and counts exact, the cloud's count and pixel set
exact, positions rtol 1e-5 / atol 1e-6, features rtol 1e-4 / atol 1e-3,
HSV one 8-bit quantum on H and S.
"""

import numpy as np
import pytest
import torch

from cvo_slam_tpu.frontend import device as jdev
from cvo_slam_tpu_torch.config import CAMERA_PRESETS, FrontendParams, \
    from_reference
from cvo_slam_tpu_torch.frontend import device as tdev
from cvo_slam_tpu_torch.frontend import pyramid as host_pyr
from cvo_slam_tpu_torch.frontend import selector as host_sel
from cvo_slam_tpu_torch.frontend.pointcloud import create_pointcloud
from test_device_frontend import _frame
from test_eth3d_shapes import ETH_CAM_SMALL, ETH_FP
from test_eth3d_shapes import _frame as _eth_frame

torch.set_num_threads(2)
CAM = CAMERA_PRESETS["TUM1"]


@pytest.fixture(scope="module")
def frame():
    return _frame()


@pytest.fixture(scope="module")
def host_levels(frame):
    _, gray, _ = frame
    return host_pyr.make_pyramid(gray.astype(np.float32), 3)


def _dev_pyramid(gray):
    return tdev.make_pyramid(torch.as_tensor(gray.astype(np.float32)), 3)


def test_pyramid_matches_host_and_jax(frame, host_levels):
    _, gray, _ = frame
    di, _, _, dag = _dev_pyramid(gray)
    ji, _, _, jag = jdev.make_pyramid(gray.astype(np.float32), 3)
    for want_i, want_ag in ((host_levels[0], host_levels[3]), (ji, jag)):
        for a, b in zip(want_i, di):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
        for a, b in zip(want_ag, dag):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-3)


def test_hists_and_select_match_host_and_jax(host_levels):
    _, hdx, hdy, hag = host_levels
    ths_h = host_sel.make_hists(hag[0])
    ag = [torch.as_tensor(a) for a in hag]
    np.testing.assert_allclose(tdev.make_hists(ag[0]).numpy(), ths_h,
                               atol=1e-4)
    for pot in (2, 3, 5):
        st_h, counts_h = host_sel.select(hag, hdx[0], hdy[0], ths_h, pot)
        st_d, counts_d = tdev.select(*ag, torch.as_tensor(ths_h), pot)
        st_j, counts_j = jdev.select(*hag, ths_h, pot)
        assert tuple(int(c) for c in counts_d) == counts_h, pot
        assert tuple(int(c) for c in counts_j) == counts_h, pot
        np.testing.assert_array_equal(st_d.numpy(), st_h)
        np.testing.assert_array_equal(st_d.numpy(), np.asarray(st_j))


def test_make_maps_matches_host_and_jax(host_levels):
    _, hdx, hdy, hag = host_levels
    fp = FrontendParams()
    st_h, n_h = host_sel.make_maps(hag, hdx[0], hdy[0], fp.num_want,
                                   fp.initial_potential, fp.recursions,
                                   seed=fp.random_seed)
    st_d, n_d = tdev.make_maps([torch.as_tensor(a) for a in hag],
                               fp.num_want, fp.initial_potential,
                               fp.recursions, seed=fp.random_seed)
    st_j, n_j = jdev.make_maps(hag, fp.num_want, fp.initial_potential,
                               fp.recursions, seed=fp.random_seed)
    assert n_d == n_h == n_j
    np.testing.assert_array_equal(st_d.numpy(), st_h)
    np.testing.assert_array_equal(st_d.numpy(), np.asarray(st_j))


def _by_pixel(pix, rows, n):
    return {tuple(p): r for p, r in zip(np.asarray(pix)[:n].tolist(),
                                        np.asarray(rows)[:n].tolist())}


def _assert_cloud(got, want_pix, want_pos, want_feat, n, feat_check):
    """got (positions, features, mask, count, pixels): the count and the
    pixel set exact, positions and features pointwise by pixel."""
    pos, feat, mask, count, pix = (np.asarray(t) for t in got)
    assert int(count) == n and mask[:n].all() and not mask[n:].any()
    assert set(_by_pixel(pix, pos, n)) == set(_by_pixel(want_pix, want_pos,
                                                        n))
    hp = _by_pixel(want_pix, want_pos, n)
    for px, p in _by_pixel(pix, pos, n).items():
        np.testing.assert_allclose(p, hp[px], rtol=1e-5, atol=1e-6)
    hf = _by_pixel(want_pix, want_feat, n)
    for px, f in _by_pixel(pix, feat, n).items():
        feat_check(np.asarray(f), np.asarray(hf[px]))


def _feat_close(f, want):
    np.testing.assert_allclose(f, want, rtol=1e-4, atol=1e-3)


def _hsv_close(f, want):
    # H quantum 1/180, S and V 1/255: one quantum on H and S
    assert abs(f[0] - want[0]) <= 1.0 / 180.0 + 1e-6
    assert abs(f[1] - want[1]) <= 1.0 / 255.0 + 1e-6
    np.testing.assert_allclose(f[2:], want[2:], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("feature_type", [1, 0])
def test_full_cloud_matches_host_and_jax(frame, feature_type):
    """The whole device cloud against the host create_pointcloud and the
    JAX package's create_pointcloud_device; feature_type 0 (HSV) at one
    quantum on H and S (test_device_frontend.py:95)."""
    bgr, gray, depth = frame
    fp = FrontendParams(feature_type=feature_type)
    check = _hsv_close if feature_type == 0 else _feat_close
    got = tdev.create_pointcloud_device(bgr, gray, depth, CAM, fp,
                                        device="cpu")
    host = create_pointcloud(bgr, gray, depth, CAM, fp)
    _assert_cloud(got, host.selected_pixels, host.positions, host.features,
                  host.count, check)
    jpos, jfeat, _, jcount, jpix = jdev.create_pointcloud_device(
        bgr, gray, depth, CAM, fp)
    _assert_cloud(got, jpix, jpos, jfeat, int(jcount), check)
    if feature_type == 0:
        n = host.count
        assert (got[1][:n, :3] >= 0).all() and (got[1][:n, :3] <= 1).all()


def test_device_frontend_matches_host_eth3d_shape():
    """369x229 (neither a multiple of 32) at CAP 1000 (not a multiple of
    128): count and pixel set against the host and the JAX package
    (test_eth3d_shapes.py:56)."""
    cam, fp = from_reference(ETH_CAM_SMALL), from_reference(ETH_FP)
    bgr, gray, depth = _eth_frame(ETH_CAM_SMALL)
    got = tdev.create_pointcloud_device(bgr, gray, depth, cam, fp,
                                        device="cpu")
    host = create_pointcloud(bgr, gray, depth, cam, fp)
    assert got[0].shape == (1000, 3)
    _assert_cloud(got, host.selected_pixels, host.positions, host.features,
                  host.count, _feat_close)
    jpos, jfeat, _, jcount, jpix = jdev.create_pointcloud_device(
        bgr, gray, depth, ETH_CAM_SMALL, ETH_FP)
    _assert_cloud(got, jpix, jpos, jfeat, int(jcount), _feat_close)


def test_device_frontend_raises_without_the_card(frame):
    """On a machine without CUDA, the default device raises (no quiet
    fallback to the CPU or to the host frontend)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdev.create_pointcloud_device(*frame, CAM, FrontendParams())
