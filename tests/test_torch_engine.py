"""Port parity, engine layer: cvo_slam_tpu_torch.cvo.engine.align /
compute_innerproduct / frame_step against the JAX package's engine (backend
"xla") on the same clouds (CPU); and the port's device policy."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import engine as jengine
from cvo_slam_tpu.ops import se3 as jse3
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import engine as tengine
from test_engine import structured_cloud

torch.set_num_threads(2)
P = CvoParams()


def _port_cloud(pc):
    return tengine.PointCloud(*[torch.as_tensor(np.array(a)) for a in pc])


def _pair(seed, xi):
    """(fixed, moved) JAX clouds: the fixed cloud moved by exp(xi)."""
    fixed = structured_cloud(seed)
    G = np.asarray(jse3.exp_se3(jnp.asarray(np.asarray(xi, np.float32))),
                   np.float64)
    pos = np.asarray(fixed.positions)
    mask = np.asarray(fixed.mask)
    moved = jengine.PointCloud(
        jnp.asarray((pos @ G[:3, :3].T + G[:3, 3]).astype(np.float32)
                    * mask[:, None]), fixed.features, fixed.mask)
    return fixed, moved


XI = [np.array([0.02, -0.015, 0.01, 0.03, -0.02, 0.025]),
      np.array([-0.01, 0.02, 0.005, -0.02, 0.01, 0.015])]


@pytest.mark.parametrize("case", [(0, 0, False), (1, 1, False), (0, 1, True)])
def test_align_and_innerproduct_parity(case):
    """Same iters, final ell and nnz; transform within 1e-5; the inner
    products within rtol 1e-4 and the pair counts exact."""
    seed, which, ell_low = case
    p = dataclasses.replace(P, ell_init=0.06) if ell_low else P
    tp = from_reference(p)
    fixed, moved = _pair(seed, XI[which])
    ell0 = np.float32(p.ell_init)
    want = jengine.align(fixed, moved, jnp.eye(3), jnp.zeros(3),
                         jnp.float32(ell0), p, "xla")
    tf, tm = _port_cloud(fixed), _port_cloud(moved)
    got = tengine.align(tf, tm, np.eye(3, dtype=np.float32),
                        np.zeros(3, np.float32), ell0, tp)
    assert int(got.iters) == int(want.iters)
    assert int(want.iters) < p.max_iter
    assert float(got.ell) == float(want.ell)
    assert int(got.nnz) == int(want.nnz)
    np.testing.assert_allclose(got.transform.numpy(),
                               np.asarray(want.transform), atol=1e-5)

    tran = np.array(want.transform)
    ip_want = jengine.compute_innerproduct(fixed, moved, jnp.asarray(tran),
                                           want.ell, p, "xla")
    ip_got = tengine.compute_innerproduct(tf, tm, tran, float(want.ell), tp)
    for key in ("inn_pre", "inn_post", "inn_fixed", "inn_moving",
                "cos_angle"):
        np.testing.assert_allclose(float(ip_got[key]), float(ip_want[key]),
                                   rtol=1e-4, err_msg=key)
    for key in ("inn_pre_num", "inn_post_num", "inliers"):
        assert int(ip_got[key]) == int(ip_want[key]), key
    # The 6x6 Hessian is assembled from the 13x13 moments G by differences
    # of degree-4 moments of points ~1.5 m from the origin, which cancel
    # ~1e3-fold in f32: on these clouds the JAX result is itself 2e-4 of
    # max|H| from an f64 evaluation, and any other f32 summation order of
    # G lands as far again. Hence the bar relative to max|H|.
    H_w = np.asarray(ip_want["post_hessian"])
    scale = np.abs(H_w).max()
    np.testing.assert_allclose(ip_got["post_hessian"].numpy() / scale,
                               H_w / scale, atol=1e-3)


def test_frame_step_parity():
    """The fused frame (odometry align+ip, device warm start, keyframe
    align+ip) against the JAX frame_step."""
    kf, prev = _pair(0, XI[0])
    _, cur = _pair(0, 2 * XI[0])
    kf_tran = np.asarray(jse3.exp_se3(jnp.asarray(-XI[0].astype(np.float32))))
    ell = np.float32(P.ell_init)
    want = jengine.frame_step(prev, kf, cur, jnp.eye(3), jnp.zeros(3), ell,
                              jnp.asarray(kf_tran), ell, P, "xla")
    got = tengine.frame_step(_port_cloud(prev), _port_cloud(kf),
                             _port_cloud(cur), np.eye(3, dtype=np.float32),
                             np.zeros(3, np.float32), ell, kf_tran, ell,
                             from_reference(P))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert int(g.iters) == int(w.iters)
        assert int(g.nnz) == int(w.nnz)
        np.testing.assert_allclose(g.transform.numpy(),
                                   np.asarray(w.transform), atol=1e-5)
    for g, w in ((got[1], want[1]), (got[3], want[3])):
        np.testing.assert_allclose(float(g["inn_post"]), float(w["inn_post"]),
                                   rtol=1e-4)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               atol=1e-5)


def test_empty_clouds_align_to_identity():
    """All-masked clouds: zero flow stops at iteration 0 with the identity;
    the post-Hessian is the identity (no inliers)."""
    cap = 256
    empty = tengine.PointCloud(torch.zeros(cap, 3), torch.zeros(cap, 5),
                               torch.zeros(cap, dtype=torch.bool))
    tp = from_reference(P)
    res = tengine.align(empty, empty, np.eye(3, dtype=np.float32),
                        np.zeros(3, np.float32), np.float32(0.15), tp)
    assert int(res.iters) == 0 and int(res.nnz) == 0
    np.testing.assert_array_equal(res.transform.numpy(), np.eye(4))
    ip = tengine.compute_innerproduct(empty, empty, np.eye(4), 0.15, tp)
    np.testing.assert_array_equal(ip["post_hessian"].numpy(), np.eye(6))
    assert int(ip["inliers"]) == 0


def test_default_device_is_cuda():
    """Entry points default to CUDA and raise without it; nothing falls back
    to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    from cvo_slam_tpu_torch.app import run_slam
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu_torch.device import resolve_device
    from cvo_slam_tpu_torch.frontend.pointcloud import PointCloudHost
    from cvo_slam_tpu_torch.tracking.local_tracker import LocalTracker
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True)
    pc = PointCloudHost(np.zeros((8, 3), np.float32),
                        np.zeros((8, 5), np.float32), np.zeros(8, bool), 0,
                        np.zeros((8, 2), np.int32), 0, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.PointCloud.from_host(pc)
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalTracker(CAMERA_PRESETS["TUM1"], cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_slam.build_tracker(CAMERA_PRESETS["TUM1"], cfg)
    assert resolve_device("cpu") == torch.device("cpu")


def test_backend_is_slice_two():
    """Slice 2 ported the backend: the shipped configuration builds the
    tracker with its keyframe graph, loop detector and windowed BA; with
    UseMultiThreading (ported since) the graph runs behind the async
    backend."""
    from cvo_slam_tpu_torch.app import run_slam
    from cvo_slam_tpu_torch.backend.keyframe_graph import KeyframeGraph
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu_torch.parallel.async_backend import AsyncKeyframeGraph
    cfg = SlamConfig.default_shipped()
    tracker = run_slam.build_tracker(CAMERA_PRESETS["TUM1"], cfg,
                                     device="cpu")
    assert isinstance(tracker.graph, KeyframeGraph)
    assert tracker.graph.loop_detector is not None
    assert tracker.graph.windowed_ba is not None
    assert tracker.lt.keyframe_feature_hook is not None
    tracker = run_slam.build_tracker(CAMERA_PRESETS["TUM1"],
                                     cfg.replace(UseMultiThreading=True),
                                     device="cpu")
    assert isinstance(tracker.graph, AsyncKeyframeGraph)
    assert isinstance(tracker.graph._graph, KeyframeGraph)
    tracker.graph.close()
