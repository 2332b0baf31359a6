"""Port parity, the adaptive-ell variant (cvo_slam_tpu_torch.cvo.adaptive)
against the JAX package's cvo.adaptive on the CPU: the self-kernel
statistics against a literal per-pair loop (tests/test_adaptive.py's
golden), adaptive_align against the JAX adaptive_align on the same clouds,
and run_odometry --adaptive through the CLI."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import engine as jengine
from cvo_slam_tpu.cvo.adaptive import adaptive_align as jadaptive_align
from cvo_slam_tpu.ops import se3 as jse3
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import engine as tengine
from cvo_slam_tpu_torch.cvo.adaptive import (AdaptiveParams,
                                             _kernel_stats_from_d2, _self_d2,
                                             adaptive_align)
from test_engine import structured_cloud
from test_torch_tracking import _rot_angle

torch.set_num_threads(2)
P = CvoParams()
TP = from_reference(P)
AP = AdaptiveParams()
# the engine parity bars (tests/test_torch_align.py's PALLAS_BARS): align
# iteration counts are not bit-stable across f32 orders of sums; measured
# on these clouds: equal iterations, 4.2e-6 m
BARS = dict(iters=3, pos=3e-4, rot=6e-4)


def _brute_kernel_d2_sum(pos, feat, mask, ell):
    """sum(A * d2) + nnz of the self kernel, literal per-pair loop
    (adaptive_cvo.cpp:134-142 gates, :222-231 reduction): the golden of
    tests/test_adaptive.py, whose module imports its helpers through the
    `tests` package (on the card another installed package)."""
    d2t = -2.0 * ell * ell * np.log(P.sp_thres / P.sigma ** 2)
    d2ct = -2.0 * P.c_ell ** 2 * np.log(P.sp_thres / P.c_sigma ** 2)
    tot, nnz = 0.0, 0
    idx = np.nonzero(mask)[0]
    for i in idx:
        for j in idx:
            d2 = float(np.sum((pos[i] - pos[j]) ** 2))
            d2c = float(np.sum((feat[i] - feat[j]) ** 2))
            if d2 < d2t and d2c < d2ct:
                a = (P.sigma ** 2 * np.exp(-d2 / (2 * ell * ell))
                     * P.c_sigma ** 2 * np.exp(-d2c / (2 * P.c_ell ** 2)))
                if a > P.sp_thres:
                    tot += a * d2
                    nnz += 1
    return tot, nnz


def _port_cloud(cloud):
    return tengine.PointCloud(*(torch.from_numpy(np.array(a))
                                for a in cloud))


@pytest.mark.parametrize("ell", [0.10, 0.05])
def test_self_kernel_stats_match_brute(ell):
    """sum(A d2) and nnz of the self kernel from the precomputed distance
    matrices against the per-pair loop: nnz exact, the sum within the JAX
    package's own bar (rtol 5e-3: the dot-identity d2 loses ~3 digits on
    near-duplicate points)."""
    cloud = structured_cloud(3, n=60)
    pos, feat, mask = (np.asarray(a) for a in cloud)
    d2, d2c = _self_d2(*(torch.from_numpy(np.array(a)) for a in cloud))
    got_sum, got_nnz = _kernel_stats_from_d2(
        d2, d2c, torch.tensor(ell, dtype=torch.float32), TP)
    want_sum, want_nnz = _brute_kernel_d2_sum(pos, feat, mask, ell)
    assert int(got_nnz) == want_nnz
    np.testing.assert_allclose(float(got_sum), want_sum, rtol=5e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_adaptive_align_matches_jax(seed):
    """The same clouds through both packages' adaptive_align (the port's
    iterations on the moment kernel's plain version): iterations, end
    transform and final ell within BARS; the known motion recovered within
    tests/test_adaptive.py's 5e-3; ell inside [ell_min, ell_max]."""
    fixed = structured_cloud(seed)
    xi = np.array([0.02, -0.015, 0.01, 0.03, -0.02, 0.025], np.float32)
    G = np.asarray(jse3.exp_se3(jnp.asarray(xi)), np.float64)
    moved = jengine.PointCloud(
        jnp.asarray((np.asarray(fixed.positions) @ G[:3, :3].T
                     + G[:3, 3]).astype(np.float32)
                    * np.asarray(fixed.mask)[:, None]),
        fixed.features, fixed.mask)
    want = jadaptive_align(fixed, moved, jnp.eye(3), jnp.zeros(3), P)
    got = adaptive_align(_port_cloud(fixed), _port_cloud(moved),
                         np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                         TP, AP)
    assert abs(int(got.iters) - int(want.iters)) <= BARS["iters"]
    assert int(got.iters) < P.max_iter
    Tg = got.transform.numpy().astype(np.float64)
    Tw = np.asarray(want.transform, np.float64)
    np.testing.assert_allclose(Tg[:3, 3], Tw[:3, 3], atol=BARS["pos"])
    assert _rot_angle(Tg[:3, :3], Tw[:3, :3]) < BARS["rot"]
    np.testing.assert_allclose(float(got.ell), float(want.ell), rtol=1e-5)
    assert AP.ell_min - 1e-6 <= float(got.ell) <= AP.ell_max + 1e-6
    est = np.asarray(jse3.log_se3(jnp.asarray(np.linalg.inv(Tg),
                                              jnp.float32)))
    np.testing.assert_allclose(est, xi, atol=5e-3)


def test_run_odometry_adaptive_cli(tmp_path):
    """The odometry CLI's run() with --adaptive on a 5-frame 160x120
    sequence (CAP 768), as tests/test_adaptive.py's test_run_odometry_cli:
    one pose line per frame after the first, ATE < 0.05 m. The
    line-by-line comparison with the JAX package's --adaptive is
    tests/test_torch_align.py's test_run_odometry_matches_jax."""
    from cvo_slam_tpu_torch.app import run_odometry
    from cvo_slam_tpu_torch.config import (CameraConfig, FrontendParams,
                                           SlamConfig)
    from cvo_slam_tpu_torch.data import synthetic
    from cvo_slam_tpu_torch.eval import ate
    folder = str(tmp_path / "seq")
    cam = CameraConfig(fx=130.0, fy=130.0, cx=80.0, cy=60.0,
                       depth_factor=5000.0, width=160, height=120)
    synthetic.make_sequence(folder, cam, n_frames=5)
    cfg = SlamConfig.default_shipped().replace(
        frontend=FrontendParams(num_want=600, cloud_capacity=768))
    stats = run_odometry.run(folder, "associate.txt", cam, cfg,
                             adaptive=True, device="cpu")
    assert stats["adaptive"] and stats["frames"] == 5
    est = ate.load_tum_trajectory(stats["trajectory"])
    assert len(est) == 4          # the first frame seeds, no pose line
    gt = ate.load_tum_trajectory(os.path.join(folder, "groundtruth.txt"))
    assert ate.ate_rmse(gt, est)["ate_rmse"] < 0.05
