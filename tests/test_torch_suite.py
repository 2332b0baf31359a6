"""Port parity, the quality-regression suite (cvo_slam_tpu_torch.eval.suite)
against the JAX package's eval.suite on the CPU: the sequence catalog and
its trajectories, run_sequence on one shared 8-frame folder at 160x120
(CAP 768), the markdown report; and the 60-frame challenge-mode ATE gates
of tests/test_eval.py, run through the port (slow)."""

import os

import numpy as np
import pytest
import torch

from cvo_slam_tpu.config import (CAMERA_PRESETS, CameraConfig, FrontendParams,
                                 SlamConfig)
from cvo_slam_tpu.eval import suite as jsuite
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.eval import suite as tsuite

torch.set_num_threads(2)
CAM = CameraConfig(fx=130.0, fy=130.0, cx=80.0, cy=60.0, depth_factor=5000.0,
                   width=160, height=120)
SMALL_FRONTEND = FrontendParams(num_want=600, cloud_capacity=768)
# the amplitudes of the suite's fast_rotation_100 and low_texture_100
FAST = np.array([0.13, 0.10, -0.06, 0.10, -0.06, 0.08])
MILD = np.array([0.06, -0.05, 0.04, 0.08, -0.05, 0.06])


def test_catalog_and_trajectories_match_jax():
    """The catalog's names and lengths and loop_trajectory equal the JAX
    package's exactly; scaled_camera gives the same fields; the f32 SE(3)
    exponentials of oscillating_trajectory agree within 1e-6."""
    want, got = jsuite._catalog(), tsuite._catalog()
    assert list(got) == list(want)
    assert [c["n_frames"] for c in got.values()] \
        == [c["n_frames"] for c in want.values()]
    for n in (12, 120):
        for g, w in zip(tsuite.loop_trajectory(n), jsuite.loop_trajectory(n)):
            np.testing.assert_array_equal(g, w)
    for s in (1.0, 0.25, 0.5):
        w = jsuite.scaled_camera(CAMERA_PRESETS["TUM1"], s)
        g = tsuite.scaled_camera(from_reference(CAMERA_PRESETS["TUM1"]), s)
        assert g == from_reference(w)
    for amp in (FAST, MILD):
        w = jsuite.oscillating_trajectory(60, amp)
        g = tsuite.oscillating_trajectory(60, amp)
        assert len(g) == len(w) == 60
        for a, b in zip(g, w):
            assert a.dtype == np.float64
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_run_sequence_matches_jax(tmp_path, monkeypatch):
    """run_sequence of the whole system through both packages on the same
    folder (the JAX package generates it; the port's generator is
    bypassed, since a last-bit difference of a trajectory changes the
    rendered frames), on tests/test_torch_tracking.py's 8-frame sequence,
    whose keyframe decisions sit clear of their threshold: the same result
    keys; the tracking ATE within that file's position bar (1e-4 m per
    pose with ell_reset) of the JAX package's; both ATEs under 0.05 m.
    Loop-closure accept decisions sit at ~1% margins (test_torch_slam.py),
    so the loop closures and the SLAM ATE are not compared."""
    from test_torch_tracking import STEP_TWIST
    folder = str(tmp_path / "seq_8")
    cfg = SlamConfig.default_shipped().replace(
        frontend=SMALL_FRONTEND, FinalOptimizationIterations=10)
    spec = dict(step_twist=STEP_TWIST)
    monkeypatch.setenv("CVO_SLAM_COMPCACHE", "0")
    want = jsuite.run_sequence("seq_8", folder, CAM, cfg, 8, spec)
    monkeypatch.setattr(tsuite, "make_sequence", lambda *a, **k: None)
    got = tsuite.run_sequence("seq_8", folder, from_reference(CAM),
                              from_reference(cfg), 8, spec, device="cpu")
    assert set(got) == set(want)
    assert got["frames"] == want["frames"] == 8
    assert got["tracking"]["pairs"] == 8
    for label in ("tracking", "slam"):
        assert set(got[label]) == set(want[label])
        assert got[label]["pairs"] == want[label]["pairs"]
        assert got[label]["ate_rmse"] < 0.05
    assert abs(got["tracking"]["ate_rmse"]
               - want["tracking"]["ate_rmse"]) < 1e-4


def test_render_markdown_matches_jax():
    """The same payload renders the same report."""
    row = dict(sequence="loop_120", frames=120, loop_closures=7, fps=3.25,
               tracking=dict(ate_rmse=0.00123), slam=dict(
                   ate_rmse=0.00098, rpe_trans_rmse=0.0007,
                   rpe_rot_rmse_deg=0.051))
    payload = dict(camera="TUM1", resolution=[640, 480],
                   results=[row, dict(row, sequence="no_slam", slam={})])
    assert tsuite.render_markdown(payload) == jsuite.render_markdown(payload)


def test_suite_cli_mesh_raises(tmp_path, monkeypatch):
    """--mesh is ported: the CLI hands it to run_slam.run, and a mesh
    asked for on cuda with more shards than the machine has cards raises
    instead of running something else (tests/test_torch_mesh_slam.py runs
    the mesh end to end on the CPU)."""
    from cvo_slam_tpu_torch.app import run_slam
    seen, real = [], run_slam.run

    def spy(*args, **kw):
        seen.append(kw["mesh_devices"])
        return real(*args, **kw)
    monkeypatch.setattr(run_slam, "run", spy)
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError):
        tsuite.main(["--out", str(tmp_path), "--scale", "0.25", "--seq",
                     "loop_120", "--mesh", str(n), "--device", "cuda"])
    assert seen == [n]


# -- the challenge-mode gates of tests/test_eval.py, through the port --------

def _gate(tmp_path, thresh, **gen):
    from cvo_slam_tpu_torch.app.run_slam import run
    from cvo_slam_tpu_torch.data import synthetic, tum
    cam = from_reference(CAM)
    cfg = from_reference(SlamConfig.default_shipped().replace(
        frontend=SMALL_FRONTEND, FinalOptimizationIterations=50))
    folder = str(tmp_path)
    synthetic.make_sequence(folder, cam, n_frames=60, **gen)
    run(folder, "associate.txt", cam, cfg, device="cpu")
    gt_ts, gt = tum.read_trajectory(os.path.join(folder, "groundtruth.txt"))
    for fname in ("Tracking_trajectory.txt", "SLAM_trajectory.txt"):
        ts, poses = tum.read_trajectory(os.path.join(folder, fname))
        rmse = tum.ate_rmse(gt_ts, gt, ts, poses)
        assert rmse < thresh, f"{fname}: ATE {rmse} >= {thresh}"


@pytest.mark.slow
def test_quality_regression_thresholds(tmp_path):
    """tests/test_eval.py's gate: 60 frames of fast rotation + exposure
    ramp through the whole system, ATE < 0.01 m."""
    _gate(tmp_path, 0.01,
          trajectory=tsuite.oscillating_trajectory(60, FAST),
          exposure_ramp=0.6)


@pytest.mark.slow
def test_quality_regression_low_texture(tmp_path):
    """tests/test_eval.py's gate: 60 frames at 25% contrast, ATE < 0.06 m."""
    _gate(tmp_path, 0.06,
          trajectory=tsuite.oscillating_trajectory(60, MILD),
          texture_strength=0.25)


@pytest.mark.slow
def test_quality_regression_noisy_loop(tmp_path):
    """tests/test_eval.py's gate: a 60-frame loop over the multi-surface
    scene with the sensor noise model, ATE < 0.03 m."""
    _gate(tmp_path, 0.03, trajectory=tsuite.loop_trajectory(60),
          multi_surface=True, noise=True)
