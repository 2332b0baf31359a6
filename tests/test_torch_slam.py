"""Port parity, whole slice 2: the full SLAM system (tracking, keyframe
graph, ORB + BoW, loop closure, windowed BA, final BA, frame-list
refinement) through both packages on the same synthetic out-and-back
sequence at 160x120 with CAP 768 (CPU), the port through its CLI's run().

The sequence is tests/test_loop_closure.py's loop walked 4 steps out and 4
back at 1.1x its step twist, with that test's configuration. Loop-closure
accept decisions compare inner products that move by ~1% with a keyframe
pose moving by a millimetre (the two packages' keyframe poses differ by up
to ~1.3 mm after the windowed BAs) or with the formulation of the
verification align. On other walks of the same family one accept decision
of 4-27 differs between the two packages, and the JAX package's own
backends differ on such a decision too: on the 3-step walk at 1.0x, the
last round's verification of candidate 0 (edge 8-0) rejects under its xla
align and accepts under its TPU-default pallas_mom align (the port's
moment formulation, run in interpret mode) on the same inputs, as the port
does. On this walk every keyframe and loop-closure decision agrees.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cvo_slam_tpu.config import CameraConfig, FrontendParams, SlamConfig
from cvo_slam_tpu.data import synthetic, tum
from cvo_slam_tpu.ops import se3
from cvo_slam_tpu_torch.config import from_reference

torch.set_num_threads(2)
CAM = CameraConfig(fx=130.0, fy=130.0, cx=80.0, cy=60.0, depth_factor=5000.0,
                   width=160, height=120)
CFG = SlamConfig.default_shipped().replace(
    frontend=FrontendParams(num_want=600, cloud_capacity=768),
    Max_KF_interval=3, Min_KF_interval=0, FinalOptimizationIterations=30,
    LC_MinMatch=10)
N_OUT = 4
STEP = 1.1 * np.array([0.003, -0.004, 0.002, 0.012, -0.008, 0.010])


def _loop_trajectory():
    step = np.asarray(se3.exp_se3(jnp.asarray(STEP.astype(np.float32))),
                      np.float64)
    Gs = [np.eye(4)]
    for _ in range(N_OUT):
        Gs.append(step @ Gs[-1])
    for _ in range(N_OUT):
        Gs.append(np.linalg.inv(step) @ Gs[-1])
    return Gs


def _lc_edges(path):
    with open(path) as f:
        rows = [line.split() for line in f if line.strip()]
    return rows, {(int(r[0]), int(r[1])) for r in rows}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages on the same sequence: the JAX package frame by frame
    (as tests/test_loop_closure.py), the port through run_slam.run."""
    from cvo_slam_tpu.app.run_slam import build_tracker
    from cvo_slam_tpu_torch.app import run_slam as trun
    base = tmp_path_factory.mktemp("slam")
    jdir, tdir = str(base / "jax"), str(base / "port")
    Gs = _loop_trajectory()
    synthetic.make_sequence(jdir, CAM, trajectory=Gs)
    shutil.copytree(jdir, tdir)
    gt = np.array([np.linalg.inv(G) for G in Gs])

    tracker = build_tracker(CAM, CFG)
    tracker.init()
    records = tum.load_association(os.path.join(jdir, "associate.txt"))
    accepts = []
    for i, rec in enumerate(records):
        if i == len(records) - 1:
            tracker.force_keyframe()
        tracker.update(tum.load_image(jdir, rec))
        accepts.append(tracker.lt.metrics.get("accept"))
    tracker.write_slam_trajectory_and_loop_closure(
        os.path.join(jdir, "SLAM_trajectory.txt"),
        os.path.join(jdir, "loop_closure.txt"))
    want = dict(graph=tracker.graph, accepts=accepts)

    stats = trun.run(tdir, "associate.txt", from_reference(CAM),
                     from_reference(CFG), device="cpu")
    with open(os.path.join(tdir, "metrics.jsonl")) as f:
        got = dict(stats=stats,
                   accepts=[json.loads(line).get("accept") for line in f])
    return jdir, tdir, gt, want, got


def test_slam_slice_parity(runs):
    """Same keyframe decisions and count, the same set of accepted
    loop-closure edges, 62-field loop_closure.txt rows, SLAM keyframe
    positions within 5 mm of the JAX package's, SLAM ATE < 0.05 m."""
    jdir, tdir, gt, want, got = runs
    graph = want["graph"]
    assert got["accepts"] == want["accepts"]
    assert got["stats"]["keyframes"] == len(graph.keyframes())
    _, want_edges = _lc_edges(os.path.join(jdir, "loop_closure.txt"))
    rows, edges = _lc_edges(os.path.join(tdir, "loop_closure.txt"))
    assert graph.lc_num >= 1 and len(want_edges) == graph.lc_num
    assert edges == want_edges
    assert got["stats"]["lc_num"] == len(rows) == graph.lc_num
    # 2 ids + 2 timestamps + 7 measurement + 36 Hessian + score + matches
    # + 3 inner products + 7 lc_prior + 2 norms + cos_angle
    assert all(len(r) == 62 for r in rows)

    ts, poses = tum.read_trajectory(os.path.join(tdir, "SLAM_trajectory.txt"))
    by_ts = dict(zip(ts, poses))
    for kf in graph.keyframes():
        np.testing.assert_allclose(by_ts[kf.timestamp][:3, 3], kf.pose[:3, 3],
                                   atol=5e-3, err_msg=kf.timestamp)
    gt_ts = [f"{1000.0 + 0.05 * k:.6f}" for k in range(len(gt))]
    assert len(ts) == len(gt_ts)
    assert tum.ate_rmse(gt_ts, gt, ts, poses) < 0.05


def test_eval_ate_parity(runs):
    """The port's eval.ate (ATE and RPE) equals the JAX package's on the
    same ground truth and SLAM trajectory files."""
    from cvo_slam_tpu.eval import ate as jate
    from cvo_slam_tpu_torch.eval import ate as tate
    _, tdir, _, _, _ = runs
    paths = [os.path.join(tdir, n) for n in ("groundtruth.txt",
                                             "SLAM_trajectory.txt")]
    gt_w, est_w = (jate.load_tum_trajectory(p) for p in paths)
    gt_g, est_g = (tate.load_tum_trajectory(p) for p in paths)
    want = {**jate.ate_rmse(gt_w, est_w), **jate.rpe(gt_w, est_w)}
    got = {**tate.ate_rmse(gt_g, est_g), **tate.rpe(gt_g, est_g)}
    assert got == want and want["ate_rmse"] < 0.05


def test_run_slam_backend_stats(runs):
    """run() without OnlyTracking reports the keyframe path: every backend
    stage timed, the loop-closure rounds with their candidates, one
    Tracking_trajectory.txt line per frame."""
    _, tdir, gt, _, got = runs
    stats = got["stats"]
    assert set(stats["keyframe_path_ms"]) == {
        "insert", "loop_detect", "windowed_ba", "final_ba", "refine_frames"}
    assert stats["lc_rounds"] >= 1 and stats["lc_candidates"] >= 1
    assert set(stats["lc_stage_ms"]) >= {"refresh", "score", "ransac",
                                         "verify"}
    ts, poses = tum.read_trajectory(os.path.join(tdir,
                                                 "Tracking_trajectory.txt"))
    assert len(ts) == len(gt) and np.isfinite(poses).all()


@pytest.mark.parametrize("option", ["mesh", "multithreading"])
def test_run_slam_unported_options_raise(option):
    """--mesh is ported: mesh_devices=2 with device="cpu" puts the windowed
    and the final BA on a 2-shard CPU mesh, alone and with the async
    backend (UseMultiThreading); a mesh asked for on cuda with more
    shards than the machine has cards raises instead of running something
    else (tests/test_torch_mesh_slam.py runs the mesh end to end)."""
    from cvo_slam_tpu_torch.app import run_slam as trun
    cam, cfg = from_reference(CAM), from_reference(CFG)
    if option == "multithreading":
        cfg = cfg.replace(UseMultiThreading=True)
    tracker = trun.build_tracker(cam, cfg, device="cpu", mesh_devices=2)
    graph = tracker.graph
    try:
        assert graph.mesh.size == 2 and graph.mesh.device.type == "cpu"
    finally:
        if option == "multithreading":
            graph.close()
    with pytest.raises(RuntimeError):
        trun.build_tracker(cam, cfg, device="cuda",
                           mesh_devices=torch.cuda.device_count() + 1)
