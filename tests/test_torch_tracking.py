"""Port parity, whole slice: tracking-only SLAM through both packages'
run_slam.build_tracker on the same synthetic 160x120 sequence (CPU), and
the port's CLI end to end."""

import json
import os

import numpy as np
import pytest
import torch

from cvo_slam_tpu.config import CameraConfig, FrontendParams, SlamConfig
from cvo_slam_tpu.data import synthetic, tum
from cvo_slam_tpu_torch.config import from_reference

torch.set_num_threads(2)
CAM = CameraConfig(fx=130.0, fy=130.0, cx=80.0, cy=60.0, depth_factor=5000.0,
                   width=160, height=120)
SMALL_FRONTEND = FrontendParams(num_want=600, cloud_capacity=768)
N_FRAMES = 8
# 1.5x the generator's default step twist. With the default twist the
# inner-product ratio of frame 4 sits within 1% of FE_InnpThreshold, and the
# JAX package's own TPU-default formulation (backend pallas_mom, run in
# interpret mode) already takes the other keyframe decision there than its
# xla backend; at 1.5x every ratio stays >= 0.05 above the threshold.
STEP_TWIST = 1.5 * np.array([0.004, -0.006, 0.003, 0.010, -0.006, 0.008])


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("seq"))
    gt = synthetic.make_sequence(folder, CAM, n_frames=N_FRAMES,
                                 step_twist=STEP_TWIST)
    return folder, gt


def _track(tracker, load_image, folder):
    """Per frame: pose, odometry / keyframe iteration counts, the accept
    vote, the keyframe timestamp of the current local map, and the
    inner-product ratio of the keyframe criterion."""
    tracker.init()
    records = tum.load_association(os.path.join(folder, "associate.txt"))
    rows = []
    for i, rec in enumerate(records[:N_FRAMES]):
        img = load_image(folder, rec)
        if i == N_FRAMES - 1:
            tracker.force_keyframe()
        ref = tracker.evaluation
        pose = tracker.update(img)
        lt = tracker.lt
        lmap = lt.get_local_map()
        rows.append(dict(
            pose=np.asarray(pose, np.float64),
            odo_iters=lt.cvo_odometry.iters, kf_iters=lt.cvo_keyframe.iters,
            accept=lt.metrics.get("accept"),
            keyframe=None if lmap is None else lmap.keyframe.timestamp,
            ratio=(lt.metrics["kf_inn_post"] / ref.inn_post
                   if ref is not None and "kf_inn_post" in lt.metrics
                   else None)))
    return rows


def _rot_angle(Ra, Rb):
    """Angle of Ra^T Rb from its skew part (well-conditioned near 0)."""
    D = Ra.T @ Rb
    return 0.5 * float(np.linalg.norm([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0],
                                       D[1, 0] - D[0, 1]]))


# Bars per ell policy. Align iteration counts are not bit-stable across f32
# formulations: the sparsification a > sp_thres is discontinuous, so a pair
# whose kernel value sits within an ulp of the threshold moves the flow by
# ~sp_thres near convergence, and the stop rule fires some iterations
# earlier or later. The JAX package's own backends (pallas_mom vs xla) differ
# on this sequence by up to 3 iterations per alignment with ell_reset=True,
# and with ell_reset=False (every alignment starts at the carried fine ell)
# by up to 119 iterations and 4.2e-3 m; the port lands as close to xla as
# pallas_mom does. Keyframe decisions, map boundaries and the trajectory
# are held exactly / tightly; iterations per alignment (True) or in total
# (False) within the reference's own spread.
BARS = {True: dict(iters=3, total=None, pos=1e-4, rot=1e-4),
        False: dict(iters=None, total=0.1, pos=5e-3, rot=2e-3)}


@pytest.mark.parametrize("ell_reset", [True, False])
def test_tracking_slice_parity(seq, ell_reset):
    """Same keyframe decisions and map boundaries as the JAX package
    (backend xla), iteration counts and poses within BARS."""
    import dataclasses
    from cvo_slam_tpu.app import run_slam as jrun
    from cvo_slam_tpu_torch.app import run_slam as trun
    from cvo_slam_tpu_torch.data import tum as ttum
    folder, gt = seq
    cfg = SlamConfig.default_shipped().replace(
        OnlyTracking=True, frontend=SMALL_FRONTEND)
    cfg = cfg.replace(cvo=dataclasses.replace(cfg.cvo, ell_reset=ell_reset))
    want = _track(jrun.build_tracker(CAM, cfg), tum.load_image, folder)
    got = _track(trun.build_tracker(from_reference(CAM), from_reference(cfg),
                                    device="cpu"), ttum.load_image, folder)
    bars = BARS[ell_reset]
    # the sequence keeps every keyframe decision clear of its threshold
    assert all(abs(w["ratio"] - cfg.FE_InnpThreshold) > 0.05
               for w in want if w["ratio"] is not None)
    for k, (g, w) in enumerate(zip(got, want)):
        for key in ("accept", "keyframe"):
            assert g[key] == w[key], (k, key, g[key], w[key])
        if bars["iters"] is not None:
            for key in ("odo_iters", "kf_iters"):
                assert abs(g[key] - w[key]) <= bars["iters"], (k, key, g, w)
        np.testing.assert_allclose(g["pose"][:3, 3], w["pose"][:3, 3],
                                   atol=bars["pos"], err_msg=f"frame {k}")
        assert _rot_angle(g["pose"][:3, :3], w["pose"][:3, :3]) \
            < bars["rot"], k
    if bars["total"] is not None:
        total_g = sum(r["odo_iters"] + r["kf_iters"] for r in got)
        total_w = sum(r["odo_iters"] + r["kf_iters"] for r in want)
        assert abs(total_g - total_w) <= bars["total"] * total_w, \
            (total_g, total_w)
    est = np.array([r["pose"] for r in got])
    err = np.linalg.norm(est[:, :3, 3] - gt[:N_FRAMES, :3, 3], axis=1)
    assert err.max() < 0.05, err


def test_run_slam_cli_only_tracking(seq, tmp_path):
    """The port's CLI on the CPU: one finite pose per frame in
    Tracking_trajectory.txt and a metrics line per frame."""
    import shutil
    from cvo_slam_tpu_torch.app import run_slam as trun
    src, _ = seq
    folder = str(tmp_path / "run")
    shutil.copytree(src, folder)
    # a small camera and frontend, as the parity test uses
    cam = from_reference(CAM)
    cfg = from_reference(SlamConfig.default_shipped().replace(
        OnlyTracking=True, frontend=SMALL_FRONTEND))
    stats = trun.run(folder, "associate.txt", cam, cfg, max_frames=4,
                     device="cpu")
    assert stats["frames"] == 4
    ts, poses = tum.read_trajectory(os.path.join(folder,
                                                 "Tracking_trajectory.txt"))
    assert len(ts) == 4 and np.isfinite(poses).all()
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [m["frame"] for m in lines] == [0, 1, 2, 3]
    assert all(m["kf_iters"] > 0 for m in lines[2:])


def test_native_selector_builds_once(monkeypatch):
    """The prefetcher's workers load the native selector at once: one build
    runs at a time, so no worker finds another's half-written library and
    falls back while the others use it."""
    import threading
    import time
    from cvo_slam_tpu_torch.frontend import native as tnative
    active, most = [0], [0]

    def build():
        active[0] += 1
        most[0] = max(most[0], active[0])
        time.sleep(0.05)
        active[0] -= 1
        return False

    monkeypatch.setenv("CVO_SLAM_NATIVE", "1")
    monkeypatch.setattr(tnative, "_build", build)
    tnative._lib.cache_clear()
    try:
        threads = [threading.Thread(target=tnative._lib) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert most[0] == 1
    finally:
        tnative._lib.cache_clear()


@pytest.mark.parametrize("native", ["1", "0"])
def test_frontend_cloud_bitwise(seq, native, monkeypatch):
    """The port's frontend copy builds the same cloud, bit for bit, as the
    JAX package's, with the native selector and with its NumPy fallback."""
    from cvo_slam_tpu.frontend import native as jnative
    from cvo_slam_tpu.frontend.pointcloud import create_pointcloud as jcreate
    from cvo_slam_tpu_torch.frontend import native as tnative
    from cvo_slam_tpu_torch.frontend.pointcloud import \
        create_pointcloud as tcreate
    monkeypatch.setenv("CVO_SLAM_NATIVE", native)
    for lib in (jnative._lib, tnative._lib):
        lib.cache_clear()
    try:
        folder, _ = seq
        rec = tum.load_association(os.path.join(folder, "associate.txt"))[3]
        img = tum.load_image(folder, rec)
        want = jcreate(img.bgr, img.gray, img.depth, CAM, SMALL_FRONTEND)
        got = tcreate(img.bgr, img.gray, img.depth, from_reference(CAM),
                      from_reference(SMALL_FRONTEND))
        assert got.count == want.count > 0
        for name in ("positions", "features", "mask", "selected_pixels"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
    finally:
        for lib in (jnative._lib, tnative._lib):
            lib.cache_clear()
