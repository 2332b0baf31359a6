"""The port's mesh mode through the live pipeline (the counterpart of
tests/test_mesh_slam.py): app.run_slam with a mesh routes the windowed
Schur BA through parallel.sharded_ba (make_windowed_ba(mesh=...)) and the
final all-keyframe BA through parallel.sharded_lm (KeyframeGraph(mesh=...)),
and must reproduce the single-device run: the same keyframes and
loop-closure edges, positions within 1e-3 m (test_mesh_slam.py:91).

At 160x120 the triangulation gates reject every landmark, so the live
windows there are pose-only; a landmark-carrying window is driven through
make_windowed_ba directly on a synthetic graph. Also the scaling harness
(eval.scaling) at a small size.
"""

import copy
import json
import os
import types

import numpy as np
import pytest
import torch

from cvo_slam_tpu_torch.app import run_slam
from cvo_slam_tpu_torch.backend.ba import make_windowed_ba
from cvo_slam_tpu_torch.backend.keyframe_graph import GraphEdge
from cvo_slam_tpu_torch.config import CameraConfig, FrontendParams, SlamConfig
from cvo_slam_tpu_torch.data import synthetic, tum
from cvo_slam_tpu_torch.eval import scaling
from cvo_slam_tpu_torch.features.matcher import Mappoint
from cvo_slam_tpu_torch.ops import se3
from cvo_slam_tpu_torch.parallel import sharded_ba, sharded_lm
from cvo_slam_tpu_torch.parallel.mesh import Mesh
from cvo_slam_tpu_torch.tracking.types import Keyframe

torch.set_num_threads(2)
CAM = CameraConfig(fx=130.0, fy=130.0, cx=80.0, cy=60.0, depth_factor=5000.0,
                   width=160, height=120)
CFG = SlamConfig.default_shipped().replace(
    frontend=FrontendParams(num_want=600, cloud_capacity=768),
    Max_KF_interval=3, Min_KF_interval=0, FinalOptimizationIterations=30,
    LC_MinMatch=10)
STEP = np.array([0.003, -0.004, 0.002, 0.012, -0.008, 0.010])


def _walk(n_out, scale):
    step = se3.exp_se3_np(scale * STEP)
    Gs = [np.eye(4)]
    for _ in range(n_out):
        Gs.append(step @ Gs[-1])
    for _ in range(n_out):
        Gs.append(np.linalg.inv(step) @ Gs[-1])
    return Gs


@pytest.fixture
def counted(monkeypatch):
    """Calls of the sharded solvers during the test."""
    calls = dict(ba=0, lm=0)
    ba_fn, lm_fn = sharded_ba.optimize_ba_sharded, sharded_lm.optimize_sharded

    def ba(*a, **k):
        calls["ba"] += 1
        return ba_fn(*a, **k)

    def lm(*a, **k):
        calls["lm"] += 1
        return lm_fn(*a, **k)
    monkeypatch.setattr(sharded_ba, "optimize_ba_sharded", ba)
    monkeypatch.setattr(sharded_lm, "optimize_sharded", lm)
    return calls


def _solo_and_mesh(tmp_path, n_out, scale, counted):
    """run_slam.run on the walk, on one device and on 2 CPU shards; returns
    both trackers' keyframes and SLAM trajectories."""
    out = {}
    for name, shards in (("solo", 0), ("mesh", 2)):
        folder = str(tmp_path / name)
        synthetic.make_sequence(folder, CAM, trajectory=_walk(n_out, scale))
        trackers = []
        build = run_slam.build_tracker

        def keep(*a, **k):
            trackers.append(build(*a, **k))
            return trackers[-1]
        run_slam.build_tracker = keep
        try:
            run_slam.run(folder, "associate.txt", CAM, CFG, device="cpu",
                         mesh_devices=shards)
        finally:
            run_slam.build_tracker = build
        graph = trackers[0].graph
        ts, poses = tum.read_trajectory(os.path.join(folder,
                                                     "SLAM_trajectory.txt"))
        out[name] = dict(graph=graph, ts=ts, poses=np.asarray(poses),
                         calls=dict(counted))
    assert out["solo"]["calls"] == dict(ba=0, lm=0)
    return out["solo"], out["mesh"]


def _assert_mesh_matches(solo, mesh):
    gs, gm = solo["graph"], mesh["graph"]
    assert gm.mesh is not None and gs.mesh is None
    assert [(k.id, k.timestamp) for k in gm.keyframes()] == \
        [(k.id, k.timestamp) for k in gs.keyframes()]
    assert gm.lc_num == gs.lc_num >= 1
    assert any("windowed_ba" in r for r in gm.stage_ms)
    assert mesh["calls"]["ba"] >= 2 and mesh["calls"]["lm"] == 1
    assert mesh["ts"] == solo["ts"]
    dpos = np.abs(mesh["poses"][:, :3, 3] - solo["poses"][:, :3, 3]).max()
    assert dpos < 1e-3, dpos


def test_mesh_mode_matches_single_device_short_walk(tmp_path, counted):
    """tests/test_torch_slam.py's walk (4 steps out and back at 1.1x, 9
    frames): solo against 2 CPU shards through run_slam.run."""
    _assert_mesh_matches(*_solo_and_mesh(tmp_path, 4, 1.1, counted))


@pytest.mark.slow
def test_mesh_mode_matches_single_device(tmp_path, counted):
    """tests/test_mesh_slam.py's walk (8 steps out and back, 17 frames):
    solo against 2 CPU shards (about six minutes on the CPU)."""
    _assert_mesh_matches(*_solo_and_mesh(tmp_path, 8, 1.0, counted))


# -- a landmark-carrying window -----------------------------------------------

WBA_CAM = CameraConfig(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                       depth_factor=5000.0, width=320, height=240)


def _window_graph(n_kf=6, n_lm=40, seed=0):
    """Keyframes 0, 2, .. on an arc observing a landmark field (noisy
    poses and landmarks, exact measurements), chained by relative-pose
    edges; the last keyframe sees every other one as covisible."""
    rng = np.random.default_rng(seed)
    step = se3.exp_se3_np(np.array([0.01, -0.02, 0.005, 0.15, 0.02, 0.01]))
    poses = [np.eye(4)]
    for _ in range(n_kf - 1):
        poses.append(poses[-1] @ step)
    E_true = [np.linalg.inv(p) for p in poses]
    lms = rng.uniform([-2, -1.5, 3.0], [2, 1.5, 5.0], (n_lm, 3))
    kfs = []
    for v in range(n_kf):
        noise = np.eye(4) if v == 0 else se3.exp_se3_np(
            rng.normal(0, 0.01, 6))
        kfs.append(Keyframe(id=2 * v, timestamp=f"{v:.1f}",
                            pose=np.linalg.inv(noise @ E_true[v]),
                            keypoints=np.zeros((0, 3))))
    map_points = {}
    kps = [[] for _ in range(n_kf)]
    for li, X in enumerate(lms):
        mp = Mappoint(id=2 * li + 1, position=X + rng.normal(0, 0.05, 3),
                      normal=np.zeros(3))
        for v in range(n_kf):
            P = E_true[v][:3, :3] @ X + E_true[v][:3, 3]
            u = WBA_CAM.fx * P[0] / P[2] + WBA_CAM.cx
            w = WBA_CAM.fy * P[1] / P[2] + WBA_CAM.cy
            if P[2] > 0.1 and 0 <= u < 320 and 0 <= w < 240:
                kfs[v].mappoints_id[len(kps[v])] = mp.id
                mp.keypoints_id[2 * v] = len(kps[v])
                kps[v].append((u, w, 0.0))
        map_points[mp.id] = mp
    for v in range(n_kf):
        kfs[v].keypoints = np.array(kps[v])
    kfs[-1].best_covisible = [k.id for k in kfs[:-1]]
    edges = [GraphEdge(2 * v, 2 * v, 2 * v + 2, types.SimpleNamespace(
        transform=E_true[v] @ poses[v + 1], information=100.0 * np.eye(6)))
        for v in range(n_kf - 1)]
    return types.SimpleNamespace(
        keyframes=lambda: kfs, map_points=map_points, edges=edges,
        matcher=types.SimpleNamespace(inv_level_sigma2=np.ones(8)))


@pytest.mark.parametrize("shards", [3, 4])
def test_windowed_ba_mesh_carries_landmarks(shards, counted):
    """make_windowed_ba on a window of 6 keyframes and the landmarks they
    see, on one device and on a mesh of 3 CPU shards (3 does not divide
    the window's 512 landmark slots) and of 4:
    the same window (wba_sizes), the same pruned observations, keyframe
    poses within 1e-4 and landmarks within 1e-3."""
    cfg = SlamConfig.default_shipped()
    base = _window_graph()
    ref = base.keyframes()[-1]
    results = []
    for mesh in (None, Mesh([torch.device("cpu")] * shards)):
        g = copy.deepcopy(base)
        g.keyframes = (lambda kfs: lambda: kfs)(
            [copy.deepcopy(k) for k in base.keyframes()])
        g.map_points = copy.deepcopy(base.map_points)
        make_windowed_ba(WBA_CAM, cfg, device="cpu", mesh=mesh)(
            g, g.keyframes()[-1], ref.id)
        results.append(g)
    solo, meshed = results
    assert counted["ba"] == 2
    assert meshed.wba_sizes == solo.wba_sizes
    seen = sum(1 for mp in base.map_points.values() if mp.keypoints_id)
    assert solo.wba_sizes[0][1] == seen > 30    # landmarks in the window
    for a, b in zip(solo.keyframes(), meshed.keyframes()):
        np.testing.assert_allclose(b.pose, a.pose, atol=1e-4)
        assert b.mappoints_id == a.mappoints_id
    for mid, mp in solo.map_points.items():
        np.testing.assert_allclose(meshed.map_points[mid].position,
                                   mp.position, atol=1e-3)
        assert meshed.map_points[mid].keypoints_id == mp.keypoints_id


# -- the scaling harness ------------------------------------------------------

def test_run_harness_small(tmp_path):
    """eval.scaling at 12 poses / 16 landmarks, 1, 2 and 4 CPU shards: a
    row per shard count and solver, each within 1e-4 of the single-device
    solver (tests/test_sharded_lm.py:24), written to --out only."""
    out = tmp_path / "scaling.json"
    payload = scaling.run_harness(str(out), poses=12, landmarks=16, iters=5,
                                  repeats=1, shards=(1, 2, 4), device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(payload))
    for bench in ("lm", "ba"):
        rows = payload[bench]["shards"]
        assert [(r["shards"], r["solver"]) for r in rows] == [
            (n, s) for n in (1, 2, 4) for s in ("dense", "pcg")]
        for r in rows:
            assert r["cards"] == 1 and r["collectives_per_call"] > 0
            assert r["max_abs_pose_delta"] <= 1e-4, r
    assert payload["card"] is None and payload["device"] == "cpu"
    with pytest.raises(SystemExit):
        scaling.main([])                   # --out is required
