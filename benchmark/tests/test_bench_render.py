"""benchmark/render.py against the port's numpy generator
(cvo_slam_tpu_torch.data.synthetic.make_sequence) on a small camera: the
same frame-0 scene, splatted along the same trajectory."""

from __future__ import annotations

import os

import cv2
import numpy as np
import pytest
import torch

from benchmark import render

from .util import SEED


def _cam(s=0.125):
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS
    c = CAMERA_PRESETS["TUM1"]
    return dict(fx=c.fx * s, fy=c.fy * s, cx=c.cx * s, cy=c.cy * s,
                depth_factor=c.depth_factor, width=int(640 * s),
                height=int(480 * s))


@pytest.mark.parametrize("multi_surface", [False, True])
def test_splat_matches_numpy_generator(tmp_path, multi_surface):
    """Depth and colour agree where both splat a point: depth exactly on
    all but a few pixels (float64 geometry in both, ties broken alike),
    colour within 1 DN (torch's bilinear resize against cv2's fixed-point
    one); the pixels each leaves empty agree but for a handful."""
    from cvo_slam_tpu_torch.config import CameraConfig
    from cvo_slam_tpu_torch.data import synthetic
    cam = _cam()
    camc = CameraConfig(**cam)
    traj = render.oscillating_trajectory(6, [0.13, 0.10, -0.06, 0.10, -0.06,
                                             0.08], period=6.0)
    synthetic.make_sequence(str(tmp_path), camc, trajectory=traj, seed=SEED,
                            multi_surface=multi_surface)
    bgr0, z0 = synthetic._base_scene(camc, np.random.default_rng(SEED),
                                     multi_surface=multi_surface)
    r = render.Renderer(torch.from_numpy(bgr0), torch.from_numpy(z0), cam)
    lines = open(os.path.join(tmp_path, "associate.txt")).read().split("\n")
    for k, G in enumerate(traj):
        _, rgb, _, dep = lines[k].split()
        want_bgr = cv2.imread(os.path.join(tmp_path, rgb))
        want_dep = cv2.imread(os.path.join(tmp_path, dep),
                              cv2.IMREAD_ANYDEPTH).astype(np.int64)
        bgr, depth = r.clean(G, first=k == 0)
        bgr, depth = bgr.numpy().astype(np.int64), depth.numpy()
        both = (depth > 0) & (want_dep > 0)
        n = depth.size
        assert np.sum((depth > 0) != (want_dep > 0)) <= 0.002 * n
        assert np.sum(depth[both] != want_dep[both]) <= 0.002 * n
        assert np.abs(bgr[both] - want_bgr[both]).max() <= 1


def test_lap_is_deterministic_and_periodic():
    """The same seed renders the same lap, another seed the same scene
    with other sensor noise; the oscillating trajectory has period 40, so
    frame 40 would be frame 0 again."""
    cam = _cam()
    traffic = {"trajectory": {"kind": "oscillating", "frames": 3,
                              "period": 40.0,
                              "amp_twist": [0.13, 0.1, -0.06, 0.1, -0.06,
                                            0.08]},
               "scene": {"seed": 1, "multi_surface": True, "noise": True}}
    a = render.render_lap(cam, traffic, SEED, "cpu")
    b = render.render_lap(cam, traffic, SEED, "cpu")
    c = render.render_lap(cam, traffic, SEED + 1, "cpu")
    for (x, y), (u, v) in zip(a, b):
        assert torch.equal(x, u) and torch.equal(y, v)
    assert not torch.equal(a[1][0], c[1][0])
    clean = dict(traffic, scene=dict(traffic["scene"], noise=False))
    assert torch.equal(render.render_lap(cam, clean, SEED, "cpu")[1][0],
                       render.render_lap(cam, clean, SEED + 1, "cpu")[1][0])
    t40 = render.oscillating_trajectory(41, traffic["trajectory"]["amp_twist"])
    assert np.allclose(t40[0], t40[40], atol=1e-6)
    loop = render.loop_trajectory(120)
    assert np.allclose(loop[0], np.eye(4))


def test_write_lap_round_trip(tmp_path):
    cam = _cam()
    traffic = {"trajectory": {"kind": "loop", "frames": 2, "radius": 0.22,
                              "lift": 0.1, "yaw_amp": 0.12},
               "scene": {"seed": 1, "multi_surface": False, "noise": True}}
    frames = render.render_lap(cam, traffic, SEED, "cpu")
    render.write_lap(str(tmp_path), frames)
    rgb, dep = render.frame_paths(1)
    assert np.array_equal(cv2.imread(os.path.join(tmp_path, rgb)),
                          frames[1][0].numpy())
    assert np.array_equal(cv2.imread(os.path.join(tmp_path, dep),
                                     cv2.IMREAD_ANYDEPTH),
                          frames[1][1].numpy().astype(np.uint16))
