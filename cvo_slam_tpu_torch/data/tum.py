"""TUM RGB-D dataset IO + trajectory writers (copy of cvo_slam_tpu.data.tum).

Re-expression of the reference CLI data path
(reference src/run_SLAM.cpp:101-143): association-file parsing, BGR
image + 16-bit depth loading, and TUM-format trajectory lines
(timestamp tx ty tz qx qy qz qw, run_SLAM.cpp:83-86).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import cv2
import numpy as np
from scipy.spatial.transform import Rotation


@dataclass
class FrameRecord:
    timestamp: str       # kept as string, exactly as read (run_SLAM.cpp:117-119)
    rgb_path: str
    depth_path: str


@dataclass
class ImagePair:
    """Reference cvo_slam::Image (include/cvo_image.h:26-38)."""
    timestamp: str
    bgr: np.ndarray      # (H,W,3) uint8, BGR channel order (cv::imread)
    gray: np.ndarray     # (H,W) uint8 via COLOR_RGB2GRAY on BGR (quirk kept)
    depth: np.ndarray    # (H,W) uint16 raw
    # optional precomputed frontend output (data.prefetch pipelines the host
    # frontend with device compute); LocalTracker uses it when present
    precomputed_cloud: object = None


def load_association(path: str) -> List[FrameRecord]:
    """Parse a TUM association file: ``rgb_ts rgb_path depth_ts depth_path``
    per line (run_SLAM.cpp:101-131)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            out.append(FrameRecord(parts[0], parts[1], parts[3]))
    return out


def load_image(folder: str, rec: FrameRecord) -> ImagePair:
    """Load one RGB-D pair (run_SLAM.cpp:134-143)."""
    bgr = cv2.imread(os.path.join(folder, rec.rgb_path))
    depth = cv2.imread(os.path.join(folder, rec.depth_path), cv2.IMREAD_ANYDEPTH)
    if bgr is None or depth is None:
        raise FileNotFoundError(f"missing frame {rec.rgb_path} / {rec.depth_path}")
    # reference quirk: RGB2GRAY coefficients applied to BGR data
    # (pcd_generator.cpp:624 on cv::imread output)
    gray = cv2.cvtColor(bgr, cv2.COLOR_RGB2GRAY)
    return ImagePair(rec.timestamp, bgr, gray, depth.astype(np.uint16))


def pose_to_tum_line(timestamp: str, pose: np.ndarray) -> str:
    """TUM line from a 4x4 cam->world pose (run_SLAM.cpp:83-86)."""
    q = Rotation.from_matrix(pose[:3, :3]).as_quat()  # x, y, z, w
    t = pose[:3, 3]
    vals = " ".join(repr(float(v)) for v in (*t, *q))
    return f"{timestamp} {vals}"


def write_trajectory(path: str, rows) -> None:
    """rows: iterable of (timestamp, 4x4 pose)."""
    with open(path, "w") as f:
        for ts, pose in rows:
            f.write(pose_to_tum_line(ts, pose) + "\n")


def read_trajectory(path: str):
    """Read a TUM trajectory into (timestamps, (N,4,4) poses)."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8 or parts[0].startswith("#"):
                continue
            ts.append(parts[0])
            t = np.array([float(v) for v in parts[1:4]])
            q = np.array([float(v) for v in parts[4:8]])
            T = np.eye(4)
            T[:3, :3] = Rotation.from_quat(q).as_matrix()
            T[:3, 3] = t
            poses.append(T)
    return ts, np.array(poses)


def ate_rmse(gt_ts, gt_poses, est_ts, est_poses) -> float:
    """Absolute trajectory error RMSE after Horn alignment (standard TUM
    evaluation; pairs matched by nearest timestamp)."""
    gt_t = np.array([float(t) for t in gt_ts])
    est_t = np.array([float(t) for t in est_ts])
    idx = np.abs(gt_t[None, :] - est_t[:, None]).argmin(axis=1)
    ok = np.abs(gt_t[idx] - est_t) < 0.02
    P = est_poses[ok][:, :3, 3]
    Q = gt_poses[idx[ok]][:, :3, 3]
    if len(P) < 3:
        return float("inf")
    # Horn/Umeyama alignment (rotation+translation)
    mp, mq = P.mean(0), Q.mean(0)
    H = (P - mp).T @ (Q - mq)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    t = mq - R @ mp
    err = (P @ R.T + t) - Q
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
