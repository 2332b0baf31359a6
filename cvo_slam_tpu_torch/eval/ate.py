"""Trajectory evaluation: TUM-style ATE and RPE (copy of
cvo_slam_tpu.eval.ate; NumPy only).

The reference repo evaluates its two output files (Tracking_trajectory.txt /
SLAM_trajectory.txt, written at run_SLAM.cpp:83-86 and
keyframe_tracker.cpp:240-254) with the external TUM RGB-D benchmark tools
(association convention cited in README.md:73). This module is the built-in
equivalent so the framework is self-contained:

  * ATE (absolute trajectory error): timestamp association -> Horn/Umeyama
    rigid alignment (no scale: RGB-D has metric depth) -> RMSE of the
    translational residuals.
  * RPE (relative pose error): per-interval relative-transform error,
    translational (m) and rotational (deg) RMSE.

CLI:  python -m cvo_slam_tpu_torch.eval.ate <groundtruth.txt> <estimate.txt>
      [--max-difference 0.02] [--rpe-delta 1]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

import numpy as np


def load_tum_trajectory(path: str) -> Dict[float, np.ndarray]:
    """timestamp -> 4x4 pose from a TUM file (ts tx ty tz qx qy qz qw)."""
    out: Dict[float, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 8:
                continue
            ts = float(parts[0])
            tx, ty, tz, qx, qy, qz, qw = (float(v) for v in parts[1:8])
            out[ts] = _pose_from_tq(np.array([tx, ty, tz]),
                                    np.array([qx, qy, qz, qw]))
    return out


def _pose_from_tq(t: np.ndarray, q: np.ndarray) -> np.ndarray:
    qx, qy, qz, qw = q / np.linalg.norm(q)
    R = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)]])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def associate(gt: Dict[float, np.ndarray], est: Dict[float, np.ndarray],
              max_difference: float = 0.02) -> List[Tuple[float, float]]:
    """Greedy nearest-timestamp matching (the TUM associate.py policy)."""
    pairs = sorted(
        (abs(a - b), a, b) for a in gt for b in est
        if abs(a - b) < max_difference)
    used_a, used_b, out = set(), set(), []
    for _, a, b in pairs:
        if a not in used_a and b not in used_b:
            used_a.add(a)
            used_b.add(b)
            out.append((a, b))
    out.sort()
    return out


def horn_align(P: np.ndarray, Q: np.ndarray) -> np.ndarray:
    """Rigid transform T minimizing ||T(P) - Q|| (Horn/Umeyama, no scale).
    P, Q: (N,3). Returns 4x4 with Q ~= R @ P + t."""
    mp, mq = P.mean(0), Q.mean(0)
    H = (P - mp).T @ (Q - mq)
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    if np.linalg.det(Vt.T @ U.T) < 0:
        S[2, 2] = -1.0
    R = Vt.T @ S @ U.T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mq - R @ mp
    return T


def ate_rmse(gt: Dict[float, np.ndarray], est: Dict[float, np.ndarray],
             max_difference: float = 0.02) -> Dict[str, float]:
    pairs = associate(gt, est, max_difference)
    if len(pairs) < 2:
        raise ValueError("fewer than 2 associated poses")
    P = np.stack([est[b][:3, 3] for _, b in pairs])
    Q = np.stack([gt[a][:3, 3] for a, _ in pairs])
    T = horn_align(P, Q)
    res = (P @ T[:3, :3].T + T[:3, 3]) - Q
    err = np.linalg.norm(res, axis=1)
    return dict(ate_rmse=float(np.sqrt(np.mean(err ** 2))),
                ate_mean=float(err.mean()), ate_median=float(np.median(err)),
                ate_max=float(err.max()), pairs=len(pairs))


def rpe(gt: Dict[float, np.ndarray], est: Dict[float, np.ndarray],
        delta: int = 1, max_difference: float = 0.02) -> Dict[str, float]:
    """Relative pose error over `delta`-frame intervals (TUM rpe tool)."""
    pairs = associate(gt, est, max_difference)
    if len(pairs) < delta + 1:
        raise ValueError("not enough pairs for the requested delta")
    terrs, rerrs = [], []
    for i in range(len(pairs) - delta):
        (a0, b0), (a1, b1) = pairs[i], pairs[i + delta]
        dg = np.linalg.inv(gt[a0]) @ gt[a1]
        de = np.linalg.inv(est[b0]) @ est[b1]
        E = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(E[:3, 3]))
        c = np.clip((np.trace(E[:3, :3]) - 1) / 2, -1.0, 1.0)
        rerrs.append(np.degrees(np.arccos(c)))
    terrs = np.asarray(terrs)
    rerrs = np.asarray(rerrs)
    return dict(rpe_trans_rmse=float(np.sqrt(np.mean(terrs ** 2))),
                rpe_rot_rmse_deg=float(np.sqrt(np.mean(rerrs ** 2))),
                intervals=len(terrs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("groundtruth")
    ap.add_argument("estimate")
    ap.add_argument("--max-difference", type=float, default=0.02)
    ap.add_argument("--rpe-delta", type=int, default=1)
    args = ap.parse_args(argv)
    gt = load_tum_trajectory(args.groundtruth)
    est = load_tum_trajectory(args.estimate)
    out = ate_rmse(gt, est, args.max_difference)
    try:
        out.update(rpe(gt, est, args.rpe_delta, args.max_difference))
    except ValueError:
        pass
    print(json.dumps(out))


if __name__ == "__main__":
    main()
