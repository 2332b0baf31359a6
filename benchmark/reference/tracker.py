"""The keyframe policy of the reference KeyframeTracker
(src/keyframe_tracker.cpp:86-116): a frame stays in the local map while
every criterion accepts it."""

from __future__ import annotations

import math

import numpy as np


def accept(T_kf: np.ndarray, kf_inn_post: float, eval_inn_post: float,
           frames_in_map: int, slam: dict) -> bool:
    """The four accept criteria: translation and rotation of the keyframe
    transform, the inner-product ratio to the map's reference and the
    number of frames already in the map."""
    dist = float(np.linalg.norm(T_kf[:3, 3]))
    tr = float(np.trace(T_kf[:3, :3]))
    ang = abs(math.acos(min(max(0.5 * (tr - 1.0), -1.0), 1.0))) \
        * 180.0 / 3.14159265
    ratio = kf_inn_post / eval_inn_post
    return (dist < slam["KFS_Distance"] and ang < slam["KFS_Angle"]
            and ratio > slam["FE_InnpThreshold"]
            and frames_in_map <= slam["Max_KF_interval"])
