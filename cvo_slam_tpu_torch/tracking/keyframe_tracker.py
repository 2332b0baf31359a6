"""Top-level orchestrator: keyframe policy + frontend/backend wiring
(port of cvo_slam_tpu.tracking.keyframe_tracker).

Re-expression of reference KeyframeTracker
(reference src/keyframe_tracker.cpp): registers the four keyframe
accept criteria (:59-68, :86-116) and the two lifecycle callbacks (map init
stores the reference odometry result; map complete pushes the map to the
global graph, :74-84), and handles the first/second-frame bootstrap
(:129-149), and writes the final SLAM trajectory + loop-closure dump
(:233-317).
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np

from .. import spans
from ..config import CameraConfig, SlamConfig
from ..data.tum import ImagePair, pose_to_tum_line
from .local_tracker import LocalTracker
from .types import TrackingResult


class KeyframeTracker:

    def __init__(self, cam: CameraConfig, cfg: SlamConfig, graph=None,
                 keyframe_feature_hook=None, verbose: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.graph = graph           # backend KeyframeGraph (None = OnlyTracking)
        log = print if verbose else None
        self.lt = LocalTracker(cam, cfg, keyframe_feature_hook, log=log,
                               device=device)
        self.evaluation: Optional[TrackingResult] = None
        self.previous: Optional[ImagePair] = None
        self.initial_transformation = np.eye(4)
        self.verbose = verbose
        self.frames = 0   # update calls: the frame index of spans.py's spans

        self.lt.map_initialized_callbacks.append(self._on_map_initialized)
        self.lt.map_complete_callbacks.append(self._on_map_complete)
        self.lt.accept_callbacks.extend([
            self._accept_distance, self._accept_angle,
            self._accept_inner_product_ratio, self._accept_frame_number])

    # -- lifecycle callbacks (keyframe_tracker.cpp:74-84)
    def _on_map_initialized(self, lt, local_map, r_odometry):
        self.evaluation = copy.deepcopy(r_odometry)

    def _on_map_complete(self, lt, local_map):
        if not self.cfg.OnlyTracking and self.graph is not None:
            self.graph.add(local_map)

    # -- accept criteria (keyframe_tracker.cpp:86-116)
    def _accept_distance(self, lt, r_odometry, r_keyframe):
        d = float(np.linalg.norm(r_keyframe.transform[:3, 3]))
        if self.verbose:
            print(f"Translation norm (m): {d}")
        return d < self.cfg.KFS_Distance

    def _accept_angle(self, lt, r_odometry, r_keyframe):
        tr = float(np.trace(r_keyframe.transform[:3, :3]))
        ang = abs(math.acos(min(max(0.5 * (tr - 1.0), -1.0), 1.0))) \
            * 180.0 / 3.14159265
        if self.verbose:
            print(f"Rotation angle (degree): {ang}")
        return ang < self.cfg.KFS_Angle

    def _accept_inner_product_ratio(self, lt, r_odometry, r_keyframe):
        ratio = r_keyframe.inn_post / self.evaluation.inn_post
        if self.verbose:
            print(f"Inner product ratio: {ratio}")
        return ratio > self.cfg.FE_InnpThreshold

    def _accept_frame_number(self, lt, r_odometry, r_keyframe):
        if self.verbose:
            print(f"Frames in current local map: {r_keyframe.dis_to_keyframe}")
        return r_keyframe.dis_to_keyframe <= self.cfg.Max_KF_interval

    # -- main loop API (keyframe_tracker.cpp:123-149, :198-221)
    def init(self, initial_transformation: np.ndarray = None):
        self.initial_transformation = (np.eye(4) if initial_transformation is None
                                       else np.asarray(initial_transformation,
                                                       np.float64))

    def update(self, current: ImagePair, next_frame: ImagePair = None
               ) -> np.ndarray:
        """Process one frame; returns the (tracking) absolute pose.

        next_frame (optional): the upcoming frame, staged so the speculative
        executor can dispatch its device work before this frame's readback
        (tracking.local_tracker.SpeculativeExecutor)."""
        from .local_tracker import drive
        frame, self.frames = self.frames, self.frames + 1
        with spans.span("tracker.update", frame):
            return drive(self.update_steps(current, next_frame),
                         self.lt.executor)

    def update_steps(self, current: ImagePair, next_frame: ImagePair = None):
        """Generator form of update (device-dispatch request protocol, see
        tracking.local_tracker): yields frame/align/ip requests."""
        if self.previous is None:
            self.previous = current
            return self.initial_transformation.copy()
        if self.lt.get_local_map() is None:
            yield from self.lt.init_new_local_map_steps(
                self.previous, current, self.initial_transformation)
            return self.lt.get_current_pose()
        return (yield from self.lt.update_steps(current, next_frame))

    def force_keyframe(self):
        self.lt.force_complete_current_local_map()

    def check_new_map(self) -> bool:
        return self.lt.check_new_map()

    # -- final outputs (keyframe_tracker.cpp:233-317)
    def write_slam_trajectory_and_loop_closure(self, slam_path: str,
                                               lc_path: str):
        assert self.graph is not None, "no backend graph (OnlyTracking?)"
        with open(slam_path, "w") as f:
            for kf in self.graph.keyframes():
                f.write(pose_to_tum_line(kf.timestamp, kf.pose) + "\n")
                for fr in kf.frame_list:
                    f.write(pose_to_tum_line(
                        fr.timestamp, kf.pose @ fr.relative_pose) + "\n")
        with open(lc_path, "w") as f:
            for row in self.graph.loop_closure_rows():
                f.write(row + "\n")
