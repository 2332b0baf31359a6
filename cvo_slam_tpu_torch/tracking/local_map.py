"""Local pose graph: one fixed keyframe + tracked frames
(port of cvo_slam_tpu.tracking.local_map, pose bookkeeping only).

Re-expression of reference LocalMap (reference src/local_map.cpp):
a tiny pose graph with the keyframe vertex fixed, odometry edges
(prev -> cur) and keyframe edges (kf -> cur), each carrying a TrackingResult.
Pose bookkeeping: current_pose = keyframe_pose * result.transform
(local_map.cpp:231); vertex estimates are inverse poses chained from the
keyframe estimate (:230). The graph's optimize() belongs to the backend.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..config import SlamConfig
from .types import Keyframe, TrackingResult


@dataclass
class LocalMap:
    keyframe: Keyframe
    keyframe_pose: np.ndarray                  # (4,4) non-optimized bookkeeping
    cfg: SlamConfig
    timestamps: List[str] = field(default_factory=list)   # per vertex
    estimates: List[np.ndarray] = field(default_factory=list)  # inverse poses E
    edges: List[Tuple[int, int, TrackingResult]] = field(default_factory=list)
    current_timestamp: Optional[str] = None
    current_frame_ref: Optional[object] = None   # most recent frame handle
    current_pose: Optional[np.ndarray] = None
    last_map: bool = False
    last_keyframe: Optional[Keyframe] = None

    def __post_init__(self):
        # keyframe vertex (id 0, fixed; local_map.cpp:96-99)
        self.timestamps.append(self.keyframe.timestamp)
        self.estimates.append(np.linalg.inv(self.keyframe_pose))
        self.current_pose = self.keyframe_pose.copy()

    # -- graph construction (local_map.cpp:215-232)
    def add_frame(self, frame_handle, timestamp: str):
        self.current_frame_ref = frame_handle
        self.current_timestamp = timestamp
        self.timestamps.append(timestamp)
        self.estimates.append(np.eye(4))

    def add_odometry_measurement(self, result: TrackingResult):
        cur = len(self.timestamps) - 1
        self.edges.append((cur - 1, cur, result))

    def add_keyframe_measurement(self, result: TrackingResult):
        cur = len(self.timestamps) - 1
        self.edges.append((0, cur, result))
        self.estimates[cur] = self._chain_estimate(result.transform)
        self.current_pose = self.keyframe_pose @ result.transform

    def _chain_estimate(self, Z: np.ndarray) -> np.ndarray:
        """g2o: v.setEstimateInv(kf.estimateInv() * Z). estimateInv() is the
        *pose* (the stored estimate is its inverse), so the new vertex pose is
        pose_kf @ Z and the stored estimate is its inverse."""
        pose_kf = np.linalg.inv(self.estimates[0])
        return np.linalg.inv(pose_kf @ Z)

    # -- accessors (local_map.cpp:172-264)
    def get_keyframe(self) -> Keyframe:
        return self.keyframe

    def get_current_frame(self):
        return self.current_frame_ref

    def get_current_frame_pose(self) -> np.ndarray:
        return self.current_pose.copy()

    def get_frame_number(self) -> int:
        return len(self.timestamps)

    def set_keyframe_pose(self, pose: np.ndarray):
        """local_map.cpp:187-202: move the keyframe estimate and re-chain every
        vertex connected by a keyframe edge."""
        self.estimates[0] = np.linalg.inv(pose)
        for (i, j, r) in self.edges:
            if i == 0:
                self.estimates[j] = self._chain_estimate(r.transform)

    def set_last_map(self):
        self.last_map = True

    def set_last_keyframe(self, kf: Keyframe):
        self.last_keyframe = kf

    def optimized_relative_poses(self) -> List[Tuple[str, np.ndarray]]:
        """Per non-keyframe vertex: (timestamp, kf->frame relative pose) from
        the estimates (keyframe_graph.cpp:1769-1777)."""
        pose_kf = np.linalg.inv(self.estimates[0])
        out = []
        for v in range(1, len(self.timestamps)):
            pose_v = np.linalg.inv(self.estimates[v])
            out.append((self.timestamps[v], np.linalg.inv(pose_kf) @ pose_v))
        return out

    def edge_record(self) -> dict:
        """Compact copy of this map's graph for the post-backend frame-list
        bridging pass: vertex timestamps plus every edge's (i, j,
        measurement, information)."""
        return dict(
            timestamps=list(self.timestamps),
            edges=[(i, j, np.asarray(r.transform, np.float64).copy(),
                    np.asarray(r.information, np.float64).copy())
                   for (i, j, r) in self.edges])

    def keyframe_to_next_result(self) -> TrackingResult:
        """The kf->last-frame keyframe-edge result (used as the inter-keyframe
        edge when this map completes, keyframe_graph.cpp:1753-1763)."""
        last = len(self.timestamps) - 1
        for (i, j, r) in self.edges:
            if i == 0 and j == last:
                return r
        raise RuntimeError("no keyframe edge to last vertex")
