"""Local pose graph: one fixed keyframe + tracked frames
(port of cvo_slam_tpu.tracking.local_map).

Re-expression of reference LocalMap (reference src/local_map.cpp):
a tiny pose graph with the keyframe vertex fixed, odometry edges
(prev -> cur) and keyframe edges (kf -> cur), each carrying a TrackingResult
and a Cauchy robust kernel (local_map.cpp:118-152). Pose bookkeeping:
current_pose = keyframe_pose * result.transform (local_map.cpp:231); vertex
estimates are inverse poses chained from the keyframe estimate (:230).

optimize() replicates g2o LM with OptimizationIterations iterations
(local_map.cpp:234-239) through backend.lm over fixed-capacity arrays on
the map's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..backend import lm
from ..config import SlamConfig
from .types import Keyframe, TrackingResult

# capacity: Max_KF_interval frames + keyframe (cfg.h Max_KF_interval=20 ->
# <= 22 vertices), the same padded shape as the JAX package's
MAX_VERTS = 24
MAX_EDGES = 48


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
    optimized: bool = False
    device: object = "cuda"                    # where optimize() solves

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

    # -- optimization (local_map.cpp:234-239)
    def optimize(self):
        n_v = len(self.timestamps)
        n_e = len(self.edges)
        assert n_v <= MAX_VERTS and n_e <= MAX_EDGES, "local map overflow"
        E = np.tile(np.eye(4, dtype=np.float32), (MAX_VERTS, 1, 1))
        E[:n_v] = np.array(self.estimates, np.float32)
        ei = np.zeros(MAX_EDGES, np.int64)
        ej = np.zeros(MAX_EDGES, np.int64)
        Z = np.tile(np.eye(4, dtype=np.float32), (MAX_EDGES, 1, 1))
        om = np.tile(np.eye(6, dtype=np.float32), (MAX_EDGES, 1, 1))
        for k, (i, j, r) in enumerate(self.edges):
            ei[k], ej[k] = i, j
            Z[k] = r.transform
            om[k] = r.information
        g = lm.pose_graph(E, np.arange(MAX_VERTS) == 0,
                          np.arange(MAX_VERTS) < n_v, ei, ej, Z, om,
                          np.arange(MAX_EDGES) < n_e, device=self.device)
        delta = self.cfg.RobustKernelDelta if self.cfg.UseRobustKernel else 0.0
        E_opt, _ = lm.optimize(g, self.cfg.OptimizationIterations,
                               robust_delta=delta)
        E_opt = E_opt.cpu().numpy().astype(np.float64)
        for v in range(n_v):
            self.estimates[v] = E_opt[v]
        self.optimized = True

    def optimized_relative_poses(self) -> List[Tuple[str, np.ndarray]]:
        """Per non-keyframe vertex: (timestamp, kf->frame relative pose) from
        the optimized estimates (keyframe_graph.cpp:1769-1777)."""
        pose_kf = np.linalg.inv(self.estimates[0])
        out = []
        for v in range(1, len(self.timestamps)):
            pose_v = np.linalg.inv(self.estimates[v])
            out.append((self.timestamps[v], np.linalg.inv(pose_kf) @ pose_v))
        return out

    def edge_record(self) -> dict:
        """Compact copy of this map's graph for the post-backend frame-list
        bridging pass (KeyframeGraph.refine_frame_lists): vertex timestamps
        plus every edge's (i, j, measurement, information)."""
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
