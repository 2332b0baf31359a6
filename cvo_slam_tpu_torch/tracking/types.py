"""Host-side tracking data types (port of cvo_slam_tpu.tracking.types).

Mirrors the reference payload structs: tracking_result
(reference include/tracking_result.h:19-93), Frame
(include/frame.h:16-31) and Keyframe (include/keyframe.h:31-137).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..cvo.engine import PointCloud


@dataclass
class TrackingResult:
    """Per-edge measurement payload (tracking_result.h)."""
    transform: np.ndarray = None            # (4,4) relative transform
    information: np.ndarray = None          # (6,6)
    post_hessian: np.ndarray = None         # (6,6)
    inn_pre: float = 0.0
    inn_post: float = 0.0
    inn_prior: float = 0.0
    inn_lc_prior: float = 0.0
    inn_fixed_pcd: float = 0.0
    inn_moving_pcd: float = 0.0
    # counted inner-product payload (cvo::inn_p.num, cvo.hpp:52-80): number
    # of point pairs passing both kernel gates, floored at 1 when empty
    # (function_inner_product, cvo.cpp:454-456). inn_p.num_e ("excluded") is
    # always 0 in the reference's active code and is not carried.
    inn_pre_num: int = 1
    inn_post_num: int = 1
    cos_angle: float = 0.0
    dis_to_keyframe: int = 0
    matches: int = 0
    score: float = 0.0
    inliers_svd: int = 0
    inliers_pnpransac: int = 0
    lc_prior: np.ndarray = None             # (4,4) ORB/RANSAC prior (LC edges)
    lc_prior_pnpransac: np.ndarray = None

    def __post_init__(self):
        if self.transform is None:
            self.transform = np.eye(4)
        if self.information is None:
            self.information = np.eye(6)
        if self.post_hessian is None:
            self.post_hessian = np.eye(6)
        if self.lc_prior is None:
            self.lc_prior = np.eye(4)
        if self.lc_prior_pnpransac is None:
            self.lc_prior_pnpransac = np.eye(4)

    @staticmethod
    def from_innerproduct(transform: np.ndarray, ip: dict) -> "TrackingResult":
        """Build from cvo.engine.compute_innerproduct output
        (local_tracker.cpp:375-385 semantics: information := post_hessian)."""
        H = np.asarray(ip["post_hessian"], np.float64)
        return TrackingResult(
            transform=np.asarray(transform, np.float64).copy(),
            information=H.copy(), post_hessian=H.copy(),
            inn_pre=float(ip["inn_pre"]), inn_post=float(ip["inn_post"]),
            inn_pre_num=max(int(ip.get("inn_pre_num", 1)), 1),
            inn_post_num=max(int(ip.get("inn_post_num", 1)), 1),
            inn_fixed_pcd=float(ip["inn_fixed"]),
            inn_moving_pcd=float(ip["inn_moving"]),
            cos_angle=float(ip["cos_angle"]))


@dataclass
class Frame:
    """Non-keyframe trajectory entry (frame.h:16-31)."""
    timestamp: str
    relative_pose: np.ndarray   # (4,4) w.r.t. owning keyframe


@dataclass
class Keyframe:
    """Keyframe payload (keyframe.h:31-137). ORB/BoW fields are populated by
    features.orb once phase 6 lands; the CVO-selected pixels are always kept
    (used for ORB gating and loop closure)."""
    id: int
    timestamp: str
    pose: np.ndarray                      # (4,4) cam->world
    cloud: Optional[PointCloud] = None    # CVO point cloud (device)
    selected_pixels: Optional[np.ndarray] = None   # (CAP,2) int32
    gray: Optional[np.ndarray] = None     # (H,W) uint8
    depth_m: Optional[np.ndarray] = None  # (H,W) float32 metric depth
    keypoints: Optional[np.ndarray] = None      # (K,3) x,y,octave (ORB)
    kp_angle: Optional[np.ndarray] = None       # (K,)
    descriptors: Optional[np.ndarray] = None    # (K,32) uint8
    bow_vec: Optional[dict] = None              # word id -> weight
    feat_vec: Optional[dict] = None             # node id -> kp index list
    bow_version: int = 0   # vocabulary version bow_vec/feat_vec were built at
    mappoints_id: Dict[int, int] = field(default_factory=dict)  # kp -> landmark
    best_covisible: List[int] = field(default_factory=list)
    frame_list: List[Frame] = field(default_factory=list)
    # compact copy of this keyframe's local-map graph (edge measurements +
    # information), kept for the post-backend frame-list bridging pass
    # (KeyframeGraph.refine_frame_lists) — an extension over the reference,
    # which freezes frame_list at insert time (keyframe_graph.cpp:1769-1777)
    map_record: Optional[dict] = None
