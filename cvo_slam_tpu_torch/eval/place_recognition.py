"""Place recognition under aliasing: the loop detector's precision and
recall on the scene of the JAX package's tests/test_place_recognition.py.

43 keyframes: 14 from each of three places whose textures and depths come
from one statistical family (seeds 100-102, the places 10 m apart in the
world), and a fresh render near the start of place 0 as the reference of
one `detect()` (backend/loop_closure.py: BoW retrieval, ORB RANSAC and the
CVO verification of the reference keyframe_graph.cpp:601-746). The
keyframes are built directly (render, cloud, ORB, BoW), not by SLAM, so
the run isolates place recognition; the growing vocabulary retrains
several times while they accumulate, so early keyframes carry stale BoW
vectors that detect() refreshes. The bars (the JAX test's): at least one
accepted edge to a place-0 keyframe and none to the decoy places.

`render` writes the sequences, `build_keyframes` makes the keyframes on a
device from them, `run` does both and one detect().
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..config import CameraConfig, FrontendParams, SlamConfig
from ..data import synthetic, tum

CAM = CameraConfig(fx=130.0, fy=130.0, cx=80.0, cy=60.0, depth_factor=5000.0,
                   width=160, height=120)
FRONTEND = FrontendParams(num_want=600, cloud_capacity=768)
N_PLACES = 3
KF_PER_PLACE = 14   # 42 keyframes and the revisit reference
STEP = np.array([0.002, -0.003, 0.002, 0.010, -0.007, 0.008])
REVISIT = (0.015, -0.01, 0.008)   # the reference's offset from place 0's start


def config() -> SlamConfig:
    return SlamConfig.default_shipped().replace(frontend=FRONTEND,
                                               LC_MinMatch=10)


@dataclass
class View:
    """One frame to make a keyframe of: its sequence folder, association
    record, world pose and place."""
    folder: str
    record: object
    pose: np.ndarray
    place: int


def render(root: str) -> List[View]:
    """Write the three places' sequences and the revisit under `root`;
    the views of the 43 keyframes in id order, the reference last."""
    views = []
    for p in range(N_PLACES):
        folder = os.path.join(root, f"place{p}")
        # distinct texture and geometry per place, one statistical family
        synthetic.make_sequence(folder, CAM, n_frames=KF_PER_PLACE,
                                seed=100 + p, randomize_depth=True,
                                step_twist=STEP)
        records = tum.load_association(os.path.join(folder, "associate.txt"))
        _, gt = tum.read_trajectory(os.path.join(folder, "groundtruth.txt"))
        offset = np.eye(4)
        offset[0, 3] = 10.0 * p          # places live far apart in the world
        views += [View(folder, rec, offset @ gt[k], p)
                  for k, rec in enumerate(records)]
    folder = os.path.join(root, "revisit")
    G_re = np.eye(4)
    G_re[:3, 3] = REVISIT
    synthetic.make_sequence(folder, CAM, seed=100, randomize_depth=True,
                            trajectory=[np.eye(4), G_re])
    records = tum.load_association(os.path.join(folder, "associate.txt"))
    views.append(View(folder, records[1], np.linalg.inv(G_re), 0))
    return views


class StubGraph:
    """The graph surface backend.loop_closure.detect uses."""

    def __init__(self, keyframes):
        self._keyframes = keyframes
        self.map_points = {}
        self.accepted = []

    def keyframes(self):
        return self._keyframes

    def log(self, msg):
        pass

    def insert_loop_closure(self, reference, cand, result):
        self.accepted.append((reference.id, cand.id, result))


def build_keyframes(views: List[View], device, cfg: SlamConfig = None):
    """The keyframes of `views` (id = index), their clouds on `device`:
    ORB, then the vocabulary step in id order (features.orb's hook and its
    bow). Returns (keyframes, hook)."""
    from ..cvo.engine import PointCloud
    from ..features.orb import KeyframeFeatureHook
    from ..frontend.pointcloud import create_pointcloud
    from ..tracking.types import Keyframe
    hook = KeyframeFeatureHook(CAM, cfg or config())
    keyframes = []
    for kf_id, v in enumerate(views):
        img = tum.load_image(v.folder, v.record)
        pc = create_pointcloud(img.bgr, img.gray, img.depth, CAM, FRONTEND)
        kf = Keyframe(id=kf_id, timestamp=img.timestamp,
                      pose=np.asarray(v.pose, np.float64),
                      cloud=PointCloud.from_host(pc, device),
                      selected_pixels=pc.selected_pixels[:pc.count].copy(),
                      gray=img.gray,
                      depth_m=img.depth.astype(np.float32) / CAM.depth_factor)
        hook(kf)
        hook.bow(kf)
        keyframes.append(kf)
    return keyframes, hook


def run(root: str, device) -> Dict[str, object]:
    """Render under `root`, build the keyframes on `device` and run one
    detect() with the last keyframe as the reference: the accepted
    (reference, candidate) ids, the true (place 0) and false accepts, what
    detect() returned, the vocabulary's version and whether early keyframes
    were stale before it."""
    from ..backend.loop_closure import make_loop_detector
    views = render(root)
    keyframes, hook = build_keyframes(views, device)
    reference = keyframes[-1]
    stale = any(kf.bow_version != hook.voc.version for kf in keyframes[:10])
    detect = make_loop_detector(CAM, config(), vocabulary=hook.voc)
    graph = StubGraph(keyframes)
    new_lc, farthest = detect(graph, reference)
    accepted = [(r, c) for r, c, _ in graph.accepted]
    return dict(keyframes=len(keyframes), accepted=accepted,
                true=[c for _, c in accepted if views[c].place == 0],
                false=[c for _, c in accepted if views[c].place != 0],
                new_lc=new_lc, farthest=farthest,
                voc_version=hook.voc.version, stale=stale)
