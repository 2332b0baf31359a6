"""Port parity, place recognition under aliasing (the port's counterpart of
tests/test_place_recognition.py): 43 keyframes from three aliased places
and a revisit of place 0 (cvo_slam_tpu_torch.eval.place_recognition), one
detect() of the port's loop detector on the CPU against the JAX package's
detector on keyframes made from the same renders."""

import numpy as np
import pytest
import torch

from cvo_slam_tpu.data import tum
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.eval import place_recognition as pr

torch.set_num_threads(2)


def _jax_accepts(views):
    """The JAX package's keyframes of the same views (its frontend, ORB
    hook and growing vocabulary) and its detector's accepted (reference,
    candidate) ids."""
    from cvo_slam_tpu.backend.loop_closure import make_loop_detector
    from cvo_slam_tpu.config import CameraConfig, FrontendParams, SlamConfig
    from cvo_slam_tpu.cvo.engine import PointCloud
    from cvo_slam_tpu.features.orb import KeyframeFeatureHook
    from cvo_slam_tpu.frontend.pointcloud import create_pointcloud
    from cvo_slam_tpu.tracking.types import Keyframe
    from test_place_recognition import StubGraph
    cam = CameraConfig(**{k: getattr(pr.CAM, k) for k in (
        "fx", "fy", "cx", "cy", "depth_factor", "width", "height")})
    fp = FrontendParams(num_want=pr.FRONTEND.num_want,
                        cloud_capacity=pr.FRONTEND.cloud_capacity)
    cfg = SlamConfig.default_shipped().replace(frontend=fp, LC_MinMatch=10)
    assert from_reference(cam) == pr.CAM and from_reference(cfg) == pr.config()
    hook = KeyframeFeatureHook(cam, cfg)
    keyframes = []
    for kf_id, v in enumerate(views):
        img = tum.load_image(v.folder, v.record)
        pc = create_pointcloud(img.bgr, img.gray, img.depth, cam, fp)
        kf = Keyframe(id=kf_id, timestamp=img.timestamp,
                      pose=np.asarray(v.pose, np.float64),
                      cloud=PointCloud.from_host(pc),
                      selected_pixels=pc.selected_pixels[:pc.count].copy(),
                      gray=img.gray,
                      depth_m=img.depth.astype(np.float32) / cam.depth_factor)
        hook(kf)
        keyframes.append(kf)
    detect = make_loop_detector(cam, cfg, vocabulary=hook.voc)
    graph = StubGraph(keyframes)
    detect(graph, keyframes[-1])
    return [(r, c) for r, c, _ in graph.accepted], hook.voc.version


@pytest.mark.slow
def test_place_recognition_matches_jax(tmp_path):
    """The JAX test's bars on the port's detector (at least one accepted
    edge to place 0, none to the decoys, the vocabulary retrained at least
    4 times with stale BoW refreshed), and the same accepted edges as the
    JAX package's detector."""
    views = pr.render(str(tmp_path))
    keyframes, hook = pr.build_keyframes(views, "cpu")
    assert len(keyframes) >= 40
    assert hook.voc.version >= 4
    assert any(kf.bow_version != hook.voc.version for kf in keyframes[:10])
    from cvo_slam_tpu_torch.backend.loop_closure import make_loop_detector
    detect = make_loop_detector(pr.CAM, pr.config(), vocabulary=hook.voc)
    graph = pr.StubGraph(keyframes)
    new_lc, farthest = detect(graph, keyframes[-1])
    accepted = [(r, c) for r, c, _ in graph.accepted]
    true = [c for _, c in accepted if views[c].place == 0]
    false = [c for _, c in accepted if views[c].place != 0]
    assert len(true) >= 1, "the revisit of place 0 was not recognized"
    assert not false, f"false loop closures against decoy places: {false}"
    assert new_lc == len(accepted)
    assert farthest == min(true)
    want, version = _jax_accepts(views)
    assert version == hook.voc.version
    assert accepted == want
