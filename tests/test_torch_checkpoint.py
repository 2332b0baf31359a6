"""The port's session checkpoint (cvo_slam_tpu_torch.data.checkpoint),
tests/test_checkpoint.py run through the port on the CPU: an interrupted
and resumed run reproduces the uninterrupted trajectory, and the whole
system's graph state survives a save and load."""

import os

import numpy as np
import pytest
import torch

from cvo_slam_tpu.config import FrontendParams, SlamConfig
from cvo_slam_tpu_torch.app.run_slam import build_tracker
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.data import checkpoint, synthetic, tum
from test_torch_tracking import CAM

torch.set_num_threads(2)
# CAP 384: the port against itself needs no parity margin
SMALL_FRONTEND = FrontendParams(num_want=300, cloud_capacity=384)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("ckpt_seq"))
    synthetic.make_sequence(folder, from_reference(CAM), n_frames=8)
    records = tum.load_association(os.path.join(folder, "associate.txt"))
    return [tum.load_image(folder, r) for r in records]


def _resume_matches(frames, cfg, ck, device):
    """Poses of an uninterrupted run, and of a run saved after 4 frames
    and resumed in a fresh tracker from the checkpoint file `ck`."""
    cam = from_reference(CAM)
    t_ref = build_tracker(cam, cfg, device=device)
    t_ref.init()
    poses_ref = [t_ref.update(f) for f in frames]
    t_a = build_tracker(cam, cfg, device=device)
    t_a.init()
    poses_a = [t_a.update(f) for f in frames[:4]]
    checkpoint.save_session(t_a, ck)
    t_b = checkpoint.load_session(ck, cam, cfg, device=device)
    assert t_b.lt.cvo_odometry.fixed.positions.device.type == device
    poses_b = [t_b.update(f) for f in frames[4:]]
    return np.array(poses_ref), np.array(poses_a + poses_b)


def test_resume_matches_uninterrupted(seq, tmp_path):
    """Tracking: resume equals the uninterrupted run within 1e-9
    (tests/test_checkpoint.py's bar)."""
    cfg = from_reference(SlamConfig.default_shipped().replace(
        OnlyTracking=True, frontend=SMALL_FRONTEND))
    want, got = _resume_matches(seq, cfg, str(tmp_path / "session.ckpt"),
                                "cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_checkpoint_full_pipeline_roundtrip(seq, tmp_path):
    """The whole system saved after 6 frames: keyframes, edges and the
    vocabulary survive the round trip, and the resumed tracker and the
    saved one, both run to the end of the sequence, end with the same
    keyframes (poses within 1e-9) and loop-closure rows."""
    cfg = from_reference(SlamConfig.default_shipped().replace(
        FinalOptimizationIterations=10, frontend=SMALL_FRONTEND))
    t = build_tracker(from_reference(CAM), cfg, device="cpu")
    t.init()
    for f in seq[:6]:
        t.update(f)
    ck = str(tmp_path / "full.ckpt")
    checkpoint.save_session(t, ck)
    t2 = checkpoint.load_session(ck, from_reference(CAM), cfg, device="cpu")
    assert len(t2.graph.keyframes()) == len(t.graph.keyframes())
    assert len(t2.graph.edges) == len(t.graph.edges)
    voc, voc2 = t.lt.keyframe_feature_hook.voc, t2.lt.keyframe_feature_hook.voc
    assert voc2.version == voc.version
    for a, b in zip(t.graph.keyframes(), t2.graph.keyframes()):
        assert (a.id, a.timestamp, a.bow_vec) == (b.id, b.timestamp,
                                                  b.bow_vec)
        np.testing.assert_array_equal(a.pose, b.pose)
        assert torch.equal(a.cloud.positions, b.cloud.positions)
    for tracker in (t, t2):
        for f in seq[6:]:
            if f is seq[-1]:
                tracker.force_keyframe()
            tracker.update(f)
    want, got = t.graph.keyframes(), t2.graph.keyframes()
    assert len(got) == len(want) >= 3
    for a, b in zip(want, got):
        assert (a.id, a.timestamp) == (b.id, b.timestamp)
        np.testing.assert_allclose(b.pose, a.pose, rtol=0, atol=1e-9)
    assert t2.graph.loop_closure_rows() == t.graph.loop_closure_rows()


def test_load_rejects_other_format(tmp_path):
    """A file of another format version is refused, not half-read."""
    import pickle
    ck = str(tmp_path / "old.ckpt")
    with open(ck, "wb") as f:
        pickle.dump(dict(version=checkpoint.FORMAT_VERSION + 1), f)
    with pytest.raises(ValueError, match="format"):
        checkpoint.load_session(ck, from_reference(CAM), from_reference(
            SlamConfig.default_shipped()), device="cpu")


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_resume_matches_uninterrupted_cuda(seq, tmp_path, monkeypatch):
    """On a card, under the pallas backend: resume equals the
    uninterrupted run bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check")
    monkeypatch.setenv("CVO_SLAM_BACKEND", "pallas")
    cfg = from_reference(SlamConfig.default_shipped().replace(
        OnlyTracking=True, frontend=SMALL_FRONTEND))
    want, got = _resume_matches(seq, cfg, str(tmp_path / "session.ckpt"),
                                "cuda")
    np.testing.assert_array_equal(got, want)
