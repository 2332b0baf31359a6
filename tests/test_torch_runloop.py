"""The port's single-card run loop (CPU): the async backend
(parallel.async_backend, UseMultiThreading), speculative frame dispatch
(tracking.local_tracker.SpeculativeExecutor), the device best-two
descriptor matcher, the pipelined loop-closure verification, the kernel
warmup and --profile-dir; the matcher against the JAX package's host
matcher. The `gpu` tests run the same checks on a card."""

import json
import logging
import os
import shutil
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from cvo_slam_tpu.config import FrontendParams
from cvo_slam_tpu.features.matcher import match_bow as jmatch_bow
from cvo_slam_tpu.tracking.types import Keyframe as JKeyframe
from cvo_slam_tpu_torch.app import run_slam as trun
from cvo_slam_tpu_torch.backend import loop_closure
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.data import synthetic, tum
from cvo_slam_tpu_torch.features import matcher
from cvo_slam_tpu_torch.parallel.async_backend import AsyncKeyframeGraph
from cvo_slam_tpu_torch.tracking import local_tracker
from cvo_slam_tpu_torch.tracking.types import Keyframe
from test_torch_slam import CAM, CFG, _loop_trajectory

torch.set_num_threads(2)
# tests/test_torch_slam.py's configuration at CAP 384: these tests compare
# the port with itself, so the decisions need no margin from the JAX
# package's, and its walk still accepts loop-closure edges
SMALL_CFG = from_reference(CFG.replace(
    frontend=FrontendParams(num_want=300, cloud_capacity=384)))


class _Inline:
    """device.StreamWorker stand-in that runs each call when it is
    submitted: the sequential order (RANSAC k, verify k, RANSAC k+1)."""

    def __init__(self, device, name):
        pass

    def submit(self, fn, *args):
        fut = Future()
        fut.set_result(fn(*args))
        return fut


def _slam(folder, cfg, device):
    """The whole system frame by frame with the run loop's lookahead:
    (keyframes as (id, timestamp, pose), loop_closure.txt rows, the
    loop-closure stage rows)."""
    tracker = trun.build_tracker(from_reference(CAM), cfg, device=device)
    tracker.init()
    records = tum.load_association(os.path.join(folder, "associate.txt"))
    images = [tum.load_image(folder, r) for r in records]
    for i, img in enumerate(images):
        if i == len(images) - 1:
            tracker.force_keyframe()
        tracker.update(img, next_frame=images[i + 1]
                       if i + 1 < len(images) else None)
    tracker.write_slam_trajectory_and_loop_closure(
        os.path.join(folder, "SLAM_trajectory.txt"),
        os.path.join(folder, "loop_closure.txt"))
    kfs = [(kf.id, kf.timestamp, kf.pose.copy())
           for kf in tracker.graph.keyframes()]   # flushes an async graph
    with open(os.path.join(folder, "loop_closure.txt")) as f:
        rows = f.read().splitlines()
    stages = list(tracker.graph.lc_stage_ms)
    if cfg.UseMultiThreading:
        assert isinstance(tracker.graph, AsyncKeyframeGraph)
        tracker.graph.close()
    return kfs, rows, stages


def _walk_runs(base, device):
    """tests/test_torch_slam.py's out-and-back walk (its accept decisions
    sit clear of their margins) run twice: synchronously with the
    verifications in the sequential order, and with UseMultiThreading
    (the backend on its worker thread) with the pipelined verification."""
    src = os.path.join(base, "walk")
    synthetic.make_sequence(src, from_reference(CAM),
                            trajectory=_loop_trajectory())
    out = {}
    for mode, mt in (("sequential", False), ("async", True)):
        folder = os.path.join(base, mode)
        shutil.copytree(src, folder)
        cfg = SMALL_CFG.replace(UseMultiThreading=mt)
        with pytest.MonkeyPatch.context() as mp:
            if not mt:
                mp.setattr(loop_closure, "StreamWorker", _Inline)
            out[mode] = _slam(folder, cfg, device)
    return out


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    return _walk_runs(str(tmp_path_factory.mktemp("runloop")), "cpu")


def _assert_same_keyframes(got, want, atol):
    assert len(got) == len(want) >= 3
    for (i1, t1, p1), (i2, t2, p2) in zip(want, got):
        assert (i1, t1) == (i2, t2)
        np.testing.assert_allclose(p2, p1, rtol=0, atol=atol)


def test_async_matches_sync(walk):
    """UseMultiThreading: the same keyframes (ids and timestamps) as the
    synchronous run, poses within 1e-8 (tests/test_async_backend.py's
    bar)."""
    _assert_same_keyframes(walk["async"][0], walk["sequential"][0], 1e-8)


def test_pipelined_verify_matches_sequential(walk):
    """The pipelined loop-closure verification (each candidate issued to
    the worker as its RANSAC passes) writes the same loop_closure.txt rows
    as verifying each candidate right after its RANSAC, at least one
    accepted edge among them; every round records the overlap."""
    _, want, want_stages = walk["sequential"]
    _, got, got_stages = walk["async"]
    assert got == want and len(want) >= 1
    assert [r["n_cands"] for r in got_stages] \
        == [r["n_cands"] for r in want_stages]
    assert all({"ransac", "verify", "overlap"} <= set(r) for r in got_stages)


def test_async_propagates_errors():
    """A failure on the backend thread surfaces at flush, and at close."""
    class Boom:
        def add(self, m):
            raise ValueError("backend exploded")

    g = AsyncKeyframeGraph(Boom(), "cpu")
    g.add(object())
    with pytest.raises(RuntimeError) as err:
        g.flush()
    assert isinstance(err.value.__cause__, ValueError)
    g.add(object())
    with pytest.raises(RuntimeError):
        g.close()


def test_speculative_executor_matches_unpipelined(tmp_path, monkeypatch):
    """Tracking with the one-frame lookahead and CVO_SLAM_SPECULATE=1
    equals the run without speculation bit for bit, and at least one
    speculation was consumed (tests/test_pipeline.py:107)."""
    folder = str(tmp_path)
    cam = from_reference(CAM)
    synthetic.make_sequence(folder, cam, n_frames=8)
    cfg = SMALL_CFG.replace(OnlyTracking=True, Max_KF_interval=20)
    images = [tum.load_image(folder, r) for r in tum.load_association(
        os.path.join(folder, "associate.txt"))]

    def track(speculate):
        monkeypatch.setenv("CVO_SLAM_SPECULATE", speculate)
        tracker = trun.build_tracker(cam, cfg, device="cpu")
        tracker.init()
        poses = []
        for i, img in enumerate(images):
            if i == len(images) - 1:
                tracker.force_keyframe()
            nxt = images[i + 1] if i + 1 < len(images) else None
            poses.append(tracker.update(img, next_frame=nxt))
        return np.array(poses), tracker.lt.executor

    plain, ex0 = track("0")
    piped, ex1 = track("1")
    np.testing.assert_array_equal(plain, piped)
    assert not ex0.enabled and ex0.hits == 0
    assert ex1.enabled and ex1.hits >= 1
    assert ex1.hits + ex1.misses == ex0.misses == len(images) - 2


def test_speculation_switch(monkeypatch):
    """On by default on a CUDA device, off on the CPU; CVO_SLAM_SPECULATE
    forces it either way."""
    monkeypatch.delenv("CVO_SLAM_SPECULATE", raising=False)
    assert local_tracker.speculation_enabled(torch.device("cuda"))
    assert not local_tracker.speculation_enabled("cpu")
    monkeypatch.setenv("CVO_SLAM_SPECULATE", "0")
    assert not local_tracker.speculation_enabled("cuda")
    monkeypatch.setenv("CVO_SLAM_SPECULATE", "1")
    assert local_tracker.speculation_enabled("cpu")


def _match_keyframes(n1, n2, seed=3):
    """tests/test_features.py:232's keyframe pair in both packages' types:
    low-entropy descriptors (many distance ties), a multi-bucket
    FeatureVector with uneven splits, a node only on the reference side
    and a single-descriptor bucket."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 4, (n1, 32)).astype(np.uint8)
    d2 = rng.integers(0, 4, (n2, 32)).astype(np.uint8)

    def kf(desc, n, nodes):
        angle = rng.uniform(0, 360, n)
        cuts = np.sort(rng.choice(np.arange(1, n), len(nodes) - 1,
                                  replace=False))
        parts = np.split(np.arange(n), cuts)
        fv = {node: parts[j].tolist() for j, node in enumerate(nodes)}
        out = []
        for cls in (Keyframe, JKeyframe):
            k = cls(id=0, timestamp="0", pose=np.eye(4))
            k.descriptors, k.kp_angle = desc, angle
            k.feat_vec = {node: list(v) for node, v in fv.items()}
            out.append(k)
        return out

    (ref, jref), (cur, jcur) = kf(d1, n1, [0, 2, 5, 9]), \
        kf(d2, n2, [0, 2, 7, 11])
    for k in (cur, jcur):
        k.feat_vec[5] = [int(k.feat_vec[7][0])]
    return ref, cur, jref, jcur


def test_device_match_bow_parity(monkeypatch):
    """The device best-two matcher (run on the CPU with force=True) gives
    the host match_bow's pairs exactly, and the JAX package's; without
    force the CPU, a small problem or CVO_SLAM_DEV_MATCH=0 take the host
    path."""
    ref, cur, jref, jcur = _match_keyframes(700, 650)
    host = matcher.match_bow(ref, cur, 0.7)
    fut = matcher.dispatch_match_bow(ref, cur, "cpu", force=True)
    dev = matcher.fetch_match_bow(fut, ref, cur, 0.7)
    assert len(host) > 0 and host.dtype == dev.dtype
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(host, jmatch_bow(jref, jcur, 0.7))
    assert matcher.dispatch_match_bow(ref, cur, "cpu") is None
    # 700 x 650 pairs in the buckets are below DEV_MIN_PAIRS
    assert matcher.dispatch_match_bow(ref, cur, torch.device("cuda")) is None
    monkeypatch.setenv("CVO_SLAM_DEV_MATCH", "0")
    assert matcher.dispatch_match_bow(ref, cur, torch.device("cuda")) is None


def test_profile_dir_writes_trace(tmp_path):
    """run(profile_dir=) writes the frame loop's torch.profiler trace."""
    folder = str(tmp_path / "seq")
    cam = from_reference(CAM)
    synthetic.make_sequence(folder, cam, n_frames=2)
    cfg = SMALL_CFG.replace(OnlyTracking=True)
    prof = str(tmp_path / "prof")
    stats = trun.run(folder, "associate.txt", cam, cfg, device="cpu",
                     profile_dir=prof)
    assert stats["frames"] == 2
    with open(os.path.join(prof, "trace.json")) as f:
        trace = json.load(f)
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])


def test_warmup_logs_build_failure(monkeypatch, caplog):
    """A failed kernel build in the warmup is logged with its traceback,
    not swallowed (the first kernel call raises it again)."""
    def broken(source):
        raise RuntimeError("nvcc failed for ip_suite.cu")

    monkeypatch.setattr(trun.cuda_build, "load", broken)
    with caplog.at_level(logging.ERROR):
        trun._warm_kernels()
    rec = [r for r in caplog.records if r.name == trun.log.name]
    assert len(rec) == 1 and rec[0].exc_info is not None
    assert "nvcc failed" in str(rec[0].exc_info[1])


def test_launch_counter_is_thread_safe():
    """The kernel wrappers count launches from the tracker's thread and the
    pipelines' workers: concurrent counting loses no launch."""
    import sys
    import threading
    from cvo_slam_tpu_torch.cvo import kernels
    info = kernels.KernelInfo("stress", "none.cu", "none")
    n_threads, n_each = 2 * (os.cpu_count() or 4), 2000

    def count():
        for _ in range(n_each):
            info.count_launch()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert info.launches == n_threads * n_each


# -- on the card -------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check")


@pytest.mark.gpu
def test_device_matcher_cuda_matches_host():
    """On a card, at ORB 5000 scale (above DEV_MIN_PAIRS, no force): the
    device matcher's pairs equal the host match_bow's."""
    _need_card()
    ref, cur, _, _ = _match_keyframes(5000, 4800, seed=11)
    fut = matcher.dispatch_match_bow(ref, cur, torch.device("cuda"))
    assert fut is not None
    np.testing.assert_array_equal(
        matcher.fetch_match_bow(fut, ref, cur, 0.7),
        matcher.match_bow(ref, cur, 0.7))


@pytest.mark.gpu
def test_speculation_cuda_bitwise(tmp_path, monkeypatch):
    """On a card, under the pallas backend: speculation on (its default
    there) equals speculation off bit for bit, with hits."""
    _need_card()
    monkeypatch.setenv("CVO_SLAM_BACKEND", "pallas")
    folder = str(tmp_path)
    cam = from_reference(CAM)
    synthetic.make_sequence(folder, cam, n_frames=8)
    cfg = SMALL_CFG.replace(OnlyTracking=True, Max_KF_interval=20)
    runs = {}
    for speculate in ("0", ""):
        monkeypatch.setenv("CVO_SLAM_SPECULATE", speculate)
        stats = trun.run(folder, "associate.txt", cam, cfg, device="cuda")
        runs[speculate] = (tum.read_trajectory(os.path.join(
            folder, "Tracking_trajectory.txt"))[1], stats["speculation"])
    np.testing.assert_array_equal(runs[""][0], runs["0"][0])
    assert runs[""][1]["enabled"] and runs[""][1]["hits"] >= 1


@pytest.mark.gpu
def test_pipelined_verify_cuda_matches_sequential(tmp_path):
    """On a card: the async backend with the pipelined verification
    against the synchronous, sequential run of the same walk."""
    _need_card()
    runs = _walk_runs(str(tmp_path), "cuda")
    _assert_same_keyframes(runs["async"][0], runs["sequential"][0], 1e-8)
    assert runs["async"][1] == runs["sequential"][1]
