"""Port parity, lockstep tracking: cvo_slam_tpu_torch.parallel.multi_sequence
on the CPU against the port's own solo runs (exactly) and against the JAX
package's MultiSequenceTracker (backend xla), on the three 6-frame 160x120
sequences of tests/test_multi_sequence.py."""

import os

import numpy as np
import pytest
import torch

from cvo_slam_tpu.config import SlamConfig
from cvo_slam_tpu.data import synthetic, tum
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import engine as tengine
from cvo_slam_tpu_torch.cvo import kernels
from cvo_slam_tpu_torch.data import tum as ttum
from cvo_slam_tpu_torch.parallel import batch, multi_sequence
from test_torch_tracking import CAM, SMALL_FRONTEND, _rot_angle

torch.set_num_threads(2)
N_FRAMES = 6
TWISTS = [np.array([0.004, -0.006, 0.003, 0.010, -0.006, 0.008]),
          np.array([-0.003, 0.005, -0.002, -0.008, 0.009, -0.006]),
          np.array([0.002, 0.003, -0.004, 0.006, 0.004, 0.010])]
# Against the JAX package's lockstep (xla). Its own vmapped batch sums in
# another order than its solo dispatch, which drifts its lockstep poses
# from its solo runs by ~1e-3 over a few frames and with the batch size
# (tests/test_multi_sequence.py holds them at 2e-3): measured on the CPU,
# the first two sequences' lockstep (S = 2) differ from the same
# sequences' in the lockstep of all three by up to 1.4e-3 rad. Its own
# pallas (interpret mode) and xla differ per alignment by up to 24
# iterations, and in total iterations per sequence by up to 12%. The
# per-alignment iteration count is not a stable quantity here (the
# discontinuous sparsification gate, ROADMAP queue 3), so the port is held
# within the reference's own spread: total iterations per sequence within
# 10%, poses within tests/test_multi_sequence.py's 2e-3 (m and rad), the
# keyframe decisions equal.
JAX_BARS = dict(total=0.1, pos=2e-3, rot=2e-3)
# A decision whose inner-product ratio lies this close to FE_InnpThreshold
# in the reference flips under last-bit changes of the align (sequence 2,
# frame 3: 0.6968 in the JAX package, 0.7016 in the port, threshold 0.7);
# each sequence is compared up to its first such frame, which starts
# another local map in one run and not in the other.
KNIFE_EDGE = 0.01


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    folders = []
    for k, tw in enumerate(TWISTS):
        folder = str(tmp_path_factory.mktemp(f"mseq{k}"))
        synthetic.make_sequence(folder, CAM, n_frames=N_FRAMES, seed=10 + k,
                                step_twist=tw)
        folders.append(folder)
    return folders


def _frames(folder, load_association, load_image):
    return [load_image(folder, r) for r in load_association(
        os.path.join(folder, "associate.txt"))[:N_FRAMES]]


def _row(tracker, pose, evaluation=None):
    lt = tracker.lt
    ratio = None
    if evaluation is not None and "kf_inn_post" in lt.metrics:
        ratio = lt.metrics["kf_inn_post"] / evaluation.inn_post
    return dict(pose=np.asarray(pose, np.float64),
                accept=lt.metrics.get("accept"),
                odo_iters=lt.cvo_odometry.iters,
                kf_iters=lt.cvo_keyframe.iters, ratio=ratio)


def _lockstep(mst, frames, force_last=False):
    """Per sequence, per frame: pose, keyframe decision and its
    inner-product ratio, iterations."""
    rows = [[] for _ in frames]
    for k in range(len(frames[0])):
        if force_last and k == len(frames[0]) - 1:
            mst.force_keyframe()
        evaluations = [t.evaluation for t in mst.trackers]
        poses = mst.update([f[k] for f in frames])
        for s, pose in enumerate(poses):
            rows[s].append(_row(mst.trackers[s], pose, evaluations[s]))
    return rows


def _solo(build, frames, force_last=False):
    rows = []
    for seq in frames:
        t = build()
        t.init()
        out = []
        for k, fr in enumerate(seq):
            if force_last and k == len(seq) - 1:
                t.force_keyframe()
            ev = t.evaluation
            out.append(_row(t, t.update(fr), ev))
        rows.append((out, t))
    return rows


def _cfg(**kw):
    return SlamConfig.default_shipped().replace(frontend=SMALL_FRONTEND,
                                               **kw)


def jax_lockstep(folders):
    """The JAX package's lockstep run (backend xla), OnlyTracking."""
    from cvo_slam_tpu.parallel.multi_sequence import MultiSequenceTracker
    frames = [_frames(f, tum.load_association, tum.load_image)
              for f in folders]
    mst = MultiSequenceTracker(CAM, _cfg(OnlyTracking=True),
                               n_seq=len(frames), backend="xla")
    return _lockstep(mst, frames)


_port_runs = {}


def port_runs(folders, backend):
    """The port's lockstep run on `backend` and its solo runs on the
    backend a batch routes it to (batch._batch_backend: pallas_mom's lanes
    are xla lanes, as in the JAX package), on the CPU with speculation off
    as lockstep has it; made once per backend and sequences."""
    key = (backend, tuple(folders))
    if key not in _port_runs:
        from cvo_slam_tpu_torch.app.run_slam import build_tracker
        frames = [_frames(f, ttum.load_association, ttum.load_image)
                  for f in folders]
        cam = from_reference(CAM)
        cfg = from_reference(_cfg(OnlyTracking=True))
        mst = multi_sequence.MultiSequenceTracker(cam, cfg, len(frames),
                                                  backend=backend,
                                                  device="cpu")
        got = _lockstep(mst, frames)
        with pytest.MonkeyPatch.context() as m:
            m.setenv("CVO_SLAM_BACKEND", batch._batch_backend(backend))
            m.setenv("CVO_SLAM_SPECULATE", "0")
            solo = _solo(lambda: build_tracker(cam, cfg, device="cpu"),
                         frames)
        _port_runs[key] = (got, [r for r, _ in solo], mst.rounds)
    return _port_runs[key]


def check_equals_solo(got, solo, rounds):
    """Every pose, keyframe decision and iteration count of the lockstep
    run equal to the solo run's, bit for bit; one frame round per tracked
    frame, one bootstrap round."""
    for s, (g_seq, w_seq) in enumerate(zip(got, solo)):
        for k, (g, w) in enumerate(zip(g_seq, w_seq)):
            assert np.array_equal(g["pose"], w["pose"]), (s, k)
            for key in ("accept", "odo_iters", "kf_iters"):
                assert g[key] == w[key], (s, k, key)
    assert rounds == {"frame": N_FRAMES - 2, "align_ip": 1, "align": 0,
                      "ip": 0}, rounds


def check_matches_jax(got, want, threshold):
    """The port's lockstep rows against the JAX package's: each sequence up
    to its first knife-edge decision (KNIFE_EDGE), the decisions equal,
    poses and total iterations within JAX_BARS. Returns the frames held."""
    held = 0
    for s, (g_seq, w_seq) in enumerate(zip(got, want)):
        total_g = total_w = 0
        for k, (g, w) in enumerate(zip(g_seq, w_seq)):
            if w["ratio"] is not None \
                    and abs(w["ratio"] - threshold) < KNIFE_EDGE:
                break
            held += 1
            assert g["accept"] == w["accept"], (s, k)
            total_g += g["odo_iters"] + g["kf_iters"]
            total_w += w["odo_iters"] + w["kf_iters"]
            np.testing.assert_allclose(g["pose"][:3, 3], w["pose"][:3, 3],
                                       atol=JAX_BARS["pos"],
                                       err_msg=f"seq {s} frame {k}")
            assert _rot_angle(g["pose"][:3, :3], w["pose"][:3, :3]) \
                < JAX_BARS["rot"], (s, k)
        assert abs(total_g - total_w) <= JAX_BARS["total"] * total_w, \
            (s, total_g, total_w)
    return held


@pytest.fixture(scope="module")
def jax_rows(sequences):
    return jax_lockstep(sequences)


def test_lockstep_equals_solo(sequences):
    """pallas: the lockstep run (align_fused and the suite as lanes) equals
    the three solo runs bit for bit."""
    check_equals_solo(*port_runs(sequences, "pallas"))


def test_lockstep_matches_jax(sequences, jax_rows):
    """pallas against the JAX package's lockstep (xla): decisions, poses
    and iterations within JAX_BARS, on at least two thirds of the frames
    (each sequence up to its first knife-edge decision)."""
    got, _, _ = port_runs(sequences, "pallas")
    held = check_matches_jax(got, jax_rows, _cfg().FE_InnpThreshold)
    assert held >= 2 * len(sequences) * N_FRAMES // 3, held


def test_batch_backend_routing(monkeypatch):
    """pallas and pallas_iter run as the lanes of one align_fused launch;
    pallas_mom and xla as one xla lane program (the JAX package's routing);
    unknown names raise. The executor and batched_align take the routed
    backend."""
    assert batch._batch_backend("pallas") == "pallas"
    assert batch._batch_backend("pallas_iter") == "pallas"
    assert batch._batch_backend("pallas_mom") == "xla"
    assert batch._batch_backend("xla") == "xla"
    with pytest.raises(ValueError):
        batch._batch_backend("bogus")
    assert multi_sequence._BatchExecutor(None, "pallas_iter").backend \
        == "pallas"
    assert multi_sequence._BatchExecutor(None, "pallas_mom").backend \
        == "xla"
    with pytest.raises(ValueError, match="lanes of one launch"):
        multi_sequence.MultiSequenceTracker(
            from_reference(CAM), from_reference(_cfg(OnlyTracking=True)),
            kernels.MAX_LANES + 1, device="cpu")
    calls = []
    lanes = kernels.align_fused_lanes
    monkeypatch.setattr(kernels, "align_fused_lanes",
                        lambda *a: calls.append(a[3].shape[0]) or lanes(*a))
    solo = []
    align = tengine.align
    monkeypatch.setattr(tengine, "align",
                        lambda *a: solo.append(a[-1]) or align(*a))
    programs = []
    loop_lanes = tengine.align_loop_lanes
    monkeypatch.setattr(tengine, "align_loop_lanes",
                        lambda f, y0, states, p: programs.append(len(states))
                        or loop_lanes(f, y0, states, p))
    rng = np.random.default_rng(0)
    pos = torch.as_tensor(rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32))
    feat = torch.as_tensor(rng.uniform(0, 1, (2, 64, 5)).astype(np.float32))
    mask = torch.ones((2, 64), dtype=torch.bool)
    cloud = tengine.PointCloud(pos, feat, mask)
    R0, T0 = torch.eye(3).expand(2, 3, 3), torch.zeros(2, 3)
    ell0 = torch.full((2,), 0.1)
    p = from_reference(SlamConfig.default_shipped()).cvo
    for backend, want in (("pallas_iter", ([2], [], [])),
                          ("pallas_mom", ([], [], [2]))):
        calls.clear()
        solo.clear()
        programs.clear()
        res = batch.batched_align(cloud, cloud, R0, T0, ell0, p, backend)
        assert (calls, solo, programs) == want, backend
        assert res.transform.shape == (2, 4, 4)


def test_executor_align_and_ip_requests_equal_solo():
    """The executor's align and ip rounds (the request kinds the trackers'
    repair paths yield) give each lane what the solo Cvo gives, bit for
    bit, and write the same state back."""
    rng = np.random.default_rng(2)
    p = from_reference(SlamConfig.default_shipped()).cvo

    def cloud(shift):
        pos = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
        pos[:, 2] += 2.0
        feat = rng.uniform(0, 1, (128, 5)).astype(np.float32)
        return (tengine.PointCloud(torch.as_tensor(pos),
                                   torch.as_tensor(feat),
                                   torch.ones(128, dtype=torch.bool)),
                tengine.PointCloud(torch.as_tensor(pos + shift),
                                   torch.as_tensor(feat),
                                   torch.ones(128, dtype=torch.bool)))

    pairs = [cloud(np.float32(0.01 * (k + 1))) for k in range(2)]
    pix = np.zeros((128, 2), np.int32)

    def cvos():
        out = []
        for fixed, _ in pairs:
            c = tengine.Cvo(p, backend="pallas")
            c.set_pcd(fixed, pix)
            out.append(c)
        return out

    ex = multi_sequence._BatchExecutor(p, "pallas")
    lanes, solo = cvos(), cvos()
    got = ex.run_align([("align", c, m, pix)
                        for c, (_, m) in zip(lanes, pairs)])
    for c, (_, m), T in zip(solo, pairs, got):
        c.set_pcd(m, pix)
        res = tengine.align(c.fixed, c.moving, c.R, c.T,
                            np.float32(c.start_ell()), p, "pallas")
        want = c._apply_align(*tengine.to_host(tuple(res)))
        assert np.array_equal(T, want)
    for a, b in zip(lanes, solo):
        assert (a.iters, a.nnz, a.ell) == (b.iters, b.nnz, b.ell)
        assert np.array_equal(a.R, b.R) and np.array_equal(a.T, b.T)
    tran = [np.eye(4, dtype=np.float32)] * 2
    got = ex.run_ip([("ip", c, t) for c, t in zip(lanes, tran)])
    for c, t, g in zip(solo, tran, got):
        want = c.compute_innerproduct(t)
        assert g.keys() == want.keys()
        for k in want:
            assert np.array_equal(g[k], want[k]), k


@pytest.mark.slow
def test_lockstep_full_pipeline_matches_independent(sequences):
    """With the backend on (per-sequence graphs: local-map LM, features,
    loop closure, BA), lockstep equals the solo runs: the same keyframe
    counts, poses within 5e-4 (tests/test_multi_sequence.py's bars)."""
    from cvo_slam_tpu_torch.app.run_slam import build_tracker
    cfg = from_reference(_cfg(Max_KF_interval=3,
                              FinalOptimizationIterations=20))
    cam = from_reference(CAM)
    frames = [_frames(f, ttum.load_association, ttum.load_image)
              for f in sequences[:2]]
    with pytest.MonkeyPatch.context() as m:
        m.setenv("CVO_SLAM_SPECULATE", "0")
        solo = _solo(lambda: build_tracker(cam, cfg, device="cpu"), frames,
                     force_last=True)
    mst = multi_sequence.MultiSequenceTracker(cam, cfg, 2, device="cpu")
    got = _lockstep(mst, frames, force_last=True)
    for s, (rows, tracker) in enumerate(solo):
        assert len(mst.trackers[s].graph.keyframes()) \
            == len(tracker.graph.keyframes())
        for k, (g, w) in enumerate(zip(got[s], rows)):
            np.testing.assert_allclose(g["pose"], w["pose"], atol=5e-4,
                                       err_msg=f"seq {s} frame {k}")
