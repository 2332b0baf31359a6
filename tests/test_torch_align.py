"""Port parity, per-pair align layer: the plain versions of the flow /
step / flow_and_step / align_fused CUDA kernels (cvo_slam_tpu_torch.cvo.
kernels) and the port's `pallas` and `pallas_iter` align backends against
the JAX package's Pallas kernels (interpret mode) on the same numpy inputs
(CPU); tracking and run_odometry through both packages; the backend switch;
the build's header hashing.

The CUDA kernels run only on the card: the tests that launch them skip
here, and chip_smoke.py holds each against its plain version at the main
path's shapes."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import engine as jengine
from cvo_slam_tpu.cvo import pallas_align as pa
from cvo_slam_tpu.cvo import pallas_kernels as pk
from cvo_slam_tpu.ops import cubic as jcubic
from cvo_slam_tpu.ops import se3 as jse3
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import cuda_build, kernels
from cvo_slam_tpu_torch.cvo import engine as tengine
from cvo_slam_tpu_torch.ops import cubic, se3
from test_pairwise import make_clouds

torch.set_num_threads(2)
P = CvoParams()
TP = from_reference(P)
CAP = 256


def _clouds(seed, cap=CAP, n=200, m=180):
    """The tests/test_pallas.py fixture clouds as numpy arrays."""
    return make_clouds(seed, n, m, cap=cap)


def _torch(arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _port_args(arrays):
    """(x, y, fx, fy, mx, my) in the argument order of the flow kernels."""
    x, fx, mx, y, fy, my = _torch(arrays)
    return x, y, fx, fy, mx, my


def _jax_args(arrays):
    x, fx, mx, y, fy, my = _jax(arrays)
    return x, y, fx, fy, mx, my


def _close(got, want, rtol, atol, name):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=name)


# -- 1. the plain per-pair passes against the Pallas kernels ----------------

@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_flow_parity(ell):
    arrays = _clouds(0)
    with pltpu.force_tpu_interpret_mode():
        o_w, v_w, n_w = pk.flow(*_jax_args(arrays), jnp.float32(ell), P)
    o, v, n = kernels.flow(*_port_args(arrays), ell, TP)
    assert int(n) == int(n_w) > 0
    _close(o, o_w, 1e-4, 1e-6, "omega")
    _close(v, v_w, 1e-4, 1e-6, "v")


def test_step_coeffs_parity():
    ell = 0.10
    arrays = _clouds(1)
    rng = np.random.default_rng(2)
    omega = rng.normal(0, 0.1, 3).astype(np.float32)
    v = rng.normal(0, 0.1, 3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pk.step_coeffs(*_jax_args(arrays), jnp.asarray(omega),
                              jnp.asarray(v), jnp.float32(ell), P)
    got = kernels.step_coeffs(*_port_args(arrays), torch.as_tensor(omega),
                              torch.as_tensor(v), ell, TP)
    for name, g, w in zip("BCDE", got, want):
        _close(g, w, 2e-3, 1e-8, name)


@pytest.mark.parametrize("seed,ell", [(7, 0.12), (0, 0.15), (1, 0.06)])
def test_flow_and_step_parity(seed, ell):
    arrays = _clouds(seed)
    with pltpu.force_tpu_interpret_mode():
        want = pk.flow_and_step(*_jax_args(arrays), jnp.float32(ell), P)
    got = kernels.flow_and_step(*_port_args(arrays), ell, TP)
    assert int(got[2]) == int(want[2]) > 0
    _close(got[0], want[0], 1e-4, 1e-7, "omega")
    _close(got[1], want[1], 1e-4, 1e-7, "v")
    for name, g, w in zip("BCDE", got[3:], want[3:]):
        _close(g, w, 2e-3, 1e-8, name)


def test_flow_and_step_odd_capacity():
    """CAP 250 with a masked tail: the port takes it as is; the Pallas
    kernel sees the same clouds padded to 256 as engine._pad128 does."""
    arrays = _clouds(11, cap=250, n=230, m=210)
    padded = [np.pad(a, [(0, 6)] + [(0, 0)] * (a.ndim - 1)) for a in arrays]
    with pltpu.force_tpu_interpret_mode():
        want = pk.flow_and_step(*_jax_args(padded), jnp.float32(0.1), P)
    got = kernels.flow_and_step(*_port_args(arrays), 0.1, TP)
    assert int(got[2]) == int(want[2]) > 0
    for name, g, w in zip(("omega", "v"), got[:2], want[:2]):
        _close(g, w, 1e-4, 1e-7, name)
    for name, g, w in zip("BCDE", got[3:], want[3:]):
        _close(g, w, 2e-3, 1e-8, name)


def test_flow_and_step_is_its_halves():
    """The fused pass equals flow followed by step_coeffs, and masked slots
    contribute nothing."""
    arrays = _clouds(3)
    args = _port_args(arrays)
    o, v, n, *bcde = kernels.flow_and_step(*args, 0.1, TP)
    o2, v2, n2 = kernels.flow(*args, 0.1, TP)
    assert int(n) == int(n2)
    np.testing.assert_array_equal(o.numpy(), o2.numpy())
    np.testing.assert_array_equal(v.numpy(), v2.numpy())
    for g, w in zip(bcde, kernels.step_coeffs(*args, o, v, 0.1, TP)):
        assert float(g) == float(w)
    x, y, fx, fy, mx, my = [a.clone() for a in args]
    x[~mx] = 0.01
    y[~my] = 0.02
    for g, w in zip(kernels.flow_and_step(x, y, fx, fy, mx, my, 0.1, TP),
                    (o, v, n, *bcde)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# -- 2. the pallas / pallas_iter align against the JAX megakernel -----------

def _megakernel_clouds():
    """The CAP-512 fixture of test_pallas.test_align_megakernel_parity."""
    from cvo_slam_tpu.frontend.pointcloud import _morton_order
    cap, n = 512, 480
    rng = np.random.default_rng(3)
    z = rng.uniform(0.8, 3.0, n)
    xy = rng.uniform(-0.6, 0.6, (n, 2)) * z[:, None]
    pos = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    pos = pos[_morton_order(pos)]
    x = np.zeros((cap, 3), np.float32)
    x[:n] = pos
    f = np.zeros((cap, 5), np.float32)
    f[:n, :3] = rng.uniform(0, 255, (n, 3))
    m = np.zeros(cap, bool)
    m[:n] = True
    twist = np.array([0.01, -0.008, 0.005, 0.02, 0.01, -0.015], np.float32)
    T_gt = np.asarray(jse3.exp_se3(jnp.asarray(twist)))
    Ti = np.linalg.inv(T_gt)
    y = x.copy()
    y[:n] = (pos @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
    return (x, f, m), (y, f, m), T_gt


@pytest.fixture(scope="module")
def megakernel():
    """The JAX package's megakernel (interpret mode) on the fixture: a cold
    call from the identity and a warm call from its result."""
    (x, f, m), (y, _, _), T_gt = _megakernel_clouds()
    fixed = jengine.PointCloud(jnp.asarray(x), jnp.asarray(f), jnp.asarray(m))
    moving = jengine.PointCloud(jnp.asarray(y), jnp.asarray(f),
                                jnp.asarray(m))
    with pltpu.force_tpu_interpret_mode():
        cold = jengine.align(fixed, moving, jnp.eye(3), jnp.zeros(3),
                             jnp.float32(P.ell_init), P, "pallas")
        warm = jengine.align(fixed, moving, cold.R, cold.T, cold.ell, P,
                             "pallas")
    cold, warm = jax.device_get((tuple(cold), tuple(warm)))
    return (x, f, m), (y, f, m), T_gt, cold, warm


def _rigid_err(Ta, Tb):
    """Translation and rotation angle of Ta^-1 Tb; the angle from the skew
    part (arccos of the trace is blind below ~5e-4 rad for f32 rotations)."""
    E = np.linalg.inv(np.asarray(Ta, np.float64)) @ np.asarray(Tb, np.float64)
    D = E[:3, :3]
    ang = 0.5 * np.linalg.norm([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0],
                                D[1, 0] - D[0, 1]])
    return np.linalg.norm(E[:3, 3]), ang


@pytest.mark.parametrize("backend", ["pallas", "pallas_iter"])
def test_align_matches_megakernel(megakernel, backend):
    """Same iteration count, nnz and ell as the JAX megakernel, the
    transform within 1e-5 (metres and radians), on the cold and the
    warm-started call."""
    fixed_np, moving_np, T_gt, cold, warm = megakernel
    fixed = tengine.PointCloud(*_torch(fixed_np))
    moving = tengine.PointCloud(*_torch(moving_np))
    got = tengine.align(fixed, moving, np.eye(3, dtype=np.float32),
                        np.zeros(3, np.float32), np.float32(P.ell_init), TP,
                        backend)
    for g, w in ((got, cold),):
        assert int(g.iters) == int(w[4]) < P.max_iter
        assert int(g.nnz) == int(w[5])
        assert float(g.ell) == float(w[3])
        dt, da = _rigid_err(g.transform.numpy(), w[2])
        assert dt < 1e-5 and da < 1e-5, (dt, da)
    assert np.linalg.norm((np.linalg.inv(got.transform.numpy()) @ T_gt)
                          [:3, 3]) < 2e-3
    got2 = tengine.align(fixed, moving, torch.tensor(cold[0]),
                         torch.tensor(cold[1]), float(cold[3]), TP,
                         backend)
    assert int(got2.iters) == int(warm[4])
    assert int(got2.nnz) == int(warm[5])
    assert float(got2.ell) == float(warm[3])
    np.testing.assert_allclose(got2.transform.numpy(), warm[2], atol=1e-5)


def test_align_fused_plain_is_the_pallas_align():
    """engine.align(backend='pallas') on CPU tensors is align_fused_plain:
    the host loop over the plain per-pair pass."""
    fixed_np, moving_np, _ = _megakernel_clouds()
    x, fx, mx = _torch(fixed_np)
    y, fy, my = _torch(moving_np)
    R, T, ell, iters, nnz = kernels.align_fused(
        x, fx, mx, y, fy, my, torch.eye(3), torch.zeros(3),
        torch.tensor(0.15), TP)
    res = tengine.align(tengine.PointCloud(x, fx, mx),
                        tengine.PointCloud(y, fy, my), np.eye(3),
                        np.zeros(3), 0.15, TP, "pallas")
    assert int(iters) == int(res.iters) and int(nnz) == int(res.nnz)
    np.testing.assert_array_equal(R.numpy(), res.R.numpy())
    np.testing.assert_array_equal(T.numpy(), res.T.numpy())


# -- 3. the scalar epilogue --------------------------------------------------

def test_epilogue_scalars_match_megakernel():
    """The plain epilogue (ops/cubic, ops/se3) against the megakernel's
    scalar helpers at test_pallas.py's bars: the step root rtol/atol 2e-4;
    Exp_SEK3 and the se3 distance to f32 rounding."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        a, b, c, d = rng.normal(0, 1, 4).astype(np.float32)
        want = pa._min_pos_root(jnp.float32(a), jnp.float32(b),
                                jnp.float32(c), jnp.float32(d),
                                jnp.float32(0.2), jnp.float32(0.8))
        got = cubic.min_positive_root_or(
            *[torch.tensor(t) for t in (a, b, c, d)], 0.2, 0.8)
        _close(got, want, 2e-4, 2e-4, "step")
        assert float(jcubic.min_positive_root_or(a, b, c, d, 0.2, 0.8)) \
            == pytest.approx(float(got), rel=2e-4, abs=2e-4)
    for scale in (1e-8, 1e-3, 0.3):
        w = (rng.normal(0, 1, 3) * scale).astype(np.float32)
        v = (rng.normal(0, 1, 3) * scale).astype(np.float32)
        dt = np.float32(0.37)
        R_w, T_w = pa._exp_sek3_scalar(tuple(jnp.float32(t) for t in w),
                                       tuple(jnp.float32(t) for t in v),
                                       jnp.float32(dt))
        E = se3.exp_sek3(torch.as_tensor(np.concatenate([w, v])), float(dt))
        _close(E[:3, :3].reshape(9), np.array(R_w), 1e-6, 1e-7, "dR")
        _close(E[:3, 3], np.array(T_w), 1e-5, 1e-8, "dT")
        want = pa._dist_se3_scalar(tuple(jnp.float32(t) for t in
                                         np.asarray(E[:3, :3]).reshape(9)),
                                   tuple(jnp.float32(t) for t in
                                         np.asarray(E[:3, 3])))
        got = se3.dist_se3(E[:3, :3], E[:3, 3])
        _close(got, want, 1e-3, 1e-7, "dist")


# -- 4. tracking under the pallas backend ------------------------------------

# The per-pair align (pallas) and the moment-form align (xla) stop a few
# iterations apart (ROADMAP queue 3). On this sequence, per alignment
# against the JAX package's xla (measured on the CPU): the port's pallas
# differs by up to 6 iterations, 1.8e-4 m and 4.6e-4 rad (frame 6, after
# a keyframe align that ran 6 iterations longer); the JAX package's own
# pallas (interpret mode) by up to 3 iterations, 1.5e-4 m and 8.2e-5 rad;
# the port's pallas_mom by up to 2, 5.6e-5 m and 4.3e-5 rad (within
# tests/test_torch_tracking.py's bars). On the CAP-512 fixture above the
# port's pallas equals the JAX megakernel in iterations, nnz and ell.
PALLAS_BARS = dict(iters=8, pos=3e-4, rot=6e-4)

def test_tracking_pallas_matches_jax(tmp_path, monkeypatch):
    """Tracking-only SLAM on a 9-frame 160x120 sequence (CAP 768): the
    port's pallas backend against the JAX package's xla (which
    test_align_megakernel_parity shows equal to its pallas on its
    fixture): the same keyframe decisions; iterations and poses within
    PALLAS_BARS."""
    from cvo_slam_tpu.app import run_slam as jrun
    from cvo_slam_tpu.config import SlamConfig
    from cvo_slam_tpu.data import synthetic, tum
    from cvo_slam_tpu_torch.app import run_slam as trun
    from cvo_slam_tpu_torch.data import tum as ttum
    from test_torch_tracking import (CAM, SMALL_FRONTEND, STEP_TWIST,
                                     _rot_angle)
    n_frames = 9
    folder = str(tmp_path)
    synthetic.make_sequence(folder, CAM, n_frames=n_frames,
                            step_twist=STEP_TWIST)
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True,
                                               frontend=SMALL_FRONTEND)
    monkeypatch.delenv("CVO_SLAM_BACKEND", raising=False)
    jtracker = jrun.build_tracker(CAM, cfg)
    assert jtracker.lt.cvo_odometry.backend == "xla"
    monkeypatch.setenv("CVO_SLAM_BACKEND", "pallas")
    ttracker = trun.build_tracker(from_reference(CAM), from_reference(cfg),
                                  device="cpu")
    assert ttracker.lt.cvo_odometry.backend == "pallas"
    records = tum.load_association(os.path.join(folder, "associate.txt"))
    rows = []
    for tracker, load in ((jtracker, tum.load_image),
                          (ttracker, ttum.load_image)):
        tracker.init()
        out = []
        for i, rec in enumerate(records[:n_frames]):
            if i == n_frames - 1:
                tracker.force_keyframe()
            pose = tracker.update(load(folder, rec))
            lt = tracker.lt
            out.append((np.asarray(pose, np.float64),
                        lt.metrics.get("accept"),
                        lt.cvo_odometry.iters, lt.cvo_keyframe.iters))
        rows.append(out)
    for k, (w, g) in enumerate(zip(*rows)):
        assert g[1] == w[1], (k, g[1], w[1])
        assert abs(g[2] - w[2]) <= PALLAS_BARS["iters"], (k, g[2], w[2])
        assert abs(g[3] - w[3]) <= PALLAS_BARS["iters"], (k, g[3], w[3])
        np.testing.assert_allclose(g[0][:3, 3], w[0][:3, 3],
                                   atol=PALLAS_BARS["pos"],
                                   err_msg=f"frame {k}")
        assert _rot_angle(g[0][:3, :3], w[0][:3, :3]) \
            < PALLAS_BARS["rot"], k


# -- 5. run_odometry ---------------------------------------------------------

def test_run_odometry_matches_jax(tmp_path, monkeypatch):
    """run_odometry through both packages on the same 5-frame sequence: the
    same lines (name + 7 numbers), poses within 5e-4 (the chained
    transforms of four alignments; the per-pair and the moment-form align
    differ by up to 1.8e-4 m per alignment, PALLAS_BARS; measured 2.3e-4
    on the fourth pose); the port under its pallas backend, the JAX
    package under xla; then both packages' --adaptive variant."""
    from cvo_slam_tpu.app import run_odometry as jodo
    from cvo_slam_tpu.config import (CameraConfig, FrontendParams,
                                     SlamConfig)
    from cvo_slam_tpu.data import synthetic
    from cvo_slam_tpu_torch.app import run_odometry as todo
    cam = CameraConfig(fx=130.0, fy=130.0, cx=80.0, cy=60.0,
                       depth_factor=5000.0, width=160, height=120)
    folder = str(tmp_path / "seq")
    synthetic.make_sequence(folder, cam, n_frames=5)
    cfg = SlamConfig.default_shipped().replace(
        frontend=FrontendParams(num_want=600, cloud_capacity=768))
    monkeypatch.setenv("CVO_SLAM_COMPCACHE", "0")
    monkeypatch.delenv("CVO_SLAM_BACKEND", raising=False)
    want_stats = jodo.run(folder, "associate.txt", cam, cfg)
    with open(want_stats["trajectory"]) as f:
        want = [line.split() for line in f]
    monkeypatch.setenv("CVO_SLAM_BACKEND", "pallas")
    stats = todo.run(folder, "associate.txt", from_reference(cam),
                     from_reference(cfg), device="cpu")
    assert stats["frames"] == 5 and stats["backend"] == "pallas"
    with open(stats["trajectory"]) as f:
        got = [line.split() for line in f]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert len(g) == len(w) == 8 and g[0] == w[0]
        _close(np.array(g[1:], float), np.array(w[1:], float), 0, 5e-4,
               g[0])
    # --adaptive (ported since): the same lines from the adaptive-ell
    # variant of both packages, poses within the same 5e-4 (measured on the
    # CPU: 2.6e-4 on the first pose)
    want_stats = jodo.run(folder, "associate.txt", cam, cfg, adaptive=True)
    with open(want_stats["trajectory"]) as f:
        want = [line.split() for line in f]
    stats = todo.run(folder, "associate.txt", from_reference(cam),
                     from_reference(cfg), adaptive=True, device="cpu")
    assert stats["adaptive"] and want_stats["adaptive"]
    with open(stats["trajectory"]) as f:
        got = [line.split() for line in f]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert len(g) == len(w) == 8 and g[0] == w[0]
        _close(np.array(g[1:], float), np.array(w[1:], float), 0, 5e-4,
               g[0])


# -- 6. the backend switch ---------------------------------------------------

def test_default_backend_reads_environment(monkeypatch):
    monkeypatch.delenv("CVO_SLAM_BACKEND", raising=False)
    assert tengine.default_backend() == "pallas_mom"
    for name in ("pallas", "pallas_iter", "pallas_mom", "xla"):
        monkeypatch.setenv("CVO_SLAM_BACKEND", name)
        assert tengine.default_backend() == name
        assert tengine.check_backend(name) == name
        assert tengine.Cvo(TP).backend == name
    monkeypatch.setenv("CVO_SLAM_BACKEND", "bogus")
    with pytest.raises(ValueError, match="pallas_mom, pallas, "
                                         "pallas_iter, xla"):
        tengine.default_backend()
    x = torch.zeros((8, 3))
    cloud = tengine.PointCloud(x, torch.zeros((8, 5)),
                               torch.zeros(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        tengine.align(cloud, cloud, np.eye(3), np.zeros(3), 0.1, TP,
                      "bogus")
    with pytest.raises(ValueError):
        tengine.Cvo(TP, backend="bogus")


def test_lc_verify_routes_pallas_iter_to_align_fused(monkeypatch):
    """Loop-closure verification under pallas_iter aligns through
    align_fused, under pallas_mom through the xla align (the JAX package's
    _vmap_backend routing), for every candidate that passes RANSAC."""
    from cvo_slam_tpu_torch.backend import loop_closure
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS, SlamConfig
    seen = []

    def verify(*a):
        seen.append(a[-1])
        res = tengine.AlignResult(*([torch.eye(3)] * 2), torch.eye(4),
                                  *([torch.zeros(())] * 3))
        lc = {k: torch.zeros(()) for k in (
            "inn_prior", "inn_lc_prior", "inn_lc_pre", "inn_lc_post",
            "inn_fixed", "inn_moving", "cos_angle", "inliers_svd",
            "inliers_pnpransac")}
        return [(res, dict(lc, post_hessian=torch.eye(6)))]

    monkeypatch.setattr(tengine, "lc_verify_batch", verify)
    monkeypatch.setattr(loop_closure, "Matcher", _OneMatch)
    for env, want in (("pallas_iter", "pallas"), ("pallas", "pallas"),
                      ("pallas_mom", "xla"), ("xla", "xla")):
        monkeypatch.setenv("CVO_SLAM_BACKEND", env)
        detect = loop_closure.make_loop_detector(
            CAMERA_PRESETS["TUM1"], SlamConfig.default_shipped())
        seen.clear()
        ref = _dummy_keyframe(3)
        graph = _DummyGraph([_dummy_keyframe(i) for i in range(3)] + [ref])
        assert detect(graph, ref) == (0, 3)     # every candidate rejected
        assert seen == [want, want], (env, seen)


class _OneMatch:
    """A matcher whose RANSAC passes every candidate with the identity."""

    def __init__(self, *a, **k):
        pass

    def reset_round(self):
        pass

    def get_initial_transformation(self, *a, **k):
        return True, 12, np.eye(4)

    def best_covisible(self, kf):
        pass


class _DummyGraph:
    def __init__(self, kfs):
        self._kfs = kfs
        self.map_points = {}

    def keyframes(self):
        return self._kfs

    def log(self, msg):
        pass


def _dummy_keyframe(i):
    from cvo_slam_tpu_torch.tracking.types import Keyframe
    kf = Keyframe(id=i, timestamp=str(i), pose=np.eye(4))
    kf.bow_vec = {0: 1.0}
    kf.cloud = tengine.PointCloud(torch.zeros((8, 3)), torch.zeros((8, 5)),
                                  torch.zeros(8, dtype=torch.bool))
    return kf


def test_wrappers_reject_bad_inputs():
    """The new CUDA wrappers validate before any build: a wrong cloud or a
    wrong pose raises instead of launching."""
    x, y, fx, fy, mx, my = _port_args(_clouds(1, n=100, m=100))
    with pytest.raises(ValueError):
        kernels.flow_and_step_cuda(x, y[:, :2], fx, fy, mx, my, 0.1, TP)
    with pytest.raises(ValueError):
        kernels.flow_cuda(x, y, fx, fy, mx.float(), my, 0.1, TP)
    with pytest.raises(ValueError):
        kernels.step_coeffs(x.to("meta"), y, fx, fy, mx, my, x[0], x[0],
                            0.1, TP)
    with pytest.raises(ValueError):
        kernels.align_fused_cuda(x, fx, mx, y, fy, my, torch.eye(4),
                                 torch.zeros(3), 0.1, TP)
    with pytest.raises(ValueError):
        kernels.align_fused(x.to("meta"), fx, mx, y, fy, my, torch.eye(3),
                            torch.zeros(3), 0.1, TP)
    # the keep bitmask: int32 words, (ceil(M/32), N)
    with pytest.raises(ValueError):
        kernels.flow_and_step_cuda(x, y, fx, fy, mx, my, 0.1, TP,
                                   keep_bits=torch.zeros((4, 100),
                                                         dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.flow_and_step_cuda(x, y, fx, fy, mx, my, 0.1, TP,
                                   keep_bits=torch.zeros((100, 4),
                                                         dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.flow_and_step_cuda(x, y, fx, fy, mx, my, 0.1, TP,
                                   keep_bits=torch.zeros((4, 100)))
    # the moving cloud is staged with 16-byte copies: a view 4 bytes into
    # its storage is refused, by both per-pair wrappers
    y_off = torch.empty(y.numel() + 1)[1:].view_as(y).copy_(y)
    with pytest.raises(ValueError, match="aligned"):
        kernels.flow_and_step_cuda(x, y_off, fx, fy, mx, my, 0.1, TP)
    with pytest.raises(ValueError, match="aligned"):
        kernels.align_fused_cuda(x, fx, mx, y_off, fy, my, torch.eye(3),
                                 torch.zeros(3), 0.1, TP)


# -- the build ---------------------------------------------------------------

def test_library_name_hashes_included_headers(tmp_path):
    """An edited header renames the library of every source that includes
    it, directly or through another header, and of no other source."""
    csrc = str(tmp_path / "csrc")
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    before = {s: cuda_build._so_path(s, csrc) for s in cuda_build.SOURCES}
    with open(os.path.join(csrc, "pair_math.cuh"), "a") as f:
        f.write("\n// edited\n")
    after = {s: cuda_build._so_path(s, csrc) for s in cuda_build.SOURCES}
    changed = {s for s in cuda_build.SOURCES if before[s] != after[s]}
    # every source but hessian_post.cu (which includes no header) includes
    # it through flow_step.cuh (pair_stats.cu and ip_suite.cu through
    # pair_stats.cuh, align_fused.cu and moment_step.cu through
    # align_state.cuh, both of which include flow_step.cuh)
    assert changed == {"ip_suite.cu", "flow_step.cu", "align_fused.cu",
                       "moment_flow_step.cu", "pair_stats.cu",
                       "moment_step.cu"}
    with open(os.path.join(csrc, "flow_step.cuh"), "a") as f:
        f.write("\n// edited\n")
    again = {s: cuda_build._so_path(s, csrc) for s in cuda_build.SOURCES}
    assert {s for s in cuda_build.SOURCES if after[s] != again[s]} \
        == {"flow_step.cu", "align_fused.cu", "moment_flow_step.cu",
            "pair_stats.cu", "ip_suite.cu", "moment_step.cu"}
    with open(os.path.join(csrc, "pair_stats.cuh"), "a") as f:
        f.write("\n// edited\n")
    last = {s: cuda_build._so_path(s, csrc) for s in cuda_build.SOURCES}
    assert {s for s in cuda_build.SOURCES if again[s] != last[s]} \
        == {"pair_stats.cu", "ip_suite.cu"}
    # the align state shared by the pallas and pallas_mom loops rebuilds
    # those two libraries and no other
    with open(os.path.join(csrc, "align_state.cuh"), "a") as f:
        f.write("\n// edited\n")
    shared = {s: cuda_build._so_path(s, csrc) for s in cuda_build.SOURCES}
    assert {s for s in cuda_build.SOURCES if last[s] != shared[s]} \
        == {"align_fused.cu", "moment_step.cu"}
    # an edit of the new source rebuilds its library alone
    with open(os.path.join(csrc, "moment_step.cu"), "a") as f:
        f.write("\n// edited\n")
    final = {s: cuda_build._so_path(s, csrc) for s in cuda_build.SOURCES}
    assert {s for s in cuda_build.SOURCES if shared[s] != final[s]} \
        == {"moment_step.cu"}
    assert cuda_build._source_closure("moment_step.cu", csrc) == [
        "moment_step.cu", "align_state.cuh", "flow_step.cuh",
        "pair_math.cuh"]
    assert cuda_build._so_path("ip_suite.cu") \
        == cuda_build._so_path("ip_suite.cu", cuda_build.CSRC_DIR)


# -- on the card -------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check")


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [256, 250])
def test_flow_step_cuda_matches_plain(cap, monkeypatch):
    """On a card: flow_and_step, flow and step_coeffs against their plain
    versions at the CPU parity bars; pass 1's keep bitmask equal to
    keep_bits_plain bit for bit; two launches bitwise equal; a split with
    every column tile in one item (the double-buffered staging, which the
    plan's one tile per item does not reach) gives the same nnz and
    bitmask."""
    _need_card()
    x, y, fx, fy, mx, my = [a.cuda() for a in _port_args(
        _clouds(7, cap=cap, n=230, m=210))]
    words = (-(-cap // 32), cap)
    for ell in (0.15, 0.06):
        bits = torch.empty(words, dtype=torch.int32, device="cuda")
        got = kernels.flow_and_step_cuda(x, y, fx, fy, mx, my, ell, TP,
                                         keep_bits=bits)
        want = kernels.flow_and_step_plain(x, y, fx, fy, mx, my, ell, TP)
        assert int(got[2]) == int(want[2])
        assert torch.equal(bits, kernels.keep_bits_plain(
            x, y, fx, fy, mx, my, ell, TP))
        for g, w in zip(got[:2], want[:2]):
            _close(g.cpu(), w.cpu(), 2e-4, 1e-6, "omega, v")
        for g, w in zip(got[3:], want[3:]):
            _close(g.cpu(), w.cpu(), 2e-3, 1e-8, "B..E")
        again = kernels.flow_and_step_cuda(x, y, fx, fy, mx, my, ell, TP)
        for g, w in zip(again, got):
            assert torch.equal(g, w)
        plan_for = kernels._plan_for

        def one_item_per_row_tile(*a):
            plan, per_sm, sms = plan_for(*a)
            return dataclasses.replace(plan, chunks=1, tiles_per_chunk=(
                plan.col_tiles)), per_sm, sms

        with monkeypatch.context() as m:
            m.setattr(kernels, "_plan_for", one_item_per_row_tile)
            bits1, info = torch.empty_like(bits), {}
            one = kernels.flow_and_step_cuda(x, y, fx, fy, mx, my, ell, TP,
                                             keep_bits=bits1,
                                             launch_info=info)
        assert info["grid"] == 1 and info["tiles_per_chunk"] == words[0]
        assert int(one[2]) == int(want[2]) and torch.equal(bits1, bits)
        for g, w in zip(one[3:], want[3:]):
            _close(g.cpu(), w.cpu(), 2e-3, 1e-8, "B..E, one item")
        o, v, n = kernels.flow(x, y, fx, fy, mx, my, ell, TP)
        assert int(n) == int(want[2])
        for g, w in zip(kernels.step_coeffs(x, y, fx, fy, mx, my, o, v, ell,
                                            TP), got[3:]):
            _close(g.cpu(), w.cpu(), 1e-6, 0.0, "step mode")


@pytest.mark.gpu
def test_align_fused_cuda_matches_plain():
    """On a card: the cooperative align kernel against its plain version on
    the megakernel fixture: iterations within 3, ell equal, transform within
    1e-4; two launches bitwise equal."""
    _need_card()
    fixed_np, moving_np, _ = _megakernel_clouds()
    x, fx, mx = [a.cuda() for a in _torch(fixed_np)]
    y, fy, my = [a.cuda() for a in _torch(moving_np)]
    args = (x, fx, mx, y, fy, my, torch.eye(3, device="cuda"),
            torch.zeros(3, device="cuda"), torch.tensor(0.15, device="cuda"),
            TP)
    R, T, ell, iters, _ = got = kernels.align_fused(*args)
    Rp, Tp, ellp, itp, _ = kernels.align_fused_plain(*args)
    assert abs(int(iters) - int(itp)) <= 3
    assert float(ell) == float(ellp)
    _close(R.cpu(), Rp.cpu(), 0, 1e-4, "R")
    _close(T.cpu(), Tp.cpu(), 0, 1e-4, "T")
    for g, w in zip(kernels.align_fused(*args), got):
        assert torch.equal(g, w)
