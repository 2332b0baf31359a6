"""Port parity, the xla align backend (cvo_slam_tpu_torch.ops.pairwise's
dense moment-form pass, engine.align(..., "xla") and its lanes) against the
JAX package's xla backend on the CPU: the pass on equal inputs, the align on
tests/test_torch_engine.py's pairs, the lanes against the solo align bit for
bit, loop-closure verification as the loop detector routes it under
pallas_mom, tracking under CVO_SLAM_BACKEND=xla, and the CLIs taking it."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cvo_slam_tpu.config import CvoParams, SlamConfig
from cvo_slam_tpu.cvo import engine as jengine
from cvo_slam_tpu.ops import pairwise as jpw
from cvo_slam_tpu.ops import se3 as jse3
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import engine as tengine
from cvo_slam_tpu_torch.ops import pairwise as tpw
from cvo_slam_tpu_torch.ops import se3 as tse3
from cvo_slam_tpu_torch.parallel import batch as tbatch
from test_engine import structured_cloud
from test_pairwise import make_clouds
from test_torch_align import PALLAS_BARS
from test_torch_engine import XI, _pair, _port_cloud
from test_torch_kernels import _assert_moment
from test_torch_tracking import (CAM, N_FRAMES, SMALL_FRONTEND, _rot_angle,
                                 _track, seq)  # noqa: F401

torch.set_num_threads(2)
P = CvoParams()
TP = from_reference(P)


def _torch(arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


# -- the pass ----------------------------------------------------------------

@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_flow_and_step_moments_parity(ell):
    """The gated colour kernel, the kernel matrix and one iteration's
    (omega, v, nnz, B, C, D, E) against the JAX package's functions on the
    same clouds: keep and nnz exact; the kernels within 1e-6; the pass at
    the moment kernel's bars (tests/test_torch_kernels.py), one-lane and
    lanes form; flow_from_color's flow at the same bars."""
    arrays = make_clouds(4, 200, 180, cap=256)
    x, fx, mx, y, fy, my = (jnp.asarray(a) for a in arrays)
    ck = jpw.color_kernel_gated(fx, fy, mx, my, P)
    A, keep = jpw.cvo_kernel_from_color(x, y, ck, jnp.float32(ell), P)
    center, U = jpw.step_moment_basis(x, mx)
    want = jpw.flow_and_step_moments(x, y, ck, U, center, jnp.float32(ell),
                                     P)
    tx, tfx, tmx, ty, tfy, tmy = _torch(arrays)
    tell = torch.tensor(ell)
    tck = tpw.color_kernel_gated(tfx, tfy, tmx, tmy, TP)
    tA, tkeep = tpw.cvo_kernel_from_color(tx, ty, tck, tell, TP)
    np.testing.assert_allclose(tck.numpy(), np.asarray(ck), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    np.testing.assert_allclose(tA.numpy(), np.asarray(A), rtol=1e-6,
                               atol=1e-9)
    tc, tU = tpw.step_moment_basis(tx, tmx)
    _assert_moment(tpw.flow_and_step_moments(tx, ty, tck, tU, tc, tell, TP),
                   want)
    _assert_moment(tpw.flow_and_step_moments_lanes(tx, ty, tck, tU, tc,
                                                   tell, TP), want)
    got_f = tpw.flow_from_color(tx, ty, tck, tell, TP)
    want_f = jpw.flow_from_color(x, y, ck, jnp.float32(ell), P)
    assert int(got_f[3]) == int(want_f[3])
    for g, w in zip(got_f[:2], want_f[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=1e-5)


def test_pass_lanes_equal_one_lane():
    """The lanes' pass over three lanes (a shared fixed cloud, per-lane
    moved clouds and ells) equals its one-lane call on each lane bit for
    bit; sum_pairwise equals a sum at f32 accuracy."""
    x, fx, mx, y, fy, my = _torch(make_clouds(6, 150, 140, cap=192))
    ys = torch.stack([y, y * 1.01, y + 0.01])
    ells = torch.tensor([0.15, 0.06, 0.1])
    ckg = tpw.color_kernel_gated(fx, fy, mx, my, TP)
    center, U = tpw.step_moment_basis(x, mx)
    lanes = tpw.flow_and_step_moments_lanes(x, ys, ckg, U, center, ells, TP)
    for l in range(3):
        one = tpw.flow_and_step_moments_lanes(x, ys[l], ckg, U, center,
                                              ells[l], TP)
        for a, b in zip(lanes, one):
            assert torch.equal(a[l], b), l
    t = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 1000))
                        .astype(np.float32))
    np.testing.assert_allclose(tpw.sum_pairwise(t).numpy(),
                               t.double().sum(-1).numpy(), rtol=1e-5,
                               atol=1e-5)


# -- the align -----------------------------------------------------------------

@pytest.mark.parametrize("case", [(0, 0), (1, 1), (0, 1)])
def test_xla_align_matches_jax(case):
    """engine.align under xla against the JAX package's on
    tests/test_torch_engine.py's pairs: the same iterations, final ell and
    nnz, the transform within 1e-5 (that test's bars)."""
    seed, which = case
    fixed, moved = _pair(seed, XI[which])
    ell0 = np.float32(P.ell_init)
    want = jengine.align(fixed, moved, jnp.eye(3), jnp.zeros(3),
                         jnp.float32(ell0), P, "xla")
    got = tengine.align(_port_cloud(fixed), _port_cloud(moved),
                        np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                        ell0, TP, "xla")
    assert int(want.iters) < P.max_iter
    assert int(got.iters) == int(want.iters)
    assert float(got.ell) == float(want.ell)
    assert int(got.nnz) == int(want.nnz)
    np.testing.assert_allclose(got.transform.numpy(),
                               np.asarray(want.transform), atol=1e-5)


def _lane_clouds(n_lanes):
    """Fixed clouds (two seeds, alternating) and moving clouds: each fixed
    cloud under its own small motion, the third lane's moving cloud its
    fixed one (it stops at once and stays frozen while the others run)."""
    rng = np.random.default_rng(3)
    fixed, moving = [], []
    for l in range(n_lanes):
        f = _port_cloud(structured_cloud(l % 2, n=256))
        xi = rng.normal(0, 0.015, 6).astype(np.float32)
        if l == 2:
            xi[:] = 0.0
        G = tse3.exp_se3(torch.as_tensor(xi))
        fixed.append(f)
        moving.append(tengine.PointCloud(
            tse3.transform_points(G, f.positions) * f.mask[:, None],
            f.features, f.mask))
    return fixed, moving


# the lanes' iteration cap: lane 2 stops at once, lane 4 after ~70
# iterations, the others run to the cap
LANE_P = dataclasses.replace(TP, max_iter=80)


@pytest.fixture(scope="module")
def lane_runs():
    """Five lanes' clouds and each lane's solo xla align, against its own
    fixed cloud and against lane 0's."""
    fixed, moving = _lane_clouds(5)
    eye, zero, ell0 = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                       np.float32(P.ell_init))
    own = [tengine.align(f, m, eye, zero, ell0, LANE_P, "xla")
           for f, m in zip(fixed, moving)]
    shared = [tengine.align(fixed[0], m, eye, zero, ell0, LANE_P, "xla")
              for m in moving]
    return fixed, moving, own, shared


@pytest.mark.parametrize("lanes", [1, 3, 5])
def test_xla_lanes_equal_solo(lane_runs, lanes, monkeypatch):
    """align_lanes under xla runs S lanes as one lane program (one
    align_loop_lanes call), per-lane fixed clouds and one shared fixed
    cloud; every lane equals its solo align bit for bit, lanes 2 and 4
    stopping iterations before the others."""
    fixed, moving, own, shared = lane_runs
    iters = [int(r.iters) for r in own]
    assert iters[2] < iters[4] < min(iters[:2])
    programs = []
    loop = tengine.align_loop_lanes
    monkeypatch.setattr(tengine, "align_loop_lanes",
                        lambda f, y0, states, p: programs.append(len(states))
                        or loop(f, y0, states, p))
    S = lanes
    args = ([np.eye(3, dtype=np.float32)] * S, [np.zeros(3, np.float32)] * S,
            [np.float32(P.ell_init)] * S, LANE_P, "xla")
    for fx, solo in ((fixed[:S], own), (fixed[0], shared)):
        res = tengine.align_lanes(fx, moving[:S], *args)
        for l in range(S):
            for a, b in zip(res, solo[l]):
                assert torch.equal(a[l], b), l
    assert programs == [S, S]


# -- loop-closure verification --------------------------------------------------

def test_lc_verify_batch_routed_matches_jax(monkeypatch):
    """Two candidates verified as the loop detector routes pallas_mom (to
    xla): one lane program for both, and against the JAX package's
    lc_verify_batch(..., "xla"): the same accept decisions
    (keyframe_graph.cpp:703-714), iterations within 3, transforms within
    1e-4, inner products rtol 2e-4."""
    backend = tbatch._batch_backend("pallas_mom")
    assert backend == "xla"
    pairs = [_pair(0, XI[0]), _pair(0, XI[1])]
    fixed = pairs[0][0]
    priors = [np.asarray(jse3.exp_se3(jnp.asarray(0.8 * xi, jnp.float32)),
                         np.float32) for xi in XI]
    inv = [np.linalg.inv(pr) for pr in priors]
    R0 = np.stack([m[:3, :3] for m in inv]).astype(np.float32)
    T0 = np.stack([m[:3, 3] for m in inv]).astype(np.float32)
    ell0 = np.full(2, P.ell_init, np.float32)
    movings = jengine.PointCloud(*(jnp.stack([getattr(m, f) for _, m in pairs])
                                   for f in ("positions", "features", "mask")))
    want_res, want_lc = jengine.lc_verify_batch(
        fixed, movings, jnp.asarray(R0), jnp.asarray(T0), jnp.asarray(ell0),
        jnp.asarray(np.stack(priors)), jnp.asarray(np.stack(priors)), P,
        "xla")
    programs = []
    loop = tengine.align_loop_lanes
    monkeypatch.setattr(tengine, "align_loop_lanes",
                        lambda f, y0, states, p: programs.append(len(states))
                        or loop(f, y0, states, p))
    ref = _port_cloud(fixed)
    cands = [_port_cloud(m) for _, m in pairs]
    got = tengine.lc_verify_batch(ref, cands, R0, T0, ell0, priors, priors,
                                  TP, backend)
    assert programs == [2]
    for k, (res, lc) in enumerate(got):
        assert abs(int(res.iters) - int(want_res.iters[k])) <= 3
        np.testing.assert_allclose(res.transform.numpy(),
                                   np.asarray(want_res.transform[k]),
                                   atol=1e-4)
        lc = tengine.to_host(lc)
        want = {key: float(v[k]) for key, v in want_lc.items()
                if key != "post_hessian"}

        def accept(d):
            return (d["inn_lc_post"] > d["inn_lc_pre"]
                    and d["inn_lc_post"] > d["inn_lc_prior"]
                    and d["inn_lc_post"] > d["inn_prior"]
                    and d["cos_angle"] >= 0.1)

        assert accept({key: float(lc[key]) for key in want}) == accept(want)
        for key in ("inn_prior", "inn_lc_prior", "inn_lc_pre", "inn_lc_post",
                    "inn_fixed", "inn_moving", "cos_angle"):
            np.testing.assert_allclose(float(lc[key]), want[key], rtol=2e-4,
                                       err_msg=key)


# -- tracking and the CLIs -------------------------------------------------------

def test_xla_tracking_matches_jax(seq, monkeypatch):  # noqa: F811
    """Tracking-only SLAM on tests/test_torch_tracking.py's sequence with
    CVO_SLAM_BACKEND=xla against the JAX package's default on the CPU
    (xla): the same keyframe decisions and map boundaries, iterations and
    poses within PALLAS_BARS (tests/test_torch_align.py: another f32 order
    of the same align's sums, measured here at 5 iterations and 1.7e-4 m,
    as the port's pallas against the JAX package's xla)."""
    from cvo_slam_tpu.app import run_slam as jrun
    from cvo_slam_tpu_torch.app import run_slam as trun
    from cvo_slam_tpu_torch.data import tum as ttum
    from cvo_slam_tpu.data import tum
    folder, gt = seq
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True,
                                               frontend=SMALL_FRONTEND)
    assert cfg.cvo.ell_reset
    want = _track(jrun.build_tracker(CAM, cfg), tum.load_image, folder)
    monkeypatch.setenv("CVO_SLAM_BACKEND", "xla")
    tracker = trun.build_tracker(from_reference(CAM), from_reference(cfg),
                                 device="cpu")
    assert tracker.lt.cvo_odometry.backend == "xla"
    got = _track(tracker, ttum.load_image, folder)
    bars = PALLAS_BARS
    for k, (g, w) in enumerate(zip(got, want)):
        for key in ("accept", "keyframe"):
            assert g[key] == w[key], (k, key, g[key], w[key])
        for key in ("odo_iters", "kf_iters"):
            assert abs(g[key] - w[key]) <= bars["iters"], (k, key, g, w)
        np.testing.assert_allclose(g["pose"][:3, 3], w["pose"][:3, 3],
                                   atol=bars["pos"], err_msg=f"frame {k}")
        assert _rot_angle(g["pose"][:3, :3], w["pose"][:3, :3]) \
            < bars["rot"], k
    est = np.array([r["pose"] for r in got])
    err = np.linalg.norm(est[:, :3, 3] - gt[:N_FRAMES, :3, 3], axis=1)
    assert err.max() < 0.05, err


def test_xla_first_pair_matches_jax(tmp_path):
    """chip_smoke.py's frames 0 -> 1 (the synthetic sequence, seed 7,
    640x480, CAP 3072), aligned from the identity at ell 0.15 by the
    port's xla and by the JAX package's xla on the CPU: iterations within
    ALIGN_ITERS_SPREAD (5, chip_smoke.py), end transforms within 1.1e-3 m
    and rad (its ALIGN_PAIRS_GAP). On this pair the stop fires where the
    flow oscillates at ell 0.03 (the se3-distance rule, at an iteration
    whose step is ~0.03), so the count moves with the last bits of the
    sums (tests/test_torch_xla_orders.py: 29 to 58 iterations over f32
    orders and CPU thread counts, the JAX package's xla 47 and its pass in
    a Python loop 59; PERF.md, PR 11); the test holds this port's order at
    two CPU threads."""
    from test_torch_xla_orders import first_pair_clouds
    (jf, jm), (tf, tm) = first_pair_clouds(str(tmp_path))
    p = SlamConfig.default_shipped().cvo
    want = jengine.align(jf, jm, jnp.eye(3), jnp.zeros(3), jnp.float32(0.15),
                         p, "xla")
    got = tengine.align(tf, tm, torch.eye(3), torch.zeros(3),
                        torch.tensor(0.15), from_reference(p), "xla")
    assert int(want.iters) < p.max_iter
    assert abs(int(got.iters) - int(want.iters)) <= 5, \
        (int(got.iters), int(want.iters))
    assert float(got.ell) == float(want.ell)
    t_got, t_want = got.transform.numpy(), np.asarray(want.transform)
    np.testing.assert_allclose(t_got[:3, 3], t_want[:3, 3], atol=1.1e-3)
    assert _rot_angle(t_got[:3, :3], t_want[:3, :3]) < 1.1e-3


def test_clis_take_xla(seq, tmp_path, monkeypatch):  # noqa: F811
    """run_slam and run_odometry read CVO_SLAM_BACKEND=xla (no flag): their
    stats name it, and every pose is finite."""
    import shutil
    from cvo_slam_tpu_torch.app import run_odometry
    from cvo_slam_tpu_torch.app import run_slam as trun
    src, _ = seq
    folder = str(tmp_path / "run")
    shutil.copytree(src, folder)
    monkeypatch.setenv("CVO_SLAM_BACKEND", "xla")
    cam = from_reference(CAM)
    cfg = from_reference(SlamConfig.default_shipped().replace(
        OnlyTracking=True, frontend=SMALL_FRONTEND))
    stats = trun.run(folder, "associate.txt", cam, cfg, max_frames=2,
                     device="cpu")
    assert stats["backend"] == "xla" and stats["frames"] == 2
    stats = run_odometry.run(folder, "associate.txt", cam, cfg, max_frames=2,
                             device="cpu")
    assert stats["backend"] == "xla"
    with open(os.path.join(folder, "cvo_poses_qt.txt")) as f:
        rows = [np.array(line.split()[1:], float) for line in f]
    assert len(rows) == 1 and np.isfinite(rows[0]).all()
