"""Port parity, the reference's public align interface: Cvo.match_odometry
and match_keyframe (cvo.cpp:461-473, :563-576) against the JAX package's
Cvo on the same clouds (CPU), on each of the port's four backends; the
counterpart of tests/test_engine.py's test_ell_carry_over."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import engine as jengine
from cvo_slam_tpu.ops import se3 as jse3
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import engine as tengine
from test_engine import structured_cloud
from test_torch_engine import XI, _port_cloud
from test_torch_tracking import BARS, _rot_angle

torch.set_num_threads(2)


def _moved(cloud, xi):
    """`cloud` moved by exp(xi), masked points at the origin."""
    G = np.asarray(jse3.exp_se3(jnp.asarray(np.asarray(xi, np.float32))),
                   np.float64)
    pos = np.asarray(cloud.positions)
    mask = np.asarray(cloud.mask)
    return jengine.PointCloud(
        jnp.asarray((pos @ G[:3, :3].T + G[:3, 3]).astype(np.float32)
                    * mask[:, None]), cloud.features, cloud.mask)


def _clouds():
    """A cloud, then the same cloud moved by exp(XI[0]), then moved by
    exp(XI[0] + XI[1]): two alignments, each from the last result."""
    c0 = structured_cloud(2)
    return [c0, _moved(c0, XI[0]), _moved(c0, XI[0] + XI[1])]


def _run(cvo, clouds, port):
    """Seed the fixed cloud, match_odometry the second cloud, make it the
    fixed cloud, match_keyframe the third; per call the iterations, ell,
    nnz and transform."""
    wrap = _port_cloud if port else (lambda c: c)
    cvo.set_pcd(wrap(clouds[0]), None)
    rows = []
    for k, cloud in enumerate(clouds[1:]):
        match = cvo.match_odometry if k == 0 else cvo.match_keyframe
        tran = match(wrap(cloud), None)
        rows.append(dict(iters=cvo.iters, ell=cvo.ell, nnz=cvo.nnz,
                         transform=np.asarray(tran, np.float64)))
        assert tran is cvo.transform
        cvo.update_fixed_pcd()
    return rows


_want = {}


@pytest.mark.parametrize("ell_reset", [True, False])
@pytest.mark.parametrize("backend", ["pallas_mom", "pallas", "pallas_iter",
                                     "xla"])
def test_match_odometry_matches_jax(backend, ell_reset):
    """Two alignments through the port's Cvo on `backend` and the JAX
    package's Cvo (its CPU backend, xla), with CvoParams() (ell_reset) and
    with the annealed ell carried from one alignment to the next: ell after
    each call equal, iterations (per call, or in total without ell_reset),
    nnz within 1% and the transform within tests/test_torch_tracking.py's
    BARS."""
    p = dataclasses.replace(CvoParams(), ell_reset=ell_reset)
    clouds = _clouds()
    if ell_reset not in _want:
        _want[ell_reset] = _run(jengine.Cvo(p, backend="xla"), clouds, False)
    want = _want[ell_reset]
    got = _run(tengine.Cvo(from_reference(p), backend=backend), clouds, True)
    bars = BARS[ell_reset]
    for k, (g, w) in enumerate(zip(got, want)):
        assert g["ell"] == w["ell"], (k, g["ell"], w["ell"])
        if bars["iters"] is not None:
            assert abs(g["iters"] - w["iters"]) <= bars["iters"], (k, g, w)
        assert abs(g["nnz"] - w["nnz"]) <= 0.01 * w["nnz"], (k, g, w)
        np.testing.assert_allclose(g["transform"][:3, 3],
                                   w["transform"][:3, 3], atol=bars["pos"],
                                   err_msg=f"call {k}")
        assert _rot_angle(g["transform"][:3, :3], w["transform"][:3, :3]) \
            < bars["rot"], k
    if bars["total"] is not None:
        total_g = sum(g["iters"] for g in got)
        total_w = sum(w["iters"] for w in want)
        assert abs(total_g - total_w) <= bars["total"] * total_w, \
            (total_g, total_w)
    if not ell_reset:
        # the second alignment started from the first one's annealed ell
        assert want[0]["ell"] == pytest.approx(p.ell_anneal_values[-1])


def test_match_needs_a_fixed_cloud():
    """match_odometry before the first set_pcd raises, as the reference
    asserts (cvo.cpp:463)."""
    c = tengine.Cvo(from_reference(CvoParams()), backend="xla")
    with pytest.raises(RuntimeError, match="not initialized"):
        c.match_odometry(_port_cloud(structured_cloud(2)), None)
