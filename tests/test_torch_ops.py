"""Port parity, ops layer: cvo_slam_tpu_torch.ops.{se3,cubic,jacobi,pairwise}
against the JAX package's functions on the same numpy inputs (CPU)."""

import ast
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.ops import cubic as jcubic
from cvo_slam_tpu.ops import jacobi as jjacobi
from cvo_slam_tpu.ops import pairwise as jpw
from cvo_slam_tpu.ops import se3 as jse3
from cvo_slam_tpu_torch import config as tconfig
from cvo_slam_tpu_torch.ops import cubic as tcubic
from cvo_slam_tpu_torch.ops import jacobi as tjacobi
from cvo_slam_tpu_torch.ops import pairwise as tpw
from cvo_slam_tpu_torch.ops import se3 as tse3

torch.set_num_threads(2)
RTOL = 1e-5
P = CvoParams()
REPO = pathlib.Path(__file__).resolve().parents[1]


def _twists(seed, n=16, scale=0.3):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, scale, (n, 6)).astype(np.float32)
    xi[0] = 0.0                       # identity
    xi[1, :3] = 1e-8                  # below the TOL=1e-6 branch switch
    return xi


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=atol)


@pytest.mark.parametrize("fn", ["exp_se3", "exp_so3", "log_so3",
                                "left_jacobian_so3", "left_jacobian_inv_so3"])
def test_se3_functions(fn):
    xi = _twists(0)
    if fn == "exp_se3":
        _close(tse3.exp_se3(torch.as_tensor(xi)), jse3.exp_se3(jnp.asarray(xi)))
    elif fn == "log_so3":
        R = np.array(jse3.exp_so3(jnp.asarray(xi[:, :3])))
        _close(tse3.log_so3(torch.as_tensor(R)), jse3.log_so3(jnp.asarray(R)),
               atol=1e-5)
    else:
        w = xi[:, :3]
        _close(getattr(tse3, fn)(torch.as_tensor(w)),
               getattr(jse3, fn)(jnp.asarray(w)))


@pytest.mark.parametrize("dt", [0.2, 0.8, 0.0374])
def test_exp_sek3_and_dist(dt):
    for xi in _twists(1, scale=0.05):
        got = tse3.exp_sek3(torch.as_tensor(xi), torch.tensor(dt))
        want = jse3.exp_sek3(jnp.asarray(xi), jnp.float32(dt))
        _close(got, want)
        W = np.array(want)
        _close(tse3.dist_se3(torch.as_tensor(W[:3, :3]),
                             torch.as_tensor(W[:3, 3])),
               jse3.dist_se3(jnp.asarray(W[:3, :3]), jnp.asarray(W[:3, 3])),
               atol=1e-6)


def test_pose_helpers():
    xi = _twists(2)
    T = np.array(jse3.exp_se3(jnp.asarray(xi)))
    pts = np.random.default_rng(3).normal(0, 2, (50, 3)).astype(np.float32)
    for k in range(len(T)):
        _close(tse3.transform_points(torch.as_tensor(T[k]),
                                     torch.as_tensor(pts)),
               jse3.transform_points(jnp.asarray(T[k]), jnp.asarray(pts)),
               atol=1e-5)
    _close(tse3.make_pose(torch.as_tensor(T[:, :3, :3]),
                          torch.as_tensor(T[:, :3, 3])), T)


@pytest.mark.parametrize("seed", range(4))
def test_cubic_min_positive_root(seed):
    rng = np.random.default_rng(seed)
    cases = [rng.normal(0, 1, 4) for _ in range(40)]
    cases += [(1.0, -1.5, -1.5, 1.0), (1.0, 6.0, 11.0, 6.0),
              (1.0, -5.0, 0.0, 0.0), (0.0, 1.0, -3.0, 2.0),
              (1e-9, 3e-7, -2e-7, 1e-8)]
    for a, b, c, d in cases:
        args = [np.float32(v) for v in (a, b, c, d)]
        want = float(jcubic.min_positive_root_or(*map(jnp.float32, args),
                                                 0.2, 0.8))
        got = float(tcubic.min_positive_root_or(
            *map(torch.tensor, args), 0.2, 0.8))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_jacobi_eigvalsh():
    rng = np.random.default_rng(0)
    cases = [a + a.T for a in rng.normal(0, 1, (6, 6, 6))]
    for spec in ([1, 1, 1 + 1e-5, -1, -1e-4, 1e3],
                 [-5e4, -2, -1e-3, 1e-3, 2, 5e4]):
        Q, _ = np.linalg.qr(rng.normal(0, 1, (6, 6)))
        cases.append(Q @ np.diag(spec) @ Q.T)
    for A in cases:
        A = A.astype(np.float32)
        want = np.sort(np.asarray(jjacobi.eigvalsh_jacobi(jnp.asarray(A))))
        got = np.sort(tjacobi.eigvalsh_jacobi(torch.as_tensor(A)).numpy())
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL,
                                   atol=1e-6)


def test_moment_basis_and_hessian_assembly():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    m = rng.uniform(size=100) > 0.2
    c_j, U_j = jpw.step_moment_basis(jnp.asarray(x), jnp.asarray(m))
    c_t, U_t = tpw.step_moment_basis(torch.as_tensor(x), torch.as_tensor(m))
    _close(c_t, c_j)
    _close(U_t, U_j)
    G = rng.normal(0, 10, (13, 13)).astype(np.float32)
    for ell in (0.15, 0.03):
        want = np.asarray(jpw.assemble_hessian(jnp.asarray(G),
                                               jnp.float32(ell)))
        got = tpw.assemble_hessian(torch.as_tensor(G),
                                   torch.tensor(ell)).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-6)
    _close(tpw.lift_u(torch.as_tensor(x)), jpw.lift_u(jnp.asarray(x)))


def test_thresholds():
    ell = np.float32(0.06)
    np.testing.assert_allclose(
        float(tpw.d2_threshold(torch.tensor(ell), tconfig.from_reference(P))),
        float(jpw.d2_threshold(jnp.float32(ell), P)), rtol=1e-6)
    assert tpw.d2_color_threshold(P) == float(
        np.float32(jpw.d2_color_threshold(P)))


def test_config_from_reference():
    from cvo_slam_tpu.config import (CAMERA_PRESETS, FrontendParams,
                                     SlamConfig)
    cfg = SlamConfig.default_shipped().replace(
        OnlyTracking=True, frontend=FrontendParams(num_want=600,
                                                   cloud_capacity=768))
    port = tconfig.from_reference(cfg)
    assert isinstance(port, tconfig.SlamConfig)
    assert port == tconfig.SlamConfig.default_shipped().replace(
        OnlyTracking=True, frontend=tconfig.FrontendParams(
            num_want=600, cloud_capacity=768))
    assert tconfig.from_reference(CAMERA_PRESETS["TUM1"]) \
        == tconfig.CAMERA_PRESETS["TUM1"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No file of the port, and not chip_smoke.py, imports jax or anything
    of the JAX package."""
    files = sorted((REPO / "cvo_slam_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "cvo_slam_tpu"), (f, name)
