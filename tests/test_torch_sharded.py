"""Port parity, the mesh: parallel.mesh, the edge-sharded pose-graph LM, the
sharded Schur BA and the sharded align of cvo_slam_tpu_torch against the
port's single-device solvers and the JAX package's sharded solvers (on its
8-device virtual CPU mesh) on the same numpy problems, on the CPU.

Bars are the JAX package's own (tests/test_sharded_lm.py:22-57,
tests/test_ba.py:95-153): chi2 rtol 1e-3 / atol 1e-5, poses rtol 1e-3 /
atol 1e-4, landmarks rtol 1e-3 / atol 1e-3.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.ops import se3 as jse3
from cvo_slam_tpu.parallel import sharded_ba as jsb
from cvo_slam_tpu.parallel import sharded_lm as jsl
from cvo_slam_tpu_torch.backend import ba as tba
from cvo_slam_tpu_torch.backend import lm as tlm
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import engine as tengine
from cvo_slam_tpu_torch.parallel import batch as tbatch
from cvo_slam_tpu_torch.parallel import sharded_ba as tsb
from cvo_slam_tpu_torch.parallel import sharded_lm as tsl
from cvo_slam_tpu_torch.parallel.mesh import Mesh
from test_ba import K, make_problem
from test_lm import build_chain
from test_torch_lanes import _lane_inputs

torch.set_num_threads(2)
TP = from_reference(CvoParams())
BA_KEYS = ("E0", "L0", "free_pose", "lm_mask", "ei", "ej", "Z", "omega",
           "pemask", "p_kf", "p_lm", "p_meas", "p_w", "p_mask")
SHARD_KEYS = ("L0", "lm_mask", "p_kf", "p_lm", "p_meas", "p_w", "p_mask",
              "ei", "ej", "Z", "omega", "pemask")


def _cpu_mesh(n):
    return Mesh([torch.device("cpu")] * n)


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("dp",))


# -- the mesh -----------------------------------------------------------------

def test_mesh_psum_in_shard_order():
    """psum adds the shards' partials left to right (bit for bit), a tuple
    in one buffer; pmax, gather; bad inputs raise."""
    rng = np.random.default_rng(0)
    parts = [torch.as_tensor(rng.normal(size=(5, 6)).astype(np.float32))
             for _ in range(3)]
    mesh = _cpu_mesh(3)
    assert torch.equal(mesh.psum(parts), (parts[0] + parts[1]) + parts[2])
    a, b = mesh.psum([(p, p.sum()) for p in parts])
    assert torch.equal(a, (parts[0] + parts[1]) + parts[2])
    assert torch.equal(b, (parts[0].sum() + parts[1].sum()) + parts[2].sum())
    assert float(mesh.pmax([p.max() for p in parts])) == \
        max(float(p.max()) for p in parts)
    assert torch.equal(mesh.gather([p[None] for p in parts]),
                       torch.stack(parts))
    assert mesh.collectives == 4
    with pytest.raises(ValueError):
        mesh.psum(parts[:2])


def test_mesh_on_cards_places_shards_by_one_rule(monkeypatch):
    """Mesh.on_cards: n CPU shards on the CPU, shared or not; on cuda one
    shard per card (raising with fewer cards) or, shared, round-robin over
    the cards; a request for the card raises where there is none (no quiet
    CPU mesh). The card count is faked, so no card is touched."""
    for shared in (False, True):
        mesh = Mesh.on_cards(3, "cpu", shared=shared)
        assert mesh.devices == [torch.device("cpu")] * 3
        assert mesh.local_shards == [0, 1, 2] and mesh.size == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert Mesh.on_cards(2, "cuda").devices == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="needs 3 cards"):
        Mesh.on_cards(3, "cuda")
    assert [d.index for d in Mesh.on_cards(5, "cuda", shared=True).devices] \
        == [0, 1, 0, 1, 0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Mesh.on_cards(2, "cuda", shared=True)


# -- the edge-sharded LM ------------------------------------------------------

@pytest.fixture(scope="module")
def chain10():
    g, _, _ = build_chain(np.random.default_rng(0), 10, noise=0.01)
    return g, tlm.pose_graph_from_reference(g, device="cpu")


def _assert_lm(E, c, E_want, c_want):
    np.testing.assert_allclose(float(c), float(c_want), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(E), np.asarray(E_want), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_lm_matches_single_device_and_jax(chain10, n):
    """The port's sharded LM (dense) on n shards against the port's
    lm.optimize and the JAX package's sharded LM on n devices."""
    g, tg = chain10
    E1, c1 = tlm.optimize(tg, 10, robust_delta=2.0)
    E2, c2 = tsl.optimize_sharded(tg, _cpu_mesh(n), 10, robust_delta=2.0)
    _assert_lm(E2, c2, E1, c1)
    Ej, cj = jsl.optimize_sharded(g, _jmesh(n), 10, robust_delta=2.0)
    _assert_lm(E2, c2, jax.device_get(Ej), cj)


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_lm_pcg_matches_dense(n):
    """pcg against dense on the same mesh (test_sharded_lm.py:41), and
    against the JAX package's pcg."""
    g, _, _ = build_chain(np.random.default_rng(2), 10, noise=0.01)
    tg = tlm.pose_graph_from_reference(g, device="cpu")
    Ed, cd = tsl.optimize_sharded(tg, _cpu_mesh(n), 10, robust_delta=2.0,
                                  solver="dense")
    Ep, cp = tsl.optimize_sharded(tg, _cpu_mesh(n), 10, robust_delta=2.0,
                                  solver="pcg")
    _assert_lm(Ep, cp, Ed, cd)
    Ej, cj = jsl.optimize_sharded(g, _jmesh(n), 10, robust_delta=2.0,
                                  solver="pcg")
    _assert_lm(Ep, cp, jax.device_get(Ej), cj)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_sharded_lm_converges_to_truth(solver):
    """test_sharded_lm.py:25's problem: a noise-free chain with perturbed
    poses, 4 shards: chi2 below 1e-8, poses within 1e-3 of the truth."""
    rng = np.random.default_rng(1)
    g, _, E_true = build_chain(rng, 8)
    E0 = np.asarray(g.E).copy()
    E0[1:8] = np.asarray(jse3.exp_se3(
        rng.normal(0, 0.03, (7, 6)).astype(np.float32))) @ E0[1:8]
    tg = tlm.pose_graph_from_reference(g._replace(E=E0), device="cpu")
    E_opt, chi2 = tsl.optimize_sharded(tg, _cpu_mesh(4), 15, solver=solver)
    assert float(chi2) < 1e-8
    np.testing.assert_allclose(E_opt.numpy()[:8], E_true, atol=1e-3)


# -- the sharded Schur BA -----------------------------------------------------

def _ba_host(seed, n_lm=40):
    args, _, _ = make_problem(seed=seed, n_lm=n_lm)
    return {k: np.asarray(v) for k, v in args.items()}


def _port_ba(a, iters=10, solver="dense"):
    t = [torch.as_tensor(a[k].astype(np.int64) if a[k].dtype == np.int32
                         else a[k].copy()) for k in BA_KEYS]
    E, L = tba.optimize_ba(*t, torch.as_tensor(K), iters, 2.0, solver=solver)
    return E.numpy(), L.numpy()


def _port_sharded(a, n, solver="dense", iters=10):
    sharded, perm, per_dev = tsb.shard_ba_problem(
        n, *(a[k] for k in SHARD_KEYS))
    E, Ls = tsb.optimize_ba_sharded(a["E0"], a["free_pose"], sharded, K,
                                    iters, 2.0, _cpu_mesh(n), solver=solver)
    L = Ls.reshape(-1, 3).numpy()[np.argsort(perm)][:len(a["L0"])]
    return E.numpy(), L, sharded, per_dev


def _jax_sharded(a, n, solver="dense"):
    sharded, perm, _ = jsb.shard_ba_problem(n, *(a[k] for k in SHARD_KEYS))
    E, Ls = jsb.optimize_ba_sharded(a["E0"], a["free_pose"], sharded, K, 10,
                                    2.0, _jmesh(n), solver=solver)
    L = np.asarray(Ls).reshape(-1, 3)[:len(perm)][np.argsort(perm)]
    return np.asarray(E), L


def _assert_ba(E, L, E_want, L_want):
    np.testing.assert_allclose(E, E_want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(L, L_want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_ba_matches_single_device_and_jax(n):
    """40 landmarks (a multiple of every n): the port's sharded BA against
    the port's optimize_ba and the JAX package's sharded BA
    (test_ba.py:95)."""
    a = _ba_host(1)
    E, L, _, _ = _port_sharded(a, n)
    _assert_ba(E, L, *_port_ba(a))
    _assert_ba(E, L, *_jax_sharded(a, n))


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_ba_pcg_matches_dense(n):
    """pcg against dense at 1 and 4 shards (test_ba.py:126), and against
    the JAX package's pcg."""
    a = _ba_host(2)
    Ed, Ld, _, _ = _port_sharded(a, n, "dense")
    Ep, Lp, _, _ = _port_sharded(a, n, "pcg")
    _assert_ba(Ep, Lp, Ed, Ld)
    _assert_ba(Ep, Lp, *_jax_sharded(a, n, "pcg"))


@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_sharded_ba_uneven_landmarks(n, solver):
    """10 landmarks on n shards (n does not divide 10): every landmark
    sits in its owner's block (landmark i in row (i % n) * per_dev + i //
    n) with its edges, and the result matches the single device, where
    the JAX package's layout puts a landmark in the wrong block."""
    a = _ba_host(1, n_lm=10)
    E, L, sharded, per_dev = _port_sharded(a, n, solver)
    for i in range(10):
        d, k = i % n, i // n
        np.testing.assert_array_equal(sharded["L"][d, k], a["L0"][i])
        assert sharded["lm_mask"][d, k]
        ours = sharded["p_mask"][d] & (sharded["p_lm"][d] == k)
        assert ours.sum() == (a["p_lm"] == i).sum()
    assert sharded["lm_mask"].sum() == 10
    _assert_ba(E, L, *_port_ba(a, solver=solver))


# -- the sharded align --------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shared", [False, True])
def test_make_sharded_align_equals_batched_align(n, shared):
    """Four lanes over n shards under pallas: every output of every lane
    equal to batched_align's bit for bit, with per-lane fixed clouds and
    with one shared fixed cloud."""
    (x, f, m), moving, R0, T0, ell0 = _lane_inputs()
    moving = np.concatenate([moving, moving[:1]])
    R0, T0, ell0 = (np.concatenate([v, v[:1]]) for v in (R0, T0, ell0))
    S = moving.shape[0]
    fixed = tengine.PointCloud(*(torch.as_tensor(a if shared
                                                 else np.stack([a] * S))
                                 for a in (x, f, m)))
    mov = tengine.PointCloud(torch.as_tensor(moving),
                             torch.as_tensor(np.stack([f] * S)),
                             torch.as_tensor(np.stack([m] * S)))
    args = (fixed, mov, torch.as_tensor(R0), torch.as_tensor(T0),
            torch.as_tensor(ell0))
    want = tbatch.batched_align(*args, TP, backend="pallas")
    mesh = _cpu_mesh(n)
    got = tbatch.make_sharded_align(mesh, TP, backend="pallas")(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert mesh.collectives == len(want)
    with pytest.raises(ValueError):
        tbatch.make_sharded_align(_cpu_mesh(3), TP)(*args)
