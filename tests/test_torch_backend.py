"""Port parity, backend layer: loop-closure scoring, the pose-graph LM and
windowed BA of cvo_slam_tpu_torch against the JAX package on the same numpy
problems (CPU).

  * engine.compute_innerproduct_lc (six pair-stats calls without moments,
    two with) against the JAX package's (backend "xla", the fused
    ip_suite_lc) and the port's own ip_suite_lc oracle;
  * backend.lm.optimize on tests/test_lm.py's graphs, and one batched call
    that equals its per-lane solo calls exactly;
  * backend.ba.optimize_ba, dense and PCG, on tests/test_ba.py's problems.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cvo_slam_tpu.backend import ba as jba
from cvo_slam_tpu.backend import lm as jlm
from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import engine as jengine
from cvo_slam_tpu.ops import pairwise as jpw
from cvo_slam_tpu.ops import se3 as jse3
from cvo_slam_tpu_torch.backend import ba as tba
from cvo_slam_tpu_torch.backend import lm as tlm
from cvo_slam_tpu_torch.config import arrays_from_reference, from_reference
from cvo_slam_tpu_torch.cvo import engine as tengine
from cvo_slam_tpu_torch.ops import pairwise as tpw
from cvo_slam_tpu_torch.ops import se3 as tse3
from test_ba import K, make_problem
from test_lm import build_chain
from test_torch_engine import XI, _pair, _port_cloud

torch.set_num_threads(2)
P = CvoParams()
TP = from_reference(P)


def _exp(xi):
    return np.asarray(jse3.exp_se3(jnp.asarray(np.asarray(xi, np.float32))),
                      np.float32)


# -- loop-closure scoring ----------------------------------------------------

LC_KEYS = ("inn_prior", "inn_lc_prior", "inn_lc_pre", "inn_lc_post",
           "inn_fixed", "inn_moving", "cos_angle")


def _assert_lc(got, want):
    """Inliers exact, the six inner products and cos within rtol 1e-4, the
    post-Hessian within 1e-3 of max|H| (its f32 moment algebra cancels
    ~1e3-fold, see tests/test_torch_engine.py)."""
    for key in ("inliers_svd", "inliers_pnpransac"):
        assert int(got[key]) == int(want[key]), key
    for key in LC_KEYS:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, err_msg=key)
    H_w = np.asarray(want["post_hessian"], np.float64)
    H_g = np.asarray(got["post_hessian"], np.float64)
    assert np.abs(H_g - H_w).max() <= 1e-3 * np.abs(H_w).max()


def _lc_inputs(seed, which):
    fixed, moved = _pair(seed, XI[which])
    trans = dict(prior=_exp(0.5 * XI[which]), lc_prior=_exp(0.9 * XI[which]),
                 lc_prior_2=np.eye(4, dtype=np.float32),
                 lc_tran=np.linalg.inv(_exp(XI[which])).astype(np.float32))
    return fixed, moved, trans, np.float32(0.1)


@pytest.mark.parametrize("case", [(0, 0), (0, 1)])
def test_compute_innerproduct_lc_parity(case):
    """Against the JAX package's compute_innerproduct_lc (backend xla):
    inliers exact, the inner products within rtol 1e-4."""
    fixed, moved, trans, ell = _lc_inputs(*case)
    want = jengine.compute_innerproduct_lc(
        fixed, moved, *(jnp.asarray(t) for t in trans.values()),
        jnp.float32(ell), P, "xla")
    got = tengine.to_host(tengine.compute_innerproduct_lc(
        _port_cloud(fixed), _port_cloud(moved), *trans.values(), ell, TP))
    assert int(want["inliers_svd"]) > 500   # the gates pass real pairs
    _assert_lc(got, want)


@pytest.mark.parametrize("case", [(0, 0), (1, 1)])
def test_compute_innerproduct_lc_equal_inputs(case):
    """On the port's transformed clouds, the JAX package's fused suite
    (ops.pairwise.ip_suite_lc, run op by op) and the port's own oracle give
    the counts of the pair-stats route exactly.

    Case (1, 1) is why the comparison runs op by op: there the JAX package's
    jitted compute_innerproduct_lc counts 912 gated pairs in the fixed
    cloud's self product and 911 inliers, where the same functions run op
    by op (and the port) count 910 and 910; XLA's fusion rounds the
    intermediate distances differently, so two pairs at the gate boundary
    flip. Its xla and pallas backends both give the fused counts."""
    fixed, moved, trans, ell = _lc_inputs(*case)
    tf, tm = _port_cloud(fixed), _port_cloud(moved)
    got = tengine.to_host(tengine.compute_innerproduct_lc(
        tf, tm, *trans.values(), ell, TP))
    moved_by = [tse3.transform_points(torch.tensor(t), tm.positions)
                for t in (trans["prior"], trans["lc_prior"],
                          trans["lc_prior_2"], trans["lc_tran"])]
    ref_j = jpw.ip_suite_lc(*(jnp.asarray(np.asarray(a)) for a in fixed),
                            *(jnp.asarray(np.asarray(a)) for a in moved),
                            *(jnp.asarray(m.numpy()) for m in moved_by),
                            jnp.float32(ell), P)
    ref_t = tpw.ip_suite_lc(*tf, *tm, *moved_by, torch.tensor(ell), TP)
    for ref, rtol in ((ref_j, 1e-4), (ref_t, 1e-5)):
        assert int(got["inliers_svd"]) == int(ref[7])
        assert int(got["inliers_pnpransac"]) == int(ref[8])
        for key, v in zip(LC_KEYS[:6], ref[:6]):
            np.testing.assert_allclose(float(got[key]), float(v), rtol=rtol,
                                       err_msg=key)


def test_lc_verify_batch_parity():
    """Two candidates re-registered from their priors and scored: the
    port's loop equals the JAX package's vmapped batch lane by lane."""
    pairs = [_pair(0, XI[0]), _pair(0, XI[1])]
    fixed = pairs[0][0]
    priors = [_exp(0.8 * XI[0]), _exp(0.8 * XI[1])]
    inv = [np.linalg.inv(pr) for pr in priors]
    R0 = np.stack([m[:3, :3] for m in inv]).astype(np.float32)
    T0 = np.stack([m[:3, 3] for m in inv]).astype(np.float32)
    movings = jengine.PointCloud(*(jnp.stack([getattr(m, f) for _, m in pairs])
                                   for f in ("positions", "features", "mask")))
    ell0 = np.full(2, P.ell_init, np.float32)
    want_res, want_lc = jengine.lc_verify_batch(
        fixed, movings, jnp.asarray(R0), jnp.asarray(T0), jnp.asarray(ell0),
        jnp.asarray(np.stack(priors)), jnp.asarray(np.stack(priors)), P,
        "xla")
    got = tengine.lc_verify_batch(
        _port_cloud(fixed), [_port_cloud(m) for _, m in pairs], R0, T0, ell0,
        priors, priors, TP)
    for k, (res, lc) in enumerate(got):
        assert abs(int(res.iters) - int(want_res.iters[k])) <= 3
        np.testing.assert_allclose(res.transform.numpy(),
                                   np.asarray(want_res.transform[k]),
                                   atol=1e-4)
        want_k = {key: np.asarray(v[k]) for key, v in want_lc.items()}
        lc = tengine.to_host(lc)
        for key in ("inliers_svd", "inliers_pnpransac"):
            assert abs(int(lc[key]) - int(want_k[key])) \
                <= 2e-3 * int(want_k[key]), key
        for key in LC_KEYS:
            np.testing.assert_allclose(float(lc[key]), float(want_k[key]),
                                       rtol=1e-3, err_msg=key)


# -- pose-graph LM -------------------------------------------------------------

def _perturbed(seed, n, sigma, **kw):
    """tests/test_lm.py's chain with every free vertex perturbed."""
    rng = np.random.default_rng(seed)
    g, _, E_true = build_chain(rng, n, **kw)
    E0 = np.asarray(g.E).copy()
    E0[1:n] = np.asarray(jse3.exp_se3(jnp.asarray(
        rng.normal(0, sigma, (n - 1, 6)).astype(np.float32)))) @ E0[1:n]
    return g._replace(E=jnp.asarray(E0)), E_true


def _outlier_graph():
    """tests/test_lm.py's corrupted loop edge at a realistic information
    scale (test_cauchy_downweights_outlier)."""
    rng = np.random.default_rng(5)
    g, _, _ = build_chain(rng, 6)
    Z = np.asarray(g.Z).copy()
    Z[5] = _exp([0.4, -0.3, 0.2, 0.5, 0.4, -0.6]) @ Z[5]
    return g._replace(Z=jnp.asarray(Z),
                      omega=jnp.asarray(np.asarray(g.omega) * 100.0))


LM_CASES = {
    "perturbed": lambda: (_perturbed(1, 6, 0.05)[0], 20, 0.0),
    "noisy": lambda: (build_chain(np.random.default_rng(2), 8,
                                  noise=0.02)[0], 15, 0.0),
    "padded": lambda: (_perturbed(4, 6, 0.05, cap_v=10, cap_e=12)[0], 10,
                       0.0),
    "cauchy": lambda: (_outlier_graph(), 25, 2.0),
}


@pytest.mark.parametrize("name", sorted(LM_CASES))
def test_lm_optimize_parity(name):
    """Inverse poses within 1e-3, the bar tests/test_lm.py holds a recovered
    pose to, and the final chi2 within rtol 1e-3 or 1e-6 absolute.

    The reference's SO(3) log reads the angle from acos((tr R - 1) / 2): in
    f32 an edge error below ~3.5e-4 rad rounds to a trace of exactly 3 and
    reads as zero, and a one-ulp difference of a 4x4 product decides which
    (the "padded" graph: 4.2e-4 apart after the first outer iteration that
    lands there, both packages at chi2 < 1e-8)."""
    g, iters, delta = LM_CASES[name]()
    E_w, c_w = jlm.optimize(g, iters, robust_delta=delta)
    E_g, c_g = tlm.optimize(tlm.pose_graph_from_reference(g, "cpu"), iters,
                            robust_delta=delta)
    np.testing.assert_allclose(E_g.numpy(), np.asarray(E_w), atol=1e-3)
    np.testing.assert_allclose(float(c_g), float(c_w), rtol=1e-3, atol=1e-6)


def test_lm_batched_equals_solo():
    """Lanes that converge at different outer iterations: each lane of one
    batched call equals its solo call bit for bit."""
    graphs = [_perturbed(s, 8, sig, cap_v=8, cap_e=8)[0]
              for s, sig in ((1, 0.05), (2, 0.002), (3, 0.1))]
    solo = [tlm.optimize(tlm.pose_graph_from_reference(g, "cpu"), 30, 2.0)
            for g in graphs]
    lanes = [tlm.pose_graph_from_reference(g, "cpu") for g in graphs]
    batch = tlm.PoseGraph(*(torch.stack(f) for f in zip(*lanes)))
    E_b, c_b = tlm.optimize(batch, 30, 2.0)
    for k, (E_s, c_s) in enumerate(solo):
        torch.testing.assert_close(E_b[k], E_s, rtol=0, atol=0)
        torch.testing.assert_close(c_b[k], c_s, rtol=0, atol=0)


# -- windowed BA ---------------------------------------------------------------

BA_ORDER = ("E0", "L0", "free_pose", "lm_mask", "ei", "ej", "Z", "omega",
            "pemask", "p_kf", "p_lm", "p_meas", "p_w", "p_mask")


def _port_args(args):
    a = arrays_from_reference(args)
    out = [torch.as_tensor(a[k]) for k in BA_ORDER]
    for i in (4, 5, 9, 10):          # edge endpoints as int64 indices
        out[i] = out[i].long()
    return out


@pytest.mark.parametrize("solver", ["dense", "pcg"])
@pytest.mark.parametrize("seed,iters,delta", [(0, 15, 0.0), (3, 10, 2.0)])
def test_optimize_ba_parity(solver, seed, iters, delta):
    """tests/test_ba.py's bars between solvers: E rtol 1e-3 / atol 1e-4,
    landmarks rtol 1e-3 / atol 1e-3."""
    args, E_true, _ = make_problem(seed=seed)
    E_w, L_w = jba.optimize_ba(*(args[k] for k in BA_ORDER), jnp.asarray(K),
                               iters, delta, solver=solver)
    E_g, L_g = tba.optimize_ba(*_port_args(args), torch.as_tensor(K), iters,
                               delta, solver=solver)
    np.testing.assert_allclose(E_g.numpy(), np.asarray(E_w), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(L_g.numpy(), np.asarray(L_w), rtol=1e-3,
                               atol=1e-3)
    if delta == 0.0:
        np.testing.assert_allclose(E_g.numpy(), E_true, atol=2e-3)
