"""Port parity, loop-closure scoring as lanes and lane stacks of any
capacity (CPU): engine.compute_innerproduct_lc_lanes against
compute_innerproduct_lc candidate by candidate, bit for bit;
engine.lc_verify_batch on three candidates against the JAX package's
vmapped lc_verify_batch; its pair-stats calls per round; and
engine.stack_clouds at capacities that are not a multiple of 16, which the
lane kernels' checks accept. On a card: every lane of align_fused_lanes,
ip_suite_lanes and pair_stats_lanes at such capacities against its solo
launch."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import engine as jengine
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import engine as tengine
from cvo_slam_tpu_torch.cvo import kernels
from cvo_slam_tpu_torch.ops import se3 as tse3
from test_torch_backend import LC_KEYS, _exp
from test_torch_engine import XI, _pair, _port_cloud

torch.set_num_threads(2)
P = CvoParams()
TP = from_reference(P)
# three candidates of one reference: test_torch_backend.py's two steps and
# a third, smaller one against them
STEPS = (XI[0], XI[1], -0.5 * XI[0])


def _candidates():
    """The reference (JAX), the candidates (JAX) and their priors and warm
    starts (each the inverse of 0.8 of its step)."""
    pairs = [_pair(0, xi) for xi in STEPS]
    priors = [_exp(0.8 * xi) for xi in STEPS]
    inv = [np.linalg.inv(pr) for pr in priors]
    R0 = np.stack([m[:3, :3] for m in inv]).astype(np.float32)
    T0 = np.stack([m[:3, 3] for m in inv]).astype(np.float32)
    return pairs[0][0], [m for _, m in pairs], priors, R0, T0


def _cloud(n, seed):
    """A random port cloud of n points, a tenth masked out."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0.0, 0.3, (n, 3)).astype(np.float32) + [0.0, 0.0, 2.0]
    return tengine.PointCloud(
        torch.as_tensor(pos.astype(np.float32)),
        torch.as_tensor(rng.uniform(0, 1, (n, 5)).astype(np.float32)),
        torch.as_tensor(rng.uniform(size=n) > 0.1))


@pytest.mark.parametrize("cap", [3000, 250, 3072])
def test_stack_clouds_any_capacity(cap):
    """A stack of three clouds of any capacity (ETH3D-shaped 3000, 250, and
    a multiple of 16) passes the lane kernels' checks: every lane's
    positions, features and mask 16-byte aligned at one lane stride, each
    lane equal to its cloud; a multiple of 16 keeps torch.stack's layout."""
    clouds = [_cloud(cap, s) for s in range(3)]
    st = tengine.stack_clouds(clouds)
    for l, c in enumerate(clouds):
        for got, want in zip(st, c):
            assert torch.equal(got[l], want)
    kernels._check_staged("moving", *st)
    stride = kernels._check_lane_cloud("moving", *st, 3, cap,
                                       torch.device("cpu"))
    assert stride == -(-cap // 16) * 16
    assert st.mask.is_contiguous() == (cap % 16 == 0)
    # a stack at the lanes' stride is taken as it is, another laid at it
    yt = kernels.stack_lanes([c.positions for c in clouds])
    assert kernels._at_lane_stride(yt, stride) is yt
    flat = torch.stack([c.positions for c in clouds])
    again = kernels._at_lane_stride(flat, stride)
    assert torch.equal(again, flat) and kernels._lane_layout(again, stride)


def test_lane_stacks_of_odd_capacity_rejected():
    """torch.stack of clouds of 3000 points leaves lane 1's mask 3000 bytes
    in, and a stack whose arrays lie at different lane strides has no one
    lane stride: the checks refuse both before any build."""
    clouds = [_cloud(3000, s) for s in range(3)]
    flat = [torch.stack(list(t)) for t in zip(*clouds)]
    with pytest.raises(ValueError, match="every lane"):
        kernels._check_staged("moving", *flat)
    ref = clouds[0]
    with pytest.raises(ValueError, match="every lane"):
        kernels.pair_stats_lanes_cuda(*flat, *flat, torch.full((3,), 0.1),
                                      TP)
    # rows whose positions lie at another lane stride than their mask
    st = tengine.stack_clouds(clouds)
    with pytest.raises(ValueError, match="stack_clouds"):
        kernels.pair_stats_lanes_cuda(st.positions, flat[1], flat[2], *ref,
                                      torch.full((3,), 0.1), TP)


def test_compute_innerproduct_lc_lanes_equal_single_calls():
    """Three candidates scored as lanes (pair_stats_lanes, plain on the
    CPU) equal three compute_innerproduct_lc calls bit for bit, each with
    its own transforms and ell."""
    fixed, movings, priors, _, _ = _candidates()
    ref = _port_cloud(fixed)
    cands = [_port_cloud(m) for m in movings]
    lc_priors = [_exp(0.9 * xi) for xi in STEPS]
    lc_trans = [_exp(xi) for xi in STEPS]
    eye = [np.eye(4, dtype=np.float32)] * 3
    ells = [np.float32(0.1), np.float32(0.06), np.float32(0.1)]
    got = tengine.compute_innerproduct_lc_lanes(ref, cands, priors,
                                                lc_priors, eye, lc_trans,
                                                ells, TP)
    for l, c in enumerate(cands):
        want = tengine.compute_innerproduct_lc(ref, c, priors[l],
                                               lc_priors[l], eye[l],
                                               lc_trans[l], ells[l], TP)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k][l], want[k]), (l, k)
        assert int(want["inliers_svd"]) > 0


@pytest.fixture(scope="module")
def jax_batch():
    """The JAX package's vmapped lc_verify_batch ('xla') on the three
    candidates."""
    fixed, movings, priors, R0, T0 = _candidates()
    stacked = jengine.PointCloud(*(jnp.stack([getattr(m, f) for m in movings])
                                   for f in ("positions", "features",
                                             "mask")))
    ell0 = np.full(3, P.ell_init, np.float32)
    return jengine.lc_verify_batch(
        fixed, stacked, jnp.asarray(R0), jnp.asarray(T0), jnp.asarray(ell0),
        jnp.asarray(np.stack(priors)), jnp.asarray(np.stack(priors)), P,
        "xla")


@pytest.mark.parametrize("backend", ["pallas_mom", "xla"])
def test_lc_verify_batch_three_candidates_matches_jax(jax_batch, backend):
    """Three candidates re-registered and scored as lanes: each within
    tests/test_torch_backend.py's lc_verify_batch bars of the JAX package's
    vmapped batch (iterations within 3, transform atol 1e-4, inliers within
    2e-3, inner products and cos rtol 1e-3)."""
    want_res, want_lc = jax_batch
    fixed, movings, priors, R0, T0 = _candidates()
    got = tengine.lc_verify_batch(
        _port_cloud(fixed), [_port_cloud(m) for m in movings], R0, T0,
        np.full(3, P.ell_init, np.float32), priors, priors, TP, backend)
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


@pytest.mark.parametrize("n", [1, 3])
def test_lc_verify_batch_pair_stats_calls(n, monkeypatch):
    """A round of n >= 2 candidates scores them in 8 pair-stats lanes calls
    (6 without moments, 2 with), the fixed self set's included; one
    candidate takes the 8 one-lane calls, as the live detector does; each
    candidate's result equals its one-candidate call bit for bit."""
    fixed, movings, priors, R0, T0 = _candidates()
    ref = _port_cloud(fixed)
    cands = [_port_cloud(m) for m in movings[:n]]
    calls = {"pair_stats": 0, "pair_stats_lanes": []}
    solo_fn, lanes_fn = kernels.pair_stats, kernels.pair_stats_lanes

    def solo(*a, **k):
        calls["pair_stats"] += 1
        return solo_fn(*a, **k)

    def lanes(*a, **k):
        calls["pair_stats_lanes"].append(a[6].shape[0])
        return lanes_fn(*a, **k)

    monkeypatch.setattr(kernels, "pair_stats", solo)
    monkeypatch.setattr(kernels, "pair_stats_lanes", lanes)
    ell0 = np.full(n, P.ell_init, np.float32)
    got = tengine.lc_verify_batch(ref, cands, R0[:n], T0[:n], ell0,
                                  priors[:n], priors[:n], TP, "pallas")
    if n == 1:
        assert calls == {"pair_stats": 8, "pair_stats_lanes": []}
        return
    assert calls == {"pair_stats": 0, "pair_stats_lanes": [n] * 8}
    calls["pair_stats"] = 0
    for l, (res, lc) in enumerate(got):
        (res1, lc1), = tengine.lc_verify_batch(
            ref, [cands[l]], R0[l:l + 1], T0[l:l + 1], ell0[l:l + 1],
            priors[l:l + 1], priors[l:l + 1], TP, "pallas")
        for a, b in zip(res, res1):
            assert torch.equal(a, b)
        for k in lc1:
            assert torch.equal(lc[k], lc1[k]), (l, k)
    assert calls["pair_stats"] == 8 * n


# -- on the card -------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check")


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [3000, 250])
def test_lanes_any_capacity_cuda(cap):
    """On a card, clouds of a capacity that is not a multiple of 16 stacked
    by stack_clouds: every lane of align_fused_lanes (distinct and shared
    fixed clouds), ip_suite_lanes and pair_stats_lanes (both modes) equals
    its solo launch bit for bit."""
    _need_card()
    S = 3
    clouds = [tengine.PointCloud(*(t.cuda() for t in _cloud(cap, s)))
              for s in range(S + 1)]
    ref, movs = clouds[0], clouds[1:]
    st = tengine.stack_clouds(movs)
    fx_st = tengine.stack_clouds(clouds[:S])
    R0 = torch.eye(3, device="cuda").expand(S, 3, 3).contiguous()
    T0 = torch.zeros(S, 3, device="cuda")
    ells = torch.tensor([0.1, 0.06, 0.1], device="cuda")
    for fixed in (ref, fx_st):
        got = kernels.align_fused_lanes_cuda(*fixed, *st, R0, T0, ells, TP)
        for l in range(S):
            x = ref if fixed is ref else clouds[l]
            solo = kernels.align_fused_cuda(*x, *movs[l], R0[l].contiguous(),
                                            T0[l].contiguous(), ells[l], TP)
            assert all(torch.equal(g[l], w) for g, w in zip(got, solo)), l
    tw = tse3.exp_se3(torch.tensor([0.01, 0.02, -0.01, 0.03, -0.02, 0.01],
                                   device="cuda"))
    yts = [tse3.transform_points(tw, m.positions).contiguous() for m in movs]
    got = kernels.ip_suite_lanes_cuda(*fx_st, *st, torch.stack(yts), ells,
                                      TP)
    for l in range(S):
        solo = kernels.ip_suite_cuda(*clouds[l], *movs[l], yts[l], ells[l],
                                     TP)
        assert all(torch.equal(g[l], w) for g, w in zip(got, solo)), l
    rows = kernels.stack_lanes(yts)
    for mom in (False, True):
        for cols in (ref, st):
            got = kernels.pair_stats_lanes_cuda(rows, st.features, st.mask,
                                                *cols, ells, TP, mom)
            for l in range(S):
                c = ref if cols is ref else movs[l]
                solo = kernels.pair_stats_cuda(yts[l], movs[l].features,
                                               movs[l].mask, *c, ells[l], TP,
                                               mom)
                assert all(torch.equal(g[l], w)
                           for g, w in zip(got, solo)), l
