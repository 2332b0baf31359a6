"""Port parity, the lanes of the align and suite kernels: the port's
batched align and suite lanes (the plain versions, CPU) against the JAX
package's vmapped Pallas kernels (interpret mode), loop-closure candidates
as lanes against one-candidate calls, and (on a card) every lane of the
CUDA kernels against its one-lane launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import engine as jengine
from cvo_slam_tpu.cvo import pallas_kernels as pk
from cvo_slam_tpu.parallel import batch as jbatch
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import engine as tengine
from cvo_slam_tpu_torch.cvo import kernels
from cvo_slam_tpu_torch.parallel import batch as tbatch
from test_torch_align import _megakernel_clouds, _rigid_err, _torch
from test_torch_kernels import _assert_suite, _suite_inputs

torch.set_num_threads(2)
P = CvoParams()
TP = from_reference(P)


def _lane_inputs():
    """Three lanes on the CAP-512 megakernel fixture: a cold start from the
    identity, a warm start from the cold lane's result (the port's one-lane
    align, which test_align_matches_megakernel holds to the JAX megakernel),
    and a lane whose moving cloud is the fixed one (it stops early and stays
    frozen while the others run)."""
    (x, f, m), (y, _, _), _ = _megakernel_clouds()
    cold = tengine.align(tengine.PointCloud(*_torch((x, f, m))),
                         tengine.PointCloud(*_torch((y, f, m))),
                         np.eye(3, dtype=np.float32),
                         np.zeros(3, np.float32), np.float32(P.ell_init), TP,
                         "pallas")
    moving = np.stack([y, y, x])
    R0 = np.stack([np.eye(3, dtype=np.float32), cold.R.numpy(),
                   np.eye(3, dtype=np.float32)])
    T0 = np.stack([np.zeros(3, np.float32), cold.T.numpy(),
                   np.zeros(3, np.float32)])
    ell0 = np.array([P.ell_init, float(cold.ell), P.ell_init], np.float32)
    return (x, f, m), moving, R0, T0, ell0


@pytest.fixture(scope="module")
def lanes():
    """The inputs and the JAX package's batched align (vmap of its Pallas
    megakernel, interpret mode) on them."""
    (x, f, m), moving, R0, T0, ell0 = _lane_inputs()
    lanes = moving.shape[0]
    fixed = jengine.PointCloud(*(jnp.asarray(np.stack([a] * lanes))
                                 for a in (x, f, m)))
    mov = jengine.PointCloud(jnp.asarray(moving),
                             jnp.asarray(np.stack([f] * lanes)),
                             jnp.asarray(np.stack([m] * lanes)))
    with pltpu.force_tpu_interpret_mode():
        want = jbatch.batched_align(fixed, mov, jnp.asarray(R0),
                                    jnp.asarray(T0), jnp.asarray(ell0), P,
                                    backend="pallas")
    return ((x, f, m), moving, R0, T0, ell0), jax.device_get(tuple(want))


def test_batched_align_matches_jax(lanes):
    """The port's batched_align under pallas against the JAX package's on
    three lanes: iterations, nnz and ell exact, the transform within 1e-5
    (test_align_matches_megakernel's bars); the third lane stops first."""
    ((x, f, m), moving, R0, T0, ell0), want = lanes
    n = moving.shape[0]
    fixed = tengine.PointCloud(*(torch.as_tensor(np.stack([a] * n))
                                 for a in (x, f, m)))
    mov = tengine.PointCloud(torch.as_tensor(moving),
                             torch.as_tensor(np.stack([f] * n)),
                             torch.as_tensor(np.stack([m] * n)))
    got = tbatch.batched_align(fixed, mov, torch.as_tensor(R0),
                               torch.as_tensor(T0), torch.as_tensor(ell0),
                               TP, "pallas")
    _, _, w_tr, w_ell, w_iters, w_nnz = want
    for l in range(n):
        assert int(got.iters[l]) == int(w_iters[l]) < P.max_iter, l
        assert int(got.nnz[l]) == int(w_nnz[l]), l
        assert float(got.ell[l]) == float(w_ell[l]), l
        dt, da = _rigid_err(got.transform[l].numpy(), w_tr[l])
        assert dt < 1e-5 and da < 1e-5, (l, dt, da)
    assert int(got.iters[2]) < int(got.iters[0])


def test_batched_align_shared_fixed_cloud(lanes):
    """One fixed cloud of every lane (lc_verify_batch's broadcast
    reference) gives what a stack of copies gives, bit for bit."""
    ((x, f, m), moving, R0, T0, ell0), _ = lanes
    n = moving.shape[0]
    mov = tengine.PointCloud(torch.as_tensor(moving),
                             torch.as_tensor(np.stack([f] * n)),
                             torch.as_tensor(np.stack([m] * n)))
    args = (torch.as_tensor(R0), torch.as_tensor(T0), torch.as_tensor(ell0),
            TP, "pallas")
    shared = tbatch.batched_align(tengine.PointCloud(*_torch((x, f, m))),
                                  mov, *args)
    stacked = tbatch.batched_align(
        tengine.PointCloud(*(torch.as_tensor(np.stack([a] * n))
                             for a in (x, f, m))), mov, *args)
    for a, b in zip(shared, stacked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ell", [(0.15, 0.06, 0.1)])
def test_ip_suite_lanes_matches_jax(ell):
    """ip_suite_lanes (plain) against the JAX package's vmapped Pallas suite
    (interpret mode) on three lanes of distinct clouds and ells: counts and
    inliers exact, sums rtol 1e-4, G atol 1e-5 after scaling by max |G|
    (chip_smoke.py phase 2's suite bars)."""
    inputs = [_suite_inputs(9 + l, 256, 200, 180) for l in range(3)]

    def stack(i):
        return np.stack([a[i] for a, _ in inputs])

    yt = np.stack([y for _, y in inputs])
    ells = np.array(ell, np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax.vmap(lambda x, fx, mx, y, fy, my, t, e: pk.ip_suite(
            x, fx, mx, y, fy, my, t, e, P))(
            *(jnp.asarray(stack(i)) for i in range(6)), jnp.asarray(yt),
            jnp.asarray(ells))
    got = kernels.ip_suite_lanes(*(torch.as_tensor(stack(i))
                                   for i in range(6)), torch.as_tensor(yt),
                                 torch.as_tensor(ells), TP)
    for l in range(3):
        _assert_suite([g[l] for g in got], [np.asarray(w[l]) for w in want])


def test_lc_verify_batch_lanes_equal_single_calls():
    """Three loop-closure candidates as the lanes of one align (pallas,
    the reference shared) equal three one-candidate calls bit for bit."""
    (x, f, m), moving, R0, T0, ell0 = _lane_inputs()
    ref = tengine.PointCloud(*_torch((x, f, m)))
    cands = [tengine.PointCloud(*_torch((y, f, m))) for y in moving]
    rng = np.random.default_rng(4)
    priors = [np.eye(4, dtype=np.float32) for _ in cands]
    lc_priors = []
    for _ in cands:
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rng.normal(0, 0.01, 3)
        lc_priors.append(T)
    calls = []
    lanes_fn = kernels.align_fused_lanes

    def counted(*a):
        calls.append(a[3].shape[0])
        return lanes_fn(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "align_fused_lanes", counted)
        batched = tengine.lc_verify_batch(ref, cands, R0, T0, ell0, priors,
                                          lc_priors, TP, "pallas")
        single = [tengine.lc_verify_batch(ref, [c], [R0[l]], [T0[l]],
                                          [ell0[l]], [priors[l]],
                                          [lc_priors[l]], TP, "pallas")[0]
                  for l, c in enumerate(cands)]
    assert calls == [3]                    # one launch; singles are solo
    for (rb, lb), (rs, ls) in zip(batched, single):
        for a, b in zip(rb, rs):
            assert torch.equal(a, b)
        assert lb.keys() == ls.keys()
        for k in lb:
            assert torch.equal(lb[k], ls[k]), k


def test_lane_wrappers_reject_bad_inputs():
    """The lane wrappers validate before any build: too many lanes, a
    moving stack of the wrong shape, a lane count that the poses do not
    share, and a stack whose lanes are not 16-byte aligned."""
    (x, f, m), moving, R0, T0, ell0 = _lane_inputs()
    x_t, f_t, m_t = _torch((x, f, m))
    y = torch.as_tensor(moving)
    fs = f_t.expand(3, -1, -1).contiguous()
    ms = m_t.expand(3, -1).contiguous()
    R0, T0, ell0 = (torch.as_tensor(a) for a in (R0, T0, ell0))
    lanes = kernels.MAX_LANES + 1
    big = (y[:1].expand(lanes, -1, -1).contiguous(),
           fs[:1].expand(lanes, -1, -1).contiguous(),
           ms[:1].expand(lanes, -1).contiguous())
    with pytest.raises(ValueError, match="lanes"):
        kernels.align_fused_lanes_cuda(
            x_t, f_t, m_t, *big, R0[:1].expand(lanes, 3, 3).contiguous(),
            T0[:1].expand(lanes, 3).contiguous(), ell0[:1].expand(lanes)
            .contiguous(), TP)
    with pytest.raises(ValueError):
        kernels.align_fused_lanes_cuda(x_t, f_t, m_t, y[:, :, :2], fs, ms,
                                       R0, T0, ell0, TP)
    with pytest.raises(ValueError):
        kernels.align_fused_lanes_cuda(x_t, f_t, m_t, y, fs, ms, R0[:2],
                                       T0, ell0, TP)
    with pytest.raises(ValueError):
        kernels.ip_suite_lanes_cuda(x_t, f_t, m_t, y, fs, ms, y[:2],
                                    ell0, TP)
    # 3 lanes of 510 points: lane 1's mask starts 510 bytes in
    odd = (y[:, :510].contiguous(), fs[:, :510].contiguous(),
           ms[:, :510].contiguous())
    with pytest.raises(ValueError, match="every lane"):
        kernels.align_fused_lanes_cuda(x_t[:510], f_t[:510], m_t[:510], *odd,
                                       R0, T0, ell0, TP)


# -- on the card -------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check")


@pytest.mark.gpu
def test_align_fused_lanes_cuda_equal_solo_and_plain():
    """On a card: each lane of align_fused_lanes bitwise equal to its
    one-lane launch, with a stacked and with a shared fixed cloud; the
    lanes against their plain loop at test_align_fused_cuda_matches_plain's
    bars (iterations within 3, ell equal, transform within 1e-4)."""
    _need_card()
    (x, f, m), moving, R0, T0, ell0 = _lane_inputs()
    x_t, f_t, m_t = (t.cuda() for t in _torch((x, f, m)))
    n = moving.shape[0]
    y = torch.as_tensor(moving).cuda()
    fs = f_t.expand(n, -1, -1).contiguous()
    ms = m_t.expand(n, -1).contiguous()
    R0, T0, ell0 = (torch.as_tensor(a).cuda() for a in (R0, T0, ell0))
    for fixed in ((x_t, f_t, m_t), (x_t.expand(n, -1, -1).contiguous(), fs,
                                    ms)):
        info = {}
        got = kernels.align_fused_lanes_cuda(*fixed, y, fs, ms, R0, T0, ell0,
                                             TP, launch_info=info)
        assert info["lanes"] == n
        plain = kernels.align_fused_lanes_plain(*fixed, y, fs, ms, R0, T0,
                                                ell0, TP)
        for l in range(n):
            solo = kernels.align_fused_cuda(x_t, f_t, m_t, y[l], f_t, m_t,
                                            R0[l].contiguous(),
                                            T0[l].contiguous(), ell0[l], TP)
            for g, w in zip(got, solo):
                assert torch.equal(g[l], w), l
            assert abs(int(got[3][l]) - int(plain[3][l])) <= 3
            assert float(got[2][l]) == float(plain[2][l])
            for g, w in zip(got[:2], plain[:2]):
                np.testing.assert_allclose(g[l].cpu().numpy(),
                                           w[l].cpu().numpy(), atol=1e-4)


@pytest.mark.gpu
def test_ip_suite_lanes_cuda_equal_solo():
    """On a card: each lane of ip_suite_lanes bitwise equal to its one-lane
    launch and at the suite's bars against the plain lanes."""
    _need_card()
    inputs = [_suite_inputs(9 + l, 256, 200, 180) for l in range(3)]

    def stack(i):
        return torch.as_tensor(np.stack([a[i] for a, _ in inputs])).cuda()

    yt = torch.as_tensor(np.stack([y for _, y in inputs])).cuda()
    ells = torch.tensor([0.15, 0.06, 0.1], device="cuda")
    args = (*(stack(i) for i in range(6)), yt, ells, TP)
    got = kernels.ip_suite_lanes_cuda(*args)
    plain = kernels.ip_suite_lanes_plain(*args)
    for l in range(3):
        solo = kernels.ip_suite_cuda(*(a[l] for a in args[:8]), TP)
        for g, w in zip(got, solo):
            assert torch.equal(g[l], w), l
        _assert_suite([g[l].cpu() for g in got], [w[l].cpu() for w in plain])
