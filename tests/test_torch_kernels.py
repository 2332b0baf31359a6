"""Port parity, kernel layer: the plain versions of the CUDA kernels
(cvo_slam_tpu_torch.cvo.kernels) against the JAX package's Pallas kernels
(interpret mode) and their XLA twins, on the same numpy clouds (CPU).

The CUDA kernels themselves run only on the card: the test that launches
them skips here, and chip_smoke.py holds each against its plain version at
the main path's shapes."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import pallas_kernels as pk
from cvo_slam_tpu.ops import pairwise as jpw
from cvo_slam_tpu.ops import se3 as jse3
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.cvo import kernels
from cvo_slam_tpu_torch.ops import pairwise as tpw
from test_pairwise import make_clouds

torch.set_num_threads(2)
P = CvoParams()
TP = from_reference(P)
NAMES = ("omega", "v", "nnz", "B", "C", "D", "E")


def _pad_to(arrays, cap):
    """Pad (x, fx, mx, y, fy, my) to a Pallas-tileable capacity with masked
    slots (the JAX kernels need a multiple of 128)."""
    out = []
    for a in arrays:
        pad = [(0, cap - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, pad))
    return out


def _clouds(seed, cap, n, m):
    x, fx, mx, y, fy, my = make_clouds(seed, n, m, cap=cap)
    return x, fx, mx, y, fy, my


def _moment_refs(arrays, ell):
    """(JAX XLA moment path, JAX Pallas moment kernel) outputs."""
    x, fx, mx, y, fy, my = [jnp.asarray(a) for a in arrays]
    ck = jpw.color_kernel_gated(fx, fy, mx, my, P)
    center, U = jpw.step_moment_basis(x, mx)
    xla = jpw.flow_and_step_moments(x, y, ck, U, center, jnp.float32(ell), P)
    with pltpu.force_tpu_interpret_mode():
        c2, Upack = pk.pack_moment_basis(x, mx)
        pallas = pk.moment_flow_step(x, y, fx, fy, mx, my, Upack, c2,
                                     jnp.float32(ell), P)
    return xla, pallas


def _port_moment(arrays, ell):
    x, fx, mx, y, fy, my = [torch.as_tensor(a) for a in arrays]
    center, U = tpw.step_moment_basis(x, mx)
    return kernels.moment_flow_step(x, y, fx, fy, mx, my, U.contiguous(),
                                    center, ell, TP)


def _assert_moment(got, want):
    for name, g, r in zip(NAMES, got, want):
        if name == "nnz":
            assert int(g) == int(r), (int(g), int(r))
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                       rtol=2e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_moment_flow_step_parity(ell):
    arrays = _clouds(4, 256, 200, 180)
    xla, pallas = _moment_refs(arrays, ell)
    got = _port_moment(arrays, ell)
    _assert_moment(got, pallas)
    _assert_moment(got, xla)


@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_moment_flow_step_odd_capacity(ell):
    """Capacity 250 (not a multiple of 128) with a masked tail: the port
    takes it as is; the JAX kernel sees the same clouds padded to 256."""
    arrays = _clouds(11, 250, 230, 210)
    xla, pallas = _moment_refs(_pad_to(arrays, 256), ell)
    got = _port_moment(arrays, ell)
    _assert_moment(got, pallas)
    _assert_moment(got, xla)


def test_moment_pass_masked_slots_contribute_zero():
    """Changing what sits in masked slots changes nothing."""
    x, fx, mx, y, fy, my = _clouds(2, 256, 150, 140)
    a = _port_moment((x, fx, mx, y, fy, my), 0.1)
    x2, y2 = x.copy(), y.copy()
    x2[~mx] = 0.01
    y2[~my] = 0.02
    b = _port_moment((x2, fx, mx, y2, fy, my), 0.1)
    for g, r in zip(a, b):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def _uneven_clouds(seed, cap_n, cap_m):
    """A fixed cloud of capacity cap_n and a moving one of cap_m (N != M),
    each with a masked tail of garbage, as torch tensors."""
    cap = max(cap_n, cap_m)
    x, fx, mx, y, fy, my = make_clouds(
        seed, max(1, cap_n - cap_n // 10), max(1, cap_m - cap_m // 10),
        cap=cap)
    return [torch.as_tensor(a) for a in
            (x[:cap_n], fx[:cap_n], mx[:cap_n], y[:cap_m], fy[:cap_m],
             my[:cap_m])]


def _numpy_moment_keep(x, fx, mx, y, fy, my, ell):
    """(N, M) keep of the moment form, written anew in numpy float32:
    explicit differences coordinate by coordinate; the exponential of the
    same argument through torch (numpy's float32 exp rounds otherwise)."""
    x, fx, mx, y, fy, my = [np.asarray(a) for a in (x, fx, mx, y, fy, my)]
    f = np.float32

    def sq_diffs(a, b):
        out = None
        for c in range(a.shape[1]):
            e = a[:, None, c] - b[None, :, c]
            out = e * e if out is None else out + e * e
        return out

    d2, d2c = sq_diffs(x, y), sq_diffs(fx, fy)
    ell = f(ell)
    d2t = f(-2.0) * ell * ell * f(tpw.log_sp_ratio(TP))
    arg = -(d2 * (f(1.0) / (f(2.0) * ell * ell))
            + d2c * f(1.0 / (2.0 * TP.c_ell * TP.c_ell)))
    a = f(TP.sigma ** 2 * TP.c_sigma ** 2) * torch.exp(
        torch.clamp(torch.as_tensor(arg), min=-20.0)).numpy()
    gate = (d2 < d2t) & (d2c < f(tpw.d2_color_threshold(TP))) \
        & mx[:, None] & my[None, :]
    return gate & (a > f(TP.sp_thres))


UNEVEN = [(1, 129), (129, 1), (250, 129), (129, 250), (3000, 2980)]


@pytest.mark.parametrize("n,m", UNEVEN)
def test_moment_keep_bits_layout(n, m):
    """moment_keep_bits_plain, what pass 1 of the moment kernel records:
    rows j of the moving cloud, words over the fixed points i, equal to the
    moment form's keep (computed anew here) and counting moment_pass_plain's
    nnz, at CAP 1, 129, 250 and 3000 with N != M."""
    x, fx, mx, y, fy, my = _uneven_clouds(n + m, n, m)
    bits = kernels.moment_keep_bits_plain(x, y, fx, fy, mx, my, 0.15, TP)
    assert bits.dtype == torch.int32
    assert tuple(bits.shape) == (-(-n // 32), m)
    keep = kernels.unpack_keep_bits(bits, n)             # (M, N)
    want = _numpy_moment_keep(x, fx, mx, y, fy, my, 0.15)
    np.testing.assert_array_equal(keep.numpy(), want.T)
    _, U = tpw.step_moment_basis(x, mx)
    _, nnz = kernels.moment_pass_plain(x, y, fx, fy, mx, my, U, 0.15, TP)
    assert int(keep.sum()) == int(nnz)
    if n * m > 1000:
        assert int(nnz) > 0


def test_moment_keep_bits_are_not_the_dot_identity_keep():
    """Far from the origin the two formulations round apart: the moment
    form (explicit differences) keeps other pairs than pairwise.cvo_kernel
    (the dot identity, keep_bits_plain), and the moment kernel's bitmask
    follows the moment form."""
    x, fx, mx, y, fy, my = _uneven_clouds(31, 250, 240)
    x, y = x + 60.0, y + 60.0
    moment = kernels.unpack_keep_bits(kernels.moment_keep_bits_plain(
        x, y, fx, fy, mx, my, 0.15, TP), 250).T          # (N, M)
    ident = kernels.unpack_keep_bits(kernels.keep_bits_plain(
        x, y, fx, fy, mx, my, 0.15, TP), 240)
    assert int((moment != ident).sum()) > 0
    np.testing.assert_array_equal(
        moment.numpy(), _numpy_moment_keep(x, fx, mx, y, fy, my, 0.15))


@pytest.mark.parametrize("ell", [0.15, 0.06])
@pytest.mark.parametrize("n,m", UNEVEN)
def test_moment_from_bits_matches_moment_pass(n, m, ell):
    """Pass 2's function (each row's kept pairs in ascending i) against
    moment_pass_plain: Mom within 1e-6 of each column's max, nnz equal."""
    x, fx, mx, y, fy, my = _uneven_clouds(n + 2 * m, n, m)
    _, U = tpw.step_moment_basis(x, mx)
    bits = kernels.moment_keep_bits_plain(x, y, fx, fy, mx, my, ell, TP)
    got, nnz = kernels.moment_from_bits_plain(x, y, fx, fy, U, bits, ell,
                                              TP)
    want, nnz_w = kernels.moment_pass_plain(x, y, fx, fy, mx, my, U, ell, TP)
    assert got.shape == want.shape == (m, 35)
    assert int(nnz) == int(nnz_w)
    col = want.abs().amax(dim=0).clamp(min=1e-30)
    assert float(((got - want).abs() / col).max()) <= 1e-6


@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_moment_from_bits_matches_pallas(ell):
    """Pass 2's function through the shared epilogue against the JAX
    package's Pallas moment kernel (interpret mode): rtol 2e-4, nnz
    exact."""
    arrays = _clouds(4, 256, 200, 180)
    _, pallas = _moment_refs(arrays, ell)
    x, fx, mx, y, fy, my = [torch.as_tensor(a) for a in arrays]
    center, U = tpw.step_moment_basis(x, mx)
    bits = kernels.moment_keep_bits_plain(x, y, fx, fy, mx, my, ell, TP)
    mom, nnz = kernels.moment_from_bits_plain(x, y, fx, fy, U, bits, ell, TP)
    got = tpw.flow_and_step_from_moments(mom, y, center,
                                         torch.tensor(np.float32(ell)), nnz,
                                         TP)
    _assert_moment(got, pallas)


def _suite_inputs(seed, cap, n, m):
    arrays = _clouds(seed, cap, n, m)
    tran = jse3.exp_se3(jnp.asarray(
        np.array([0.02, -0.01, 0.03, 0.05, 0.02, -0.04], np.float32)))
    yt = np.array(jse3.transform_points(tran, jnp.asarray(arrays[3])))
    return arrays, yt


def _suite_refs(arrays, yt, ell):
    x, fx, mx, y, fy, my = [jnp.asarray(a) for a in arrays]
    xla = jpw.ip_suite(x, fx, mx, y, fy, my, jnp.asarray(yt),
                       jnp.float32(ell), P)
    with pltpu.force_tpu_interpret_mode():
        pallas = pk.ip_suite(x, fx, mx, y, fy, my, jnp.asarray(yt),
                             jnp.float32(ell), P)
    return xla, pallas


def _assert_suite(got, want):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    for k in (0, 2, 4, 6):                       # the four sums
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    for k in (1, 3, 5, 7, 9):                    # counts and inliers
        assert int(got[k]) == int(want[k]), (k, got[k], want[k])
    scale = max(np.abs(want[8]).max(), 1.0)
    np.testing.assert_allclose(got[8] / scale, want[8] / scale, atol=1e-5)


@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_ip_suite_parity(ell):
    arrays, yt = _suite_inputs(9, 256, 200, 180)
    xla, pallas = _suite_refs(arrays, yt, ell)
    got = kernels.ip_suite(*[torch.as_tensor(a) for a in arrays],
                           torch.as_tensor(yt), ell, TP)
    _assert_suite(got, pallas)
    _assert_suite(got, xla)


def test_ip_suite_odd_capacity():
    arrays, yt = _suite_inputs(13, 250, 240, 190)
    xla, pallas = _suite_refs(_pad_to(arrays, 256),
                              np.pad(yt, ((0, 6), (0, 0))), 0.15)
    got = kernels.ip_suite(*[torch.as_tensor(a) for a in arrays],
                           torch.as_tensor(yt), 0.15, TP)
    _assert_suite(got, pallas)
    _assert_suite(got, xla)


def _stats_refs(arrays, ell, with_moments):
    """The Pallas pair_stats kernel (interpret mode) on rows y, columns x."""
    x, fx, mx, y, fy, my = [jnp.asarray(a) for a in arrays]
    with pltpu.force_tpu_interpret_mode():
        return pk.pair_stats(y, fy, my, x, fx, mx, jnp.float32(ell), P,
                             with_moments=with_moments)


def _port_stats(arrays, ell, with_moments):
    x, fx, mx, y, fy, my = [torch.as_tensor(a) for a in arrays]
    return kernels.pair_stats(y, fy, my, x, fx, mx, ell, TP, with_moments)


def _assert_stats(got, want, ell):
    """tests/test_pallas.py's bars: count exact, value rtol 1e-4, G / scale
    atol 1e-5, the assembled H / scale atol 1e-4."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert float(got[1]) == float(want[1]), (got[1], want[1])
    if len(want) == 2:
        return
    assert int(got[3]) == int(want[3]), (got[3], want[3])
    scale = max(np.abs(want[2]).max(), 1.0)
    np.testing.assert_allclose(got[2] / scale, want[2] / scale, atol=1e-5)
    H_g = tpw.assemble_hessian(torch.as_tensor(got[2]),
                               torch.tensor(np.float32(ell))).numpy()
    H_w = np.asarray(jpw.assemble_hessian(jnp.asarray(want[2]),
                                          jnp.float32(ell)))
    h_scale = max(np.abs(H_w).max(), 1.0)
    np.testing.assert_allclose(H_g / h_scale, H_w / h_scale, atol=1e-4)


@pytest.mark.parametrize("with_moments", [False, True])
@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_pair_stats_parity(ell, with_moments):
    """pair_stats_plain against the Pallas pair_stats kernel at CAP 256."""
    arrays = _clouds(17, 256, 220, 200)
    want = _stats_refs(arrays, ell, with_moments)
    got = _port_stats(arrays, ell, with_moments)
    assert int(got[1]) > 40     # the gates pass real pairs at both ell
    _assert_stats(got, want, ell)


@pytest.mark.parametrize("with_moments", [False, True])
def test_pair_stats_odd_capacity(with_moments):
    """CAP 250 with a masked tail; the Pallas side pads to 256 as
    engine._pad128 does."""
    arrays = _clouds(19, 250, 235, 205)
    want = _stats_refs(_pad_to(arrays, 256), 0.1, with_moments)
    got = _port_stats(arrays, 0.1, with_moments)
    _assert_stats(got, want, 0.1)


def test_pair_stats_views_match_xla():
    """inner_product / se3_hessian_raw (views of pair_stats) against the
    JAX package's XLA functions on the same pair."""
    arrays = _clouds(23, 256, 210, 190)
    x, fx, mx, y, fy, my = [jnp.asarray(a) for a in arrays]
    tx, tfx, tmx, ty, tfy, tmy = [torch.as_tensor(a) for a in arrays]
    ell = np.float32(0.1)
    v_w, n_w = jpw.inner_product(y, fy, my, x, fx, mx, jnp.float32(ell), P)
    v_g, n_g = tpw.inner_product(ty, tfy, tmy, tx, tfx, tmx,
                                 torch.tensor(ell), TP)
    np.testing.assert_allclose(float(v_g), float(v_w), rtol=1e-4)
    assert float(n_g) == float(n_w)
    H_w, i_w = jpw.se3_hessian_raw(y, fy, my, x, fx, mx, jnp.float32(ell), P)
    H_g, i_g = tpw.se3_hessian_raw(ty, tfy, tmy, tx, tfx, tmx,
                                   torch.tensor(ell), TP)
    assert int(i_g) == int(i_w)
    scale = np.abs(np.asarray(H_w)).max()
    np.testing.assert_allclose(H_g.numpy() / scale, np.asarray(H_w) / scale,
                               atol=1e-4)


def test_wrappers_reject_bad_inputs():
    """A CUDA launch validates shapes, dtypes and devices before any build:
    a wrong cloud raises instead of launching."""
    x, fx, mx, y, fy, my = [torch.as_tensor(a)
                            for a in _clouds(1, 256, 100, 100)]
    center, U = tpw.step_moment_basis(x, mx)
    with pytest.raises(ValueError):
        kernels.moment_pass_cuda(x, y, fx, fy, mx, my, U[:, :34], 0.1, TP)
    with pytest.raises(ValueError):
        kernels.ip_suite_cuda(x, fx, mx.float(), y, fy, my, y, 0.1, TP)
    with pytest.raises(ValueError):
        kernels.moment_pass(x.to("meta"), y, fx, fy, mx, my, U, 0.1, TP)
    with pytest.raises(ValueError):
        kernels.pair_stats_cuda(y, fy, my, x[:, :2], fx, mx, 0.1, TP)
    with pytest.raises(ValueError):
        kernels.pair_stats(y.to("meta"), fy, my, x, fx, mx, 0.1, TP)


@pytest.mark.parametrize("cloud", ["fixed", "moving"])
def test_suite_wrapper_rejects_unaligned_columns(cloud):
    """The suite stages both clouds as columns (the fixed one for pre, post
    and fixed, the moving one for the moving self set) with 16-byte copies:
    a view 4 bytes into its storage is refused before any build."""
    x, fx, mx, y, fy, my = [torch.as_tensor(a)
                            for a in _clouds(3, 256, 100, 100)]
    args = dict(x=x, fx=fx, mx=mx, y=y, fy=fy, my=my)
    pos = args["x" if cloud == "fixed" else "y"]
    args["x" if cloud == "fixed" else "y"] = \
        torch.empty(pos.numel() + 1)[1:].view_as(pos).copy_(pos)
    with pytest.raises(ValueError, match=f"{cloud} positions is not 16-byte"):
        kernels.ip_suite_cuda(**args, yt=y, ell=0.1, p=TP)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check")


def _suite_launches_per_call(fn):
    """Kernel launches of one call of fn (the suite's, by profiler name)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "suite_sweep" in e.name)


@pytest.mark.gpu
@pytest.mark.parametrize("cap,n,m", [(250, 240, 190), (3000, 2900, 2800)])
def test_cuda_kernels_match_plain(cap, n, m):
    """On a card: the moment and suite kernels against their plain versions
    (CAP 250 and 3000); the moment kernel's pass-1 bitmask equal bit for bit
    to the moment form's keep; two launches of each bitwise equal; the
    suite in one launch per call."""
    _need_card()
    arrays, yt = _suite_inputs(13, cap, n, m)
    x, fx, mx, y, fy, my = [torch.as_tensor(a).cuda() for a in arrays]
    center, U = tpw.step_moment_basis(x, mx)
    U = U.contiguous()
    for ell in (0.15, 0.06):
        got = kernels.moment_flow_step(x, y, fx, fy, mx, my, U, center,
                                       ell, TP)
        want = kernels.moment_flow_step_plain(x, y, fx, fy, mx, my, U,
                                              center, ell, TP)
        _assert_moment([g.cpu() for g in got], [w.cpu() for w in want])
        bits = torch.empty((-(-cap // 32), cap), dtype=torch.int32,
                           device="cuda")
        first = kernels.moment_pass_cuda(x, y, fx, fy, mx, my, U, ell, TP,
                                         keep_bits=bits)
        again = kernels.moment_pass_cuda(x, y, fx, fy, mx, my, U, ell, TP)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        assert torch.equal(bits.cpu(), kernels.moment_keep_bits_plain(
            *[t.cpu() for t in (x, y, fx, fy, mx, my)], ell, TP))
        ytc = torch.as_tensor(yt).cuda()
        args = (x, fx, mx, y, fy, my, ytc, ell, TP)
        got = kernels.ip_suite(*args)
        want = kernels.ip_suite_plain(*args)
        _assert_suite([g.cpu() for g in got], [w.cpu() for w in want])
        again = kernels.ip_suite_cuda(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert _suite_launches_per_call(
            lambda: kernels.ip_suite_cuda(*args)) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [256, 250])
def test_pair_stats_cuda_matches_plain(cap):
    """On a card: the pair-stats kernel against its plain version, with
    and without moments, at both ells, with the CPU parity bars; two
    launches bitwise equal."""
    _need_card()
    arrays, yt = _suite_inputs(29, cap, 230, 200)
    x, fx, mx, _, fy, my = [torch.as_tensor(a).cuda() for a in arrays]
    ytc = torch.as_tensor(yt).cuda()
    for ell in (0.15, 0.06):
        for with_moments in (False, True):
            got = kernels.pair_stats(ytc, fy, my, x, fx, mx, ell, TP,
                                     with_moments)
            want = kernels.pair_stats_plain(ytc, fy, my, x, fx, mx, ell, TP,
                                            with_moments)
            _assert_stats([g.cpu() for g in got], [w.cpu() for w in want],
                          ell)
            again = kernels.pair_stats(ytc, fy, my, x, fx, mx, ell, TP,
                                       with_moments)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
