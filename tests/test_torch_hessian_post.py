"""The inner products' Hessian epilogue (cvo_slam_tpu_torch.cvo.kernels.
hessian_post): scale, fixed-sweep Jacobi eigenvalues and the spectrum
shift, one launch of csrc/hessian_post.cu on the card, its plain version on
the CPU.

On the CPU: the plain version against a copy of the engine's epilogue as it
was before the kernel (Jacobi on the device, the eigenvalues copied to the
host, the float32 shift loop there), bit for bit, on stacks that take 0, 1,
several and 64 shift steps, with a NaN lane and lanes without inliers; each
lane of a stack against its solo call; the four compute_innerproduct entry
points against the same functions over the copy. On a card (`gpu`): the
kernel against the plain version run on the card, bit for bit, one launch
per inner product and no host read inside `innerproduct`.

Imports neither JAX nor the JAX package, so the card's run needs only
`python -m pytest --noconftest -m gpu tests/test_torch_hessian_post.py`."""

import dataclasses

import numpy as np
import pytest
import torch

from cvo_slam_tpu_torch import spans
from cvo_slam_tpu_torch.config import CvoParams
from cvo_slam_tpu_torch.cvo import engine, kernels
from cvo_slam_tpu_torch.ops import pairwise
from cvo_slam_tpu_torch.ops.jacobi import eigvalsh_jacobi

torch.set_num_threads(2)
P = CvoParams()
# a floor above 1 that the shift (to 1) never reaches: the 64-step cap
P_CAP = dataclasses.replace(P, hessian_min_abs_eig=2.0)


def _before(H_raw, inliers, p):
    """The engine's epilogue before the kernel, verbatim but for also
    returning the total shifts and each lane's shift steps."""
    H = H_raw * p.hessian_scale
    lams = eigvalsh_jacobi(H)
    lams = lams.cpu().numpy()
    totals = np.zeros(len(lams), np.float32)
    steps = []
    for j, lam in enumerate(lams):
        total = np.float32(0.0)
        n = 0
        for _ in range(64):
            lam_min = lam[np.argmin(np.abs(lam))]
            if not abs(lam_min) < p.hessian_min_abs_eig:
                break
            shift = np.float32(1.0) - lam_min
            lam = lam + shift
            total = np.float32(total + shift)
            n += 1
        totals[j] = total
        steps.append(n)
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    H = H + torch.as_tensor(totals, device=H.device)[:, None, None] * eye
    return (torch.where(inliers.reshape(-1, 1, 1) > 0, H, eye),
            torch.as_tensor(totals), steps)


def _with_spectrum(rng, lams):
    """A raw Hessian whose scaled matrix (x hessian_scale) is symmetric with
    eigenvalues `lams`."""
    q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    h = (q * np.asarray(lams, np.float64)) @ q.T
    h = (h + h.T) / 2.0
    return (h / P.hessian_scale).astype(np.float32)


def _case(name, seed=0):
    """(H_raw (6, 6) f32, inliers, the least shift steps the case takes at
    the default floor; None: not held)."""
    rng = np.random.default_rng(seed + 101)
    if name == "definite":      # every |eigenvalue| above the floor
        return _with_spectrum(rng, [2.0, 3.5, -4.0, 5.0, 6.5, -7.0]), 500, 0
    if name == "one_step":
        return _with_spectrum(rng, [0.5, 3.0, 4.0, 5.0, 6.0, 7.0]), 80, 1
    if name == "several":       # the shift brings others under the floor
        return _with_spectrum(rng, [0.2, -0.5, -1.7, 3.0, 4.0, 5.0]), 80, 3
    if name == "near_floor":
        return _with_spectrum(rng, [0.99999, 1.00001, -0.99999,
                                    -1.00001, 1.0, 2.0]), 9, 1
    if name == "indefinite":    # a random symmetric matrix, O(1) spectrum
        a = rng.standard_normal((6, 6))
        return ((a + a.T) / P.hessian_scale).astype(np.float32), 7, None
    if name == "asymmetric":    # the raw matrix need not be symmetric
        a = rng.standard_normal((6, 6)) * 3e5
        return a.astype(np.float32), 3, None
    if name == "zero":          # equal diagonals and no off-diagonal
        return np.zeros((6, 6), np.float32), 1, 1
    if name == "nan":
        a = _with_spectrum(rng, [0.5, 3.0, 4.0, 5.0, 6.0, 7.0])
        a[2, 4] = np.nan
        return a, 40, 0
    if name == "no_inliers":
        return _with_spectrum(rng, [0.2, -0.5, 3.0, 4.0, 5.0, 6.0]), 0, 2
    raise ValueError(name)


CASES = ("definite", "one_step", "several", "near_floor", "indefinite",
         "asymmetric", "zero", "nan", "no_inliers")


def _stack(names, seed=0, device="cpu"):
    cases = [_case(n, seed + k) for k, n in enumerate(names)]
    H = torch.as_tensor(np.stack([c[0] for c in cases])).to(device)
    inl = torch.tensor([c[1] for c in cases], dtype=torch.int32,
                       device=device)
    return H, inl, [c[2] for c in cases]


def _assert_bits(got, want):
    """Equal bit for bit: NaNs at the same places, every other entry with
    the same bits (so +0 and -0 differ)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got, want)
    fin = ~np.isnan(want)
    np.testing.assert_array_equal(got.view(np.int32)[fin],
                                  want.view(np.int32)[fin])


@pytest.mark.parametrize("name", CASES + ("cap",))
def test_plain_equals_the_epilogue_before(name):
    """hessian_post_plain against the copy of the epilogue before the
    kernel, bit for bit in post_hessian and the total shift; each case
    takes the shift steps it is built for (64 at the cap)."""
    p = P_CAP if name == "cap" else P
    H, inl, least = _stack(["zero" if name == "cap" else name])
    post, total = kernels.hessian_post_plain(H, inl, p)
    want_post, want_total, steps = _before(H, inl, p)
    _assert_bits(post, want_post)
    _assert_bits(total, want_total)
    if name == "cap":
        assert steps == [64]
    elif least[0] is not None:
        assert steps[0] >= least[0], steps
        if least[0] == 0:
            assert steps == [0]
    if name == "no_inliers":
        _assert_bits(post[0], torch.eye(6))
    if name == "nan":
        assert np.isnan(post.numpy()).any() and float(total[0]) == 0.0


@pytest.mark.parametrize("p", [P, P_CAP], ids=["floor1", "cap"])
def test_each_lane_equals_its_solo_call(p):
    """A stack of every case: the stack against the copy, and each lane
    against hessian_post_plain of that lane alone, bit for bit."""
    H, inl, _ = _stack(CASES + CASES[:4], seed=7)
    post, total = kernels.hessian_post_plain(H, inl, p)
    want_post, want_total, _ = _before(H, inl, p)
    _assert_bits(post, want_post)
    _assert_bits(total, want_total)
    for l in range(H.shape[0]):
        solo_post, solo_total = kernels.hessian_post_plain(
            H[l:l + 1], inl[l:l + 1], p)
        _assert_bits(post[l], solo_post[0])
        _assert_bits(total[l], solo_total[0])


# -- the engine's four entry points -------------------------------------------

def _cloud(rng, cap, device="cpu", base=None):
    """A cloud of `cap` slots, a few masked out; near `base` if given."""
    if base is None:
        pos = rng.uniform(-0.3, 0.3, (cap, 3)) + np.array([0.0, 0.0, 1.5])
    else:
        pos = base + rng.normal(0.0, 0.01, (cap, 3))
    feat = rng.uniform(0.0, 1.0, (cap, 5))
    mask = rng.uniform(size=cap) > 0.1
    return engine.PointCloud(
        torch.as_tensor(pos, dtype=torch.float32).to(device),
        torch.as_tensor(feat, dtype=torch.float32).to(device),
        torch.as_tensor(mask).to(device))


def _pose(rng, scale=0.02):
    from cvo_slam_tpu_torch.ops import se3
    w = rng.normal(0.0, scale, 3)
    t = rng.normal(0.0, scale, 3)
    return se3.exp_se3_np(np.concatenate([w, t])).astype(np.float32)


def _entry_call(name, device="cpu", cap=128, lanes=3):
    """A call of one of the four entry points on small random clouds."""
    rng = np.random.default_rng(23)
    fixed = _cloud(rng, cap, device)
    movings = [_cloud(rng, cap, device, fixed.positions.cpu().numpy())
               for _ in range(lanes)]
    poses = [[_pose(rng) for _ in range(lanes)] for _ in range(4)]
    ells = [0.15, 0.1, 0.06][:lanes]
    if name == "compute_innerproduct":
        return lambda: engine.compute_innerproduct(fixed, movings[0],
                                                   poses[0][0], ells[0], P)
    if name == "compute_innerproduct_lanes":
        return lambda: engine.compute_innerproduct_lanes(
            fixed, movings, poses[0], ells, P)
    if name == "compute_innerproduct_lc":
        return lambda: engine.compute_innerproduct_lc(
            fixed, movings[0], *(q[0] for q in poses), ells[0], P)
    return lambda: engine.compute_innerproduct_lc_lanes(
        fixed, movings, *poses, ells, P)


ENTRY_POINTS = ("compute_innerproduct", "compute_innerproduct_lanes",
                "compute_innerproduct_lc", "compute_innerproduct_lc_lanes")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_return_the_dicts_of_before(name, monkeypatch):
    """Each entry point returns, key for key and bit for bit, the dict it
    returned over the epilogue before the kernel; on the CPU the wrapper
    takes the plain version and never the kernel."""
    call = _entry_call(name)
    with monkeypatch.context() as m:
        m.setattr(kernels, "hessian_post",
                  lambda H, inl, p: _before(H, inl, p)[:2])
        want = call()

    def no_kernel(*args, **kw):
        raise AssertionError("a CPU tensor reached the kernel")
    monkeypatch.setattr(kernels, "hessian_post_cuda", no_kernel)
    before = kernels.HESSIAN_POST.launches
    got = call()
    assert kernels.HESSIAN_POST.launches == before
    assert got.keys() == want.keys()
    for k in want:
        _assert_bits(got[k], want[k])
    post = got["post_hessian"]
    assert post.shape[-2:] == (6, 6) and torch.isfinite(post).all()


# -- on the card ----------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check")


def _suite_hessians(lanes, cap=256):
    """Raw Hessians and inliers of the suite kernel (ip_suite_cuda) on
    random cloud pairs at two ells, `lanes` of them, on the card."""
    rng = np.random.default_rng(5)
    hs, inls = [], []
    while len(hs) < lanes:
        x = _cloud(rng, cap, "cuda")
        y = _cloud(rng, cap, "cuda", x.positions.cpu().numpy())
        yt = y.positions.clone()
        for ell in (0.15, 0.06):
            out = kernels.ip_suite_cuda(*x, *y, yt, ell, P)
            hs.append(pairwise.assemble_hessian(
                out[8], torch.tensor(ell, device="cuda")))
            inls.append(out[9])
    return torch.stack(hs[:lanes]), torch.stack(inls[:lanes])


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 2, 7, 33])
def test_kernel_equals_plain_on_the_card(lanes):
    """The kernel against hessian_post_plain run on the card, bit for bit,
    at both floors: stacks of the CPU cases and of the suite's Hessians."""
    _need_card()
    names = [CASES[k % len(CASES)] for k in range(lanes)]
    H, inl, _ = _stack(names, seed=lanes, device="cuda")
    Hs, inls = _suite_hessians(lanes)
    for H_raw, inliers in ((H, inl), (Hs, inls)):
        for p in (P, P_CAP):
            post, total = kernels.hessian_post_cuda(H_raw, inliers, p)
            want_post, want_total = kernels.hessian_post_plain(H_raw,
                                                               inliers, p)
            _assert_bits(post.cpu(), want_post.cpu())
            _assert_bits(total.cpu(), want_total.cpu())
            # the suite's inliers column (a strided view) as the kernel
            # reads it
            again = kernels.hessian_post(H_raw, inliers, p)
            _assert_bits(again[0].cpu(), post.cpu())


@pytest.mark.gpu
def test_one_launch_and_no_host_read_per_inner_product(monkeypatch):
    """On the card each compute_innerproduct call launches the epilogue
    kernel once, never takes the plain version and records no device.read
    span inside its innerproduct span."""
    _need_card()

    def no_plain(*args, **kw):
        raise AssertionError("a CUDA tensor reached hessian_post_plain")
    monkeypatch.setattr(kernels, "hessian_post_plain", no_plain)
    call = _entry_call("compute_innerproduct", "cuda", cap=256)
    call()
    torch.cuda.synchronize()
    for n in range(1, 4):
        before = kernels.HESSIAN_POST.launches
        spans.enable()
        try:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        finally:
            spans.disable()
        taken = spans.take()
        assert kernels.HESSIAN_POST.launches - before == n
        inner = [s for s in taken if s.name == "innerproduct"]
        assert len(inner) == n
        for s in taken:
            q = s.parent
            while q is not None:
                assert not (s.name == "device.read"
                            and q.name == "innerproduct"), s
                q = q.parent


def test_kernel_schedule_is_the_round_robin():
    """csrc/hessian_post.cu's rounds, written out as template arguments,
    are ops/jacobi._round_robin_pairs(6) in order (the plain version's
    schedule)."""
    import os
    import re
    from cvo_slam_tpu_torch.cvo import cuda_build
    from cvo_slam_tpu_torch.ops.jacobi import _round_robin_pairs
    with open(os.path.join(cuda_build.CSRC_DIR, "hessian_post.cu")) as f:
        src = f.read()
    rounds = [tuple(zip(*[iter(map(int, m.split(",")))] * 2))
              for m in re.findall(r"jacobi_round<([\d, ]+)>\(a\)", src)]
    assert tuple(rounds) == _round_robin_pairs(6)
