"""The `pallas_mom` align iteration on the card (cvo_slam_tpu_torch.cvo.
kernels.moment_epilogue / moment_state_init / moment_state_step, csrc/
moment_step.cu, and engine.align_loop_moment_cuda) and the loop it leaves
to the CPU.

On the CPU: `align(..., 'pallas_mom')` runs `align_loop` over the plain
moment pass, bit for bit; the loop is chosen by the device type and the
backend alone; the kernel wrapper's calls as the benchmark records them
(benchmark/trace.py wraps kernels.moment_flow_step by module attribute and
reads each call's y and ell after the window); the anneal schedule the
kernels take; the wrappers' input checks; align_loop_moment_cuda's Python
with the two state launches replaced by a torch twin of `_update`.

On a card (`gpu`): the epilogue kernel against
ops/pairwise.flow_and_step_from_moments, the state kernel against
engine._update on crafted inputs, two launches of each bitwise equal, a
whole align against the plain loop, four launches an iteration, and
align_fused's outputs equal to those of the build before its scalar
helpers moved to csrc/align_state.cuh.

Imports neither JAX nor the JAX package, so the card's run needs only
`python -m pytest --noconftest -m gpu tests/test_torch_moment_epilogue.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cvo_slam_tpu_torch import spans
from cvo_slam_tpu_torch.config import CvoParams
from cvo_slam_tpu_torch.cvo import engine, kernels
from cvo_slam_tpu_torch.frontend.pointcloud import _morton_order
from cvo_slam_tpu_torch.ops import pairwise, se3

torch.set_num_threads(2)
P = CvoParams()
NAMES = ("omega", "v", "nnz", "B", "C", "D", "E")
# tests/test_torch_align.py's PALLAS_BARS: the spread of the port's
# pallas_mom against the JAX package's align on its tracking sequence
BARS = dict(iters=8, pos=3e-4, rot=6e-4)


def make_clouds(seed, n, m, cap):
    """tests/test_pairwise.make_clouds (which imports JAX): a fixed cloud
    in a 0.6 m cube, the moving one near it, garbage in the masked
    slots."""
    rng = np.random.default_rng(seed)
    x = np.zeros((cap, 3), np.float32)
    y = np.zeros((cap, 3), np.float32)
    fx = np.zeros((cap, 5), np.float32)
    fy = np.zeros((cap, 5), np.float32)
    mx = np.zeros(cap, bool)
    my = np.zeros(cap, bool)
    x[:n] = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    y[:m] = (x[:m] + rng.normal(0, 0.05, (m, 3))).astype(np.float32)
    fx[:n, :3] = rng.uniform(0, 255, (n, 3))
    fy[:m, :3] = fx[:m, :3] + rng.normal(0, 10, (m, 3))
    fx[:n, 3:] = rng.normal(0, 20, (n, 2))
    fy[:m, 3:] = fx[:m, 3:] + rng.normal(0, 5, (m, 2))
    x[n:] = 99.0
    y[m:] = -99.0
    mx[:n] = True
    my[:m] = True
    return [torch.as_tensor(a) for a in (x, fx, mx, y, fy, my)]


def fixture_clouds(cap=512, n=480, seed=3):
    """((x, fx, mx), (y, fy, my)) of tests/test_torch_align.py's CAP-512
    megakernel fixture, built with the port's Morton order and exp_se3: a
    Morton-ordered cloud and its copy under a known small motion."""
    rng = np.random.default_rng(seed)
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
    Ti = np.linalg.inv(se3.exp_se3_np(twist).astype(np.float64))
    y = x.copy()
    y[:n] = (pos @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
    fixed = [torch.as_tensor(a) for a in (x, f, m)]
    moving = [torch.as_tensor(a) for a in (y, f, m)]
    return fixed, moving


def _cloud(arrays, device="cpu"):
    return engine.PointCloud(*(a.to(device) for a in arrays))


def _start(device="cpu"):
    return (torch.eye(3, device=device), torch.zeros(3, device=device),
            torch.tensor(0.15, device=device))


def _rigid_err(Ta, Tb):
    """Translation and rotation angle of Ta^-1 Tb (the angle from the skew
    part)."""
    E = np.linalg.inv(np.asarray(Ta, np.float64)) @ np.asarray(Tb,
                                                               np.float64)
    D = E[:3, :3]
    ang = 0.5 * np.linalg.norm([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0],
                                D[1, 0] - D[0, 1]])
    return np.linalg.norm(E[:3, 3]), ang


def _record_calls(monkeypatch):
    """Wrap kernels.moment_flow_step as benchmark/trace.py does (by module
    attribute), keeping each call's arguments and a copy of its y and ell
    as they were at the call."""
    calls = []
    orig = kernels.moment_flow_step

    def wrapped(*args, **kw):
        calls.append((args, args[1].clone(), args[8].clone()))
        return orig(*args, **kw)

    monkeypatch.setattr(kernels, "moment_flow_step", wrapped)
    return calls


def _check_recorded(calls, iters, p):
    """One call per iteration run, the loop reading the stop flag once per
    ALIGN_CHUNK iterations; each call's y and ell distinct tensors, on
    storage of their own, still holding what they held at the call."""
    chunk = engine.ALIGN_CHUNK
    assert len(calls) == min(-(-(iters + 1) // chunk) * chunk, p.max_iter)
    ys = [c[0][1] for c in calls]
    ells = [c[0][8] for c in calls]
    assert len({id(t) for t in ys + ells}) == 2 * len(calls)
    assert len({t.data_ptr() for t in ys}) == len(calls)
    assert len({t.data_ptr() for t in ells}) == len(calls)
    for (args, y, ell) in calls:
        assert torch.equal(args[1], y) and torch.equal(args[8], ell)


# -- on the CPU ---------------------------------------------------------------

def test_cpu_pallas_mom_is_the_plain_loop(monkeypatch):
    """On the CPU, align under 'pallas_mom' runs align_loop (never the
    card's loop) and equals align_loop over moment_flow_step_plain bit for
    bit; its align span says the epilogue ran on the host."""
    def card_loop(*a, **k):
        raise AssertionError("the card's loop ran on the CPU")

    monkeypatch.setattr(engine, "align_loop_moment_cuda", card_loop)
    (x, fx, mx), (y, fy, my) = fixture_clouds()
    spans.enable()
    try:
        got = engine.align(_cloud((x, fx, mx)), _cloud((y, fy, my)),
                           *_start(), P, "pallas_mom")
    finally:
        spans.disable()
    taken = [s for s in spans.take() if s.name == "align"]
    assert [s.attrs["epilogue"] for s in taken] == ["host"]
    center, U = pairwise.step_moment_basis(x, mx)
    want = engine.align_loop(
        lambda yy, ell: kernels.moment_flow_step_plain(
            x, yy, fx, fy, mx, my, U.contiguous(), center, ell, P),
        y, *_start(), P)
    assert int(got.iters) < P.max_iter
    for name, g, w in zip(engine.AlignResult._fields, got, want):
        assert torch.equal(g, w), name


DEVICES = ("cpu", "cuda", "cuda:1", "meta")


@pytest.mark.parametrize("backend", engine.BACKENDS)
def test_loop_chosen_by_device_and_backend(backend, monkeypatch):
    """The state update runs on the card for 'pallas' and 'pallas_mom' on
    a CUDA device and nowhere else, whatever the environment says."""
    want = {d: "card" if d.startswith("cuda")
            and backend in ("pallas", "pallas_mom") else "host"
            for d in DEVICES}
    for env in ({}, {"CVO_SLAM_BACKEND": "pallas_iter",
                     "CVO_SLAM_SPECULATE": "0"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for d in DEVICES:
            assert engine.epilogue_site(backend, torch.device(d)) == want[d]
            assert engine.epilogue_site(backend, d) == want[d]


@pytest.mark.parametrize("backend", ["pallas_mom", "pallas_iter"])
def test_kernel_calls_as_the_benchmark_records_them(backend, monkeypatch):
    """With kernels.moment_flow_step wrapped as benchmark/trace.py wraps
    it, a 'pallas_mom' align makes one call per iteration it runs, whose y
    and ell nothing overwrites later; 'pallas_iter' makes none."""
    calls = _record_calls(monkeypatch)
    (x, fx, mx), (y, fy, my) = fixture_clouds()
    res = engine.align(_cloud((x, fx, mx)), _cloud((y, fy, my)), *_start(),
                       P, backend)
    if backend == "pallas_iter":
        assert calls == []
        return
    _check_recorded(calls, int(res.iters), P)


def _anneal_as_the_kernel(schedule, k, ell):
    """csrc/align_state.cuh's anneal: each step in order, ell = value when
    k > iteration."""
    for it, val in zip(*schedule):
        if k > it:
            ell = np.float32(val)
    return ell


@pytest.mark.parametrize("anneal", [
    ((2, 9, 19), (0.10, 0.06, 0.03)),
    ((5,), (0.07,)),
    ((), ()),
    ((0, 3), (0.2, 0.1)),
])
def test_anneal_schedule_matches_update(anneal):
    """The schedule packed for the kernels (three steps, padded with steps
    that never fire) anneals ell as _update does at every k; a longer
    schedule, or one whose lists differ in length, is refused."""
    p = dataclasses.replace(P, ell_anneal_iters=anneal[0],
                            ell_anneal_values=anneal[1], max_iter=40)
    schedule = kernels.anneal_schedule(p)
    assert len(schedule[0]) == len(schedule[1]) == kernels.ANNEAL_STEPS
    hf, hi = kernels._align_params(p)
    assert list(hi)[:3] == list(schedule[0])
    assert list(hf)[11:14] == [float(np.float32(v)) for v in schedule[1]]
    # an iteration that runs on: the flow well above eps, a step of 0.2
    z = torch.zeros(())
    out = (torch.tensor([0.01, 0.0, 0.0]), torch.tensor([0.0, 0.02, 0.0]),
           torch.tensor(7, dtype=torch.int32), torch.tensor(1.0), z, z, z)
    ell0 = np.float32(0.15)
    for k in range(p.max_iter):
        state = engine._initial_state(torch.eye(3), torch.zeros(3), ell0,
                                      "cpu", p)
        got = engine._update(state, k, out, p)
        assert not bool(got[3])
        assert float(got[2]) == float(_anneal_as_the_kernel(schedule, k,
                                                            ell0)), k
    for bad in (((1, 2, 3, 4), (0.1, 0.1, 0.1, 0.1)), ((1, 2), (0.1,))):
        with pytest.raises(ValueError):
            kernels.anneal_schedule(dataclasses.replace(
                P, ell_anneal_iters=bad[0], ell_anneal_values=bad[1]))


def test_new_wrappers_reject_bad_inputs():
    """The epilogue and state wrappers check their inputs before any
    build."""
    x, fx, mx, y, fy, my = make_clouds(1, 100, 90, 128)
    center, U = pairwise.step_moment_basis(x, mx)
    Mom, nnz = kernels.moment_pass_plain(x, y, fx, fy, mx, my, U, 0.1, P)
    with pytest.raises(ValueError):
        kernels.moment_epilogue_cuda(Mom[:, :34], y, center, 0.1, nnz, P)
    with pytest.raises(ValueError):
        kernels.moment_epilogue_cuda(Mom, y.T, center, 0.1, nnz, P)
    with pytest.raises(ValueError):
        kernels.moment_epilogue_cuda(Mom, y, center[:2], 0.1, nnz, P)
    with pytest.raises(ValueError):
        kernels.moment_epilogue(Mom.to("meta"), y, center, 0.1, nnz, P)
    R, T, ell = _start()
    with pytest.raises(ValueError):
        kernels.moment_state_init(y, torch.eye(4), T, ell, P)
    with pytest.raises(ValueError):
        kernels.moment_state_init(y, R.T.contiguous()[:, :2], T, ell, P)
    with pytest.raises(ValueError):
        kernels.moment_state_init(y, R, T, ell.reshape(1), P)
    with pytest.raises(ValueError):
        kernels.moment_state_init(y[:, :2], R, T, ell, P)
    f = torch.zeros(29)
    out = kernels.moment_flow_step_plain(x, y, fx, fy, mx, my, U, center,
                                         0.1, P)
    with pytest.raises(ValueError):
        kernels.moment_state_step(kernels.MomentState(
            f, torch.zeros(3, dtype=torch.int64)), out, y, 0, P)
    state = kernels.MomentState(f, torch.zeros(3, dtype=torch.int32))
    # each of the pass output's seven tensors is checked on its own
    omega, v, nnz, B, C, D, E = out
    for bad in ((omega[:2], v, nnz, B, C, D, E),
                (omega, v.double(), nnz, B, C, D, E),
                (omega, v, nnz.long(), B, C, D, E),
                (omega, v, nnz, B.reshape(1), C, D, E),
                (omega, v, nnz, B, C, D, E.double())):
        with pytest.raises(ValueError):
            kernels.moment_state_step(state, bad, y, 0, P)


def _twin_state_launch(R, T, ell, n, out, k, y0, p):
    """A torch twin of the state launch: engine._update, then the moved
    cloud as engine.align_loop makes it."""
    if n is None:
        state = engine._initial_state(R, T, ell, y0.device, p)
    else:
        state = (R.clone(), T.clone(), ell.clone(), n[0].bool(),
                 n[1].long(), n[2].clone())
    if k >= 0:
        state = engine._update(state, k, out, p)
    R, T, ell, done, iters, nnz = state
    tf = se3.make_pose(R.T, -(R.T @ T))
    f = torch.cat([R.reshape(9), T, ell.reshape(1), tf.reshape(16)])
    n = torch.stack([done.int(), iters.int(), nnz.int()])
    y = (y0 @ R + (-(R.T @ T))[None, :]).contiguous()
    return kernels.MomentState(f, n), y


def test_card_loop_logic_on_the_cpu(monkeypatch):
    """align_loop_moment_cuda with its state launches replaced by a torch
    twin of _update runs align_loop's iterations: the same iterations,
    nnz, ell and pose bit for bit, one moment_flow_step call per iteration
    with y and ell that nothing overwrites, one state launch per call and
    one for the initial state."""
    launches = []

    def twin(*a):
        launches.append(a[5])
        return _twin_state_launch(*a)

    monkeypatch.setattr(kernels, "_state_launch", twin)
    calls = _record_calls(monkeypatch)
    (x, fx, mx), (y, fy, my) = fixture_clouds()
    center, U = pairwise.step_moment_basis(x, mx)
    U = U.contiguous()
    got = engine.align_loop_moment_cuda(x, fx, mx, y, fy, my, U, center,
                                        *_start(), P)
    _check_recorded(calls, int(got.iters), P)
    assert launches == [-1] + list(range(len(calls)))
    want = engine.align_loop(
        lambda yy, ell: kernels.moment_flow_step_plain(
            x, yy, fx, fy, mx, my, U, center, ell, P), y, *_start(), P)
    assert int(got.iters) == int(want.iters) < P.max_iter
    for name in ("R", "T", "ell", "nnz"):
        assert torch.equal(getattr(got, name),
                           getattr(want, name).to(getattr(got, name).dtype))
    np.testing.assert_array_equal(got.transform.numpy(),
                                  want.transform.numpy())


# -- on the card -------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU tests above hold the "
                    "loop, the kernels run only on the card")


def _assert_moment(got, want):
    """tests/test_torch_kernels._assert_moment's bars."""
    for name, g, w in zip(NAMES, got, want):
        g, w = g.cpu(), w.cpu()
        if name == "nnz":
            assert int(g) == int(w), (int(g), int(w))
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=2e-4, atol=1e-5, err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("ell", [0.15, 0.06])
@pytest.mark.parametrize("cap,n,m", [(250, 240, 190), (3000, 2900, 2800)])
def test_epilogue_cuda_matches_plain(cap, n, m, ell):
    """The epilogue kernel against flow_and_step_from_moments on the
    moment kernel's own Mom, and moment_flow_step against its plain
    version, at test_torch_kernels' bars; two launches bitwise equal; one
    epilogue launch a call."""
    _need_card()
    x, fx, mx, y, fy, my = [a.cuda() for a in make_clouds(13, n, m, cap)]
    center, U = pairwise.step_moment_basis(x, mx)
    U = U.contiguous()
    ell_t = torch.tensor(ell, device="cuda")
    Mom, nnz = kernels.moment_pass_cuda(x, y, fx, fy, mx, my, U, ell_t, P)
    before = kernels.MOMENT_EPILOGUE.launches
    got = kernels.moment_epilogue(Mom, y, center, ell_t, nnz, P)
    assert kernels.MOMENT_EPILOGUE.launches == before + 1
    want = pairwise.flow_and_step_from_moments(Mom, y, center, ell_t, nnz, P)
    _assert_moment(got, want)
    again = kernels.moment_epilogue_cuda(Mom, y, center, ell_t, nnz, P)
    for name, g, a in zip(NAMES, got, again):
        assert torch.equal(g, a), name
    _assert_moment(kernels.moment_flow_step(x, y, fx, fy, mx, my, U, center,
                                            ell, P),
                   kernels.moment_flow_step_plain(x, y, fx, fy, mx, my, U,
                                                  center, ell, P))


def _rot(twist):
    return torch.as_tensor(se3.exp_se3_np(np.asarray(twist, np.float32))
                           [:3, :3].astype(np.float32))


# crafted pass outputs: (omega, v, (B, C, D, E)); the step cubic is
# 4E s^3 + 3D s^2 + 2C s + B, so E = 1/4, C = D = 0 gives s^3 = -B
RUN = ((0.01, -0.02, 0.005), (0.03, 0.01, -0.02), (-1e-3, 0, 0, 0.25))
CASES = {
    # flow norms below eps: stop before the update
    "stop1": ((1e-5, 0, 0), (0, 2e-5, 1e-5), (-1e-3, 0, 0, 0.25)),
    # a step of 0.1 of a 6e-5 flow: the increment's se3 distance 6e-6
    "stop2": ((0, 0, 0), (0, 6e-5, 0), (-1e-3, 0, 0, 0.25)),
    # s^3 = -1e-3 has no positive root: the fallback min_step
    "no_root": RUN[:2] + ((1e-3, 0, 0, 0.25),),
    # a zero leading coefficient: the fallback min_step
    "zero_lead": RUN[:2] + ((-1e-3, 0.3, 0.2, 0.0),),
    # s^3 = 1: the root 1 clamped at max_step
    "max_step": RUN[:2] + ((-1.0, 0, 0, 0.25),),
    "run": RUN,
}


def _crafted(name, device):
    """A crafted pass output (omega, v, nnz, B, C, D, E), each a tensor of
    its own (the state kernel takes one pointer per output)."""
    w, v, bcde = CASES[name]
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(w, **f32), torch.tensor(v, **f32),
            torch.tensor(1234, dtype=torch.int32, device=device),
            *(torch.tensor(q, **f32) for q in bcde))


def _state(device, done=False):
    R = _rot([0.05, -0.03, 0.02, 0, 0, 0]).to(device)
    T = torch.tensor([0.1, -0.2, 0.3], device=device)
    ell = torch.tensor(0.15, device=device)
    n = torch.tensor([int(done), 7 if done else P.max_iter, 99],
                     dtype=torch.int32, device=device)
    f = torch.cat([R.reshape(9), T, ell.reshape(1),
                   torch.zeros(16, device=device)])
    return kernels.MomentState(f, n)


def _case_ids():
    ks = sorted({k + d for k in P.ell_anneal_iters for d in (-1, 0, 1)})
    return ([(name, 0, False) for name in CASES]
            + [("run", k, False) for k in ks] + [("run", 5, True),
                                                 ("stop1", 5, True)])


@pytest.mark.gpu
@pytest.mark.parametrize("name,k,done", _case_ids())
def test_state_step_matches_update(name, k, done):
    """The state kernel against engine._update on the card: R, T and the
    moved cloud to f32 rounding, done, iters, nnz and ell exact, the
    transform [R^T | -R^T T]; a stopped alignment frozen; two launches
    bitwise equal."""
    _need_card()
    dev = "cuda"
    st = _state(dev, done)
    out = _crafted(name, dev)
    y0 = make_clouds(5, 300, 300, 320)[3].to(dev)
    got, y = kernels.moment_state_step(st, out, y0, k, P)
    want = engine._update((st.R.clone(), st.T.clone(), st.ell.clone(),
                           st.done.bool(), st.iters.long(), st.nnz.clone()),
                          k, out, P)
    R, T, ell, dn, iters, nnz = want
    assert bool(got.done) == bool(dn)
    assert int(got.iters) == int(iters) and int(got.nnz) == int(nnz)
    assert float(got.ell) == float(ell)
    torch.testing.assert_close(got.R, R, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got.T, T, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got.transform,
                               se3.make_pose(R.T, -(R.T @ T)),
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(y, y0 @ R - (R.T @ T)[None, :], rtol=1e-5,
                               atol=1e-6)
    if done or name in ("stop1",):
        assert torch.equal(got.R, st.R) and torch.equal(got.T, st.T)
    if done:
        assert torch.equal(got.f[:13], st.f[:13])
        assert torch.equal(got.n, st.n)
    again, y2 = kernels.moment_state_step(st, out, y0, k, P)
    assert torch.equal(again.f, got.f) and torch.equal(again.n, got.n)
    assert torch.equal(y2, y)


@pytest.mark.gpu
def test_state_init_on_the_card():
    """The initial state: R0, T0, ell0 as given, not done, iters max_iter,
    nnz 0, and the initial moved cloud."""
    _need_card()
    y0 = make_clouds(5, 300, 300, 320)[3].cuda()
    R0 = _rot([0.02, 0.01, -0.03, 0, 0, 0]).cuda()
    T0 = torch.tensor([0.05, 0.0, -0.1], device="cuda")
    ell0 = torch.tensor(0.12, device="cuda")
    st, y = kernels.moment_state_init(y0, R0, T0, ell0, P)
    assert torch.equal(st.R, R0) and torch.equal(st.T, T0)
    assert float(st.ell) == float(ell0)
    assert st.n.tolist() == [0, P.max_iter, 0]
    torch.testing.assert_close(y, y0 @ R0 - (R0.T @ T0)[None, :], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [512, 3072])
def test_align_on_the_card_matches_plain_loop(cap, monkeypatch):
    """A whole 'pallas_mom' align on the card (align_loop_moment_cuda)
    against align_loop over the plain moment pass, run on the card, within
    BARS; the benchmark's recorded calls intact; one epilogue launch per
    call, one state launch per call and one more."""
    _need_card()
    fixed, moving = fixture_clouds(cap, cap - 32)
    fixed, moving = _cloud(fixed, "cuda"), _cloud(moving, "cuda")
    calls = _record_calls(monkeypatch)
    before = (kernels.MOMENT_EPILOGUE.launches,
              kernels.MOMENT_STATE.launches)
    spans.enable()
    try:
        got = engine.align(fixed, moving, *_start("cuda"), P, "pallas_mom")
    finally:
        spans.disable()
    assert [s.attrs["epilogue"] for s in spans.take()
            if s.name == "align"] == ["card"]
    _check_recorded(calls, int(got.iters), P)
    assert (kernels.MOMENT_EPILOGUE.launches - before[0],
            kernels.MOMENT_STATE.launches - before[1]) \
        == (len(calls), len(calls) + 1)
    x, fx, mx = fixed
    y0, fy, my = moving
    center, U = pairwise.step_moment_basis(x, mx)
    want = engine.align_loop(
        lambda yy, ell: kernels.moment_flow_step_plain(
            x, yy, fx, fy, mx, my, U.contiguous(), center, ell, P),
        y0, *_start("cuda"), P)
    assert int(got.iters) < P.max_iter
    assert abs(int(got.iters) - int(want.iters)) <= BARS["iters"]
    dt, da = _rigid_err(got.transform.cpu().numpy(),
                        want.transform.cpu().numpy())
    assert dt < BARS["pos"] and da < BARS["rot"], (dt, da)
    torch.testing.assert_close(
        got.transform, se3.make_pose(got.R.T, -(got.R.T @ got.T)),
        rtol=1e-6, atol=1e-6)
    again = engine.align(fixed, moving, *_start("cuda"), P, "pallas_mom")
    for name, g, a in zip(engine.AlignResult._fields, got, again):
        assert torch.equal(g, a), name


@pytest.mark.gpu
def test_four_launches_an_iteration():
    """The card's loop makes four kernel launches an iteration (both
    moment passes, the epilogue, the state update) and one for the initial
    state, counted with the profiler as test_torch_kernels counts the
    suite's; no other device operation but the stop flag's reads."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    fixed, moving = fixture_clouds(3072, 3040)
    (x, fx, mx), (y0, fy, my) = [[a.cuda() for a in c]
                                 for c in (fixed, moving)]
    center, U = pairwise.step_moment_basis(x, mx)
    U = U.contiguous()
    start = _start("cuda")

    def run():
        return engine.align_loop_moment_cuda(x, fx, mx, y0, fy, my, U,
                                             center, *start, P)

    run()
    torch.cuda.synchronize()
    before = kernels.MOMENT.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    calls = kernels.MOMENT.launches - before
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in events]
    reads = sum("Memcpy" in n for n in names)
    kernels_run = len(names) - reads
    chunk = engine.ALIGN_CHUNK
    assert calls == min(-(-(int(res.iters) + 1) // chunk) * chunk,
                        P.max_iter)
    assert reads == -(-calls // chunk), names
    assert kernels_run == 4 * calls + 1, names
    assert sum("moment_epilogue_kernel" in n for n in names) == calls
    assert sum("moment_state_kernel" in n for n in names) == calls + 1


# align_fused on fixture_clouds() from the identity at ell 0.15, then from
# that result: R, T, ell as float32 bits, iters and nnz, read from the build
# before the scalar helpers moved to csrc/align_state.cuh (NVIDIA H100 80GB
# HBM3, CUDA 12; the kernels' float operations are deterministic there)
_SAME_START = [1065352489, 1000515686, 1006706696, 3148166870, 1065352180,
               1008879789, 3154137072, 3156405681, 1065351875, 3164666127,
               3156127956, 1014482186, 1022739087]
ALIGN_FUSED_BEFORE = [_SAME_START + [63, 482], _SAME_START + [0, 482]]


def _bits(t):
    return [int(b) for b in
            t.detach().cpu().reshape(-1).numpy().view(np.uint32)]


def align_fused_outputs():
    """(cold, warm) align_fused outputs on fixture_clouds(), each a list of
    the float32 bits of R, T, ell and then iters and nnz."""
    (x, fx, mx), (y, fy, my) = [[a.cuda() for a in c]
                                for c in fixture_clouds()]
    R, T, ell = _start("cuda")
    out = []
    for _ in range(2):
        R, T, ell, iters, nnz = kernels.align_fused(x, fx, mx, y, fy, my, R,
                                                    T, ell, P)
        out.append(_bits(R) + _bits(T) + _bits(ell)
                   + [int(iters), int(nnz)])
        R, T = R.contiguous(), T.contiguous()
    return out


@pytest.mark.gpu
def test_align_fused_unchanged_by_the_header_move():
    """align_fused's cold and warm outputs on the fixture equal, bit for
    bit, those of the build before its state and epilogue moved into the
    header that the pallas_mom state kernel shares."""
    _need_card()
    assert align_fused_outputs() == ALIGN_FUSED_BEFORE
