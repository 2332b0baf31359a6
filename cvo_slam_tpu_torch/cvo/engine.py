"""CVO registration engine: the align loop and the host-side state machine
(port of cvo_slam_tpu.cvo.engine).

  * `align` (cvo.cpp:763-821) carries (R, T, ell) with both stopping rules
    (flow norms < eps at :782; se3 distance < eps_2 at :804) and the ell
    anneal schedule (:810-812) on one of four backends, named as in the
    JAX package (CVO_SLAM_BACKEND, `default_backend`):
      - 'pallas_mom' (default) and 'pallas_iter': a host loop of device
        iterations running the moment kernel
        (cvo.kernels.moment_flow_step) or the per-pair kernel
        (cvo.kernels.flow_and_step) once per iteration. Every state update
        is gated on `active = ~done`, so iterations run after the stop are
        no-ops: the loop reads the stop flag from the device only once per
        chunk of ALIGN_CHUNK iterations, and the iteration count is the
        same as a loop that stops at once. 'pallas_mom' on a CUDA device
        runs `align_loop_moment_cuda`: four launches an iteration (the
        moment kernel's two passes, its epilogue, the state update with the
        next moved cloud, cvo.kernels.moment_state_step) and no PyTorch
        operation, after one launch for the initial state. 'pallas_iter', and 'pallas_mom' on the
        CPU, run `align_loop`, whose `_update` is the plain version of that
        state update;
      - 'pallas': the whole loop in one launch (cvo.kernels.align_fused);
      - 'xla': the JAX package's dense moment-form pass in plain torch
        (ops.pairwise.flow_and_step_moments_lanes: the gated colour kernel
        and the moment basis loop constants, per iteration the (N, M)
        kernel matrix, one torch.mm A^T U and the epilogue), through
        `align_loop_lanes`; the solo align is its one-lane run. The JAX
        package routes 'pallas_mom' here for lanes and loop-closure
        verification (parallel.batch._batch_backend).
  * `compute_innerproduct` runs the suite kernel (cvo.kernels.ip_suite);
    `compute_innerproduct_lc` (cvo.cpp:505-561) runs the pair-stats kernel
    (cvo.kernels.pair_stats) 6 + 2 times, `compute_innerproduct_lc_lanes`
    the same 6 + 2 calls over S candidates, each one pair-stats lanes
    launch (cvo.kernels.pair_stats_lanes), and `lc_verify_batch`
    re-registers the loop-closure candidates of a round (under 'pallas' as
    the lanes of one align_fused launch, under 'xla' as one lane program)
    and scores them, two or more as lanes (the JAX package's vmap).
  * the lanes (the JAX package's vmapped align, multi_sequence.py:44-73):
    `align_lanes`, `compute_innerproduct_lanes`,
    `align_and_innerproduct_lanes` and `frame_step_lanes` run S requests of
    one kind at once, under 'pallas' through one align_fused_lanes launch
    per align and one ip_suite_lanes launch per inner-product suite, under
    'xla' as one program (one (S, N, M) pass and one epilogue per
    iteration, `align_loop_lanes`); each lane equals the one-lane function
    on its inputs bit for bit. 'pallas_mom' and 'pallas_iter' align lane
    by lane.
  * the Hessian's eigenvalue floor (se3_Hessian, cvo.cpp:620-759) is
    `hessian_postprocess` (`hessian_postprocess_lanes` for a stack), one
    launch of the epilogue kernel (cvo.kernels.hessian_post) per inner
    product or stack of lanes, with no host read.

Host-side `Cvo` mirrors the reference state plumbing: fixed/moving/previous
clouds, update_fixed_pcd (:578), update_previous_pcd (:584), reset_keyframe
(:591-604), reset_transform (:606-609), reset_initial (:611-618).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import spans
from ..config import CvoParams
from ..device import resolve_device
from ..frontend.pointcloud import PointCloudHost
from ..ops import cubic, pairwise, se3
from . import kernels

ALIGN_CHUNK = 4   # align iterations between two reads of the stop flag
BACKENDS = ("pallas_mom", "pallas", "pallas_iter", "xla")


class PointCloud(NamedTuple):
    """Device-side fixed-capacity point cloud."""
    positions: torch.Tensor  # (CAP, 3) f32
    features: torch.Tensor   # (CAP, 5) f32
    mask: torch.Tensor       # (CAP,) bool

    @staticmethod
    def from_host(pc: PointCloudHost, device="cuda") -> "PointCloud":
        dev = resolve_device(device)
        return PointCloud(
            torch.as_tensor(np.ascontiguousarray(pc.positions, np.float32)
                            ).to(dev),
            torch.as_tensor(np.ascontiguousarray(pc.features, np.float32)
                            ).to(dev),
            torch.as_tensor(np.ascontiguousarray(pc.mask, bool)).to(dev))

    @property
    def device(self) -> torch.device:
        return self.positions.device


class AlignResult(NamedTuple):
    R: torch.Tensor          # (3,3) internal state (transform = [R^T | -R^T T])
    T: torch.Tensor          # (3,)
    transform: torch.Tensor  # (4,4) the registration output
    ell: torch.Tensor        # annealed length-scale after the loop
    iters: torch.Tensor      # iteration count at break (max_iter if exhausted)
    nnz: torch.Tensor        # A_nonzero of the last flow evaluation


def _f32(v, device):
    """A float32 tensor on `device` from a tensor or a host array / scalar
    (a copy from pageable host memory, which on a CUDA device first waits
    for the work queued on the stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    with spans.span("device.write"):
        return torch.tensor(np.asarray(v, np.float32), device=device)


def default_backend() -> str:
    """The align backend named by CVO_SLAM_BACKEND, as the JAX package reads
    it: 'pallas_mom' (the moment kernel per iteration; the default),
    'pallas' (the whole align loop in one align_fused launch),
    'pallas_iter' (one flow_and_step launch per iteration) or 'xla' (the
    dense moment-form pass in plain torch)."""
    env = os.environ.get("CVO_SLAM_BACKEND", "")
    return check_backend(env) if env else "pallas_mom"


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown align backend {backend!r}: the port runs "
            f"{', '.join(BACKENDS)}")
    return backend


def align(fixed: PointCloud, moving: PointCloud, R0, T0, ell0,
          p: CvoParams, backend: str = "pallas_mom") -> AlignResult:
    """RKHS-SE(3) gradient-flow registration (cvo.cpp:763-821) on `backend`
    (see default_backend)."""
    check_backend(backend)
    with spans.span("align") as sp:
        sp.set("backend", backend)
        dev = fixed.device
        sp.set("epilogue", epilogue_site(backend, dev))
        x, fx, mx = fixed.positions, fixed.features, fixed.mask
        y0, fy, my = moving.positions, moving.features, moving.mask
        R0, T0 = _f32(R0, dev), _f32(T0, dev)
        ell0 = _f32(ell0, dev).reshape(())
        if backend == "pallas":
            R, T, ell, iters, nnz = kernels.align_fused(
                x, fx, mx, y0, fy, my, R0.contiguous(), T0.contiguous(),
                ell0, p)
            return AlignResult(R, T, se3.make_pose(R.T, -(R.T @ T)), ell,
                               iters, nnz)
        if backend == "xla":
            res = _align_xla_lanes(fixed, stack_clouds([moving]), [R0],
                                   [T0], [ell0], p)
            return AlignResult(*(t[0] for t in res))
        if backend == "pallas_iter":
            def iterate(y, ell):
                return kernels.flow_and_step(x, y, fx, fy, mx, my, ell, p)
        else:
            # the fixed cloud never moves (cvo.cpp:336), so its centred
            # moment basis is a loop constant
            center, U = pairwise.step_moment_basis(x, mx)
            U = U.contiguous()
            if epilogue_site(backend, dev) == "card":
                return align_loop_moment_cuda(x, fx, mx, y0, fy, my, U,
                                              center, R0, T0, ell0, p)

            def iterate(y, ell):
                return kernels.moment_flow_step(x, y, fx, fy, mx, my, U,
                                                center, ell, p)
        return align_loop(iterate, y0, R0, T0, ell0, p)


def epilogue_site(backend: str, device) -> str:
    """Where an align's per-iteration state update runs: 'card' for
    'pallas' (inside align_fused) and 'pallas_mom' (the state kernel of
    align_loop_moment_cuda) on a CUDA device, else 'host' (`_update`'s
    torch operations, launched from the host). Chosen by the device type and
    the backend alone."""
    card = torch.device(device).type == "cuda" \
        and backend in ("pallas", "pallas_mom")
    return "card" if card else "host"


def _initial_state(R0, T0, ell0, device, p: CvoParams):
    """(R, T, ell, done, iters, nnz) of an alignment before its first
    iteration, each tensor its own."""
    return (_f32(R0, device).clone(), _f32(T0, device).clone(),
            _f32(ell0, device).reshape(()).clone(),
            torch.zeros((), dtype=torch.bool, device=device),
            torch.full((), p.max_iter, dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def _update(state, k: int, out, p: CvoParams):
    """One align iteration's state update from the pass output
    out = (omega, v, nnz, B, C, D, E) at iteration k: the step size, both
    stop tests and the ell anneal, every update gated on active = ~done."""
    R, T, ell, done, iters, nnz = state
    omega, v, nnz_k, B, C, D, E = out
    step = cubic.min_positive_root_or(4.0 * E, 3.0 * D, 2.0 * C, B,
                                      p.min_step, p.max_step)
    active = ~done
    # stop 1: flow norms below eps (:782) — break before the update
    stop1 = active & (torch.linalg.norm(omega) < p.eps) \
        & (torch.linalg.norm(v) < p.eps)
    do_update = active & ~stop1
    dtrans = se3.exp_sek3(torch.cat([omega, v]), step)
    dR = dtrans[:3, :3]
    dT = dtrans[:3, 3]
    T_new = torch.where(do_update, R @ dT + T, T)
    R = torch.where(do_update, R @ dR, R)
    T = T_new
    # stop 2: se3 distance of the increment below eps_2 (:804)
    stop2 = do_update & (se3.dist_se3(dR, dT) < p.eps_2)
    done_new = done | stop1 | stop2
    iters = torch.where(active & (stop1 | stop2),
                        torch.full_like(iters, k), iters)
    # ell anneal (:810-812) — skipped on break (it follows the break)
    ell_ann = ell
    for it, val in zip(p.ell_anneal_iters, p.ell_anneal_values):
        if k > it:
            ell_ann = torch.full_like(ell, val)
    ell = torch.where(active & ~stop1 & ~stop2, ell_ann, ell)
    nnz = torch.where(active, nnz_k, nnz)
    return R, T, ell, done_new, iters, nnz


def _result(state) -> AlignResult:
    R, T, ell, _, iters, nnz = state
    transform = se3.make_pose(R.T, -(R.T @ T))   # final update_tf (:817)
    return AlignResult(R, T, transform, ell, iters, nnz)


def align_loop(iterate, y0, R0, T0, ell0, p: CvoParams) -> AlignResult:
    """The host align loop carrying (R, T, ell) from (R0, T0, ell0), with
    `iterate(y, ell)` -> (omega, v, nnz, B, C, D, E) the pairwise pass of
    one iteration on the transformed moving positions y."""
    state = _initial_state(R0, T0, ell0, y0.device, p)
    k = 0
    while k < p.max_iter:
        for _ in range(min(ALIGN_CHUNK, p.max_iter - k)):
            # update_tf (:106-110): transform = [R^T | -R^T T]; transform_pcd
            R, T = state[0], state[1]
            Rt = R.T
            Tt = -(Rt @ T)
            y = (y0 @ R + Tt[None, :]).contiguous()
            state = _update(state, k, iterate(y, state[2]), p)
            k += 1
        with spans.span("device.read"):
            done = bool(state[3])
        if done:
            break
    return _result(state)


def align_loop_moment_cuda(x, fx, mx, y0, fy, my, U, center, R0, T0, ell0,
                           p: CvoParams) -> AlignResult:
    """align_loop of the 'pallas_mom' backend on a CUDA device, with no
    PyTorch operation an iteration: kernels.moment_flow_step (the moment
    kernel's two passes and its epilogue), then kernels.moment_state_step
    (the state update of `_update` and the next moved cloud), each
    iteration's cloud and state new tensors. The stop flag is read once per
    ALIGN_CHUNK iterations; the result's tensors are views of the last
    state."""
    state, y = kernels.moment_state_init(y0, R0.contiguous(),
                                         T0.contiguous(), ell0, p)
    k = 0
    while k < p.max_iter:
        for _ in range(min(ALIGN_CHUNK, p.max_iter - k)):
            out = kernels.moment_flow_step(x, y, fx, fy, mx, my, U, center,
                                           state.ell, p)
            state, y = kernels.moment_state_step(state, out, y0, k, p)
            k += 1
        with spans.span("device.read"):
            done = bool(state.done)
        if done:
            break
    return AlignResult(state.R, state.T, state.transform, state.ell,
                       state.iters, state.nnz)


def _moved_lanes(y0, R, T):
    """y0 (S, M, 3) under each lane's update_tf [R^T | -R^T T]
    (cvo.cpp:106-110, :336): y0 R - R^T T, written out per component so
    each lane's points do not depend on the lane count."""
    Tt = -(R[:, 0, :] * T[:, 0, None] + R[:, 1, :] * T[:, 1, None]
           + R[:, 2, :] * T[:, 2, None])
    return (y0[..., 0, None] * R[:, None, 0, :]
            + y0[..., 1, None] * R[:, None, 1, :]
            + y0[..., 2, None] * R[:, None, 2, :] + Tt[:, None, :])


def align_loop_lanes(iterate, y0, states, p: CvoParams):
    """align_loop over S lanes run as one program: `iterate(y, ell)` the
    pass of every lane at once on y (S, M, 3) and ell (S,), returning
    (omega, v, nnz, B, C, D, E) with a leading lane axis; then each lane's
    `_update` (a stopped lane frozen while the others run, the JAX
    package's vmap-of-while). The loop reads the lanes' stop flags once per
    ALIGN_CHUNK iterations and ends when every lane has stopped. Returns
    the lanes' states."""
    k = 0
    while k < p.max_iter:
        for _ in range(min(ALIGN_CHUNK, p.max_iter - k)):
            R, T, ell = (torch.stack([s[i] for s in states])
                         for i in range(3))
            out = iterate(_moved_lanes(y0, R, T), ell)
            states = [_update(s, k, [o[l] for o in out], p)
                      for l, s in enumerate(states)]
            k += 1
        with spans.span("device.read"):
            done = bool(torch.stack([s[3] for s in states]).all())
        if done:
            break
    return states


def _align_xla_lanes(fixed, mv: PointCloud, R0, T0, ell0,
                     p: CvoParams) -> AlignResult:
    """The xla align of S lanes as one program: mv the stacked moving
    clouds (S, M, .), fixed one cloud of every lane or a list of S clouds,
    (R0[l], T0[l], ell0[l]) per lane. The gated colour kernel (S, N, M) and
    each fixed cloud's moment basis are loop constants (the JAX package's
    engine.py:178-187). Returns an AlignResult with a leading lane axis."""
    dev = mv.device
    lanes = mv.positions.shape[0]
    if isinstance(fixed, PointCloud):
        fx = fixed
        center, U = pairwise.step_moment_basis(fixed.positions, fixed.mask)
    else:
        fx = stack_clouds(fixed)
        bases = [pairwise.step_moment_basis(f.positions, f.mask)
                 for f in fixed]
        center = torch.stack([c for c, _ in bases])
        U = [u for _, u in bases]
    ckg = pairwise.color_kernel_gated(fx.features, mv.features, fx.mask,
                                      mv.mask, p)

    def iterate(y, ell):
        return pairwise.flow_and_step_moments_lanes(fx.positions, y, ckg, U,
                                                    center, ell, p)

    states = align_loop_lanes(
        iterate, mv.positions,
        [_initial_state(R0[l], T0[l], ell0[l], dev, p)
         for l in range(lanes)], p)
    return AlignResult(*(torch.stack(list(t))
                         for t in zip(*map(_result, states))))


# ---------------------------------------------------------------------------
# Hessian post-processing (cvo.cpp:726-755)
# ---------------------------------------------------------------------------

def hessian_postprocess(H_raw, inliers, p: CvoParams):
    """Scale by -1/1e5 then shift the spectrum until min |eigenvalue| >= 1
    (cvo.cpp:726-754); identity when no inliers (hessian_postprocess_lanes
    of one lane)."""
    return hessian_postprocess_lanes(H_raw[None], inliers.reshape(1), p)[0]


def hessian_postprocess_lanes(H_raw, inliers, p: CvoParams):
    """hessian_postprocess of a stack (S, 6, 6) with inliers (S,): on the
    card one launch of the epilogue kernel (cvo.kernels.hessian_post)."""
    return kernels.hessian_post(H_raw, inliers, p)[0]


@spans.traced("innerproduct")
def compute_innerproduct(fixed: PointCloud, moving: PointCloud, tran, ell,
                         p: CvoParams):
    """Reference compute_innerproduct (cvo.cpp:475-503): inner products
    before/after registration, self-norms, cos angle, and the post-Hessian.
    Returns a dict of device scalars plus the (6,6) post_hessian."""
    dev = fixed.device
    x, fx, mx = fixed.positions, fixed.features, fixed.mask
    y, fy, my = moving.positions, moving.features, moving.mask
    tran = _f32(tran, dev)
    ell = _f32(ell, dev).reshape(())
    yt = se3.transform_points(tran, y).contiguous()
    (pre_v, pre_n, post_v, post_n, fixed_v, _, moving_v, _, G,
     inliers) = kernels.ip_suite(x, fx, mx, y, fy, my, yt, ell, p)
    H_raw = pairwise.assemble_hessian(G, ell)
    cos_angle = post_v / (torch.sqrt(fixed_v) * torch.sqrt(moving_v))
    post_hessian = hessian_postprocess(H_raw, inliers, p)
    return dict(inn_pre=pre_v, inn_pre_num=pre_n, inn_post=post_v,
                inn_post_num=post_n, inn_fixed=fixed_v, inn_moving=moving_v,
                cos_angle=cos_angle, post_hessian=post_hessian,
                inliers=inliers)


def align_and_innerproduct(fixed: PointCloud, moving: PointCloud, R0, T0,
                           ell0, p: CvoParams, backend: str = "pallas_mom"):
    """align followed by compute_innerproduct on its result
    (local_tracker.cpp runs these back-to-back for each cvo instance)."""
    res = align(fixed, moving, R0, T0, ell0, p, backend)
    ip = compute_innerproduct(fixed, moving, res.transform, res.ell, p)
    return res, ip


def frame_step(prev: PointCloud, kf: PointCloud, cur: PointCloud,
               R_odo0, T_odo0, ell_odo0, kf_transform, ell_kf0,
               p: CvoParams, backend: str = "pallas_mom"):
    """The device work of one tracked frame:

      1. odometry align + innerproduct (prev -> cur),
      2. the keyframe warm start on the device (reset_initial,
         cvo.cpp:611-618: R,T <- (kf_transform @ T_odo)^-1 as the rigid
         inverse [R^T | -R^T t], in f32),
      3. keyframe align + innerproduct (kf -> cur).

    Returns (res_odo, ip_odo, res_kf, ip_kf, guess)."""
    res1 = align(prev, cur, R_odo0, T_odo0, ell_odo0, p, backend)
    ip1 = compute_innerproduct(prev, cur, res1.transform, res1.ell, p)
    guess = _f32(kf_transform, prev.device) @ res1.transform
    Rk0 = guess[:3, :3].T
    Tk0 = -(Rk0 @ guess[:3, 3])
    res2 = align(kf, cur, Rk0, Tk0, ell_kf0, p, backend)
    ip2 = compute_innerproduct(kf, cur, res2.transform, res2.ell, p)
    return res1, ip1, res2, ip2, guess


# ---------------------------------------------------------------------------
# lanes: S requests of one kind at once (the JAX package's vmap)
# ---------------------------------------------------------------------------

def stack_clouds(clouds) -> PointCloud:
    """S clouds of one capacity as one PointCloud with a leading lane
    axis, (S, CAP, .) each, laid for the lane kernels at any capacity
    (kernels.stack_lanes: each lane's points contiguous, the lanes CAP
    rounded up to 16 points apart, so every lane is 16-byte aligned)."""
    return PointCloud(*(kernels.stack_lanes(t) for t in zip(*clouds)))


def unstack_clouds(stacked: PointCloud):
    """The S clouds of a stacked PointCloud (views)."""
    return [PointCloud(*(t[l] for t in stacked))
            for l in range(stacked.positions.shape[0])]


def _lane_fixed(fixed, lanes: int):
    """The fixed clouds of `lanes` lanes: a list of S clouds, or one cloud
    that every lane aligns against."""
    if isinstance(fixed, PointCloud):
        return [fixed] * lanes
    if len(fixed) != lanes:
        raise ValueError(f"{len(fixed)} fixed clouds for {lanes} lanes")
    return list(fixed)


def _stacked_fixed(fixed) -> PointCloud:
    """The kernels' fixed operand: a stack, or the one shared cloud."""
    return fixed if isinstance(fixed, PointCloud) else stack_clouds(fixed)


def _stack_f32(values, dev):
    """Per-lane values (device tensors or host arrays / scalars) as one f32
    tensor with a leading lane axis."""
    if all(isinstance(v, torch.Tensor) for v in values):
        return torch.stack([_f32(v, dev) for v in values])
    return _f32(np.stack([np.asarray(v, np.float32) for v in values]), dev)


def _stack_results(results) -> AlignResult:
    return AlignResult(*(torch.stack(list(v)) for v in zip(*results)))


def align_lanes(fixed, moving, R0, T0, ell0, p: CvoParams,
                backend: str = "pallas_mom", moving_stacked=None,
                fixed_stacked=None) -> AlignResult:
    """align over S lanes (the JAX package's vmapped align): lane l aligns
    moving[l] against fixed[l] (a list of S clouds), or against `fixed` (one
    PointCloud of every lane), from (R0[l], T0[l], ell0[l]). Under 'pallas'
    one align_fused_lanes launch, under 'xla' one lane program
    (_align_xla_lanes), a stopped lane frozen while the others run; under
    'pallas_mom' and 'pallas_iter' lane by lane. Each lane equals align on
    its inputs bit for bit. Returns an AlignResult with a leading lane
    axis. moving_stacked / fixed_stacked: the clouds already stacked."""
    check_backend(backend)
    lanes = len(moving)
    if backend in ("pallas_mom", "pallas_iter"):
        return _stack_results(
            align(f, m, R0[l], T0[l], ell0[l], p, backend)
            for l, (f, m) in enumerate(zip(_lane_fixed(fixed, lanes),
                                           moving)))
    mv = stack_clouds(moving) if moving_stacked is None else moving_stacked
    with spans.span("align") as sp:
        sp.set("backend", backend)
        if backend == "xla":
            return _align_xla_lanes(fixed, mv, R0, T0, ell0, p)
        fx = _stacked_fixed(fixed) if fixed_stacked is None else fixed_stacked
        dev = mv.device
        R, T, ell, iters, nnz = kernels.align_fused_lanes(
            fx.positions, fx.features, fx.mask, mv.positions, mv.features,
            mv.mask, _stack_f32([R0[l] for l in range(lanes)], dev),
            _stack_f32([T0[l] for l in range(lanes)], dev),
            _stack_f32([ell0[l] for l in range(lanes)], dev).reshape(lanes), p)
        # the final update_tf of each lane, as align makes it
        transform = torch.stack([se3.make_pose(R[l].T, -(R[l].T @ T[l]))
                                 for l in range(lanes)])
        return AlignResult(R, T, transform, ell, iters, nnz)


@spans.traced("innerproduct")
def compute_innerproduct_lanes(fixed, moving, tran, ell, p: CvoParams,
                               moving_stacked=None, fixed_stacked=None):
    """compute_innerproduct over S lanes, the suites in one ip_suite_lanes
    launch: fixed/moving as align_lanes takes them, tran[l] and ell[l] per
    lane. Returns compute_innerproduct's dict, each entry with a leading
    lane axis; each lane equals compute_innerproduct on its inputs bit for
    bit."""
    lanes = len(moving)
    mv = stack_clouds(moving) if moving_stacked is None else moving_stacked
    fx = _stacked_fixed(fixed) if fixed_stacked is None else fixed_stacked
    dev = mv.device
    trans = [_f32(tran[l], dev) for l in range(lanes)]
    ells = [_f32(ell[l], dev).reshape(()) for l in range(lanes)]
    yt = kernels.stack_lanes(
        se3.transform_points(trans[l], moving[l].positions).contiguous()
        for l in range(lanes))
    (pre_v, pre_n, post_v, post_n, fixed_v, _, moving_v, _, G,
     inliers) = kernels.ip_suite_lanes(
        fx.positions, fx.features, fx.mask, mv.positions, mv.features,
        mv.mask, yt, torch.stack(ells), p)
    H_raw = torch.stack([pairwise.assemble_hessian(G[l], ells[l])
                         for l in range(lanes)])
    cos_angle = post_v / (torch.sqrt(fixed_v) * torch.sqrt(moving_v))
    post_hessian = hessian_postprocess_lanes(H_raw, inliers, p)
    return dict(inn_pre=pre_v, inn_pre_num=pre_n, inn_post=post_v,
                inn_post_num=post_n, inn_fixed=fixed_v, inn_moving=moving_v,
                cos_angle=cos_angle, post_hessian=post_hessian,
                inliers=inliers)


def align_and_innerproduct_lanes(fixed, moving, R0, T0, ell0, p: CvoParams,
                                 backend: str = "pallas_mom"):
    """align_and_innerproduct over S lanes (align_lanes, then
    compute_innerproduct_lanes on its results, the clouds stacked once)."""
    mv = stack_clouds(moving)
    fx = _stacked_fixed(fixed)
    res = align_lanes(fixed, moving, R0, T0, ell0, p, backend, mv, fx)
    ip = compute_innerproduct_lanes(fixed, moving, res.transform, res.ell,
                                    p, mv, fx)
    return res, ip


def frame_step_lanes(prev, kf, cur, R_odo0, T_odo0, ell_odo0, kf_transform,
                     ell_kf0, p: CvoParams, backend: str = "pallas_mom"):
    """frame_step over S lanes: prev, kf and cur lists of S clouds, the
    other arguments per lane. Two align_lanes and two
    compute_innerproduct_lanes; the keyframe warm start of each lane on the
    device in f32, as frame_step makes it. Returns (res_odo, ip_odo,
    res_kf, ip_kf, guess), each with a leading lane axis."""
    lanes = len(cur)
    dev = cur[0].device
    mv = stack_clouds(cur)
    prev_st, kf_st = stack_clouds(prev), stack_clouds(kf)
    res1 = align_lanes(prev, cur, R_odo0, T_odo0, ell_odo0, p, backend, mv,
                       prev_st)
    ip1 = compute_innerproduct_lanes(prev, cur, res1.transform, res1.ell, p,
                                     mv, prev_st)
    guess = [_f32(kf_transform[l], dev) @ res1.transform[l]
             for l in range(lanes)]
    Rk0 = [g[:3, :3].T for g in guess]
    Tk0 = [-(R @ g[:3, 3]) for R, g in zip(Rk0, guess)]
    res2 = align_lanes(kf, cur, Rk0, Tk0, ell_kf0, p, backend, mv, kf_st)
    ip2 = compute_innerproduct_lanes(kf, cur, res2.transform, res2.ell, p,
                                     mv, kf_st)
    return res1, ip1, res2, ip2, torch.stack(guess)


@spans.traced("innerproduct")
def compute_innerproduct_lc(fixed: PointCloud, moving: PointCloud,
                            prior_tran, lc_prior_tran, lc_prior_tran_2,
                            lc_tran, ell, p: CvoParams):
    """Reference compute_innerproduct_lc (cvo.cpp:505-561): inner products
    of the moving cloud under four transforms against the fixed cloud, both
    self norms, and the post-Hessian of the CVO result with the inlier
    counts under it and under the second (pnpransac) prior. Six pair-stats
    launches without moments and two with them, as the reference's separate
    calls (the second Hessian only yields its inlier count)."""
    dev = fixed.device
    x, fx, mx = fixed.positions, fixed.features, fixed.mask
    y, fy, my = moving.positions, moving.features, moving.mask
    ell = _f32(ell, dev).reshape(())

    def moved(tran):
        return se3.transform_points(_f32(tran, dev), y).contiguous()

    def ip(a, fa, ma, b, fb, mb, with_moments=False):
        return kernels.pair_stats(a, fa, ma, b, fb, mb, ell, p, with_moments)

    y_lc = moved(lc_tran)
    prior_v = ip(moved(prior_tran), fy, my, x, fx, mx)[0]
    lcp_v = ip(moved(lc_prior_tran), fy, my, x, fx, mx)[0]
    pre_v = ip(y, fy, my, x, fx, mx)[0]
    post_v = ip(y_lc, fy, my, x, fx, mx)[0]
    fixed_v = ip(x, fx, mx, x, fx, mx)[0]
    moving_v = ip(y, fy, my, y, fy, my)[0]
    _, _, G, inliers_svd = ip(y_lc, fy, my, x, fx, mx, True)
    inliers_pnp = ip(moved(lc_prior_tran_2), fy, my, x, fx, mx, True)[3]
    H_raw = pairwise.assemble_hessian(G, ell)
    cos_angle = post_v / (torch.sqrt(fixed_v) * torch.sqrt(moving_v))
    post_hessian = hessian_postprocess(H_raw, inliers_svd, p)
    return dict(inn_prior=prior_v, inn_lc_prior=lcp_v, inn_lc_pre=pre_v,
                inn_lc_post=post_v, inn_fixed=fixed_v, inn_moving=moving_v,
                cos_angle=cos_angle, post_hessian=post_hessian,
                inliers_svd=inliers_svd, inliers_pnpransac=inliers_pnp)


@spans.traced("innerproduct")
def compute_innerproduct_lc_lanes(fixed: PointCloud, movings, prior_tran,
                                  lc_prior_tran, lc_prior_tran_2, lc_tran,
                                  ell, p: CvoParams, moving_stacked=None):
    """compute_innerproduct_lc over S candidates against one fixed cloud
    (the JAX package's vmap of it in lc_verify_batch): movings a list of S
    clouds, each transform and ell one entry per candidate. Each of the
    six pair-stats calls without moments and the two with them is one
    pair-stats lanes launch over the candidates (the fixed self set too:
    its clouds are shared, its ell is each candidate's). Returns
    compute_innerproduct_lc's dict, each entry with a leading lane axis;
    each lane equals compute_innerproduct_lc on its inputs bit for bit.
    moving_stacked: the candidates already stacked (stack_clouds)."""
    dev = fixed.device
    lanes = len(movings)
    x, fx, mx = fixed.positions, fixed.features, fixed.mask
    mv = stack_clouds(movings) if moving_stacked is None else moving_stacked
    y, fy, my = mv.positions, mv.features, mv.mask
    ells = torch.stack([_f32(ell[l], dev).reshape(()) for l in range(lanes)])

    def moved(tran):
        return kernels.stack_lanes(
            se3.transform_points(_f32(tran[l], dev), movings[l].positions)
            .contiguous() for l in range(lanes))

    def ip(a, fa, ma, b, fb, mb, with_moments=False):
        return kernels.pair_stats_lanes(a, fa, ma, b, fb, mb, ells, p,
                                        with_moments)

    y_lc = moved(lc_tran)
    prior_v = ip(moved(prior_tran), fy, my, x, fx, mx)[0]
    lcp_v = ip(moved(lc_prior_tran), fy, my, x, fx, mx)[0]
    pre_v = ip(y, fy, my, x, fx, mx)[0]
    post_v = ip(y_lc, fy, my, x, fx, mx)[0]
    fixed_v = ip(x, fx, mx, x, fx, mx)[0]
    moving_v = ip(y, fy, my, y, fy, my)[0]
    _, _, G, inliers_svd = ip(y_lc, fy, my, x, fx, mx, True)
    inliers_pnp = ip(moved(lc_prior_tran_2), fy, my, x, fx, mx, True)[3]
    H_raw = torch.stack([pairwise.assemble_hessian(G[l], ells[l])
                         for l in range(lanes)])
    cos_angle = post_v / (torch.sqrt(fixed_v) * torch.sqrt(moving_v))
    post_hessian = hessian_postprocess_lanes(H_raw, inliers_svd, p)
    return dict(inn_prior=prior_v, inn_lc_prior=lcp_v, inn_lc_pre=pre_v,
                inn_lc_post=post_v, inn_fixed=fixed_v, inn_moving=moving_v,
                cos_angle=cos_angle, post_hessian=post_hessian,
                inliers_svd=inliers_svd, inliers_pnpransac=inliers_pnp)


def lc_verify_batch(fixed: PointCloud, movings, R0, T0, ell0, priors,
                    lc_priors, p: CvoParams, backend: str = "pallas_mom"):
    """Every loop-closure candidate verification of one detection round
    (keyframe_graph.cpp:693-714: reset_initial(lc_prior) -> set_pcd(ref) ->
    match_keyframe(cand) -> compute_innerproduct_lc) against the shared
    reference cloud. Under 'pallas' the candidates are the lanes of one
    align_fused launch, under 'xla' of one lane program, with the reference
    as every lane's fixed cloud (the JAX package's vmap, converged lanes
    frozen, so each lane equals its solo run); a single candidate, and the
    other backends, align one candidate after the other. Then
    compute_innerproduct_lc: two or more candidates as the lanes of
    compute_innerproduct_lc_lanes on every backend (8 pair-stats launches
    a call), a single one alone (8 a candidate). The pnpransac prior is the
    identity (never assigned in the reference's active code).

    movings: a sequence of PointCloud; R0/T0/ell0/priors/lc_priors: one
    entry per candidate. Returns [(AlignResult, lc dict)] in order."""
    eye4 = np.eye(4, dtype=np.float32)
    n = len(movings)
    if n == 1:
        res = align(fixed, movings[0], R0[0], T0[0], ell0[0], p, backend)
        return [(res, compute_innerproduct_lc(
            fixed, movings[0], priors[0], lc_priors[0], eye4, res.transform,
            res.ell, p))]
    mv = stack_clouds(movings)
    if backend in ("pallas", "xla"):
        lanes = align_lanes(fixed, movings, R0, T0, ell0, p, backend, mv)
        results = [AlignResult(*(t[l] for t in lanes)) for l in range(n)]
    else:
        results = [align(fixed, moving, R0_i, T0_i, ell0_i, p, backend)
                   for moving, R0_i, T0_i, ell0_i in zip(movings, R0, T0,
                                                         ell0)]
    lcs = compute_innerproduct_lc_lanes(
        fixed, movings, priors, lc_priors, [eye4] * n,
        [r.transform for r in results], [r.ell for r in results], p, mv)
    return [(res, {k: v[l] for k, v in lcs.items()})
            for l, res in enumerate(results)]


def to_host(tree):
    """Device tensors of nested tuples / dicts -> numpy (one copy each)."""
    with spans.span("device.read"):
        return _to_host(tree)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# ---------------------------------------------------------------------------
# host-side state machine (mirrors cvo::cvo state plumbing)
# ---------------------------------------------------------------------------

@dataclass
class Cvo:
    """One CVO instance (the reference keeps two: odometry + keyframe,
    local_tracker.cpp:48-49)."""

    params: CvoParams
    fixed: Optional[PointCloud] = None
    moving: Optional[PointCloud] = None
    previous: Optional[PointCloud] = None
    fixed_pixels: Optional[np.ndarray] = None   # CVO-selected pixels of fixed
    moving_pixels: Optional[np.ndarray] = None
    previous_pixels: Optional[np.ndarray] = None
    init: bool = False
    first_frame: bool = True
    pre_pc_init: bool = False
    R: np.ndarray = None
    T: np.ndarray = None
    transform: np.ndarray = None   # (4,4) float64 host copy of the output
    ell: float = None
    iters: int = 0
    nnz: int = 0
    backend: str = "auto"   # "auto": default_backend()

    def __post_init__(self):
        self.backend = (default_backend() if self.backend == "auto"
                        else check_backend(self.backend))
        self.R = np.eye(3, dtype=np.float32)
        self.T = np.zeros(3, dtype=np.float32)
        self.transform = np.eye(4, dtype=np.float64)
        self.ell = self.params.ell_init

    # -- set_pcd (cvo.cpp:345-386): first call seeds fixed; later calls set
    #    moving. Clouds are produced once by the frontend and shared.
    def set_pcd(self, cloud: PointCloud, pixels: np.ndarray):
        if not self.init:
            self.fixed = cloud
            self.fixed_pixels = pixels
            self.init = True
            return False
        self.moving = cloud
        self.moving_pixels = pixels
        return True

    def start_ell(self) -> float:
        """ell the next alignment starts from: ell_init under the ell_reset
        policy (coarse-to-fine every alignment), else the carried state
        (reference quirk, cvo.cpp:383)."""
        return self.params.ell_init if self.params.ell_reset else self.ell

    def _align(self):
        """One align of moving against fixed from (R, T, start_ell()) under
        the instance's backend, its outputs brought to the host in one
        transfer and written back."""
        res = align(self.fixed, self.moving, self.R, self.T,
                    np.float32(self.start_ell()), self.params, self.backend)
        # f64 holds every f32 value and count exactly
        flat = torch.cat([t.reshape(-1).double() for t in res])
        with spans.span("device.read"):
            flat = flat.cpu().numpy()
        parts = np.split(flat, np.cumsum([t.numel() for t in res])[:-1])
        return self._apply_align(*(a.reshape(t.shape)
                                   for a, t in zip(parts, res)))

    def match_odometry(self, cloud: PointCloud, pixels: np.ndarray):
        """cvo.cpp:461-473: set the new cloud as moving, align it, return
        the transform."""
        if not self.init:
            raise RuntimeError("cvo not initialized: set_pcd the fixed cloud "
                               "first")
        self.set_pcd(cloud, pixels)
        return self._align()

    match_keyframe = match_odometry   # cvo.cpp:563-576 (same body)

    def _apply_align(self, R, T, transform, ell, iters, nnz):
        """Write back one alignment's host outputs."""
        self.R = np.asarray(R, np.float32)
        self.T = np.asarray(T, np.float32)
        self.transform = np.asarray(transform, np.float64)
        self.ell = float(ell)
        self.iters = int(iters)
        self.nnz = int(nnz)
        return self.transform

    def _align_with_innerproduct(self):
        """align + innerproduct; returns (transform, host ip dict)."""
        res, ip = align_and_innerproduct(self.fixed, self.moving, self.R,
                                         self.T, np.float32(self.start_ell()),
                                         self.params, self.backend)
        host_res, host_ip = to_host((tuple(res), ip))
        return self._apply_align(*host_res), host_ip

    def compute_innerproduct(self, tran: np.ndarray):
        return to_host(compute_innerproduct(
            self.fixed, self.moving, np.asarray(tran, np.float32),
            np.float32(self.ell), self.params))

    def compute_innerproduct_lc(self, prior, lc_prior, lc_prior_2, lc_tran):
        return to_host(compute_innerproduct_lc(
            self.fixed, self.moving, np.asarray(prior, np.float32),
            np.asarray(lc_prior, np.float32),
            np.asarray(lc_prior_2, np.float32),
            np.asarray(lc_tran, np.float32), np.float32(self.ell),
            self.params))

    # -- state plumbing (cvo.cpp:578-618)
    def update_fixed_pcd(self):
        self.fixed, self.fixed_pixels = self.moving, self.moving_pixels
        self.moving, self.moving_pixels = None, None

    def update_previous_pcd(self):
        self.previous, self.previous_pixels = self.moving, self.moving_pixels
        self.moving, self.moving_pixels = None, None
        self.pre_pc_init = True

    def reset_keyframe(self, odometry: np.ndarray):
        if not self.pre_pc_init:
            self.fixed, self.fixed_pixels = self.moving, self.moving_pixels
            self.moving, self.moving_pixels = None, None
        else:
            self.fixed, self.fixed_pixels = self.previous, self.previous_pixels
            self.update_previous_pcd()
        self.reset_transform(odometry)

    def reset_transform(self, odometry: np.ndarray):
        self.transform = np.asarray(odometry, np.float64).copy()

    def reset_initial(self, odometry: np.ndarray):
        """Warm start (cvo.cpp:611-618): R,T <- (transform @ odometry)^-1;
        returns the initial guess transform @ odometry."""
        guess = self.transform @ np.asarray(odometry, np.float64)
        inv = np.linalg.inv(guess)
        self.R = inv[:3, :3].astype(np.float32)
        self.T = inv[:3, 3].astype(np.float32)
        return guess
