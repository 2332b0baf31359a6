"""CVO registration engine: the align loop and the host-side state machine
(port of cvo_slam_tpu.cvo.engine).

  * `align` (cvo.cpp:763-821) carries (R, T, ell) with both stopping rules
    (flow norms < eps at :782; se3 distance < eps_2 at :804) and the ell
    anneal schedule (:810-812) on one of three backends, named as in the
    JAX package (CVO_SLAM_BACKEND, `default_backend`):
      - 'pallas_mom' (default) and 'pallas_iter': `align_loop`, a host loop
        of device iterations running the moment kernel
        (cvo.kernels.moment_flow_step) or the per-pair kernel
        (cvo.kernels.flow_and_step) once per iteration. Every state update
        is gated on `active = ~done`, so iterations run after the stop are
        no-ops: the loop reads the stop flag from the device only once per
        chunk of ALIGN_CHUNK iterations, and the iteration count is the
        same as a loop that stops at once;
      - 'pallas': the whole loop in one launch (cvo.kernels.align_fused).
  * `compute_innerproduct` runs the suite kernel (cvo.kernels.ip_suite);
    `compute_innerproduct_lc` (cvo.cpp:505-561) runs the pair-stats kernel
    (cvo.kernels.pair_stats) 6 + 2 times, and `lc_verify_batch` re-registers
    and scores each loop-closure candidate in turn.
  * the Hessian's eigenvalue floor (se3_Hessian, cvo.cpp:620-759) is
    `hessian_postprocess`.

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

from ..config import CvoParams
from ..device import resolve_device
from ..frontend.pointcloud import PointCloudHost
from ..ops import cubic, pairwise, se3
from ..ops.jacobi import eigvalsh_jacobi
from . import kernels

ALIGN_CHUNK = 4   # align iterations between two reads of the stop flag
BACKENDS = ("pallas_mom", "pallas", "pallas_iter")


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
    """A float32 tensor on `device` from a tensor or a host array / scalar."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(v, np.float32), device=device)


def default_backend() -> str:
    """The align backend named by CVO_SLAM_BACKEND, as the JAX package reads
    it: 'pallas_mom' (the moment kernel per iteration; the default),
    'pallas' (the whole align loop in one align_fused launch) or
    'pallas_iter' (one flow_and_step launch per iteration)."""
    env = os.environ.get("CVO_SLAM_BACKEND", "")
    return check_backend(env) if env else "pallas_mom"


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown align backend {backend!r}: the port runs "
            f"{', '.join(BACKENDS)} ('xla' has no counterpart on the card)")
    return backend


def align(fixed: PointCloud, moving: PointCloud, R0, T0, ell0,
          p: CvoParams, backend: str = "pallas_mom") -> AlignResult:
    """RKHS-SE(3) gradient-flow registration (cvo.cpp:763-821) on `backend`
    (see default_backend)."""
    check_backend(backend)
    dev = fixed.device
    x, fx, mx = fixed.positions, fixed.features, fixed.mask
    y0, fy, my = moving.positions, moving.features, moving.mask
    R0, T0 = _f32(R0, dev), _f32(T0, dev)
    ell0 = _f32(ell0, dev).reshape(())
    if backend == "pallas":
        R, T, ell, iters, nnz = kernels.align_fused(
            x, fx, mx, y0, fy, my, R0.contiguous(), T0.contiguous(), ell0, p)
        return AlignResult(R, T, se3.make_pose(R.T, -(R.T @ T)), ell, iters,
                           nnz)
    if backend == "pallas_iter":
        def iterate(y, ell):
            return kernels.flow_and_step(x, y, fx, fy, mx, my, ell, p)
    else:
        # the fixed cloud never moves (cvo.cpp:336), so its centred moment
        # basis is a loop constant
        center, U = pairwise.step_moment_basis(x, mx)
        U = U.contiguous()

        def iterate(y, ell):
            return kernels.moment_flow_step(x, y, fx, fy, mx, my, U, center,
                                            ell, p)
    return align_loop(iterate, y0, R0, T0, ell0, p)


def align_loop(iterate, y0, R0, T0, ell0, p: CvoParams) -> AlignResult:
    """The host align loop carrying (R, T, ell) from (R0, T0, ell0), with
    `iterate(y, ell)` -> (omega, v, nnz, B, C, D, E) the pairwise pass of
    one iteration on the transformed moving positions y."""
    dev = y0.device
    R, T = _f32(R0, dev), _f32(T0, dev)
    ell = _f32(ell0, dev).reshape(())
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.full((), p.max_iter, dtype=torch.int64, device=dev)
    nnz = torch.zeros((), dtype=torch.int32, device=dev)
    a_iters, a_vals = p.ell_anneal_iters, p.ell_anneal_values

    k = 0
    while k < p.max_iter:
        for _ in range(min(ALIGN_CHUNK, p.max_iter - k)):
            # update_tf (:106-110): transform = [R^T | -R^T T]; transform_pcd
            Rt = R.T
            Tt = -(Rt @ T)
            y = (y0 @ R + Tt[None, :]).contiguous()
            omega, v, nnz_k, B, C, D, E = iterate(y, ell)
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
            for it, val in zip(a_iters, a_vals):
                if k > it:
                    ell_ann = torch.full_like(ell, val)
            ell = torch.where(active & ~stop1 & ~stop2, ell_ann, ell)
            nnz = torch.where(active, nnz_k, nnz)
            done = done_new
            k += 1
        if bool(done):
            break
    transform = se3.make_pose(R.T, -(R.T @ T))   # final update_tf (:817)
    return AlignResult(R, T, transform, ell, iters, nnz)


# ---------------------------------------------------------------------------
# Hessian post-processing (cvo.cpp:726-755)
# ---------------------------------------------------------------------------

def hessian_postprocess(H_raw, inliers, p: CvoParams):
    """Scale by -1/1e5 then shift the spectrum until min |eigenvalue| >= 1
    (cvo.cpp:726-754); identity when no inliers.

    The eigenvalues come from the fixed-sweep Jacobi solver on the device;
    the shift loop (at most 64 steps, float32 like the device) runs on the
    six host copies."""
    H = H_raw * p.hessian_scale
    lam = eigvalsh_jacobi(H).cpu().numpy()
    total = np.float32(0.0)
    for _ in range(64):
        lam_min = lam[np.argmin(np.abs(lam))]
        if not abs(lam_min) < p.hessian_min_abs_eig:
            break
        shift = np.float32(1.0) - lam_min
        lam = lam + shift
        total = np.float32(total + shift)
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    H = H + float(total) * eye
    return torch.where(inliers > 0, H, eye)


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


def lc_verify_batch(fixed: PointCloud, movings, R0, T0, ell0, priors,
                    lc_priors, p: CvoParams, backend: str = "pallas_mom"):
    """Every loop-closure candidate verification of one detection round
    (keyframe_graph.cpp:693-714: reset_initial(lc_prior) -> set_pcd(ref) ->
    match_keyframe(cand) -> compute_innerproduct_lc), one candidate after
    the other against the shared reference cloud. The JAX package vmaps the
    candidates with converged lanes frozen, so each lane equals its solo
    run: this loop computes the same. The pnpransac prior is the identity
    (never assigned in the reference's active code).

    movings: a sequence of PointCloud; R0/T0/ell0/priors/lc_priors: one
    entry per candidate. Returns [(AlignResult, lc dict)] in order."""
    eye4 = np.eye(4, dtype=np.float32)
    out = []
    for moving, R0_i, T0_i, ell0_i, prior, lc_prior in zip(
            movings, R0, T0, ell0, priors, lc_priors):
        res = align(fixed, moving, R0_i, T0_i, ell0_i, p, backend)
        lc = compute_innerproduct_lc(fixed, moving, prior, lc_prior, eye4,
                                     res.transform, res.ell, p)
        out.append((res, lc))
    return out


def to_host(tree):
    """Device tensors of nested tuples / dicts -> numpy (one copy each)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_host(v) for v in tree)
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
