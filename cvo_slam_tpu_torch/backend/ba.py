"""Windowed bundle adjustment: poses + landmarks with Schur marginalization
(port of cvo_slam_tpu.backend.ba, single device).

Re-expression of reference bundleAdjustmentForCurrentKeyframe
(reference src/keyframe_graph.cpp:928-1243): the window spans from the
farthest covisible / loop-closure keyframe to the current one (farthest
fixed); relative-pose edges inside the window; landmark (marginalized) +
projection edges with information 100 * I2 * invLevelSigma2 (:1091);
observers outside the window join as fixed pose vertices. Two-stage
schedule: optimize 5 iterations -> prune projection outliers (unweighted
squared error > 9 or non-positive depth; erase observations, drop landmarks
observed once, :1127-1219) -> optimize OptimizationIterations -> second
prune -> write back poses, landmark positions and viewing normals
(:1221-1265).

The solver is the counterpart of g2o BlockSolver_6_3: landmark 3x3 blocks
are inverted locally and the reduced 6Vx6V camera system is either
assembled densely and solved, or solved matrix-free by block-Jacobi
preconditioned CG (large windows), with LM damping. Projection-edge
residuals and Jacobians follow EdgeSE3Projection (vertex_and_edge.cpp:15-73).
The LM schedule is backend.lm's: Nielsen damping, up to 10 trials per outer
iteration, the same convergence exit; the host reads the stop flags once
per outer iteration, and the CG loop once per CG_CHUNK iterations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CameraConfig, SlamConfig
from ..device import resolve_device
from ..ops import se3
from ..tracking.types import Keyframe
from . import lm
from .keyframe_graph import ID_INTERVAL

CG_CHUNK = 8   # CG iterations between two reads of the stop flag


def proj_terms(E, L, p_kf, p_lm, p_meas, K):
    """Per projection edge: residual e (M,2), J_pose (M,2,6), J_point
    (M,2,3), camera-frame depth z (M,), unweighted squared error (M,)."""
    Ei = E[p_kf]                                   # (M,4,4) inverse poses
    P = (Ei[:, :3, :3] @ L[p_lm][..., None])[..., 0] + Ei[:, :3, 3]
    z = P[:, 2]
    zs = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                      float(K[1, 2]))
    u = fx * P[:, 0] / zs + cx
    v = fy * P[:, 1] / zs + cy
    e = p_meas - torch.stack([u, v], 1)
    m = P.shape[0]
    A = P.new_zeros((m, 2, 3))
    A[:, 0, 0] = fx
    A[:, 0, 2] = -(fx * P[:, 0]) / zs
    A[:, 1, 1] = fy
    A[:, 1, 2] = -(fy * P[:, 1]) / zs
    B = P.new_zeros((m, 3, 6))
    B[:, 0, 1] = P[:, 2]
    B[:, 0, 2] = -P[:, 1]
    B[:, 1, 0] = -P[:, 2]
    B[:, 1, 2] = P[:, 0]
    B[:, 2, 0] = P[:, 1]
    B[:, 2, 1] = -P[:, 0]
    B[:, :, 3:] = torch.eye(3, dtype=P.dtype, device=P.device)
    scale = (-1.0 / zs)[:, None, None]
    Jp = scale * (A @ B)                           # d e / d pose twist
    Jl = scale * (A @ Ei[:, :3, :3])               # d e / d landmark
    return e, Jp, Jl, z, (e * e).sum(1)


def _masked_sum(mask, v):
    return torch.where(mask, v, torch.zeros_like(v)).sum()


class _Problem:
    """One windowed-BA problem on the device (the arguments of
    optimize_ba), with the LM's linearization, chi2 and damped solve."""

    def __init__(self, free_pose, lm_mask, ei, ej, Z, omega, pemask, p_kf,
                 p_lm, p_meas, p_w, p_mask, K, delta: float, solver: str):
        self.ei, self.ej, self.Z, self.omega = ei[None], ej[None], Z[None], \
            omega[None]
        self.pemask = pemask
        self.p_kf, self.p_lm, self.p_meas = p_kf, p_lm, p_meas
        self.p_w, self.p_mask, self.K = p_w, p_mask, K
        self.delta = delta
        self.solver = solver
        self.fp = free_pose.to(torch.float32)
        self.fl = lm_mask.to(torch.float32)

    def _pose_terms(self, E):
        e, Ji, Jj, chi2 = lm.edge_terms(E[None], self.ei, self.ej, self.Z,
                                        self.omega)
        w, rchi2 = lm.robust(chi2[0], self.delta)
        w = torch.where(self.pemask, w, torch.zeros_like(w))
        return e, Ji, Jj, w, _masked_sum(self.pemask, rchi2)

    def _proj_weights(self, err2):
        c = self.p_w * err2
        rw, rc = lm.robust(c, self.delta)
        return torch.where(self.p_mask, self.p_w * rw, torch.zeros_like(c)), \
            _masked_sum(self.p_mask, rc)

    def total_chi2(self, E, L):
        chi2_pose = self._pose_terms(E)[4]
        err2 = proj_terms(E, L, self.p_kf, self.p_lm, self.p_meas, self.K)[4]
        return chi2_pose + self._proj_weights(err2)[1]

    def normal_eq(self, E, L):
        V, NL = E.shape[0], L.shape[0]
        e_pose, Ji, Jj, wpe, chi2_pose = self._pose_terms(E)
        Hpp = E.new_zeros((1, V, V, 6, 6))
        bp = E.new_zeros((1, V, 6))
        lm.scatter_blocks(Hpp, bp, self.ei, self.ej, Ji, Jj,
                          wpe[None, :, None, None] * self.omega, e_pose)
        Hpp, bp = Hpp[0], bp[0]

        e, Jp, Jl, _, err2 = proj_terms(E, L, self.p_kf, self.p_lm,
                                        self.p_meas, self.K)
        wt, chi2_proj = self._proj_weights(err2)
        JpW = wt[:, None, None] * Jp.transpose(-1, -2)        # (M,6,2)
        JlW = wt[:, None, None] * Jl.transpose(-1, -2)        # (M,3,2)
        Hpp.index_put_((self.p_kf, self.p_kf), JpW @ Jp, accumulate=True)
        bp.index_put_((self.p_kf,), -(JpW @ e[..., None])[..., 0],
                      accumulate=True)
        Hll = E.new_zeros((NL, 3, 3))
        Hll.index_put_((self.p_lm,), JlW @ Jl, accumulate=True)
        bl = E.new_zeros((NL, 3))
        bl.index_put_((self.p_lm,), -(JlW @ e[..., None])[..., 0],
                      accumulate=True)
        Hpl = E.new_zeros((V, NL, 6, 3))
        Hpl.index_put_((self.p_kf, self.p_lm), JpW @ Jl, accumulate=True)
        return Hpp, Hpl, Hll, bp, bl, chi2_pose + chi2_proj

    def _pcg(self, Hpp, Hpl, HplHinv, rhs, lam):
        """Matrix-free damped Schur solve on the free-pose subspace with a
        block-Jacobi preconditioner; stops at |r|^2 <= 1e-10 |rhs|^2 or 6V
        iterations. Iterations after the stop are masked no-ops."""
        fp = self.fp
        V = rhs.shape[0]
        eye6 = torch.eye(6, dtype=rhs.dtype, device=rhs.device)

        def matvec(xv):
            xt = xv * fp[:, None]
            g1 = torch.einsum("vlac,va->lc", Hpl, xt)
            corr = torch.einsum("vlac,lc->va", HplHinv, g1)
            Sx = torch.einsum("vuab,ub->va", Hpp, xt) + lam * xt - corr
            return Sx * fp[:, None] + xv * (1.0 - fp)[:, None]

        diag_corr = torch.einsum("vlac,vlec->vae", HplHinv, Hpl)
        Dv = torch.diagonal(Hpp, dim1=0, dim2=1).permute(2, 0, 1) \
            + lam * eye6 - diag_corr
        Dv = torch.where(fp[:, None, None] > 0, Dv, eye6)
        Dinv = torch.nan_to_num(torch.linalg.inv_ex(Dv)[0])

        def prec(r):
            return torch.einsum("vab,vb->va", Dinv, r)

        tol2 = 1e-10 * torch.clamp((rhs * rhs).sum(), min=1e-30)
        xv = torch.zeros_like(rhs)
        r = rhs
        z = prec(r)
        pv = z
        rz = (r * z).sum()
        active = (r * r).sum() > tol2
        k = 0
        while k < 6 * V:
            for _ in range(min(CG_CHUNK, 6 * V - k)):
                Ap = matvec(pv)
                alpha = rz / torch.clamp((pv * Ap).sum(), min=1e-30)
                x_n = xv + alpha * pv
                r_n = r - alpha * Ap
                z_n = prec(r_n)
                rz_n = (r_n * z_n).sum()
                beta = rz_n / torch.clamp(rz, min=1e-30)
                p_n = z_n + beta * pv
                xv = torch.where(active, x_n, xv)
                r = torch.where(active, r_n, r)
                pv = torch.where(active, p_n, pv)
                rz = torch.where(active, rz_n, rz)
                k += 1
                active = active & ((r * r).sum() > tol2)
            if not bool(active):
                break
        return xv

    def solve(self, Hpp, Hpl, Hll, bp, bl, lam):
        """Damped Schur solve: (dx_pose (V,6), dx_landmark (NL,3))."""
        fp, fl = self.fp, self.fl
        V = bp.shape[0]
        eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
        eye6 = torch.eye(6, dtype=Hll.dtype, device=Hll.device)
        # damp diagonals (g2o adds lambda to every diagonal element); pin
        # invalid landmarks
        Hll_d = torch.where(fl[:, None, None] > 0, Hll + lam * eye3, eye3)
        Hll_inv = torch.linalg.inv_ex(Hll_d)[0]
        bl_m = bl * fl[:, None]
        HplHinv = torch.einsum("vlab,lbc->vlac", Hpl, Hll_inv)
        rhs = (bp - torch.einsum("vlac,lc->va", HplHinv, bl_m)) * fp[:, None]
        if self.solver == "pcg":
            dxp = self._pcg(Hpp, Hpl, HplHinv, rhs, lam)
        else:
            # S = Hpp - Hpl Hll^-1 Hlp, damped + pinned, dense solve
            S = Hpp - torch.einsum("vlac,ulec->vuae", HplHinv, Hpl)
            diag = torch.arange(V, device=S.device)
            S[diag, diag] += lam * eye6
            S = S * fp[:, None, None, None] * fp[None, :, None, None]
            S[diag, diag] += (1.0 - fp)[:, None, None] * eye6
            Sd = S.permute(0, 2, 1, 3).reshape(V * 6, V * 6)
            dxp = torch.linalg.solve_ex(Sd, rhs.reshape(-1, 1))[0]
            dxp = dxp.reshape(V, 6)
        dxp = torch.nan_to_num(dxp) * fp[:, None]
        # back-substitute landmarks
        dxl = torch.einsum("lbc,lc->lb", Hll_inv,
                           bl_m - torch.einsum("vlab,va->lb", Hpl, dxp))
        return dxp, torch.nan_to_num(dxl) * fl[:, None]


def optimize_ba(E0, L0, free_pose, lm_mask, ei, ej, Z, omega, pemask,
                p_kf, p_lm, p_meas, p_w, p_mask, K, iterations: int,
                robust_delta: float, solver: str = "dense"):
    """Schur-complement LM over poses (E = inverse poses) + landmarks.

    solver='dense' assembles the reduced camera system S = Hpp - Hpl Hll^-1
    Hlp densely and solves it; solver='pcg' solves it matrix-free with a
    block-Jacobi preconditioner (the dense assembly is O(V^2 L)). Every
    argument is a tensor on one device; K is (3,3). Returns (E_opt, L_opt).
    """
    prob = _Problem(free_pose, lm_mask, ei, ej, Z, omega, pemask, p_kf,
                    p_lm, p_meas, p_w, p_mask, K, float(robust_delta), solver)
    E, L = E0, L0
    dev, dt = E.device, E.dtype
    lam = torch.full((), -1.0, dtype=dt, device=dev)
    ni = torch.full((), 2.0, dtype=dt, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iterations):
        active = ~conv
        Hpp, Hpl, Hll, bp, bl, chi2 = prob.normal_eq(E, L)
        diag_max = torch.maximum(
            torch.diagonal(torch.diagonal(Hpp, dim1=0, dim2=1), dim1=0,
                           dim2=1).abs().max(),
            torch.diagonal(Hll, dim1=-2, dim2=-1).abs().max())
        lam = torch.where(lam < 0, 1e-5 * diag_max, lam)
        E_cur, L_cur, lam_t, ni_t, chi2_cur = E, L, lam, ni, chi2
        done = torch.zeros((), dtype=torch.bool, device=dev)

        def trial():
            nonlocal E_cur, L_cur, lam_t, ni_t, chi2_cur, done
            dxp, dxl = prob.solve(Hpp, Hpl, Hll, bp, bl, lam_t)
            E_try = se3.exp_se3(dxp) @ E
            L_try = L + dxl
            chi2_new = prob.total_chi2(E_try, L_try)
            scale = (dxp * (lam_t * dxp + bp)).sum() \
                + (dxl * (lam_t * dxl + bl)).sum() + 1e-3
            rho = (chi2 - chi2_new) / scale
            accept = (rho > 0) & torch.isfinite(chi2_new)
            go = ~done                    # trials stop at the first accept
            lam_n, ni_n = lm.lm_update(lam_t, ni_t, rho, accept)
            E_cur = torch.where(go & accept, E_try, E_cur)
            L_cur = torch.where(go & accept, L_try, L_cur)
            chi2_cur = torch.where(go & accept, chi2_new, chi2_cur)
            lam_t = torch.where(go, lam_n, lam_t)
            ni_t = torch.where(go, ni_n, ni_t)
            done = done | (go & accept)

        trial()
        gain_small = chi2 - chi2_cur <= 1e-9 * chi2
        flags = torch.stack([done | conv, conv | (active & gain_small)])
        all_done, all_conv = flags.tolist()          # the one host read
        if not all_done:
            for _ in range(lm.N_TRIALS - 1):
                trial()
        conv_new = ~done | (chi2 - chi2_cur <= 1e-9 * chi2)
        E = torch.where(active, E_cur, E)
        L = torch.where(active, L_cur, L)
        lam = torch.where(active, lam_t, lam)
        ni = torch.where(active, ni_t, ni)
        conv = conv | (active & conv_new)
        if all_done and all_conv:
            break
    return E, L


def projection_errors(E, L, p_kf, p_lm, p_meas, K):
    """Unweighted squared reprojection errors + camera-frame depth per edge
    (for the g2o-style pruning gates)."""
    _, _, _, z, err2 = proj_terms(E, L, p_kf, p_lm, p_meas, K)
    return err2, z


def _pad_bucket(n, base=8):
    b = base
    while b < n:
        b *= 2
    return b


# Windowed-BA capacity classes (cap_v, cap_l, cap_pe, cap_pr), as the JAX
# package's: bounds from the reference's own caps (<= 500 landmarks per
# keyframe, ORBmatcher.cpp:1166, x a top-10+1 covisibility window,
# :2229-2246). The class decides the padded problem and the solver
# (PCG from 96 pose slots on).
_SIZE_CLASSES = (
    dict(v=16, l=512, pe=64, pr=2048),
    dict(v=64, l=2048, pe=256, pr=8192),
    dict(v=96, l=4096, pe=512, pr=12288),
    dict(v=192, l=6144, pe=1024, pr=24576),
)


def _select_caps(n_v, n_l, n_pe, n_pr):
    for c in _SIZE_CLASSES:
        if (n_v <= c["v"] and n_l <= c["l"] and n_pe <= c["pe"]
                and n_pr <= c["pr"]):
            return c["v"], c["l"], c["pe"], c["pr"]
    # beyond the largest class: per-dimension power-of-two padding
    return (max(_pad_bucket(n_v), 16), max(_pad_bucket(n_l), 512),
            max(_pad_bucket(n_pe), 64), max(_pad_bucket(n_pr), 2048))


def make_windowed_ba(cam: CameraConfig, cfg: SlamConfig, device="cuda"):
    """Windowed-BA closure (keyframe_graph.cpp:928-1243) solving on
    `device`."""
    dev = resolve_device(device)
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)

    def windowed_ba(graph, reference: Keyframe, farthest_lc: int):
        covis = sorted(set(reference.best_covisible))
        window_src = set(covis)
        if window_src:
            window_src.add(reference.id)
        farthest = min(min(window_src), farthest_lc) if window_src \
            else farthest_lc
        if farthest == reference.id:
            return
        kf_by_id = {kf.id: kf for kf in graph.keyframes()}

        movable = list(range(farthest + ID_INTERVAL, reference.id + 1,
                             ID_INTERVAL))
        vert_ids = [farthest] + movable
        fixed_ids = {farthest}

        # landmarks observed by covisible keyframes (+ reference)
        lm_ids = []
        seen = set()
        for kid in sorted(window_src):
            for mp_id in kf_by_id[kid].mappoints_id.values():
                if mp_id not in seen:
                    seen.add(mp_id)
                    lm_ids.append(mp_id)
        # extra fixed observers outside the window
        proj = []   # (kf_id, lm_idx, meas_xy, weight, mp_id, kp_idx)
        for li, mp_id in enumerate(lm_ids):
            mp = graph.map_points[mp_id]
            for kf_id, kp_idx in mp.keypoints_id.items():
                kf = kf_by_id[kf_id]
                if kf_id < farthest and kf_id not in fixed_ids \
                        and kf_id not in vert_ids:
                    vert_ids.append(kf_id)
                    fixed_ids.add(kf_id)
                kp = kf.keypoints[kp_idx]
                w = 100.0 * graph.matcher.inv_level_sigma2[int(kp[2])]
                proj.append((kf_id, li, (float(kp[0]), float(kp[1])), w,
                             mp_id, kp_idx))

        vid_to_idx = {vid: i for i, vid in enumerate(vert_ids)}
        n_v = len(vert_ids)
        n_l = len(lm_ids)
        pose_edges = [e for e in graph.edges
                      if e.from_id >= farthest and e.to_id >= farthest]
        cap_v, cap_l, cap_pe, cap_pr = _select_caps(
            n_v, n_l, len(pose_edges), len(proj))
        if not hasattr(graph, "wba_sizes"):
            graph.wba_sizes = []
        graph.wba_sizes.append((n_v, n_l, len(pose_edges), len(proj),
                                cap_v, cap_l, cap_pe, cap_pr))

        E = np.tile(np.eye(4, dtype=np.float32), (cap_v, 1, 1))
        for i, vid in enumerate(vert_ids):
            E[i] = np.linalg.inv(kf_by_id[vid].pose)
        L = np.zeros((cap_l, 3), np.float32)
        for i, mid in enumerate(lm_ids):
            L[i] = graph.map_points[mid].position
        free_pose = np.zeros(cap_v, bool)
        for i, vid in enumerate(vert_ids):
            free_pose[i] = vid not in fixed_ids
        lm_mask = np.arange(cap_l) < n_l

        ei = np.zeros(cap_pe, np.int64)
        ej = np.zeros(cap_pe, np.int64)
        Z = np.tile(np.eye(4, dtype=np.float32), (cap_pe, 1, 1))
        om = np.tile(np.eye(6, dtype=np.float32), (cap_pe, 1, 1))
        for i, e in enumerate(pose_edges):
            ei[i] = vid_to_idx[e.from_id]
            ej[i] = vid_to_idx[e.to_id]
            Z[i] = e.result.transform
            om[i] = e.result.information
        pemask = np.arange(cap_pe) < len(pose_edges)

        p_kf = np.zeros(cap_pr, np.int64)
        p_lm = np.zeros(cap_pr, np.int64)
        p_meas = np.zeros((cap_pr, 2), np.float32)
        p_w = np.zeros(cap_pr, np.float32)
        p_mask = np.zeros(cap_pr, bool)
        for i, (kf_id, li, meas, w, _, _) in enumerate(proj):
            p_kf[i] = vid_to_idx[kf_id]
            p_lm[i] = li
            p_meas[i] = meas
            p_w[i] = w
            p_mask[i] = True

        delta = cfg.RobustKernelDelta if cfg.UseRobustKernel else 0.0
        args = [torch.as_tensor(a).to(dev) for a in
                (E, L, free_pose, lm_mask, ei, ej, Z, om, pemask,
                 p_kf, p_lm, p_meas, p_w, p_mask)]

        def prune(E_cur, L_cur):
            err2, z = projection_errors(E_cur, L_cur, args[9], args[10],
                                        args[11], Kt)
            err2 = err2[:len(proj)].cpu().numpy()
            z = z[:len(proj)].cpu().numpy()
            # the reference's per-edge outlier gate (keyframe_graph.cpp:
            # 1127-1167); host bookkeeping in ascending edge order
            bad = p_mask[:len(proj)] & ((err2 > 9.0) | (z <= 0))
            for i in np.flatnonzero(bad):
                p_mask[i] = False
                kf_id, li, _, _, mp_id, kp_idx = proj[i]
                mp = graph.map_points[mp_id]
                kp = mp.erase_observation(kf_id)
                kf_by_id[kf_id].mappoints_id.pop(kp, None)
                if len(mp.keypoints_id) == 1:
                    only_kf, only_kp = next(iter(mp.keypoints_id.items()))
                    mp.erase_observation(only_kf)
                    kf_by_id[only_kf].mappoints_id.pop(only_kp, None)
            args[13] = torch.as_tensor(p_mask).to(dev)
            return int(bad.sum())

        # big windows use the matrix-free PCG Schur solve (the dense S
        # assembly is O(V^2 L))
        ba_solver = "pcg" if cap_v >= 96 else "dense"

        # stage 1: 5 iterations, prune, then the full run + second prune;
        # both prunes gated on OptimizationRemoveOutliers (default True =
        # the reference, which prunes unconditionally)
        E1, L1 = optimize_ba(*args, Kt, 5, delta, solver=ba_solver)
        args[0], args[1] = E1, L1
        if cfg.OptimizationRemoveOutliers:
            prune(E1, L1)
        E2, L2 = optimize_ba(*args, Kt, cfg.OptimizationIterations, delta,
                             solver=ba_solver)
        args[0], args[1] = E2, L2
        if cfg.OptimizationRemoveOutliers:
            prune(E2, L2)

        E2 = E2.cpu().numpy().astype(np.float64)
        L2 = L2.cpu().numpy().astype(np.float64)
        for i, vid in enumerate(vert_ids):
            if vid in fixed_ids:
                continue
            kf_by_id[vid].pose = np.linalg.inv(E2[i])
        for i, mid in enumerate(lm_ids):
            mp = graph.map_points[mid]
            mp.position = L2[i]
            _update_normal(mp, kf_by_id)

    return windowed_ba


def _update_normal(mp, kf_by_id):
    """UpdateMapPointNormal (keyframe_graph.cpp:1246-1264)."""
    if not mp.keypoints_id:
        return
    normal = np.zeros(3)
    for kf_id in mp.keypoints_id:
        center = kf_by_id[kf_id].pose[:3, 3]
        d = mp.position - center
        n = np.linalg.norm(d)
        if n > 0:
            normal += d / n
    n = np.linalg.norm(normal)
    if n > 0:
        mp.normal = normal / n
