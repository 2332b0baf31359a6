"""Levenberg-Marquardt pose-graph solver, batched over a leading axis
(port of cvo_slam_tpu.backend.lm).

Re-expression of the reference solver stack: g2o BlockSolver_6_3 +
LinearSolverEigen + OptimizationAlgorithmLevenberg (reference
src/local_map.cpp:85-92) with the custom SE(3) types of
src/vertex_and_edge.{h,cpp}:

  * vertices store INVERSE poses E = pose^{-1}; the update is
    left-multiplicative E <- exp(delta) E.
  * relative-pose edge error e = log(Z^{-1} E_i E_j^{-1}) with the
    closed-form Jacobians J_i = Jl^{-1}(e) Ad(Z^{-1}),
    J_j = -Jl^{-1}(e) Ad(err) (vertex_and_edge.cpp:79-86, :181-182).
  * Cauchy robust kernel with delta: weight 1/(1 + s/delta^2), robust
    chi2 = delta^2 log(1 + s/delta^2).
  * LM damping as g2o: lambda_0 = 1e-5 max diag(H); Nielsen update, up to
    10 trials per outer iteration; an outer iteration whose 10 trials all
    reject, or whose relative chi2 gain is <= 1e-9, ends the lane.

Every lane of a batch runs the solo algorithm: a lane's state is frozen by
masks once it converges (the JAX package's cond-under-vmap), so a batched
call equals its per-lane solo calls. The host reads one pair of flags per
outer iteration, after the first damping trial: whether every lane has
accepted (then the other nine trials are skipped) and whether every lane
has then converged (then the loop ends).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import arrays_from_reference
from ..ops import se3

N_TRIALS = 10


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph, optionally with a leading batch axis.
    Invalid slots must be masked out."""
    E: torch.Tensor        # ([B,] V, 4, 4) inverse-pose estimates
    fixed: torch.Tensor    # ([B,] V) bool, held constant
    vmask: torch.Tensor    # ([B,] V) bool, slot is a real vertex
    ei: torch.Tensor       # ([B,] M) int64 edge endpoints (from)
    ej: torch.Tensor       # ([B,] M) int64 edge endpoints (to)
    Z: torch.Tensor        # ([B,] M, 4, 4) measurements
    omega: torch.Tensor    # ([B,] M, 6, 6) information matrices
    emask: torch.Tensor    # ([B,] M) bool


def pose_graph(E, fixed, vmask, ei, ej, Z, omega, emask,
               device="cuda") -> PoseGraph:
    """A PoseGraph on `device` from host arrays (float32 / bool / int64)."""
    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return PoseGraph(t(E, torch.float32), t(fixed, torch.bool),
                     t(vmask, torch.bool), t(ei, torch.int64),
                     t(ej, torch.int64), t(Z, torch.float32),
                     t(omega, torch.float32), t(emask, torch.bool))


def pose_graph_from_reference(g, device="cuda") -> PoseGraph:
    """The port's PoseGraph from the JAX package's (cvo_slam_tpu.backend.
    lm.PoseGraph, or any tuple with the same fields), read through
    config.arrays_from_reference."""
    return pose_graph(**arrays_from_reference(g), device=device)


def _gather(x, idx):
    """x (B, V, ...), idx (B, M) -> (B, M, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def edge_terms(E, ei, ej, Z, omega):
    """Per-edge error e (B,M,6), Jacobians Ji, Jj (B,M,6,6), chi2 (B,M)."""
    Zinv = se3.inv_pose(Z)
    err_T = Zinv @ _gather(E, ei) @ se3.inv_pose(_gather(E, ej))
    e = se3.log_se3(err_T)
    Jl_inv = se3.left_jacobian_inv_se3(e)
    Ji = Jl_inv @ se3.adjoint_se3(Zinv)
    Jj = -Jl_inv @ se3.adjoint_se3(err_T)
    chi2 = torch.einsum("bmi,bmij,bmj->bm", e, omega, e)
    return e, Ji, Jj, chi2


def robust(chi2, delta: float):
    """(weight, robust chi2) of the Cauchy kernel; delta <= 0 disables it."""
    if delta <= 0.0:
        return torch.ones_like(chi2), chi2
    d2 = delta * delta
    aux = chi2 / d2
    return 1.0 / (1.0 + aux), d2 * torch.log1p(aux)


def _total_chi2(E, g: PoseGraph, delta: float):
    _, _, _, chi2 = edge_terms(E, g.ei, g.ej, g.Z, g.omega)
    _, rchi2 = robust(chi2, delta)
    return torch.where(g.emask, rchi2, torch.zeros_like(rchi2)).sum(-1)


def scatter_blocks(H, b, ei, ej, Ji, Jj, W, e):
    """Add the relative-pose edges' blocks J^T W J into H (B,V,V,6,6) and
    -J^T W e into b (B,V,6), in place."""
    bidx = torch.arange(H.shape[0], device=H.device)[:, None].expand_as(ei)
    JiW = Ji.transpose(-1, -2) @ W
    JjW = Jj.transpose(-1, -2) @ W
    Hij = JiW @ Jj
    H.index_put_((bidx, ei, ei), JiW @ Ji, accumulate=True)
    H.index_put_((bidx, ei, ej), Hij, accumulate=True)
    H.index_put_((bidx, ej, ei), Hij.transpose(-1, -2), accumulate=True)
    H.index_put_((bidx, ej, ej), JjW @ Jj, accumulate=True)
    b.index_put_((bidx, ei), -(JiW @ e[..., None])[..., 0], accumulate=True)
    b.index_put_((bidx, ej), -(JjW @ e[..., None])[..., 0], accumulate=True)


def _normal_equations(E, g: PoseGraph, delta: float):
    """Dense (B,6V,6V) H and (B,6V) b with fixed / invalid rows pinned, and
    the robust chi2 (B,)."""
    B, V = E.shape[:2]
    e, Ji, Jj, chi2 = edge_terms(E, g.ei, g.ej, g.Z, g.omega)
    w, rchi2 = robust(chi2, delta)
    w = torch.where(g.emask, w, torch.zeros_like(w))
    H = torch.zeros((B, V, V, 6, 6), dtype=E.dtype, device=E.device)
    b = torch.zeros((B, V, 6), dtype=E.dtype, device=E.device)
    scatter_blocks(H, b, g.ei, g.ej, Ji, Jj, w[..., None, None] * g.omega, e)
    # pin fixed / invalid vertices: zero their rows and columns, identity
    # diagonal block
    fm = (g.vmask & ~g.fixed).to(E.dtype)
    H = H * fm[:, :, None, None, None] * fm[:, None, :, None, None]
    eye6 = torch.eye(6, dtype=E.dtype, device=E.device)
    diag = torch.arange(V, device=E.device)
    H[:, diag, diag] += (1.0 - fm)[..., None, None] * eye6
    b = b * fm[..., None]
    Hd = H.permute(0, 1, 3, 2, 4).reshape(B, V * 6, V * 6)
    chi2_tot = torch.where(g.emask, rchi2, torch.zeros_like(rchi2)).sum(-1)
    return Hd, b.reshape(B, -1), chi2_tot


def lm_update(lam, ni, rho, accept):
    """Nielsen damping update: (lam, ni) after an accepted or rejected
    trial."""
    lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    return (torch.where(accept, lam_acc, lam * ni),
            torch.where(accept, torch.full_like(ni, 2.0), ni * 2.0))


def optimize(g: PoseGraph, iterations: int, robust_delta: float = 0.0):
    """Run up to `iterations` LM outer iterations. Returns (E_opt,
    final_chi2); with a leading batch axis on every field of `g`, both
    outputs carry it too."""
    solo = g.E.dim() == 3
    if solo:
        g = PoseGraph(*(t[None] for t in g))
    E = g.E
    B, V = E.shape[:2]
    dev, dt = E.device, E.dtype
    delta = float(robust_delta)
    free = (g.vmask & ~g.fixed).to(dt)
    eye = torch.eye(V * 6, dtype=dt, device=dev)

    lam = torch.full((B,), -1.0, dtype=dt, device=dev)
    ni = torch.full((B,), 2.0, dtype=dt, device=dev)
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(iterations):
        active = ~conv
        H, b, chi2 = _normal_equations(E, g, delta)
        lam = torch.where(lam < 0, 1e-5 * H.diagonal(dim1=-2, dim2=-1)
                          .amax(-1), lam)
        E_cur, lam_t, ni_t = E, lam, ni
        chi2_cur = chi2
        done = torch.zeros(B, dtype=torch.bool, device=dev)

        def trial():
            nonlocal E_cur, lam_t, ni_t, chi2_cur, done
            dx = torch.linalg.solve_ex(H + lam_t[:, None, None] * eye,
                                       b[..., None])[0][..., 0]
            dx = torch.nan_to_num(dx)
            E_try = se3.exp_se3(dx.reshape(B, V, 6) * free[..., None]) @ E
            chi2_new = _total_chi2(E_try, g, delta)
            scale = (dx * (lam_t[:, None] * dx + b)).sum(-1) + 1e-3
            rho = (chi2 - chi2_new) / scale
            accept = (rho > 0) & torch.isfinite(chi2_new)
            go = ~done                    # a lane stops at its first accept
            lam_n, ni_n = lm_update(lam_t, ni_t, rho, accept)
            E_cur = torch.where((go & accept)[:, None, None, None], E_try,
                                E_cur)
            chi2_cur = torch.where(go & accept, chi2_new, chi2_cur)
            lam_t = torch.where(go, lam_n, lam_t)
            ni_t = torch.where(go, ni_n, ni_t)
            done = done | (go & accept)

        trial()
        gain_small = chi2 - chi2_cur <= 1e-9 * chi2
        conv_if_done = conv | (active & gain_small)
        flags = torch.stack([(done | conv).all(), conv_if_done.all()])
        all_done, all_conv = flags.tolist()          # the one host read
        if not all_done:
            for _ in range(N_TRIALS - 1):
                trial()
        conv_new = ~done | (chi2 - chi2_cur <= 1e-9 * chi2)
        E = torch.where(active[:, None, None, None], E_cur, E)
        lam = torch.where(active, lam_t, lam)
        ni = torch.where(active, ni_t, ni)
        conv = conv | (active & conv_new)
        if all_done and all_conv:
            break
    chi2_final = _total_chi2(E, g, delta)
    if solo:
        return E[0], chi2_final[0]
    return E, chi2_final


def chi2(g: PoseGraph, robust_delta: float = 0.0):
    if g.E.dim() == 3:
        return _total_chi2(g.E[None], PoseGraph(*(t[None] for t in g)),
                           float(robust_delta))[0]
    return _total_chi2(g.E, g, float(robust_delta))
