"""Windowed bundle adjustment in plain torch, in any float type: the cost
the reference's windowed BA gives g2o (keyframe_graph.cpp:928-1243) and
its minimum by Levenberg-Marquardt on a dense Jacobian, with none of the
port's Schur complement, block structure or preconditioned solve.

The variables are the inverse poses E of the window's keyframes (those not
held fixed, updated as exp(d) E) and the landmark positions L (updated as
L + d). The cost is

  sum over pose edges    rho(e^T Omega e),  e = Log(Z^-1 E_i E_j^-1)
  sum over projections   rho(w |m - pi(K, E_k L_l)|^2)

with Log the SE(3) logarithm in [w, v] order and rho the Cauchy kernel
d^2 log(1 + c / d^2) (delta 0: no kernel). A problem is the port's
optimize_ba arguments as host arrays.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch


def _skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_se3(xi):
    """(..., 6) [w, v] -> (..., 4, 4); series below 1e-6 rad, so that its
    derivatives stay finite at 0."""
    w, v = xi[..., :3], xi[..., 3:]
    th2 = torch.sum(w * w, -1)[..., None, None]
    big = th2 > 1e-12
    th2s = torch.where(big, th2, torch.ones_like(th2))
    th = torch.sqrt(th2s)
    A = _skew(w)
    A2 = A @ A
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(A.shape)
    a = torch.where(big, torch.sin(th) / th, 1.0 - th2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(th)) / th2s, 0.5 - th2 / 24.0)
    c = torch.where(big, (th - torch.sin(th)) / (th2s * th),
                    1.0 / 6.0 - th2 / 120.0)
    R = eye + a * A + b * A2
    J = eye + b * A + c * A2
    return _pose(R, (J @ v[..., None])[..., 0])


def _pose(R, t):
    """(..., 4, 4) from R (..., 3, 3) and t (..., 3), out of place."""
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., :1])],
                       -1)
    return torch.cat([top, bottom], -2)


def log_se3(T):
    """(..., 4, 4) -> (..., 6) [w, v]; series below 1e-6 rad."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    vec = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                             R[..., 0, 2] - R[..., 2, 0],
                             R[..., 1, 0] - R[..., 0, 1]], -1)
    s2 = torch.sum(vec * vec, -1)
    big = s2 > 1e-12
    sn = torch.sqrt(torch.where(big, s2, torch.ones_like(s2)))
    th = torch.atan2(sn, c)
    factor = torch.where(big, th / sn, 1.0 + s2 / 6.0)
    w = factor[..., None] * vec
    th2 = torch.where(big, th * th, torch.ones_like(th))
    coef = torch.where(big, 1.0 / th2 - (1.0 + torch.cos(th))
                       / (2.0 * th * sn), 1.0 / 12.0 + s2 / 720.0)
    A = _skew(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(A.shape)
    v = ((eye - 0.5 * A + coef[..., None, None] * (A @ A))
         @ t[..., None])[..., 0]
    return torch.cat([w, v], -1)


def _inv(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _pose(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


class Problem:
    """One windowed-BA problem (the port's optimize_ba arguments)."""

    def __init__(self, a: dict, dtype, device):
        def t(k, dt=dtype):
            return torch.as_tensor(a[k], device=device).to(dt)
        self.dtype = dtype
        self.E0, self.L0 = t("E"), t("L")
        self.free = torch.as_tensor(a["free_pose"], device=device)
        self.lm = torch.as_tensor(a["lm_mask"], device=device)
        pe = torch.as_tensor(a["pemask"], device=device)
        self.ei = torch.as_tensor(a["ei"], device=device)[pe]
        self.ej = torch.as_tensor(a["ej"], device=device)[pe]
        self.Z = t("Z")[pe]
        om = torch.as_tensor(a["omega"], device=device).double()[pe]
        # Omega = S^T S for the weighted residual S e
        evals, evecs = torch.linalg.eigh(0.5 * (om + om.transpose(-1, -2)))
        self.S = (evecs * torch.sqrt(torch.clamp(evals, min=0.0))[..., None, :]
                  ).transpose(-1, -2).to(dtype)
        pm = torch.as_tensor(a["p_mask"], device=device)
        self.p_kf = torch.as_tensor(a["p_kf"], device=device)[pm]
        self.p_lm = torch.as_tensor(a["p_lm"], device=device)[pm]
        self.meas = t("p_meas")[pm]
        self.sw = torch.sqrt(t("p_w")[pm])
        K = np.asarray(a["K"], np.float64)
        self.fx, self.fy, self.cx, self.cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        self.delta = float(a["delta"])
        self.free_idx = torch.nonzero(self.free)[:, 0]
        self.lm_idx = torch.nonzero(self.lm)[:, 0]
        self.n = 6 * len(self.free_idx) + 3 * len(self.lm_idx)

    def apply(self, E, L, d):
        nf = len(self.free_idx)
        dp = d[:6 * nf].reshape(nf, 6)
        dl = d[6 * nf:].reshape(-1, 3)
        E = E.index_put((self.free_idx,), exp_se3(dp) @ E[self.free_idx])
        L = L.index_put((self.lm_idx,), L[self.lm_idx] + dl)
        return E, L

    def residuals(self, E, L):
        """(pose residuals (P, 6) weighted by S, projection residuals
        (M, 2) weighted by sqrt(w))."""
        err = _inv(self.Z) @ E[self.ei] @ _inv(E[self.ej])
        rp = (self.S @ log_se3(err)[..., None])[..., 0]
        Ek = E[self.p_kf]
        P = (Ek[:, :3, :3] @ L[self.p_lm][..., None])[..., 0] + Ek[:, :3, 3]
        z = P[:, 2]
        z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
        uv = torch.stack([self.fx * P[:, 0] / z + self.cx,
                          self.fy * P[:, 1] / z + self.cy], 1)
        return rp, self.sw[:, None] * (self.meas - uv)

    def _rho(self, c):
        if self.delta <= 0:
            return c, torch.ones_like(c)
        d2 = self.delta * self.delta
        return d2 * torch.log1p(c / d2), 1.0 / (1.0 + c / d2)

    def cost(self, E, L):
        rp, rr = self.residuals(E, L)
        return float(self._rho(torch.sum(rp * rp, -1))[0].sum()
                     + self._rho(torch.sum(rr * rr, -1))[0].sum())


def _proj_residual(dp, dl, Ek, Ll, meas, sw, K):
    """One projection edge's weighted residual (2,) after the updates dp
    of its keyframe's inverse pose and dl of its landmark."""
    E = exp_se3(dp) @ Ek
    P = E[:3, :3] @ (Ll + dl) + E[:3, 3]
    z = torch.where(P[2].abs() > 1e-9, P[2], torch.full_like(P[2], 1e-9))
    uv = torch.stack([K[0] * P[0] / z + K[2], K[1] * P[1] / z + K[3]])
    return sw * (meas - uv)


def _pose_residual(di, dj, Ei, Ej, Z, S):
    """One pose edge's weighted residual (6,) after the updates di, dj of
    its two inverse poses."""
    err = _inv(Z) @ (exp_se3(di) @ Ei) @ _inv(exp_se3(dj) @ Ej)
    return S @ log_se3(err)


def jacobian(problem: Problem, E, L):
    """The dense Jacobian (residuals x variables) of the stacked residuals
    at (E, L), assembled from each edge's own derivative blocks. Forward
    mode here runs in float64 only, so another type's Jacobian is taken in
    float64 and rounded."""
    p = problem
    if p.dtype != torch.float64:
        wide = copy.copy(p)
        f64 = torch.float64
        wide.dtype, wide.Z, wide.S = f64, p.Z.to(f64), p.S.to(f64)
        wide.meas, wide.sw = p.meas.to(f64), p.sw.to(f64)
        return jacobian(wide, E.to(f64), L.to(f64)).to(p.dtype)
    dt, dev = p.dtype, E.device
    col_pose = torch.full((E.shape[0],), -1, dtype=torch.int64, device=dev)
    col_pose[p.free_idx] = 6 * torch.arange(len(p.free_idx), device=dev)
    col_lm = torch.full((L.shape[0],), -1, dtype=torch.int64, device=dev)
    col_lm[p.lm_idx] = 6 * len(p.free_idx) + 3 * torch.arange(
        len(p.lm_idx), device=dev)
    n_pose_res = 6 * len(p.ei)
    J = torch.zeros((n_pose_res + 2 * len(p.p_kf), p.n), dtype=dt,
                    device=dev)
    if len(p.p_kf):
        K = torch.tensor([p.fx, p.fy, p.cx, p.cy], dtype=dt, device=dev)
        z6 = torch.zeros((len(p.p_kf), 6), dtype=dt, device=dev)
        z3 = torch.zeros((len(p.p_kf), 3), dtype=dt, device=dev)
        Jp, Jl = torch.func.vmap(torch.func.jacfwd(_proj_residual, (0, 1)),
                                 in_dims=(0, 0, 0, 0, 0, 0, None))(
            z6, z3, E[p.p_kf], L[p.p_lm], p.meas, p.sw, K)
        rows = n_pose_res + 2 * torch.arange(len(p.p_kf), device=dev)
        _put(J, rows, 2, col_pose[p.p_kf], 6, Jp)
        _put(J, rows, 2, col_lm[p.p_lm], 3, Jl)
    if len(p.ei):
        zp = torch.zeros((len(p.ei), 6), dtype=dt, device=dev)
        Ji, Jj = torch.func.vmap(torch.func.jacfwd(_pose_residual, (0, 1)))(
            zp, zp, E[p.ei], E[p.ej], p.Z, p.S)
        rows = 6 * torch.arange(len(p.ei), device=dev)
        _put(J, rows, 6, col_pose[p.ei], 6, Ji)
        _put(J, rows, 6, col_pose[p.ej], 6, Jj)
    return J


def _put(J, rows, nr, cols, nc, blocks):
    """J[rows + i, cols + j] += blocks[:, i, j] where cols >= 0."""
    keep = cols >= 0
    rows, cols, blocks = rows[keep], cols[keep], blocks[keep]
    r = rows[:, None, None] + torch.arange(nr, device=J.device)[None, :, None]
    c = cols[:, None, None] + torch.arange(nc, device=J.device)[None, None, :]
    J.index_put_((r.expand(blocks.shape).reshape(-1),
                  c.expand(blocks.shape).reshape(-1)),
                 blocks.reshape(-1), accumulate=True)


def _solve(A, b):
    """A x = b; torch solves no bfloat16 system, so that one is solved in
    float32 and rounded back (this and the Jacobian are the bfloat16
    control's wider steps)."""
    if A.dtype == torch.bfloat16:
        return torch.linalg.solve(A.float(), b.float()).to(A.dtype)
    return torch.linalg.solve(A, b)


def solve(problem: Problem, iterations: int = 100):
    """LM with Cauchy (IRLS) weights on the dense Jacobian; returns the
    inverse poses E and landmarks L at the minimum found."""
    E, L = problem.E0, problem.L0
    if problem.n == 0:
        return E, L
    lam = None
    cost = problem.cost(E, L)
    for _ in range(iterations):
        J = jacobian(problem, E, L)
        rp, rr = problem.residuals(E, L)
        wp = problem._rho(torch.sum(rp * rp, -1))[1]
        wr = problem._rho(torch.sum(rr * rr, -1))[1]
        w = torch.cat([wp.repeat_interleave(6), wr.repeat_interleave(2)])
        r = torch.cat([rp.reshape(-1), rr.reshape(-1)])
        H = J.T @ (w[:, None] * J)
        g = J.T @ (w * r)
        if lam is None:
            lam = 1e-5 * float(torch.diagonal(H).abs().max())
        improved = False
        for _ in range(10):
            A = H + lam * torch.diag(torch.diagonal(H).clamp(min=1e-12))
            d = _solve(A, -g)
            E2, L2 = problem.apply(E, L, d)
            c2 = problem.cost(E2, L2)
            if math.isfinite(c2) and c2 < cost:
                improved = True
                gain = cost - c2
                E, L, cost = E2, L2, c2
                lam = max(lam / 3.0, 1e-12)
                break
            lam *= 4.0
        if not improved or gain <= 1e-12 * cost:
            break
    return E, L
