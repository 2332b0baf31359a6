"""SE(3)/SO(3) Lie-group math in PyTorch (port of cvo_slam_tpu.ops.se3).

Conventions (matching the reference LieGroup.cpp):
  * twist vectors are ordered [omega(3), v(3)] — rotation first.
  * poses are 4x4 homogeneous matrices.
  * small-angle switch at TOLERANCE=1e-6 (LieGroup.cpp:18) selecting the
    identity/first-order branch, exactly like the reference (no Taylor series).

Every tensor function works on tensors of any leading batch shape, on any
device, with no host synchronisation: branches are computed with safe
denominators and selected with torch.where.
"""

from __future__ import annotations

import numpy as np
import torch

TOL = 1e-6


def skew(v):
    """3-vector -> skew-symmetric matrix (LieGroup.cpp:20-27)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def unskew(M):
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _theta(w):
    return torch.sqrt(torch.clamp(torch.sum(w * w, dim=-1), min=0.0))


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def exp_so3(w):
    """Rodrigues formula (LieGroup.cpp:148-157)."""
    theta = _theta(w)
    safe = theta >= TOL
    t = torch.where(safe, theta, torch.ones_like(theta))
    A = skew(w)
    A2 = A @ A
    eye = _eye3(w)
    R = eye + (torch.sin(t) / t)[..., None, None] * A \
        + ((1.0 - torch.cos(t)) / (t * t))[..., None, None] * A2
    return torch.where(safe[..., None, None], R, eye.expand_as(R))


def log_so3(R):
    """Matrix log on SO(3) (LieGroup.cpp:120-126), with acos clamped."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    theta = torch.arccos(cos_t)
    safe = theta >= TOL
    one = torch.ones_like(theta)
    t = torch.where(safe, theta, one)
    st = torch.where(safe, torch.sin(t), one)
    W = (t / (2.0 * st))[..., None, None] * (R - R.transpose(-1, -2))
    w = unskew(W)
    return torch.where(safe[..., None], w, torch.zeros_like(w))


def left_jacobian_so3(w):
    """J_l (LieGroup.cpp:49-59)."""
    theta = _theta(w)
    safe = theta >= TOL
    t = torch.where(safe, theta, torch.ones_like(theta))
    A = skew(w)
    A2 = A @ A
    eye = _eye3(w)
    J = eye + ((1.0 - torch.cos(t)) / (t * t))[..., None, None] * A \
        + ((t - torch.sin(t)) / (t ** 3))[..., None, None] * A2
    return torch.where(safe[..., None, None], J, eye.expand_as(J))


def left_jacobian_inv_so3(w):
    """J_l^{-1} (LieGroup.cpp:61-69)."""
    theta = _theta(w)
    safe = theta >= TOL
    t = torch.where(safe, theta, torch.ones_like(theta))
    A = skew(w)
    A2 = A @ A
    eye = _eye3(w)
    coef = 1.0 / (t * t) - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t))
    J = eye - 0.5 * A + coef[..., None, None] * A2
    return torch.where(safe[..., None, None], J, eye.expand_as(J))


def make_pose(R, t):
    """Assemble a (...,4,4) pose from (...,3,3) and (...,3)."""
    batch = R.shape[:-2]
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def exp_se3(xi):
    """SE(3) exponential, xi=[w,v] (LieGroup.cpp:139-146)."""
    w, v = xi[..., :3], xi[..., 3:6]
    R = exp_so3(w)
    t = (left_jacobian_so3(w) @ v[..., None])[..., 0]
    return make_pose(R, t)


def exp_se3_np(xi):
    """NumPy float64 SE(3) exponential for the host-side pose-only LM of the
    loop-closure matcher (features.matcher), as g2o::SE3Quat::exp in double
    precision; the small-angle branch is first order below 1e-7."""
    xi = np.asarray(xi, np.float64)
    w, v = xi[:3], xi[3:6]
    theta = float(np.linalg.norm(w))
    A = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]])
    eye = np.eye(3)
    if theta < 1e-7:
        R = eye + A
        J = eye + 0.5 * A
    else:
        A2 = A @ A
        R = eye + (np.sin(theta) / theta) * A \
            + ((1.0 - np.cos(theta)) / theta ** 2) * A2
        J = eye + ((1.0 - np.cos(theta)) / theta ** 2) * A \
            + ((theta - np.sin(theta)) / theta ** 3) * A2
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = J @ v
    return T


def log_se3(T):
    """SE(3) log returning [w, v] (LieGroup.cpp:128-136)."""
    w = log_so3(T[..., :3, :3])
    v = (left_jacobian_inv_so3(w) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([w, v], dim=-1)


def exp_sek3(xi, dt):
    """Scaled exponential Exp_SEK3(v, dt) used by the align loop
    (LieGroup.cpp:159-186, K=1). Returns a 4x4 transform."""
    dt = torch.as_tensor(dt, dtype=xi.dtype, device=xi.device)
    w, v = xi[..., :3], xi[..., 3:6]
    theta = _theta(w)
    safe = theta >= TOL
    t = torch.where(safe, theta, torch.ones_like(theta))
    A = skew(w)
    A2 = A @ A
    eye = _eye3(xi)
    st = torch.sin(dt * t)
    ct = torch.cos(dt * t)
    one_m_ct_t2 = (1.0 - ct) / (t * t)
    R = eye + (st / t)[..., None, None] * A + one_m_ct_t2[..., None, None] * A2
    Jl = dt[..., None, None] * eye + one_m_ct_t2[..., None, None] * A \
        + ((dt * t - st) / (t ** 3))[..., None, None] * A2
    R = torch.where(safe[..., None, None], R, eye.expand_as(R))
    Jl = torch.where(safe[..., None, None], Jl, dt[..., None, None] * eye)
    tvec = (Jl @ v[..., None])[..., 0]
    return make_pose(R, tvec)


def adjoint_se3(T):
    """Adjoint for the [w, v] ordering (LieGroup.cpp:188-199, K=1):
    [[R, 0], [skew(t) R, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([skew(t) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def left_jacobian_inv_se3(xi):
    """Closed-form inverse left Jacobian of SE(3) for [phi, rho] ordering, as
    the reference edge linearization (vertex_and_edge.cpp:118-171):

      theta > 1e-3:  [[Jinv, 0], [-Jinv Q Jinv, Jinv]]
      else:          [[I, 0], [-0.5 skew(rho), I]]
    """
    phi, rho = xi[..., :3], xi[..., 3:6]
    theta = _theta(phi)
    safe = theta > 1e-3
    t = torch.where(safe, theta, torch.ones_like(theta))

    P = skew(phi)
    Rh = skew(rho)
    P2 = P @ P
    eye = _eye3(xi)

    coef = 1.0 / (t * t) - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t))
    Jinv = eye - 0.5 * P + coef[..., None, None] * P2

    t2, t3 = t * t, t ** 3
    t4, t5 = t ** 4, t ** 5
    st, ct = torch.sin(t), torch.cos(t)
    Q = (0.5 * Rh
         + ((t - st) / t3)[..., None, None] * (P @ Rh + Rh @ P + P @ Rh @ P)
         + ((t2 + 2.0 * ct - 2.0) / (2.0 * t4))[..., None, None]
         * (P2 @ Rh + Rh @ P2 - 3.0 * P @ Rh @ P)
         + ((2.0 * t - 3.0 * st + t * ct) / (2.0 * t5))[..., None, None]
         * (P @ Rh @ P2 + P2 @ Rh @ P))

    big_block = -Jinv @ Q @ Jinv
    small_block = -0.5 * Rh

    Jinv = torch.where(safe[..., None, None], Jinv, eye.expand_as(Jinv))
    lower = torch.where(safe[..., None, None], big_block, small_block)
    top = torch.cat([Jinv, torch.zeros_like(Jinv)], dim=-1)
    bot = torch.cat([lower, Jinv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inv_pose(T):
    """Rigid SE(3) inverse [R^T | -R^T t]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_pose(Rt, -(Rt @ t[..., None])[..., 0])


def dist_se3(R, t):
    """Frobenius norm of the 4x4 matrix log (cvo.cpp:94-104):
    sqrt(2 |w|^2 + |u|^2) with w = Log(R), u = J_l(w)^{-1} t."""
    w = log_so3(R)
    u = (left_jacobian_inv_so3(w) @ t[..., None])[..., 0]
    return torch.sqrt(2.0 * torch.sum(w * w, dim=-1) + torch.sum(u * u, dim=-1))


def transform_points(T, pts):
    """Apply (...,4,4) pose to (...,N,3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]
