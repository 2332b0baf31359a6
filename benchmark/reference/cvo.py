"""CVO registration and inner products in plain torch, in any float type.

Written from the reference CVO (thirdparty/cvo/src/cvo.cpp): the joint
kernel and its gates (:122-185), the gradient flow (:187-236), the
4th-order step size (:239-334), both stop rules (:782, :804), the ell
anneal (:810-812) and the inner product (:388-459). Every pair of the two
clouds is evaluated densely, as written there, with no skipping, no
moments and no fixed order of sums: the float type is the only knob
(float64 for the reference, bfloat16 for the lower-precision control).
The closed-form cubic is a copy of the port's ops/cubic.py, which solves
the reference's companion-matrix eigenproblem (:76-92) branch-free.
"""

from __future__ import annotations

import math

import torch


def _d2t(ell, p: dict):
    return -2.0 * ell * ell * math.log(p["sp_thres"] / p["sigma"] ** 2)


def _d2ct(p: dict):
    return -2.0 * p["c_ell"] ** 2 * math.log(p["sp_thres"] / p["c_sigma"] ** 2)


def sq_dists(a, b):
    """(N, K), (M, K) -> (N, M) squared distances, coordinate by
    coordinate."""
    out = (a[:, None, 0] - b[None, :, 0]) ** 2
    for c in range(1, a.shape[1]):
        out = out + (a[:, None, c] - b[None, :, c]) ** 2
    return out


def _skew(w):
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def exp_sek3(xi, dt):
    """Exp_SEK3 (LieGroup.cpp:159-186, K=1): (dR, dT) of xi = [w, v]
    scaled by dt."""
    w, v = xi[:3], xi[3:]
    theta = torch.sqrt(torch.sum(w * w))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    if float(theta) < 1e-6:
        return eye, dt * v
    A = _skew(w)
    A2 = A @ A
    st, ct = torch.sin(dt * theta), torch.cos(dt * theta)
    R = eye + (st / theta) * A + ((1.0 - ct) / theta ** 2) * A2
    J = dt * eye + ((1.0 - ct) / theta ** 2) * A \
        + ((dt * theta - st) / theta ** 3) * A2
    return R, J @ v


def dist_se3(R, t):
    """Frobenius norm of the 4x4 matrix log (cvo.cpp:94-104)."""
    cos_t = torch.clamp(0.5 * (R[0, 0] + R[1, 1] + R[2, 2] - 1.0), -1.0, 1.0)
    theta = torch.arccos(cos_t)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    if float(theta) < 1e-6:
        return torch.sqrt(torch.sum(t * t))
    W = (theta / (2.0 * torch.sin(theta))) * (R - R.T)
    w = torch.stack([W[2, 1], W[0, 2], W[1, 0]])
    A = _skew(w)
    coef = 1.0 / theta ** 2 - (1.0 + torch.cos(theta)) \
        / (2.0 * theta * torch.sin(theta))
    u = (eye - 0.5 * A + coef * (A @ A)) @ t
    return torch.sqrt(2.0 * torch.sum(w * w) + torch.sum(u * u))


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def min_positive_root(a, b, c, d, fallback: float, clamp: float):
    """Smallest positive real root of a s^3 + b s^2 + c s + d, `fallback`
    if none, clamped at `clamp` (cvo.cpp:317-333; ops/cubic.py)."""
    inf = torch.full_like(a, math.inf)
    safe_a = torch.where(torch.abs(a) > 0.0, a, torch.ones_like(a))
    p, q, r = b / safe_a, c / safe_a, d / safe_a
    pt = q - p * p / 3.0
    qt = 2.0 * p ** 3 / 27.0 - p * q / 3.0 + r
    disc = (qt / 2.0) ** 2 + (pt / 3.0) ** 3
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_single = _cbrt(-qt / 2.0 + sq) + _cbrt(-qt / 2.0 - sq)
    m = torch.clamp(-pt / 3.0, min=1e-30)
    sm = torch.sqrt(m)
    pt_safe = torch.where(torch.abs(pt) > 1e-30, pt, -3.0 * m)
    cos_arg = torch.clamp(3.0 * qt / (2.0 * pt_safe * sm), -1.0, 1.0)
    ang = torch.arccos(cos_arg) / 3.0
    ks = torch.arange(3, dtype=a.dtype, device=a.device)
    t_trig = 2.0 * sm * torch.cos(ang - 2.0 * math.pi * ks / 3.0)
    roots = torch.where(disc <= 0.0, t_trig - p / 3.0,
                        torch.stack([t_single - p / 3.0, inf, inf]))
    roots = torch.where(torch.abs(a) > 0.0, roots, inf)
    best = torch.min(torch.where(roots > 0.0, roots, inf))
    step = best if math.isfinite(float(best)) else torch.full_like(
        best, fallback)
    return torch.clamp(step, max=clamp)


def _cross_w(w, u):
    return torch.stack([w[1] * u[:, 2] - w[2] * u[:, 1],
                        w[2] * u[:, 0] - w[0] * u[:, 2],
                        w[0] * u[:, 1] - w[1] * u[:, 0]], dim=1)


def _kernel(x, y, d2c, cgate, ell, p: dict):
    """The kept joint kernel A (N, M) of the fixed points x against the
    moved points y (cvo.cpp:122-185)."""
    d2 = sq_dists(x, y)
    a = (p["sigma"] ** 2 * p["c_sigma"] ** 2) * torch.exp(torch.clamp(
        -(d2 / (2.0 * ell * ell) + d2c / (2.0 * p["c_ell"] ** 2)), min=-20.0))
    keep = cgate & (d2 < _d2t(ell, p)) & (a > p["sp_thres"])
    return torch.where(keep, a, torch.zeros_like(a)), keep


def _flow_and_step(x, y, A, ell, p: dict):
    """omega, v (cvo.cpp:187-236) and the step's Taylor coefficients
    B, C, D, E (:239-315) over the kept pairs."""
    d = A @ y - torch.sum(A, dim=1)[:, None] * x
    omega = torch.sum(torch.linalg.cross(x, d, dim=1), dim=0) / p["c"]
    v = torch.sum(d, dim=0) / p["d"]
    xiz = _cross_w(omega, y) + v[None, :]
    xi2z = _cross_w(omega, xiz)
    xi3z = _cross_w(omega, xi2z)
    xi4z = _cross_w(omega, xi3z)

    def rowdot(u, w):
        return torch.sum(u * w, dim=1)

    def xdot(u):          # x_i . u_j - u_j . y_j, (N, M)
        return x @ u.T - rowdot(u, y)[None, :]

    tc = 1.0 / (2.0 * ell * ell)
    beta = -2.0 * tc * xdot(xiz)
    gamma = -tc * (rowdot(xiz, xiz)[None, :] + 2.0 * xdot(xi2z))
    delta = 2.0 * tc * (-rowdot(xiz, xi2z)[None, :] - xdot(xi3z))
    epsil = -tc * ((rowdot(xi2z, xi2z) + 2.0 * rowdot(xiz, xi3z))[None, :]
                   + 2.0 * xdot(xi4z))
    B = torch.sum(A * beta)
    C = torch.sum(A * (gamma + beta * beta * 0.5))
    D = torch.sum(A * (delta + beta * gamma + beta ** 3 / 6.0))
    E = torch.sum(A * (epsil + beta * delta + 0.5 * beta * beta * gamma
                       + 0.5 * gamma * gamma + beta ** 4 / 24.0))
    return omega, v, B, C, D, E


def align(fixed, moving, R0, T0, ell0: float, p: dict, dtype,
          on_iteration=None):
    """Register `moving` to `fixed` (cvo.cpp:763-821) from the state
    (R0, T0, ell0), the clouds as (positions, features, mask) tensors.
    Returns (transform (4, 4) float64 on the host, ell, iterations).
    `on_iteration(k, y, ell)`, if given, sees each iteration's moved
    points and ell."""
    x, fx, mx = (t.to(dtype) if t.is_floating_point() else t for t in fixed)
    y0, fy, my = (t.to(dtype) if t.is_floating_point() else t
                  for t in moving)
    dev = x.device
    R = torch.as_tensor(R0, dtype=dtype, device=dev)
    T = torch.as_tensor(T0, dtype=dtype, device=dev)
    d2c = sq_dists(fx, fy)
    cgate = (d2c < _d2ct(p)) & mx[:, None] & my[None, :]
    ell = float(ell0)
    iters = p["max_iter"]
    for k in range(p["max_iter"]):
        y = y0 @ R - (R.T @ T)[None, :]
        if on_iteration is not None:
            on_iteration(k, y, ell)
        A, _ = _kernel(x, y, d2c, cgate, ell, p)
        omega, v, B, C, D, E = _flow_and_step(x, y, A, ell, p)
        if float(torch.linalg.norm(omega)) < p["eps"] \
                and float(torch.linalg.norm(v)) < p["eps"]:
            iters = k
            break
        step = min_positive_root(4.0 * E, 3.0 * D, 2.0 * C, B,
                                 p["min_step"], p["max_step"])
        dR, dT = exp_sek3(torch.cat([omega, v]), step)
        T = R @ dT + T
        R = R @ dR
        if float(dist_se3(dR, dT)) < p["eps_2"]:
            iters = k
            break
        for it, val in zip(p["ell_anneal_iters"], p["ell_anneal_values"]):
            if k > it:
                ell = val
    R64, T64 = R.double().cpu(), T.double().cpu()
    out = torch.eye(4, dtype=torch.float64)
    out[:3, :3] = R64.T
    out[:3, 3] = -(R64.T @ T64)
    return out.numpy(), ell, iters


def inner_product(fixed, moving, transform, ell: float, p: dict, dtype):
    """<f_fixed, f_moving under transform> (cvo.cpp:388-459): the joint
    kernel summed over the pairs inside both gates."""
    x, fx, mx = (t.to(dtype) if t.is_floating_point() else t for t in fixed)
    y, fy, my = (t.to(dtype) if t.is_floating_point() else t for t in moving)
    Tm = torch.as_tensor(transform, dtype=dtype, device=x.device)
    yt = y @ Tm[:3, :3].T + Tm[:3, 3]
    d2 = sq_dists(yt, x)
    d2c = sq_dists(fy, fx)
    gate = (d2 < _d2t(ell, p)) & (d2c < _d2ct(p)) & my[:, None] & mx[None, :]
    k = p["sigma"] ** 2 * torch.exp(torch.clamp(-d2 / (2.0 * ell * ell),
                                                min=-20.0))
    ck = p["c_sigma"] ** 2 * torch.exp(torch.clamp(
        -d2c / (2.0 * p["c_ell"] ** 2), min=-20.0))
    return float(torch.sum(torch.where(gate, ck * k, torch.zeros_like(k))))
