"""Smallest-positive-real-root cubic solver for the CVO step size
(port of cvo_slam_tpu.ops.cubic).

The reference solves the quartic-energy derivative 4E s^3 + 3D s^2 + 2C s + B
via a companion-matrix eigensolve and picks the smallest positive real root
(cvo.cpp:76-92, 317-333). The closed-form (trig/Cardano) solution here is
branch-free, so it stays on the device inside the align loop. Semantics:

  * only real roots count (discriminant decides, like imag()==0 in Eigen);
  * no positive real root -> min_step (cvo.cpp:330);
  * result clamped to max_step=0.8 (cvo.cpp:333);
  * degenerate leading coefficient -> min_step.
"""

from __future__ import annotations

import math

import torch


def cubic_roots_real(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d (0-d tensors), returned as a
    length-3 vector where non-real (or invalid) slots are +inf."""
    inf = torch.full_like(a, math.inf)
    safe_a = torch.where(torch.abs(a) > 0.0, a, torch.ones_like(a))
    p = b / safe_a
    q = c / safe_a
    r = d / safe_a

    # depressed cubic t^3 + pt*t + qt, x = t - p/3
    pt = q - p * p / 3.0
    qt = 2.0 * p ** 3 / 27.0 - p * q / 3.0 + r

    disc = (qt / 2.0) ** 2 + (pt / 3.0) ** 3

    # --- one-real-root branch (disc > 0): Cardano
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_single = _cbrt(-qt / 2.0 + sq) + _cbrt(-qt / 2.0 - sq)

    # --- three-real-roots branch (disc <= 0): trigonometric
    m = torch.clamp(-pt / 3.0, min=1e-30)
    sm = torch.sqrt(m)
    # guard pt -> 0 (triple root): cos_arg irrelevant, sm -> 0 gives t=0
    pt_safe = torch.where(torch.abs(pt) > 1e-30, pt, -3.0 * m)
    cos_arg = torch.clamp(3.0 * qt / (2.0 * pt_safe * sm), -1.0, 1.0)
    ang = torch.arccos(cos_arg) / 3.0
    ks = torch.arange(3, dtype=a.dtype, device=a.device)
    t_trig = 2.0 * sm * torch.cos(ang - 2.0 * math.pi * ks / 3.0)

    three_real = disc <= 0.0
    roots = torch.where(three_real, t_trig - p / 3.0,
                        torch.stack([t_single - p / 3.0, inf, inf]))
    return torch.where(torch.abs(a) > 0.0, roots, inf)


def _cbrt(x):
    """Real cube root (torch has no cbrt): sign(x) |x|^(1/3)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def min_positive_root_or(a, b, c, d, fallback, clamp):
    """Smallest strictly-positive real root of the cubic; ``fallback`` if none;
    clamped from above at ``clamp`` (cvo.cpp:324-333)."""
    roots = cubic_roots_real(a, b, c, d)
    pos = torch.where(roots > 0.0, roots, torch.full_like(roots, math.inf))
    best = torch.min(pos)
    step = torch.where(torch.isfinite(best), best,
                       torch.full_like(best, fallback))
    return torch.clamp(step, max=clamp)
