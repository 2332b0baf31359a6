"""Intensity pyramid + central-difference gradients (DSO-style) (copy of
cvo_slam_tpu.frontend.pyramid).

Re-expression of reference pcd_generator::make_pyramid
(reference thirdparty/cvo/src/pcd_generator.cpp:50-143) in vectorized
NumPy (host-side data prep; the CVO compute path consumes the fixed-size
point clouds on device).

Fidelity notes:
  * gradients are computed over the *flattened* image for linear indices
    [w, w*(h-1)), i.e. rows 1..h-2 — including column 0 / w-1, where the
    stencil wraps to the previous/next row exactly as in the reference.
  * downsampling is a 2x2 box filter on the previous level; odd trailing
    pixels are dropped (integer halving of w, h).
"""

from __future__ import annotations

import numpy as np

PYR_LEVELS = 3  # reference data_type.h:25


def make_pyramid(gray: np.ndarray, levels: int = PYR_LEVELS):
    """gray: (H, W) float32 intensity (0..255).

    Returns (intensity, dx, dy, absgrad): lists of per-level (h_l, w_l)
    float32 arrays."""
    h, w = gray.shape
    intensity, dxs, dys, absgrads = [], [], [], []
    cur = gray.astype(np.float32)
    wl, hl = w, h
    for lvl in range(levels):
        if lvl > 0:
            prev = intensity[lvl - 1]
            wl //= 2
            hl //= 2
            cur = 0.25 * (prev[0:2 * hl:2, 0:2 * wl:2]
                          + prev[0:2 * hl:2, 1:2 * wl:2]
                          + prev[1:2 * hl:2, 0:2 * wl:2]
                          + prev[1:2 * hl:2, 1:2 * wl:2])
        flat = cur.reshape(-1)
        n = flat.shape[0]
        dx = np.zeros(n, np.float32)
        dy = np.zeros(n, np.float32)
        sl = slice(wl, wl * (hl - 1))
        dx[sl] = 0.5 * (flat[wl + 1: wl * (hl - 1) + 1]
                        - flat[wl - 1: wl * (hl - 1) - 1])
        dy[sl] = 0.5 * (flat[2 * wl: wl * hl] - flat[0: wl * (hl - 2)])
        np.nan_to_num(dx, copy=False)
        np.nan_to_num(dy, copy=False)
        ag = dx * dx + dy * dy
        intensity.append(cur)
        dxs.append(dx.reshape(hl, wl))
        dys.append(dy.reshape(hl, wl))
        absgrads.append(ag.reshape(hl, wl))
    return intensity, dxs, dys, absgrads
