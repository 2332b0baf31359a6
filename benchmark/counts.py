"""The least work a kernel call's inputs need, and the least time the
H100's published peaks allow for it (for the `roofline_pct.<kernel>`
metrics).

The counts are of what the inputs need, whatever implements it: the gate
test over every pair of valid points, the kernel terms of the pairs the
gates pass, each input byte read once and each output byte written once.
They do not change when a kernel skips more tiles or sums in another
order. Operations are float32 arithmetic (an add, multiply, compare,
max or exponential is one; a multiply-add two), against 67 TFLOP/s; bytes
against 3.35 TB/s (NVIDIA's data sheet for the H100 SXM at 700 W, dense,
outside the tensor cores). Per pair:

  gate test of a valid pair          9  (3 sub, 3 mul, 2 add, compare)
  colour distance inside the gate   15  (5 sub, 5 mul, 4 add, compare)
  joint kernel of a gated pair       7  (2 mul, add, max, exp, mul, compare)
  flow and step terms of a kept
  pair (35 moments, multiply-add)   70
  an inner product's gated pair     11  (two exponentials 8, product,
                                         sum, count)
  a Hessian moment of a gated pair  36  (a 5-term feature dot 9, a 13-term
                                         multiply-add row 26, weight 1),
                                         and 338 per row that has one

Copied from chip_smoke.py's live_pairs / moment_counts / suite_counts /
align_counts and corrected: those count the pairs of the tile pairs a
kernel computes, so their bound moves when skipping changes.
"""

from __future__ import annotations

import collections
import math
import sys

import torch

PEAK_FLOPS = 67e12      # float32, outside the tensor cores
PEAK_BYTES = 3.35e12    # HBM3


def least_seconds(ops: float, nbytes: float):
    """(seconds, 'operations' or 'bytes', whichever bounds)."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _d2t(ell: float, p: dict) -> float:
    return -2.0 * ell * ell * math.log(p["sp_thres"] / p["sigma"] ** 2)


def _d2ct(p: dict) -> float:
    return -2.0 * p["c_ell"] ** 2 * math.log(p["sp_thres"]
                                             / p["c_sigma"] ** 2)


def _sq(a, b):
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)


def pair_classes(xa, fa, ma, xb, fb, mb, ell: float, p: dict):
    """Counts of the valid, geometrically gated, fully gated and kept
    pairs, and the gated (rows, pairs) mask."""
    valid = ma[:, None] & mb[None, :]
    d2 = _sq(xa.float(), xb.float())
    geo = valid & (d2 < _d2t(ell, p))
    d2c = _sq(fa.float(), fb.float())
    gate = geo & (d2c < _d2ct(p))
    a = (p["sigma"] ** 2 * p["c_sigma"] ** 2) * torch.exp(torch.clamp(
        -(d2 / (2 * ell * ell) + d2c / (2 * p["c_ell"] ** 2)), min=-20.0))
    keep = gate & (a > p["sp_thres"])
    return ([int(t.sum()) for t in (valid, geo, gate, keep)], gate)


def _cloud_bytes(n: int) -> int:
    return n * (3 * 4 + 5 * 4 + 1)


def moment_flow_step(args, p: dict):
    """(ops, bytes) of kernels.moment_flow_step(x, y, fx, fy, mx, my, U,
    center, ell, p): one align iteration's pass."""
    x, y, fx, fy, mx, my, U, center, ell = args[:9]
    ell = float(ell)
    (nv, ng, nk, nkeep), _ = pair_classes(x, fx, mx, y, fy, my, ell, p)
    ops = 9 * nv + 15 * ng + 7 * nk + 70 * nkeep
    nbytes = _cloud_bytes(x.shape[0]) + _cloud_bytes(y.shape[0]) \
        + U.numel() * 4 + 3 * 4 + 4 + 11 * 4
    return ops, nbytes


def _ip_set(xa, fa, ma, xb, fb, mb, ell, p, moments: bool):
    (nv, ng, nk, _), gate = pair_classes(xa, fa, ma, xb, fb, mb, ell, p)
    ops = 9 * nv + 15 * ng + 11 * nk
    if moments:
        ops += 36 * nk + 338 * int(gate.any(dim=1).sum())
    return ops


def ip_suite(args, p: dict):
    """(ops, bytes) of kernels.ip_suite(x, fx, mx, y, fy, my, yt, ell, p):
    the pre, post (with the Hessian moments), fixed and moving pair
    sets."""
    x, fx, mx, y, fy, my, yt, ell = args[:8]
    ell = float(ell)
    ops = (_ip_set(y, fy, my, x, fx, mx, ell, p, False)
           + _ip_set(yt, fy, my, x, fx, mx, ell, p, True)
           + _ip_set(x, fx, mx, x, fx, mx, ell, p, False)
           + _ip_set(y, fy, my, y, fy, my, ell, p, False))
    nbytes = _cloud_bytes(x.shape[0]) + _cloud_bytes(y.shape[0]) \
        + y.shape[0] * 3 * 4 + (4 + 4 + 169 + 1) * 4
    return ops, nbytes


def align_fused(args, iterations: int, p: dict):
    """(ops, bytes) of kernels.align_fused(x, fx, mx, y0, fy, my, R0, T0,
    ell0, p) that ran `iterations` iterations: each iteration's pairs as
    the plain registration (benchmark/reference/cvo.py, float32) meets
    them from the same start, averaged over the iterations both ran, times
    `iterations`; bytes: both clouds and the state read once, the state,
    ell, iterations and count written once."""
    from .reference import cvo as ref_cvo
    x, fx, mx, y0, fy, my, R0, T0, ell0 = args[:9]
    per_iter = []

    def seen(k, y, ell):
        if k < iterations:
            (nv, ng, nk, nkeep), _ = pair_classes(x, fx, mx, y, fy, my, ell,
                                                  p)
            per_iter.append(9 * nv + 15 * ng + 7 * nk + 70 * nkeep
                            + 15 * y.shape[0])

    ref_cvo.align((x, fx, mx), (y0, fy, my), R0, T0, float(ell0),
                  dict(p, max_iter=max(iterations, 1)), torch.float32,
                  on_iteration=seen)
    ops = sum(per_iter) / max(len(per_iter), 1) * iterations
    nbytes = _cloud_bytes(x.shape[0]) + _cloud_bytes(y0.shape[0]) \
        + 13 * 4 + 16 * 4
    return ops, nbytes


def roofline_pct(window, kernel: str, names, count, p: dict,
                 sample: int = 24):
    """100 x the least time over the device time of a fixed sample of the
    captured calls of kernels.<kernel> whose device time the trace holds
    (its kernels `names`, benchmark/trace.match_calls; evenly spaced, at
    most `sample`); None if there is none. `count(call, p)` gives (ops,
    bytes)."""
    from .trace import match_calls
    calls = window.kernel_calls.get(kernel, [])
    if not window.trace or not calls:
        return None
    match_calls(calls, window.trace["port_kernels"], names)
    timed = [c for c in calls if c.device_s]
    if not timed:
        return None
    step = max(1, len(timed) // sample)
    pick = timed[::step][:sample]
    least, device, bound = 0.0, 0.0, collections.Counter()
    for c in pick:
        t, what = least_seconds(*count(c, p))
        least += t
        device += c.device_s
        bound[what] += 1
    print(f"roofline {pick[0].name}: {len(pick)} of {len(timed)} timed "
          f"calls ({len(calls)} made), bound by {dict(bound)}",
          file=sys.stderr)
    return 100.0 * least / device


def iterations_run(iters: int, p: dict) -> int:
    """Iterations an align evaluated: the stop iteration's pass ran too."""
    return min(int(iters) + 1, p["max_iter"])
