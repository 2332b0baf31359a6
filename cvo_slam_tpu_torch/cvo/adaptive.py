"""Adaptive-ell CVO registration, the reference's `adaptive_cvo` variant
(port of cvo_slam_tpu.cvo.adaptive).

Re-expression of the reference's thirdparty/cvo/src/adaptive_cvo.cpp, a
variant the reference ships but does not build (its CMake targets are
commented out, thirdparty/cvo/CMakeLists.txt:78-101). Instead of the fixed
iteration-indexed ell anneal of the main engine (cvo.cpp:810-812), the
kernel length-scale follows a data-driven gradient step each iteration
(adaptive_cvo.cpp:537-545):

    ell <- ell + dl_step * dl
    if ell >= ell_max: ell = 0.7 * ell_max; ell_max = 0.7 * ell_max
    ell = max(ell, ell_min)

where dl is the derivative of the kernel-correlation objective w.r.t. ell,
accumulated over the self- and cross-kernels (adaptive_cvo.cpp:167-271):

    dl = (1/ell^3) * [ sum_ij Axx_ij |x_i-x_j|^2 + sum_ij Ayy_ij |y_i-y_j|^2
                       - 2 sum_ij Axy_ij |x_i-y_j|^2 ]
         / (nnz(Axx) + nnz(Ayy) - 2 nnz(Axy))

As in the JAX package, the reduction is the mathematically intended one:
the reference's TBB loop never fills `sum_diff_yy_2` for rows i <
num_fixed (adaptive_cvo.cpp:214-222).

Each iteration's flow and step coefficients come from the moment kernel
(kernels.moment_flow_step: the CUDA kernel on the card, its plain version
on the CPU), nnz(Axy) with them. The dl terms are plain torch: |x_i-x_j|^2
and |y_i-y_j|^2 (geometric and colour) are invariant under the rigid
update, so the four self-distance matrices are computed once per alignment
(~151 MB at CAP 3072) and re-kernelled with the current ell each
iteration; the cross sum is evaluated on the current pair set.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import CvoParams
from ..ops import cubic, pairwise, se3
from . import kernels
from .engine import ALIGN_CHUNK, AlignResult, PointCloud, _f32


@dataclass(frozen=True)
class AdaptiveParams:
    """adaptive_cvo.cpp:25-31 defaults."""
    ell_init: float = 0.1
    ell_min: float = 0.0391
    ell_max: float = 0.15
    dl_step: float = 0.3


def _self_d2(pos, feat, mask):
    """Rigid-invariant self squared distances (geometric + colour) with the
    validity mask folded in as +inf (fails every gate)."""
    d2 = pairwise.pairwise_sq_dists(pos, pos)
    d2c = pairwise.pairwise_sq_dists(feat, feat)
    valid = mask[:, None] & mask[None, :]
    inf = torch.full_like(d2, float("inf"))
    return torch.where(valid, d2, inf), torch.where(valid, d2c, inf)


def _kernel_stats_from_d2(d2, d2c, ell, p: CvoParams):
    """sum(A * d2) and nnz of a kernel evaluated on precomputed distance
    matrices (the se_kernel gates + sparsification of adaptive_cvo.cpp:
    134-142, reduced per :222-231)."""
    ggate = d2 < pairwise.d2_threshold(ell, p)
    cgate = d2c < pairwise.d2_color_threshold(p)
    k = (p.sigma * p.sigma) * torch.exp(
        torch.clamp(-d2 / (2.0 * ell * ell), min=-20.0))
    ck = (p.c_sigma * p.c_sigma) * torch.exp(
        torch.clamp(-d2c / (2.0 * p.c_ell * p.c_ell), min=-20.0))
    a = ck * k
    keep = ggate & cgate & (a > p.sp_thres)
    zero = torch.zeros_like(a)
    return (torch.sum(torch.where(keep, a, zero) * torch.where(keep, d2, zero)),
            torch.sum(keep, dtype=torch.int32))


def adaptive_align(fixed: PointCloud, moving: PointCloud, R0, T0,
                   p: CvoParams, ap: AdaptiveParams = AdaptiveParams()
                   ) -> AlignResult:
    """RKHS-SE(3) registration with the adaptive ell schedule
    (adaptive_cvo.cpp:446-569). The flow, step size and stopping rules of
    engine.align; ell starts from ap.ell_init on every call (the adaptive
    variant resets it, adaptive_cvo.cpp:476-478). A host loop reading the
    stop flag once per ALIGN_CHUNK iterations, each update gated on
    `active`, as engine.align_loop."""
    dev = fixed.device
    x, fx, mx = fixed.positions, fixed.features, fixed.mask
    y0, fy, my = moving.positions, moving.features, moving.mask
    center, U = pairwise.step_moment_basis(x, mx)
    U = U.contiguous()
    # rigid-invariant self-distance matrices: loop constants
    d2_xx, d2c_xx = _self_d2(x, fx, mx)
    d2_yy, d2c_yy = _self_d2(y0, fy, my)

    R, T = _f32(R0, dev), _f32(T0, dev)
    ell = torch.tensor(ap.ell_init, dtype=torch.float32, device=dev)
    ell_max = torch.tensor(ap.ell_max, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.full((), p.max_iter, dtype=torch.int64, device=dev)
    nnz = torch.zeros((), dtype=torch.int32, device=dev)

    k = 0
    while k < p.max_iter:
        for _ in range(min(ALIGN_CHUNK, p.max_iter - k)):
            Rt = R.T
            Tt = -(Rt @ T)
            y = (y0 @ R + Tt[None, :]).contiguous()
            omega, v, nnz_xy, B, C, D, E = kernels.moment_flow_step(
                x, y, fx, fy, mx, my, U, center, ell, p)
            # dl (adaptive_cvo.cpp:222-271): self terms from the
            # precomputed distance matrices, cross term from the current
            # pair set
            A_xy, keep_xy = pairwise.cvo_kernel(x, y, fx, fy, mx, my, ell, p)
            d2_xy = pairwise.pairwise_sq_dists(x, y)
            sum_xy = torch.sum(A_xy * torch.where(keep_xy, d2_xy,
                                                  torch.zeros_like(d2_xy)))
            sum_xx, nnz_xx = _kernel_stats_from_d2(d2_xx, d2c_xx, ell, p)
            sum_yy, nnz_yy = _kernel_stats_from_d2(d2_yy, d2c_yy, ell, p)
            denom = (nnz_xx + nnz_yy - 2 * nnz_xy).to(torch.float32)
            dl = (sum_xx + sum_yy - 2.0 * sum_xy) / (
                ell * ell * ell
                * torch.where(denom == 0, torch.ones_like(denom), denom))

            step = cubic.min_positive_root_or(4.0 * E, 3.0 * D, 2.0 * C, B,
                                              p.min_step, p.max_step)
            active = ~done
            stop1 = active & (torch.linalg.norm(omega) < p.eps) \
                & (torch.linalg.norm(v) < p.eps)
            do_update = active & ~stop1
            dtrans = se3.exp_sek3(torch.cat([omega, v]), step)
            dR = dtrans[:3, :3]
            dT = dtrans[:3, 3]
            T_new = torch.where(do_update, R @ dT + T, T)
            R = torch.where(do_update, R @ dR, R)
            T = T_new
            stop2 = do_update & (se3.dist_se3(dR, dT) < p.eps_2)
            iters = torch.where(active & (stop1 | stop2),
                                torch.full_like(iters, k), iters)
            # ell update (adaptive_cvo.cpp:537-545)
            ell_up = ell + ap.dl_step * dl
            shrink = ell_up >= ell_max
            ell_max_new = torch.where(shrink, ell_max * 0.7, ell_max)
            ell_up = torch.where(shrink, ell_max * 0.7, ell_up)
            ell_up = torch.clamp(ell_up, min=ap.ell_min)
            keep_state = active & ~stop1 & ~stop2
            ell = torch.where(keep_state, ell_up, ell)
            ell_max = torch.where(keep_state, ell_max_new, ell_max)
            nnz = torch.where(active, nnz_xy, nnz)
            done = done | stop1 | stop2
            k += 1
        if bool(done):
            break
    transform = se3.make_pose(R.T, -(R.T @ T))
    return AlignResult(R, T, transform, ell, iters, nnz)
