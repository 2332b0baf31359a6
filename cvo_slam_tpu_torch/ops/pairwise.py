"""Dense masked pairwise CVO math in PyTorch (port of the parts of
cvo_slam_tpu.ops.pairwise that tracking needs).

  * thresholds of the geometric and colour gates (cvo.cpp:125-126);
  * the 35-monomial moment basis of the fixed cloud and the O(M) epilogue
    `flow_and_step_from_moments` that turns the moment matrix of one align
    iteration into (omega, v, B, C, D, E) (cvo.cpp:187-334);
  * the dense moment-form pass of the JAX package's 'xla' align
    (`color_kernel_gated`, `cvo_kernel_from_color`,
    `flow_and_step_moments`; `flow_and_step_moments_lanes` for S lanes,
    each lane's bits independent of the lane count);
  * the 13x13 Hessian moment algebra (`assemble_hessian`, cvo.cpp:620-759);
  * `ip_suite`, the plain version of compute_innerproduct's pairwise work
    (cvo.cpp:475-503), which the CUDA suite kernel is held against;
  * `pair_stats` (one gated inner product of a cloud pair, with the 13x13
    Hessian moments on request), the plain version of the CUDA pair-stats
    kernel that compute_innerproduct_lc (cvo.cpp:505-561) runs, and its
    named views `inner_product`, `hessian_moments`, `se3_hessian_raw`;
  * `ip_suite_lc`, compute_innerproduct_lc's pairwise work with the feature
    products shared, written independently of `pair_stats`.

All functions take fixed-capacity point clouds with validity masks; invalid
slots contribute exactly zero. Reductions are deterministic.

Pairwise dot products are written out per coordinate in a fixed order (a
chain of fused multiply-adds) rather than as matrix products, so the CUDA
kernels (cvo/kernels.py, csrc/) can repeat the same float operations and
take the same gate decisions bit for bit.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..config import CvoParams
from . import se3


# ---------------------------------------------------------------------------
# thresholds (cvo.cpp:125-126, :395-396, :626-627)
# ---------------------------------------------------------------------------

def log_sp_ratio(p: CvoParams) -> float:
    """log(sp_thres / sigma^2), the constant of the geometric gate."""
    return math.log(p.sp_thres / (p.sigma * p.sigma))


def d2_threshold(ell, p: CvoParams):
    """Geometric squared-distance cutoff: -2 l^2 log(sp_thres / sigma^2)."""
    return -2.0 * ell * ell * log_sp_ratio(p)


def d2_color_threshold(p: CvoParams) -> float:
    """Color squared-distance cutoff: -2 c_ell^2 log(sp_thres / c_sigma^2),
    as the float32 value every gate compares against."""
    return float(np.float32(-2.0 * p.c_ell * p.c_ell
                            * np.log(p.sp_thres / (p.c_sigma * p.c_sigma))))


def sq_norms(a):
    """(..., N, K) -> (..., N) sum of squares, accumulated column by column
    (no fused multiply-add, as XLA's reduction on the CPU)."""
    out = a[..., 0] * a[..., 0]
    for c in range(1, a.shape[-1]):
        out = out + a[..., c] * a[..., c]
    return out


def _fma(a, b, c):
    """float32 fused multiply-add a * b + c, rounded once: the product of two
    f32 values is exact in f64, so one f64 add and one rounding to f32 give
    the fused result (barring a double-rounding tie, ~2^-29 of cases)."""
    return (a.double() * b.double() + c.double()).float()


def pair_dots(a, b):
    """(..., M, K), (..., N, K) -> (..., M, N) dot products a_j . b_i as a
    chain of fused multiply-adds, acc = a_0 b_0, acc = fma(a_c, b_c, acc):
    the rounding of XLA's f32 dot on the CPU and of the CUDA suite kernel
    (__fmaf_rn). Leading lane axes broadcast; every entry is computed
    elementwise, so it does not depend on the lane count."""
    out = a[..., :, None, 0] * b[..., None, :, 0]
    for c in range(1, a.shape[-1]):
        out = _fma(a[..., :, None, c], b[..., None, :, c], out)
    return out


def row_dots(a, b):
    """(K, D), (K, D) -> (K,) row-wise dot products, the FMA chain of
    pair_dots."""
    out = a[:, 0] * b[:, 0]
    for c in range(1, a.shape[1]):
        out = _fma(a[:, c], b[:, c], out)
    return out


def pairwise_sq_dists(a, b):
    """(..., M, K), (..., N, K) -> (..., M, N) squared distances via the
    dot-product identity max(|a|^2 + |b|^2 - 2 a.b, 0) (ops/pairwise.py of
    the JAX package)."""
    return torch.clamp(sq_norms(a)[..., :, None] + sq_norms(b)[..., None, :]
                       - 2.0 * pair_dots(a, b), min=0.0)


# ---------------------------------------------------------------------------
# se_kernel, compute_flow and compute_step_size in per-pair form
# (cvo.cpp:122-334), the plain versions of the flow / step CUDA kernels
# ---------------------------------------------------------------------------

def cvo_kernel(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """Masked joint kernel A (N, M) of the fixed cloud x (rows) against the
    transformed moving cloud y (columns), and keep = gate & a > sp_thres
    (cvo.cpp:175). Gate and kernel as the Pallas `_pair_tile`: distances by
    the dot identity, one fused exponential clamped at -20. The colour
    distance and the kernel are evaluated only for the pairs inside the
    geometric gate, with the same float operations per pair as over the
    whole matrix."""
    d2 = pairwise_sq_dists(x, y)
    i, j = torch.nonzero((d2 < d2_threshold(ell, p)) & mx[:, None]
                         & my[None, :], as_tuple=True)
    fa, fb = fx[i], fy[j]
    d2c = torch.clamp(sq_norms(fa) + sq_norms(fb) - 2.0 * row_dots(fa, fb),
                      min=0.0)
    arg = -(d2[i, j] / (2.0 * ell * ell) + d2c / (2.0 * p.c_ell * p.c_ell))
    a = (p.sigma * p.sigma * p.c_sigma * p.c_sigma) * torch.exp(
        torch.clamp(arg, min=-20.0))
    kept = (d2c < d2_color_threshold(p)) & (a > p.sp_thres)
    i, j = i[kept], j[kept]
    keep = torch.zeros_like(d2, dtype=torch.bool)
    keep[i, j] = True
    A = torch.zeros_like(d2)
    A[i, j] = a[kept]
    return A, keep


def flow(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """omega, v of the RKHS gradient flow (compute_flow, cvo.cpp:187-236):
    omega = (1/c) sum_ij A_ij (x_i x y_j), v = (1/d) sum_ij A_ij (y_j - x_i).
    Returns (omega, v, A, nnz)."""
    A, keep = cvo_kernel(x, y, fx, fy, mx, my, ell, p)
    return _flow_from_A(x, y, A, keep, p)


def _flow_from_A(x, y, A, keep, p: CvoParams):
    """(omega, v, A, nnz) of the flow from the kernel matrix A (N, M)."""
    # d_i = sum_j A_ij (y_j - x_i) is locally small; omega = sum x_i x d_i
    # (exact: x x x = 0) does not cancel when clouds sit metres from the
    # origin, as the raw sum of x_i x y_j would
    d = A @ y - torch.sum(A, dim=1)[:, None] * x
    omega = torch.sum(torch.linalg.cross(x, d, dim=1), dim=0) / p.c
    v = torch.sum(d, dim=0) / p.d
    return omega, v, A, torch.sum(keep, dtype=torch.int32)


def _cross_omega(w, u):
    """omega x u_j for (M, 3) rows u, coordinate by coordinate."""
    return torch.stack([w[1] * u[:, 2] - w[2] * u[:, 1],
                        w[2] * u[:, 0] - w[0] * u[:, 2],
                        w[0] * u[:, 1] - w[1] * u[:, 0]], dim=1)


def step_coeffs(x, y, A, omega, v, ell):
    """Taylor coefficients B, C, D, E of the 4th-order step-size expansion
    (cvo.cpp:239-315). Per pair, with j the moving index, tc = 1/(2 l^2):
      beta  = -2 tc xiz_j . (x_i - y_j)
      gamma = -tc (|xiz_j|^2 + 2 xi2z_j . (x_i - y_j))
      delta = 2 tc (-xiz_j . xi2z_j - xi3z_j . (x_i - y_j))
      epsil = -tc (|xi2z_j|^2 + 2 xiz_j . xi3z_j + 2 xi4z_j . (x_i - y_j))
    xiz = omega x y + v and xi{k+1}z = omega x xi{k}z, the recursive cross
    form of the Pallas kernels (equal to cvo.cpp:252-260's matrix powers).
    The sums run over the kept pairs (A_ij > 0) only."""
    xiz = _cross_omega(omega, y) + v[None, :]
    xi2z = _cross_omega(omega, xiz)
    xi3z = _cross_omega(omega, xi2z)
    xi4z = _cross_omega(omega, xi3z)

    def rowdot(u, w):
        return u[:, 0] * w[:, 0] + u[:, 1] * w[:, 1] + u[:, 2] * w[:, 2]

    i, j = torch.nonzero(A, as_tuple=True)
    a, xi = A[i, j], x[i]

    def xdot(u):          # x_i . u_j - u_j . y_j over the kept pairs
        return rowdot(xi, u[j]) - rowdot(u, y)[j]

    normxiz2 = rowdot(xiz, xiz)[j]
    xiz_dot_xi2z = -rowdot(xiz, xi2z)[j]
    epsil_const = (rowdot(xi2z, xi2z) + 2.0 * rowdot(xiz, xi3z))[j]
    tc = 1.0 / (2.0 * ell * ell)
    beta = -2.0 * tc * xdot(xiz)
    gamma = -tc * (normxiz2 + 2.0 * xdot(xi2z))
    delta = 2.0 * tc * (xiz_dot_xi2z - xdot(xi3z))
    epsil = -tc * (epsil_const + 2.0 * xdot(xi4z))
    B = torch.sum(a * beta)
    C = torch.sum(a * (gamma + beta * beta * 0.5))
    D = torch.sum(a * (delta + beta * gamma + beta ** 3 / 6.0))
    E = torch.sum(a * (epsil + beta * delta + 0.5 * beta * beta * gamma
                       + 0.5 * gamma * gamma + beta ** 4 / 24.0))
    return B, C, D, E


def flow_and_step(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """One align iteration in per-pair form: (omega, v, nnz, B, C, D, E)."""
    omega, v, A, nnz = flow(x, y, fx, fy, mx, my, ell, p)
    return (omega, v, nnz) + step_coeffs(x, y, A, omega, v, ell)


# ---------------------------------------------------------------------------
# moment basis and the moment-form epilogue (cvo.cpp:187-334)
# ---------------------------------------------------------------------------
# Per pair, every step-size Taylor factor is affine in x_i, so each of
# B, C, D, E = sum_ij A_ij P(x_i; j) with P of degree <= 4 in x_i: a linear
# functional of the 35 moments Mom_j = sum_i A_ij xt_i^alpha (xt = x minus
# the masked centroid, |alpha| <= 4). The flow falls out of the degree-<=1
# columns. Centering keeps the expansion conditioned.

# all monomial index tuples over {0,1,2} with degree <= 4, grouped by degree
_MONOMIALS = [()]
_MONOMIALS += [(i,) for i in range(3)]
_MONOMIALS += [(i, j) for i in range(3) for j in range(i, 3)]
_MONOMIALS += [(i, j, k) for i in range(3) for j in range(i, 3)
               for k in range(j, 3)]
_MONOMIALS += [(i, j, k, l) for i in range(3) for j in range(i, 3)
               for k in range(j, 3) for l in range(k, 3)]
_MONO_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}
assert len(_MONOMIALS) == 35
N_MOMENTS = len(_MONOMIALS)


def step_moment_basis(x, mask):
    """(centroid, U) of the fixed cloud: U is (N, 35), all monomials of
    xt = x - centroid up to degree 4. The fixed cloud never changes across
    align iterations (cvo.cpp:336-341), so this is computed once per align."""
    w = mask.to(x.dtype)
    c = torch.sum(x * w[:, None], dim=0) / torch.clamp(torch.sum(w), min=1.0)
    xt = x - c
    cols = [torch.ones(x.shape[0], dtype=x.dtype, device=x.device)]
    for mono in _MONOMIALS[1:]:
        col = xt[:, mono[0]]
        for idx in mono[1:]:
            col = col * xt[:, idx]
        cols.append(col)
    return c, torch.stack(cols, dim=1)


def _poly_mul(p1, p2):
    """Multiply polynomials-in-xt with (M,)-tensor coefficients, keyed by
    sorted monomial index tuples."""
    out = {}
    for k1, v1 in p1.items():
        for k2, v2 in p2.items():
            k = tuple(sorted(k1 + k2))
            out[k] = out.get(k, 0.0) + v1 * v2
    return out


def _poly_addmul(acc, poly, scale=1.0):
    for k, v in poly.items():
        acc[k] = acc.get(k, 0.0) + scale * v
    return acc


def _affine(const, vec):
    """Affine per-j polynomial const_j + vec_j . xt: {(): (M,), (i,): (M,)}."""
    return {(): const, (0,): vec[:, 0], (1,): vec[:, 1], (2,): vec[:, 2]}


def flow_and_step_from_moments(Mom, y, center, ell, nnz, p: CvoParams):
    """Epilogue of the moment-form pass: (omega, v, nnz, B, C, D, E) from
    the moment matrix Mom (M, 35) of the transformed moving cloud y.
    All work here is O(M)-sized — no (N, M) temporaries."""
    # ---- flow (cvo.cpp:222-223) from the degree-<=1 columns -------------
    M0 = Mom[:, 0]
    M1 = Mom[:, 1:4]
    dy = y - center
    # D_j = sum_i A_ij (x_i - y_j): locally small (gate radius ~2.6 ell)
    Dj = M1 - dy * M0[:, None]
    # v = (1/d) sum_ij A (y_j - x_i) = -(1/d) sum_j D_j
    v = -torch.sum(Dj, dim=0) / p.d
    # omega: x_i x y_j = (x_i - y_j) x y_j, so sum_ij A (x x y) = sum_j D_j x y_j
    omega = torch.sum(torch.linalg.cross(Dj, y, dim=1), dim=0) / p.c

    # ---- step coefficients (cvo.cpp:239-315) ----------------------------
    oh = se3.skew(omega)
    oh2 = oh @ oh
    oh3 = oh2 @ oh
    oh4 = oh3 @ oh
    xiz = y @ oh.T + v[None, :]
    xi2z = y @ oh2.T + (oh @ v)[None, :]
    xi3z = y @ oh3.T + (oh2 @ v)[None, :]
    xi4z = y @ oh4.T + (oh3 @ v)[None, :]

    tc = 1.0 / (2.0 * ell * ell)
    two_tc = 2.0 * tc

    def ddot(u):
        return torch.sum(u * dy, dim=1)          # u_j . (y_j - center)

    normxiz2 = torch.sum(xiz * xiz, dim=1)
    xiz_dot_xi2z = torch.sum(xiz * xi2z, dim=1)
    epsil_const = torch.sum(xi2z * xi2z, dim=1) \
        + 2.0 * torch.sum(xiz * xi3z, dim=1)
    # beta  = -2tc xiz.(x - y)  = (2tc xiz.dy) + (-2tc xiz).xt
    beta = _affine(two_tc * ddot(xiz), -two_tc * xiz)
    gamma = _affine(-tc * normxiz2 + two_tc * ddot(xi2z), -two_tc * xi2z)
    delta = _affine(-two_tc * xiz_dot_xi2z + two_tc * ddot(xi3z),
                    -two_tc * xi3z)
    epsil = _affine(-tc * epsil_const + two_tc * ddot(xi4z), -two_tc * xi4z)

    PB, PC, PD, PE = _quartic_polys(beta, gamma, delta, epsil)

    def contract(poly):
        return sum(torch.dot(coef, Mom[:, _MONO_INDEX[k]])
                   for k, coef in poly.items())

    return omega, v, nnz, contract(PB), contract(PC), contract(PD), \
        contract(PE)


def _quartic_polys(beta, gamma, delta, epsil):
    """The per-j polynomials of B, C, D, E from the affine Taylor factors:
    PB = beta, PC = gamma + beta^2/2, PD = delta + beta gamma + beta^3/6,
    PE = epsil + beta delta + beta^2 gamma/2 + gamma^2/2 + beta^4/24."""
    b2 = _poly_mul(beta, beta)
    bg = _poly_mul(beta, gamma)
    PB = dict(beta)
    PC = _poly_addmul(dict(gamma), b2, 0.5)
    PD = _poly_addmul(_poly_addmul(dict(delta), bg),
                      _poly_mul(b2, beta), 1.0 / 6.0)
    PE = _poly_addmul(_poly_addmul(dict(epsil), _poly_mul(beta, delta)),
                      _poly_mul(b2, gamma), 0.5)
    PE = _poly_addmul(PE, _poly_mul(gamma, gamma), 0.5)
    PE = _poly_addmul(PE, _poly_mul(b2, b2), 1.0 / 24.0)
    return PB, PC, PD, PE


# ---------------------------------------------------------------------------
# the dense moment-form pass of the JAX package's 'xla' backend
# (ops/pairwise.py of the JAX package: color_kernel_gated,
# cvo_kernel_from_color, flow_and_step_moments)
# ---------------------------------------------------------------------------
# The kernel functions take leading lane axes (S alignments at once; a
# fixed cloud without one is every lane's) and compute every (N, M) value
# elementwise. The lanes' pass (flow_and_step_moments_lanes) takes one
# torch.mm per lane for the moment product and sums over the moving points
# in a fixed pairwise order (sum_pairwise), so each lane's result is that of
# its one-lane call whatever the lane count: a library reduction or a
# batched product may pick its order by the number of outputs or lanes.

def color_kernel_gated(fx, fy, mx, my, p: CvoParams):
    """(..., N, M) colour kernel with its gate and both validity masks
    folded in (zero where the colour gate or a mask fails). Features do not
    change during an alignment (only positions transform, cvo.cpp:336-341),
    so an alignment computes it once."""
    d2c = pairwise_sq_dists(fx, fy)
    cgate = (d2c < d2_color_threshold(p)) & mx[..., :, None] \
        & my[..., None, :]
    ck = (p.c_sigma * p.c_sigma) * torch.exp(
        torch.clamp(-d2c / (2.0 * p.c_ell * p.c_ell), min=-20.0))
    return torch.where(cgate, ck, torch.zeros_like(ck))


def cvo_kernel_from_color(x, y, ckg, ell, p: CvoParams):
    """(A, keep), each (..., N, M): the joint kernel of the fixed positions
    x against the moved positions y with the colour factor ckg from
    color_kernel_gated (zero encodes a failed colour gate or mask, so the
    pair fails a > sp_thres); ell one per lane."""
    ell = ell[..., None, None]
    d2 = pairwise_sq_dists(x, y)
    k = (p.sigma * p.sigma) * torch.exp(
        torch.clamp(-d2 / (2.0 * ell * ell), min=-20.0))
    a = ckg * k
    keep = (d2 < d2_threshold(ell, p)) & (a > p.sp_thres)
    return torch.where(keep, a, torch.zeros_like(a)), keep


def flow_from_color(x, y, ckg, ell, p: CvoParams):
    """flow with the colour kernel precomputed by color_kernel_gated (one
    lane): (omega, v, A, nnz)."""
    A, keep = cvo_kernel_from_color(x, y, ckg, ell, p)
    return _flow_from_A(x, y, A, keep, p)


def sum_pairwise(t):
    """Sum over the last axis in a fixed order: zero-padded to a power of
    two, then the upper half added to the lower half, elementwise, until one
    column remains. Every output is summed in the same order whatever the
    leading shape and the device."""
    n = t.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        t = torch.nn.functional.pad(t, (0, size - n))
    while size > 1:
        size //= 2
        t = t[..., :size] + t[..., size:]
    return t[..., 0]


def moment_product(A, U):
    """Mom (..., M, 35) = A^T U per lane: A (..., N, M) and U (N, 35), one
    per lane (..., N, 35), or a list of the lanes' (N, 35); Precision.HIGHEST
    in the JAX package, so f32 products with TF32 off (package init)."""
    if A.dim() == 2:
        return torch.mm(A.T, U)
    lanes = A.reshape(-1, *A.shape[-2:])
    shared = torch.is_tensor(U) and U.dim() == 2
    mom = torch.stack([torch.mm(a.T, U if shared else U[l])
                       for l, a in enumerate(lanes)])
    return mom.reshape(*A.shape[:-2], *mom.shape[-2:])


def _cross3(a, b):
    """a x b of component lists [x, y, z]."""
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _mat3(a, b):
    """a @ b of (..., 3, 3) matrices, written out per entry."""
    return torch.stack([torch.stack([a[..., i, 0] * b[..., 0, j]
                                     + a[..., i, 1] * b[..., 1, j]
                                     + a[..., i, 2] * b[..., 2, j]
                                     for j in range(3)], dim=-1)
                        for i in range(3)], dim=-2)


def _matvec3(a, u, extra=None):
    """a u (+ extra) per point: a (..., 3, 3), u and extra component lists
    of (..., M) or (..., 1)."""
    out = [a[..., i, 0, None] * u[0] + a[..., i, 1, None] * u[1]
           + a[..., i, 2, None] * u[2] for i in range(3)]
    return out if extra is None else [o + e for o, e in zip(out, extra)]


def flow_and_step_from_moments_lanes(Mom, y, center, ell, nnz,
                                     p: CvoParams):
    """The moment-form epilogue over leading lane axes: (omega, v, nnz, B,
    C, D, E) from Mom (..., M, 35), y (..., M, 3), center (..., 3), ell
    (...). The JAX package's flow_and_step_from_moments term for term (the
    xi{k}z from the powers of skew(omega), each coefficient the sum over
    the monomials of the moments' dot products, added in the same order),
    with the products of 3-vectors and 3x3 matrices written out per
    component and every sum over the moving points by sum_pairwise."""
    M0 = Mom[..., 0]
    yc = [y[..., c] for c in range(3)]
    dy = [yc[c] - center[..., c, None] for c in range(3)]
    # D_j = sum_i A_ij (x_i - y_j): locally small; v = -(1/d) sum_j D_j,
    # omega = (1/c) sum_j D_j x y_j
    Dj = [Mom[..., 1 + c] - dy[c] * M0 for c in range(3)]
    s = sum_pairwise(torch.stack(Dj + _cross3(Dj, yc), dim=-2))
    v = -s[..., :3] / p.d
    omega = s[..., 3:] / p.c

    oh = se3.skew(omega)
    oh2 = _mat3(oh, oh)
    oh3 = _mat3(oh2, oh)
    oh4 = _mat3(oh3, oh)
    vc = [v[..., c, None] for c in range(3)]
    xiz = _matvec3(oh, yc, vc)
    xi2z = _matvec3(oh2, yc, _matvec3(oh, vc))
    xi3z = _matvec3(oh3, yc, _matvec3(oh2, vc))
    xi4z = _matvec3(oh4, yc, _matvec3(oh3, vc))
    tc = (1.0 / (2.0 * ell * ell))[..., None]
    two_tc = 2.0 * tc

    def affine(const, u):
        # const_j + (-2tc u_j) . xt
        return {(): const, (0,): -two_tc * u[0], (1,): -two_tc * u[1],
                (2,): -two_tc * u[2]}

    beta = affine(two_tc * _dot3(xiz, dy), xiz)
    gamma = affine(-tc * _dot3(xiz, xiz) + two_tc * _dot3(xi2z, dy), xi2z)
    delta = affine(-two_tc * _dot3(xiz, xi2z) + two_tc * _dot3(xi3z, dy),
                   xi3z)
    epsil = affine(-tc * (_dot3(xi2z, xi2z) + 2.0 * _dot3(xiz, xi3z))
                   + two_tc * _dot3(xi4z, dy), xi4z)
    polys = _quartic_polys(beta, gamma, delta, epsil)
    # every monomial term's sum over the moving points in one call, then
    # each coefficient's terms added in the polynomial's order
    dots = sum_pairwise(torch.stack(
        [coef * Mom[..., _MONO_INDEX[k]] for poly in polys
         for k, coef in poly.items()], dim=-2))
    coefs, first = [], 0
    for poly in polys:
        acc = dots[..., first]
        for i in range(first + 1, first + len(poly)):
            acc = acc + dots[..., i]
        coefs.append(acc)
        first += len(poly)
    return (omega, v, nnz) + tuple(coefs)


def flow_and_step_from_A(A, keep, y, U, center, ell, p: CvoParams):
    """(omega, v, nnz, B, C, D, E) of one lane from its kernel matrix A
    (N, M) and keep mask: the moment product, the kept-pair count and
    flow_and_step_from_moments, the JAX package's epilogue term for
    term."""
    return flow_and_step_from_moments(
        moment_product(A, U), y, center, ell,
        torch.sum(keep, dtype=torch.int32), p)


def flow_and_step_moments(x, y, ckg, U, center, ell, p: CvoParams):
    """One iteration of the JAX package's xla align (compute_flow and
    compute_step_size, cvo.cpp:187-334) in moment form, one lane: (omega,
    v, nnz, B, C, D, E). x/U/center from the fixed cloud
    (step_moment_basis), y the moved positions of the iteration, ckg from
    color_kernel_gated."""
    A, keep = cvo_kernel_from_color(x, y, ckg, ell, p)
    return flow_and_step_from_A(A, keep, y, U, center, ell, p)


def flow_and_step_moments_lanes(x, y, ckg, U, center, ell, p: CvoParams):
    """flow_and_step_moments over leading lane axes (every output with
    them), through flow_and_step_from_moments_lanes: each lane's result is
    that of its one-lane call of this function whatever the lane count."""
    A, keep = cvo_kernel_from_color(x, y, ckg, ell, p)
    return flow_and_step_from_moments_lanes(
        moment_product(A, U), y, center, ell,
        torch.sum(keep, dim=(-2, -1), dtype=torch.int32), p)


# ---------------------------------------------------------------------------
# se3_Hessian via 13x13 weighted moments (cvo.cpp:620-759)
# ---------------------------------------------------------------------------
# Each 6x6 Hessian entry is H[r,c] = il2 * (il2 * <hi_poly> + <lo_poly>)
# where <P> = sum_ij w_ij P(a_i, b_j), w_ij = k_ij (f_a.f_b)_ij gate_ij,
# il2 = 1/l^2, and each poly is degree <=2 in a and <=2 in b — a linear
# functional of the moment matrix G = U_a^T W U_b with U = [1, p, vec(pp^T)].


class _Poly:
    """Tiny polynomial in a0..a2, b0..b2 (degree <=2 per side)."""

    def __init__(self, terms=None):
        self.terms = dict(terms or {})  # {(a_idx_tuple, b_idx_tuple): coef}

    @staticmethod
    def const(c=1.0):
        return _Poly({((), ()): float(c)})

    @staticmethod
    def a(i):
        return _Poly({((i,), ()): 1.0})

    @staticmethod
    def b(i):
        return _Poly({((), (i,)): 1.0})

    def __add__(self, o):
        t = dict(self.terms)
        for k, v in o.terms.items():
            t[k] = t.get(k, 0.0) + v
        return _Poly(t)

    def __sub__(self, o):
        return self + (o * -1.0)

    def __mul__(self, o):
        if isinstance(o, (int, float)):
            return _Poly({k: v * o for k, v in self.terms.items()})
        t = {}
        for (a1, b1), c1 in self.terms.items():
            for (a2, b2), c2 in o.terms.items():
                ka = tuple(sorted(a1 + a2))
                kb = tuple(sorted(b1 + b2))
                assert len(ka) <= 2 and len(kb) <= 2, "degree overflow"
                t[(ka, kb)] = t.get((ka, kb), 0.0) + c1 * c2
        return _Poly(t)

    __rmul__ = __mul__


def _u_index(idx):
    """Map a monomial index tuple to the row of U = [1, p0..p2, vec(pp^T)]."""
    if len(idx) == 0:
        return 0
    if len(idx) == 1:
        return 1 + idx[0]
    p, q = idx
    return 4 + 3 * p + q


@lru_cache(maxsize=1)
def _hessian_polys():
    """The (hi, lo) polynomial pair of each of the 36 Hessian entries,
    mirroring the block formulas of cvo.cpp:666-704, each flattened to
    (rows, cols, coefs) against the 13x13 G."""
    a = [_Poly.a(i) for i in range(3)]
    b = [_Poly.b(i) for i in range(3)]
    zero = _Poly()
    cross = [a[1] * b[2] - a[2] * b[1],
             a[2] * b[0] - a[0] * b[2],
             a[0] * b[1] - a[1] * b[0]]
    diff = [b[i] - a[i] for i in range(3)]
    one = _Poly.const(1.0)

    # Block A (cvo.cpp:666-675)
    A_ = [[None] * 3 for _ in range(3)]
    dots = [a[1] * b[1] + a[2] * b[2],
            a[0] * b[0] + a[2] * b[2],
            a[0] * b[0] + a[1] * b[1]]
    for i in range(3):
        A_[i][i] = (cross[i] * cross[i], zero - dots[i])
    for i, j in ((0, 1), (0, 2), (1, 2)):
        lo = 0.5 * (a[i] * b[j] + a[j] * b[i])
        A_[i][j] = A_[j][i] = (cross[i] * cross[j], lo)

    # Block C (cvo.cpp:677-688): C[r][c]
    C_ = [[None] * 3 for _ in range(3)]
    for i in range(3):
        C_[i][i] = (cross[i] * diff[i], zero)
    C_[1][0] = (diff[1] * cross[0], a[2] * one)
    C_[2][0] = (diff[2] * cross[0], zero - a[1])
    C_[0][1] = (diff[0] * cross[1], zero - a[2])
    C_[2][1] = (diff[2] * cross[1], a[0] * one)
    C_[0][2] = (diff[0] * cross[2], a[1] * one)
    C_[1][2] = (diff[1] * cross[2], zero - a[0])

    # Block D (cvo.cpp:690-697)
    D_ = [[None] * 3 for _ in range(3)]
    for i in range(3):
        D_[i][i] = (diff[i] * diff[i], zero - one)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        D_[i][j] = D_[j][i] = (diff[i] * diff[j], zero)

    # Assemble 6x6: [[A, C^T], [C, D]] (cvo.cpp:699-704)
    H = [[None] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            H[i][j] = A_[i][j]
            H[i][3 + j] = C_[j][i]      # C^T
            H[3 + i][j] = C_[i][j]
            H[3 + i][3 + j] = D_[i][j]

    def compile_poly(poly):
        rows, cols, coefs = [], [], []
        for (ia, ib), c in poly.terms.items():
            if c == 0.0:
                continue
            rows.append(_u_index(ia))
            cols.append(_u_index(ib))
            coefs.append(c)
        return rows, cols, np.array(coefs, np.float32)

    return [[(compile_poly(H[r][c][0]), compile_poly(H[r][c][1]))
             for c in range(6)] for r in range(6)]


def lift_u(pts):
    """(N,3) -> (N,13) moment features U = [1, p, vec(p p^T)]."""
    n = pts.shape[0]
    ones = torch.ones((n, 1), dtype=pts.dtype, device=pts.device)
    outer = (pts[:, :, None] * pts[:, None, :]).reshape(n, 9)
    return torch.cat([ones, pts, outer], dim=1)


@lru_cache(maxsize=None)
def _hessian_operator(device: torch.device):
    """(hi, lo) as (36, 169) f32 matrices on `device`: row 6r+c holds the
    coefficients of Hessian entry (r, c) against the flattened 13x13 G."""
    mats = np.zeros((2, 36, 169), np.float32)
    for r in range(6):
        for c in range(6):
            for side, (rows, cols, coefs) in enumerate(_hessian_polys()[r][c]):
                for i, j, co in zip(rows, cols, coefs):
                    mats[side, 6 * r + c, 13 * i + j] += co
    t = torch.from_numpy(mats).to(device)
    return t[0], t[1]


def assemble_hessian(G, ell):
    """6x6 Hessian from the 13x13 moment matrix G (exact index algebra):
    H = il2 * (il2 * hi + lo) with hi, lo linear in G."""
    il2 = 1.0 / (ell * ell)
    hi_op, lo_op = _hessian_operator(G.device)
    g = G.reshape(169)
    return (il2 * (il2 * (hi_op @ g) + lo_op @ g)).reshape(6, 6)


# ---------------------------------------------------------------------------
# fused inner-product suite (compute_innerproduct, cvo.cpp:475-503)
# ---------------------------------------------------------------------------

def _gated_sum_count(d2, d2c, gate, ell, p: CvoParams):
    """(sum of the joint kernel, pair count) over `gate`."""
    k = (p.sigma * p.sigma) * torch.exp(
        torch.clamp(-d2 / (2.0 * ell * ell), min=-20.0))
    ck = (p.c_sigma * p.c_sigma) * torch.exp(
        torch.clamp(-d2c / (2.0 * p.c_ell * p.c_ell), min=-20.0))
    value = torch.sum(torch.where(gate, ck * k, torch.zeros_like(k)))
    return value, torch.sum(gate, dtype=torch.int32), k


def _floor1(n):
    """Counted inner-product payload floored at 1 (cvo.cpp:454-456)."""
    n = n.to(torch.float32)
    return torch.where(n == 0, torch.ones_like(n), n)


def ip_suite(x, fx, mx, y, fy, my, yt, ell, p: CvoParams):
    """Everything compute_innerproduct needs, with the shared pairwise
    subexpressions computed once: fy.fx serves the color distance of the pre
    and post inner products and the Hessian pair weight (cvo.cpp:652); the
    post inner product and the Hessian share d2(yt, x) (cvo.cpp:485, :500).

    Rows are moving points (y, yt), columns fixed points (x). Returns
    (pre_v, pre_n, post_v, post_n, fixed_v, fixed_n, moving_v, moving_n, G,
    inliers): sums as f32 scalars, *_n the f32 pair counts floored at 1, G
    the (13,13) Hessian moment matrix, inliers the int32 post pair count."""
    d2t = d2_threshold(ell, p)
    d2ct = d2_color_threshold(p)

    def color(fa, ma, fb, mb):
        dots = pair_dots(fa, fb)
        d2c = torch.clamp(sq_norms(fa)[:, None] + sq_norms(fb)[None, :]
                          - 2.0 * dots, min=0.0)
        return d2c, (d2c < d2ct) & ma[:, None] & mb[None, :], dots

    d2c, cgate, cdot = color(fy, my, fx, mx)
    d2_pre = pairwise_sq_dists(y, x)
    pre_v, pre_n, _ = _gated_sum_count(d2_pre, d2c, (d2_pre < d2t) & cgate,
                                       ell, p)
    d2_post = pairwise_sq_dists(yt, x)
    gate_post = (d2_post < d2t) & cgate
    post_v, post_n, k_post = _gated_sum_count(d2_post, d2c, gate_post, ell, p)

    d2c_x, cgate_x, _ = color(fx, mx, fx, mx)
    d2_x = pairwise_sq_dists(x, x)
    fixed_v, fixed_n, _ = _gated_sum_count(d2_x, d2c_x, (d2_x < d2t) & cgate_x,
                                           ell, p)
    d2c_y, cgate_y, _ = color(fy, my, fy, my)
    d2_y = pairwise_sq_dists(y, y)
    moving_v, moving_n, _ = _gated_sum_count(d2_y, d2c_y,
                                             (d2_y < d2t) & cgate_y, ell, p)

    # Hessian moments: weight w = k * (f_a . f_b) over the post gate
    W = torch.where(gate_post, k_post * cdot, torch.zeros_like(cdot))
    G = lift_u(yt).T @ (W @ lift_u(x))
    return (pre_v, _floor1(pre_n), post_v, _floor1(post_n), fixed_v,
            _floor1(fixed_n), moving_v, _floor1(moving_n), G, post_n)


# ---------------------------------------------------------------------------
# one cloud pair (function_inner_product cvo.cpp:388-459, se3_Hessian
# cvo.cpp:620-759) and the loop-closure suite (cvo.cpp:505-561)
# ---------------------------------------------------------------------------

def pair_stats(xa, fa, ma, xb, fb, mb, ell, p: CvoParams,
               with_moments: bool = False):
    """Rows xa (the transformed moving cloud), columns xb (the fixed one).
    Returns (value, num) — the sum of the joint kernel ck * k over the pairs
    passing the geometric and colour gates (no sp_thres test) and the f32
    pair count floored at 1 — and with `with_moments` also (G, inliers):
    G = U(xa)^T W U(xb) with W = gate * k * (fa . fb), inliers the int32
    pair count. Distances use the dot-product identity, as the suite."""
    cdot = pair_dots(fa, fb)
    d2c = torch.clamp(sq_norms(fa)[:, None] + sq_norms(fb)[None, :]
                      - 2.0 * cdot, min=0.0)
    d2 = pairwise_sq_dists(xa, xb)
    gate = (d2 < d2_threshold(ell, p)) & (d2c < d2_color_threshold(p)) \
        & ma[:, None] & mb[None, :]
    value, n, k = _gated_sum_count(d2, d2c, gate, ell, p)
    if not with_moments:
        return value, _floor1(n)
    W = torch.where(gate, k * cdot, torch.zeros_like(cdot))
    G = lift_u(xa).T @ (W @ lift_u(xb))
    return value, _floor1(n), G, n


def inner_product(xa, fa, ma, xb, fb, mb, ell, p: CvoParams):
    """RKHS inner product <f_a, f_b> (cvo.cpp:428-447): (value, num >= 1)."""
    return pair_stats(xa, fa, ma, xb, fb, mb, ell, p)


def hessian_moments(xa, fa, ma, xb, fb, mb, ell, p: CvoParams):
    """Weighted moment matrix G (13,13) and inlier count for se3_Hessian
    (cvo.cpp:648-662); xa the transformed moving cloud, xb the fixed one."""
    return pair_stats(xa, fa, ma, xb, fb, mb, ell, p, with_moments=True)[2:]


def se3_hessian_raw(xa, fa, ma, xb, fb, mb, ell, p: CvoParams):
    """Unscaled 6x6 Hessian sum (before the -1/1e5 scaling and eigenvalue
    floor of cvo.cpp:726-754, engine.hessian_postprocess) and inliers."""
    G, inliers = hessian_moments(xa, fa, ma, xb, fb, mb, ell, p)
    return assemble_hessian(G, ell), inliers


def ip_suite_lc(x, fx, mx, y, fy, my, y_prior, y_lcp, y_lcp2, y_lc, ell,
                p: CvoParams):
    """Everything compute_innerproduct_lc needs (cvo.cpp:505-561), with one
    feature product shared by the six pair sets: inner products of the
    moving cloud under four transforms against the fixed cloud, both self
    norms, the Hessian moments of the CVO result (y_lc) and the gated-pair
    count under the second prior (y_lcp2). Returns (prior_v, lcp_v, pre_v,
    post_v, fixed_v, moving_v, G, inliers_svd, inliers_pnp)."""
    d2t = d2_threshold(ell, p)
    d2ct = d2_color_threshold(p)
    cdot = pair_dots(fy, fx)
    d2c = torch.clamp(sq_norms(fy)[:, None] + sq_norms(fx)[None, :]
                      - 2.0 * cdot, min=0.0)
    cgate = (d2c < d2ct) & my[:, None] & mx[None, :]

    def against_fixed(yk):
        d2 = pairwise_sq_dists(yk, x)
        gate = (d2 < d2t) & cgate
        value, n, k = _gated_sum_count(d2, d2c, gate, ell, p)
        return value, n, gate, k

    prior_v = against_fixed(y_prior)[0]
    lcp_v = against_fixed(y_lcp)[0]
    pre_v = against_fixed(y)[0]
    post_v, inliers_svd, gate_post, k_post = against_fixed(y_lc)
    inliers_pnp = against_fixed(y_lcp2)[1]

    def self_norm(a, fa, ma):
        d2 = pairwise_sq_dists(a, a)
        d2c_s = pairwise_sq_dists(fa, fa)
        gate = (d2 < d2t) & (d2c_s < d2ct) & ma[:, None] & ma[None, :]
        return _gated_sum_count(d2, d2c_s, gate, ell, p)[0]

    W = torch.where(gate_post, k_post * cdot, torch.zeros_like(cdot))
    G = lift_u(y_lc).T @ (W @ lift_u(x))
    return (prior_v, lcp_v, pre_v, post_v, self_norm(x, fx, mx),
            self_norm(y, fy, my), G, inliers_svd, inliers_pnp)
