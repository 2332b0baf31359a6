"""The pairwise passes of tracking and loop-closure verification:
hand-written CUDA kernels (csrc/moment_flow_step.cu, csrc/ip_suite.cu), each
beside its plain PyTorch version.

  * `moment_flow_step`: one align iteration (cvo.cpp:187-334). The kernel
    computes the moment matrix Mom (M, 35) and the kept-pair count nnz; the
    O(M) epilogue ops.pairwise.flow_and_step_from_moments gives
    (omega, v, nnz, B, C, D, E).
  * `ip_suite`: the pairwise work of compute_innerproduct (cvo.cpp:475-503):
    four gated inner products with their pair counts and the 13x13 Hessian
    moment matrix G.
  * `pair_stats`: one gated inner product of a cloud pair with its pair
    count and, on request, the Hessian moments G (function_inner_product
    and se3_Hessian, cvo.cpp:388-459, :620-759), the single-pair-set mode
    of the suite kernel; compute_innerproduct_lc launches it 6 + 2 times.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel (building it on first use) or raises. Each
wrapper counts its launches in `KernelInfo.launches`, and nowhere else.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..config import CvoParams
from ..ops import pairwise
from . import cuda_build

N_CHUNKS = 8     # split of the column range across blocks (fills 132 SMs)
_TILE = 128      # rows per block, as in csrc/


@dataclass
class KernelInfo:
    name: str
    source: str      # file under csrc/
    replaces: str    # the Pallas kernel's pallas_call, file:line
    launches: int = 0


MOMENT = KernelInfo("moment_flow_step", "moment_flow_step.cu",
                    "cvo_slam_tpu/cvo/pallas_kernels.py:973")
IP_SUITE = KernelInfo("ip_suite", "ip_suite.cu",
                      "cvo_slam_tpu/cvo/pallas_kernels.py:802")
PAIR_STATS = KernelInfo("pair_stats", "ip_suite.cu",
                        "cvo_slam_tpu/cvo/pallas_kernels.py:418")
KERNELS = (MOMENT, IP_SUITE, PAIR_STATS)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def _as_ell(ell, device):
    return torch.as_tensor(ell, dtype=torch.float32, device=device).reshape(())


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_cloud(prefix, pos, feat, mask, n, device):
    _check(prefix + " positions", pos, torch.float32, (n, 3), device)
    _check(prefix + " features", feat, torch.float32, (n, 5), device)
    _check(prefix + " mask", mask, torch.bool, (n,), device)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# moment pass of one align iteration
# ---------------------------------------------------------------------------

def moment_pass_plain(x, y, fx, fy, mx, my, U, ell, p: CvoParams):
    """(Mom (M, 35), nnz int32): Mom[j] = sum_i keep_ij a_ij U[i],
    nnz = sum keep. Distances are explicit differences (as in the Pallas
    kernel), one fused exponential with its clamp at -20."""
    ell = _as_ell(ell, x.device)
    d2t = pairwise.d2_threshold(ell, p)
    inv2l2 = 1.0 / (2.0 * ell * ell)

    def sq_diffs(a, b):
        e = a[:, None, 0] - b[None, :, 0]
        out = e * e
        for c in range(1, a.shape[1]):
            e = a[:, None, c] - b[None, :, c]
            out = out + e * e
        return out

    d2 = sq_diffs(x, y)
    d2c = sq_diffs(fx, fy)
    gate = (d2 < d2t) & (d2c < pairwise.d2_color_threshold(p)) \
        & mx[:, None] & my[None, :]
    a = _s2cs2(p) * torch.exp(
        torch.clamp(-(d2 * inv2l2 + d2c * _inv2cl2(p)), min=-20.0))
    keep = gate & (a > p.sp_thres)
    A = torch.where(keep, a, torch.zeros_like(a))
    return (U.T @ A).T, torch.sum(keep, dtype=torch.int32)


def _s2cs2(p: CvoParams) -> float:
    return p.sigma * p.sigma * p.c_sigma * p.c_sigma


def _inv2cl2(p: CvoParams) -> float:
    return 1.0 / (2.0 * p.c_ell * p.c_ell)


def moment_pass_cuda(x, y, fx, fy, mx, my, U, ell, p: CvoParams):
    """The CUDA moment kernel: same function as moment_pass_plain."""
    dev = x.device
    n, m = x.shape[0], y.shape[0]
    _check_cloud("fixed", x, fx, mx, n, dev)
    _check_cloud("moving", y, fy, my, m, dev)
    _check("U", U, torch.float32, (n, pairwise.N_MOMENTS), dev)
    ell = _as_ell(ell, dev).contiguous()
    lib = cuda_build.load(MOMENT.source)
    fn = lib.moment_flow_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 5)
    mom_part = torch.empty((N_CHUNKS, pairwise.N_MOMENTS, m),
                           dtype=torch.float32, device=dev)
    nnz_part = torch.empty((N_CHUNKS * -(-m // _TILE),), dtype=torch.int32,
                           device=dev)
    momT = torch.empty((pairwise.N_MOMENTS, m), dtype=torch.float32,
                       device=dev)
    nnz = torch.empty((), dtype=torch.int32, device=dev)
    err = fn(_ptr(x), _ptr(fx), _ptr(mx), _ptr(U), _ptr(y), _ptr(fy),
             _ptr(my), _ptr(ell), n, m, N_CHUNKS,
             pairwise.log_sp_ratio(p), pairwise.d2_color_threshold(p),
             _inv2cl2(p), _s2cs2(p), p.sp_thres,
             _ptr(mom_part), _ptr(nnz_part), _ptr(momT), _ptr(nnz),
             _stream(dev))
    _raise_on(err, MOMENT.name)
    MOMENT.launches += 1
    return momT.T, nnz


def moment_pass(x, y, fx, fy, mx, my, U, ell, p: CvoParams):
    if x.device.type == "cpu":
        return moment_pass_plain(x, y, fx, fy, mx, my, U, ell, p)
    if x.device.type == "cuda":
        return moment_pass_cuda(x, y, fx, fy, mx, my, U, ell, p)
    raise ValueError(f"unsupported device {x.device}")


def moment_flow_step(x, y, fx, fy, mx, my, U, center, ell, p: CvoParams):
    """One align iteration: (omega, v, nnz, B, C, D, E).

    x/fx/mx: the fixed cloud; y: the moving positions transformed by the
    current estimate, fy/my its features and mask; (center, U): the fixed
    cloud's moment basis (pairwise.step_moment_basis)."""
    ell = _as_ell(ell, x.device)
    Mom, nnz = moment_pass(x, y, fx, fy, mx, my, U, ell, p)
    return pairwise.flow_and_step_from_moments(Mom, y, center, ell, nnz, p)


def moment_flow_step_plain(x, y, fx, fy, mx, my, U, center, ell,
                           p: CvoParams):
    """moment_flow_step through the plain version on any device."""
    ell = _as_ell(ell, x.device)
    Mom, nnz = moment_pass_plain(x, y, fx, fy, mx, my, U, ell, p)
    return pairwise.flow_and_step_from_moments(Mom, y, center, ell, nnz, p)


# ---------------------------------------------------------------------------
# inner-product suite of compute_innerproduct
# ---------------------------------------------------------------------------

def ip_suite_plain(x, fx, mx, y, fy, my, yt, ell, p: CvoParams):
    """pairwise.ip_suite: the plain version of the suite kernel."""
    return pairwise.ip_suite(x, fx, mx, y, fy, my, yt,
                             _as_ell(ell, x.device), p)


def ip_suite_cuda(x, fx, mx, y, fy, my, yt, ell, p: CvoParams):
    """The CUDA suite kernel: same function and tuple as ip_suite_plain."""
    dev = x.device
    n, m = x.shape[0], y.shape[0]
    _check_cloud("fixed", x, fx, mx, n, dev)
    _check_cloud("moving", y, fy, my, m, dev)
    _check("yt", yt, torch.float32, (m, 3), dev)
    ell = _as_ell(ell, dev).contiguous()
    lib = cuda_build.load(IP_SUITE.source)
    fn = lib.ip_suite_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 7)
    parts = N_CHUNKS * -(-max(n, m) // _TILE)
    sum_part = torch.empty((parts, 4), dtype=torch.float32, device=dev)
    cnt_part = torch.empty((parts, 4), dtype=torch.int32, device=dev)
    wu_part = torch.empty((N_CHUNKS, 13, m), dtype=torch.float32, device=dev)
    g_part = torch.empty((-(-m // _TILE), 169), dtype=torch.float32,
                         device=dev)
    out_f = torch.empty((173,), dtype=torch.float32, device=dev)
    out_n = torch.empty((4,), dtype=torch.int32, device=dev)
    err = fn(_ptr(x), _ptr(fx), _ptr(mx), _ptr(y), _ptr(fy), _ptr(my),
             _ptr(yt), _ptr(ell), n, m, N_CHUNKS,
             pairwise.log_sp_ratio(p), pairwise.d2_color_threshold(p),
             p.sigma * p.sigma, p.c_sigma * p.c_sigma,
             2.0 * p.c_ell * p.c_ell,
             _ptr(sum_part), _ptr(cnt_part), _ptr(wu_part), _ptr(g_part),
             _ptr(out_f), _ptr(out_n), _stream(dev))
    _raise_on(err, IP_SUITE.name)
    IP_SUITE.launches += 1
    G = out_f[:169].reshape(13, 13)
    s = out_f[169:173]
    n_f = torch.where(out_n == 0, torch.ones_like(out_n), out_n).float()
    return (s[0], n_f[0], s[1], n_f[1], s[2], n_f[2], s[3], n_f[3], G,
            out_n[1])


def ip_suite(x, fx, mx, y, fy, my, yt, ell, p: CvoParams):
    """(pre_v, pre_n, post_v, post_n, fixed_v, fixed_n, moving_v, moving_n,
    G, inliers): x/fx/mx the fixed cloud, y/fy/my the moving one, yt the
    moving positions under the registration result."""
    if x.device.type == "cpu":
        return ip_suite_plain(x, fx, mx, y, fy, my, yt, ell, p)
    if x.device.type == "cuda":
        return ip_suite_cuda(x, fx, mx, y, fy, my, yt, ell, p)
    raise ValueError(f"unsupported device {x.device}")


# ---------------------------------------------------------------------------
# pair stats of compute_innerproduct_lc (one pair set of the suite)
# ---------------------------------------------------------------------------

def pair_stats_plain(xa, fa, ma, xb, fb, mb, ell, p: CvoParams,
                     with_moments: bool = False):
    """pairwise.pair_stats: the plain version of the pair-stats kernel."""
    return pairwise.pair_stats(xa, fa, ma, xb, fb, mb,
                               _as_ell(ell, xa.device), p, with_moments)


def pair_stats_cuda(xa, fa, ma, xb, fb, mb, ell, p: CvoParams,
                    with_moments: bool = False):
    """The CUDA pair-stats kernel: same function and tuple as
    pair_stats_plain."""
    dev = xa.device
    n, m = xa.shape[0], xb.shape[0]
    _check_cloud("row", xa, fa, ma, n, dev)
    _check_cloud("column", xb, fb, mb, m, dev)
    ell = _as_ell(ell, dev).contiguous()
    lib = cuda_build.load(PAIR_STATS.source)
    fn = lib.pair_stats_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 7)
    row_blocks = -(-n // _TILE)
    sum_part = torch.empty((N_CHUNKS * row_blocks, 4), dtype=torch.float32,
                           device=dev)
    cnt_part = torch.empty((N_CHUNKS * row_blocks, 4), dtype=torch.int32,
                           device=dev)
    wu_part = torch.empty((N_CHUNKS, 13, n) if with_moments else (1,),
                          dtype=torch.float32, device=dev)
    g_part = torch.empty((row_blocks, 169) if with_moments else (1,),
                         dtype=torch.float32, device=dev)
    out_f = torch.empty((173,), dtype=torch.float32, device=dev)
    out_n = torch.empty((4,), dtype=torch.int32, device=dev)
    err = fn(_ptr(xa), _ptr(fa), _ptr(ma), _ptr(xb), _ptr(fb), _ptr(mb),
             _ptr(ell), n, m, N_CHUNKS, int(with_moments),
             pairwise.log_sp_ratio(p), pairwise.d2_color_threshold(p),
             p.sigma * p.sigma, p.c_sigma * p.c_sigma,
             2.0 * p.c_ell * p.c_ell,
             _ptr(sum_part), _ptr(cnt_part), _ptr(wu_part), _ptr(g_part),
             _ptr(out_f), _ptr(out_n), _stream(dev))
    _raise_on(err, PAIR_STATS.name)
    PAIR_STATS.launches += 1
    count = out_n[0]
    num = torch.where(count == 0, torch.ones_like(count), count).float()
    if not with_moments:
        return out_f[169], num
    return out_f[169], num, out_f[:169].reshape(13, 13), count


def pair_stats(xa, fa, ma, xb, fb, mb, ell, p: CvoParams,
               with_moments: bool = False):
    """(value, num) of the gated inner product of rows xa/fa/ma against
    columns xb/fb/mb, and with `with_moments` also (G (13, 13), inliers)."""
    if xa.device.type == "cpu":
        return pair_stats_plain(xa, fa, ma, xb, fb, mb, ell, p, with_moments)
    if xa.device.type == "cuda":
        return pair_stats_cuda(xa, fa, ma, xb, fb, mb, ell, p, with_moments)
    raise ValueError(f"unsupported device {xa.device}")
