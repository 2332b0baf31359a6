"""The cells' frames, rendered on the card from a seed.

A torch copy of the port's synthetic RGB-D generator
(cvo_slam_tpu_torch/data/synthetic.py: the wavy textured sheet, the
multi-surface slabs, the 3x supersampled forward splat and the Kinect
sensor model) and of the suite's trajectories (cvo_slam_tpu_torch/eval/
suite.py: loop_trajectory, oscillating_trajectory). It imports nothing of
the port. Where it differs from the numpy generator:

  * random numbers come from torch generators (the scene and the sensor
    noise from one on the device, the slabs' placement from one on the
    host), so a seed gives other pixels than the numpy generator's seed;
  * resizing is torch's (bicubic and bilinear, half-pixel centres, edge
    replicated), not cv2's fixed-point arithmetic: a colour may differ by
    one DN where both splat the same source point;
  * the splat is a z-buffer: per pixel the nearest point wins, and of
    points at the same depth the one with the largest source index, which
    is the point the numpy generator's far-to-near stable sort writes last.
    It is taken by two `scatter_reduce` passes (the least depth, then the
    largest index among the points at it), so it is deterministic.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import torch
import torch.nn.functional as F

SUPERSAMPLE = 3   # the numpy generator's SS for extent 1


# ---------------------------------------------------------------------------
# trajectories (eval/suite.py), world->camera transforms G_k, p_k = G_k p_0
# ---------------------------------------------------------------------------

def _skew(w):
    z = torch.zeros((), dtype=w.dtype)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def se3_exp(twist) -> np.ndarray:
    """The float32 SE(3) exponential of the port's ops.se3.exp_se3 (twist
    [w, v]), computed on the host and returned as float64."""
    xi = torch.as_tensor(np.asarray(twist, np.float32))
    w, v = xi[:3], xi[3:6]
    theta = torch.sqrt(torch.clamp(torch.sum(w * w), min=0.0))
    eye = torch.eye(3, dtype=torch.float32)
    if float(theta) < 1e-6:
        R, J = eye, eye
    else:
        A = _skew(w)
        A2 = A @ A
        R = eye + (torch.sin(theta) / theta) * A \
            + ((1.0 - torch.cos(theta)) / (theta * theta)) * A2
        J = eye + ((1.0 - torch.cos(theta)) / (theta * theta)) * A \
            + ((theta - torch.sin(theta)) / theta ** 3) * A2
    G = np.eye(4)
    G[:3, :3] = R.numpy()
    G[:3, 3] = (J @ v[:, None])[:, 0].numpy()
    return G


def loop_trajectory(n: int, radius: float = 0.22, lift: float = 0.10,
                    yaw_amp: float = 0.12):
    """Closed circuit with G_0 = G_n = I (a strafe around a small circle
    with an oscillating yaw)."""
    out = []
    for k in range(n):
        th = 2.0 * np.pi * k / n
        yaw = yaw_amp * np.sin(th)
        c, s = np.cos(yaw), np.sin(yaw)
        G = np.eye(4)
        G[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        G[:3, 3] = [radius * np.sin(th), lift * (1 - np.cos(th)), 0.0]
        out.append(G)
    return out


def oscillating_trajectory(n: int, amp_twist, period: float = 40.0):
    """G_k = exp(sin(2 pi k / period) * amp_twist): a swing about the
    scene, periodic with `period` frames."""
    amp = np.asarray(amp_twist, np.float32)
    return [se3_exp(amp * np.sin(2.0 * np.pi * k / period))
            for k in range(n)]


def trajectory(spec: dict):
    """The trajectory a traffic file names (its "trajectory" object)."""
    kind = spec["kind"]
    if kind == "loop":
        return loop_trajectory(spec["frames"], spec["radius"], spec["lift"],
                               spec["yaw_amp"])
    if kind == "oscillating":
        return oscillating_trajectory(spec["frames"], spec["amp_twist"],
                                      spec["period"])
    raise ValueError(f"unknown trajectory kind {kind!r}")


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------

def generators(seed: int, device):
    """(host, device) torch generators seeded from `seed`."""
    host = torch.Generator()
    host.manual_seed(int(seed))
    dev = torch.Generator(device=device)
    dev.manual_seed(int(seed))
    return host, dev


def _resize(img, h: int, w: int, mode: str):
    """(H, W) or (H, W, C) float tensor resized to (h, w)."""
    t = img.permute(2, 0, 1)[None] if img.dim() == 3 else img[None, None]
    out = F.interpolate(t, size=(h, w), mode=mode, align_corners=False)
    return out[0].permute(1, 2, 0) if img.dim() == 3 else out[0, 0]


def _to_u8(t):
    """numpy's clip(0, 255).astype(uint8): truncation."""
    return torch.clamp(t, 0, 255).to(torch.uint8)


def base_scene(cam: dict, host_gen, dev_gen, multi_surface: bool, device):
    """(bgr (H, W, 3) uint8, z (H, W) float64 metres) of frame 0: a smooth
    random texture on a wavy sheet ~2 m away and, with multi_surface, three
    textured slabs 0.9-1.6 m away (the numpy generator's _base_scene at
    extent 1 and full texture)."""
    H, W = cam["height"], cam["width"]
    base = 255.0 * torch.rand((max(H // 8, 2), max(W // 8, 2)),
                              generator=dev_gen, device=device)
    tex = _resize(base, H, W, "bicubic")
    bgr = _to_u8(torch.stack([tex, tex.roll(3, 0), tex.roll(5, 1)], -1))
    lin_w = torch.linspace(0, 3, W, dtype=torch.float64, device=device)
    lin_h = torch.linspace(0, 2, H, dtype=torch.float64, device=device)
    z = 2.0 + 0.5 * torch.sin(lin_w)[None, :] + 0.3 * torch.cos(lin_h)[:, None]
    if multi_surface:
        for _ in range(3):
            u = torch.rand(5, generator=host_gen, dtype=torch.float64).tolist()
            sw = int((0.12 + 0.18 * u[0]) * W)
            sh = int((0.12 + 0.18 * u[1]) * H)
            x0 = int(u[2] * (W - sw))
            y0 = int(u[3] * (H - sh))
            zs = 0.9 + 0.7 * u[4]
            small = 255.0 * torch.rand((max(sh // 6, 2), max(sw // 6, 2)),
                                       generator=dev_gen, device=device)
            slab = _resize(small, sh, sw, "bicubic")
            wave = 0.03 * torch.sin(torch.linspace(
                0, 4, sw, dtype=torch.float64, device=device))[None, :]
            z[y0:y0 + sh, x0:x0 + sw] = zs + wave
            for c, roll in ((0, 0), (1, 2), (2, 4)):
                bgr[y0:y0 + sh, x0:x0 + sw, c] = _to_u8(slab.roll(roll, 0))
    return bgr, z


class Renderer:
    """Frames of one scene: frame k seen by the camera G_k (p_k = G_k p_0)
    by a forward splat of the 3x supersampled frame-0 surface."""

    def __init__(self, bgr0, z0, cam: dict):
        self.cam = cam
        self.bgr0, self.z0 = bgr0, z0
        H, W = cam["height"], cam["width"]
        Hs, Ws = H * SUPERSAMPLE, W * SUPERSAMPLE
        dev = z0.device
        colors = _resize(bgr0.float(), Hs, Ws, "bilinear")
        self.colors = torch.clamp(torch.round(colors), 0, 255).to(
            torch.uint8).reshape(-1, 3)
        zs = _resize(z0, Hs, Ws, "bilinear")
        ys, xs = torch.meshgrid(
            torch.arange(Hs, dtype=torch.float64, device=dev),
            torch.arange(Ws, dtype=torch.float64, device=dev), indexing="ij")
        xf = (xs + 0.5) / SUPERSAMPLE - 0.5
        yf = (ys + 0.5) / SUPERSAMPLE - 0.5
        self.P0 = torch.stack([(xf - cam["cx"]) * zs / cam["fx"],
                               (yf - cam["cy"]) * zs / cam["fy"], zs],
                              -1).reshape(-1, 3)
        self.index = torch.arange(self.P0.shape[0], device=dev)

    def clean(self, G: np.ndarray, first: bool = False):
        """(bgr (H, W, 3) uint8, depth (H, W) int32 raw units) of the pose
        G; `first` and G = I give frame 0 itself, as the numpy generator
        writes it."""
        cam = self.cam
        H, W, df = cam["height"], cam["width"], cam["depth_factor"]
        if first and np.allclose(G, np.eye(4)):
            return self.bgr0.clone(), (self.z0 * df).to(torch.int32)
        Gt = torch.as_tensor(G, dtype=torch.float64, device=self.P0.device)
        Pw = self.P0 @ Gt[:3, :3].T + Gt[:3, 3]
        zw = Pw[:, 2]
        u = torch.round(Pw[:, 0] / zw * cam["fx"] + cam["cx"]).to(torch.int64)
        v = torch.round(Pw[:, 1] / zw * cam["fy"] + cam["cy"]).to(torch.int64)
        m = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (zw > 0.1)
        pix, zm, idx = (v * W + u)[m], zw[m], self.index[m]
        zmin = torch.full((H * W,), math.inf, dtype=zw.dtype,
                          device=zw.device).scatter_reduce(
            0, pix, zm, "amin", include_self=True)
        at = zm == zmin[pix]
        win = torch.full((H * W,), -1, dtype=torch.int64,
                         device=zw.device).scatter_reduce(
            0, pix[at], idx[at], "amax", include_self=True)
        has = win >= 0
        bgr = torch.zeros((H * W, 3), dtype=torch.uint8, device=zw.device)
        depth = torch.zeros(H * W, dtype=torch.int32, device=zw.device)
        bgr[has] = self.colors[win[has]]
        depth[has] = (zw[win[has]] * df).to(torch.int32)
        return bgr.reshape(H, W, 3), depth.reshape(H, W)

    def pixel_shift(self, G, G_prev):
        """Apparent motion (px) of the scene centre from G_prev to G, which
        sets the motion blur."""
        cam = self.cam
        zc = float(torch.median(self.z0))
        Pc = np.array([0.0, 0.0, zc])
        cur = G[:3, :3] @ Pc + G[:3, 3]
        prv = G_prev[:3, :3] @ Pc + G_prev[:3, 3]
        return ((cur[0] / cur[2] - prv[0] / prv[2]) * cam["fx"],
                (cur[1] / cur[2] - prv[1] / prv[2]) * cam["fy"])


def _blur_kernel(pixel_shift):
    """The numpy generator's directional box blur along the motion, or
    None below two pixels."""
    shift = float(np.hypot(pixel_shift[0], pixel_shift[1]))
    if shift <= 0.5:
        return None
    L = int(min(np.ceil(shift), 9))
    if L < 2:
        return None
    kern = np.zeros((L, L), np.float32)
    ang = np.arctan2(pixel_shift[1], pixel_shift[0])
    c = (L - 1) / 2.0
    for t in np.linspace(-0.5, 0.5, 2 * L + 1):
        px = c + t * (L - 1) * np.cos(ang)
        py = c + t * (L - 1) * np.sin(ang)
        kern[int(round(py)), int(round(px))] += 1.0
    return kern / kern.sum()


def sensor_noise(bgr, depth, cam: dict, gen, pixel_shift,
                 depth_sigma=(0.0012, 0.0019), depth_quant=2.85e-5,
                 edge_dropout=0.6, speckle_dropout=0.01, rgb_sigma=2.5):
    """The Kinect-like sensor model of the numpy generator
    (apply_sensor_noise): axial depth noise a + b (z - 0.4)^2, disparity
    quantisation depth_quant z^2, dropout on depth edges and speckle, RGB
    read noise and a motion blur along the image motion."""
    df = cam["depth_factor"]
    z = depth.to(torch.float64) / df
    valid = z > 0
    a, b = depth_sigma
    sig = a + b * torch.clamp(z - 0.4, min=0.0) ** 2
    zn = z + torch.randn(z.shape, generator=gen, device=z.device,
                         dtype=torch.float64) * sig
    dz = depth_quant * torch.clamp(zn, min=0.3) ** 2
    zn = torch.where(dz > 0, torch.round(zn / torch.clamp(dz, min=1e-9)) * dz,
                     zn)
    gx = torch.abs(torch.diff(z, dim=1, prepend=z[:, :1]))
    gy = torch.abs(torch.diff(z, dim=0, prepend=z[:1, :]))
    edge = (torch.maximum(gx, gy) > 0.04) & valid
    u1 = torch.rand(z.shape, generator=gen, device=z.device)
    u2 = torch.rand(z.shape, generator=gen, device=z.device)
    drop = (edge & (u1 < edge_dropout)) | (valid & (u2 < speckle_dropout))
    zn = torch.where(valid & ~drop, zn, torch.zeros_like(zn))
    depth_out = torch.clamp(zn * df, 0, 65535).to(torch.int32)

    out = bgr.to(torch.float32)
    kern = _blur_kernel(pixel_shift)
    if kern is not None:
        L = kern.shape[0]
        lo, hi = L // 2, L - 1 - L // 2     # cv2.filter2D's centred anchor
        img = out.permute(2, 0, 1)[None]
        img = F.pad(img, (lo, hi, lo, hi), mode="reflect")
        k = torch.as_tensor(kern, device=out.device)[None, None].repeat(
            3, 1, 1, 1)
        out = F.conv2d(img, k, groups=3)[0].permute(1, 2, 0)
    if rgb_sigma > 0:
        out = out + rgb_sigma * torch.randn(out.shape, generator=gen,
                                            device=out.device)
    return _to_u8(out), depth_out


def render_lap(cam: dict, traffic: dict, seed: int, device):
    """The lap of a traffic mix: a list of (bgr, depth) device tensors, one
    per pose of its trajectory. The scene comes from the mix's own scene
    seed, the same for every run, so that each run does the same work; the
    sensor noise of every frame from the mix's noise seed where it has one
    (where the noise would change the work: keyframe events, loop-closure
    rounds), else from the run's seed."""
    scene = traffic["scene"]
    host_gen, scene_gen = generators(scene["seed"], device)
    _, dev_gen = generators(scene.get("noise_seed", seed), device)
    bgr0, z0 = base_scene(cam, host_gen, scene_gen, scene["multi_surface"],
                          device)
    r = Renderer(bgr0, z0, cam)
    frames = []
    G_prev = np.eye(4)
    for k, G in enumerate(trajectory(traffic["trajectory"])):
        bgr, depth = r.clean(G, first=k == 0)
        if scene["noise"]:
            bgr, depth = sensor_noise(bgr, depth, cam, dev_gen,
                                      r.pixel_shift(G, G_prev))
        frames.append((bgr, depth))
        G_prev = G
    return frames


def frame_paths(k: int):
    """The TUM-style relative paths of lap frame k."""
    return f"rgb/{k:04d}.png", f"depth/{k:04d}.png"


def write_lap(folder: str, frames, workers: int = 4):
    """Write the lap's frames as TUM-format PNGs (8-bit BGR, 16-bit depth)
    under `folder`; PNG level 1 keeps the write short."""
    os.makedirs(os.path.join(folder, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(folder, "depth"), exist_ok=True)
    host = [(b.cpu().numpy(), d.cpu().numpy().astype(np.uint16))
            for b, d in frames]
    flags = [cv2.IMWRITE_PNG_COMPRESSION, 1]

    def write(k):
        rgb, dep = frame_paths(k)
        ok = cv2.imwrite(os.path.join(folder, rgb), host[k][0], flags) \
            and cv2.imwrite(os.path.join(folder, dep), host[k][1], flags)
        if not ok:
            raise OSError(f"could not write frame {k} under {folder}")

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(write, range(len(host))))
