"""Device-side frontend: pyramid, DSO selection and back-projection as
tensor code on the device (port of cvo_slam_tpu.frontend.device).

The same semantics as the host frontend (pyramid.py / selector.py /
pointcloud.py, re-expressions of reference pcd_generator.cpp:50-143 and
PixelSelector2.cpp), operation for operation:

  * pyramid: 2x2 box downsample + flattened central-difference gradients
    (the reference's row-wrap quirk at columns 0 / w-1 included);
  * make_hists: per-32x32-block integer histograms (one bincount), the
    computeHistQuantil walk as a cumsum threshold, 3x3 count-aware
    smoothing;
  * select: per-pot-block argmax hierarchy with the level-1 lock
    (PixelSelector2.cpp:417-421); ties go to the first pixel in raster
    order, as the host's argmax; `pot` is a Python int per pass of the
    host-side potential loop (make_maps), which visits the values the host
    selector visits;
  * the glibc-rand sub-sample pattern comes from selector.random_pattern
    (bit-exact) and is applied on the device with a cumsum rank;
  * back-projection writes the fixed-capacity Morton-ordered cloud
    (positions / features / mask + selected pixels) on the device; the
    Morton sort is stable, as the host's.

The host frontend stays the default of the streaming CLI (it overlaps the
device work through data.prefetch); create_pointcloud_device is the
on-device alternative and never calls the host frontend.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CameraConfig, FrontendParams
from ..device import resolve_device
from . import selector as host_selector

SETTING_GRAD_DOWNWEIGHT = host_selector.SETTING_GRAD_DOWNWEIGHT
SETTING_MIN_GRAD_HIST_CUT = host_selector.SETTING_MIN_GRAD_HIST_CUT
SETTING_MIN_GRAD_HIST_ADD = host_selector.SETTING_MIN_GRAD_HIST_ADD


# ---------------------------------------------------------------------------
# pyramid (pcd_generator.cpp:50-143)
# ---------------------------------------------------------------------------

def make_pyramid(gray: torch.Tensor, levels: int = 3):
    """gray (H, W) -> per-level lists (intensity, dx, dy, absgrad), f32."""
    intensity, dxs, dys, absgrads = [], [], [], []
    cur = gray.to(torch.float32)
    hl, wl = gray.shape
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
        dx = torch.zeros_like(flat)
        dy = torch.zeros_like(flat)
        dx[wl:wl * (hl - 1)] = 0.5 * (flat[wl + 1: wl * (hl - 1) + 1]
                                      - flat[wl - 1: wl * (hl - 1) - 1])
        dy[wl:wl * (hl - 1)] = 0.5 * (flat[2 * wl: wl * hl]
                                      - flat[0: wl * (hl - 2)])
        intensity.append(cur)
        dxs.append(dx.reshape(hl, wl))
        dys.append(dy.reshape(hl, wl))
        absgrads.append((dx * dx + dy * dy).reshape(hl, wl))
    return intensity, dxs, dys, absgrads


# ---------------------------------------------------------------------------
# make_hists (PixelSelector2.cpp:71-136)
# ---------------------------------------------------------------------------

def make_hists(absgrad0: torch.Tensor) -> torch.Tensor:
    """Per-32x32-block smoothed squared thresholds (h32, w32) f32."""
    h, w = absgrad0.shape
    h32, w32 = h // 32, w // 32
    dev = absgrad0.device
    g = torch.clamp(torch.sqrt(absgrad0).to(torch.int64), max=48)
    valid = torch.zeros((h, w), dtype=torch.bool, device=dev)
    valid[1:h - 1, 1:w - 1] = True
    gb = g[:h32 * 32, :w32 * 32].reshape(h32, 32, w32, 32)
    vb = valid[:h32 * 32, :w32 * 32].reshape(h32, 32, w32, 32)
    block_id = (torch.arange(h32, device=dev)[:, None, None, None] * w32
                + torch.arange(w32, device=dev)[None, None, :, None])
    keys = torch.where(vb, block_id * 49 + gb, h32 * w32 * 49)
    hist = torch.bincount(keys.reshape(-1), minlength=h32 * w32 * 49 + 1)
    hist = hist[:-1].reshape(h32, w32, 49)
    total = hist.sum(-1)

    th0 = (total.to(torch.float32) * SETTING_MIN_GRAD_HIST_CUT
           + 0.5).to(torch.int64)
    above = torch.cumsum(hist, -1) > th0[..., None]
    # the first bin over the threshold (argmax returns the first maximum)
    first = torch.argmax(above.to(torch.int32), -1)
    quant = torch.where(above.any(-1), first, torch.full_like(first, 90))
    ths = (quant + SETTING_MIN_GRAD_HIST_ADD).to(torch.float32)

    pad = torch.zeros((h32 + 2, w32 + 2), device=dev)
    pad[1:-1, 1:-1] = ths
    cnt = torch.zeros((h32 + 2, w32 + 2), device=dev)
    cnt[1:-1, 1:-1] = 1.0
    ssum = torch.zeros((h32, w32), device=dev)
    snum = torch.zeros((h32, w32), device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ssum = ssum + pad[1 + dy:h32 + 1 + dy, 1 + dx:w32 + 1 + dx]
            snum = snum + cnt[1 + dy:h32 + 1 + dy, 1 + dx:w32 + 1 + dx]
    sm = ssum / snum
    return sm * sm


# ---------------------------------------------------------------------------
# select (PixelSelector2.cpp:290-433)
# ---------------------------------------------------------------------------

def _block_argmax(score, valid, bs: int, w: int):
    """Per-(bs x bs)-tile argmax of score where valid, the first maximum in
    raster order: (flat pixel index (hb, wb), tile has a valid pixel)."""
    h = score.shape[0]
    hb, wb = -(-h // bs), -(-w // bs)
    sp = torch.full((hb * bs, wb * bs), -torch.inf, device=score.device)
    sp[:h, :w] = torch.where(valid, score, -torch.inf)
    tiles = sp.reshape(hb, bs, wb, bs).permute(0, 2, 1, 3).reshape(
        hb, wb, bs * bs)
    loc = torch.argmax(tiles, -1)
    has = torch.isfinite(torch.gather(tiles, -1, loc[..., None])[..., 0])
    gy = torch.arange(hb, device=score.device)[:, None] * bs \
        + torch.div(loc, bs, rounding_mode="floor")
    gx = torch.arange(wb, device=score.device)[None, :] * bs + loc % bs
    return gy * w + gx, has


def _any_in_blocks(mask, bs: int):
    h, w = mask.shape
    hb, wb = -(-h // bs), -(-w // bs)
    mp = torch.zeros((hb * bs, wb * bs), dtype=torch.bool,
                     device=mask.device)
    mp[:h, :w] = mask
    return mp.reshape(hb, bs, wb, bs).any(3).any(1)


def _lock_after_first(pick1):
    """2pot-block mask: True while no earlier sub-block (raster order in
    each 2x2 group of a 4pot block) made a level-1 selection."""
    hb, wb = pick1.shape
    hb4, wb4 = -(-hb // 2), -(-wb // 2)
    p = torch.zeros((hb4 * 2, wb4 * 2), dtype=torch.bool,
                    device=pick1.device)
    p[:hb, :wb] = pick1
    g = p.reshape(hb4, 2, wb4, 2).permute(0, 2, 1, 3).reshape(hb4, wb4, 4)
    prior = torch.stack([torch.zeros_like(g[..., 0]), g[..., 0],
                         g[..., 0] | g[..., 1],
                         g[..., 0] | g[..., 1] | g[..., 2]], -1)
    a = (~prior).reshape(hb4, wb4, 2, 2).permute(0, 2, 1, 3).reshape(
        hb4 * 2, wb4 * 2)
    return a[:hb, :wb]


def select(ag0, ag1, ag2, ths_smoothed, pot: int, th_factor: float = 1.0):
    """One hierarchical selection pass: (status (h, w) uint8 in {0, 1, 2,
    4}, (n2, n3, n4) 0-d int64 tensors)."""
    h, w = ag0.shape
    h1, w1 = ag1.shape
    h2, w2 = ag2.shape
    dev = ag0.device
    dw1 = SETTING_GRAD_DOWNWEIGHT
    dw2 = dw1 * dw1

    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    border = (xs >= 4) & (xs < w - 5) & (ys >= 4) & (ys <= h - 4)
    bx = torch.clamp(xs >> 5, max=ths_smoothed.shape[1] - 1)
    by = torch.clamp(ys >> 5, max=ths_smoothed.shape[0] - 1)
    pixel_th0 = ths_smoothed[by, bx] * th_factor

    xf, yf = xs.to(torch.float32), ys.to(torch.float32)
    sx1 = torch.clamp((xf * 0.5 + 0.25).to(torch.int64), max=w1 - 1)
    sy1 = torch.clamp((yf * 0.5 + 0.25).to(torch.int64), max=h1 - 1)
    sx2 = torch.clamp((xf * 0.25 + 0.125).to(torch.int64), max=w2 - 1)
    sy2 = torch.clamp((yf * 0.25 + 0.125).to(torch.int64), max=h2 - 1)
    ag1p = ag1[sy1, sx1]
    ag2p = ag2[sy2, sx2]

    valid0 = border & (ag0 > pixel_th0)
    valid1 = border & (ag1p > pixel_th0 * dw1)
    valid2 = border & (ag2p > pixel_th0 * dw2)

    status = torch.zeros(h * w, dtype=torch.int32, device=dev)

    def mark(idx, pick, value):
        # masked-out tiles write 0 into pixel 0, which stays unselectable
        status.scatter_reduce_(
            0, torch.where(pick, idx, 0).reshape(-1),
            (pick.to(torch.int32) * value).reshape(-1), "amax")
        return pick.sum()

    idx0, has0 = _block_argmax(ag0, valid0, pot, w)
    n2 = mark(idx0, has0 & (idx0 > 0), 1)

    any0_2 = _any_in_blocks(valid0, 2 * pot)
    idx1, has1 = _block_argmax(ag1p, valid1, 2 * pot, w)
    pick1 = has1 & ~any0_2 & (idx1 > 0)
    n3 = mark(idx1, pick1, 2)

    any0_4 = _any_in_blocks(valid0, 4 * pot)
    allowed2 = _lock_after_first(pick1)
    allowed_pix = allowed2.repeat_interleave(2 * pot, 0) \
        .repeat_interleave(2 * pot, 1)[:h, :w]
    idx2, has2 = _block_argmax(
        torch.where(allowed_pix, ag2p, -torch.inf), valid2 & allowed_pix,
        4 * pot, w)
    n4 = mark(idx2, has2 & ~any0_4 & (idx2 > 0), 4)
    status[0] = 0
    return status.to(torch.uint8).reshape(h, w), (n2, n3, n4)


# ---------------------------------------------------------------------------
# makeMaps: the host-side potential adaptation around the device passes
# ---------------------------------------------------------------------------

def make_maps(absgrads, num_want: int, initial_potential: int = 3,
              recursions_left: int = 1, th_factor: float = 1.0,
              seed: int = 3141592):
    """Device-path makeMaps (PixelSelector2.cpp:137-286): the control flow
    on the host (one read of the three counts per pass), the pixel work on
    the device. Returns (status tensor, num_selected int)."""
    ths = make_hists(absgrads[0])
    h, w = absgrads[0].shape
    pot = initial_potential
    while True:
        status, counts = select(absgrads[0], absgrads[1], absgrads[2], ths,
                                pot, th_factor)
        num_have = float(sum(torch.stack(counts).tolist()))
        quotia = num_want / max(num_have, 1e-9)
        K = num_have * (pot + 1) * (pot + 1)
        ideal = max(int(np.sqrt(np.float32(K / num_want)) - 1), 1)
        if recursions_left > 0 and quotia > 1.25 and pot > 1:
            pot = min(ideal, pot - 1)
            recursions_left -= 1
            continue
        if recursions_left > 0 and quotia < 0.25:
            pot = max(ideal, pot + 1)
            recursions_left -= 1
            continue
        break

    num_have_sub = int(num_have)
    if quotia < 0.95:
        pattern = torch.as_tensor(host_selector.random_pattern(w, h, seed)
                                  ).to(status.device)
        status, dropped = _subsample(status, pattern,
                                     int(255.0 * quotia) & 0xFF)
        num_have_sub -= int(dropped)
    return status, num_have_sub


def _subsample(status, pattern, char_th: int):
    """The reference's random sub-sample: the k-th selected pixel (raster
    order) is dropped iff pattern[k] > char_th (PixelSelector2.cpp:
    271-283)."""
    flat = status.reshape(-1)
    sel = flat > 0
    rank = torch.cumsum(sel.to(torch.int64), 0) - 1
    drop = sel & (pattern[torch.clamp(rank, 0, pattern.numel() - 1)]
                  > char_th)
    return (torch.where(drop, torch.zeros_like(flat), flat)
            .reshape(status.shape), drop.sum())


# ---------------------------------------------------------------------------
# back-projection into the fixed-capacity Morton-ordered cloud
# ---------------------------------------------------------------------------

def _hsv8(img):
    """OpenCV 8U RGB2HSV on the channels as given (the reference feeds a
    BGR-loaded image to COLOR_RGB2HSV, pcd_generator.cpp:625, so channel 0
    plays 'R'): a float re-derivation of cv2's fixed-point tables that
    agrees with cv2 to one quantum on H and S."""
    f = img.to(torch.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    safe = torch.where(diff > 0, diff, torch.ones_like(diff))
    h_deg = torch.where(
        diff <= 0, torch.zeros_like(diff),
        torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe)))
    h_deg = torch.where(h_deg < 0, h_deg + 360.0, h_deg)
    H = torch.round(h_deg / 2.0)
    H = torch.where(H >= 180.0, H - 180.0, H)   # 8U hue range is [0, 180)
    S = torch.where(v > 0, torch.round(255.0 * diff / torch.where(
        v > 0, v, torch.ones_like(v))), torch.zeros_like(v))
    return torch.stack([H, S, v], -1)


def _morton_order_device(pos, mask):
    """Stable Morton sort of the cloud's slots (as pointcloud._morton_order
    on the valid points); invalid slots sort last via a code past every
    valid 30-bit key."""
    inf = torch.full_like(pos, torch.inf)
    lo = torch.where(mask[:, None], pos, inf).amin(0)
    hi = torch.where(mask[:, None], pos, -inf).amax(0)
    span = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((pos - lo) / span * 1023.0, 0, 1023).to(torch.int64)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    code = torch.where(mask, code, torch.full_like(code, 1 << 31))
    return torch.sort(code, stable=True).indices


def _build_cloud(status, depth, bgr, dx0, dy0, cam: CameraConfig, cap: int,
                 feature_type: int = 1):
    h, w = status.shape
    dev = status.device
    dep = depth.to(torch.float32)
    keep = ((status != 0) & (depth != 0) & torch.isfinite(dep)).reshape(-1)
    # raster-order compaction into cap slots (the order of np.nonzero)
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep & (rank < cap), rank, cap)   # cap: spill row

    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    z = dep / cam.depth_factor
    px = (xs.to(torch.float32) - cam.cx) * z / cam.fx
    py = (ys.to(torch.float32) - cam.cy) * z / cam.fy

    def scat(vals, dtype=torch.float32):
        vals = vals.reshape(h * w, -1).to(dtype)
        out = torch.zeros((cap + 1, vals.shape[1]), dtype=dtype, device=dev)
        out[slot] = vals
        return out[:cap]

    positions = scat(torch.stack([px, py, z], -1))
    if feature_type == 0:
        color = _hsv8(bgr) / torch.tensor([180.0, 255.0, 255.0], device=dev)
        gscale = 2.0 / 255.0
    else:
        color = bgr.to(torch.float32)
        gscale = 1.0
    features = scat(torch.cat([color, gscale * dx0[..., None],
                               gscale * dy0[..., None]], -1))
    pix = scat(torch.stack([xs, ys], -1), torch.int32)
    n_selected = keep.sum()
    count = torch.clamp(n_selected, max=cap)
    mask = torch.arange(cap, device=dev) < count
    order = _morton_order_device(positions, mask)
    return (positions[order], features[order], mask, count, pix[order],
            n_selected, n_selected - count)


def create_pointcloud_device(bgr, gray, depth, cam: CameraConfig,
                             fp: FrontendParams, device="cuda"):
    """Device-path create_pointcloud from host images (bgr (H, W, 3) uint8,
    gray (H, W), depth (H, W) uint16): (positions, features, mask, count,
    selected_pixels, n_selected, n_dropped) on `device`, at capacity
    fp.cloud_capacity; n_selected and n_dropped are the host cloud's
    counters as 0-d tensors (n_selected - n_dropped == count). Matches
    frontend.pointcloud.create_pointcloud up to Morton tie-breaking and f32
    rounding of the back-projection."""
    dev = resolve_device(device)
    gray = torch.as_tensor(np.asarray(gray, np.float32)).to(dev)
    _, dxs, dys, absgrads = make_pyramid(gray, fp.pyr_levels)
    status, _ = make_maps(absgrads, fp.num_want,
                          initial_potential=fp.initial_potential,
                          recursions_left=fp.recursions, th_factor=1.0,
                          seed=fp.random_seed)
    return _build_cloud(
        status, torch.as_tensor(np.asarray(depth, np.int32)).to(dev),
        torch.as_tensor(np.asarray(bgr, np.uint8)).to(dev), dxs[0], dys[0],
        cam, fp.cloud_capacity, fp.feature_type)
