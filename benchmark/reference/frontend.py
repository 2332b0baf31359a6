"""A frame's point cloud from its PNGs: a frozen copy of the port's plain
frontend (cvo_slam_tpu_torch/frontend/pyramid.py, the numpy path of
selector.py and pointcloud.py with feature type 1), so the reference
rebuilds the cloud the port's frontend (its native selector included)
derives from the same frame. `dtype` is the float type of the pyramid and
of the cloud's arithmetic: float32 as the port, float16 for the
lower-precision control.

Re-expression of the reference pcd_generator (pcd_generator.cpp:50-143,
366-656) and PixelSelector2.cpp (makeHists :71-136, select :290-433,
makeMaps :137-286), as the port's copies document.
"""

from __future__ import annotations

from functools import lru_cache

import cv2
import numpy as np


# ---------------------------------------------------------------------------
# the pyramid (pyramid.py)
# ---------------------------------------------------------------------------

def make_pyramid(gray: np.ndarray, levels: int = 3, dtype=np.float32):
    """gray: (H, W) intensity (0..255) (pcd_generator.cpp:50-143).

    Returns (intensity, dx, dy, absgrad): lists of per-level (h_l, w_l)
    float32 arrays."""
    h, w = gray.shape
    intensity, dxs, dys, absgrads = [], [], [], []
    cur = gray.astype(dtype)
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
        dx = np.zeros(n, dtype)
        dy = np.zeros(n, dtype)
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


SETTING_GRAD_DOWNWEIGHT = 0.75   # PixelSelector2.h:30
SETTING_MIN_GRAD_HIST_CUT = 0.5  # PixelSelector2.h:32
SETTING_MIN_GRAD_HIST_ADD = 7    # PixelSelector2.h:33


# ---------------------------------------------------------------------------
# glibc rand() (TYPE_3 additive feedback), bit-exact
# ---------------------------------------------------------------------------

def glibc_rand_sequence(seed: int, n: int) -> np.ndarray:
    """First n outputs of glibc rand() after srand(seed)."""
    total = 344 + n
    r = np.zeros(total, dtype=np.uint32)
    r[0] = np.uint32(seed)
    x = np.int64(seed)
    for i in range(1, 31):
        # r[i] = (16807 * r[i-1]) % 2147483647 without overflow
        hi, lo = divmod(x, 127773)
        x = 16807 * lo - 2836 * hi
        if x < 0:
            x += 2147483647
        r[i] = np.uint32(x)
    for i in range(31, 34):
        r[i] = r[i - 31]
    rr = r.astype(np.uint64)
    for i in range(34, total):
        rr[i] = (rr[i - 31] + rr[i - 3]) & 0xFFFFFFFF
    return (rr[344:] >> np.uint64(1)).astype(np.uint32)


@lru_cache(maxsize=4)
def random_pattern(w: int, h: int, seed: int = 3141592) -> np.ndarray:
    """randomPattern[i] = rand() & 0xFF (PixelSelector2.cpp:36-38)."""
    return (glibc_rand_sequence(seed, w * h) & 0xFF).astype(np.uint8)


# ---------------------------------------------------------------------------
# makeHists
# ---------------------------------------------------------------------------

def make_hists(absgrad0: np.ndarray) -> np.ndarray:
    """Per-32x32-block smoothed squared thresholds (thsSmoothed).

    Returns (h32, w32) float32."""
    h, w = absgrad0.shape
    w32, h32 = w // 32, h // 32
    g = np.sqrt(absgrad0).astype(np.int32)
    np.minimum(g, 48, out=g)

    # interior mask: 1 <= it <= w-2, 1 <= jt <= h-2 (PixelSelector2.cpp:95)
    valid = np.zeros((h, w), bool)
    valid[1:h - 1, 1:w - 1] = True

    gb = g[:h32 * 32, :w32 * 32].reshape(h32, 32, w32, 32)
    vb = valid[:h32 * 32, :w32 * 32].reshape(h32, 32, w32, 32)

    # histogram over 49 bins (g in 0..48) per block via a single bincount
    # over block_index*49 + g (the one-hot formulation costs ~40 ms/frame)
    block_id = (np.arange(h32)[:, None, None, None] * w32
                + np.arange(w32)[None, None, :, None])
    flat_keys = (block_id * 49 + gb)[vb]
    hist = np.bincount(flat_keys.ravel(),
                       minlength=h32 * w32 * 49).reshape(h32, w32, 49)
    total = hist.sum(axis=-1)

    # computeHistQuantil (PixelSelector2.cpp:59-68): th = int(total*below+0.5);
    # walk th -= hist0[i+1] (== our hist[i]) for i = 0..89 and return the first
    # i where th goes negative, i.e. the first i with cumsum(hist[0..i]) > th;
    # bins beyond 48 are empty so the walk returns <= 48 unless total == 0,
    # in which case it returns 90.
    th0 = (total * SETTING_MIN_GRAD_HIST_CUT + 0.5).astype(np.int64)
    cs1 = np.cumsum(hist, axis=-1)                    # (h32, w32, 49)
    above = cs1 > th0[..., None]
    any_above = above.any(axis=-1)
    quant = np.where(any_above, above.argmax(axis=-1), 90)

    ths = (quant + SETTING_MIN_GRAD_HIST_ADD).astype(np.float32)

    # 3x3 count-aware smoothing then square (PixelSelector2.cpp:107-131)
    pad = np.zeros((h32 + 2, w32 + 2), np.float32)
    cnt = np.zeros((h32 + 2, w32 + 2), np.float32)
    pad[1:-1, 1:-1] = ths
    cnt[1:-1, 1:-1] = 1.0
    ssum = np.zeros((h32, w32), np.float32)
    snum = np.zeros((h32, w32), np.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ssum += pad[1 + dy:h32 + 1 + dy, 1 + dx:w32 + 1 + dx]
            snum += cnt[1 + dy:h32 + 1 + dy, 1 + dx:w32 + 1 + dx]
    sm = ssum / snum
    return sm * sm


# ---------------------------------------------------------------------------
# select
# ---------------------------------------------------------------------------

def _block_reduce_argmax(score: np.ndarray, valid: np.ndarray, bs: int):
    """Per-(bs x bs)-tile argmax of score where valid (raster tie-break =
    first max, matching the strict '>' scan of the reference).

    Returns (best_flat_idx (hb, wb) int64 of flattened image, has_any)."""
    h, w = score.shape
    hb, wb = -(-h // bs), -(-w // bs)
    ph, pw = hb * bs, wb * bs
    sp = np.full((ph, pw), -np.inf, np.float32)
    sp[:h, :w] = np.where(valid, score, -np.inf)
    tiles = sp.reshape(hb, bs, wb, bs).transpose(0, 2, 1, 3).reshape(hb, wb, bs * bs)
    loc = tiles.argmax(axis=-1)
    has = np.isfinite(np.take_along_axis(tiles, loc[..., None], axis=-1)[..., 0])
    ly, lx = loc // bs, loc % bs
    gy = np.arange(hb)[:, None] * bs + ly
    gx = np.arange(wb)[None, :] * bs + lx
    return gy * w + gx, has


def select(absgrads, dx0, dy0, ths_smoothed, pot: int, th_factor: float = 1.0):
    """One hierarchical selection pass (PixelSelector2.cpp:290-433).

    absgrads: 3-level list of abs-squared-grad arrays.
    Returns (status map (h,w) uint8 in {0,1,2,4}, (n2, n3, n4))."""
    ag0, ag1, ag2 = absgrads[0], absgrads[1], absgrads[2]
    h, w = ag0.shape
    h1, w1 = ag1.shape
    h2, w2 = ag2.shape
    dw1 = SETTING_GRAD_DOWNWEIGHT
    dw2 = dw1 * dw1

    ys, xs = np.mgrid[0:h, 0:w]
    border = (xs >= 4) & (xs < w - 5) & (ys >= 4) & (ys <= h - 4)

    # per-pixel thresholds from the 32x32 block (clamped at the ragged edge,
    # where the reference indexes past its w/32-wide array)
    bx = np.minimum(xs >> 5, ths_smoothed.shape[1] - 1)
    by = np.minimum(ys >> 5, ths_smoothed.shape[0] - 1)
    pixel_th0 = ths_smoothed[by, bx] * th_factor

    # sampled coarser-level gradients per level-0 pixel (:384, :396)
    sx1 = np.minimum((xs * 0.5 + 0.25).astype(np.int32), w1 - 1)
    sy1 = np.minimum((ys * 0.5 + 0.25).astype(np.int32), h1 - 1)
    sx2 = np.minimum((xs * 0.25 + 0.125).astype(np.int32), w2 - 1)
    sy2 = np.minimum((ys * 0.25 + 0.125).astype(np.int32), h2 - 1)
    ag1p = ag1[sy1, sx1]
    ag2p = ag2[sy2, sx2]

    valid0 = border & (ag0 > pixel_th0)
    valid1 = border & (ag1p > pixel_th0 * dw1)
    valid2 = border & (ag2p > pixel_th0 * dw2)

    status = np.zeros(h * w, np.uint8)

    # level 0: per pot-block argmax of ag0 among valid0
    idx0, has0 = _block_reduce_argmax(ag0, valid0, pot)
    sel0 = idx0[has0 & (idx0 > 0)]
    status[sel0] = 1
    n2 = int(sel0.size)

    # level 1: 2pot blocks with no valid0 pixel anywhere
    any0_2pot = _any_in_blocks(valid0, 2 * pot)
    idx1, has1 = _block_reduce_argmax(ag1p, valid1, 2 * pot)
    pick1 = has1 & ~any0_2pot & (idx1 > 0)
    sel1 = idx1[pick1]
    status[sel1] = 2
    n3 = int(sel1.size)

    # level 2: 4pot blocks with no valid0 pixel; candidate pool limited to
    # 2pot sub-blocks up to (and including) the first one that made a level-1
    # selection (bestVal4 lock, :417-421)
    any0_4pot = _any_in_blocks(valid0, 4 * pot)
    hb2, wb2 = pick1.shape
    # map each 2pot sub-block to its 4pot parent; raster order of sub-blocks
    # within a parent is (2x2): order = 2*(y&1)+(x&1)
    allowed2 = _lock_after_first(pick1)
    # expand allowed 2pot blocks to pixel mask
    allowed_pix = np.kron(allowed2, np.ones((2 * pot, 2 * pot), bool))[:h, :w]
    idx2, has2 = _block_reduce_argmax(
        np.where(allowed_pix, ag2p, -np.inf), valid2 & allowed_pix, 4 * pot)
    pick2 = has2 & ~any0_4pot & (idx2 > 0)
    sel2 = idx2[pick2]
    status[sel2] = 4
    n4 = int(sel2.size)

    return status.reshape(h, w), (n2, n3, n4)


def _any_in_blocks(mask: np.ndarray, bs: int) -> np.ndarray:
    h, w = mask.shape
    hb, wb = -(-h // bs), -(-w // bs)
    mp = np.zeros((hb * bs, wb * bs), bool)
    mp[:h, :w] = mask
    return mp.reshape(hb, bs, wb, bs).any(axis=(1, 3))


def _lock_after_first(pick1: np.ndarray) -> np.ndarray:
    """2pot-block mask: True while no *earlier* sub-block (raster order inside
    each 2x2 group of a 4pot block) has a level-1 selection; the locking block
    itself stays allowed."""
    hb, wb = pick1.shape
    hb4, wb4 = -(-hb // 2), -(-wb // 2)
    p = np.zeros((hb4 * 2, wb4 * 2), bool)
    p[:hb, :wb] = pick1
    # raster order within the 2x2 group: (0,0), (0,1), (1,0), (1,1)
    g = p.reshape(hb4, 2, wb4, 2).transpose(0, 2, 1, 3).reshape(hb4, wb4, 4)
    prior = np.zeros_like(g)
    prior[..., 1] = g[..., 0]
    prior[..., 2] = g[..., 0] | g[..., 1]
    prior[..., 3] = g[..., 0] | g[..., 1] | g[..., 2]
    allowed = ~prior
    a = allowed.reshape(hb4, wb4, 2, 2).transpose(0, 2, 1, 3).reshape(hb4 * 2, wb4 * 2)
    return a[:hb, :wb]


# ---------------------------------------------------------------------------
# makeMaps
# ---------------------------------------------------------------------------

def make_maps(absgrads, dx0, dy0, num_want: int,
              initial_potential: int = 3, recursions_left: int = 1,
              th_factor: float = 1.0, seed: int = 3141592):
    """Full selection with potential adaptation + random sub-sample
    (PixelSelector2.cpp:137-286). Returns (status map, num_selected)."""
    ths_smoothed = make_hists(absgrads[0])
    h, w = absgrads[0].shape
    pot = initial_potential

    while True:
        status, (n2, n3, n4) = select(absgrads, dx0, dy0, ths_smoothed,
                                      pot, th_factor)
        num_have = float(n2 + n3 + n4)
        quotia = num_want / max(num_have, 1e-9)
        K = num_have * (pot + 1) * (pot + 1)
        ideal = int(np.sqrt(np.float32(K / num_want)) - 1)
        if ideal < 1:
            ideal = 1
        if recursions_left > 0 and quotia > 1.25 and pot > 1:
            if ideal >= pot:
                ideal = pot - 1
            pot = ideal
            recursions_left -= 1
            continue
        if recursions_left > 0 and quotia < 0.25:
            if ideal <= pot:
                ideal = pot + 1
            pot = ideal
            recursions_left -= 1
            continue
        break

    num_have_sub = int(num_have)
    if quotia < 0.95:
        pattern = random_pattern(w, h, seed)
        char_th = np.uint8(int(255.0 * quotia) & 0xFF)
        flat = status.reshape(-1)
        sel_idx = np.flatnonzero(flat)
        drop = pattern[:sel_idx.size] > char_th
        flat[sel_idx[drop]] = 0
        num_have_sub -= int(drop.sum())
    return status, num_have_sub


# ---------------------------------------------------------------------------
# the point cloud (pointcloud.py, feature type 1)
# ---------------------------------------------------------------------------

def _morton_order(pos: np.ndarray) -> np.ndarray:
    """Permutation along a 3-D Z-order curve, 10 bits per axis over the
    points' bounding box; ties keep raster order."""
    lo = pos.min(axis=0)
    span = np.maximum(pos.max(axis=0) - lo, 1e-9)
    q = ((pos - lo) / span * 1023.0).astype(np.uint64)
    q = np.minimum(q, 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def load_frame(rgb_path: str, depth_path: str):
    """(bgr, gray, depth) as the reference's run_SLAM.cpp:134-143 loads a
    pair: gray by COLOR_RGB2GRAY applied to the BGR image (its quirk)."""
    bgr = cv2.imread(rgb_path)
    depth = cv2.imread(depth_path, cv2.IMREAD_ANYDEPTH)
    if bgr is None or depth is None:
        raise FileNotFoundError(f"missing frame {rgb_path} / {depth_path}")
    return bgr, cv2.cvtColor(bgr, cv2.COLOR_RGB2GRAY), depth.astype(np.uint16)


def create_pointcloud(bgr, gray, depth, cam: dict, fp: dict,
                      dtype=np.float32):
    """(positions (CAP, 3), features (CAP, 5), mask (CAP,), count,
    pixels (CAP, 2)): DSO selection, depth gating, pinhole back-projection
    and the feature rows [B, G, R, dI/dx, dI/dy], Morton-ordered."""
    intensity, dxs, dys, absgrads = make_pyramid(gray.astype(dtype),
                                                 fp["pyr_levels"], dtype)
    status, _ = make_maps(absgrads, dxs[0], dys[0], fp["num_want"],
                          initial_potential=fp["initial_potential"],
                          recursions_left=fp["recursions"],
                          seed=fp["random_seed"])
    dep = depth.astype(dtype)
    keep = (status != 0) & (depth != 0) & np.isfinite(dep)
    ys, xs = np.nonzero(keep)
    cap = fp["cloud_capacity"]
    n = min(len(xs), cap)
    xs, ys = xs[:n], ys[:n]
    positions = np.zeros((cap, 3), dtype)
    features = np.zeros((cap, 5), dtype)
    mask = np.zeros(cap, bool)
    pix = np.zeros((cap, 2), np.int32)
    z = dep[ys, xs] / cam["depth_factor"]
    positions[:n, 0] = (xs - cam["cx"]) * z / cam["fx"]
    positions[:n, 1] = (ys - cam["cy"]) * z / cam["fy"]
    positions[:n, 2] = z
    features[:n, 0:3] = bgr[ys, xs, :].astype(dtype)
    features[:n, 3] = dxs[0][ys, xs]
    features[:n, 4] = dys[0][ys, xs]
    mask[:n] = True
    pix[:n, 0] = xs
    pix[:n, 1] = ys
    if n > 1:
        order = _morton_order(positions[:n].astype(np.float32))
        positions[:n] = positions[order]
        features[:n] = features[order]
        pix[:n] = pix[order]
    return positions, features, mask, n, pix
