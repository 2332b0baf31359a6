"""ORB keypoints + descriptors for keyframes (copy of
cvo_slam_tpu.features.orb; NumPy and OpenCV only).

Functional re-expression of the reference extractor
(reference src/ORBextractor.cpp): 8-level 1.2x pyramid, grid FAST with
high/low threshold fallback (:772-860 octree distribution), intensity-centroid
orientation (IC_Angle :75-102), 256-pair binary descriptors on the blurred
level image, and the CVO-gated ExtractOrb filter (:1114-1277): keep keypoints
with valid depth, near a CVO-selected pixel (radius^2 < 1e5 — effectively
always true inside the image), and pairwise-distinct beyond
`keypoint_distance` (default 0 => exact-duplicate dedupe).

Implementation notes (deviations, documented):
  * FAST / resize / GaussianBlur use OpenCV directly (the reference links the
    same library); the octree spatial distribution is a quadtree on numpy.
  * the BRIEF sampling pattern is our own deterministic 256-pair layout
    (seeded Gaussian pairs in the 31x31 patch, the standard BRIEF recipe) —
    the reference's learned table is ORB-SLAM2 data we deliberately do not
    copy. Descriptors are only matched against our own keyframes and our own
    trained vocabulary, so self-consistency is what matters.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import cv2
import numpy as np

from ..config import CameraConfig, SlamConfig

HALF_PATCH = 15
EDGE_THRESHOLD = 19
PATCH_SIZE = 31


@lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """(256, 4) int32 [x1, y1, x2, y2] sampling pairs, Gaussian(0, patch/5)
    clipped to the 31x31 patch (classic BRIEF layout, own fixed seed)."""
    rng = np.random.RandomState(0x5EED)
    sigma = PATCH_SIZE / 5.0
    pts = np.clip(np.round(rng.randn(256, 4) * sigma), -13, 13).astype(np.int32)
    return pts


@lru_cache(maxsize=1)
def patch_offsets():
    """All (u, v) offsets of the circular IC_Angle patch, flattened:
    v = 0 full row, |v| >= 1 rows bounded by umax (ORBextractor.cpp:75-102).
    Returns (uu, vv) int64 arrays of ~750 offsets for one-gather moments."""
    umax = umax_table()
    us, vs = [], []
    for u in range(-HALF_PATCH, HALF_PATCH + 1):
        us.append(u)
        vs.append(0)
    for v in range(1, HALF_PATCH + 1):
        d = int(umax[v])
        for u in range(-d, d + 1):
            us.extend((u, u))
            vs.extend((v, -v))
    return np.asarray(us, np.int64), np.asarray(vs, np.int64)


@lru_cache(maxsize=1)
def umax_table() -> np.ndarray:
    """Circular-patch row extents for IC_Angle (ORBextractor.cpp:439-453)."""
    umax = np.zeros(HALF_PATCH + 1, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


@dataclass
class OrbParams:
    n_features: int = 5000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    keypoint_distance: float = 0.0


class OrbExtractor:

    def __init__(self, p: OrbParams):
        self.p = p
        self.scales = p.scale_factor ** np.arange(p.n_levels)
        self.inv_scales = 1.0 / self.scales
        self.level_sigma2 = self.scales ** 2
        self.inv_level_sigma2 = 1.0 / self.level_sigma2
        # per-level feature budget ~ geometric series (ORBextractor.cpp:418-436)
        factor = 1.0 / p.scale_factor
        n_desired = p.n_features * (1 - factor) / (1 - factor ** p.n_levels)
        budgets = []
        total = 0
        for _ in range(p.n_levels - 1):
            budgets.append(int(round(n_desired)))
            total += budgets[-1]
            n_desired *= factor
        budgets.append(max(p.n_features - total, 0))
        self.budgets = budgets
        self._fast_hi = cv2.FastFeatureDetector_create(p.ini_th_fast)
        self._fast_lo = cv2.FastFeatureDetector_create(p.min_th_fast)

    # -- detection ---------------------------------------------------------
    def _detect_level(self, img: np.ndarray, budget: int):
        """Grid FAST with threshold fallback + quadtree distribution.
        Returns (pts (K,2) float32 level coords, response (K,)).

        One whole-image FAST pass per threshold (instead of the reference's
        ~200 per-cell detector invocations, ORBextractor.cpp:1050-1112); the
        low-threshold fallback keeps the same per-cell semantics — low-
        threshold corners are admitted only in 35px grid cells where the
        high threshold found nothing."""
        h, w = img.shape
        cell = 35
        x0, y0 = EDGE_THRESHOLD - 3, EDGE_THRESHOLD - 3
        x1, y1 = w - EDGE_THRESHOLD + 3, h - EDGE_THRESHOLD + 3
        if x1 - x0 < 7 or y1 - y0 < 7:
            return np.zeros((0, 2), np.float32), np.zeros(0, np.float32)

        def detect(det):
            found = det.detect(img[y0:y1, x0:x1])
            if not found:
                return (np.zeros((0, 2), np.float32),
                        np.zeros(0, np.float32))
            pts = np.array([k.pt for k in found], np.float32)
            pts += np.float32([x0, y0])
            resp = np.array([k.response for k in found], np.float32)
            return pts, resp

        pts_hi, resp_hi = detect(self._fast_hi)
        pts_lo, resp_lo = detect(self._fast_lo)
        ncx = max((x1 - x0 + cell - 1) // cell, 1)

        def cell_id(pts):
            return ((pts[:, 1] - y0) // cell).astype(np.int64) * ncx \
                + ((pts[:, 0] - x0) // cell).astype(np.int64)

        hi_cells = np.unique(cell_id(pts_hi)) if len(pts_hi) else \
            np.zeros(0, np.int64)
        if len(pts_lo):
            lo_keep = ~np.isin(cell_id(pts_lo), hi_cells)
            pts = np.concatenate([pts_hi, pts_lo[lo_keep]])
            resp = np.concatenate([resp_hi, resp_lo[lo_keep]])
        else:
            pts, resp = pts_hi, resp_hi
        if len(pts) == 0:
            return np.zeros((0, 2), np.float32), np.zeros(0, np.float32)
        keep = self._distribute_quadtree(pts, resp, budget, (x0, y0, x1, y1))
        return pts[keep], resp[keep]

    @staticmethod
    def _distribute_quadtree(pts, resp, budget, bounds):
        """Spatially even top-response selection (quadtree analogue of
        DistributeOctTree, ORBextractor.cpp:772-860).

        Level-synchronous: every round splits all splittable nodes at once
        (vectorized point re-assignment); when a full round would overshoot
        the budget, only the most-populated nodes split (the reference's
        size-sorted final expansion). One surviving keypoint per node: the
        max-response point."""
        n = len(pts)
        if n == 0:
            return np.zeros(0, np.int64)
        x0, y0, x1, y1 = bounds
        # phase 1 — level-synchronous: per-point node assignment +
        # per-node bounds, every splittable node splits at once, while a
        # full round cannot overshoot the budget
        assign = np.zeros(n, np.int64)
        lo = np.array([[x0, y0]], np.float64)
        hi = np.array([[x1, y1]], np.float64)
        while True:
            counts = np.bincount(assign, minlength=len(lo))
            splittable = np.flatnonzero(counts > 1)
            n_nodes = len(lo)
            if n_nodes >= budget or len(splittable) == 0 \
                    or n_nodes + 3 * len(splittable) > budget:
                break
            # vectorized split: points in splitting nodes get child code
            # 0..3 by quadrant; children are appended after existing nodes
            is_split = np.zeros(n_nodes, bool)
            is_split[splittable] = True
            rank = np.cumsum(is_split) - 1          # node -> split index
            mid = (lo[splittable] + hi[splittable]) / 2
            pm = is_split[assign]                   # points that move
            a = assign[pm]
            code = (pts[pm, 0] >= mid[rank[a], 0]).astype(np.int64) \
                + 2 * (pts[pm, 1] >= mid[rank[a], 1]).astype(np.int64)
            new_assign = n_nodes + 4 * rank[a] + code
            # child bounds
            cl = np.repeat(lo[splittable], 4, axis=0)
            ch = np.repeat(hi[splittable], 4, axis=0)
            cm = np.repeat(mid, 4, axis=0)
            q = np.tile(np.arange(4), len(splittable))
            cl[:, 0] = np.where(q % 2 == 1, cm[:, 0], cl[:, 0])
            ch[:, 0] = np.where(q % 2 == 0, cm[:, 0], ch[:, 0])
            cl[:, 1] = np.where(q >= 2, cm[:, 1], cl[:, 1])
            ch[:, 1] = np.where(q < 2, cm[:, 1], ch[:, 1])
            assign2 = assign.copy()
            assign2[pm] = new_assign
            lo2 = np.concatenate([lo, cl])
            hi2 = np.concatenate([hi, ch])
            # compact: drop emptied parents + empty children
            counts2 = np.bincount(assign2, minlength=len(lo2))
            live = np.flatnonzero(counts2 > 0)
            remap = np.full(len(lo2), -1, np.int64)
            remap[live] = np.arange(len(live))
            assign = remap[assign2]
            lo, hi = lo2[live], hi2[live]

        # phase 2 — biggest-first tail (the reference's size-sorted final
        # expansion): heap of (-count, seq); stop the moment the budget is
        # reached. Nodes are (lo, hi, point-index array) tuples.
        import heapq
        order = np.argsort(assign, kind="stable")
        cuts = np.searchsorted(assign[order], np.arange(len(lo) + 1))
        heap = []
        seq = 0
        leaves = []       # non-splittable nodes (1 point)
        for i in range(len(lo)):
            idx = order[cuts[i]:cuts[i + 1]]
            node = (lo[i], hi[i], idx)
            if len(idx) > 1:
                heapq.heappush(heap, (-len(idx), seq, node))
                seq += 1
            else:
                leaves.append(node)
        while heap and len(heap) + len(leaves) < budget:
            _, _, (nlo, nhi, idx) = heapq.heappop(heap)
            mx, my = (nlo[0] + nhi[0]) / 2, (nlo[1] + nhi[1]) / 2
            right = pts[idx, 0] >= mx
            top = pts[idx, 1] >= my
            for quad, qlo, qhi in (
                (~right & ~top, nlo, (mx, my)),
                (right & ~top, (mx, nlo[1]), (nhi[0], my)),
                (~right & top, (nlo[0], my), (mx, nhi[1])),
                (right & top, (mx, my), nhi),
            ):
                qi = idx[quad]
                if len(qi) == 0:
                    continue
                node = ((qlo[0], qlo[1]), (qhi[0], qhi[1]), qi)
                if len(qi) > 1:
                    heapq.heappush(heap, (-len(qi), seq, node))
                    seq += 1
                else:
                    leaves.append(node)
        keep = [idx[0] if len(idx) == 1 else idx[np.argmax(resp[idx])]
                for (_, _, idx) in leaves + [h[2] for h in heap]]
        return np.sort(np.asarray(keep, np.int64))

    # -- orientation -------------------------------------------------------
    @staticmethod
    def _ic_angles(img: np.ndarray, pts: np.ndarray) -> np.ndarray:
        """Intensity-centroid angles in degrees (IC_Angle semantics):
        one (K, ~750) gather over the circular patch offsets instead of
        ~700 per-row numpy passes."""
        if len(pts) == 0:
            return np.zeros(0, np.float32)
        uu, vv = patch_offsets()
        h, w = img.shape
        I = np.ascontiguousarray(img, np.float32)
        # keypoints come from the EDGE_THRESHOLD-bounded detection ROI, so
        # the patch cannot leave the image; clamp centers once for safety
        xs = np.clip(np.round(pts[:, 0]).astype(np.int64),
                     HALF_PATCH, w - 1 - HALF_PATCH)
        ys = np.clip(np.round(pts[:, 1]).astype(np.int64),
                     HALF_PATCH, h - 1 - HALF_PATCH)
        flat = (ys[:, None] + vv[None, :]) * w + xs[:, None] + uu[None, :]
        patch = I.take(flat.ravel()).reshape(flat.shape)   # (K, P)
        m10 = patch @ uu.astype(np.float32)
        m01 = patch @ vv.astype(np.float32)
        return np.degrees(np.arctan2(m01, m10)).astype(np.float32)

    # -- descriptors -------------------------------------------------------
    @staticmethod
    def _descriptors(blurred: np.ndarray, pts: np.ndarray,
                     angles_deg: np.ndarray) -> np.ndarray:
        if len(pts) == 0:
            return np.zeros((0, 32), np.uint8)
        pat = brief_pattern().astype(np.float32)     # (256,4)
        a = np.radians(angles_deg)
        ca, sa = np.cos(a), np.sin(a)
        h, w = blurred.shape
        I = np.ascontiguousarray(blurred)

        def sample(px, py):
            # rotate pattern points by keypoint angle, round, clamp
            rx = np.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None]
                          + pts[:, 0:1]).astype(np.int64)
            ry = np.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None]
                          + pts[:, 1:2]).astype(np.int64)
            np.clip(rx, 0, w - 1, out=rx)
            np.clip(ry, 0, h - 1, out=ry)
            return I.take(ry * w + rx)

        v1 = sample(pat[:, 0], pat[:, 1])            # (K,256)
        v2 = sample(pat[:, 2], pat[:, 3])
        bits = (v1 < v2).astype(np.uint8)
        return np.packbits(bits, axis=1, bitorder="little")

    # -- full ExtractOrb (ORBextractor.cpp:1114-1277) ----------------------
    def extract(self, gray: np.ndarray, depth_m: np.ndarray,
                selected_pixels: np.ndarray):
        """Returns (keypoints (K,3) [x, y, octave] in level-0 coords,
        angles (K,), descriptors (K,32) uint8)."""
        p = self.p
        pyramid = [gray]
        for lvl in range(1, p.n_levels):
            sz = (int(round(gray.shape[1] * self.inv_scales[lvl])),
                  int(round(gray.shape[0] * self.inv_scales[lvl])))
            pyramid.append(cv2.resize(gray, sz, interpolation=cv2.INTER_LINEAR))

        h, w = gray.shape
        out_pts, out_ang, out_desc, out_oct = [], [], [], []
        self._seen = np.zeros(0, np.complex128)
        self._grid = {}
        for lvl in range(p.n_levels):
            img = pyramid[lvl]
            pts, resp = self._detect_level(img, self.budgets[lvl])
            if len(pts) == 0:
                continue
            scale = self.scales[lvl]
            pts0 = pts * scale                        # level-0 coords
            xi = np.clip(pts0[:, 0].astype(np.int64), 0, w - 1)
            yi = np.clip(pts0[:, 1].astype(np.int64), 0, h - 1)
            keep = depth_m[yi, xi] > 0.0              # depth gate (:1169-1173)
            # CVO gate (:1179-1195): with any selected pixels present the
            # radius^2 < 1e5 test always passes inside a VGA frame; an empty
            # selection rejects everything.
            if selected_pixels is None or len(selected_pixels) == 0:
                keep[:] = False
            # min-distance gate vs already-kept keypoints (:1205-1225).
            # keypoint_distance=0 (shipped configs) degenerates to exact-
            # duplicate dedupe; >0 uses a greedy grid hash (same greedy
            # first-come-kept semantics as the reference's incremental kdtree).
            if np.any(keep):
                sel = np.flatnonzero(keep)
                if p.keypoint_distance <= 0.0:
                    # vectorized exact-duplicate dedupe: level-0 coord pairs
                    # as complex keys; first occurrence wins (same greedy
                    # order as the reference's incremental kd-tree insert)
                    ck = np.ascontiguousarray(
                        pts0[sel], np.float64).view(np.complex128).ravel()
                    _, first = np.unique(ck, return_index=True)
                    dup = np.ones(len(sel), bool)
                    dup[first] = False
                    if len(self._seen):
                        dup |= np.isin(ck, self._seen)
                    keep[sel[dup]] = False
                    fresh = ck[~dup]
                    self._seen = fresh if not len(self._seen) else \
                        np.concatenate([self._seen, fresh])
                else:
                    cell = max(np.sqrt(p.keypoint_distance), 1e-6)
                    for i in sel:
                        cx, cy = int(pts0[i, 0] / cell), int(pts0[i, 1] / cell)
                        ok = True
                        for gx in (cx - 1, cx, cx + 1):
                            for gy in (cy - 1, cy, cy + 1):
                                for q in self._grid.get((gx, gy), ()):
                                    if (q[0] - pts0[i, 0]) ** 2 + \
                                       (q[1] - pts0[i, 1]) ** 2 \
                                       <= p.keypoint_distance:
                                        ok = False
                                        break
                        if ok:
                            self._grid.setdefault((cx, cy), []).append(
                                (pts0[i, 0], pts0[i, 1]))
                        else:
                            keep[i] = False
            if not np.any(keep):
                continue
            pts_l = pts[keep]
            ang = self._ic_angles(img, pts_l)
            blurred = cv2.GaussianBlur(img, (7, 7), 2, borderType=cv2.BORDER_REFLECT_101)
            desc = self._descriptors(blurred, pts_l, ang)
            out_pts.append(pts_l * scale)
            out_ang.append(ang)
            out_desc.append(desc)
            out_oct.append(np.full(len(pts_l), lvl, np.int32))
        if not out_pts:
            return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                    np.zeros((0, 32), np.uint8))
        pts = np.concatenate(out_pts)
        octv = np.concatenate(out_oct).astype(np.float32)
        kp = np.concatenate([pts, octv[:, None]], axis=1)
        return (kp, np.concatenate(out_ang), np.concatenate(out_desc))


class OpenCVOrbExtractor:
    """Fast ORB path: one cv2.ORB_create C++ call (pyramid + FAST + Harris
    retention + IC angle + learned rBRIEF), then the same ExtractOrb gate
    chain as the reference (ORBextractor.cpp:1114-1277): valid depth, CVO
    selection present, exact-duplicate / min-distance dedupe.

    ~10x faster than the numpy reference-parity extractor (OrbExtractor) and
    uses OpenCV's learned descriptor pattern — the same library the
    reference links. Selected with CameraConfig.orb_backend="opencv"."""

    def __init__(self, p: OrbParams):
        self.p = p
        self.scales = p.scale_factor ** np.arange(p.n_levels)
        self.level_sigma2 = self.scales ** 2
        self.inv_level_sigma2 = 1.0 / self.level_sigma2
        self._orb = cv2.ORB_create(
            nfeatures=p.n_features, scaleFactor=p.scale_factor,
            nlevels=p.n_levels, edgeThreshold=EDGE_THRESHOLD, firstLevel=0,
            WTA_K=2, scoreType=cv2.ORB_HARRIS_SCORE, patchSize=PATCH_SIZE,
            fastThreshold=p.min_th_fast)

    def extract(self, gray: np.ndarray, depth_m: np.ndarray,
                selected_pixels: np.ndarray):
        kps, desc = self._orb.detectAndCompute(gray, None)
        if not kps:
            return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                    np.zeros((0, 32), np.uint8))
        pts0 = np.array([k.pt for k in kps], np.float32)
        ang = np.array([k.angle for k in kps], np.float32)
        octv = np.array([k.octave for k in kps], np.float32)
        # process in level order (stable) to mirror the reference's
        # level-by-level first-come-kept dedupe
        order = np.argsort(octv, kind="stable")
        pts0, ang, octv, desc = pts0[order], ang[order], octv[order], desc[order]
        h, w = gray.shape
        xi = np.clip(pts0[:, 0].astype(np.int64), 0, w - 1)
        yi = np.clip(pts0[:, 1].astype(np.int64), 0, h - 1)
        keep = depth_m[yi, xi] > 0.0               # depth gate
        if selected_pixels is None or len(selected_pixels) == 0:
            keep[:] = False                        # CVO gate
        if np.any(keep):
            sel = np.flatnonzero(keep)
            ck = np.ascontiguousarray(
                pts0[sel], np.float64).view(np.complex128).ravel()
            _, first = np.unique(ck, return_index=True)
            dup = np.ones(len(sel), bool)
            dup[first] = False
            if self.p.keypoint_distance > 0.0:
                # min-distance gate: greedy first-come via grid hash
                cell = max(np.sqrt(self.p.keypoint_distance), 1e-6)
                grid = {}
                for j in np.flatnonzero(~dup):
                    i = sel[j]
                    cx, cy = int(pts0[i, 0] / cell), int(pts0[i, 1] / cell)
                    ok = True
                    for gx in (cx - 1, cx, cx + 1):
                        for gy in (cy - 1, cy, cy + 1):
                            for q in grid.get((gx, gy), ()):
                                if (q[0] - pts0[i, 0]) ** 2 + \
                                   (q[1] - pts0[i, 1]) ** 2 \
                                   <= self.p.keypoint_distance:
                                    ok = False
                                    break
                    if ok:
                        grid.setdefault((cx, cy), []).append(
                            (pts0[i, 0], pts0[i, 1]))
                    else:
                        dup[j] = True
            keep[sel[dup]] = False
        if not np.any(keep):
            return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                    np.zeros((0, 32), np.uint8))
        kp = np.concatenate([pts0[keep], octv[keep][:, None]], axis=1)
        return kp, ang[keep], np.ascontiguousarray(desc[keep])


def make_extractor(cam: CameraConfig):
    p = OrbParams(
        n_features=cam.orb_n_features, scale_factor=cam.orb_scale_factor,
        n_levels=cam.orb_n_levels, ini_th_fast=cam.orb_ini_th_fast,
        min_th_fast=cam.orb_min_th_fast,
        keypoint_distance=cam.orb_keypoint_distance)
    backend = getattr(cam, "orb_backend", "opencv")
    return OpenCVOrbExtractor(p) if backend == "opencv" else OrbExtractor(p)


class KeyframeFeatureHook:
    """Hook attached to LocalTracker keyframe creation: ORB extraction
    (local_tracker.cpp:292-300). The vocabulary step (`bow`) is run by the
    backend graph when the keyframe's map reaches it (KeyframeGraph's
    `keyframe_bow`): between the same two backend events as at creation, so
    the vocabulary sees the same sequence of documents, and only the
    backend's thread touches it (the async backend runs beside the
    tracker). Exposed as an object so the vocabulary can be
    checkpointed/restored alongside the session."""

    def __init__(self, cam: CameraConfig, cfg: SlamConfig, vocabulary=None,
                 vocabulary_path: str = ""):
        self.extractor = make_extractor(cam)
        if vocabulary is None:
            if vocabulary_path:
                from .bow import load_orbvoc_text
                vocabulary = load_orbvoc_text(vocabulary_path)
            else:
                from .bow import default_vocabulary
                vocabulary = default_vocabulary()
        self.voc = vocabulary
        self.last_ms = 0.0   # keyframe feature cost, surfaced in metrics

    def __call__(self, kf):
        import time
        t0 = time.perf_counter()
        kp, ang, desc = self.extractor.extract(kf.gray, kf.depth_m,
                                               kf.selected_pixels)
        kf.keypoints = kp
        kf.kp_angle = ang
        kf.descriptors = desc
        self.last_ms = (time.perf_counter() - t0) * 1e3

    def bow(self, kf):
        """Add the keyframe's descriptors to an online vocabulary (no-op for
        a loaded DBoW2 vocabulary, which has no add_document) and set its
        BoW and feature vectors."""
        add = getattr(self.voc, "add_document", None)
        if add is not None:
            add(kf.descriptors)
        kf.bow_vec, kf.feat_vec = self.voc.transform(kf.descriptors,
                                                     levelsup=4)
        kf.bow_version = getattr(self.voc, "version", 0)


def keyframe_feature_hook(cam: CameraConfig, cfg: SlamConfig,
                          vocabulary_path: str = ""):
    return KeyframeFeatureHook(cam, cfg, vocabulary_path=vocabulary_path)
