"""Loop-closure geometric verification: BoW matching, RANSAC, pose refine,
landmark management (port of cvo_slam_tpu.features.matcher, host path).

Re-expression of the active code of reference ORBmatcher
(reference src/ORBmatcher.cpp):

  * match_bow: FeatureVector-bucketed mutual-best descriptor matching with
    TH_LOW=50 + nn-ratio test (:136-217) and the 30-bin rotation-histogram
    filter keeping the three dominant bins (:219-257, ComputeThreeMaxima).
  * RANSAC (:428-645): 100 4-point samples; per hypothesis a 2-D homography
    warp check (<=3 px) and a Kabsch rigid transform with bidirectional 3-D
    reprojection checks (<=8 px). All 100 hypotheses are evaluated in one
    batched pass (batched normalized-DLT homographies + batched Kabsch SVDs)
    instead of the reference's sequential host loop.
  * optimize_relative_transformation (:2407-2457): pose-only LM over the
    inlier projections (EdgeSE3ProjectionOnlyPose residuals, Cauchy kernel,
    information I2 * invLevelSigma2[octave], 20 iterations).
  * landmark management: triangulated map points with the full epipolar /
    parallax / reprojection / scale-consistency gate chain
    (CreateNewMapPoints :1579-1748), projection-based linking of existing
    points (:2102-2142), covisibility counting -> best-covisible list
    (>=15 shared points, top 10, :2229-2246), 500-landmark/keyframe cap.

Deviation: RANSAC sampling uses a seeded generator (the reference draws from
std::random_device — nondeterministic run-to-run); deterministic here.

Descriptor matching: `match_bow` on the host, and for large problems on
a CUDA device `dispatch_match_bow` / `fetch_match_bow`, which compute the
same best-two reduction in torch with byte-identical pairs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import CameraConfig, SlamConfig
from ..tracking.types import Keyframe
from .bow import _popcount_sum

TH_LOW = 50
HISTO_LENGTH = 30
MAX_LANDMARKS_PER_KF = 500


@dataclass
class Mappoint:
    """Reference include/map_point.h:16-48."""
    id: int
    position: np.ndarray                 # (3,) world
    normal: np.ndarray                   # (3,) mean viewing direction
    keypoints_id: Dict[int, int] = field(default_factory=dict)  # kf id -> kp

    def erase_observation(self, kf_id: int) -> int:
        return self.keypoints_id.pop(kf_id, -1)


def descriptor_distances(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    x = np.bitwise_xor(d1[:, None, :], d2[None, :, :])
    return _popcount_sum(x)


def _three_maxima(hist_counts: np.ndarray) -> List[int]:
    """ComputeThreeMaxima: indexes of the three largest bins, dropping bins
    below 0.1x the maximum."""
    order = np.argsort(-hist_counts, kind="stable")[:3]
    keep = [int(order[0])]
    m = hist_counts[order[0]]
    if len(order) > 1 and hist_counts[order[1]] >= 0.1 * m:
        keep.append(int(order[1]))
        if len(order) > 2 and hist_counts[order[2]] >= 0.1 * m:
            keep.append(int(order[2]))
    return keep


def _best_two_rows(D: np.ndarray):
    """Per-row (first-minimum index, best value, second-best value) — the
    vectorized equivalent of the reference's per-keypoint scan keeping
    bestDist/bestDist2 in encounter order (ORBmatcher.cpp:158-183): argmin
    returns the FIRST minimum, and with ties the second-best equals the
    best, both matching the sequential '<' updates."""
    idx = D.argmin(axis=1)
    ar = np.arange(D.shape[0])
    best = D[ar, idx].copy()
    if D.shape[1] > 1:
        D[ar, idx] = 1 << 30
        second = D.min(axis=1)
        D[ar, idx] = best
    else:
        second = np.full(D.shape[0], 256, D.dtype)
    return idx, best, second


_MATCH_CHUNK = 256   # rows per distance-matrix chunk (bounds the (r, n2, 32)
                     # xor temporary to ~40 MB at 5000 candidate descriptors)


def _gate_node(ref, cur, i1, i2, idx, best, second, nn_ratio,
               pairs_list, rots_list):
    """Ratio + TH_LOW gates and rotation binning for one bucket's best-two
    results."""
    keep = (best < TH_LOW) & (best < nn_ratio * second)
    if not keep.any():
        return
    r_idx = i1[keep]
    c_idx = i2[idx[keep]]
    pairs_list.append(np.stack([r_idx, c_idx], 1))
    rot = (ref.kp_angle[r_idx] - cur.kp_angle[c_idx]).astype(np.float64)
    rot = np.where(rot < 0.0, rot + 360.0, rot)
    b = np.round(rot * (HISTO_LENGTH / 360.0)).astype(np.int64)
    rots_list.append(np.where(b == HISTO_LENGTH, 0, b))


def _assemble_pairs(pairs_list, rots_list, check_orientation):
    if not pairs_list:
        return np.zeros((0, 2), np.int64)
    pairs = np.concatenate(pairs_list)
    if check_orientation:
        rots = np.concatenate(rots_list)
        hist = np.bincount(rots, minlength=HISTO_LENGTH)
        keep_bins = np.zeros(HISTO_LENGTH, bool)
        keep_bins[_three_maxima(hist)] = True
        pairs = pairs[keep_bins[rots]]
    return pairs


def match_bow(ref: Keyframe, cur: Keyframe, nn_ratio: float,
              check_orientation: bool = True):
    """Matched (ref_idx, cur_idx) pairs (ORBmatcher.cpp:136-257).

    Fully vectorized per FeatureVector bucket (the reference loops keypoint-
    by-keypoint): chunked distance matrix -> per-row best/second -> ratio +
    TH_LOW gates -> rotation histogram, identical accept decisions in
    identical order. With the online-grown vocabulary (L=3, levelsup=4) the
    bucket level degenerates to the root — one brute-force bucket — which
    made the per-keypoint Python loop the dominant host cost of a loop-
    closure round (~0.25 s/candidate at 5000 features)."""
    if not ref.feat_vec or not cur.feat_vec or ref.descriptors is None \
            or cur.descriptors is None or len(cur.descriptors) == 0:
        return np.zeros((0, 2), np.int64)
    pairs_list = []
    rots_list = []
    common = sorted(set(ref.feat_vec) & set(cur.feat_vec))
    for node in common:
        i1 = np.asarray(ref.feat_vec[node], np.int64)
        i2 = np.asarray(cur.feat_vec[node], np.int64)
        d1 = ref.descriptors[i1]
        d2 = cur.descriptors[i2]
        idx = np.empty(len(i1), np.int64)
        best = np.empty(len(i1), np.int64)
        second = np.empty(len(i1), np.int64)
        for s in range(0, len(i1), _MATCH_CHUNK):
            e = min(s + _MATCH_CHUNK, len(i1))
            ix, b1, b2 = _best_two_rows(descriptor_distances(d1[s:e], d2))
            idx[s:e], best[s:e], second[s:e] = ix, b1, b2
        _gate_node(ref, cur, i1, i2, idx, best, second, nn_ratio,
                   pairs_list, rots_list)
    return _assemble_pairs(pairs_list, rots_list, check_orientation)


# ---------------------------------------------------------------------------
# device-side descriptor matching (the loop-closure host-phase hot spot)
# ---------------------------------------------------------------------------
# With the default online-grown vocabulary the FeatureVector bucket level
# degenerates to the root, so match_bow brute-forces a ~5000x5000 Hamming
# matrix per candidate on the host. The distance matrix and the per-row
# best-two reduction move to the device; all accept logic (ratio + TH_LOW
# gates, rotation histogram) stays on the host, byte-identical.

DEV_MIN_PAIRS = 262144    # below this the device round trip wins nothing
_BIG = 1 << 30            # distance of a pair in two different buckets


def _words(desc: np.ndarray, device) -> torch.Tensor:
    """(n, 32) uint8 descriptors -> (n, 8) int64 tensor of their uint32
    words. The words are nonnegative in int64, so >> shifts in zeros."""
    w = np.ascontiguousarray(desc, np.uint8).view(np.uint32)
    return torch.from_numpy(w.astype(np.int64)).to(device)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR bit count of int64 tensors holding uint32 values (torch has no
    popcount op), in place."""
    t = x >> 1
    x -= t.bitwise_and_(0x55555555)
    t = x >> 2
    x.bitwise_and_(0x33333333).add_(t.bitwise_and_(0x33333333))
    x.add_(x >> 4).bitwise_and_(0x0F0F0F0F)
    return x.mul_(0x01010101).bitwise_and_(0xFFFFFFFF).bitwise_right_shift_(24)


def best_two_device(d1w, d2w, n1id, n2id):
    """Per row of d1w: (first-minimum index, best, second best) Hamming
    distance to the rows of d2w, over pairs of the same node id; a pair of
    two nodes is at _BIG. The distance matrix is one (n1, n2) int32 sum of
    the 8 words' bit counts."""
    D = torch.zeros((d1w.shape[0], d2w.shape[0]), dtype=torch.int32,
                    device=d1w.device)
    for w in range(d1w.shape[1]):
        D += _popcount32(d1w[:, w, None] ^ d2w[None, :, w]).to(torch.int32)
    D = torch.where(n1id[:, None] == n2id[None, :], D,
                    torch.full_like(D, _BIG))
    idx = torch.argmin(D, dim=1)          # the first minimum, as the host
    best = D.gather(1, idx[:, None])[:, 0]
    second = D.scatter(1, idx[:, None], _BIG).min(dim=1).values
    return idx, best, second


def dispatch_match_bow(ref: Keyframe, cur: Keyframe, device,
                       force: bool = False):
    """Issue the bucketed best-two reduction on `device`; returns an opaque
    future for fetch_match_bow, or None when the host match_bow should run:
    CVO_SLAM_DEV_MATCH=0, a CPU device, no common buckets, or fewer than
    DEV_MIN_PAIRS descriptor pairs. Buckets are encoded as node ids, so any
    FeatureVector structure maps to one masked (n1, n2) matrix, with the
    matches of the per-node host loop. force=True skips the device and
    size gates (parity tests run it on the CPU)."""
    device = torch.device(device)
    if not force and (os.environ.get("CVO_SLAM_DEV_MATCH", "1") == "0"
                      or device.type == "cpu"):
        return None
    if not ref.feat_vec or not cur.feat_vec or ref.descriptors is None \
            or cur.descriptors is None or len(cur.descriptors) == 0:
        return None
    common = sorted(set(ref.feat_vec) & set(cur.feat_vec))
    if not common:
        return None
    i1 = [np.asarray(ref.feat_vec[node], np.int64) for node in common]
    i2 = [np.asarray(cur.feat_vec[node], np.int64) for node in common]
    if not force and sum(len(a) * len(b) for a, b in zip(i1, i2)) \
            < DEV_MIN_PAIRS:
        return None
    n1 = np.concatenate([np.full(len(a), nd) for nd, a in enumerate(i1)])
    n2 = np.concatenate([np.full(len(b), nd) for nd, b in enumerate(i2)])
    i1, i2 = np.concatenate(i1), np.concatenate(i2)   # node order
    out = best_two_device(_words(ref.descriptors[i1], device),
                          _words(cur.descriptors[i2], device),
                          torch.from_numpy(n1).to(device),
                          torch.from_numpy(n2).to(device))
    return i1, i2, out


def fetch_match_bow(fut, ref: Keyframe, cur: Keyframe, nn_ratio: float,
                    check_orientation: bool = True):
    """Complete dispatch_match_bow: copy (idx, best, second) to the host
    and apply the same gates and histogram as match_bow. A bucket with one
    candidate descriptor has second = _BIG, which gates as the host's
    second = 256 (the ratio bound 0.7 * 256 > TH_LOW never binds)."""
    i1, i2, out = fut
    idx, best, second = (t.cpu().numpy().astype(np.int64) for t in out)
    pairs_list, rots_list = [], []
    _gate_node(ref, cur, i1, i2, idx, best, second, nn_ratio,
               pairs_list, rots_list)
    return _assemble_pairs(pairs_list, rots_list, check_orientation)


def kabsch(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rigid transform src->dst (computeRigidTransformSVD, :2356-2405).
    NOTE: replicates the reference exactly, including the absence of a
    reflection (det) correction — degenerate samples yield reflections that
    the reprojection gates then reject."""
    cs = src.mean(0)
    cd = dst.mean(0)
    H = (dst - cd).T @ (src - cs)
    U, _, Vt = np.linalg.svd(H)
    R = U @ Vt
    t = cd - R @ cs
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def kabsch_batched(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(S,4,3)x(S,4,3) -> (S,3,4) [R|t], vectorized kabsch (same math,
    batched SVD, still no reflection correction)."""
    cs = src.mean(1, keepdims=True)
    cd = dst.mean(1, keepdims=True)
    H = np.einsum("ski,skj->sij", dst - cd, src - cs)
    U, _, Vt = np.linalg.svd(H)
    R = U @ Vt
    t = cd[:, 0, :] - np.einsum("sij,sj->si", R, cs[:, 0, :])
    return np.concatenate([R, t[:, :, None]], axis=2)


def homography_batched(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 4-point homographies src->dst, (S,4,2)x(S,4,2) -> (S,3,3).

    Batched normalized DLT (the math behind cv2.findHomography on a minimal
    sample): Hartley-normalize both point sets, solve the 8x9 nullspace by
    SVD, denormalize. Degenerate (collinear) samples yield an arbitrary
    nullspace vector whose warp the 3-px gate then rejects — equivalent to
    the reference skipping cv2's nullptr return."""
    S = src.shape[0]

    def normalize(pts):
        c = pts.mean(1, keepdims=True)                     # (S,1,2)
        d = np.linalg.norm(pts - c, axis=2).mean(1)        # (S,)
        s = np.sqrt(2.0) / np.maximum(d, 1e-12)
        T = np.zeros((S, 3, 3))
        T[:, 0, 0] = s
        T[:, 1, 1] = s
        T[:, 2, 2] = 1.0
        T[:, :2, 2] = -s[:, None] * c[:, 0, :]
        return (pts - c) * s[:, None, None], T

    sn, Ts = normalize(src)
    dn, Td = normalize(dst)
    A = np.zeros((S, 8, 9))
    x, y = sn[:, :, 0], sn[:, :, 1]
    u, v = dn[:, :, 0], dn[:, :, 1]
    A[:, 0::2, 0] = -x
    A[:, 0::2, 1] = -y
    A[:, 0::2, 2] = -1.0
    A[:, 0::2, 6] = u * x
    A[:, 0::2, 7] = u * y
    A[:, 0::2, 8] = u
    A[:, 1::2, 3] = -x
    A[:, 1::2, 4] = -y
    A[:, 1::2, 5] = -1.0
    A[:, 1::2, 6] = v * x
    A[:, 1::2, 7] = v * y
    A[:, 1::2, 8] = v
    _, _, Vt = np.linalg.svd(A)
    Hn = Vt[:, -1, :].reshape(S, 3, 3)
    # denormalize: H = Td^-1 Hn Ts
    Td_inv = np.linalg.inv(Td)
    return Td_inv @ Hn @ Ts


def optimize_relative_transformation(kps_2d: np.ndarray, pts_3d: np.ndarray,
                                     inv_level_sigma2: np.ndarray,
                                     octaves: np.ndarray, K: np.ndarray,
                                     T_cr: np.ndarray, delta: float,
                                     iterations: int = 20) -> np.ndarray:
    """Pose-only LM (ORBmatcher.cpp:2407-2457). The vertex stores E =
    T_cr^{-1} ('setEstimateInv(T_SE3Quat)' with T_SE3Quat = T_cr); the
    residual projects reference-frame points through E into the current
    image. Returns the refined T_cr (= E^{-1})."""
    E = np.linalg.inv(T_cr)
    fx, fy = K[0, 0], K[1, 1]
    w = inv_level_sigma2[octaves]

    def residuals_jac(E):
        P = pts_3d @ E[:3, :3].T + E[:3, 3]
        z = P[:, 2]
        u = K[0, 0] * P[:, 0] / z + K[0, 2]
        v = K[1, 1] * P[:, 1] / z + K[1, 2]
        e = kps_2d - np.stack([u, v], 1)              # (N,2)
        # J = -1/z * A * B (vertex_and_edge.cpp:271-291)
        A = np.zeros((len(P), 2, 3))
        A[:, 0, 0] = fx
        A[:, 0, 2] = -(fx * P[:, 0]) / z
        A[:, 1, 1] = fy
        A[:, 1, 2] = -(fy * P[:, 1]) / z
        B = np.zeros((len(P), 3, 6))
        B[:, 0, 1] = P[:, 2]
        B[:, 0, 2] = -P[:, 1]
        B[:, 1, 0] = -P[:, 2]
        B[:, 1, 2] = P[:, 0]
        B[:, 2, 0] = P[:, 1]
        B[:, 2, 1] = -P[:, 0]
        B[:, :, 3:] = np.eye(3)[None]
        J = (-1.0 / z)[:, None, None] * (A @ B)       # d e / d xi
        return e, J

    lam = -1.0
    ni = 2.0
    d2 = delta * delta if delta > 0 else None

    def chi2_of(E):
        e, _ = residuals_jac(E)
        c = w * np.sum(e * e, axis=1)
        if d2 is None:
            return c.sum()
        return (d2 * np.log1p(c / d2)).sum()

    from ..ops import se3

    LAM_MAX = 1e12   # damping this high means dx ~ 0; further tries are noise
    chi2 = chi2_of(E)
    for _ in range(iterations):
        e, J = residuals_jac(E)
        c = w * np.sum(e * e, axis=1)
        rw = w if d2 is None else w / (1.0 + c / d2)
        H = np.einsum("nki,n,nkj->ij", J, rw, J)
        b = -np.einsum("nki,n,nk->i", J, rw, e)
        if lam < 0:
            lam = 1e-5 * np.max(np.diag(H))
        if lam >= LAM_MAX:
            break
        for _try in range(10):
            try:
                dx = np.linalg.solve(H + lam * np.eye(6), b)
            except np.linalg.LinAlgError:
                lam = min(lam * ni, LAM_MAX)
                ni *= 2
                continue
            # host-side exp in float64 (a device call per LM step would
            # cost a host-device round trip each)
            E_try = se3.exp_se3_np(dx) @ E
            c_new = chi2_of(E_try)
            rho = (chi2 - c_new) / (dx @ (lam * dx + b) + 1e-3)
            if rho > 0 and np.isfinite(c_new):
                E = E_try
                chi2 = c_new
                lam *= max(1.0 / 3.0, 1.0 - (2 * rho - 1) ** 3)
                ni = 2.0
                break
            lam = min(lam * ni, LAM_MAX)
            ni *= 2
            if lam >= LAM_MAX:
                break
    return np.linalg.inv(E)


class Matcher:
    """Holds per-detection-round covisibility state (the reference ORBmatcher
    member keyframe_map_point_pairs, cleared in ReleasePoseOptimizer)."""

    def __init__(self, cam: CameraConfig, cfg: SlamConfig, scale_factor=1.2,
                 n_levels=8):
        self.cam = cam
        self.cfg = cfg
        self.K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                           [0, 0, 1.0]], np.float64)
        self.scale_factors = scale_factor ** np.arange(n_levels)
        self.level_sigma2 = self.scale_factors ** 2
        self.inv_level_sigma2 = 1.0 / self.level_sigma2
        self.scale_factor = scale_factor
        self.kf_map_point_pairs: Dict[int, int] = {}
        self.rng = np.random.default_rng(0xC0FFEE)

    def reset_round(self):
        self.kf_map_point_pairs = {}

    # -- GetInitialTransformation (active path) ---------------------------
    def get_initial_transformation(self, reference: Keyframe, current: Keyframe,
                                   map_points: Dict[int, Mappoint],
                                   next_mappoint_id: List[int], pairs=None):
        """Returns (ok, matches, T_cr_refined). Side effects: landmark
        creation/linking + covisibility accumulation. `pairs` (optional):
        a precomputed match_bow result."""
        cfg = self.cfg
        if pairs is None:
            pairs = match_bow(reference, current, cfg.LC_MatchThreshold)
        nmatches = len(pairs)
        if nmatches < cfg.LC_MinMatch:
            return False, 0, None

        # 3-D back-projection of matches with valid depth on both sides
        fx, fy, cx, cy = (self.K[0, 0], self.K[1, 1], self.K[0, 2],
                          self.K[1, 2])
        r_xy = reference.keypoints[pairs[:, 0], :2]
        c_xy = current.keypoints[pairs[:, 1], :2]
        r_dep = reference.depth_m[r_xy[:, 1].astype(int), r_xy[:, 0].astype(int)]
        c_dep = current.depth_m[c_xy[:, 1].astype(int), c_xy[:, 0].astype(int)]
        ok = (r_dep > 0) & (c_dep > 0)
        if ok.sum() < cfg.LC_MinMatch:
            return False, 0, None
        pairs = pairs[ok]
        r_xy, c_xy = r_xy[ok], c_xy[ok]
        r_dep, c_dep = r_dep[ok], c_dep[ok]
        r_pc = np.stack([(r_xy[:, 0] - cx) * r_dep / fx,
                         (r_xy[:, 1] - cy) * r_dep / fy, r_dep], 1)
        c_pc = np.stack([(c_xy[:, 0] - cx) * c_dep / fx,
                         (c_xy[:, 1] - cy) * c_dep / fy, c_dep], 1)
        n = len(pairs)

        # RANSAC: homography warp gate + Kabsch + bidirectional reprojection,
        # all 100 hypotheses evaluated in ONE batched pass (the reference
        # loops host-side per hypothesis with per-call cv2/SVD work,
        # ORBmatcher.cpp:428-645; same samples, same gates, same
        # first-strict-maximum winner).
        S = 100
        # one vectorized draw of S distinct-4 samples (uniform over 4-subsets;
        # the hypothesis math is order-invariant) — replaces 100 sequential
        # rng.choice calls, the last Python loop in this pass
        keys = self.rng.random((S, n))
        sel = np.argpartition(keys, 3, axis=1)[:, :4]             # (S,4)
        with np.errstate(divide="ignore", invalid="ignore"):
            Hs = homography_batched(c_xy[sel].astype(np.float64),
                                    r_xy[sel].astype(np.float64))  # (S,3,3)
            ch = np.concatenate([c_xy, np.ones((n, 1))], 1)        # (n,3)
            warped = np.einsum("sij,nj->sni", Hs, ch)
            w = warped[:, :, 2:3]
            warped2 = warped[:, :, :2] / np.where(np.abs(w) > 1e-12, w, np.nan)
            e2d = np.sum((warped2 - r_xy[None]) ** 2, axis=2)      # (S,n)

            Rt = kabsch_batched(c_pc[sel].astype(np.float64),
                                r_pc[sel].astype(np.float64))      # (S,3,4)
            R, t = Rt[:, :, :3], Rt[:, :, 3]
            p_in_r = np.einsum("sij,nj->sni", R, c_pc) + t[:, None, :]
            proj_r = p_in_r @ self.K.T
            pr = proj_r[:, :, :2] / proj_r[:, :, 2:3]
            e3d_1 = np.sum((pr - r_xy[None]) ** 2, axis=2)
            tin = -np.einsum("sji,sj->si", R, t)                   # -R^T t
            p_in_c = np.einsum("sji,nj->sni", R, r_pc) + tin[:, None, :]
            proj_c = p_in_c @ self.K.T
            pc2 = proj_c[:, :, :2] / proj_c[:, :, 2:3]
            e3d_2 = np.sum((pc2 - c_xy[None]) ** 2, axis=2)
        good = ((e2d <= 9.0) & (e3d_1 <= 64.0) & (e3d_2 <= 64.0)
                & np.isfinite(e2d) & np.isfinite(e3d_1) & np.isfinite(e3d_2))
        counts = good.sum(axis=1)                                  # (S,)
        best_s = int(np.argmax(counts))   # first maximum = sequential '>'
        if counts[best_s] < max(cfg.LC_MinMatch, 1):
            return False, 0, None
        best_inliers = np.flatnonzero(good[best_s])
        best_T = np.eye(4)
        best_T[:3, :3] = R[best_s]
        best_T[:3, 3] = t[best_s]
        if len(best_inliers) < cfg.LC_MinMatch:
            return False, 0, None

        inl_pairs = pairs[best_inliers]
        # pose-only refinement over inliers (current keypoints vs reference
        # 3-D points)
        octv = current.keypoints[inl_pairs[:, 1], 2].astype(int)
        T_ref = optimize_relative_transformation(
            current.keypoints[inl_pairs[:, 1], :2], r_pc[best_inliers],
            self.inv_level_sigma2, octv, self.K, best_T,
            cfg.RobustKernelDelta if cfg.UseRobustKernel else 0.0)

        self._manage_landmarks(reference, current, inl_pairs,
                               map_points, next_mappoint_id)
        return True, int(len(best_inliers)), T_ref

    # -- landmark management (ORBmatcher.cpp:1146-1217) -------------------
    def _manage_landmarks(self, reference: Keyframe, current: Keyframe,
                          inl_pairs: np.ndarray,
                          map_points: Dict[int, Mappoint],
                          next_mappoint_id: List[int]):
        r_E = np.linalg.inv(reference.pose)   # world->ref cam
        c_E = np.linalg.inv(current.pose)
        r_R, r_t = reference.pose[:3, :3], reference.pose[:3, 3]
        c_R, c_t = current.pose[:3, :3], current.pose[:3, 3]
        # fundamental matrix of current w.r.t. reference (:1136-1143)
        R_cr = r_E[:3, :3] @ c_E[:3, :3].T
        t_cr = -R_cr @ c_E[:3, 3] + r_E[:3, 3]
        tx = np.array([[0, -t_cr[2], t_cr[1]], [t_cr[2], 0, -t_cr[0]],
                       [-t_cr[1], t_cr[0], 0]])
        F = np.linalg.inv(self.K.T) @ tx @ R_cr @ np.linalg.inv(self.K)

        for r_idx, c_idx in inl_pairs:
            r_has = int(r_idx) in reference.mappoints_id
            c_has = int(c_idx) in current.mappoints_id
            if not r_has and not c_has:
                if (len(reference.mappoints_id) >= MAX_LANDMARKS_PER_KF
                        or len(current.mappoints_id) >= MAX_LANDMARKS_PER_KF):
                    continue
                mp = self._create_map_point(int(r_idx), int(c_idx), reference,
                                            current, F, next_mappoint_id)
                if mp is not None:
                    map_points[mp.id] = mp
                    self.kf_map_point_pairs[current.id] = \
                        self.kf_map_point_pairs.get(current.id, 0) + 1
            elif not r_has and c_has:
                if len(reference.mappoints_id) >= MAX_LANDMARKS_PER_KF:
                    continue
                mp = map_points[current.mappoints_id[int(c_idx)]]
                self._check_existing_by_projection(reference, mp, int(r_idx))
            # reference-has / both-have branches are empty in the reference

    def _create_map_point(self, r_idx: int, c_idx: int, reference: Keyframe,
                          current: Keyframe, F: np.ndarray,
                          next_mappoint_id: List[int]) -> Optional[Mappoint]:
        """CreateNewMapPoints gate chain + linear triangulation
        (:1579-1748)."""
        K = self.K
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        r_kp = reference.keypoints[r_idx]
        c_kp = current.keypoints[c_idx]
        r_oct = int(r_kp[2])
        c_oct = int(c_kp[2])
        ratio_factor = 1.5 * self.scale_factor
        r_pose, c_pose = reference.pose, current.pose
        r_t, c_t = r_pose[:3, 3], c_pose[:3, 3]
        baseline = np.linalg.norm(r_t - c_t)
        if baseline < self.cam.bf / fx:
            return None
        c_E = np.linalg.inv(c_pose)
        # epipole distance gate (:1600-1607)
        P_r_in_c = c_E[:3, :3] @ r_t + c_E[:3, 3]
        ex = fx * P_r_in_c[0] / P_r_in_c[2] + cx
        ey = fy * P_r_in_c[1] / P_r_in_c[2] + cy
        if (ex - c_kp[0]) ** 2 + (ey - c_kp[1]) ** 2 \
                < 100 * self.scale_factors[c_oct]:
            return None
        # epipolar line distance (:2.84 sigma gate, CheckDistEpipolarLine)
        a = r_kp[0] * F[0, 0] + r_kp[1] * F[1, 0] + F[2, 0]
        b = r_kp[0] * F[0, 1] + r_kp[1] * F[1, 1] + F[2, 1]
        c = r_kp[0] * F[0, 2] + r_kp[1] * F[1, 2] + F[2, 2]
        num = a * c_kp[0] + b * c_kp[1] + c
        den = a * a + b * b
        if den == 0 or num * num / den >= 3.84 * self.level_sigma2[c_oct]:
            return None
        # parallax + linear triangulation (:1610-1640)
        xn1 = np.array([(r_kp[0] - cx) / fx, (r_kp[1] - cy) / fy, 1.0])
        xn2 = np.array([(c_kp[0] - cx) / fx, (c_kp[1] - cy) / fy, 1.0])
        ray1 = r_pose[:3, :3] @ xn1
        ray2 = c_pose[:3, :3] @ xn2
        cos_par = ray1 @ ray2 / (np.linalg.norm(ray1) * np.linalg.norm(ray2))
        if not (0 < cos_par < 0.9998):
            return None
        r_E = np.linalg.inv(r_pose)
        A = np.zeros((4, 4))
        A[0] = xn1[0] * r_E[2, :] - r_E[0, :]
        A[1] = xn1[1] * r_E[2, :] - r_E[1, :]
        A[2] = xn2[0] * c_E[2, :] - c_E[0, :]
        A[3] = xn2[1] * c_E[2, :] - c_E[1, :]
        _, _, Vt = np.linalg.svd(A)
        x4 = Vt[3]
        if x4[3] == 0:
            return None
        x3d = x4[:3] / x4[3]
        # cheirality + reprojection gates (:1643-1672)
        for E, kp in ((r_E, r_kp), (c_E, c_kp)):
            p = E[:3, :3] @ x3d + E[:3, 3]
            if p[2] <= 0:
                return None
            u = fx * p[0] / p[2] + cx
            v = fy * p[1] / p[2] + cy
            if (u - kp[0]) ** 2 + (v - kp[1]) ** 2 > 9.0:
                return None
        # scale consistency (:1675-1683)
        n1 = x3d - r_t
        n2 = x3d - c_t
        d1, d2 = np.linalg.norm(n1), np.linalg.norm(n2)
        if d1 == 0 or d2 == 0:
            return None
        ratio_dist = d2 / d1
        ratio_oct = self.scale_factors[r_oct] / self.scale_factors[c_oct]
        if ratio_dist * ratio_factor < ratio_oct \
                or ratio_dist > ratio_oct * ratio_factor:
            return None
        normal = n1 / d1 + n2 / d2
        normal = normal / np.linalg.norm(normal)
        mid = next_mappoint_id[0]
        next_mappoint_id[0] += 2
        mp = Mappoint(mid, x3d.copy(), normal)
        mp.keypoints_id[reference.id] = r_idx
        mp.keypoints_id[current.id] = c_idx
        reference.mappoints_id[r_idx] = mid
        current.mappoints_id[c_idx] = mid
        return mp

    def _check_existing_by_projection(self, keyframe: Keyframe, mp: Mappoint,
                                      kp_idx: int) -> bool:
        """(:2102-2142): link an existing landmark if it reprojects within
        8 px of the keypoint; accumulate covisibility for all its observers."""
        E = np.linalg.inv(keyframe.pose)
        p = E[:3, :3] @ mp.position + E[:3, 3]
        if p[2] <= 0:
            return False
        proj = self.K @ p
        x, y = proj[0] / proj[2], proj[1] / proj[2]
        kp = keyframe.keypoints[kp_idx]
        if (x - kp[0]) ** 2 + (y - kp[1]) ** 2 > 64.0:
            return False
        for obs_kf in mp.keypoints_id:
            self.kf_map_point_pairs[obs_kf] = \
                self.kf_map_point_pairs.get(obs_kf, 0) + 1
        mp.keypoints_id[keyframe.id] = kp_idx
        keyframe.mappoints_id[kp_idx] = mp.id
        return True

    def best_covisible(self, reference: Keyframe):
        """GetBestCovisibleKeyframeList (:2229-2246): keyframes sharing >=15
        landmarks, top 10 by count, into reference.best_covisible."""
        cands = [(cnt, kfid) for kfid, cnt in self.kf_map_point_pairs.items()
                 if cnt >= 15]
        if not cands:
            return
        cands.sort(reverse=True)
        for cnt, kfid in cands[:10]:
            reference.best_covisible.append(kfid)
