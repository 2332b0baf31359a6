"""Loop-closure detection: BoW top-10 candidates -> ORB/RANSAC prior -> CVO
verification (port of cvo_slam_tpu.backend.loop_closure).

Re-expression of reference detectLoopClousure_top10
(reference src/keyframe_graph.cpp:601-746): score the new keyframe
against every earlier keyframe except the last two, visit the 10 best; for
each candidate run the ORB matcher's RANSAC pipeline for an initial
transform, re-register with a fresh CVO state seeded with that prior
(reset_initial(lc_prior) -> set_pcd(ref cloud) -> match_keyframe(cand
cloud)) and accept iff the CVO posterior inner product exceeds the
pre/prior/lc-prior inner products and cos_angle >= 0.1 (:703-714). Accepted
edges go into the global graph with the eigenvalue-floored Hessian as
information.

A host/device pipeline, in the reference's per-candidate order: the
descriptor matching of all candidates is issued to the device up front
(features.matcher.dispatch_match_bow, where the problem is large enough);
then per candidate, in BoW-score order, the host runs ORB RANSAC with its
landmark side effects, and each passing candidate's CVO re-registration
and scoring (cvo.engine.lc_verify_batch on one candidate: the align, then
compute_innerproduct_lc on the pair-stats kernel) is handed to a worker
thread with its own CUDA side stream (device.StreamWorker), so the device
verifies candidate k while the host runs RANSAC for candidate k+1. The
results are read in candidate order, and the accept tests and edge
insertions run on the host in that order. A verification depends on
nothing later RANSAC mutates, so the results equal the sequential loop's
bit for bit. Each round records its stage costs in graph.lc_stage_ms.

Reference quirks kept: the pnpransac prior transform is never assigned in
the active code (uninitialized in C++); the identity is passed. The
per-round covisibility state feeds GetBestCovisibleKeyframeList at the end.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..config import CameraConfig, CvoParams, SlamConfig
from ..cvo import engine
from ..device import StreamWorker
from ..features import matcher as matcher_mod
from ..features.bow import Vocabulary
from ..features.matcher import Matcher
from ..tracking.types import Keyframe, TrackingResult


def _verify(reference: engine.PointCloud, cand: engine.PointCloud,
            lc_prior: np.ndarray, prior: np.ndarray, p: CvoParams,
            backend: str):
    """One candidate's CVO re-registration from the inverse of its RANSAC
    prior, then compute_innerproduct_lc: (transform f64, host lc dict,
    (start, end) of this call on the perf_counter clock)."""
    t0 = time.perf_counter()
    inv = np.linalg.inv(lc_prior)
    (res, lc), = engine.lc_verify_batch(
        reference, [cand], [inv[:3, :3].astype(np.float32)],
        [inv[:3, 3].astype(np.float32)], [np.float32(p.ell_init)],
        [prior.astype(np.float32)], [lc_prior.astype(np.float32)], p,
        backend)
    T = res.transform.cpu().numpy().astype(np.float64)
    return T, engine.to_host(lc), (t0, time.perf_counter())


def make_loop_detector(cam: CameraConfig, cfg: SlamConfig, vocabulary=None):
    """The loop detector KeyframeGraph calls per keyframe event; the CVO
    verification runs where the keyframes' clouds live."""
    matcher = Matcher(cam, cfg, scale_factor=cam.orb_scale_factor,
                      n_levels=cam.orb_n_levels)
    # the verification align, routed as the JAX package's _vmap_backend:
    # under 'pallas' and 'pallas_iter' one align_fused launch per
    # candidate; under 'pallas_mom' the moment-kernel loop
    backend = engine.default_backend()
    verify_backend = "pallas" if backend == "pallas_iter" else backend
    refresh_thread = [None]
    verifier = []   # the StreamWorker, made on the first round's device

    def _refresh_stale(keyframes):
        """Re-transform BoW vectors built under an older vocabulary (the
        growing vocabulary retrains as the map expands; see features.bow)."""
        if vocabulary is None:
            return
        ver = getattr(vocabulary, "version", 0)
        for kf in keyframes:
            if kf.descriptors is not None and len(kf.descriptors) \
                    and getattr(kf, "bow_version", 0) != ver:
                kf.bow_vec, kf.feat_vec = vocabulary.transform(
                    kf.descriptors, levelsup=4)
                kf.bow_version = ver

    def prefetch(graph):
        """Start the post-retrain BoW refresh on a worker thread at the top
        of a keyframe event, so it overlaps the local-map optimize."""
        if vocabulary is None or refresh_thread[0] is not None:
            return
        kfs = list(graph.keyframes())
        ver = getattr(vocabulary, "version", 0)
        if not any(kf.descriptors is not None and len(kf.descriptors)
                   and getattr(kf, "bow_version", 0) != ver for kf in kfs):
            return
        t = threading.Thread(target=_refresh_stale, args=(kfs,), daemon=True)
        t.start()
        refresh_thread[0] = t

    def detect(graph, reference: Keyframe):
        if not hasattr(graph, "matcher"):
            graph.matcher = matcher
        if not hasattr(graph, "next_mappoint_id"):
            graph.next_mappoint_id = [1]   # odd ids (keyframe_graph.cpp:94)

        keyframes = graph.keyframes()
        farthest = reference.id
        if len(keyframes) <= 2 or reference.bow_vec is None:
            return 0, farthest

        # stage costs in ms (refresh = BoW re-transform join; score = BoW
        # scoring; ransac = host ORB matching + RANSAC + landmark
        # bookkeeping, with the verifications issued as it goes; verify =
        # the wait for the verifications after it; overlap = the part of
        # the verifications' own time that ran during the ransac stage),
        # and the descriptor matchings run on the device and on the host
        sub = getattr(graph, "lc_stage_ms", None)
        if sub is None:
            sub = graph.lc_stage_ms = []
        row = {}
        sub.append(row)
        t0 = time.perf_counter()

        if refresh_thread[0] is not None:
            refresh_thread[0].join()
            refresh_thread[0] = None
        _refresh_stale(keyframes)   # no-op when prefetch already ran
        t1 = time.perf_counter()
        row["refresh"] = (t1 - t0) * 1e3

        matcher.reset_round()
        scored = []
        for i in range(len(keyframes) - 2):
            cand = keyframes[i]
            if cand.bow_vec is None:
                continue
            scored.append((Vocabulary.score(reference.bow_vec, cand.bow_vec),
                           i))
        scored.sort(reverse=True)
        t2 = time.perf_counter()
        row["score"] = (t2 - t1) * 1e3

        # phase 1 (host, overlapped with the device): ORB matching +
        # RANSAC prior per candidate in BoW-score order (landmark /
        # covisibility side effects are sequential in the reference,
        # keyframe_graph.cpp:628-684); each passing candidate's
        # verification is issued at once, so the device verifies candidate
        # k while the host runs RANSAC for candidate k+1
        device = reference.cloud.device
        if not verifier:
            verifier.append(StreamWorker(device, "lc-verify"))
        top = [keyframes[i] for _, i in scored[:10]]
        match_futs = [matcher_mod.dispatch_match_bow(reference, cand, device)
                      for cand in top]
        row["n_match_device"] = sum(f is not None for f in match_futs)
        row["n_match_host"] = len(top) - row["n_match_device"]
        cands = []
        for (s, _), cand, mfut in zip(scored, top, match_futs):
            graph.log(f"Checking keyframe {cand.id} with BoW score {s:.4f}")
            pairs = None if mfut is None else matcher_mod.fetch_match_bow(
                mfut, reference, cand, cfg.LC_MatchThreshold)
            ok, matches, T_cr = matcher.get_initial_transformation(
                reference, cand, graph.map_points, graph.next_mappoint_id,
                pairs=pairs)
            if not ok:
                continue
            prior = np.linalg.inv(reference.pose) @ cand.pose
            lc_prior = np.asarray(T_cr, np.float64)
            fut = verifier[0].submit(_verify, reference.cloud, cand.cloud,
                                     lc_prior, prior, cfg.cvo,
                                     verify_backend)
            cands.append((cand, float(s), matches, lc_prior, prior, fut))
        t3 = time.perf_counter()
        row["ransac"] = (t3 - t2) * 1e3

        # phase 2 (device): the verifications, read in candidate order
        verified = [c[5].result() for c in cands]
        row["verify"] = (time.perf_counter() - t3) * 1e3
        row["overlap"] = sum(max(0.0, min(end, t3) - start)
                             for _, _, (start, end) in verified) * 1e3
        row["n_cands"] = len(cands)

        # phase 3 (host): accept tests + edge insertion in candidate order
        # (keyframe_graph.cpp:703-746)
        new_lc = 0
        for (cand, s, matches, lc_prior, prior, _), (T, lc, _) in zip(
                cands, verified):
            result = TrackingResult()
            result.score = s
            result.matches = matches
            result.lc_prior = lc_prior
            result.lc_prior_pnpransac = np.eye(4)
            result.transform = T
            result.inn_prior = float(lc["inn_prior"])
            result.inn_lc_prior = float(lc["inn_lc_prior"])
            result.inn_pre = float(lc["inn_lc_pre"])
            result.inn_post = float(lc["inn_lc_post"])
            result.inn_fixed_pcd = float(lc["inn_fixed"])
            result.inn_moving_pcd = float(lc["inn_moving"])
            result.cos_angle = float(lc["cos_angle"])
            result.inliers_svd = int(lc["inliers_svd"])
            result.inliers_pnpransac = int(lc["inliers_pnpransac"])
            result.post_hessian = np.asarray(lc["post_hessian"], np.float64)
            result.information = result.post_hessian.copy()

            if (result.inn_post <= result.inn_pre
                    or result.inn_post <= result.inn_lc_prior
                    or result.inn_post <= result.inn_prior
                    or result.cos_angle < 0.1):
                graph.log("Final transformation: Reject (inner products)")
                continue
            graph.log(f"Accept loop-closure between keyframe {reference.id} "
                      f"and {cand.id}")
            if cand.id < farthest:
                farthest = cand.id
            graph.insert_loop_closure(reference, cand, result)
            new_lc += 1

        matcher.best_covisible(reference)
        return new_lc, farthest

    detect.prefetch = prefetch
    return detect
