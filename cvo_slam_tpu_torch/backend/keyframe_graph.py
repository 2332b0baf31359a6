"""Global backend: keyframe pose graph + final BA
(port of cvo_slam_tpu.backend.keyframe_graph).

Re-expression of reference KeyframeGraph
(reference src/keyframe_graph.cpp, class KeyframeGraphImpl):

  * add(map) -> newKeyframe (:242-362): insert the completed local map
    (optimize it, lift optimized relative poses into the keyframe's
    frameLists, chain the keyframe pose through the inter-keyframe edge),
    early-abort while <=2 keyframes or within Min_KF_interval frames of the
    last loop-closure check, then loop-closure detection and windowed BA;
    for the last map additionally insert the final keyframe and run the
    all-keyframe BA.
  * insertNewKeyframe (:1742-1798) / insertLastKeyframe (:1800-1820):
    pose chaining `pose_k = pose_{k-1} * Z_{k-1,k}` with the previous map's
    keyframe->last-frame edge result as Z.
  * bundleAdjustmentForAllKeyframes (:1267-1431): in the reference's active
    code this is pose-graph-only: all keyframes, first fixed, every
    relative-pose edge with a Cauchy kernel, FinalOptimizationIterations LM
    iterations on backend.lm, or with a `mesh` on the edge-sharded
    solver (parallel.sharded_lm).
  * refine_frame_lists (an extension over the reference): every local map
    re-optimized with both endpoint keyframes pinned, in one batched LM
    call.
  * loop-closure detection and the windowed BA are pluggable
    (`loop_detector`, `windowed_ba`), and so is the vocabulary step of the
    keyframes' features (`keyframe_bow`, features.orb's hook), which add()
    runs first for the map's keyframes that lack their BoW vectors.

Keyframe vertex ids are even (id_interval_=2, keyframe_graph.cpp:91-97),
landmark ids odd; edge ids even — the loop-closure writer filters on these
(keyframe_tracker.cpp:263-273).
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from .. import spans
from ..config import CameraConfig, SlamConfig
from ..device import resolve_device
from ..parallel import sharded_lm
from ..tracking.local_map import MAX_EDGES, MAX_VERTS, LocalMap
from ..tracking.types import Frame, Keyframe, TrackingResult
from . import lm

ID_INTERVAL = 2


@dataclass
class GraphEdge:
    edge_id: int
    from_id: int      # keyframe vertex id (even)
    to_id: int
    result: TrackingResult


def _pad_to_bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


class KeyframeGraph:

    def __init__(self, cam: CameraConfig, cfg: SlamConfig,
                 loop_detector: Optional[Callable] = None,
                 windowed_ba: Optional[Callable] = None,
                 log: Optional[Callable[[str], None]] = None,
                 device="cuda", keyframe_bow: Optional[Callable] = None,
                 mesh=None):
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        self.loop_detector = loop_detector
        self.windowed_ba = windowed_ba
        self.keyframe_bow = keyframe_bow
        # with a parallel.mesh.Mesh the final all-keyframe BA runs on the
        # edge-sharded pcg solver; the windowed BA is routed by
        # make_windowed_ba
        self.mesh = mesh
        self._keyframes: List[Keyframe] = []
        self.edges: List[GraphEdge] = []
        self.lc_num = 0
        self.keyframe_vertex_id = 0
        self.keyframe_edge_id = 0
        self.current_kf_dist = 0
        self.last_to_current: Optional[TrackingResult] = None
        self.log = log or (lambda s: None)
        self.map_points = {}   # landmark id -> Mappoint (feature layer)
        # per keyframe event, each backend stage's cost in ms (insert incl.
        # the local-map optimize / loop_detect incl. RANSAC + CVO verify /
        # windowed_ba / final_ba / refine_frames)
        self.stage_ms: List[dict] = []

    @property
    def _delta(self) -> float:
        return self.cfg.RobustKernelDelta if self.cfg.UseRobustKernel else 0.0

    # -- public API (keyframe_graph.cpp:149-162, 2144-2160)
    def add(self, local_map: LocalMap):
        with spans.span("backend.event"):
            self._new_keyframe(local_map)

    def keyframes(self) -> List[Keyframe]:
        return self._keyframes

    # -- newKeyframe (keyframe_graph.cpp:242-362)
    def _new_keyframe(self, m: LocalMap):
        stage = {}
        self.stage_ms.append(stage)

        def timed(key, fn, *a):
            with spans.span(f"backend.{key}") as sp:
                t0 = time.perf_counter()
                out = fn(*a)
                t1 = time.perf_counter()
                sp.times(t0, t1)
            stage[key] = stage.get(key, 0.0) + (t1 - t0) * 1e3
            return out

        # the vocabulary step of the map's keyframes (made by the tracker
        # with their ORB features only), before anything below reads the
        # vocabulary
        timed("insert", self._keyframe_bow, m)

        # start the post-retrain BoW refresh on a worker thread so it
        # overlaps the local-map optimize below
        prefetch = getattr(self.loop_detector, "prefetch", None)
        if prefetch is not None:
            prefetch(self)

        keyframe = timed("insert", self._insert_new_keyframe, m)

        if len(self._keyframes) <= 2:
            self.current_kf_dist += m.get_frame_number()
            return
        if not m.last_map:
            if self.current_kf_dist < self.cfg.Min_KF_interval:
                self.log("Avoid performing too frequent loop-closure")
                self.current_kf_dist += m.get_frame_number()
                return
            self.current_kf_dist = m.get_frame_number()

        farthest = keyframe.id
        if self.loop_detector is not None:
            new_lc, farthest = timed("loop_detect", self.loop_detector,
                                     self, keyframe)
            self.lc_num += new_lc
            self.log(f"Number of loop closure constraints: {self.lc_num}")
        if self.windowed_ba is not None:
            timed("windowed_ba", self.windowed_ba, self, keyframe, farthest)

        if m.last_map:
            kf_last = timed("insert", self._insert_last_keyframe, m)
            farthest = kf_last.id
            if self.loop_detector is not None:
                new_lc, farthest = timed("loop_detect", self.loop_detector,
                                         self, kf_last)
                self.lc_num += new_lc
            if self.windowed_ba is not None:
                timed("windowed_ba", self.windowed_ba, self, kf_last,
                      farthest)
            self.log("Final bundle adjustment start")
            timed("final_ba", self.bundle_adjustment_all_keyframes)
            self.log("Final bundle adjustment end")
            if self.cfg.RefineFrameLists:
                timed("refine_frames", self.refine_frame_lists)

    def _keyframe_bow(self, m: LocalMap):
        if self.keyframe_bow is None:
            return
        for kf in (m.keyframe, m.last_keyframe):
            if kf is not None and kf.bow_vec is None \
                    and kf.descriptors is not None:
                self.keyframe_bow(kf)

    # -- insertNewKeyframe (keyframe_graph.cpp:1742-1798)
    def _insert_new_keyframe(self, m: LocalMap) -> Keyframe:
        if not m.last_map:
            m.optimize()

        current_to_next = m.keyframe_to_next_result()

        keyframe = m.get_keyframe()
        keyframe.id = self.keyframe_vertex_id

        # optimized kf->frame relative poses for all intermediate frames
        # (the last vertex becomes the next keyframe and is excluded)
        rels = m.optimized_relative_poses()
        for ts, rel in rels[:-1]:
            keyframe.frame_list.append(Frame(ts, rel))
        keyframe.map_record = m.edge_record()

        if not self._keyframes:
            keyframe.pose = np.linalg.inv(m.estimates[0])
            self.keyframe_vertex_id += ID_INTERVAL
        else:
            keyframe.pose = self._keyframes[-1].pose \
                @ self.last_to_current.transform
            self.keyframe_vertex_id += ID_INTERVAL
            self._add_edge(self.last_to_current,
                           self.keyframe_vertex_id - 2 * ID_INTERVAL,
                           self.keyframe_vertex_id - ID_INTERVAL)

        self._keyframes.append(keyframe)
        self.last_to_current = current_to_next
        return keyframe

    # -- insertLastKeyframe (keyframe_graph.cpp:1800-1820)
    def _insert_last_keyframe(self, m: LocalMap) -> Keyframe:
        kf = m.last_keyframe
        kf.id = self.keyframe_vertex_id
        kf.pose = self._keyframes[-1].pose @ self.last_to_current.transform
        self.keyframe_vertex_id += ID_INTERVAL
        self._add_edge(self.last_to_current,
                       self.keyframe_vertex_id - 2 * ID_INTERVAL,
                       self.keyframe_vertex_id - ID_INTERVAL)
        self._keyframes.append(kf)
        return kf

    # -- addEdgeToGraph (keyframe_graph.cpp:480-505)
    def _add_edge(self, result: TrackingResult, from_id: int, to_id: int):
        self.edges.append(GraphEdge(self.keyframe_edge_id, from_id, to_id,
                                    copy.deepcopy(result)))
        self.keyframe_edge_id += ID_INTERVAL

    def insert_loop_closure(self, ref: Keyframe, cand: Keyframe,
                            result: TrackingResult):
        """insertLoopClosureConstraint (keyframe_graph.cpp:1581-1607):
        vertex 0 = reference (the new keyframe), vertex 1 = candidate;
        measurement maps candidate points into the reference frame."""
        self._add_edge(result, ref.id, cand.id)

    # -- bundleAdjustmentForAllKeyframes (keyframe_graph.cpp:1267-1431)
    def bundle_adjustment_all_keyframes(self):
        n = len(self._keyframes)
        if n < 2 or not self.edges:
            return
        cap_v = _pad_to_bucket(n)
        cap_e = _pad_to_bucket(len(self.edges))
        E = np.tile(np.eye(4, dtype=np.float32), (cap_v, 1, 1))
        for k, kf in enumerate(self._keyframes):
            E[k] = np.linalg.inv(kf.pose)
        ei = np.zeros(cap_e, np.int64)
        ej = np.zeros(cap_e, np.int64)
        Z = np.tile(np.eye(4, dtype=np.float32), (cap_e, 1, 1))
        om = np.tile(np.eye(6, dtype=np.float32), (cap_e, 1, 1))
        for k, e in enumerate(self.edges):
            ei[k] = e.from_id // ID_INTERVAL
            ej[k] = e.to_id // ID_INTERVAL
            Z[k] = e.result.transform
            om[k] = e.result.information
        g = lm.pose_graph(E, np.arange(cap_v) == 0, np.arange(cap_v) < n,
                          ei, ej, Z, om, np.arange(cap_e) < len(self.edges),
                          device=self.device)
        if self.mesh is not None:
            E_opt, _ = sharded_lm.optimize_sharded(
                g, self.mesh, self.cfg.FinalOptimizationIterations,
                robust_delta=self._delta, solver="pcg")
        else:
            E_opt, _ = lm.optimize(g, self.cfg.FinalOptimizationIterations,
                                   robust_delta=self._delta)
        E_opt = E_opt.cpu().numpy().astype(np.float64)
        for k, kf in enumerate(self._keyframes):
            if kf.id == 0:
                continue
            kf.pose = np.linalg.inv(E_opt[k])

    # -- frame-list bridging (extension over the reference) ----------------
    def refine_frame_lists(self):
        """Re-optimize every local map with BOTH endpoint keyframes pinned
        at their backend-optimized poses, then rebuild the frame_list
        relative poses from the bridged solution.

        The reference freezes each map's kf->frame relatives at insert time
        (keyframe_graph.cpp:1769-1777), so when loop closures later move the
        keyframes, intra-map frames keep any odometry slip that happened
        inside the map. Pinning both ends lets the map's own measurements and
        Cauchy kernels decide where the correction belongs. One batched LM
        call bridges all maps at once; each lane equals its solo run."""
        kfs = self._keyframes
        jobs = []   # (kf, next_kf, record)
        for k in range(len(kfs) - 1):
            rec = kfs[k].map_record
            if rec is None or len(rec["timestamps"]) < 3:
                continue
            jobs.append((kfs[k], kfs[k + 1], rec))
        if not jobs:
            return
        B = _pad_to_bucket(len(jobs))
        E = np.tile(np.eye(4, dtype=np.float32), (B, MAX_VERTS, 1, 1))
        fixed = np.ones((B, MAX_VERTS), bool)   # padded lanes fully pinned
        vmask = np.zeros((B, MAX_VERTS), bool)
        ei = np.zeros((B, MAX_EDGES), np.int64)
        ej = np.zeros((B, MAX_EDGES), np.int64)
        Z = np.tile(np.eye(4, dtype=np.float32), (B, MAX_EDGES, 1, 1))
        om = np.tile(np.eye(6, dtype=np.float32), (B, MAX_EDGES, 1, 1))
        emask = np.zeros((B, MAX_EDGES), bool)
        for b, (kf, nxt, rec) in enumerate(jobs):
            n_v = len(rec["timestamps"])
            E[b, 0] = np.linalg.inv(kf.pose)
            for j, fr in enumerate(kf.frame_list):
                E[b, 1 + j] = np.linalg.inv(kf.pose @ fr.relative_pose)
            E[b, n_v - 1] = np.linalg.inv(nxt.pose)
            fixed[b, 1:n_v - 1] = False
            vmask[b, :n_v] = True
            for e, (i, j, Ze, ome) in enumerate(rec["edges"]):
                ei[b, e], ej[b, e] = i, j
                Z[b, e] = Ze
                om[b, e] = ome
                emask[b, e] = True
        g = lm.pose_graph(E, fixed, vmask, ei, ej, Z, om, emask,
                          device=self.device)
        E_opt, _ = lm.optimize(g, self.cfg.OptimizationIterations,
                               robust_delta=self._delta)
        E_opt = E_opt.cpu().numpy().astype(np.float64)
        for b, (kf, nxt, rec) in enumerate(jobs):
            inv_kf = np.linalg.inv(kf.pose)
            for j, fr in enumerate(kf.frame_list):
                fr.relative_pose = inv_kf @ np.linalg.inv(E_opt[b, 1 + j])

    # -- loop-closure dump rows (keyframe_tracker.cpp:258-315)
    def loop_closure_rows(self) -> List[str]:
        from scipy.spatial.transform import Rotation
        rows = []
        ts = {kf.id: kf.timestamp for kf in self._keyframes}
        for e in self.edges:
            if e.edge_id % 2 != 0:
                continue
            if abs(e.from_id - e.to_id) == ID_INTERVAL:
                continue
            r = e.result
            Z = r.transform
            q = Rotation.from_matrix(Z[:3, :3]).as_quat()
            meas = " ".join(repr(float(v)) for v in (*Z[:3, 3], *q))
            hess = " ".join(repr(float(v)) for v in r.post_hessian.flatten())
            lcp = r.lc_prior
            q2 = Rotation.from_matrix(lcp[:3, :3]).as_quat()
            lcs = " ".join(repr(float(v)) for v in (*lcp[:3, 3], *q2))
            rows.append(
                f"{e.from_id} {e.to_id} {ts[e.from_id]} {ts[e.to_id]} {meas} "
                f"{hess} {r.score} {r.matches} {r.inn_prior} {r.inn_lc_prior} "
                f"{r.inn_post} {lcs} {r.inn_fixed_pcd} {r.inn_moving_pcd} "
                f"{r.cos_angle}")
        return rows
