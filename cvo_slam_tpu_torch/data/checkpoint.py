"""Session checkpoint / resume (port of cvo_slam_tpu.data.checkpoint).

The reference is one-shot (its only persisted state is three output text
files). Here the full SLAM session (global keyframe graph: poses, edges
with 6x6 informations, landmark table, BoW vectors, keyframe clouds;
tracker state: both CVO instances including the carried ell, the open
local map, the reference evaluation result) is serialized, so a run can
stop every K keyframes and resume exactly where it left off.

Format: a single pickle (protocol 4) of plain dict / ndarray structures in
the JAX package's layout and FORMAT_VERSION, holding the port's own types
(a checkpoint of one package does not load in the other). Each keyframe
also keeps its `map_record`, which the frame-list refinement of the final
backend pass reads. Device tensors are copied to numpy on save and to the
tracker's device on load. Checkpoints are internal state produced by this
framework: load only files you wrote.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from ..cvo.engine import Cvo, PointCloud
from ..parallel.async_backend import AsyncKeyframeGraph

FORMAT_VERSION = 1


def _cloud_out(c: Optional[PointCloud]):
    if c is None:
        return None
    return dict(positions=c.positions.cpu().numpy(),
                features=c.features.cpu().numpy(),
                mask=c.mask.cpu().numpy())


def _cloud_in(d, device) -> Optional[PointCloud]:
    if d is None:
        return None
    return PointCloud(*(torch.from_numpy(d[k]).to(device)
                        for k in ("positions", "features", "mask")))


def _cvo_out(c: Cvo):
    return dict(fixed=_cloud_out(c.fixed), moving=_cloud_out(c.moving),
                previous=_cloud_out(c.previous),
                fixed_pixels=c.fixed_pixels, moving_pixels=c.moving_pixels,
                previous_pixels=c.previous_pixels,
                init=c.init, first_frame=c.first_frame,
                pre_pc_init=c.pre_pc_init, R=c.R, T=c.T,
                transform=c.transform, ell=c.ell)


def _cvo_in(state, cvo: Cvo, device):
    cvo.fixed = _cloud_in(state["fixed"], device)
    cvo.moving = _cloud_in(state["moving"], device)
    cvo.previous = _cloud_in(state["previous"], device)
    cvo.fixed_pixels = state["fixed_pixels"]
    cvo.moving_pixels = state["moving_pixels"]
    cvo.previous_pixels = state["previous_pixels"]
    cvo.init = state["init"]
    cvo.first_frame = state["first_frame"]
    cvo.pre_pc_init = state["pre_pc_init"]
    cvo.R = state["R"]
    cvo.T = state["T"]
    cvo.transform = state["transform"]
    cvo.ell = state["ell"]


def _keyframe_out(kf):
    return dict(id=kf.id, timestamp=kf.timestamp, pose=kf.pose,
                cloud=_cloud_out(kf.cloud), selected_pixels=kf.selected_pixels,
                gray=kf.gray, depth_m=kf.depth_m, keypoints=kf.keypoints,
                kp_angle=kf.kp_angle, descriptors=kf.descriptors,
                bow_vec=kf.bow_vec, feat_vec=kf.feat_vec,
                bow_version=kf.bow_version,
                mappoints_id=dict(kf.mappoints_id),
                best_covisible=list(kf.best_covisible),
                frame_list=[(f.timestamp, f.relative_pose)
                            for f in kf.frame_list],
                map_record=kf.map_record)


def _keyframe_in(d, device):
    from ..tracking.types import Frame, Keyframe
    kf = Keyframe(id=d["id"], timestamp=d["timestamp"], pose=d["pose"],
                  cloud=_cloud_in(d["cloud"], device),
                  selected_pixels=d["selected_pixels"], gray=d["gray"],
                  depth_m=d["depth_m"], keypoints=d["keypoints"],
                  kp_angle=d["kp_angle"], descriptors=d["descriptors"],
                  bow_vec=d["bow_vec"], feat_vec=d["feat_vec"],
                  bow_version=d.get("bow_version", 0),
                  mappoints_id=dict(d["mappoints_id"]),
                  best_covisible=list(d["best_covisible"]),
                  map_record=d.get("map_record"))
    kf.frame_list = [Frame(ts, rel) for ts, rel in d["frame_list"]]
    return kf


def _image_out(img):
    return None if img is None else dict(
        timestamp=img.timestamp, bgr=img.bgr, gray=img.gray, depth=img.depth)


def _image_in(d):
    from ..data.tum import ImagePair
    return None if d is None else ImagePair(d["timestamp"], d["bgr"],
                                            d["gray"], d["depth"])


def save_session(tracker, path: str):
    """Serialize a KeyframeTracker (+ its graph) mid-run. An async graph is
    flushed first."""
    lt = tracker.lt
    lm = lt.local_map
    state = dict(
        version=FORMAT_VERSION,
        evaluation=tracker.evaluation,
        previous_image=_image_out(tracker.previous),
        initial_transformation=tracker.initial_transformation,
        lt=dict(
            cvo_odometry=_cvo_out(lt.cvo_odometry),
            cvo_keyframe=_cvo_out(lt.cvo_keyframe),
            reference_result=lt.reference_result,
            new_map=lt.new_map, force=lt.force, next_kf_id=lt.next_kf_id),
        local_map=None if lm is None else dict(
            keyframe=_keyframe_out(lm.keyframe),
            keyframe_pose=lm.keyframe_pose,
            timestamps=list(lm.timestamps),
            estimates=[np.asarray(e) for e in lm.estimates],
            edges=[(i, j, r) for (i, j, r) in lm.edges],
            current_timestamp=lm.current_timestamp,
            current_frame=_image_out(lm.current_frame_ref),
            current_pose=lm.current_pose, last_map=lm.last_map,
            optimized=lm.optimized),
        vocabulary=(None if lt.keyframe_feature_hook is None
                    else lt.keyframe_feature_hook.voc),
        graph=None,
    )
    g = tracker.graph
    if g is not None:
        if isinstance(g, AsyncKeyframeGraph):
            g.flush()
            g = g._graph
        state["graph"] = dict(
            keyframes=[_keyframe_out(kf) for kf in g._keyframes],
            edges=[(e.edge_id, e.from_id, e.to_id, e.result) for e in g.edges],
            lc_num=g.lc_num, keyframe_vertex_id=g.keyframe_vertex_id,
            keyframe_edge_id=g.keyframe_edge_id,
            # the JAX layout's landmark vertex counter: the port's graph
            # numbers no landmark vertices, so it stays at its start value
            mappoint_vertex_id=1,
            current_kf_dist=g.current_kf_dist,
            last_to_current=g.last_to_current,
            map_points=dict(g.map_points),
            next_mappoint_id=list(getattr(g, "next_mappoint_id", [1])))
    with open(path, "wb") as f:
        pickle.dump(state, f, protocol=4)


def load_session(path: str, cam, cfg, verbose: bool = False, device="cuda"):
    """Rebuild a KeyframeTracker on `device` from a checkpoint; resume by
    continuing to call tracker.update(next_frame)."""
    from ..app.run_slam import build_tracker
    from ..backend.keyframe_graph import GraphEdge
    from ..backend.loop_closure import make_loop_detector
    from ..tracking.local_map import LocalMap

    with open(path, "rb") as f:
        state = pickle.load(f)
    if state.get("version") != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format {state.get('version')}, "
                         f"this reader takes {FORMAT_VERSION}")

    tracker = build_tracker(cam, cfg, verbose, device=device)
    lt = tracker.lt
    device = lt.device
    tracker.evaluation = state["evaluation"]
    tracker.initial_transformation = state["initial_transformation"]
    tracker.previous = _image_in(state["previous_image"])
    s = state["lt"]
    _cvo_in(s["cvo_odometry"], lt.cvo_odometry, device)
    _cvo_in(s["cvo_keyframe"], lt.cvo_keyframe, device)
    lt.reference_result = s["reference_result"]
    lt.new_map = s["new_map"]
    lt.force = s["force"]
    lt.next_kf_id = s["next_kf_id"]
    voc = state.get("vocabulary")
    if voc is not None and lt.keyframe_feature_hook is not None:
        lt.keyframe_feature_hook.voc = voc

    if state["local_map"] is not None:
        d = state["local_map"]
        lm = LocalMap(_keyframe_in(d["keyframe"], device), d["keyframe_pose"],
                      cfg, device=device)
        lm.timestamps = list(d["timestamps"])
        lm.estimates = [np.asarray(e) for e in d["estimates"]]
        lm.edges = list(d["edges"])
        lm.current_timestamp = d["current_timestamp"]
        lm.current_frame_ref = _image_in(d["current_frame"])
        lm.current_pose = d["current_pose"]
        lm.last_map = d["last_map"]
        lm.optimized = d["optimized"]
        lt.local_map = lm

    if state["graph"] is not None and tracker.graph is not None:
        gst = state["graph"]
        g = tracker.graph
        target = g._graph if isinstance(g, AsyncKeyframeGraph) else g
        if voc is not None and target.loop_detector is not None:
            # the detector re-transforms stale BoW vectors with the
            # vocabulary it was made with: make it on the loaded one
            target.loop_detector = make_loop_detector(cam, cfg, voc)
        target._keyframes = [_keyframe_in(k, device)
                             for k in gst["keyframes"]]
        target.edges = [GraphEdge(eid, f, t, r)
                        for (eid, f, t, r) in gst["edges"]]
        target.lc_num = gst["lc_num"]
        target.keyframe_vertex_id = gst["keyframe_vertex_id"]
        target.keyframe_edge_id = gst["keyframe_edge_id"]
        target.current_kf_dist = gst["current_kf_dist"]
        target.last_to_current = gst["last_to_current"]
        target.map_points = dict(gst["map_points"])
        target.next_mappoint_id = list(gst["next_mappoint_id"])
    return tracker
