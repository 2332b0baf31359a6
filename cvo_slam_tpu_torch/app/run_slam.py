"""CLI entry point: run CVO-SLAM on a TUM-format sequence
(port of cvo_slam_tpu.app.run_slam).

Loads the association file, streams frames through the KeyframeTracker,
writes Tracking_trajectory.txt per frame (run_SLAM.cpp:83-86) and, unless
OnlyTracking, SLAM_trajectory.txt + loop_closure.txt at the end (:91-98).
Per-frame metrics go to metrics.jsonl. UseMultiThreading runs the backend
on a worker thread (parallel.async_backend); --mesh N runs the windowed and
the final BA on the sharded solvers (parallel.sharded_ba / sharded_lm) over
N shards: one per card on cuda, N on the CPU with --device cpu.

Usage:
  python -m cvo_slam_tpu_torch.app.run_slam --folder <seq_dir> \
      [--association associate.txt] [--camera TUM1] [--config config.txt] \
      [--only-tracking] [--max-frames N] [--vocabulary ORBvoc.txt] \
      [--profile-dir DIR] [--mesh N] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import threading
import time

from ..backend.ba import make_windowed_ba
from ..backend.keyframe_graph import KeyframeGraph
from ..backend.loop_closure import make_loop_detector
from ..config import CAMERA_PRESETS, CameraConfig, SlamConfig, parse_config_txt
from ..cvo import cuda_build
from ..data import tum
from ..data.prefetch import FramePrefetcher
from ..device import resolve_device
from ..features.orb import keyframe_feature_hook
from ..parallel.async_backend import AsyncKeyframeGraph
from ..parallel.mesh import Mesh
from ..tracking.keyframe_tracker import KeyframeTracker

log = logging.getLogger(__name__)


def _warm_kernels():
    """Build and load every csrc/ library. A failure is logged here, and
    the first kernel call raises it again (cuda_build.load rebuilds)."""
    try:
        cuda_build.load(cuda_build.SOURCES[0])
    except Exception:   # noqa: BLE001 — logged; the first launch re-raises
        log.exception("building the CUDA kernels failed")


def start_warmup(device):
    """On a CUDA device, build and load the kernels on a background thread
    before the first frame, so nvcc overlaps the startup (the prefetcher's
    first frames) instead of stalling the first alignment. The CPU runs
    the plain versions and has nothing to build."""
    if device.type == "cuda":
        threading.Thread(target=_warm_kernels, daemon=True,
                         name="kernel-warmup").start()


def build_tracker(cam, cfg, verbose=False, device="cuda",
                  vocabulary_path: str = "", mesh_devices: int = 0,
                  mesh: Mesh = None):
    """The KeyframeTracker with, unless OnlyTracking, the backend graph:
    ORB + BoW keyframe features, loop-closure detection, windowed BA, the
    final all-keyframe BA and frame-list refinement, all on `device`;
    with UseMultiThreading the graph runs on a worker thread. With `mesh`
    (or mesh_devices, a mesh of that many shards, one per card:
    Mesh.on_cards) the windowed and the final BA run on the sharded
    solvers."""
    if cfg.OnlyTracking:
        return KeyframeTracker(cam, cfg, verbose=verbose, device=device)
    if mesh is None and mesh_devices:
        mesh = Mesh.on_cards(mesh_devices, device)
    feature_hook = keyframe_feature_hook(cam, cfg, vocabulary_path)
    graph = KeyframeGraph(
        cam, cfg,
        loop_detector=make_loop_detector(cam, cfg, feature_hook.voc),
        windowed_ba=make_windowed_ba(cam, cfg, device, mesh=mesh),
        log=print if verbose else None, device=device,
        keyframe_bow=feature_hook.bow, mesh=mesh)
    if cfg.UseMultiThreading:
        # working replacement for the reference's broken TBB pipeline
        # (keyframe_graph.cpp:2091-2095): the backend consumes completed
        # local maps on a worker thread; writers flush the queue first
        graph = AsyncKeyframeGraph(graph, device)
    return KeyframeTracker(cam, cfg, graph=graph,
                           keyframe_feature_hook=feature_hook,
                           verbose=verbose, device=device)


def _stage_stats(rows, per_event: bool):
    """mean / max (and with per_event the count and total) of each stage
    over the rows; with per_event the mean is over the rows where the stage
    ran."""
    out = {}
    for k in sorted({k for row in rows for k in row}):
        vals = [r[k] for r in rows if k in r]
        n = len(vals) if per_event else len(rows)
        out[k] = dict(mean=sum(vals) / max(n, 1), max=max(vals))
        if per_event:
            out[k].update(n=len(vals), total_s=sum(vals) / 1e3)
    return out


def run(folder: str, association: str, cam_name, cfg: SlamConfig,
        max_frames: int = 0, verbose: bool = False, device="cuda",
        vocabulary_path: str = "", mesh_devices: int = 0,
        profile_dir: str = "", mesh: Mesh = None):
    """cam_name: a preset key (e.g. "TUM1") or a CameraConfig instance.
    The align backend comes from CVO_SLAM_BACKEND (engine.default_backend).
    Returns run statistics (frames, wall_s, fps, update_total_s, the align
    backend and, with the SLAM backend, keyframes, keyframe_path_ms per
    stage and lc_stage_ms per loop-closure sub-stage, all in ms per
    event). mesh_devices / mesh: see build_tracker. With profile_dir, the
    frame loop runs under torch.profiler and
    its trace is written to profile_dir/trace.json (chrome trace format)."""
    device = resolve_device(device)
    cam = (cam_name if isinstance(cam_name, CameraConfig)
           else CAMERA_PRESETS[cam_name])
    records = tum.load_association(os.path.join(folder, association))
    if max_frames:
        records = records[:max_frames]

    tracker = build_tracker(cam, cfg, verbose, device, vocabulary_path,
                            mesh_devices, mesh)
    start_warmup(device)
    tracker.init()
    backend = tracker.lt.cvo_odometry.backend   # CVO_SLAM_BACKEND
    profiler = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        profiler = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))

    traj_path = os.path.join(folder, "Tracking_trajectory.txt")
    metrics_path = os.path.join(folder, "metrics.jsonl")
    t_start = time.perf_counter()
    frames = FramePrefetcher(folder, records, cam, cfg.frontend)
    update_total_s = 0.0
    with open(traj_path, "w") as traj, open(metrics_path, "w") as mf, \
            profiler as prof:
        it = iter(frames)
        image = next(it, None)
        i = -1
        while image is not None:
            i += 1
            # one-frame lookahead: staging the next frame lets the tracker
            # dispatch its device work speculatively before this frame's
            # readback (SpeculativeExecutor)
            nxt = next(it, None)
            if i == len(records) - 1:
                tracker.force_keyframe()
            t0 = time.perf_counter()
            pose = tracker.update(image, next_frame=nxt)
            dt = time.perf_counter() - t0
            update_total_s += dt
            traj.write(tum.pose_to_tum_line(image.timestamp, pose) + "\n")
            lc_num = 0 if tracker.graph is None else tracker.graph.lc_num
            mf.write(json.dumps({
                "frame": i, "timestamp": image.timestamp, "t_frame_s": dt,
                "lc_num": lc_num, "backend": backend,
                **{k: (float(v) if isinstance(v, float) else int(v))
                   for k, v in tracker.lt.metrics.items()}}) + "\n")
            if verbose:
                print(f"frame {i + 1}/{len(records)} {dt * 1e3:.1f} ms")
            image = nxt
    wall = time.perf_counter() - t_start
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    if not cfg.OnlyTracking:
        tracker.write_slam_trajectory_and_loop_closure(
            os.path.join(folder, "SLAM_trajectory.txt"),
            os.path.join(folder, "loop_closure.txt"))
    # wall accounting: update_total_s = every tracker.update call (tracked
    # frames and the inline keyframe events); the difference to wall_s is
    # frame IO/prefetch stalls + startup + writers
    ex = tracker.lt.executor
    stats = dict(frames=len(records), wall_s=wall,
                 fps=len(records) / wall if wall > 0 else 0.0,
                 update_total_s=update_total_s, backend=backend,
                 speculation=dict(enabled=ex.enabled, hits=ex.hits,
                                  misses=ex.misses, discards=ex.discards))
    graph = tracker.graph
    if graph is not None:
        stats["keyframes"] = len(graph.keyframes())
        stats["lc_num"] = graph.lc_num
        if graph.stage_ms:
            stats["keyframe_path_ms"] = _stage_stats(graph.stage_ms, True)
            stats["keyframe_path_total_s"] = sum(
                v for r in graph.stage_ms for v in r.values()) / 1e3
        lc_rows = getattr(graph, "lc_stage_ms", None)
        if lc_rows:
            stats["lc_rounds"] = len(lc_rows)
            stats["lc_candidates"] = sum(r["n_cands"] for r in lc_rows)
            stats["lc_matches"] = {
                where: sum(r[f"n_match_{where}"] for r in lc_rows)
                for where in ("device", "host")}
            stats["lc_stage_ms"] = _stage_stats(lc_rows, False)
        if isinstance(graph, AsyncKeyframeGraph):
            graph.close()
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--folder", required=True)
    ap.add_argument("--association", default="associate.txt")
    ap.add_argument("--camera", default="TUM1", choices=sorted(CAMERA_PRESETS))
    ap.add_argument("--config", default=None,
                    help="reference-style config.txt (default: shipped values)")
    ap.add_argument("--only-tracking", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--vocabulary", default="",
                    help="DBoW2 ORBvoc.txt path (default: online-grown "
                         "vocabulary, see features.bow.GrowingVocabulary)")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace of the frame loop "
                         "here (trace.json, chrome trace format)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run the windowed and the final BA on the sharded "
                         "solvers over N shards (one per card; on the CPU "
                         "with --device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = (parse_config_txt(args.config) if args.config
           else SlamConfig.default_shipped())
    if args.only_tracking:
        cfg = cfg.replace(OnlyTracking=True)
    stats = run(args.folder, args.association, args.camera, cfg,
                args.max_frames, args.verbose, device=args.device,
                vocabulary_path=args.vocabulary, mesh_devices=args.mesh,
                profile_dir=args.profile_dir)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
