"""CLI entry point: run tracking-only CVO-SLAM on a TUM-format sequence
(port of cvo_slam_tpu.app.run_slam, OnlyTracking mode).

Loads the association file, streams frames through the KeyframeTracker and
writes Tracking_trajectory.txt per frame (run_SLAM.cpp:83-86) and per-frame
metrics to metrics.jsonl. The backend (SLAM_trajectory.txt,
loop_closure.txt) is ROADMAP slice 2; without --only-tracking this raises.

Usage:
  python -m cvo_slam_tpu_torch.app.run_slam --folder <seq_dir> \
      [--association associate.txt] [--camera TUM1] [--config config.txt] \
      --only-tracking [--max-frames N] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..config import CAMERA_PRESETS, CameraConfig, SlamConfig, parse_config_txt
from ..data import tum
from ..data.prefetch import FramePrefetcher
from ..device import resolve_device
from ..tracking.keyframe_tracker import KeyframeTracker

_BACKEND_MISSING = ("the SLAM backend (pose graph, loop closure, BA) is "
                    "ROADMAP slice 2 and not ported yet: run with "
                    "OnlyTracking (--only-tracking)")


def build_tracker(cam, cfg, verbose=False, device="cuda"):
    if not cfg.OnlyTracking:
        raise NotImplementedError(_BACKEND_MISSING)
    return KeyframeTracker(cam, cfg, verbose=verbose, device=device)


def run(folder: str, association: str, cam_name, cfg: SlamConfig,
        max_frames: int = 0, verbose: bool = False, device="cuda"):
    """cam_name: a preset key (e.g. "TUM1") or a CameraConfig instance.
    Returns run statistics (frames, wall_s, fps, update_total_s)."""
    device = resolve_device(device)
    cam = (cam_name if isinstance(cam_name, CameraConfig)
           else CAMERA_PRESETS[cam_name])
    records = tum.load_association(os.path.join(folder, association))
    if max_frames:
        records = records[:max_frames]

    tracker = build_tracker(cam, cfg, verbose, device)
    tracker.init()

    traj_path = os.path.join(folder, "Tracking_trajectory.txt")
    metrics_path = os.path.join(folder, "metrics.jsonl")
    t_start = time.perf_counter()
    frames = FramePrefetcher(folder, records, cam, cfg.frontend)
    update_total_s = 0.0
    with open(traj_path, "w") as traj, open(metrics_path, "w") as mf:
        for i, image in enumerate(frames):
            if i == len(records) - 1:
                tracker.force_keyframe()
            t0 = time.perf_counter()
            pose = tracker.update(image)
            dt = time.perf_counter() - t0
            update_total_s += dt
            traj.write(tum.pose_to_tum_line(image.timestamp, pose) + "\n")
            mf.write(json.dumps({
                "frame": i, "timestamp": image.timestamp, "t_frame_s": dt,
                **{k: (float(v) if isinstance(v, float) else int(v))
                   for k, v in tracker.lt.metrics.items()}}) + "\n")
            if verbose:
                print(f"frame {i + 1}/{len(records)} {dt * 1e3:.1f} ms")
    wall = time.perf_counter() - t_start
    # wall accounting: update_total_s = every tracker.update call; the
    # difference to wall_s is frame IO/prefetch stalls + startup + writers
    return dict(frames=len(records), wall_s=wall,
                fps=len(records) / wall if wall > 0 else 0.0,
                update_total_s=update_total_s)


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
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = (parse_config_txt(args.config) if args.config
           else SlamConfig.default_shipped())
    if args.only_tracking:
        cfg = cfg.replace(OnlyTracking=True)
    stats = run(args.folder, args.association, args.camera, cfg,
                args.max_frames, args.verbose, device=args.device)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
