"""Standalone frame-to-frame CVO odometry CLI
(port of cvo_slam_tpu.app.run_odometry).

Re-expression of the reference's standalone mains (cvo_main.cpp and
adaptive_cvo_main.cpp): loop over a TUM-format association file, register
consecutive frames with ONE CVO instance (identity start), accumulate the
pose chain, and write `cvo_poses_qt.txt` lines `name tx ty tz qx qy qz qw`
(cvo_main.cpp:60-65). The align backend of the fixed ell anneal comes from
CVO_SLAM_BACKEND (engine.default_backend); --adaptive selects the
adaptive-ell variant (cvo.adaptive.adaptive_align, re-expressing
adaptive_cvo.cpp), whose iterations run the xla backend's dense pass.

Usage:
  python -m cvo_slam_tpu_torch.app.run_odometry --folder <seq_dir> \
      [--association associate.txt] [--camera TUM1] [--adaptive] \
      [--max-frames N] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..config import CAMERA_PRESETS, CameraConfig, SlamConfig
from ..cvo import engine
from ..cvo.adaptive import AdaptiveParams, adaptive_align
from ..data import tum
from ..device import resolve_device
from ..frontend.pointcloud import create_pointcloud


def run(folder: str, association: str, cam_name, cfg: SlamConfig,
        adaptive: bool = False, max_frames: int = 0, verbose: bool = False,
        device="cuda"):
    """cam_name: a preset key or a CameraConfig. Returns run statistics
    (frames, wall_s, fps, mean_frame_ms, trajectory, adaptive, backend)."""
    device = resolve_device(device)
    cam = (cam_name if isinstance(cam_name, CameraConfig)
           else CAMERA_PRESETS[cam_name])
    records = tum.load_association(os.path.join(folder, association))
    if max_frames:
        records = records[:max_frames]

    p = cfg.cvo
    ap = AdaptiveParams()
    backend = engine.default_backend()
    eye3, zero3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    out_path = os.path.join(folder, "cvo_poses_qt.txt")
    accum = np.eye(4)                      # accum_transform (cvo_main.cpp:61)
    prev_cloud = None
    per_frame = []
    t_total = time.perf_counter()
    with open(out_path, "w") as f:
        for i, rec in enumerate(records):
            t0 = time.perf_counter()
            img = tum.load_image(folder, rec)
            pc = create_pointcloud(img.bgr, img.gray, img.depth, cam,
                                   cfg.frontend)
            cloud = engine.PointCloud.from_host(pc, device)
            if prev_cloud is not None:
                if adaptive:
                    res = adaptive_align(prev_cloud, cloud, eye3, zero3, p,
                                         ap)
                else:
                    res = engine.align(prev_cloud, cloud, eye3, zero3,
                                       np.float32(p.ell_init), p, backend)
                accum = accum @ res.transform.cpu().numpy().astype(np.float64)
                f.write(tum.pose_to_tum_line(img.timestamp, accum) + "\n")
            prev_cloud = cloud
            dt = time.perf_counter() - t0
            per_frame.append(dt)
            if verbose and i:
                print(f"frame {i}/{len(records) - 1}: {dt * 1e3:.1f} ms",
                      flush=True)
    wall = time.perf_counter() - t_total
    return dict(frames=len(records), wall_s=wall,
                fps=len(records) / wall if wall > 0 else 0.0,
                mean_frame_ms=float(np.mean(per_frame[1:])) * 1e3
                if len(per_frame) > 1 else 0.0,
                trajectory=out_path, adaptive=adaptive, backend=backend)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--folder", required=True)
    ap.add_argument("--association", default="associate.txt")
    ap.add_argument("--camera", default="TUM1", choices=sorted(CAMERA_PRESETS))
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive-ell variant (adaptive_cvo.cpp)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    stats = run(args.folder, args.association, args.camera,
                SlamConfig.default_shipped(), args.adaptive, args.max_frames,
                args.verbose, device=args.device)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
