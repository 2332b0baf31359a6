"""Quality-regression suite: ATE/RPE on challenging synthetic sequences
(port of cvo_slam_tpu.eval.suite).

The reference's verification is end-to-end: run TUM/ETH3D sequences and
score ATE with the TUM tooling (reference README.md:63-85). Without the
datasets, this suite generates long synthetic RGB-D sequences in the
paper's challenge modes (rapid motion, texture-less scenes, over-exposure,
README.md:3) plus a genuine loop circuit, runs the whole system (tracking,
loop closure, windowed and final BA) and records ATE/RPE for both output
trajectories (Tracking_trajectory.txt and SLAM_trajectory.txt, the files of
keyframe_tracker.cpp:233-317 in the reference).

CLI:
  python -m cvo_slam_tpu_torch.eval.suite --out DIR [--scale 0.5]
      [--seq loop_120 fast_rotation_100 ...] [--results-md RESULTS.md]
      [--async] [--mesh N] [--device cuda]

Writes DIR/results.json and optionally a markdown report. --mesh N runs the
windowed and the final BA on the sharded solvers over N shards
(app.run_slam's --mesh).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..config import CAMERA_PRESETS, CameraConfig, SlamConfig
from ..data.synthetic import make_sequence
from ..ops import se3
from . import ate as ate_mod


def scaled_camera(cam: CameraConfig, s: float) -> CameraConfig:
    """Scale resolution + intrinsics together (keeps geometry identical)."""
    return dataclasses.replace(
        cam, fx=cam.fx * s, fy=cam.fy * s, cx=cam.cx * s, cy=cam.cy * s,
        width=int(round(cam.width * s)), height=int(round(cam.height * s)))


def loop_trajectory(n: int, radius: float = 0.22, lift: float = 0.10,
                    yaw_amp: float = 0.12):
    """Closed circuit: world->cam transforms G_k with G_0 = G_n = I.

    The camera strafes around a small circle with an oscillating yaw, ending
    exactly where it started: a genuine revisit for loop closure."""
    Gs = []
    for k in range(n):
        th = 2.0 * np.pi * k / n
        t = np.array([radius * np.sin(th), lift * (1 - np.cos(th)), 0.0])
        yaw = yaw_amp * np.sin(th)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        G = np.eye(4)
        G[:3, :3] = R
        G[:3, 3] = t
        Gs.append(G)
    return Gs


def oscillating_trajectory(n: int, amp_twist, period: float = 40.0):
    """World->cam transforms G_k = exp(sin(2 pi k / period) * amp_twist):
    the camera swings about the scene instead of walking off it (a constant
    twist compounded over 100 frames rotates the camera >100 deg away from
    the rendered surface). Peak per-frame motion is
    ~|amp_twist| * 2 pi / period at the zero crossings."""
    amp = np.asarray(amp_twist, np.float32)
    return [se3_exp(amp * np.sin(2.0 * np.pi * k / period))
            for k in range(n)]


def se3_exp(twist):
    """The f32 SE(3) exponential of ops.se3, as a float64 array."""
    xi = torch.as_tensor(np.asarray(twist, np.float32))
    return se3.exp_se3(xi).numpy().astype(np.float64)


# sequence catalog: name -> (n_frames, make_sequence kwargs builder)
def _catalog():
    # per-frame peak deltas: amp * 2 pi / period
    fast = np.array([0.13, 0.10, -0.06, 0.10, -0.06, 0.08])   # ~1.2 deg/frame
    mild = np.array([0.06, -0.05, 0.04, 0.08, -0.05, 0.06])   # ~0.6 deg/frame
    return {
        # genuine loop circuit (revisit of frame 0 at the end)
        "loop_120": dict(n_frames=120,
                         kwargs=lambda n: dict(trajectory=loop_trajectory(n))),
        # rapid motion: ~1.2 deg + 16 mm per frame at the swing crossings
        "fast_rotation_100": dict(
            n_frames=100,
            kwargs=lambda n: dict(trajectory=oscillating_trajectory(n, fast))),
        # texture-less: contrast compressed to 25%
        "low_texture_100": dict(
            n_frames=100,
            kwargs=lambda n: dict(trajectory=oscillating_trajectory(n, mild),
                                  texture_strength=0.25)),
        # over-exposure: +60% linear brightness ramp over the sequence
        "exposure_ramp_100": dict(
            n_frames=100,
            kwargs=lambda n: dict(trajectory=oscillating_trajectory(n, mild),
                                  exposure_ramp=0.6)),
        # sensor-realism circuit: multi-surface scene with depth
        # discontinuities + the Kinect noise model (axial sigma ~ z^2,
        # disparity quantization, edge/speckle dropout, RGB read noise,
        # per-frame motion blur)
        "noisy_loop_120": dict(
            n_frames=120,
            kwargs=lambda n: dict(trajectory=loop_trajectory(n),
                                  multi_surface=True, noise=True)),
        # metre-scale: 500 frames around a 0.8 m-radius circuit (~5 m path)
        # over a world sheet 3 frustums wide, with the full sensor model
        "metre_loop_500": dict(
            n_frames=500,
            kwargs=lambda n: dict(
                trajectory=loop_trajectory(n, radius=0.8, lift=0.35,
                                           yaw_amp=0.3),
                extent=3.0, multi_surface=True, noise=True)),
    }


def run_sequence(name: str, folder: str, cam: CameraConfig, cfg: SlamConfig,
                 n_frames: int, gen_kwargs: dict, verbose: bool = False,
                 device="cuda", mesh_devices: int = 0):
    """Generate + run the whole system + score. Returns a result dict."""
    from ..app.run_slam import run as run_slam

    make_sequence(folder, cam, n_frames=n_frames, **gen_kwargs)
    t0 = time.perf_counter()
    stats = run_slam(folder, "associate.txt", cam, cfg, verbose=verbose,
                     device=device, mesh_devices=mesh_devices)
    wall = time.perf_counter() - t0

    gt = ate_mod.load_tum_trajectory(os.path.join(folder, "groundtruth.txt"))
    out = dict(sequence=name, frames=n_frames, wall_s=round(wall, 2),
               fps=round(stats["fps"], 3))
    for k in ("keyframe_path_ms", "keyframe_path_total_s", "update_total_s",
              "lc_stage_ms", "keyframes"):
        if k in stats:
            out[k] = stats[k]
    for label, fname in (("tracking", "Tracking_trajectory.txt"),
                         ("slam", "SLAM_trajectory.txt")):
        path = os.path.join(folder, fname)
        if not os.path.exists(path):
            continue
        est = ate_mod.load_tum_trajectory(path)
        scores = ate_mod.ate_rmse(gt, est)
        scores.update(ate_mod.rpe(gt, est))
        out[label] = {k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in scores.items()}
    # loop-closure / backend counters from the metrics stream
    lc_num = 0
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        for line in f:
            lc_num = max(lc_num, json.loads(line).get("lc_num", 0))
    out["loop_closures"] = lc_num
    return out


def run_suite(out_dir: str, scale: float = 1.0, camera: str = "TUM1",
              sequences=None, cfg: SlamConfig = None, verbose: bool = False,
              use_async: bool = False, device="cuda", mesh_devices: int = 0):
    cam = scaled_camera(CAMERA_PRESETS[camera], scale) if scale != 1.0 \
        else CAMERA_PRESETS[camera]
    cfg = cfg or SlamConfig.default_shipped()
    if use_async:
        # the working UseMultiThreading replacement (parallel.async_backend):
        # loop closure + BA consume completed maps on a worker thread while
        # tracking continues
        cfg = cfg.replace(UseMultiThreading=True)
    cat = _catalog()
    names = sequences or list(cat)
    results = []
    for name in names:
        spec = cat[name]
        n = spec["n_frames"]
        folder = os.path.join(out_dir, name)
        res = run_sequence(name, folder, cam, cfg, n, spec["kwargs"](n),
                           verbose, device=device, mesh_devices=mesh_devices)
        results.append(res)
        print(json.dumps(res), flush=True)
    payload = dict(scale=scale, camera=camera,
                   resolution=[cam.width, cam.height],
                   config="shipped", async_backend=use_async,
                   mesh_devices=mesh_devices, device=str(device),
                   results=results)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(payload, f, indent=1)
    return payload


def render_markdown(payload: dict) -> str:
    lines = [
        "# RESULTS — end-to-end quality regression (synthetic challenge suite)",
        "",
        f"Full pipeline (tracking + loop closure + windowed/final BA), shipped "
        f"config, camera {payload['camera']} @ "
        f"{payload['resolution'][0]}x{payload['resolution'][1]}.",
        "",
        "| sequence | frames | ATE RMSE (track) | ATE RMSE (SLAM) | "
        "RPE trans (SLAM) | RPE rot deg (SLAM) | loops | fps |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in payload["results"]:
        tr = r.get("tracking", {})
        sl = r.get("slam", {})
        lines.append(
            f"| {r['sequence']} | {r['frames']} "
            f"| {tr.get('ate_rmse', float('nan')):.4f} "
            f"| {sl.get('ate_rmse', float('nan')):.4f} "
            f"| {sl.get('rpe_trans_rmse', float('nan')):.4f} "
            f"| {sl.get('rpe_rot_rmse_deg', float('nan')):.3f} "
            f"| {r['loop_closures']} | {r['fps']:.2f} |")
    lines.append("")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--camera", default="TUM1", choices=sorted(CAMERA_PRESETS))
    ap.add_argument("--seq", nargs="*", default=None,
                    help="subset of sequences (default: all)")
    ap.add_argument("--results-md", default="",
                    help="also write a markdown report here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="run the backend on the async pipeline "
                         "(UseMultiThreading replacement)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run the windowed and the final BA on the sharded "
                         "solvers over N shards (one per card; on the CPU "
                         "with --device cpu)")
    args = ap.parse_args(argv)
    payload = run_suite(args.out, args.scale, args.camera, args.seq,
                        verbose=args.verbose, use_async=args.use_async,
                        device=args.device, mesh_devices=args.mesh)
    if args.results_md:
        with open(args.results_md, "w") as f:
            f.write(render_markdown(payload))
    print(json.dumps({name: r.get("slam", r.get("tracking", {})).get(
        "ate_rmse") for name, r in
        ((x["sequence"], x) for x in payload["results"])}))


if __name__ == "__main__":
    main()
