#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (cvo_slam_tpu_torch) on one GPU.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. card and build: the card's name and power limit, torch.version.cuda,
     and the nvcc build of every kernel in csrc/ (timed, with ptxas's
     register / spill report);
  2. kernel checks: each CUDA kernel against its plain PyTorch version on
     two clouds of the port's synthetic 640x480 scene, at CAP 3072 and
     CAP 3000, ell in {0.15, 0.06}; bars: nnz, counts and inliers exact;
     the moment matrix Mom within 1e-5 of each column's max; omega, v, B, C
     (through the shared epilogue) rtol 2e-4 / atol 1e-5; the four sums
     rtol 1e-4; G atol 1e-5 after scaling by max|G|. The quartic
     coefficients D and E are printed, not held: the f32 epilogue
     (ops/pairwise.flow_and_step_from_moments) amplifies a 1e-7 change of
     Mom up to 1e-3 (D) and 1e-1 (E) relative on these clouds, for the
     plain version as much as for the kernel (measured against an f64
     evaluation of the same Mom). Times by CUDA events (median of 5 runs
     of 10 launches) beside the plain version's time and the bound;
     The pair-stats kernel is held the same way, with and without
     moments: value and count, G and inliers;
  3. tracking: tracking-only SLAM at 640x480 / CAP 3072 on a 16-frame
     synthetic sequence through app.run_slam.run(device="cuda"), with the
     launch counters set to 0 just before and read just after; checks one
     finite pose per frame, both counters non-zero (the suite exactly one
     launch per alignment) and the position error against the ground truth
     below 0.05 m;
  4. SLAM: the whole system (SlamConfig.default_shipped(), OnlyTracking
     False: tracking, keyframe graph, ORB + BoW, loop closure, windowed BA,
     final BA, frame-list refinement) through app.run_slam.run on a
     synthetic out-and-back sequence at 640x480 / CAP 3072 with the TUM1
     camera and ORB at 5000 features, counters set to 0 just before and
     read just after; fails unless every kernel launched (pair_stats from
     the loop-closure verification), at least one loop-closure edge was
     accepted, every loop_closure.txt row has 62 fields and the SLAM ATE is
     below 0.05 m;
  5. one engine.frame_step under torch.profiler: device busy share and
     kernel launches per align iteration;
  6. a JSON line with every kernel's numbers, the card line, and last
     {"ok": true, "device": {...}}.

The bound of a kernel is the larger of operations / 67 TFLOP/s (fp32 on
the CUDA cores of an H100 SXM at 700 W) and bytes / 3.35 TB/s, with the
operations counted from this run's data (pairs inside each gate).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32 = 67e12        # FLOP/s, H100 SXM, CUDA cores
PEAK_BYTES = 3.35e12     # B/s, H100 SXM HBM3
N_FRAMES = 16
# out-and-back SLAM sequence: SLAM_OUT frames out, then back, at 1.5x the
# generator's default step twist (10 keyframes and 5 loop-closure rounds
# under the shipped keyframe policy on the H100)
SLAM_OUT = 24
SLAM_STEP = (0.006, -0.009, 0.0045, 0.015, -0.009, 0.012)
CAPS = (3072, 3000)
ELLS = (0.15, 0.06)
TWIST = (0.02, -0.01, 0.03, 0.05, 0.02, -0.04)   # post transform of the suite


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_time_ms(fn, reps=10, trials=5):
    """Median over `trials` of the mean per-call time of `reps` calls, by
    CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


# -- operation and byte counts of each kernel's function ---------------------
# Per pair, the operations the function needs (a fused multiply-add is 2):
#   moment pass: geometric distance of a valid pair 9 (3 sub, 3 mul, 2 add,
#   compare); colour distance of a pair inside the geometric gate 15; the
#   joint kernel of a gated pair 8 (2 mul, add, neg, max, exp, mul,
#   compare); a kept pair adds 35 multiply-adds into the moments (70).
#   suite, each of the four pair sets: colour distance of a valid pair 14
#   (the pre and post sets share one); geometric distance of a colour-gated
#   pair 10; a gated pair 12 (two clamped exponentials, product, sum,
#   count); a gated post pair adds W (1) and W U(x) (9 lift products + 13
#   multiply-adds = 35).

def moment_counts(x, fx, mx, y, fy, my, ell, p):
    import torch
    from cvo_slam_tpu_torch.ops import pairwise
    d2 = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    d2c = ((fx[:, None, :] - fy[None, :, :]) ** 2).sum(-1)
    valid = mx[:, None] & my[None, :]
    geo = valid & (d2 < pairwise.d2_threshold(torch.tensor(ell), p).item())
    gate = geo & (d2c < pairwise.d2_color_threshold(p))
    a = (p.sigma ** 2 * p.c_sigma ** 2) * torch.exp(torch.clamp(
        -(d2 / (2 * ell * ell) + d2c / (2 * p.c_ell ** 2)), min=-20.0))
    keep = gate & (a > p.sp_thres)
    n = [int(t.sum()) for t in (valid, geo, gate, keep)]
    ops = 9 * n[0] + 15 * n[1] + 8 * n[2] + 70 * n[3]
    cap_x, cap_y = x.shape[0], y.shape[0]
    nbytes = cap_x * (3 + 5 + 35) * 4 + cap_x + cap_y * (3 + 5) * 4 + cap_y \
        + cap_y * 35 * 4 + 4
    return ops, nbytes


def suite_counts(x, fx, mx, y, fy, my, yt, ell, p):
    import torch
    from cvo_slam_tpu_torch.ops import pairwise
    d2t = pairwise.d2_threshold(torch.tensor(ell), p).item()
    d2ct = pairwise.d2_color_threshold(p)
    ops = 0
    sets = ((y, fy, my, x, fx, mx, True), (yt, fy, my, x, fx, mx, False),
            (x, fx, mx, x, fx, mx, True), (y, fy, my, y, fy, my, True))
    for k, (a, fa, ma, b, fb, mb, colour) in enumerate(sets):
        valid = ma[:, None] & mb[None, :]
        d2c = ((fa[:, None, :] - fb[None, :, :]) ** 2).sum(-1)
        cg = valid & (d2c < d2ct)
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        g = cg & (d2 < d2t)
        ops += (14 * int(valid.sum()) if colour else 0) \
            + 10 * int(cg.sum()) + 12 * int(g.sum())
        if k == 1:
            ops += 36 * int(g.sum())
    n, m = x.shape[0], y.shape[0]
    nbytes = n * (3 + 5) * 4 + n + m * (3 + 5 + 3) * 4 + m \
        + (169 + 4) * 4 + 4 * 4
    return ops, nbytes


def pair_stats_counts(xa, fa, ma, xb, fb, mb, ell, p, with_moments):
    """One pair set of the suite: colour distance of a valid pair 14,
    geometric distance of a colour-gated pair 10, a gated pair 12, and with
    moments W U(xb) of a gated pair 36 (the suite's post set)."""
    import torch
    from cvo_slam_tpu_torch.ops import pairwise
    valid = ma[:, None] & mb[None, :]
    d2c = ((fa[:, None, :] - fb[None, :, :]) ** 2).sum(-1)
    cg = valid & (d2c < pairwise.d2_color_threshold(p))
    d2 = ((xa[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    g = cg & (d2 < pairwise.d2_threshold(torch.tensor(ell), p).item())
    ops = 14 * int(valid.sum()) + 10 * int(cg.sum()) \
        + (48 if with_moments else 12) * int(g.sum())
    n, m = xa.shape[0], xb.shape[0]
    nbytes = (n + m) * ((3 + 5) * 4 + 1) + 4 \
        + ((169 + 1) * 4 + 4 if with_moments else 2 * 4)
    return ops, nbytes


def bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_close(name, got, want, rtol, atol):
    import numpy as np
    g = np.asarray(got.detach().cpu(), np.float64)
    w = np.asarray(want.detach().cpu(), np.float64)
    if not np.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: {g} vs {w}")
    return float(np.abs(g - w).max())


def kernel_checks(clouds, p, report):
    """Phase 2: both kernels against their plain versions; fills report."""
    import torch
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.ops import pairwise, se3
    names = ("omega", "v", "nnz", "B", "C", "D", "E")
    for cap, (c0, c1) in clouds.items():
        x, fx, mx = c0
        y, fy, my = c1
        center, U = pairwise.step_moment_basis(x, mx)
        U = U.contiguous()
        yt = se3.transform_points(
            se3.exp_se3(torch.tensor(TWIST, device=x.device)), y).contiguous()
        for ell in ELLS:
            # the kernel's own output: Mom column by column, nnz exactly
            ell_t = torch.tensor(ell, device=x.device)
            Mk, nk = kernels.moment_pass_cuda(x, y, fx, fy, mx, my, U, ell_t,
                                              p)
            Mp, npl = kernels.moment_pass_plain(x, y, fx, fy, mx, my, U,
                                                ell_t, p)
            torch.cuda.synchronize()
            if int(nk) != int(npl):
                raise AssertionError(f"moment nnz {int(nk)} != {int(npl)} "
                                     f"(CAP {cap}, ell {ell})")
            col = Mp.abs().amax(dim=0).clamp(min=1e-30)
            err_m = float(((Mk - Mp).abs() / col).max())
            if err_m > 1e-5:
                raise AssertionError(f"moment Mom: {err_m:.3e} of its column"
                                     f" max (CAP {cap}, ell {ell})")
            # through the shared epilogue: omega, v, B, C at the bar; D and
            # E are reported only (see the module docstring)
            got = kernels.moment_flow_step(x, y, fx, fy, mx, my, U, center,
                                           ell, p)
            want = kernels.moment_flow_step_plain(x, y, fx, fy, mx, my, U,
                                                  center, ell, p)
            err = 0.0
            for name, g, w in zip(names, got, want):
                if name in ("omega", "v", "B", "C"):
                    err = max(err, check_close(f"moment {name}", g, w,
                                               2e-4, 1e-5))
            rel_de = [abs(float(g) - float(w)) / abs(float(w))
                      for g, w in zip(got[5:], want[5:])]
            report["moment_flow_step"]["max_abs_err"] = max(
                report["moment_flow_step"]["max_abs_err"], err)
            print(f"moment_flow_step CAP {cap} ell {ell}: nnz {int(nk)} "
                  f"equal, Mom max |err| / column max {err_m:.3e}, omega v B"
                  f" C max |err| {err:.3e}, D E rel diff "
                  f"{rel_de[0]:.2e} {rel_de[1]:.2e}", flush=True)

            got = kernels.ip_suite(x, fx, mx, y, fy, my, yt, ell, p)
            want = kernels.ip_suite_plain(x, fx, mx, y, fy, my, yt, ell, p)
            torch.cuda.synchronize()
            err = 0.0
            for k in (1, 3, 5, 7, 9):
                if int(got[k]) != int(want[k]):
                    raise AssertionError(f"suite count {k}: {int(got[k])} != "
                                         f"{int(want[k])} (CAP {cap}, ell {ell})")
            for k in (0, 2, 4, 6):
                err = max(err, check_close(f"suite sum {k}", got[k], want[k],
                                           1e-4, 0.0))
            scale = max(float(want[8].abs().max()), 1.0)
            err = max(err, check_close("suite G", got[8] / scale,
                                       want[8] / scale, 0.0, 1e-5) * scale)
            report["ip_suite"]["max_abs_err"] = max(
                report["ip_suite"]["max_abs_err"], err)
            print(f"ip_suite CAP {cap} ell {ell}: counts "
                  f"{[int(got[k]) for k in (1, 3, 5, 7)]} inliers "
                  f"{int(got[9])} equal, max |err| {err:.3e}", flush=True)

            # pair stats of the loop-closure post set: rows yt, columns x
            for mom in (False, True):
                got = kernels.pair_stats(yt, fy, my, x, fx, mx, ell, p, mom)
                want = kernels.pair_stats_plain(yt, fy, my, x, fx, mx, ell,
                                                p, mom)
                torch.cuda.synchronize()
                if float(got[1]) != float(want[1]) or (
                        mom and int(got[3]) != int(want[3])):
                    raise AssertionError(
                        f"pair_stats counts {float(got[1])}/"
                        f"{float(want[1])} (CAP {cap}, ell {ell}, "
                        f"moments {mom})")
                err = check_close("pair_stats value", got[0], want[0],
                                  1e-4, 0.0)
                if mom:
                    scale = max(float(want[2].abs().max()), 1.0)
                    err = max(err, check_close(
                        "pair_stats G", got[2] / scale, want[2] / scale, 0.0,
                        1e-5) * scale)
                report["pair_stats"]["max_abs_err"] = max(
                    report["pair_stats"]["max_abs_err"], err)
                print(f"pair_stats CAP {cap} ell {ell} moments {mom}: count "
                      f"{int(got[1])} equal, max |err| {err:.3e}", flush=True)

        if cap != CAPS[0]:
            continue
        # times at the main path's capacity, at both ells
        for ell in ELLS:
            ell_t = torch.tensor(ell, device=x.device)
            t_k = cuda_time_ms(lambda: kernels.moment_pass_cuda(
                x, y, fx, fy, mx, my, U, ell_t, p))
            t_p = cuda_time_ms(lambda: kernels.moment_pass_plain(
                x, y, fx, fy, mx, my, U, ell_t, p), reps=3)
            ops, nbytes = moment_counts(x, fx, mx, y, fy, my, ell, p)
            b, by = bound_ms(ops, nbytes)
            _record(report["moment_flow_step"], ell, t_k, t_p, b, by, ops)
            t_k = cuda_time_ms(lambda: kernels.ip_suite_cuda(
                x, fx, mx, y, fy, my, yt, ell_t, p))
            t_p = cuda_time_ms(lambda: kernels.ip_suite_plain(
                x, fx, mx, y, fy, my, yt, ell_t, p), reps=3)
            ops, nbytes = suite_counts(x, fx, mx, y, fy, my, yt, ell, p)
            b, by = bound_ms(ops, nbytes)
            _record(report["ip_suite"], ell, t_k, t_p, b, by, ops)
            # pair stats: the six calls without moments are the main ones;
            # the two with moments are recorded beside them
            for mom in (True, False):
                t_k = cuda_time_ms(lambda: kernels.pair_stats_cuda(
                    yt, fy, my, x, fx, mx, ell_t, p, mom))
                t_p = cuda_time_ms(lambda: kernels.pair_stats_plain(
                    yt, fy, my, x, fx, mx, ell_t, p, mom), reps=3)
                ops, nbytes = pair_stats_counts(yt, fy, my, x, fx, mx, ell,
                                                p, mom)
                b, by = bound_ms(ops, nbytes)
                _record(report["pair_stats"], ell, t_k, t_p, b, by, ops,
                        "moments" if mom else "")


def _record(entry, ell, t_k, t_p, b, by, ops, mode=""):
    """Print one timing; keep it under times_by_ell (mode-suffixed keys for
    a second mode) and as the entry's headline at the first ell without a
    mode."""
    tag = f" {mode}" if mode else ""
    print(f"{entry['name']}{tag} CAP {CAPS[0]} ell {ell}: kernel {t_k:.4f} "
          f"ms, plain {t_p:.4f} ms, bound {b:.4f} ms ({by}, {ops:.4g} ops), "
          f"{b / t_k:.1%} of bound", flush=True)
    entry["times_by_ell"][str(ell) + (f" {mode}" if mode else "")] = dict(
        ms=t_k, plain_ms=t_p, bound_ms=b)
    if ell == ELLS[0] and not mode:
        entry.update(ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by)


def profile_frame(clouds, p):
    """One engine.frame_step (all device work of a tracked frame) under
    torch.profiler: wall time, device time summed over kernels, the number
    of kernel launches, and the two CUDA kernels' share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cvo_slam_tpu_torch.cvo import engine
    (x, fx, mx), (y, fy, my) = clouds[CAPS[0]]
    prev, cur = engine.PointCloud(x, fx, mx), engine.PointCloud(y, fy, my)
    eye3, zero3 = torch.eye(3).numpy(), torch.zeros(3).numpy()

    def frame():
        out = engine.frame_step(prev, prev, cur, eye3, zero3, p.ell_init,
                                torch.eye(4).numpy(), p.ell_init, p)
        torch.cuda.synchronize()
        return out

    frame()                                     # warm-up
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = frame()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_us, ours_us, n = 0.0, 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            d = e.time_range.elapsed_us()
            kernels_us += d
            n += 1
            if e.name.startswith(("moment_", "suite_", "(anonymous namespace)"
                                  "::moment", "(anonymous namespace)::suite")):
                ours_us += d
    iters = int(res[0].iters) + int(res[2].iters) + 2
    if kernels_us == 0.0:
        print(f"profile of one frame_step: wall {wall_ms:.1f} ms; device "
              "time not measured (the profiler saw no CUDA kernels)",
              flush=True)
        return
    print(f"profile of one frame_step (CAP {CAPS[0]}, {iters} align "
          f"iterations): wall {wall_ms:.1f} ms (profiler on), device kernels"
          f" {kernels_us / 1e3:.2f} ms = {kernels_us / 1e3 / wall_ms:.1%} "
          f"busy, {n} kernel launches ({n / iters:.0f} per iteration), the "
          f"two CUDA kernels {ours_us / 1e3:.2f} ms", flush=True)


def host_cloud_tensors(pc, device):
    from cvo_slam_tpu_torch.cvo.engine import PointCloud
    c = PointCloud.from_host(pc, device)
    return c.positions, c.features, c.mask


def tracking(folder, gt, report, card):
    """Phase 3: the main path, counters reset just before, read just after."""
    import numpy as np
    from cvo_slam_tpu_torch.app import run_slam
    from cvo_slam_tpu_torch.config import SlamConfig
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.data import tum
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True)
    kernels.reset_launch_counts()
    stats = run_slam.run(folder, "associate.txt", "TUM1", cfg, device="cuda")
    launches = {k.name: k.launches for k in kernels.KERNELS}
    for k in kernels.KERNELS:
        report[k.name]["launches"] = k.launches

    ts, poses = tum.read_trajectory(os.path.join(folder,
                                                 "Tracking_trajectory.txt"))
    if len(ts) != N_FRAMES or not np.isfinite(poses).all():
        raise AssertionError(f"{len(ts)} poses for {N_FRAMES} frames, "
                             f"finite: {np.isfinite(poses).all()}")
    err = np.linalg.norm(poses[:, :3, 3] - gt[:N_FRAMES, :3, 3], axis=1)
    ate = tum.ate_rmse([f"{1000.0 + 0.05 * k:.6f}" for k in range(N_FRAMES)],
                       gt[:N_FRAMES], ts, poses)
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    tracked = [r for r in rows if "odo_iters" in r]
    iters = [r["odo_iters"] for r in tracked] + [r["kf_iters"]
                                                 for r in tracked]
    t_frame = [r["t_frame_s"] * 1e3 for r in tracked]
    # alignments: one bootstrap (odometry only) + two per tracked frame
    n_align = 1 + 2 * len(tracked)
    print(f"tracking {N_FRAMES} frames 640x480 CAP 3072 on {card}: "
          f"{np.mean(t_frame):.1f} ms/frame mean, {np.median(t_frame):.1f} "
          f"median over {len(tracked)} tracked frames; wall {stats['wall_s']:.2f}"
          f" s ({stats['fps']:.2f} fps incl. bootstrap and IO); "
          f"{np.mean(iters):.1f} align iterations per alignment "
          f"(tracked frames); launches {launches}; alignments {n_align}; "
          f"max position error {err.max():.4f} m, ATE {ate:.4f} m", flush=True)
    if launches["moment_flow_step"] < sum(iters) or launches["ip_suite"] \
            != n_align:
        raise AssertionError(f"launch counts {launches} do not cover "
                             f"{sum(iters)} iterations / {n_align} alignments")
    if err.max() >= 0.05:
        raise AssertionError(f"position error {err.max()} m >= 0.05 m")


def loop_trajectory(n_out):
    """World->camera transforms walking out n_out steps, then back."""
    import numpy as np
    import torch
    from cvo_slam_tpu_torch.ops import se3
    step = se3.exp_se3(torch.tensor(SLAM_STEP, dtype=torch.float64)).numpy()
    Gs = [np.eye(4)]
    for _ in range(n_out):
        Gs.append(step @ Gs[-1])
    for _ in range(n_out):
        Gs.append(np.linalg.inv(step) @ Gs[-1])
    return Gs


def slam(folder, report, card, device="cuda", cam=None, cfg=None):
    """Phase 4: the whole SLAM system on an out-and-back sequence, counters
    set to 0 just before run() and read just after."""
    import numpy as np
    from cvo_slam_tpu_torch.app import run_slam
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.data import synthetic, tum
    cam = cam or CAMERA_PRESETS["TUM1"]
    cfg = cfg or SlamConfig.default_shipped()
    Gs = loop_trajectory(SLAM_OUT)
    gt = synthetic.make_sequence(folder, cam, trajectory=Gs)
    gt_ts = [f"{1000.0 + 0.05 * k:.6f}" for k in range(len(Gs))]
    kernels.reset_launch_counts()
    stats = run_slam.run(folder, "associate.txt", cam, cfg, device=device)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    report["pair_stats"]["launches"] = launches["pair_stats"]

    ts, poses = tum.read_trajectory(os.path.join(folder,
                                                 "Tracking_trajectory.txt"))
    ate_track = tum.ate_rmse(gt_ts, gt, ts, poses)
    ts, poses = tum.read_trajectory(os.path.join(folder,
                                                 "SLAM_trajectory.txt"))
    ate_slam = tum.ate_rmse(gt_ts, gt, ts, poses)
    with open(os.path.join(folder, "loop_closure.txt")) as f:
        rows = [line.split() for line in f if line.strip()]
    stages = {k: round(v["mean"], 1)
              for k, v in stats.get("keyframe_path_ms", {}).items()}
    print(f"SLAM {stats['frames']} frames {cam.width}x{cam.height} CAP "
          f"{cfg.frontend.cloud_capacity} on {card}: {stats['keyframes']} "
          f"keyframes, {stats.get('lc_rounds', 0)} loop-closure rounds, "
          f"{stats.get('lc_candidates', 0)} candidates verified, "
          f"{stats['lc_num']} loop-closure edges accepted; launches "
          f"{launches}; ms per keyframe event by stage {stages}; "
          f"loop-closure sub-stages "
          f"{ {k: round(v['mean'], 1) for k, v in stats.get('lc_stage_ms', {}).items()} }; "
          f"wall {stats['wall_s']:.1f} s; tracking ATE {ate_track:.4f} m, "
          f"SLAM ATE {ate_slam:.4f} m", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched by SLAM: {launches}")
    if stats["lc_num"] < 1:
        raise AssertionError("no loop-closure edge was accepted")
    if any(len(r) != 62 for r in rows):
        raise AssertionError(f"loop_closure.txt rows of "
                             f"{sorted({len(r) for r in rows})} fields")
    if not ate_slam < 0.05:
        raise AssertionError(f"SLAM ATE {ate_slam} m >= 0.05 m")
    return stats


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "cvo_slam_tpu_torch")):
        return fail("cvo_slam_tpu_torch/ not found beside chip_smoke.py: run "
                    "from the root of a checkout")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this run needs a "
                    "CUDA card")
    from cvo_slam_tpu_torch.config import (CAMERA_PRESETS, FrontendParams,
                                           SlamConfig)
    from cvo_slam_tpu_torch.cvo import cuda_build, kernels
    from cvo_slam_tpu_torch.data import synthetic, tum
    from cvo_slam_tpu_torch.frontend.pointcloud import create_pointcloud

    # -- phase 1: card and build
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"nvcc build of {len(cuda_build.SOURCES)} sources (in parallel): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for src, text in cuda_build.build_report.get("ptxas", {}).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)

    report = {k.name: dict(name=k.name, route="cuda",
                           source=f"cvo_slam_tpu_torch/csrc/{k.source}",
                           replaces=k.replaces, launches=0, max_abs_err=0.0,
                           ms=None, plain_ms=None, bound_ms=None,
                           bound_by=None, library_ms=None, times_by_ell={})
              for k in kernels.KERNELS}
    cam = CAMERA_PRESETS["TUM1"]
    p = SlamConfig.default_shipped().cvo
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as folder:
        t0 = time.perf_counter()
        gt = synthetic.make_sequence(folder, cam, n_frames=N_FRAMES)
        print(f"synthetic sequence: {N_FRAMES} frames 640x480 in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # -- phase 2: kernel checks on frames 0 and 1 of the sequence
        records = tum.load_association(os.path.join(folder, "associate.txt"))
        images = [tum.load_image(folder, r) for r in records[:2]]
        clouds = {}
        for cap in CAPS:
            fp = FrontendParams(cloud_capacity=cap)
            pcs = [create_pointcloud(im.bgr, im.gray, im.depth, cam, fp)
                   for im in images]
            print(f"CAP {cap}: {[pc.count for pc in pcs]} valid points",
                  flush=True)
            clouds[cap] = [host_cloud_tensors(pc, "cuda") for pc in pcs]
        kernel_checks(clouds, p, report)

        # -- phase 3: tracking-only SLAM through the CLI's run(); phase 4:
        #    the whole system; then one frame under the profiler (after, so
        #    it cannot slow phases 3-4)
        tracking(folder, gt, report, card)
        slam(os.path.join(folder, "slam"), report, card)
        profile_frame(clouds, p)

    for entry in report.values():
        if entry["launches"] <= 0:
            return fail(f"{entry['name']} was not launched on the main path")
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(card, flush=True)              # as nvidia-smi prints it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:   # noqa: BLE001 — report any failed phase
        import traceback
        traceback.print_exc()
        sys.exit(fail(f"{type(exc).__name__}: {exc}"))
