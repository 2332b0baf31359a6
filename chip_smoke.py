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
     (through the shared epilogue) rtol 2e-4 / atol 1e-5; the suite's four
     sums rtol 1e-4; G atol 1e-5 after scaling by max|G|; the moment
     kernel's pass-1 keep bitmask equal bit for bit to the moment form's
     keep (kernels.moment_keep_bits_plain); two launches of each bitwise
     equal, the suite's split printed. The
     quartic coefficients D and E are printed, not held: the f32 epilogue
     (ops/pairwise.flow_and_step_from_moments) amplifies a 1e-7 change of
     Mom up to 1e-3 (D) and 1e-1 (E) relative on these clouds, for the
     plain version as much as for the kernel (measured against an f64
     evaluation of the same Mom). Times by CUDA events (median of 5 runs
     of 10 calls: the wrapper's host work included) and the kernels' own
     device time (torch.profiler over 20 calls) beside the plain version's
     time and the bound;
     The pair-stats kernel is held the same way, with and without
     moments: value and count, G and inliers, two launches bitwise equal.
     The profiler's launches per call are held at most 2 for the moment
     kernel and 1 for the suite and for pair stats in each mode, and a
     kernel whose device time the profiler does not see fails the phase.
     The per-pair align
     kernels: flow_and_step, flow and step_coeffs (csrc/flow_step.cu)
     against their plain versions at the same capacities and ells, nnz
     exact, omega and v rtol 2e-4 / atol 1e-6, B, C, D, E rtol 2e-3 (the
     bar of tests/test_pallas.py), pass 1's keep bitmask equal bit for
     bit to the keep mask of ops/pairwise.cvo_kernel, two launches of each
     bitwise equal; align_fused (csrc/align_fused.cu) against
     align_fused_plain on frames 0 -> 1 from the identity at ell 0.15: ell
     equal, the iteration count within ALIGN_ITERS_SPREAD (the moment-form
     align's count printed beside them), the transform within 1e-4 (metres
     and radians), two launches bitwise equal, the grid the card's resident
     blocks or the work items, whichever is fewer; then on frames 1 -> 2 ..
     5 -> 6 the iteration count within ALIGN_PAIRS_ITERS_SPREAD and the
     transform within ALIGN_PAIRS_GAP.
     flow and step_coeffs lie on no path (only the JAX package's tests
     call them): their launches are those of these checks, and each
     flow_and_step launch of the main path runs both passes once more;
  3. tracking: tracking-only SLAM at 640x480 / CAP 3072 on a 16-frame
     synthetic sequence through app.run_slam.run(device="cuda"), with the
     launch counters set to 0 just before and read just after; checks one
     finite pose per frame, both counters non-zero (the suite exactly one
     launch per alignment) and the position error against the ground truth
     below 0.05 m;
  3b. the same tracking with CVO_SLAM_BACKEND=pallas: align_fused exactly
     once per alignment, the moment kernel never, the suite once per
     alignment, position error below 0.05 m; ms/frame beside phase 3's;
  3c. tracking with CVO_SLAM_BACKEND=pallas_iter on the first 8 frames:
     flow_and_step at least once per align iteration, position error
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
  4b. the same walk with CVO_SLAM_BACKEND=pallas: the same checks, the
     moment kernel never launched, and align_fused launched once per
     tracking alignment plus once per verified loop-closure candidate;
     the keyframe-path stages beside phase 4's;
  4c. app.run_odometry on the 16-frame sequence under pallas: 15 finite
     poses, align_fused launched 15 times; ms/frame;
  5. one engine.frame_step under torch.profiler on each backend: device
     busy share, kernel launches per frame and per align iteration, and
     the device time by kernel name (top 10);
  6. a JSON line with every kernel's numbers, the card line, and last
     {"ok": true, "device": {...}}.

The bound of a kernel is the larger of issued fp32 instructions / 33.5 T
instructions/s (132 SMs x 128 lanes x 1.98 GHz on an H100 SXM at 700 W)
and bytes / 3.35 TB/s, with the instructions counted from this run's data
(pairs inside each gate). Every kernel compiles with -fmad=false, so each
add, multiply, compare and fused multiply-add of an explicit FMA chain is
one instruction (67 TFLOP/s would count an FMA as two operations and
every other instruction as one, and so halve the bound of these kernels,
which issue few FMAs). The
per-pair align kernels need the gate sweep once per iteration (the kept
pairs can be carried from one pass to the next), so it is counted once per
flow_and_step call, beside each pass's work on the kept pairs. For
align_fused, that count is taken at every iteration of the plain version's
run on the same pair (its poses and ells), averaged, and multiplied by the
iterations the kernel evaluated.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# fp32 instructions/s issued by the CUDA cores of an H100 SXM (132 SMs x
# 128 lanes x 1.98 GHz boost clock); an FMA is one instruction
PEAK_INSTR = 132 * 128 * 1.98e9
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
ITER_FRAMES = 8            # length of the pallas_iter tracking phase
# align_fused against its plain version: iteration counts may differ by up
# to this many (measured at CAP 3072 on an NVIDIA H100 80GB HBM3 on this
# script's frames 0 -> 1: 37 vs 40 with the sums of the first kernel, 45 vs
# 40 with the fixed order of csrc/flow_step.cuh; see ROADMAP queue 3)
ALIGN_ITERS_SPREAD = 5
# align_fused against its plain version on frames 1 -> 2 .. 5 -> 6 (at CAP
# 3072 from the identity at ell 0.15): the worst transform gap of every
# order of sums tried for it (1.1e-3 m) and the shipped order's worst
# iteration gap on these pairs (15), both from chip_compare.py kernels on
# an NVIDIA H100 80GB HBM3 (PERF.md §6)
ALIGN_PAIRS = 6
ALIGN_PAIRS_GAP = 1.1e-3
ALIGN_PAIRS_ITERS_SPREAD = 15
# kernels on no path of the JAX package (only its tests call them): their
# launches are those of the phase-2 checks
CHECK_ONLY = ("flow", "step_coeffs")
# the port's CUDA kernels as torch.profiler names them
OUR_KERNELS = ("moment_keep_pass", "moment_sum_pass", "suite_",
               "pair_stats_sweep", "flow_pass", "step_pass", "align_kernel")
# the CUDA kernels each wrapper launches, as torch.profiler names them
DEVICE_NAMES = {
    "moment_flow_step": ("moment_keep_pass", "moment_sum_pass"),
    "ip_suite": ("suite_",),
    "pair_stats": ("pair_stats_sweep",),
    "flow_and_step": ("flow_pass", "step_pass"),
    "flow": ("flow_pass",),
    "step_coeffs": ("step_pass",),
    "align_fused": ("align_kernel",),
}


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


def device_profile(fn, names, reps=20, windows=5):
    """(mean device time per call in ms, kernel launches per call) of the
    CUDA kernels of `fn` whose names contain one of `names`, from
    torch.profiler over `reps` calls after one warm-up call: the kernels'
    own time, without the wrapper's host work and launch gaps (which
    cuda_time_ms includes). The profiler now and then returns a window
    without device events, or with some of them lost (a count of kernels
    that is not a multiple of `reps`: every call launches the same
    kernels); such a window is taken again, up to `windows` windows. The
    time is None if no window held every launch: a window that lost
    events would read too fast."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per_call = 0.0
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ours = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.name for k in names)]
        per_call = len(ours) / reps
        if ours and len(ours) % reps == 0:
            us = sum(e.time_range.elapsed_us() for e in ours)
            return us / reps / 1e3, per_call
    return None, per_call


def device_time_ms(fn, names, reps=20):
    """The device time per call of device_profile."""
    return device_profile(fn, names, reps)[0]


# -- instruction and byte counts of each kernel's function -------------------
# Per pair, the fp32 instructions the function needs (-fmad=false: each
# add, multiply and compare is one; an explicit fused multiply-add of an
# FMA-chain dot is one):
#   moment pass: geometric distance of a valid pair 9 (3 sub, 3 mul, 2 add,
#   compare); colour distance of a pair inside the geometric gate 15; the
#   joint kernel of a gated pair 8 (2 mul, add, neg, max, exp, mul,
#   compare); a kept pair adds 35 multiplies and 35 adds into the moments.
#   suite: its four pair sets, each as pair stats counts it (below).

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
    """The suite's instructions: pair_stats_counts over its four pair sets
    (pre: rows y, columns x; post: yt, x, with moments; fixed: x, x;
    moving: y, y), the geometric gate first as the kernel tests it; bytes:
    each input read once, the outputs (G, four sums, four counts) written
    once."""
    sets = ((y, fy, my, x, fx, mx, False), (yt, fy, my, x, fx, mx, True),
            (x, fx, mx, x, fx, mx, False), (y, fy, my, y, fy, my, False))
    ops = sum(pair_stats_counts(*s[:6], ell, p, s[6])[0] for s in sets)
    n, m = x.shape[0], y.shape[0]
    nbytes = n * (3 + 5) * 4 + n + m * (3 + 5 + 3) * 4 + m \
        + (169 + 4) * 4 + 4 * 4
    return ops, nbytes


def pair_stats_counts(xa, fa, ma, xb, fb, mb, ell, p, with_moments):
    """One pair set of the suite, in instructions, its geometric gate
    tested first (it passes far fewer pairs): geometric distance of a valid
    pair 8, colour distance of a pair inside the geometric gate 10, a gated
    pair 12, and with moments W U(xb) of a gated pair 36 (the suite's post
    set)."""
    import torch
    from cvo_slam_tpu_torch.ops import pairwise
    valid = ma[:, None] & mb[None, :]
    d2 = ((xa[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    geo = valid & (d2 < pairwise.d2_threshold(torch.tensor(ell), p).item())
    d2c = ((fa[:, None, :] - fb[None, :, :]) ** 2).sum(-1)
    g = geo & (d2c < pairwise.d2_color_threshold(p))
    ops = 8 * int(valid.sum()) + 10 * int(geo.sum()) \
        + (48 if with_moments else 12) * int(g.sum())
    n, m = xa.shape[0], xb.shape[0]
    nbytes = (n + m) * ((3 + 5) * 4 + 1) + 4 \
        + ((169 + 1) * 4 + 4 if with_moments else 2 * 4)
    return ops, nbytes


def flow_step_counts(x, fx, mx, y, fy, my, ell, p, passes=("flow", "step")):
    """Instructions of the per-pair passes (csrc/flow_step.cuh) on this
    data: the gate sweep, once whatever the passes (the kept pairs can be
    carried from one pass to the next): geometric distance of a valid pair
    8 (a 3-term FMA-chain dot 3, the identity 3, clamp, compare), colour
    distance of a pair inside the geometric gate 10 (a 5-term chain 5, the
    identity 3, clamp, compare), the joint kernel of a gated pair 8; then
    a kept pair adds 10 in the flow pass (y - x, d += a (y - x), count) and
    67 in the step pass (four 3-dots, four subtractions, beta..epsilon, the
    B..E polynomials and four multiply-adds). Both clouds are read once;
    the outputs are 10 floats and 1 int."""
    import torch
    from cvo_slam_tpu_torch.ops import pairwise
    valid = mx[:, None] & my[None, :]
    d2 = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    geo = valid & (d2 < pairwise.d2_threshold(torch.tensor(ell), p).item())
    d2c = ((fx[:, None, :] - fy[None, :, :]) ** 2).sum(-1)
    gate = geo & (d2c < pairwise.d2_color_threshold(p))
    a = (p.sigma ** 2 * p.c_sigma ** 2) * torch.exp(torch.clamp(
        -(d2 / (2 * ell * ell) + d2c / (2 * p.c_ell ** 2)), min=-20.0))
    n = [int(t.sum()) for t in (valid, geo, gate, gate & (a > p.sp_thres))]
    per_kept = {"flow": 10, "step": 67}
    ops = 8 * n[0] + 10 * n[1] + 8 * n[2] \
        + sum(per_kept[q] for q in passes) * n[3]
    nbytes = (x.shape[0] + y.shape[0]) * ((3 + 5) * 4 + 1) + 10 * 4 + 4
    return ops, nbytes


def bound_ms(ops, nbytes):
    """The least time of `ops` fp32 instructions and `nbytes` bytes:
    (ms, what bounds it)."""
    t_ops, t_bytes = ops / PEAK_INSTR, nbytes / PEAK_BYTES
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
            # the kernel's own output: Mom column by column, nnz exactly;
            # pass 1's keep bitmask bit for bit; a second launch bitwise
            ell_t = torch.tensor(ell, device=x.device)
            bits = torch.empty((-(-x.shape[0] // kernels.KEEP_WORD),
                                y.shape[0]), dtype=torch.int32,
                               device=x.device)
            split = {}
            Mk, nk = kernels.moment_pass_cuda(x, y, fx, fy, mx, my, U, ell_t,
                                              p, keep_bits=bits,
                                              launch_info=split)
            again = kernels.moment_pass_cuda(x, y, fx, fy, mx, my, U, ell_t,
                                             p)
            Mp, npl = kernels.moment_pass_plain(x, y, fx, fy, mx, my, U,
                                                ell_t, p)
            want_bits = kernels.moment_keep_bits_plain(x, y, fx, fy, mx, my,
                                                       ell_t, p)
            torch.cuda.synchronize()
            if int(nk) != int(npl):
                raise AssertionError(f"moment nnz {int(nk)} != {int(npl)} "
                                     f"(CAP {cap}, ell {ell})")
            if not torch.equal(bits, want_bits):
                diff = kernels.unpack_keep_bits(bits, x.shape[0]) \
                    ^ kernels.unpack_keep_bits(want_bits, x.shape[0])
                raise AssertionError(f"moment keep bitmask: "
                                     f"{int(diff.sum())} bits differ (CAP "
                                     f"{cap}, ell {ell})")
            if not (torch.equal(Mk, again[0]) and torch.equal(nk, again[1])):
                raise AssertionError(f"moment: two launches differ (CAP "
                                     f"{cap}, ell {ell})")
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
                  f"equal, keep bitmask equal bit for bit, two launches "
                  f"bitwise equal, Mom max |err| / column max {err_m:.3e}, "
                  f"omega v B C max |err| {err:.3e}, D E rel diff "
                  f"{rel_de[0]:.2e} {rel_de[1]:.2e}; split {split}",
                  flush=True)

            split = {}
            got = kernels.ip_suite_cuda(x, fx, mx, y, fy, my, yt, ell, p,
                                        launch_info=split)
            again = kernels.ip_suite_cuda(x, fx, mx, y, fy, my, yt, ell, p)
            want = kernels.ip_suite_plain(x, fx, mx, y, fy, my, yt, ell, p)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"suite: two launches differ (CAP "
                                     f"{cap}, ell {ell})")
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
                  f"{int(got[9])} equal, two launches bitwise equal, max "
                  f"|err| {err:.3e}; split {split}", flush=True)

            # pair stats of the loop-closure post set: rows yt, columns x
            for mom in (False, True):
                split = {}
                got = kernels.pair_stats_cuda(yt, fy, my, x, fx, mx, ell, p,
                                              mom, launch_info=split)
                again = kernels.pair_stats_cuda(yt, fy, my, x, fx, mx, ell,
                                                p, mom)
                want = kernels.pair_stats_plain(yt, fy, my, x, fx, mx, ell,
                                                p, mom)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(
                        f"pair_stats: two launches differ (CAP {cap}, ell "
                        f"{ell}, moments {mom})")
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
                      f"{int(got[1])} equal, two launches bitwise equal, max "
                      f"|err| {err:.3e}; split {split}", flush=True)

        if cap != CAPS[0]:
            continue
        # times at the main path's capacity, at both ells
        for ell in ELLS:
            ell_t = torch.tensor(ell, device=x.device)
            kern = lambda: kernels.moment_pass_cuda(  # noqa: E731
                x, y, fx, fy, mx, my, U, ell_t, p)
            t_k = cuda_time_ms(kern)
            t_d, per_call = device_profile(kern,
                                           DEVICE_NAMES["moment_flow_step"])
            t_p = cuda_time_ms(lambda: kernels.moment_pass_plain(
                x, y, fx, fy, mx, my, U, ell_t, p), reps=3)
            ops, nbytes = moment_counts(x, fx, mx, y, fy, my, ell, p)
            b, by = bound_ms(ops, nbytes)
            _record(report["moment_flow_step"], ell, t_k, t_p, b, by, ops,
                    device=t_d, per_call=per_call, max_per_call=2)
            kern = lambda: kernels.ip_suite_cuda(  # noqa: E731
                x, fx, mx, y, fy, my, yt, ell_t, p)
            t_k = cuda_time_ms(kern)
            t_d, per_call = device_profile(kern, DEVICE_NAMES["ip_suite"])
            t_p = cuda_time_ms(lambda: kernels.ip_suite_plain(
                x, fx, mx, y, fy, my, yt, ell_t, p), reps=3)
            ops, nbytes = suite_counts(x, fx, mx, y, fy, my, yt, ell, p)
            b, by = bound_ms(ops, nbytes)
            _record(report["ip_suite"], ell, t_k, t_p, b, by, ops,
                    device=t_d, per_call=per_call, max_per_call=1)
            # pair stats: the six calls without moments are the main ones;
            # the two with moments are recorded beside them
            for mom in (True, False):
                kern = lambda: kernels.pair_stats_cuda(  # noqa: E731
                    yt, fy, my, x, fx, mx, ell_t, p, mom)
                t_k = cuda_time_ms(kern)
                t_d, per_call = device_profile(kern,
                                               DEVICE_NAMES["pair_stats"])
                t_p = cuda_time_ms(lambda: kernels.pair_stats_plain(
                    yt, fy, my, x, fx, mx, ell_t, p, mom), reps=3)
                ops, nbytes = pair_stats_counts(yt, fy, my, x, fx, mx, ell,
                                                p, mom)
                b, by = bound_ms(ops, nbytes)
                _record(report["pair_stats"], ell, t_k, t_p, b, by, ops,
                        "moments" if mom else "", device=t_d,
                        per_call=per_call, max_per_call=1)


def _record(entry, ell, t_k, t_p, b, by, ops, mode="", device=None,
            per_call=None, max_per_call=None):
    """Print one timing: t_k the CUDA-event time per wrapper call (host work
    included), `device` the kernels' own device time per call (None, where
    no profiler window held every launch, fails the phase), per_call the
    profiler's kernel
    launches per wrapper call (held at max_per_call when given); keep it
    under times_by_ell (mode-suffixed keys for a second mode) and as the
    entry's headline at the first ell without a mode."""
    tag = f" {mode}" if mode else ""
    if device is None:
        raise AssertionError(f"{entry['name']}{tag}: no profiler window held "
                             f"every launch of its kernels "
                             f"{DEVICE_NAMES[entry['name']]} (last window "
                             f"{per_call:g} per call)")
    if max_per_call is not None and per_call > max_per_call:
        raise AssertionError(f"{entry['name']}{tag}: {per_call} kernel "
                             f"launches per call, at most {max_per_call}")
    calls = "" if per_call is None else f", {per_call:g} launches per call"
    print(f"{entry['name']}{tag} CAP {CAPS[0]} ell {ell}: kernel {t_k:.4f} "
          f"ms per call, device {device:.4f} ms{calls}, plain {t_p:.4f} ms, "
          f"bound {b:.4f} ms ({by}, {ops:.4g} instructions), "
          f"{b / t_k:.1%} of bound per call, {b / device:.1%} on the device",
          flush=True)
    entry["times_by_ell"][str(ell) + (f" {mode}" if mode else "")] = dict(
        ms=t_k, device_ms=device, plain_ms=t_p, bound_ms=b,
        launches_per_call=per_call)
    if ell == ELLS[0] and not mode:
        entry.update(ms=t_k, device_ms=device, plain_ms=t_p, bound_ms=b,
                     bound_by=by)


def flow_step_checks(clouds, p, report):
    """Phase 2, the per-pair align kernels: flow_and_step, flow and
    step_coeffs against their plain versions; the checks' launches of
    flow and step_coeffs (CHECK_ONLY); times at CAP 3072."""
    import torch
    from cvo_slam_tpu_torch.cvo import kernels
    kernels.reset_launch_counts()
    for cap, (c0, c1) in clouds.items():
        x, fx, mx = c0
        y, fy, my = c1
        args = (x, y, fx, fy, mx, my)
        for ell in ELLS:
            want = kernels.flow_and_step_plain(*args, ell, p)
            bits = torch.empty((-(-y.shape[0] // kernels.KEEP_WORD),
                                x.shape[0]), dtype=torch.int32,
                               device=x.device)
            split = {}
            got = kernels.flow_and_step_cuda(*args, ell, p, keep_bits=bits,
                                             launch_info=split)
            flow = kernels.flow_cuda(*args, ell, p)
            step = kernels.step_coeffs_cuda(*args, want[0], want[1], ell, p)
            step_want = kernels.step_coeffs_plain(*args, want[0], want[1],
                                                  ell, p)
            # determinism: a second launch of each kernel, bit for bit
            again = (kernels.flow_and_step_cuda(*args, ell, p),
                     kernels.flow_cuda(*args, ell, p),
                     kernels.step_coeffs_cuda(*args, want[0], want[1], ell,
                                              p))
            torch.cuda.synchronize()
            for name, a, b in zip(("flow_and_step", "flow", "step_coeffs"),
                                  again, (got, flow, step)):
                if not all(torch.equal(u, w) for u, w in zip(a, b)):
                    raise AssertionError(f"{name}: two launches differ (CAP "
                                         f"{cap}, ell {ell})")
            # pass 1's keep bitmask against pairwise.cvo_kernel's keep
            want_bits = kernels.keep_bits_plain(*args, ell, p)
            if not torch.equal(bits, want_bits):
                diff = kernels.unpack_keep_bits(bits, y.shape[0]) \
                    ^ kernels.unpack_keep_bits(want_bits, y.shape[0])
                raise AssertionError(f"keep bitmask: {int(diff.sum())} bits "
                                     f"differ (CAP {cap}, ell {ell})")
            for name, n in (("flow_and_step", got[2]), ("flow", flow[2])):
                if int(n) != int(want[2]):
                    raise AssertionError(f"{name} nnz {int(n)} != "
                                         f"{int(want[2])} (CAP {cap}, "
                                         f"ell {ell})")
            errs = {"flow_and_step": 0.0, "flow": 0.0, "step_coeffs": 0.0}
            for name, g in (("flow_and_step", got), ("flow", flow)):
                for q in (0, 1):
                    errs[name] = max(errs[name], check_close(
                        f"{name} omega, v", g[q], want[q], 2e-4, 1e-6))
            for name, g, w in (("flow_and_step", got[3:], want[3:]),
                               ("step_coeffs", step, step_want)):
                for gq, wq in zip(g, w):
                    errs[name] = max(errs[name], check_close(
                        f"{name} B..E", gq, wq, 2e-3, 0.0))
            for name, err in errs.items():
                report[name]["max_abs_err"] = max(
                    report[name]["max_abs_err"], err)
            rel = [abs(float(g) - float(w)) / abs(float(w))
                   for g, w in zip(got[3:], want[3:])]
            print(f"flow_and_step / flow / step_coeffs CAP {cap} ell {ell}: "
                  f"nnz {int(got[2])} equal; keep bitmask equal bit for bit;"
                  f" two launches bitwise equal; max |err| {errs}; B C D E "
                  f"rel diff {' '.join(f'{r:.2e}' for r in rel)}; split "
                  f"{split}", flush=True)
    for k in (kernels.FLOW, kernels.STEP):
        report[k.name]["launches"] = k.launches
    (x, fx, mx), (y, fy, my) = clouds[CAPS[0]]
    args = (x, y, fx, fy, mx, my)
    for ell in ELLS:
        ell_t = torch.tensor(ell, device=x.device)
        omega, v, _ = kernels.flow_plain(*args, ell_t, p)
        for name, kern, plain, passes in (
                ("flow_and_step", lambda: kernels.flow_and_step_cuda(
                    *args, ell_t, p), lambda: kernels.flow_and_step_plain(
                    *args, ell_t, p), ("flow", "step")),
                ("flow", lambda: kernels.flow_cuda(*args, ell_t, p),
                 lambda: kernels.flow_plain(*args, ell_t, p), ("flow",)),
                ("step_coeffs", lambda: kernels.step_coeffs_cuda(
                    *args, omega, v, ell_t, p),
                 lambda: kernels.step_coeffs_plain(
                    *args, omega, v, ell_t, p), ("step",))):
            t_k = cuda_time_ms(kern)
            t_d, per_call = device_profile(kern, DEVICE_NAMES[name])
            t_p = cuda_time_ms(plain, reps=3)
            ops, nbytes = flow_step_counts(x, fx, mx, y, fy, my, ell, p,
                                           passes)
            b, by = bound_ms(ops, nbytes)
            _record(report[name], ell, t_k, t_p, b, by, ops, device=t_d,
                    per_call=per_call, max_per_call=len(passes))


def transform_gap(a, b):
    """(max |dt| in metres, angle in radians) between the transforms
    [R^T | -R^T T] of two align states (R, T)."""
    import numpy as np

    def transform(R, T):
        Rt = R.double().T.cpu().numpy()
        return Rt, -(Rt @ T.double().cpu().numpy())

    (Ra, ta), (Rb, tb) = transform(*a), transform(*b)
    D = Ra.T @ Rb
    return float(np.abs(ta - tb).max()), 0.5 * float(np.linalg.norm(
        [D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]]))


def align_args(seq, k, p):
    """align_fused's arguments for frames k -> k + 1 of `seq` (a list of
    clouds): from the identity at ell 0.15."""
    import torch
    dev = seq[k][0].device
    return tuple(seq[k]) + tuple(seq[k + 1]) + (
        torch.eye(3, device=dev), torch.zeros(3, device=dev),
        torch.tensor(ELLS[0], device=dev), p)


def align_pair_gap(seq, k, p):
    """align_fused against align_fused_plain on frames k -> k + 1: (kernel
    iterations, plain iterations, |dt| in metres, angle in radians, kernel
    ell, plain ell)."""
    from cvo_slam_tpu_torch.cvo import kernels
    a = align_args(seq, k, p)
    R, T, ell, it, _ = kernels.align_fused_cuda(*a)
    Rp, Tp, ellp, itp, _ = kernels.align_fused_plain(*a)
    dt, ang = transform_gap((R, T), (Rp, Tp))
    return int(it), int(itp), dt, ang, float(ell), float(ellp)


def align_checks(seq, p, report):
    """Phase 2, align_fused against align_fused_plain at CAP 3072 from the
    identity at ell 0.15: on frames 0 -> 1 ell equal, iterations within
    ALIGN_ITERS_SPREAD, the transform within 1e-4, two launches bitwise
    equal, time per alignment and the bound over the plain run's
    iterations (module docstring); on frames 1 -> 2 .. 5 -> 6 iterations
    within ALIGN_PAIRS_ITERS_SPREAD and the transform within
    ALIGN_PAIRS_GAP. seq: the sequence's first ALIGN_PAIRS + 1 clouds."""
    import numpy as np
    import torch
    from cvo_slam_tpu_torch.cvo import engine, kernels
    (x, fx, mx), (y, fy, my) = seq[:2]
    args = align_args(seq, 0, p)
    launch = {}
    got = kernels.align_fused_cuda(*args, launch_info=launch)
    R, T, ell, iters, _ = got
    again = kernels.align_fused_cuda(*args)
    Rp, Tp, ellp, iters_p, _ = kernels.align_fused_plain(*args)
    mom = engine.align(engine.PointCloud(x, fx, mx),
                       engine.PointCloud(y, fy, my), args[6], args[7],
                       ELLS[0], p, "pallas_mom")
    torch.cuda.synchronize()
    dt, ang = transform_gap((R, T), (Rp, Tp))
    print(f"align_fused CAP {CAPS[0]} frames 0 -> 1 ell {ELLS[0]}: iters "
          f"{int(iters)} (plain {int(iters_p)}, moment-form align "
          f"{int(mom.iters)}), ell {float(ell)} (plain {float(ellp)}), "
          f"transform |dt| {dt:.3e} m, angle {ang:.3e} rad; launch {launch}",
          flush=True)
    if not all(torch.equal(a, b) for a, b in zip(again, got)):
        raise AssertionError("align_fused: two launches differ")
    if launch["grid"] != min(launch["items"],
                             launch["blocks_per_sm"] * launch["sms"]):
        raise AssertionError(f"align_fused grid {launch}")
    if abs(int(iters) - int(iters_p)) > ALIGN_ITERS_SPREAD:
        raise AssertionError(f"align_fused iters {int(iters)} vs plain "
                             f"{int(iters_p)}")
    if float(ell) != float(ellp) or dt > 1e-4 or ang > 1e-4:
        raise AssertionError(f"align_fused: ell {float(ell)} vs "
                             f"{float(ellp)}, |dt| {dt}, angle {ang}")
    report["align_fused"]["max_abs_err"] = max(dt, ang)
    gaps = []
    for k in range(1, ALIGN_PAIRS):
        it, itp, dt_k, ang_k, ell_k, ellp_k = align_pair_gap(seq, k, p)
        gaps.append(f"{k}->{k + 1}: {it} vs {itp} iterations, {dt_k:.2e} m, "
                    f"{ang_k:.2e} rad, ell {ell_k} vs {ellp_k}")
        if abs(it - itp) > ALIGN_PAIRS_ITERS_SPREAD \
                or max(dt_k, ang_k) > ALIGN_PAIRS_GAP:
            raise AssertionError(f"align_fused frames {k} -> {k + 1}: {it} "
                                 f"vs {itp} iterations, |dt| {dt_k}, angle "
                                 f"{ang_k}")
        report["align_fused"]["max_abs_err"] = max(
            report["align_fused"]["max_abs_err"], dt_k, ang_k)
    print(f"align_fused CAP {CAPS[0]} against its plain version, bars "
          f"{ALIGN_PAIRS_ITERS_SPREAD} iterations and {ALIGN_PAIRS_GAP} m / "
          f"rad: {'; '.join(gaps)}", flush=True)

    # the bound: both passes at each iteration of the plain run
    seen = []

    def iterate(yk, ellk):
        seen.append((yk, float(ellk)))
        return kernels.flow_and_step_plain(x, yk, fx, fy, mx, my, ellk, p)

    ref = engine.align_loop(iterate, y, *args[6:9], p)
    seen = seen[:int(ref.iters) + 1]
    per_iter = [flow_step_counts(x, fx, mx, yk, fy, my, ek, p)[0]
                for yk, ek in seen]
    n_iter = int(iters) + 1
    ops = float(np.mean(per_iter)) * n_iter
    nbytes = (x.shape[0] + y.shape[0]) * ((3 + 5) * 4 + 1) + 13 * 4 \
        + 13 * 4 + 2 * 4
    b, by = bound_ms(ops, nbytes)
    t_k = cuda_time_ms(lambda: kernels.align_fused_cuda(*args), reps=5,
                       trials=3)
    t_d = device_time_ms(lambda: kernels.align_fused_cuda(*args),
                         DEVICE_NAMES["align_fused"], reps=5)
    if t_d is None:
        raise AssertionError("align_fused: no profiler window held every "
                             f"launch of {DEVICE_NAMES['align_fused']}")
    t_p = cuda_time_ms(lambda: kernels.align_fused_plain(*args), reps=1,
                       trials=3)
    print(f"align_fused CAP {CAPS[0]}: {t_k:.4f} ms per alignment (device "
          f"{t_d:.4f} ms), {n_iter} iterations, {t_k / n_iter:.4f} ms per "
          f"iteration; plain {t_p:.1f} ms; bound {b:.4f} ms ({by}, "
          f"{ops:.4g} instructions), {b / t_k:.1%} of bound per call, "
          f"{b / t_d:.1%} on the device", flush=True)
    report["align_fused"].update(ms=t_k, device_ms=t_d, plain_ms=t_p,
                                 bound_ms=b,
                                 bound_by=by, iterations=n_iter,
                                 ms_per_iteration=t_k / n_iter,
                                 launch=launch)


@contextlib.contextmanager
def backend_env(name):
    """CVO_SLAM_BACKEND set to `name` for the block, restored after."""
    old = os.environ.get("CVO_SLAM_BACKEND")
    os.environ["CVO_SLAM_BACKEND"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["CVO_SLAM_BACKEND"]
        else:
            os.environ["CVO_SLAM_BACKEND"] = old


def profile_frame(clouds, p, backend):
    """One engine.frame_step (all device work of a tracked frame) on
    `backend` under torch.profiler: wall time, device time summed over
    kernels, the number of kernel launches, and the port's CUDA kernels'
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cvo_slam_tpu_torch.cvo import engine
    (x, fx, mx), (y, fy, my) = clouds[CAPS[0]]
    prev, cur = engine.PointCloud(x, fx, mx), engine.PointCloud(y, fy, my)
    eye3, zero3 = torch.eye(3).numpy(), torch.zeros(3).numpy()

    def frame():
        out = engine.frame_step(prev, prev, cur, eye3, zero3, p.ell_init,
                                torch.eye(4).numpy(), p.ell_init, p, backend)
        torch.cuda.synchronize()
        return out

    frame()                                     # warm-up
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = frame()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_us, ours_us, n = 0.0, 0.0, 0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            d = e.time_range.elapsed_us()
            kernels_us += d
            n += 1
            if any(k in e.name for k in OUR_KERNELS):
                ours_us += d
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0][:60]
            t, c = by_name.get(name, (0.0, 0))
            by_name[name] = (t + d, c + 1)
    iters = int(res[0].iters) + int(res[2].iters) + 2
    if kernels_us == 0.0:
        print(f"profile of one frame_step ({backend}): wall {wall_ms:.1f} "
              "ms; device time not measured (the profiler saw no CUDA "
              "kernels)", flush=True)
        return
    print(f"profile of one frame_step ({backend}, CAP {CAPS[0]}, {iters} "
          f"align iterations): wall {wall_ms:.1f} ms (profiler on), device "
          f"kernels {kernels_us / 1e3:.2f} ms = "
          f"{kernels_us / 1e3 / wall_ms:.1%} busy, {n} kernel launches per "
          f"frame ({n / iters:.1f} per iteration), the port's CUDA kernels "
          f"{ours_us / 1e3:.2f} ms", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    print(f"  device time by kernel ({backend}, top 10: ms, launches): "
          + "; ".join(f"{k} {t / 1e3:.3f} ms x{c}" for k, (t, c) in top),
          flush=True)


def host_cloud_tensors(pc, device):
    from cvo_slam_tpu_torch.cvo.engine import PointCloud
    c = PointCloud.from_host(pc, device)
    return c.positions, c.features, c.mask


def sequence_clouds(folder, cam, cap, n_frames=None):
    """The first n_frames frames (all by default) of the sequence in
    `folder` as clouds on the card at capacity `cap`."""
    from cvo_slam_tpu_torch.config import FrontendParams
    from cvo_slam_tpu_torch.data import tum
    from cvo_slam_tpu_torch.frontend.pointcloud import create_pointcloud
    records = tum.load_association(os.path.join(folder, "associate.txt"))
    fp = FrontendParams(cloud_capacity=cap)
    pcs = [create_pointcloud(im.bgr, im.gray, im.depth, cam, fp)
           for im in (tum.load_image(folder, r)
                      for r in records[:n_frames])]
    print(f"CAP {cap}: {[pc.count for pc in pcs]} valid points", flush=True)
    return [host_cloud_tensors(pc, "cuda") for pc in pcs]


def first_pair_clouds(folder, cam, caps=CAPS):
    """{CAP: [(x, fx, mx), (y, fy, my)]}: frames 0 and 1 of the sequence in
    `folder` as clouds on the card, at each capacity."""
    return {cap: sequence_clouds(folder, cam, cap, 2) for cap in caps}


def tracking(folder, gt, report, card, backend, n_frames=N_FRAMES):
    """Phases 3, 3b, 3c: tracking-only SLAM on `backend` over the first
    n_frames frames, counters set to 0 just before, read just after.
    Returns the tracked frames' ms/frame."""
    import numpy as np
    from cvo_slam_tpu_torch.app import run_slam
    from cvo_slam_tpu_torch.config import SlamConfig
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.data import tum
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True)
    with backend_env(backend):
        kernels.reset_launch_counts()
        stats = run_slam.run(folder, "associate.txt", "TUM1", cfg,
                             max_frames=n_frames, device="cuda")
        launches = {k.name: k.launches for k in kernels.KERNELS}

    ts, poses = tum.read_trajectory(os.path.join(folder,
                                                 "Tracking_trajectory.txt"))
    if len(ts) != n_frames or not np.isfinite(poses).all():
        raise AssertionError(f"{len(ts)} poses for {n_frames} frames, "
                             f"finite: {np.isfinite(poses).all()}")
    err = np.linalg.norm(poses[:, :3, 3] - gt[:n_frames, :3, 3], axis=1)
    ate = tum.ate_rmse([f"{1000.0 + 0.05 * k:.6f}" for k in range(n_frames)],
                       gt[:n_frames], ts, poses)
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    tracked = [r for r in rows if "odo_iters" in r]
    odo = [r["odo_iters"] for r in tracked]
    kf = [r["kf_iters"] for r in tracked]
    iters = odo + kf
    t_frame = [r["t_frame_s"] * 1e3 for r in tracked]
    # alignments: one bootstrap (odometry only) + two per tracked frame
    n_align = 1 + 2 * len(tracked)
    print(f"tracking ({stats['backend']}) {n_frames} frames 640x480 CAP "
          f"3072 on {card}: {np.mean(t_frame):.1f} ms/frame mean, "
          f"{np.median(t_frame):.1f} median over {len(tracked)} tracked "
          f"frames; wall {stats['wall_s']:.2f} s ({stats['fps']:.2f} fps "
          f"incl. bootstrap and IO); {np.mean(iters):.1f} align iterations "
          f"per alignment (tracked frames: odometry {odo}, keyframe {kf}); "
          f"launches {launches}; alignments {n_align}; max position error "
          f"{err.max():.4f} m, ATE {ate:.4f} m", flush=True)
    # the align kernel of the backend: at least once per iteration, or
    # (align_fused) exactly once per alignment; the other two never
    aligns = {"pallas_mom": "moment_flow_step",
              "pallas_iter": "flow_and_step", "pallas": "align_fused"}
    align = aligns[backend]
    ok = launches["ip_suite"] == n_align and stats["backend"] == backend \
        and all(launches[k] == 0 for k in aligns.values() if k != align)
    if backend == "pallas":
        ok &= launches[align] == n_align
    else:
        ok &= launches[align] >= sum(iters)
    if not ok:
        raise AssertionError(f"{backend}: launch counts {launches} do not "
                             f"match {sum(iters)} iterations / {n_align} "
                             f"alignments")
    for name, n in launches.items():
        if n and not report[name]["launches"]:
            report[name]["launches"] = n
    if err.max() >= 0.05:
        raise AssertionError(f"position error {err.max()} m >= 0.05 m")
    return t_frame


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


def slam(folder, report, card, device="cuda", cam=None, cfg=None,
         backend="pallas_mom"):
    """Phases 4 and 4b: the whole SLAM system on an out-and-back sequence
    on `backend`, counters set to 0 just before run() and read just
    after."""
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
    with backend_env(backend):
        kernels.reset_launch_counts()
        stats = run_slam.run(folder, "associate.txt", cam, cfg, device=device)
        launches = {k.name: k.launches for k in kernels.KERNELS}

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
    print(f"SLAM ({stats['backend']}) {stats['frames']} frames "
          f"{cam.width}x{cam.height} CAP {cfg.frontend.cloud_capacity} on "
          f"{card}: {stats['keyframes']} keyframes, "
          f"{stats.get('lc_rounds', 0)} loop-closure rounds, "
          f"{stats.get('lc_candidates', 0)} candidates verified, "
          f"{stats['lc_num']} loop-closure edges accepted; launches "
          f"{launches}; ms per keyframe event by stage {stages}; "
          f"loop-closure sub-stages "
          f"{ {k: round(v['mean'], 1) for k, v in stats.get('lc_stage_ms', {}).items()} }; "
          f"wall {stats['wall_s']:.1f} s; tracking ATE {ate_track:.4f} m, "
          f"SLAM ATE {ate_slam:.4f} m", flush=True)
    align = "align_fused" if backend == "pallas" else "moment_flow_step"
    used = (align, "ip_suite", "pair_stats")
    if min(launches[k] for k in used) <= 0 or stats["backend"] != backend \
            or any(n for k, n in launches.items() if k not in used):
        raise AssertionError(f"{backend}: SLAM launched {launches}")
    if backend == "pallas":
        # frame 0 seeds, frame 1 bootstraps (one alignment), every later
        # frame aligns twice; the rest are the loop-closure verifications
        n_track = 1 + 2 * (stats["frames"] - 2)
        if launches[align] - n_track != stats.get("lc_candidates", 0):
            raise AssertionError(
                f"align_fused launched {launches[align]} times for {n_track} "
                f"tracking alignments and {stats.get('lc_candidates', 0)} "
                f"loop-closure candidates")
    if not report["pair_stats"]["launches"]:
        report["pair_stats"]["launches"] = launches["pair_stats"]
    if stats["lc_num"] < 1:
        raise AssertionError("no loop-closure edge was accepted")
    if any(len(r) != 62 for r in rows):
        raise AssertionError(f"loop_closure.txt rows of "
                             f"{sorted({len(r) for r in rows})} fields")
    if not ate_slam < 0.05:
        raise AssertionError(f"SLAM ATE {ate_slam} m >= 0.05 m")
    return stats


def odometry(folder, gt, card):
    """Phase 4c: app.run_odometry on the tracking sequence under pallas,
    counters set to 0 just before, read just after."""
    import numpy as np
    from cvo_slam_tpu_torch.app import run_odometry
    from cvo_slam_tpu_torch.config import SlamConfig
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.data import tum
    with backend_env("pallas"):
        kernels.reset_launch_counts()
        stats = run_odometry.run(folder, "associate.txt", "TUM1",
                                 SlamConfig.default_shipped(), device="cuda")
        launches = {k.name: k.launches for k in kernels.KERNELS}
    ts, poses = tum.read_trajectory(stats["trajectory"])
    ate = tum.ate_rmse([f"{1000.0 + 0.05 * k:.6f}" for k in range(N_FRAMES)],
                       gt[:N_FRAMES], ts, poses)
    print(f"run_odometry ({stats['backend']}) {N_FRAMES} frames on {card}: "
          f"{stats['mean_frame_ms']:.1f} ms/frame mean (frontend included), "
          f"{len(ts)} poses, launches {launches}, ATE {ate:.4f} m",
          flush=True)
    if len(ts) != N_FRAMES - 1 or not np.isfinite(poses).all():
        raise AssertionError(f"run_odometry wrote {len(ts)} poses, finite: "
                             f"{np.isfinite(poses).all()}")
    if launches["align_fused"] != N_FRAMES - 1 or stats["backend"] != "pallas":
        raise AssertionError(f"run_odometry launches {launches}")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "cvo_slam_tpu_torch")):
        return fail("cvo_slam_tpu_torch/ not found beside chip_smoke.py: run "
                    "from the root of a checkout")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this run needs a "
                    "CUDA card")
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu_torch.cvo import cuda_build, kernels
    from cvo_slam_tpu_torch.data import synthetic

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
                           ms=None, device_ms=None, plain_ms=None,
                           bound_ms=None,
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
        clouds = first_pair_clouds(folder, cam)
        kernel_checks(clouds, p, report)
        flow_step_checks(clouds, p, report)
        align_checks(sequence_clouds(folder, cam, CAPS[0], ALIGN_PAIRS + 1),
                     p, report)

        # -- phase 3: tracking-only SLAM through the CLI's run() on each
        #    backend; phase 4: the whole system; phase 4c: run_odometry;
        #    then one frame under the profiler (after, so it cannot slow
        #    phases 3-4)
        t_mom = tracking(folder, gt, report, card, "pallas_mom")
        t_fused = tracking(folder, gt, report, card, "pallas")
        print(f"ms/frame mean / median: pallas_mom {np.mean(t_mom):.1f} / "
              f"{np.median(t_mom):.1f}, pallas {np.mean(t_fused):.1f} / "
              f"{np.median(t_fused):.1f}", flush=True)
        tracking(folder, gt, report, card, "pallas_iter", ITER_FRAMES)
        s_mom = slam(os.path.join(folder, "slam"), report, card)
        s_fused = slam(os.path.join(folder, "slam"), report, card,
                       backend="pallas")
        for name, st in (("pallas_mom", s_mom), ("pallas", s_fused)):
            print(f"keyframe path ms per event ({name}): "
                  f"{ {k: round(v['mean'], 1) for k, v in st.get('keyframe_path_ms', {}).items()} }, "
                  f"verify per round "
                  f"{round(st['lc_stage_ms']['verify']['mean'], 1) if 'lc_stage_ms' in st else None}",
                  flush=True)
        odometry(folder, gt, card)
        for backend in ("pallas_mom", "pallas", "pallas_iter"):
            profile_frame(clouds, p, backend)

    for entry in report.values():
        if entry["launches"] <= 0:
            return fail(f"{entry['name']} was not launched " + (
                "by its checks" if entry["name"] in CHECK_ONLY
                else "on the main path"))
    for name in CHECK_ONLY:
        report[name]["launches_from"] = "phase-2 checks"
        report[name]["passes_in_flow_and_step"] = \
            report["flow_and_step"]["launches"]
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
