#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (cvo_slam_tpu_torch) on one GPU.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 chip_smoke.py
    python3 chip_smoke.py --cards N   (a machine with N cards: phases 4b,
                                       4h and 4i only, one shard per card)

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
     The lanes (kernels.align_fused_lanes, ip_suite_lanes): align_fused
     on frames 0 -> 1 .. 5 -> 6 as 6 lanes of one launch (distinct fixed
     clouds), each lane equal to its solo launch bit for bit and within
     the pairs' bars of its plain run; then S = LANE_COUNTS lanes against
     the shared frame-0 cloud (the moving clouds frames 1.., the last
     lane started at its own solution), each lane equal to its solo
     launch bit for bit (S = 1: the solo wrapper); the suite on frames
     l -> l + 1 as 1 and 4 lanes (yt under TWIST, ells alternating), each
     lane equal to its solo launch bit for bit, counts equal to the plain
     lanes' and sums and G at the suite's bars. Each lane call is one
     kernel launch in the profiler; its device ms is printed beside the
     S solo launches';
     flow and step_coeffs lie on no path (only the JAX package's tests
     call them): their launches are those of these checks, and each
     flow_and_step launch of the main path runs both passes once more.
     Tile skipping (the gate sweeps of the moment kernel, flow_and_step,
     flow, step_coeffs and align_fused skip the tile pairs whose boxes lie
     beyond the gate radius): at CAP 3072 and 3000, ell 0.15 and 0.06,
     each skipping launch bitwise equal to its tile_skip=False launch
     (outputs and keep bitmasks; align_fused on frames 0 -> 1 from the
     identity at each ell; its lanes at CAP 3072, frames k -> k + 1 on
     distinct fixed clouds and frames 1 .. against frame 0), at least one
     tile pair skipped in each (in every lane), the unskipped launch one
     sweep's tile pairs (align_fused: one a evaluated iteration), and the
     count the kernel reports equal to kernels.tile_flags_plain's where it
     sweeps the clouds as given; the skip fraction, and the device ms with
     and without skipping at CAP 3072 (in turns: skipping, not, not,
     skipping);
  2m. the sharded align (parallel.batch.make_sharded_align): SHARDED_LANES
     lanes on the frame-0 cloud (the moving clouds frames 1 ..) over a
     mesh of SHARDS shards on the one card, one align_fused_lanes launch
     per shard (counters set to 0 just before, read just after): every
     lane equal bit for bit to the same lane of one SHARDED_LANES-lane
     launch; the shards' device ms beside the one launch's (the shards run
     one after another on one card). Its launches and phase 4h's are added
     to the kernels' main-path counts;
  2x. the xla align (engine.align(..., "xla"): the JAX package's dense
     moment-form pass, plain torch and one torch.mm per iteration, no hand
     kernel, as the JAX package computes it outside Pallas) on frames
     0 -> 1 .. 5 -> 6 from the identity at ell 0.15: finite, within
     XLA_PAIRS_GAP m / rad of the pallas_mom align on the same pair (the
     iterations printed beside the pallas_mom align's); one pass on
     frames 0 -> 1 at both ells against the same function on the CPU
     (keep bit for bit, Mom, omega, v, B, C at phase 2's bars); the six
     pairs as the lanes of one
     lane program (engine.align_lanes), on distinct fixed clouds and on the
     frame-0 cloud, every lane equal to its solo align bit for bit; no
     kernel launched and no plain version of one run (counters set to 0
     just before, read just after); the wall ms of the six lanes (and
     their peak memory) against the six solo aligns'. chip_compare.py xla
     gives the device times;
  3. tracking: tracking-only SLAM at 640x480 / CAP 3072 on a 16-frame
     synthetic sequence through app.run_slam.run(device="cuda"), with the
     launch counters set to 0 just before and read just after; checks one
     finite pose per frame, both counters non-zero (the suite exactly one
     launch per alignment) and the position error against the ground truth
     below 0.05 m;
  3b. the same tracking with CVO_SLAM_BACKEND=pallas: align_fused exactly
     once per alignment, the moment kernel never, the suite once per
     alignment, position error below 0.05 m; ms/frame beside phase 3's;
  3x. the tracking of phase 3 with CVO_SLAM_BACKEND=xla: the suite once
     per alignment and no other kernel, no plain version of one run,
     position error below 0.05 m; ms/frame beside phases 3 and 3b's;
  3c. tracking with CVO_SLAM_BACKEND=pallas_iter on the first 8 frames:
     flow_and_step at least once per align iteration, position error
     below 0.05 m;
  3s. phases 3, 3b and 3c again with every main-path wrapper's
     tile_skip=False (the sweeps compute every tile pair): each trajectory
     equal to the skipping run's line for line;
  4. SLAM: the whole system (SlamConfig.default_shipped(), OnlyTracking
     False: tracking, keyframe graph, ORB + BoW, loop closure, windowed BA,
     final BA, frame-list refinement) through app.run_slam.run on a
     synthetic out-and-back sequence at 640x480 / CAP 3072 with the TUM1
     camera and ORB at 5000 features, counters set to 0 just before and
     read just after; fails unless every kernel launched (pair_stats from
     the loop-closure verification), every loop-closure candidate was
     verified with the JAX package's routed align (xla under pallas_mom,
     pallas under pallas and pallas_iter), at least one loop-closure edge
     was accepted, every loop_closure.txt row has 62 fields and the SLAM ATE is
     below 0.05 m;
  4b. the same walk with CVO_SLAM_BACKEND=pallas: the same checks, the
     moment kernel never launched, and align_fused launched once per
     tracking alignment plus once per verified loop-closure candidate;
     the keyframe-path stages beside phase 4's;
  4c. app.run_odometry on the 16-frame sequence under pallas: 15 finite
     poses, align_fused launched 15 times; ms/frame;
  3e. (run after 3d) lockstep tracking (parallel.multi_sequence): the
     phase-3 sequence and three more (seeds 8-10, their own step
     twists), 16 frames each at 640x480 / CAP 3072, the shipped
     configuration with OnlyTracking, under pallas: each sequence's
     poses equal bit for bit to its solo run with CVO_SLAM_SPECULATE=0;
     align_fused_lanes and ip_suite_lanes launched once per round of each
     request kind, align_fused and ip_suite never; ms per frame round and
     per sequence-frame beside the solo runs' ms/frame. Then the first two
     sequences, 8 frames, under pallas_mom, which a batch routes to xla as
     the JAX package does (each round's aligns one xla lane program, the
     suite as lanes): poses equal to the solo xla runs bit for bit, the
     moment kernel and align_fused never launched, no plain version run;
     ms per sequence-frame beside the solo xla and solo pallas_mom runs'
     ms/frame; and through the whole
     pipeline (OnlyTracking False, Max_KF_interval=3, the last frame a
     forced keyframe): keyframe counts and poses equal to solo;
  3d. (run after 3c) the tracking of phase 3b with CVO_SLAM_SPECULATE=1:
     the trajectory equal to phase 3b's line for line (bitwise), at least
     one speculation consumed, align_fused and the suite once per
     alignment plus twice per discarded speculation; hits, misses and
     ms/frame beside phase 3b's. Phases 3-4d run with speculation off, so
     their launch counts are exact;
  4, 4b (loop-closure round): each SLAM phase prints its descriptor
     matchings on the card and on the host, and per round the ransac,
     verify and overlap ms; at ORB 5000 the device matcher must run at
     least once; in phase 4 every device matching is held byte for byte
     against the host match_bow on the same keyframes;
  4d. the walk of phase 4b with UseMultiThreading (the async backend):
     the same keyframe ids, timestamps and count as phase 4b, positions
     within 1e-6 m, at least one accepted edge; frame-loop and whole run()
     time beside phase 4b's;
  4e. app.run_odometry --adaptive on the 16-frame sequence: 15 finite
     poses, no kernel launched and no plain version of one run (each
     iteration one xla pass); ms/frame and ATE;
  4f. data.checkpoint: 8 frames tracked under pallas, saved after frame 4
     and resumed in a fresh tracker, poses bitwise equal to the
     uninterrupted run;
  4g. eval.suite.run_suite on fast_rotation_100 and noisy_loop_120, full
     length, under pallas with the default speculation: tracking and SLAM
     ATE under tests/test_eval.py's bars (SUITE_BARS); ATE, RPE, loops,
     fps and keyframe-path ms per sequence;
  4h. mesh SLAM: the walk of phase 4b under pallas through
     app.run_slam.run(mesh=<SHARDS shards on cuda:0>), the windowed BA on
     parallel.sharded_ba and the final BA on parallel.sharded_lm: the
     keyframe ids and timestamps and the accepted loop-closure edges of
     phase 4b, keyframe positions within 1e-3 m (tests/test_mesh_slam.py's
     bar), at least one sharded windowed BA and one sharded final BA, each
     window's landmarks as in phase 4b; the windows' sizes and the
     keyframe-path ms per stage beside phase 4b's;
  4i. the solvers: eval.scaling.run_harness at its defaults (48 poses,
     96 landmarks, 10 iterations, SCALING_REPEATS repeats) on 1, 2 and 4
     shards of the card, dense and pcg, every row within 1e-4 of the
     single-device solver; then 10 landmarks on 4 shards (4 does not
     divide 10) against the single-device optimize_ba (poses rtol 1e-3 /
     atol 1e-4, landmarks atol 1e-3);
  4j. two processes: two gloo ranks, each with 2 shards on cuda:0, run the
     sharded LM (parallel.multiprocess): the ranks equal bit for bit and
     within the LM bars of the in-process 4-shard mesh;
  4k. the device frontend (frontend.device.create_pointcloud_device) on
     4 frames of the 640x480 sequence (CAP 3072), one ETH3D-shaped frame
     (739x458, CAP 3000) and one frame with feature_type 0, against the
     host create_pointcloud: count and pixel set exact, positions rtol
     1e-5 / atol 1e-6, features rtol 1e-4 / atol 1e-3 (HSV one quantum on
     H and S); ms per frame of both;
  4l. place recognition (eval.place_recognition: 43 keyframes of three
     aliased places at 160x120, the growing vocabulary retrained along the
     way, one detect() under the default backend on the card): at least
     one accepted edge to the revisited place, none to the decoys (the
     JAX package's tests/test_place_recognition.py bars);
  5. one engine.frame_step under torch.profiler on each backend with a
     kernel of its own (xla's device work is phase 2x's): device
     busy share, kernel launches per frame and per align iteration, and
     the device time by kernel name (top 10);
  6. a JSON line with every kernel's numbers, the run's seconds, the card
     line, and last {"ok": true, "device": {...}}.
Each phase prints its wall time. No earlier phase is cut in depth: the
whole run took 661.9-756.0 s of the 1200 s limit on an NVIDIA H100 80GB
HBM3 at 700.00 W with phases 3s and 4l and the tile-skip checks (642.0 s
before them; its largest parts are phase 4g's generation of 220 frames,
~200 s, and phase 3e's lockstep runs, ~100 s).

The bound of a kernel is the larger of issued fp32 instructions / 33.5 T
instructions/s (132 SMs x 128 lanes x 1.98 GHz on an H100 SXM at 700 W)
and bytes / 3.35 TB/s, with the instructions counted from this run's data
(pairs inside each gate; for the skipping sweeps only the pairs of the
tile pairs they compute, kernels.tile_flags_plain). Every kernel compiles
with -fmad=false, so each add, multiply, compare and fused multiply-add of
an explicit FMA chain is one instruction (67 TFLOP/s would count an FMA as
two operations and every other instruction as one, and so halve the bound
of these kernels, which issue few FMAs). The per-pair align kernels need
the gate sweep once per iteration (the kept pairs can be carried from one
pass to the next), so it is counted once per flow_and_step call, beside
each pass's work on the kept pairs. For align_fused, that count is taken
at every iteration of the plain version's run on the same pair (its poses
and ells), averaged, and multiplied by the iterations the kernel
evaluated.
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
# eval.suite sequences of phase 4g and their tracking / SLAM ATE bars in
# metres: tests/test_eval.py:94 (fast rotation with an exposure ramp) and
# :162 (the noisy loop)
SUITE_BARS = {"fast_rotation_100": 0.01, "noisy_loop_120": 0.03}
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
# the xla align against the pallas_mom align on the same pairs (phase 2x):
# two formulations of the moment-form align whose sums round differently,
# held as far apart as the pallas_mom align lies from its own plain
# version on these pairs (1-29 iterations, up to 2.2e-3 m: chip_compare.py
# kernels on an NVIDIA H100 80GB HBM3, PERF.md §6); the iterations are
# printed, not held: frames 0 -> 1 stop after 24 xla iterations on the
# card, 45-58 on the CPU by thread count and 47 in the JAX package's xla,
# each stop the se3-distance rule on an oscillating flow
# (tests/test_torch_xla_orders.py)
XLA_PAIRS_GAP = 2.2e-3
# the lanes of align_fused on the shared frame-0 cloud (phase 2)
LANE_COUNTS = (1, 2, 4, 10)
# phase 3e: lockstep tracking of LOCKSTEP_SEQS sequences (the phase-3
# sequence, seed 7, and three more: seeds 8-10, each with its own multiple
# of the default step twist), N_FRAMES frames each under pallas; the
# pallas_mom and whole-pipeline runs take the first two for
# LOCKSTEP_SHORT frames
LOCKSTEP_SEQS = 4
LOCKSTEP_SHORT = 8
LOCKSTEP_STEPS = (None, (-0.003, 0.005, -0.002, -0.008, 0.009, -0.006),
                  (0.002, 0.003, -0.004, 0.006, 0.004, 0.010),
                  (0.005, -0.004, -0.003, 0.008, 0.007, -0.005))
# phase 2m: lanes on the frame-0 cloud split over SHARDS shards of the one
# card; phases 4h and 4i: the mesh of SHARDS shards, and the scaling
# harness's repeats (best of, after one untimed call)
SHARDED_LANES = 8
SHARDS = 4
SCALING_REPEATS = 3
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
    "align_fused_lanes": ("align_kernel",),
    "ip_suite_lanes": ("suite_",),
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

def live_pairs(rows, m_rows, cols, m_cols, ell, p):
    """(rows, cols) bool: the pairs of the tile pairs a skipping gate
    sweep computes (kernels.tile_flags_plain with the kernels' slack; rows
    in the kernels' work items, columns in tiles of KEEP_WORD)."""
    from cvo_slam_tpu_torch.cvo import kernels
    tile = _geometry_rows()
    flags = kernels.tile_flags_plain(rows, m_rows, cols, m_cols, ell, tile,
                                     kernels.KEEP_WORD, p, slack=True)
    n, m = rows.shape[0], cols.shape[0]
    return flags.repeat_interleave(tile, 0)[:n].repeat_interleave(
        kernels.KEEP_WORD, 1)[:, :m]


def moment_counts(x, fx, mx, y, fy, my, ell, p):
    import torch
    from cvo_slam_tpu_torch.ops import pairwise
    d2 = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    d2c = ((fx[:, None, :] - fy[None, :, :]) ** 2).sum(-1)
    # the pairs of the computed tile pairs (rows: the moving points)
    valid = mx[:, None] & my[None, :] & live_pairs(y, my, x, mx, ell, p).T
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
    # the pairs of the computed tile pairs (rows: the fixed points)
    valid = mx[:, None] & my[None, :] & live_pairs(x, mx, y, my, ell, p)
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


def align_counts(args, n_iter, p):
    """(instructions, bytes, the plain run's AlignResult) of n_iter
    iterations of align_fused on its arguments `args`: both passes at
    each iteration of the plain run (its poses and ells), averaged, times
    n_iter (module docstring); bytes: both clouds read once, the initial
    and final state."""
    import numpy as np
    from cvo_slam_tpu_torch.cvo import engine, kernels
    x, fx, mx, y, fy, my = args[:6]
    seen = []

    def iterate(yk, ellk):
        seen.append((yk, float(ellk)))
        return kernels.flow_and_step_plain(x, yk, fx, fy, mx, my, ellk, p)

    ref = engine.align_loop(iterate, y, *args[6:9], p)
    seen = seen[:int(ref.iters) + 1]
    per_iter = [flow_step_counts(x, fx, mx, yk, fy, my, ek, p)[0]
                for yk, ek in seen]
    nbytes = (x.shape[0] + y.shape[0]) * ((3 + 5) * 4 + 1) + 13 * 4 \
        + 13 * 4 + 2 * 4
    return float(np.mean(per_iter)) * n_iter, nbytes, ref


def align_checks(seq, p, report):
    """Phase 2, align_fused against align_fused_plain at CAP 3072 from the
    identity at ell 0.15: on frames 0 -> 1 ell equal, iterations within
    ALIGN_ITERS_SPREAD, the transform within 1e-4, two launches bitwise
    equal, time per alignment and the bound over the plain run's
    iterations (module docstring); on frames 1 -> 2 .. 5 -> 6 iterations
    within ALIGN_PAIRS_ITERS_SPREAD and the transform within
    ALIGN_PAIRS_GAP. seq: the sequence's first ALIGN_PAIRS + 1 clouds."""
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

    n_iter = int(iters) + 1
    ops, nbytes, _ = align_counts(args, n_iter, p)
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


def _stack(clouds):
    """(positions, features, mask) of a list of clouds, each stacked on a
    leading lane axis."""
    import torch
    return tuple(torch.stack([c[i] for c in clouds]) for i in range(3))


def _lanes_equal_solo(name, got, solos):
    """Every lane of a lane launch's outputs bitwise equal to the outputs
    of its one-lane call."""
    import torch
    for l, want in enumerate(solos):
        if not all(torch.equal(g[l], w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: lane {l} differs from its solo "
                                 f"launch")


def _lane_profile(name, fn, solo_fn, lanes, reps=3):
    """(device ms of one lane launch, device ms of its `lanes` solo
    launches): each by torch.profiler, held at one kernel launch per lane
    call and `lanes` per round of solo calls."""
    names = DEVICE_NAMES[name]
    t_d, per_call = device_profile(fn, names, reps=reps)
    t_s, per_solo = device_profile(solo_fn, names, reps=reps)
    if t_d is None or t_s is None:
        raise AssertionError(f"{name}: no profiler window held every launch "
                             f"of {names}")
    if per_call != 1 or per_solo != lanes:
        raise AssertionError(f"{name}: {per_call} launches per lane call, "
                             f"{per_solo} per {lanes} solo calls")
    return t_d, t_s


def lane_checks(seq, p, report):
    """Phase 2, the lanes of align_fused and of the suite (module
    docstring). seq: the sequence's first ALIGN_PAIRS + 1 clouds at CAP
    3072."""
    import torch
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.ops import se3
    dev = seq[0][0].device
    entry = report["align_fused_lanes"]
    # 1. frames k -> k + 1 as ALIGN_PAIRS lanes, distinct fixed clouds
    S = ALIGN_PAIRS
    largs = (*_stack(seq[:S]), *_stack(seq[1:S + 1]),
             torch.eye(3, device=dev).expand(S, 3, 3).contiguous(),
             torch.zeros(S, 3, device=dev),
             torch.full((S,), ELLS[0], device=dev), p)
    info = {}
    got = kernels.align_fused_lanes_cuda(*largs, launch_info=info)
    _lanes_equal_solo("align_fused lanes", got, [
        kernels.align_fused_cuda(*align_args(seq, k, p)) for k in range(S)])
    ops = nbytes = 0
    gaps = []
    for k in range(S):
        it = int(got[3][k])
        o, b_k, ref = align_counts(align_args(seq, k, p), it + 1, p)
        ops, nbytes = ops + o, nbytes + b_k
        dt, ang = transform_gap((got[0][k], got[1][k]), (ref.R, ref.T))
        gaps.append(f"{k}->{k + 1}: {it} vs {int(ref.iters)}")
        if abs(it - int(ref.iters)) > ALIGN_PAIRS_ITERS_SPREAD \
                or max(dt, ang) > ALIGN_PAIRS_GAP:
            raise AssertionError(f"align_fused lane {k}: {it} vs "
                                 f"{int(ref.iters)} iterations, |dt| {dt}, "
                                 f"angle {ang}")
        entry["max_abs_err"] = max(entry["max_abs_err"], dt, ang)
    b, by = bound_ms(ops, nbytes)
    t_k = cuda_time_ms(lambda: kernels.align_fused_lanes_cuda(*largs),
                       reps=3, trials=3)
    t_d, t_s = _lane_profile(
        "align_fused_lanes", lambda: kernels.align_fused_lanes_cuda(*largs),
        lambda: [kernels.align_fused_cuda(*align_args(seq, k, p))
                 for k in range(S)], S)
    t_p = cuda_time_ms(lambda: kernels.align_fused_lanes_plain(*largs),
                       reps=1, trials=1)
    lane_iters = int((got[3] + 1).sum())
    print(f"align_fused lanes, frames 0 -> 1 .. {S - 1} -> {S} as {S} lanes "
          f"(CAP {CAPS[0]}, ell {ELLS[0]}): every lane equal to its solo "
          f"launch bit for bit; against the plain lanes {'; '.join(gaps)} "
          f"iterations, within {ALIGN_PAIRS_ITERS_SPREAD} and "
          f"{ALIGN_PAIRS_GAP} m / rad; {t_k:.4f} ms per call, device "
          f"{t_d:.4f} ms in 1 launch against {t_s:.4f} ms in {S} solo "
          f"launches, {t_d / lane_iters * 1e3:.2f} us per lane-iteration "
          f"({lane_iters}); plain {t_p:.1f} ms; bound {b:.4f} ms ({by}), "
          f"{b / t_d:.1%} on the device; launch {info}", flush=True)
    entry.update(ms=t_k, device_ms=t_d, solo_device_ms=t_s, plain_ms=t_p,
                 bound_ms=b, bound_by=by, lanes=S, launch=info)

    # 2. every lane against the frame-0 cloud (loop-closure candidates
    #    against one reference), the last lane started at its own solution
    x0 = seq[0]
    ell0 = torch.tensor(ELLS[0], device=dev)
    entry["shared_fixed"] = {}
    for S in LANE_COUNTS:
        movs = [seq[1 + l % ALIGN_PAIRS] for l in range(S)]
        R0 = torch.eye(3, device=dev).expand(S, 3, 3).contiguous()
        T0 = torch.zeros(S, 3, device=dev)
        ells = ell0.expand(S).contiguous()
        if S > 1:
            own = kernels.align_fused_cuda(*x0, *movs[-1], R0[-1].contiguous(),
                                           T0[-1].contiguous(), ell0, p)
            R0[-1], T0[-1], ells[-1] = own[0], own[1], own[2]
        largs = (*x0, *_stack(movs), R0, T0, ells, p)
        got = kernels.align_fused_lanes_cuda(*largs)

        def solos():
            return [kernels.align_fused_cuda(*x0, *movs[l],
                                             R0[l].contiguous(),
                                             T0[l].contiguous(), ells[l], p)
                    for l in range(S)]
        _lanes_equal_solo(f"align_fused {S} lanes on one fixed cloud", got,
                          solos())
        t_d, t_s = _lane_profile(
            "align_fused_lanes",
            lambda: kernels.align_fused_lanes_cuda(*largs), solos, S)
        iters = [int(i) for i in got[3]]
        n_iter = max(iters) + 1
        lane_iters = sum(i + 1 for i in iters)
        print(f"align_fused {S} lanes on the frame-0 cloud: iterations "
              f"{iters}, every lane equal to its solo launch bit for bit; "
              f"device {t_d:.4f} ms in 1 launch against {t_s:.4f} ms in {S} "
              f"solo launches; {t_d / n_iter * 1e3:.2f} us per iteration "
              f"({n_iter}), {t_d / lane_iters * 1e3:.2f} us per "
              f"lane-iteration ({lane_iters})", flush=True)
        entry["shared_fixed"][S] = dict(
            iters=iters, device_ms=t_d, solo_device_ms=t_s,
            us_per_iteration=t_d / n_iter * 1e3,
            us_per_lane_iteration=t_d / lane_iters * 1e3)

    # 3. the suite: frames l -> l + 1 as 4 lanes (yt under TWIST, both
    #    ells), and one lane
    entry = report["ip_suite_lanes"]
    tw = se3.exp_se3(torch.tensor(TWIST, device=dev))
    entry["by_lanes"] = {}
    for S in (1, 4):
        yts = [se3.transform_points(tw, seq[l + 1][0]).contiguous()
               for l in range(S)]
        ells = torch.tensor([ELLS[l % 2] for l in range(S)], device=dev)
        sargs = (*_stack(seq[:S]), *_stack(seq[1:S + 1]), torch.stack(yts),
                 ells, p)

        def solos():
            return [kernels.ip_suite_cuda(*seq[l], *seq[l + 1], yts[l],
                                          ells[l], p) for l in range(S)]
        got = kernels.ip_suite_lanes_cuda(*sargs)
        _lanes_equal_solo(f"ip_suite {S} lanes", got, solos())
        want = kernels.ip_suite_lanes_plain(*sargs)
        torch.cuda.synchronize()
        for k in (1, 3, 5, 7, 9):
            if not torch.equal(got[k].float(), want[k].float()):
                raise AssertionError(f"suite lanes count {k}: "
                                     f"{got[k].tolist()} != {want[k].tolist()}")
        err = 0.0
        for k in (0, 2, 4, 6):
            err = max(err, check_close(f"suite lanes sum {k}", got[k],
                                       want[k], 1e-4, 0.0))
        scale = max(float(want[8].abs().max()), 1.0)
        err = max(err, check_close("suite lanes G", got[8] / scale,
                                   want[8] / scale, 0.0, 1e-5) * scale)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        t_k = cuda_time_ms(lambda: kernels.ip_suite_lanes_cuda(*sargs))
        t_d, t_s = _lane_profile(
            "ip_suite_lanes", lambda: kernels.ip_suite_lanes_cuda(*sargs),
            solos, S)
        t_p = cuda_time_ms(lambda: kernels.ip_suite_lanes_plain(*sargs),
                           reps=1)
        counts = [suite_counts(*seq[l], *seq[l + 1], yts[l],
                               float(ells[l]), p) for l in range(S)]
        b, by = bound_ms(sum(c[0] for c in counts),
                         sum(c[1] for c in counts))
        print(f"ip_suite {S} lanes (CAP {CAPS[0]}, ells "
              f"{[float(e) for e in ells]}): every lane equal to its solo "
              f"launch bit for bit, counts equal to the plain lanes', max "
              f"|err| {err:.3e}; {t_k:.4f} ms per call, device {t_d:.4f} ms "
              f"in 1 launch against {t_s:.4f} ms in {S} solo launches; plain "
              f"{t_p:.2f} ms; bound {b:.4f} ms ({by}), {b / t_d:.1%} on the "
              f"device", flush=True)
        entry["by_lanes"][S] = dict(ms=t_k, device_ms=t_d,
                                    solo_device_ms=t_s, plain_ms=t_p,
                                    bound_ms=b)
        entry.update(ms=t_k, device_ms=t_d, solo_device_ms=t_s, plain_ms=t_p,
                     bound_ms=b, bound_by=by, lanes=S)


def _skip_pair(name, run, cap, ell):
    """Runs run(tile_skip) -> (outputs, launch_info) skipping and not;
    fails unless the outputs are bitwise equal and the skipping launch
    computed fewer tile pairs than the unskipped one.
    Returns (tiles computed, tiles of the unskipped launch, both
    launch_info dicts)."""
    import torch
    got, info = run(True)
    want, full_info = run(False)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: the skipping launch differs from the "
                             f"unskipped one (CAP {cap}, ell {ell})")
    tiles = info["tiles"].sum().item()
    full = full_info["tiles"].sum().item()
    if not tiles < full:
        raise AssertionError(f"{name}: no tile pair skipped ({tiles} of "
                             f"{full}; CAP {cap}, ell {ell})")
    return tiles, full, info, full_info


def skip_checks(clouds, seq, p, report):
    """Phase 2, tile skipping (module docstring): every skipping launch
    against its tile_skip=False launch, bitwise, at CAP 3072 / 3000 and
    ell 0.15 / 0.06; the tile pairs computed (the kernels' count) against
    kernels.tile_flags_plain where the kernel sweeps fixed clouds; the skip
    fraction and the device ms with and without skipping at CAP 3072.
    seq: the sequence's first ALIGN_PAIRS + 1 clouds at CAP 3072 (the
    lanes run there only: a stack of lanes needs 16-byte lane strides,
    which CAP 3000's masks do not have)."""
    import torch
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.ops import pairwise
    rows = _geometry_rows()
    fracs = {}

    def record(name, cap, ell, tiles, full, plain=None, pairs=None):
        # one sweep's pairs, unskipped; skipping, tile_flags_plain's count
        if pairs is not None and full != pairs or \
                plain is not None and tiles != plain:
            raise AssertionError(f"{name}: {tiles} tile pairs computed of "
                                 f"{full} (tile_flags_plain {plain}, a sweep"
                                 f" {pairs}; CAP {cap}, ell {ell})")
        fracs[(name, cap, ell)] = 1.0 - tiles / full
        if cap == CAPS[0]:
            report[name].setdefault("skip_fraction", {})[str(ell)] = \
                1.0 - tiles / full

    for cap, (c0, c1) in clouds.items():
        (x, fx, mx), (y, fy, my) = c0, c1
        center, U = pairwise.step_moment_basis(x, mx)
        U = U.contiguous()
        args = (x, y, fx, fy, mx, my)
        for ell in ELLS:
            e = torch.tensor(ell, device=x.device)

            def moment(skip):
                info, bits = {}, torch.empty(
                    (-(-x.shape[0] // kernels.KEEP_WORD), y.shape[0]),
                    dtype=torch.int32, device=x.device)
                out = kernels.moment_pass_cuda(*args, U, e, p, keep_bits=bits,
                                               launch_info=info,
                                               tile_skip=skip)
                return out + (bits,), info
            t, f, info, _ = _skip_pair("moment_flow_step", moment, cap, ell)
            record("moment_flow_step", cap, ell, t, f, int(
                kernels.tile_flags_plain(y, my, x, mx, e, rows,
                                         kernels.KEEP_WORD, p,
                                         slack=True).sum()),
                   info["tile_pairs"])
            plain = int(kernels.tile_flags_plain(
                x, mx, y, my, e, rows, kernels.KEEP_WORD, p,
                slack=True).sum())

            def both(skip):
                info, bits = {}, torch.empty(
                    (-(-y.shape[0] // kernels.KEEP_WORD), x.shape[0]),
                    dtype=torch.int32, device=x.device)
                out = kernels.flow_and_step_cuda(*args, e, p, keep_bits=bits,
                                                 launch_info=info,
                                                 tile_skip=skip)
                return out + (bits,), info
            t, f, info, _ = _skip_pair("flow_and_step", both, cap, ell)
            record("flow_and_step", cap, ell, t, f, plain,
                   info["tile_pairs"])

            def flow(skip):
                info = {}
                return kernels.flow_cuda(*args, e, p, launch_info=info,
                                         tile_skip=skip), info
            t, f, info, _ = _skip_pair("flow", flow, cap, ell)
            record("flow", cap, ell, t, f, plain, info["tile_pairs"])
            omega, v, _ = kernels.flow_plain(*args, e, p)

            def step(skip):
                info = {}
                return kernels.step_coeffs_cuda(*args, omega, v, e, p,
                                                launch_info=info,
                                                tile_skip=skip), info
            t, f, info, _ = _skip_pair("step_coeffs", step, cap, ell)
            record("step_coeffs", cap, ell, t, f, plain, info["tile_pairs"])

            # align_fused on frames 0 -> 1 from the identity at this ell
            def align(skip):
                info = {}
                out = kernels.align_fused_cuda(
                    x, fx, mx, y, fy, my, torch.eye(3, device=x.device),
                    torch.zeros(3, device=x.device), e, p, launch_info=info,
                    tile_skip=skip)
                return out, info
            t, f, info, _ = _skip_pair("align_fused", align, cap, ell)
            iters = int(kernels.align_fused_cuda(
                x, fx, mx, y, fy, my, torch.eye(3, device=x.device),
                torch.zeros(3, device=x.device), e, p)[3])
            if f != min(iters + 1, p.max_iter) * info["tile_pairs"]:
                raise AssertionError(f"align_fused: {f} tile pairs unskipped"
                                     f" over {iters} iterations")
            record("align_fused", cap, ell, t, f)
    # the lanes: frames k -> k + 1 (distinct fixed clouds) and frames 1 ..
    # against frame 0 (one fixed cloud), ALIGN_PAIRS lanes each, at both
    # start ells
    S = ALIGN_PAIRS
    cap, dev = CAPS[0], seq[0][0].device
    for ell in ELLS:
        init = (torch.eye(3, device=dev).expand(S, 3, 3).contiguous(),
                torch.zeros(S, 3, device=dev),
                torch.full((S,), ell, device=dev), p)
        for fixed, what in ((_stack(seq[:S]), "distinct"),
                            (seq[0], "shared")):
            largs = (*fixed, *_stack(seq[1:S + 1]), *init)

            def lanes(skip):
                info = {}
                return kernels.align_fused_lanes_cuda(
                    *largs, launch_info=info, tile_skip=skip), info
            name = f"align_fused_lanes ({what} fixed clouds)"
            t, f, info, full_info = _skip_pair(name, lanes, cap, ell)
            per_lane = [int(a) for a in info["tiles"]]
            full_lane = [int(a) for a in full_info["tiles"]]
            if not all(a < b for a, b in zip(per_lane, full_lane)):
                raise AssertionError(f"{name}: a lane skipped nothing: "
                                     f"{per_lane} of {full_lane} (CAP "
                                     f"{cap}, ell {ell})")
            print(f"align_fused {S} lanes on {what} fixed clouds, CAP "
                  f"{cap}, ell {ell}: skipping launch bitwise equal to "
                  f"the unskipped one; tile pairs computed per lane "
                  f"{per_lane} of {full_lane}", flush=True)
            if what == "distinct":
                record("align_fused_lanes", cap, ell, t, f)
    print("tile skipping, skipping launches bitwise equal to the unskipped "
          "ones, skip fraction (of the gate sweep's tile pairs): "
          + "; ".join(f"{n} CAP {c} ell {e} {v:.1%}"
                      for (n, c, e), v in fracs.items()), flush=True)

    # device ms with and without skipping, CAP 3072, in turns
    (x, fx, mx), (y, fy, my) = clouds[CAPS[0]]
    center, U = pairwise.step_moment_basis(x, mx)
    U = U.contiguous()
    args = (x, y, fx, fy, mx, my)
    calls = {}
    for ell in ELLS:
        e = torch.tensor(ell, device=x.device)
        omega, v, _ = kernels.flow_plain(*args, e, p)
        calls[("moment_flow_step", ell)] = lambda s, e=e: \
            kernels.moment_pass_cuda(*args, U, e, p, tile_skip=s)
        calls[("flow_and_step", ell)] = lambda s, e=e: \
            kernels.flow_and_step_cuda(*args, e, p, tile_skip=s)
        calls[("flow", ell)] = lambda s, e=e: kernels.flow_cuda(
            *args, e, p, tile_skip=s)
        calls[("step_coeffs", ell)] = lambda s, e=e, o=omega, w=v: \
            kernels.step_coeffs_cuda(*args, o, w, e, p, tile_skip=s)
    e0 = torch.tensor(ELLS[0], device=x.device)
    calls[("align_fused", ELLS[0])] = lambda s: kernels.align_fused_cuda(
        x, fx, mx, y, fy, my, torch.eye(3, device=x.device),
        torch.zeros(3, device=x.device), e0, p, tile_skip=s)
    largs = (*_stack(seq[:S]), *_stack(seq[1:S + 1]),
             torch.eye(3, device=x.device).expand(S, 3, 3).contiguous(),
             torch.zeros(S, 3, device=x.device),
             torch.full((S,), ELLS[0], device=x.device), p)
    calls[("align_fused_lanes", ELLS[0])] = lambda s: \
        kernels.align_fused_lanes_cuda(*largs, tile_skip=s)
    for (name, ell), fn in calls.items():
        reps = 5 if name.startswith("align") else 20
        times = [_device_ms(lambda: fn(s), name, reps)
                 for s in (True, False, False, True)]
        on, off = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        print(f"{name} CAP {CAPS[0]} ell {ell}: device {on:.4f} ms with tile "
              f"skipping, {off:.4f} ms without ({on / off:.2f}x; skip "
              f"fraction {fracs[(name, CAPS[0], ell)]:.1%})", flush=True)
        report[name].setdefault("device_ms_unskipped", {})[str(ell)] = off
        report[name].setdefault("device_ms_skipping", {})[str(ell)] = on


def _device_ms(fn, name, reps, tries=3):
    """Device ms per call of fn's kernels (DEVICE_NAMES[name]) from one
    torch.profiler window of reps + 1 calls, the last reps calls' kernels
    in start order. After phase 2's other windows the profiler was seen to
    drop the first kernel of every window (the moment kernel's keep pass,
    19 of 20), so the first call is not counted and a window that lost no
    more than its kernels is kept; up to `tries` windows, else fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    # one launch per kernel name per call (phase 2's launch bars)
    k, seen = len(DEVICE_NAMES[name]), []
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps + 1):
                fn()
            torch.cuda.synchronize()
        ours = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and any(n in e.name for n in DEVICE_NAMES[name])),
                      key=lambda e: e.time_range.start)
        seen.append(len(ours))
        if reps * k <= len(ours) <= (reps + 1) * k:
            return sum(e.time_range.elapsed_us()
                       for e in ours[-reps * k:]) / reps / 1e3
    raise AssertionError(f"{name}: no profiler window held the last {reps} "
                         f"calls' {reps * k} kernels (windows held {seen})")


def _geometry_rows():
    """Rows of a work item as the per-pair kernels' library reports them."""
    import torch
    from cvo_slam_tpu_torch.cvo import kernels
    return kernels._geometry(kernels.FLOW_AND_STEP, "flow_step_geometry",
                             torch.device("cuda"))[2]


@contextlib.contextmanager
def unskipped():
    """The block's kernel launches with tile_skip=False: every skipping
    wrapper that the main path reaches computes every tile pair (the same
    outputs bit for bit)."""
    import functools
    from cvo_slam_tpu_torch.cvo import kernels
    saved = {n: getattr(kernels, n) for n in (
        "moment_pass_cuda", "flow_and_step_cuda", "align_fused_cuda",
        "align_fused_lanes_cuda")}
    for n, fn in saved.items():
        setattr(kernels, n, functools.partial(fn, tile_skip=False))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)


def place_recognition(root, card):
    """Phase 4l: eval.place_recognition on the card (43 keyframes of three
    aliased places, one detect() under the default backend): at least one
    accepted edge to place 0, none to the decoys, the vocabulary retrained
    at least 4 times with stale BoW vectors refreshed (the JAX package's
    tests/test_place_recognition.py bars)."""
    from cvo_slam_tpu_torch.eval import place_recognition as pr
    out = pr.run(root, "cuda")
    print(f"place recognition on {card}: {out['keyframes']} keyframes, "
          f"vocabulary version {out['voc_version']} (stale BoW before "
          f"detect: {out['stale']}); accepted {out['accepted']}, true "
          f"{out['true']}, false {out['false']}; detect() returned "
          f"{out['new_lc']}, farthest {out['farthest']}", flush=True)
    if len(out["true"]) < 1 or out["false"] or out["voc_version"] < 4 \
            or not out["stale"] or out["new_lc"] != len(out["accepted"]) \
            or out["farthest"] != min(out["true"]):
        raise AssertionError(f"place recognition: {out}")


@contextlib.contextmanager
def plain_calls():
    """Counts, in the block, the calls of every plain version of a kernel
    (kernels.*_plain): the wrappers look them up by name, so a wrapper that
    took one is counted."""
    from cvo_slam_tpu_torch.cvo import kernels
    names = [n for n in dir(kernels) if n.endswith("_plain")]
    saved = {n: getattr(kernels, n) for n in names}
    counts = dict.fromkeys(names, 0)

    def counting(name):
        def call(*args, **kw):
            counts[name] += 1
            return saved[name](*args, **kw)
        return call

    for n in names:
        setattr(kernels, n, counting(n))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)


def _no_kernel(name, launches, plain, allowed=()):
    """Fails unless no kernel but `allowed` launched and no plain version
    of a kernel ran."""
    ran = {k: n for k, n in launches.items() if n and k not in allowed}
    took = {k: n for k, n in plain.items() if n}
    if ran or took:
        raise AssertionError(f"{name}: kernels {ran} launched, plain "
                             f"versions {took} ran")


def _wall_ms(fn):
    """Host ms of one call of fn, ended by a device synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _device_once(fn):
    """(device ms, device operations) of one call of fn in one
    torch.profiler window: every CUDA activity (kernels, copies, sets);
    None for the time if the window holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in ev) / 1e3 if ev
            else None), len(ev)


def pass_parity(seq, p):
    """The xla pass on the card against the same function on the CPU
    (plain torch there too, with MKL's product and the CPU's
    exponential) on frames 0 -> 1 at both ells: keep bit for bit, Mom
    within 1e-5 of each column's max, omega, v, B, C rtol 2e-4 / atol
    1e-5 (phase 2's bars for the moment kernel); D and E printed."""
    import torch
    from cvo_slam_tpu_torch.ops import pairwise
    for ell in ELLS:
        got, want = [], []
        for dev, out in (("cuda", got), ("cpu", want)):
            (x, fx, mx), (y, fy, my) = [[t.to(dev) for t in c]
                                        for c in seq[:2]]
            e = torch.tensor(ell, device=dev)
            ckg = pairwise.color_kernel_gated(fx, fy, mx, my, p)
            center, U = pairwise.step_moment_basis(x, mx)
            A, keep = pairwise.cvo_kernel_from_color(x, y, ckg, e, p)
            out += [keep, pairwise.moment_product(A, U)]
            out += pairwise.flow_and_step_moments_lanes(x, y, ckg, U, center,
                                                        e, p)
        if not torch.equal(got[0].cpu(), want[0]):
            raise AssertionError(f"xla pass ell {ell}: keep differs from "
                                 f"the CPU's in {int((got[0].cpu() != want[0]).sum())} pairs")
        scale = want[1].abs().amax(dim=0).clamp(min=1e-30)
        check_close(f"xla Mom ell {ell}", got[1] / scale.to(got[1].device),
                    want[1] / scale, 0.0, 1e-5)
        names = ("omega", "v", "nnz", "B", "C", "D", "E")
        for name, g, w in zip(names, got[2:], want[2:]):
            if name == "nnz":
                if int(g) != int(w):
                    raise AssertionError(f"xla nnz {int(g)} vs {int(w)}")
            elif name in ("D", "E"):
                continue
            else:
                check_close(f"xla {name} ell {ell}", g, w, 2e-4, 1e-5)
        print(f"xla pass CAP {CAPS[0]} ell {ell}, card against CPU: keep "
              f"equal ({int(got[4])} pairs), Mom, omega, v, B, C within "
              f"bars; D {float(got[7]):.6e} vs {float(want[7]):.6e}, E "
              f"{float(got[8]):.6e} vs {float(want[8]):.6e}", flush=True)


def xla_checks(seq, p, card):
    """Phase 2x (module docstring). seq: the sequence's first
    ALIGN_PAIRS + 1 clouds at CAP 3072."""
    import torch
    from cvo_slam_tpu_torch.cvo import engine, kernels
    from cvo_slam_tpu_torch.ops import pairwise
    dev = seq[0][0].device
    clouds = [engine.PointCloud(*c) for c in seq]
    S = ALIGN_PAIRS
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    ell0 = torch.tensor(ELLS[0], device=dev)
    init = ([eye] * S, [zero] * S, [ell0] * S)

    def solos(fixed):
        return [engine.align(fixed[k] if isinstance(fixed, list) else fixed,
                             clouds[k + 1], eye, zero, ell0, p, "xla")
                for k in range(S)]

    def lanes(fixed):
        return engine.align_lanes(fixed, clouds[1:S + 1], *init, p, "xla")

    # one pass first, so the timed calls below find cuBLAS and the
    # allocator warm
    (x, fx, mx), (y, fy, my) = seq[0], seq[1]
    center, U = pairwise.step_moment_basis(x, mx)
    pairwise.flow_and_step_moments_lanes(
        x, y, pairwise.color_kernel_gated(fx, fy, mx, my, p), U, center,
        ell0, p)
    kernels.reset_launch_counts()
    with plain_calls() as plain:
        solo, got = [], []
        w_s = _wall_ms(lambda: solo.extend(solos(clouds[:S])))
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        w_l = _wall_ms(lambda: got.append(lanes(clouds[:S])))
        peak = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
        shared_solo, shared = solos(clouds[0]), lanes(clouds[0])
        torch.cuda.synchronize()
    got = got[0]
    _no_kernel("xla aligns", {k.name: k.launches for k in kernels.KERNELS},
               plain)
    _lanes_equal_solo(f"xla {S} lanes", got, solo)
    _lanes_equal_solo(f"xla {S} lanes on the frame-0 cloud", shared,
                      shared_solo)
    rows, err = [], 0.0
    for k, res in enumerate(solo):
        mom = engine.align(clouds[k], clouds[k + 1], eye, zero, ell0, p,
                           "pallas_mom")
        finite = all(bool(torch.isfinite(t).all()) for t in res)
        dt, ang = transform_gap((res.R, res.T), (mom.R, mom.T))
        rows.append((k, int(res.iters), int(mom.iters), dt, ang, finite))
        err = max(err, dt, ang)
    print(f"xla align CAP {CAPS[0]} from the identity at ell {ELLS[0]} "
          f"against the pallas_mom align (iterations, |dt| m, angle rad; "
          f"bar {XLA_PAIRS_GAP} m / rad): "
          + "; ".join(f"{k}->{k + 1}: {it} vs {it_m}, {dt:.2e}, {ang:.2e}"
                      for k, it, it_m, dt, ang, _ in rows)
          + f"; no kernel launched and no plain version ran; as {S} lanes "
          f"of one program every lane equal to its solo align bit for bit, "
          f"on distinct fixed clouds and on the frame-0 cloud (iterations "
          f"{[int(i) for i in shared.iters]}); on {card}: the {S} lanes "
          f"{w_l:.1f} ms (peak {peak:.0f} MiB) against {w_s:.1f} ms for the "
          f"{S} solo aligns ({sum(r[1] + 1 for r in rows)} lane-iterations)",
          flush=True)
    if not all(r[5] for r in rows) or err > XLA_PAIRS_GAP:
        raise AssertionError(f"xla align: not finite, or further than "
                             f"{XLA_PAIRS_GAP} from the pallas_mom align")
    pass_parity(seq, p)


@contextlib.contextmanager
def env(**values):
    """The environment variables `values` set for the block (None unsets
    one), restored after."""
    old = {k: os.environ.get(k) for k in values}

    def put(items):
        for k, v in items:
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    put(values.items())
    try:
        yield
    finally:
        put(old.items())


@contextlib.contextmanager
def phase(name):
    """Prints the wall time of the block."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


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


def tracking(folder, gt, report, card, backend, n_frames=N_FRAMES,
             speculate="0"):
    """Phases 3, 3b, 3c, 3d: tracking-only SLAM on `backend` over the first
    n_frames frames with CVO_SLAM_SPECULATE=`speculate`, counters set to 0
    just before, read just after. Returns the tracked frames' ms/frame
    (t_frame), the lines of Tracking_trajectory.txt and run()'s stats."""
    import numpy as np
    from cvo_slam_tpu_torch.app import run_slam
    from cvo_slam_tpu_torch.config import SlamConfig
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.data import tum
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True)
    with env(CVO_SLAM_BACKEND=backend, CVO_SLAM_SPECULATE=speculate):
        kernels.reset_launch_counts()
        stats = run_slam.run(folder, "associate.txt", "TUM1", cfg,
                             max_frames=n_frames, device="cuda")
        launches = {k.name: k.launches for k in kernels.KERNELS}

    path = os.path.join(folder, "Tracking_trajectory.txt")
    with open(path) as f:
        lines = f.read().splitlines()
    ts, poses = tum.read_trajectory(path)
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
    # alignments: one bootstrap (odometry only) + two per tracked frame,
    # and two per speculative frame_step that was thrown away
    n_align = 1 + 2 * len(tracked) + 2 * stats["speculation"]["discards"]
    print(f"tracking ({stats['backend']}) {n_frames} frames 640x480 CAP "
          f"3072 on {card}: {np.mean(t_frame):.1f} ms/frame mean, "
          f"{np.median(t_frame):.1f} median over {len(tracked)} tracked "
          f"frames; wall {stats['wall_s']:.2f} s ({stats['fps']:.2f} fps "
          f"incl. bootstrap and IO); {np.mean(iters):.1f} align iterations "
          f"per alignment (tracked frames: odometry {odo}, keyframe {kf}); "
          f"launches {launches}; alignments {n_align}; max position error "
          f"{err.max():.4f} m, ATE {ate:.4f} m", flush=True)
    # the align kernel of the backend: at least once per iteration, or
    # (align_fused) exactly once per alignment; the others never (xla has
    # none)
    aligns = {"pallas_mom": "moment_flow_step",
              "pallas_iter": "flow_and_step", "pallas": "align_fused"}
    align = aligns.get(backend)
    ok = launches["ip_suite"] == n_align and stats["backend"] == backend \
        and all(launches[k] == 0 for k in aligns.values() if k != align)
    if backend == "pallas":
        ok &= launches[align] == n_align
    elif align is not None:
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
    return dict(t_frame=t_frame, lines=lines, stats=stats)


def lockstep_sequences(folder, cam):
    """Phase 3e's sequences: the phase-3 sequence in `folder`, then
    LOCKSTEP_SEQS - 1 more (seeds 8, 9, ..., LOCKSTEP_STEPS) in
    subfolders; their frames loaded once, N_FRAMES each."""
    import numpy as np
    from cvo_slam_tpu_torch.data import synthetic, tum
    folders = [folder]
    for k in range(1, LOCKSTEP_SEQS):
        sub = os.path.join(folder, f"lockstep{k}")
        synthetic.make_sequence(sub, cam, n_frames=N_FRAMES, seed=7 + k,
                                step_twist=np.array(LOCKSTEP_STEPS[k]))
        folders.append(sub)
    return [[tum.load_image(f, r) for r in tum.load_association(
        os.path.join(f, "associate.txt"))[:N_FRAMES]] for f in folders]


def _solo_runs(frames, cam, cfg, force_last=False):
    """Each sequence tracked alone (speculation off): per sequence its
    poses, its update ms per frame and its tracker."""
    import torch
    from cvo_slam_tpu_torch.app.run_slam import build_tracker
    out = []
    with env(CVO_SLAM_SPECULATE="0"):
        for seq in frames:
            t = build_tracker(cam, cfg, device="cuda")
            t.init()
            poses, ms = [], []
            for k, img in enumerate(seq):
                if force_last and k == len(seq) - 1:
                    t.force_keyframe()
                t0 = time.perf_counter()
                poses.append(t.update(img))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            out.append((poses, ms, t))
    return out


def _lockstep_run(frames, cam, cfg, backend, force_last=False):
    """The sequences in lockstep (parallel.multi_sequence) on `backend`,
    counters set to 0 just before and read just after: per sequence its
    poses, ms per round, the launches, the rounds and the tracker."""
    import torch
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.parallel.multi_sequence import \
        MultiSequenceTracker
    mst = MultiSequenceTracker(cam, cfg, len(frames),
                               backend=backend, device="cuda")
    poses = [[] for _ in frames]
    ms = []
    kernels.reset_launch_counts()
    for k in range(len(frames[0])):
        if force_last and k == len(frames[0]) - 1:
            mst.force_keyframe()
        t0 = time.perf_counter()
        for s, pose in enumerate(mst.update([f[k] for f in frames])):
            poses[s].append(pose)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    return poses, ms, launches, dict(mst.rounds), mst


def lockstep(frames, cam, report, card):
    """Phase 3e: MultiSequenceTracker on the sequences `frames` (module
    docstring): under pallas each sequence's poses bitwise equal to its
    solo run, align_fused and the suite launched once per round of each
    request kind (as lanes), never alone; under pallas_mom (2 sequences,
    LOCKSTEP_SHORT frames) equal to solo; the whole pipeline (OnlyTracking
    False, Max_KF_interval=3; 2 sequences, LOCKSTEP_SHORT frames, a forced
    last keyframe) with the same keyframe counts and poses as solo."""
    import numpy as np
    from cvo_slam_tpu_torch.config import SlamConfig
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True)

    def equal(name, got, solo):
        for s, (g, (w, _, _)) in enumerate(zip(got, solo)):
            for k, (a, b) in enumerate(zip(g, w)):
                if not np.array_equal(a, b):
                    raise AssertionError(f"lockstep {name}: sequence {s} "
                                         f"frame {k} differs from its solo "
                                         f"run")

    def check_launches(name, launches, rounds, lanes_kernel):
        """The suites as lanes, once per round of each kind; the aligns as
        align_fused lanes, or (lanes_kernel False: xla) no align kernel."""
        want = {"ip_suite_lanes": 2 * rounds["frame"] + rounds["align_ip"]
                + rounds["ip"], "ip_suite": 0, "align_fused": 0,
                "moment_flow_step": 0, "align_fused_lanes": 0}
        if lanes_kernel:
            want["align_fused_lanes"] = 2 * rounds["frame"] \
                + rounds["align_ip"] + rounds["align"]
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"lockstep {name}: launches {launches}, "
                                 f"rounds {rounds}, want {want}")

    with env(CVO_SLAM_BACKEND="pallas"):
        solo = _solo_runs(frames, cam, cfg)
    got, ms, launches, rounds, _ = _lockstep_run(frames, cam, cfg,
                                                 "pallas")
    equal("pallas", got, solo)
    check_launches("pallas", launches, rounds, True)
    for name, n in launches.items():
        if n and not report[name]["launches"]:
            report[name]["launches"] = n
    S = len(frames)
    solo_ms = [m for _, t, _ in solo for m in t[2:]]
    round_ms = ms[2:]
    print(f"lockstep (pallas) {S} sequences x {N_FRAMES} frames 640x480 CAP "
          f"{CAPS[0]} on {card}: poses equal to the solo runs bit for bit; "
          f"rounds {rounds}, launches {launches}; {np.mean(round_ms):.1f} / "
          f"{np.median(round_ms):.1f} ms per frame round (mean / median), "
          f"{np.mean(round_ms) / S:.1f} ms per sequence-frame against "
          f"{np.mean(solo_ms):.1f} / {np.median(solo_ms):.1f} ms per frame "
          f"solo", flush=True)
    report["align_fused_lanes"]["lockstep"] = dict(
        sequences=S, frames=N_FRAMES, ms_per_round=float(np.mean(round_ms)),
        ms_per_sequence_frame=float(np.mean(round_ms)) / S,
        solo_ms_per_frame=float(np.mean(solo_ms)), rounds=rounds)

    # pallas_mom: a batch routes it to xla (the JAX package's routing), so
    # the lockstep run equals the solo xla runs; the solo pallas_mom runs
    # time the route of PR 8 (each lane its own moment-kernel align)
    short = [f[:LOCKSTEP_SHORT] for f in frames[:2]]
    with env(CVO_SLAM_BACKEND="pallas_mom"):
        solo_mom = _solo_runs(short, cam, cfg)
    with env(CVO_SLAM_BACKEND="xla"):
        solo = _solo_runs(short, cam, cfg)
    with plain_calls() as plain:
        got, ms, launches, rounds, _ = _lockstep_run(short, cam, cfg,
                                                     "pallas_mom")
    equal("pallas_mom (xla lanes)", got, solo)
    check_launches("pallas_mom", launches, rounds, False)
    _no_kernel("lockstep pallas_mom", launches, plain, ("ip_suite_lanes",))
    S = len(short)
    xla_ms = [m for _, t, _ in solo for m in t[2:]]
    mom_ms = [m for _, t, _ in solo_mom for m in t[2:]]
    print(f"lockstep (pallas_mom, routed to xla lanes) {S} sequences x "
          f"{LOCKSTEP_SHORT} frames: poses equal to the solo xla runs bit "
          f"for bit; rounds {rounds}, launches {launches}; "
          f"{np.mean(ms[2:]):.1f} ms per frame round, "
          f"{np.mean(ms[2:]) / S:.1f} ms per sequence-frame against "
          f"{np.mean(xla_ms):.1f} ms per frame solo xla and "
          f"{np.mean(mom_ms):.1f} solo pallas_mom (the lane-by-lane route)",
          flush=True)
    report["ip_suite_lanes"]["lockstep_pallas_mom"] = dict(
        sequences=S, frames=LOCKSTEP_SHORT,
        ms_per_round=float(np.mean(ms[2:])),
        ms_per_sequence_frame=float(np.mean(ms[2:])) / S,
        solo_xla_ms_per_frame=float(np.mean(xla_ms)),
        solo_pallas_mom_ms_per_frame=float(np.mean(mom_ms)))

    cfg = SlamConfig.default_shipped().replace(Max_KF_interval=3)
    with env(CVO_SLAM_BACKEND="pallas"):
        solo = _solo_runs(short, cam, cfg, force_last=True)
        got, ms, launches, rounds, mst = _lockstep_run(short, cam, cfg,
                                                       "pallas",
                                                       force_last=True)
    equal("whole pipeline", got, solo)
    kfs = [len(t.graph.keyframes()) for t in mst.trackers]
    want_kfs = [len(t.graph.keyframes()) for _, _, t in solo]
    if kfs != want_kfs:
        raise AssertionError(f"lockstep whole pipeline: keyframes {kfs}, "
                             f"solo {want_kfs}")
    print(f"lockstep whole pipeline (pallas, Max_KF_interval 3) 2 sequences "
          f"x {LOCKSTEP_SHORT} frames: keyframes {kfs} as solo, poses equal "
          f"to the solo runs bit for bit; rounds {rounds}, launches "
          f"{launches}", flush=True)


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
         backend="pallas_mom", use_async=False, check_matcher=False,
         mesh=None):
    """Phases 4, 4b and 4d: the whole SLAM system on an out-and-back
    sequence on `backend` (with UseMultiThreading: the async backend),
    without speculation, counters set to 0 just before run() and read just
    after. With check_matcher, every device descriptor matching is held
    against the host match_bow on the same keyframes, byte for byte.
    With `mesh` the windowed and final BA run on the sharded solvers.
    Returns run()'s stats (with the launches and the windowed BAs' sizes)
    and the keyframes as (id, timestamp, pose)."""
    import numpy as np
    from cvo_slam_tpu_torch.app import run_slam
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.data import synthetic, tum
    from cvo_slam_tpu_torch.features import matcher
    cam = cam or CAMERA_PRESETS["TUM1"]
    cfg = (cfg or SlamConfig.default_shipped()).replace(
        UseMultiThreading=use_async)
    Gs = loop_trajectory(SLAM_OUT)
    gt = np.array([np.linalg.inv(G) for G in Gs])
    if not os.path.exists(os.path.join(folder, "associate.txt")):
        synthetic.make_sequence(folder, cam, trajectory=Gs)
    gt_ts = [f"{1000.0 + 0.05 * k:.6f}" for k in range(len(Gs))]
    from cvo_slam_tpu_torch.cvo import engine
    trackers, checked = [], dict(calls=0, differ=0)
    build, fetch = run_slam.build_tracker, matcher.fetch_match_bow
    verify, verified = engine.lc_verify_batch, []

    def build_and_keep(*args, **kw):
        trackers.append(build(*args, **kw))
        return trackers[-1]

    def verify_and_record(*args):
        verified.append(args[-1])
        return verify(*args)

    def fetch_and_check(fut, ref, cur, nn_ratio, check_orientation=True):
        got = fetch(fut, ref, cur, nn_ratio, check_orientation)
        want = matcher.match_bow(ref, cur, nn_ratio, check_orientation)
        checked["calls"] += 1
        checked["differ"] += not (got.dtype == want.dtype
                                  and got.shape == want.shape
                                  and got.tobytes() == want.tobytes())
        return got

    run_slam.build_tracker = build_and_keep
    engine.lc_verify_batch = verify_and_record
    if check_matcher:
        matcher.fetch_match_bow = fetch_and_check
    try:
        with env(CVO_SLAM_BACKEND=backend, CVO_SLAM_SPECULATE="0"):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            stats = run_slam.run(folder, "associate.txt", cam, cfg,
                                 device=device, mesh=mesh)
            # the whole call: the frame loop (wall_s), then the writers,
            # which wait for an async backend's backlog
            stats["run_s"] = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels.KERNELS}
    finally:
        run_slam.build_tracker, matcher.fetch_match_bow = build, fetch
        engine.lc_verify_batch = verify
    graph = trackers[0].graph
    stats["launches"] = launches
    stats["wba_sizes"] = list(getattr(graph, "wba_sizes", []))
    keyframes = [(kf.id, kf.timestamp, kf.pose.copy())
                 for kf in graph.keyframes()]
    rounds = [(round(r["ransac"], 1), round(r["verify"], 1),
               round(r["overlap"], 1), r["n_cands"], r["n_match_device"])
              for r in graph.lc_stage_ms]

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
    mode = ("async backend" if use_async else "synchronous backend") + (
        f", {mesh.size}-shard mesh" if mesh is not None else "")
    print(f"SLAM ({stats['backend']}, {mode}) {stats['frames']} frames "
          f"{cam.width}x{cam.height} CAP {cfg.frontend.cloud_capacity} on "
          f"{card}: {stats['keyframes']} keyframes, "
          f"{stats.get('lc_rounds', 0)} loop-closure rounds, "
          f"{stats.get('lc_candidates', 0)} candidates verified, "
          f"{stats['lc_num']} loop-closure edges accepted; launches "
          f"{launches}; ms per keyframe event by stage {stages}; "
          f"loop-closure sub-stages "
          f"{ {k: round(v['mean'], 1) for k, v in stats.get('lc_stage_ms', {}).items()} }; "
          f"per round (ransac ms, verify ms, overlap ms, candidates, device "
          f"matchings) {rounds}; verification aligns "
          f"{ {b: verified.count(b) for b in set(verified)} }; descriptor "
          f"matchings {stats.get('lc_matches')}"
          f"{'; device pairs held against the host match_bow: ' + str(checked) if check_matcher else ''}; "
          f"wall {stats['wall_s']:.1f} s (frame loop), {stats['run_s']:.1f} s "
          f"(run() in all); tracking ATE {ate_track:.4f} m, "
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
    # the verification align as the JAX package routes it (_vmap_backend)
    want = {"pallas_mom": "xla", "pallas_iter": "pallas"}.get(backend,
                                                               backend)
    if len(verified) != stats.get("lc_candidates", 0) \
            or set(verified) - {want}:
        raise AssertionError(f"{backend}: loop-closure verification aligned "
                             f"under {verified}, want {want} for each of "
                             f"{stats.get('lc_candidates', 0)} candidates")
    if not report["pair_stats"]["launches"]:
        report["pair_stats"]["launches"] = launches["pair_stats"]
    if stats["lc_num"] < 1:
        raise AssertionError("no loop-closure edge was accepted")
    if stats["lc_matches"]["device"] < 1:
        raise AssertionError(f"the device matcher never ran at ORB "
                             f"{cam.orb_n_features}: {stats['lc_matches']}")
    if check_matcher and (checked["differ"]
                          or checked["calls"] != stats["lc_matches"]["device"]):
        raise AssertionError(f"device matcher against match_bow: {checked}")
    if any(len(r) != 62 for r in rows):
        raise AssertionError(f"loop_closure.txt rows of "
                             f"{sorted({len(r) for r in rows})} fields")
    if not ate_slam < 0.05:
        raise AssertionError(f"SLAM ATE {ate_slam} m >= 0.05 m")
    return stats, keyframes


def async_backend(folder, report, card, sync):
    """Phase 4d: the SLAM walk under pallas with UseMultiThreading against
    phase 4b's synchronous run `sync` (stats, keyframes): the same keyframe
    ids, timestamps and count, poses within 1e-6 m, an accepted edge."""
    import numpy as np
    stats, kfs = slam(folder, report, card, backend="pallas",
                      use_async=True)
    want = sync[1]
    gap = max((float(np.abs(a[2][:3, 3] - b[2][:3, 3]).max())
               for a, b in zip(kfs, want)), default=0.0)
    print(f"async backend: {len(kfs)} keyframes (synchronous {len(want)}), "
          f"max keyframe position gap {gap:.3e} m; frame loop "
          f"{stats['wall_s']:.1f} s against {sync[0]['wall_s']:.1f} s "
          f"synchronous, run() in all {stats['run_s']:.1f} s against "
          f"{sync[0]['run_s']:.1f} s", flush=True)
    if [k[:2] for k in kfs] != [k[:2] for k in want] or not gap <= 1e-6:
        raise AssertionError("the async backend's keyframes differ from the "
                             "synchronous run's")


def odometry(folder, gt, card):
    """Phase 4c: app.run_odometry on the tracking sequence under pallas,
    counters set to 0 just before, read just after."""
    import numpy as np
    from cvo_slam_tpu_torch.app import run_odometry
    from cvo_slam_tpu_torch.config import SlamConfig
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.data import tum
    with env(CVO_SLAM_BACKEND="pallas"):
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


def adaptive_odometry(folder, gt, card):
    """Phase 4e: app.run_odometry --adaptive on the tracking sequence,
    counters set to 0 just before, read just after: 15 finite poses, no
    kernel launched and no plain version of one run (each iteration one
    xla pass, as the JAX package's adaptive variant)."""
    import numpy as np
    from cvo_slam_tpu_torch.app import run_odometry
    from cvo_slam_tpu_torch.config import SlamConfig
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.data import tum
    kernels.reset_launch_counts()
    with plain_calls() as plain:
        stats = run_odometry.run(folder, "associate.txt", "TUM1",
                                 SlamConfig.default_shipped(), adaptive=True,
                                 device="cuda")
    launches = {k.name: k.launches for k in kernels.KERNELS}
    ts, poses = tum.read_trajectory(stats["trajectory"])
    ate = tum.ate_rmse([f"{1000.0 + 0.05 * k:.6f}" for k in range(N_FRAMES)],
                       gt[:N_FRAMES], ts, poses)
    print(f"run_odometry --adaptive {N_FRAMES} frames on {card}: "
          f"{stats['mean_frame_ms']:.1f} ms/frame mean (frontend included), "
          f"{len(ts)} poses, launches {launches}, ATE {ate:.4f} m",
          flush=True)
    if len(ts) != N_FRAMES - 1 or not np.isfinite(poses).all():
        raise AssertionError(f"run_odometry --adaptive wrote {len(ts)} "
                             f"poses, finite: {np.isfinite(poses).all()}")
    _no_kernel("run_odometry --adaptive", launches, plain)


def resume(folder, card, n_frames=8, at=4):
    """Phase 4f: tracking under pallas for n_frames frames, saved after
    frame `at` (data.checkpoint) and resumed in a fresh tracker: the poses
    equal the uninterrupted run's bit for bit."""
    import numpy as np
    from cvo_slam_tpu_torch.app.run_slam import build_tracker
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu_torch.data import checkpoint, tum
    cam = CAMERA_PRESETS["TUM1"]
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True)
    records = tum.load_association(os.path.join(folder, "associate.txt"))
    frames = [tum.load_image(folder, r) for r in records[:n_frames]]
    ck = os.path.join(folder, "session.ckpt")
    with env(CVO_SLAM_BACKEND="pallas"):
        t = build_tracker(cam, cfg, device="cuda")
        t.init()
        want = np.array([t.update(f) for f in frames])
        t = build_tracker(cam, cfg, device="cuda")
        t.init()
        got = [t.update(f) for f in frames[:at]]
        checkpoint.save_session(t, ck)
        t = checkpoint.load_session(ck, cam, cfg, device="cuda")
        got = np.array(got + [t.update(f) for f in frames[at:]])
    print(f"checkpoint: {n_frames} frames under pallas, saved after frame "
          f"{at} ({os.path.getsize(ck) / 1e6:.1f} MB) and resumed: poses "
          f"bitwise equal to the uninterrupted run: "
          f"{np.array_equal(got, want)}", flush=True)
    if not np.array_equal(got, want):
        raise AssertionError("the resumed run's poses differ")


def suite(out_dir, card):
    """Phase 4g: eval.suite.run_suite on SUITE_BARS' sequences, full
    length, at 640x480 under pallas with the run loop's defaults
    (speculation on), counters set to 0 just before, read just after:
    tracking and SLAM ATE under each sequence's bar."""
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.eval import suite as suite_mod
    with env(CVO_SLAM_BACKEND="pallas", CVO_SLAM_SPECULATE=None):
        kernels.reset_launch_counts()
        payload = suite_mod.run_suite(out_dir, sequences=list(SUITE_BARS),
                                      device="cuda")
        launches = {k.name: k.launches for k in kernels.KERNELS}
    print(f"suite (pallas) on {card}: launches {launches}", flush=True)
    for r in payload["results"]:
        tr, sl = r["tracking"], r["slam"]
        kp = {k: round(v["mean"], 1)
              for k, v in r.get("keyframe_path_ms", {}).items()}
        print(f"suite {r['sequence']} {r['frames']} frames 640x480: ATE "
              f"tracking {tr['ate_rmse']:.4f} m, SLAM {sl['ate_rmse']:.4f} m "
              f"(bar {SUITE_BARS[r['sequence']]}); RPE SLAM "
              f"{sl['rpe_trans_rmse']:.4f} m, {sl['rpe_rot_rmse_deg']:.3f} "
              f"deg; {r['loop_closures']} loop closures; {r['fps']:.2f} fps "
              f"(wall {r['wall_s']:.1f} s); {r.get('keyframes')} keyframe "
              f"events, ms per event by stage {kp}", flush=True)
        for label, res in (("tracking", tr), ("SLAM", sl)):
            if not res["ate_rmse"] < SUITE_BARS[r["sequence"]]:
                raise AssertionError(f"{r['sequence']}: {label} ATE "
                                     f"{res['ate_rmse']} m over its bar")
    if min(launches[k] for k in ("align_fused", "ip_suite", "pair_stats")) \
            <= 0:
        raise AssertionError(f"suite launches {launches}")


# -- the mesh and the device frontend (phases 2m, 4h-4k) ---------------------

def _align_fields_equal(got, want):
    """The lanes whose outputs (every AlignResult field) differ."""
    import torch
    return [l for l in range(want[0].shape[0])
            if not all(torch.equal(g[l], w[l]) for g, w in zip(got, want))]


def sharded_align(seq, p, report, card):
    """Phase 2m: SHARDED_LANES lanes on the shared frame-0 cloud split over
    a mesh of SHARDS shards on the one card (parallel.batch.
    make_sharded_align, one align_fused_lanes launch per shard), every lane
    equal bit for bit to the same lane of one SHARDED_LANES-lane launch
    (batched_align); counters set to 0 just before the sharded call and read
    just after; device ms of the shards' launches beside the one launch."""
    import torch
    from cvo_slam_tpu_torch.cvo import engine, kernels
    from cvo_slam_tpu_torch.parallel import batch
    from cvo_slam_tpu_torch.parallel.mesh import Mesh
    dev = seq[0][0].device
    S = SHARDED_LANES
    args = (engine.PointCloud(*seq[0]),
            engine.PointCloud(*_stack([seq[1 + l % ALIGN_PAIRS]
                                       for l in range(S)])),
            torch.eye(3, device=dev).expand(S, 3, 3).contiguous(),
            torch.zeros(S, 3, device=dev),
            torch.full((S,), ELLS[0], device=dev))
    want = batch.batched_align(*args, p, backend="pallas")
    mesh = Mesh.on_cards(SHARDS, dev, shared=True)
    sharded = batch.make_sharded_align(mesh, p, backend="pallas")
    kernels.reset_launch_counts()
    got = sharded(*args)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    bad = _align_fields_equal(got, want)
    t_sh, per_sh = device_profile(lambda: sharded(*args), ("align_kernel",),
                                  reps=3)
    t_one, per_one = device_profile(
        lambda: batch.batched_align(*args, p, backend="pallas"),
        ("align_kernel",), reps=3)
    print(f"sharded align: {S} lanes on the frame-0 cloud over {SHARDS} "
          f"shards on {card}: launches {launches}; lanes differing from the "
          f"one {S}-lane launch: {bad}; iterations "
          f"{[int(i) for i in got.iters]}; device {t_sh} ms in {per_sh} "
          f"launches against {t_one} ms in {per_one} launch (the shards run "
          f"one after another on the one card)", flush=True)
    if bad or launches["align_fused_lanes"] != SHARDS or any(
            n for k, n in launches.items() if k != "align_fused_lanes"):
        raise AssertionError(f"sharded align: lanes {bad} differ, launches "
                             f"{launches}")
    # added to the main path's count after phase 3e sets it (main)
    report["align_fused_lanes"]["sharded"] = dict(
        lanes=S, shards=SHARDS, launches=launches["align_fused_lanes"],
        device_ms=t_sh, launches_per_call=per_sh, one_launch_ms=t_one)


def mesh_slam(folder, report, card, sync, mesh):
    """Phase 4h: the walk of phase 4b under pallas through run_slam.run
    with `mesh`: the keyframe ids and timestamps and the accepted
    loop-closure edges of phase 4b's run `sync`, keyframe positions within
    1e-3 m, at least one windowed BA through parallel.sharded_ba and the
    final BA through parallel.sharded_lm, and each window's landmarks as in
    phase 4b. Launches added to the report's counts."""
    import numpy as np
    from cvo_slam_tpu_torch.cvo import kernels
    from cvo_slam_tpu_torch.parallel import sharded_ba, sharded_lm
    calls = dict(sharded_ba=0, sharded_lm=0)
    ba_fn, lm_fn = sharded_ba.optimize_ba_sharded, sharded_lm.optimize_sharded

    def ba(*a, **k):
        calls["sharded_ba"] += 1
        return ba_fn(*a, **k)

    def lm(*a, **k):
        calls["sharded_lm"] += 1
        return lm_fn(*a, **k)
    sharded_ba.optimize_ba_sharded, sharded_lm.optimize_sharded = ba, lm
    mesh.collectives = 0
    try:
        stats, kfs = slam(folder, report, card, backend="pallas", mesh=mesh)
    finally:
        sharded_ba.optimize_ba_sharded, sharded_lm.optimize_sharded = \
            ba_fn, lm_fn
    want_stats, want = sync
    gap = max((float(np.abs(a[2][:3, 3] - b[2][:3, 3]).max())
               for a, b in zip(kfs, want)), default=0.0)
    windows = [(w[0], w[1], w[3]) for w in stats["wba_sizes"]]
    want_windows = [(w[0], w[1], w[3]) for w in want_stats["wba_sizes"]]
    stages = {k: round(v["mean"], 1)
              for k, v in stats.get("keyframe_path_ms", {}).items()}
    want_stages = {k: round(v["mean"], 1)
                   for k, v in want_stats.get("keyframe_path_ms", {}).items()}
    print(f"mesh SLAM ({mesh}) on {card}: {len(kfs)} keyframes (phase 4b "
          f"{len(want)}), {stats['lc_num']} loop-closure edges (4b "
          f"{want_stats['lc_num']}), max keyframe position gap {gap:.3e} m; "
          f"sharded solver calls {calls}, {mesh.collectives} collectives; "
          f"windows (poses, landmarks, projection edges) {windows} (4b "
          f"{want_windows}); keyframe path ms per event by stage {stages} "
          f"(4b {want_stages})", flush=True)
    if [k[:2] for k in kfs] != [k[:2] for k in want] \
            or stats["lc_num"] != want_stats["lc_num"] or not gap <= 1e-3:
        raise AssertionError("mesh SLAM: keyframes, loop-closure edges or "
                             "positions differ from phase 4b's")
    if calls["sharded_ba"] < 1 or calls["sharded_lm"] != 1:
        raise AssertionError(f"mesh SLAM: sharded solver calls {calls}")
    if [w[1] for w in windows] != [w[1] for w in want_windows]:
        raise AssertionError("mesh SLAM: the windows' landmarks differ from "
                             "phase 4b's")
    if not any(w[1] > 0 for w in want_windows):
        raise AssertionError("mesh SLAM: no window of phase 4b carried "
                             "landmarks, so the landmark-carrying sharded "
                             "windowed BA did not run")
    for name in ("align_fused", "ip_suite", "pair_stats"):
        report[name]["launches"] += stats["launches"][name]
    return stats


def solvers(card, shards=(1, 2, 4), repeats=SCALING_REPEATS):
    """Phase 4i: eval.scaling.run_harness at its defaults on the card
    (shards round-robin over the cards), dense and pcg, every row within
    1e-4 of the single-device solver; then a 10-landmark BA on 4 shards
    (4 does not divide 10) against the single-device optimize_ba."""
    import numpy as np
    from cvo_slam_tpu_torch.eval import scaling
    from cvo_slam_tpu_torch.parallel import sharded_ba
    from cvo_slam_tpu_torch.parallel.mesh import Mesh
    with tempfile.TemporaryDirectory(prefix="scaling_") as d:
        t0 = time.perf_counter()
        payload = scaling.run_harness(os.path.join(d, "scaling.json"),
                                      repeats=repeats, shards=shards,
                                      device="cuda")
        wall = time.perf_counter() - t0
    for bench in ("lm", "ba"):
        b = payload[bench]
        print(f"scaling {bench} {b['problem']} on {payload['card']} "
              f"({payload['cards']} cards): single device "
              f"{b['single_device_ms']:.2f} ms; " + "; ".join(
                  f"{r['shards']} shards on {r['cards']} cards {r['solver']} "
                  f"{r['ms_per_call']:.2f} ms, "
                  f"{r['collectives_per_call']:.0f} collectives, |dE| "
                  f"{r['max_abs_pose_delta']:.2e}"
                  + (f", chi2 rel {r['chi2_rel_delta']:.2e}"
                     if "chi2_rel_delta" in r else "")
                  for r in b["shards"]), flush=True)
        worst = max(r["max_abs_pose_delta"] for r in b["shards"])
        if not worst <= 1e-4:
            raise AssertionError(f"scaling {bench}: |dE| {worst} > 1e-4")
    print(f"scaling harness: {wall:.1f} s (repeats {repeats})", flush=True)

    prob, K = scaling.arc_ba_problem(np.random.default_rng(1), 24, 10)
    E1, L1 = scaling.optimize_ba_single(prob, K, 10, 2.0, "cuda")
    mesh = Mesh.on_cards(4, "cuda", shared=True)
    for solver in ("dense", "pcg"):
        sharded, perm, _ = sharded_ba.shard_ba_problem(
            4, *(prob[k] for k in ("L0", "lm_mask", "p_kf", "p_lm", "p_meas",
                                   "p_w", "p_mask", "ei", "ej", "Z", "omega",
                                   "pemask")))
        E2, Ls = sharded_ba.optimize_ba_sharded(prob["E0"], prob["free_pose"],
                                                sharded, K, 10, 2.0, mesh,
                                                solver=solver)
        L2 = Ls.reshape(-1, 3).cpu().numpy()[np.argsort(perm)][:10]
        dE = float(np.abs(E2.cpu().numpy() - E1.cpu().numpy()).max())
        dL = float(np.abs(L2 - L1.cpu().numpy()).max())
        print(f"10 landmarks on 4 shards ({solver}): |dE| {dE:.2e}, |dL| "
              f"{dL:.2e} against the single device", flush=True)
        np.testing.assert_allclose(E2.cpu().numpy(), E1.cpu().numpy(),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(L2, L1.cpu().numpy(), rtol=1e-3,
                                   atol=1e-3)
    return payload


def two_processes(card):
    """Phase 4j: two gloo ranks, each with 2 shards on cuda:0, run the
    sharded LM (parallel.multiprocess); the ranks agree bit for bit and
    agree with the in-process 4-shard mesh within the LM bars."""
    import numpy as np
    from cvo_slam_tpu_torch.parallel import multiprocess
    t0 = time.perf_counter()
    (c0, E0), (c1, E1) = multiprocess.run_ranks(
        world=2, shards_per_rank=2, device="cuda", timeout_s=300)
    wall = time.perf_counter() - t0
    c, E = multiprocess.single_process(4, device="cuda")
    print(f"two processes (gloo, 2 shards each on cuda:0 of {card}): chi2 "
          f"{c0!r} / {c1!r}, poses bitwise equal: {np.array_equal(E0, E1)}; "
          f"in-process 4 shards chi2 {c!r}, |dE| "
          f"{float(np.abs(E0 - E).max()):.2e}; {wall:.1f} s", flush=True)
    if c0 != c1 or not np.array_equal(E0, E1):
        raise AssertionError("the two ranks disagree")
    np.testing.assert_allclose(c0, c, rtol=1e-3)
    np.testing.assert_allclose(E0, E, rtol=1e-3, atol=1e-4)


def device_frontend(folder, card, n_frames=4):
    """Phase 4k: frames of the 640x480 sequence (CAP 3072) and one
    ETH3D-shaped frame (739x458, CAP 3000) through
    frontend.device.create_pointcloud_device on the card against the host
    create_pointcloud: count and pixel set exact, positions rtol 1e-5 /
    atol 1e-6, features rtol 1e-4 / atol 1e-3 (HSV: one quantum on H and
    S); ms per frame of both frontends."""
    import numpy as np
    import torch
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS, FrontendParams
    from cvo_slam_tpu_torch.data import synthetic, tum
    from cvo_slam_tpu_torch.frontend.device import create_pointcloud_device
    from cvo_slam_tpu_torch.frontend.pointcloud import create_pointcloud

    def frames(fold):
        return [tum.load_image(fold, r) for r in tum.load_association(
            os.path.join(fold, "associate.txt"))[:n_frames]]

    eth_dir = os.path.join(folder, "eth3d")
    eth = CAMERA_PRESETS["ETH3D_1"]
    synthetic.make_sequence(eth_dir, eth, n_frames=1)
    cases = [(CAMERA_PRESETS["TUM1"], FrontendParams(cloud_capacity=3072),
              im) for im in frames(folder)]
    cases.append((eth, FrontendParams(num_want=3000, cloud_capacity=3000),
                  frames(eth_dir)[0]))
    cases.append((CAMERA_PRESETS["TUM1"],
                  FrontendParams(cloud_capacity=3072, feature_type=0),
                  cases[0][2]))
    t_host, t_dev = {}, {}
    for k, (cam, fp, im) in enumerate(cases):
        args = (im.bgr, im.gray, im.depth, cam, fp)
        create_pointcloud_device(*args, device="cuda")      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = create_pointcloud_device(*args, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = create_pointcloud(*args)
        t2 = time.perf_counter()
        key = f"{cam.width}x{cam.height} CAP {fp.cloud_capacity}" + (
            " HSV" if fp.feature_type == 0 else "")
        t_dev.setdefault(key, []).append((t1 - t0) * 1e3)
        t_host.setdefault(key, []).append((t2 - t1) * 1e3)
        pos, feat, mask, count, pix = (t.cpu().numpy() for t in got)
        n = host.count
        if int(count) != n or not mask[:n].all() or mask[n:].any():
            raise AssertionError(f"device frontend {key} frame {k}: count "
                                 f"{int(count)}, host {n}")
        want = {tuple(p): i for i, p in
                enumerate(host.selected_pixels[:n].tolist())}
        idx = [want.get(tuple(p), -1) for p in pix[:n].tolist()]
        if sorted(idx) != list(range(n)):
            raise AssertionError(f"device frontend {key} frame {k}: the "
                                 f"selected pixels differ from the host's")
        np.testing.assert_allclose(pos[:n], host.positions[idx], rtol=1e-5,
                                   atol=1e-6)
        if fp.feature_type == 0:
            d = np.abs(feat[:n] - host.features[idx])
            if (d[:, 0] > 1 / 180 + 1e-6).any() or \
                    (d[:, 1] > 1 / 255 + 1e-6).any():
                raise AssertionError("device frontend HSV: more than one "
                                     "quantum on H or S")
            np.testing.assert_allclose(feat[:n, 2:], host.features[idx, 2:],
                                       rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(feat[:n], host.features[idx],
                                       rtol=1e-4, atol=1e-3)
    times = "; ".join(f"{k} {np.median(t_dev[k]):.2f} / "
                      f"{np.median(t_host[k]):.2f} ({len(t_dev[k])} frames)"
                      for k in t_dev)
    print(f"device frontend on {card}: counts, pixel sets, positions and "
          f"features as the host's; ms per frame (device / host): {times}",
          flush=True)
    return {k: dict(device_ms=float(np.median(t_dev[k])),
                    host_ms=float(np.median(t_host[k]))) for k in t_dev}


def multi_card(cards: int) -> int:
    """`--cards N`: phases 4h and 4i with one shard per card on a machine
    with N cards: the walk of phase 4b on cuda:0, then again with the
    windowed and final BA on a mesh over cuda:0 .. N-1 (run_slam's
    --mesh N), and the scaling harness on 1, 2 and N shards, one per
    card."""
    import torch
    from cvo_slam_tpu_torch.cvo import cuda_build, kernels
    from cvo_slam_tpu_torch.parallel.mesh import Mesh
    if torch.cuda.device_count() < cards:
        return fail(f"--cards {cards}: the machine has "
                    f"{torch.cuda.device_count()} cards")
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; {torch.cuda.device_count()} cards: "
          f"{[torch.cuda.get_device_name(i) for i in range(cards)]}",
          flush=True)
    cuda_build.build_all()
    report = {k.name: dict(name=k.name, launches=0) for k in kernels.KERNELS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as folder:
        with phase("4b"):
            sync = slam(os.path.join(folder, "slam"), report, card,
                        backend="pallas")
        with phase(f"4h on {cards} cards"):
            mesh_slam(os.path.join(folder, "slam"), report, card, sync,
                      Mesh.on_cards(cards, "cuda"))
        with phase(f"4i on {cards} cards"):
            solvers(card, shards=(1, 2, cards))
    print(f"chip_smoke --cards {cards}: {time.perf_counter() - t_start:.1f} "
          f"s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="chip smoke run of the port")
    ap.add_argument("--cards", type=int, default=1,
                    help="with N > 1: only phases 4h and 4i, one shard per "
                         "card of N")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "cvo_slam_tpu_torch")):
        return fail("cvo_slam_tpu_torch/ not found beside chip_smoke.py: run "
                    "from the root of a checkout")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this run needs a "
                    "CUDA card")
    if args.cards > 1:
        return multi_card(args.cards)
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu_torch.cvo import cuda_build, kernels
    from cvo_slam_tpu_torch.data import synthetic
    from cvo_slam_tpu_torch.parallel.mesh import Mesh

    # -- phase 1: card and build
    t_start = time.perf_counter()
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
        with phase("2"):
            clouds = first_pair_clouds(folder, cam)
            kernel_checks(clouds, p, report)
            flow_step_checks(clouds, p, report)
            seq = sequence_clouds(folder, cam, CAPS[0], ALIGN_PAIRS + 1)
            align_checks(seq, p, report)
            lane_checks(seq, p, report)
            skip_checks(clouds, seq, p, report)
        with phase("2m"):
            sharded_align(seq, p, report, card)
        with phase("2x"):
            xla_checks(seq, p, card)
            del seq

        # -- phase 3: tracking-only SLAM through the CLI's run() on each
        #    backend; phase 3d: speculation; phase 4: the whole system;
        #    phase 4c: run_odometry; phases 4d-4g: the async backend,
        #    run_odometry --adaptive, checkpoint, the suite; then one frame
        #    under the profiler (after, so it cannot slow the others)
        with phase("3"):
            t_mom = tracking(folder, gt, report, card, "pallas_mom")
        with phase("3b"):
            fused = tracking(folder, gt, report, card, "pallas")
        with phase("3x"):
            with plain_calls() as plain:
                t_xla = tracking(folder, gt, report, card, "xla")
            _no_kernel("tracking (xla)", {}, plain)
        t_fused = fused["t_frame"]
        print(f"ms/frame mean / median: pallas_mom "
              f"{np.mean(t_mom['t_frame']):.1f} / "
              f"{np.median(t_mom['t_frame']):.1f}, pallas "
              f"{np.mean(t_fused):.1f} / {np.median(t_fused):.1f}, xla "
              f"{np.mean(t_xla['t_frame']):.1f} / "
              f"{np.median(t_xla['t_frame']):.1f}", flush=True)
        with phase("3c"):
            t_iter = tracking(folder, gt, report, card, "pallas_iter",
                              ITER_FRAMES)
        with phase("3s"):
            # phases 3, 3b, 3c with every sweep unskipped: the same
            # trajectories, line for line
            for backend, ref in (("pallas_mom", t_mom), ("pallas", fused),
                                 ("pallas_iter", t_iter)):
                with unskipped():
                    again = tracking(folder, gt, report, card, backend,
                                     len(ref["lines"]))
                if again["lines"] != ref["lines"]:
                    return fail(f"{backend}: tracking with the unskipped "
                                f"sweeps differs from the skipping run")
            print("tracking with every tile pair computed (pallas_mom, "
                  "pallas, pallas_iter): trajectories equal to phases 3, 3b"
                  " and 3c line for line", flush=True)
        with phase("3d"):
            spec = tracking(folder, gt, report, card, "pallas",
                            speculate="1")
        sp = spec["stats"]["speculation"]
        print(f"speculation (pallas, CVO_SLAM_SPECULATE=1): hits "
              f"{sp['hits']}, misses {sp['misses']}, discarded "
              f"{sp['discards']}; ms/frame mean / median "
              f"{np.mean(spec['t_frame']):.1f} / "
              f"{np.median(spec['t_frame']):.1f} (phase 3b without: "
              f"{np.mean(t_fused):.1f} / {np.median(t_fused):.1f}); "
              f"trajectory equal to phase 3b's: "
              f"{spec['lines'] == fused['lines']}", flush=True)
        if sp["hits"] < 1 or spec["lines"] != fused["lines"]:
            return fail("speculation: no hit, or poses not bitwise equal "
                        "to phase 3b's")
        with phase("3e"):
            t0 = time.perf_counter()
            frames = lockstep_sequences(folder, cam)
            print(f"lockstep sequences: {LOCKSTEP_SEQS - 1} more of "
                  f"{N_FRAMES} frames in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            lockstep(frames, cam, report, card)
            del frames
        with phase("4"):
            s_mom = slam(os.path.join(folder, "slam"), report, card,
                         check_matcher=True)
        with phase("4b"):
            s_fused = slam(os.path.join(folder, "slam"), report, card,
                           backend="pallas")
        for name, (st, _) in (("pallas_mom", s_mom), ("pallas", s_fused)):
            print(f"keyframe path ms per event ({name}): "
                  f"{ {k: round(v['mean'], 1) for k, v in st.get('keyframe_path_ms', {}).items()} }, "
                  f"verify per round "
                  f"{round(st['lc_stage_ms']['verify']['mean'], 1) if 'lc_stage_ms' in st else None}",
                  flush=True)
        with phase("4c"):
            odometry(folder, gt, card)
        with phase("4d"):
            async_backend(os.path.join(folder, "slam"), report, card,
                          s_fused)
        with phase("4e"):
            adaptive_odometry(folder, gt, card)
        with phase("4f"):
            resume(folder, card)
        with phase("4g"):
            suite(os.path.join(folder, "suite"), card)
        with phase("4h"):
            mesh_slam(os.path.join(folder, "slam"), report, card, s_fused,
                      Mesh.on_cards(SHARDS, "cuda", shared=True))
        with phase("4i"):
            solvers(card)
        with phase("4j"):
            two_processes(card)
        with phase("4k"):
            device_frontend(folder, card)
        with phase("4l"):
            place_recognition(os.path.join(folder, "places"), card)
        with phase("5"):
            for backend in ("pallas_mom", "pallas", "pallas_iter"):
                profile_frame(clouds, p, backend)

    report["align_fused_lanes"]["launches"] += \
        report["align_fused_lanes"]["sharded"]["launches"]
    for entry in report.values():
        if entry["launches"] <= 0:
            return fail(f"{entry['name']} was not launched " + (
                "by its checks" if entry["name"] in CHECK_ONLY
                else "on the main path"))
    for name in CHECK_ONLY:
        report[name]["launches_from"] = "phase-2 checks"
        report[name]["passes_in_flow_and_step"] = \
            report["flow_and_step"]["launches"]
    # launch_info's counts are device tensors
    print(json.dumps({"kernels": list(report.values())},
                     default=lambda o: o.tolist()), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
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
