#!/usr/bin/env python3
"""Same-call comparisons on one GPU, beside chip_smoke.py's own numbers.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 chip_compare.py e2e ROOT
    python3 chip_compare.py kernels ROOT [ROOT2]
    python3 chip_compare.py speculation ROOT
    python3 chip_compare.py xla ROOT
    python3 chip_compare.py spans WORKLOAD SEED [TRACED_S [PAIRS [COST_S]]]

e2e: chip_smoke.py's end-to-end phases on the package under ROOT: tracking
under pallas (16 frames) and pallas_iter (8 frames), each with its
keyframe decisions per tracked frame (metrics.jsonl `accept`: 1 keeps the
keyframe, 0 makes the frame a new one), run_odometry, and the whole SLAM
system under pallas with its keyframe decisions and its verify ms per
candidate. ROOT is this checkout (.) or another commit unpacked with `git
archive` into a git-ignored directory. Host-bound times move by tens of
percent between machines, so compare two commits in one call, in turns:
parent, change, change, parent.

kernels: the kernels of the package under ROOT, built from its csrc/:
ptxas's registers and the device time (torch.profiler) with the kernel
launches per call of the moment kernel, the suite (rows the moving cloud
under chip_smoke's TWIST for post), its yardstick of four pair-stats calls (pre, post with
moments, fixed, moving), pair stats (with and without moments, rows the
moving cloud under TWIST), flow_and_step, flow and step_coeffs at CAP
3072 (frames 0 -> 1 of chip_smoke's sequence, ell 0.15 and 0.06; nnz and
the pair counts checked against the plain versions) and of align_fused
(ell 0.15 from the identity), with its iterations and launch; then, for
each of the sequence's first ALIGN_PAIRS frame pairs k -> k + 1 at CAP 3072,
the whole-run gap of each align backend to its plain version: the
iterations and end transform of align_fused against align_fused_plain,
and of engine.align under pallas_mom and pallas_iter with the kernel
against the same run with kernels.moment_pass_cuda /
kernels.flow_and_step_cuda swapped for their plain versions inside this
process (the stop rule and the sparsification gate turn last-bit
differences of the sums into different iteration counts); last,
chip_smoke's phase 3 (tracking under pallas_mom) with its iterations per
alignment. Run several in one call to compare them. With two roots (the
parent and the change), each runs in a process of its own, in turn, and
a last line sets their one-lane align_fused, suite and pair stats side
by side: whether each tree's outputs on chip_smoke's frame pairs 0 -> 1 ..
5 -> 6 (align_fused from the identity at ell 0.15) and on frames 0 -> 1
(the suite and pair stats in both modes, both ells) are bitwise equal to
the other's, and each tree's device us per align_fused iteration (frames
0 -> 1) and suite device ms.

speculation: chip_smoke's tracking phase (16 frames; pallas_iter 8) on
each backend with CVO_SLAM_SPECULATE=0, 1, 1, 0 in turns: ms/frame and the
speculation's hits, misses and discards per run, and whether the runs of a
backend wrote the same trajectory, line for line.

xla: the device times of the xla align backend (plain torch and one cuBLAS
product per iteration; no kernel of the port) beside the moment kernel's,
on chip_smoke's frames 0 -> 1 at CAP 3072, both ells: ms per call (CUDA
events) and the device ms and device operations of one call in one
torch.profiler window, for the kernel matrix with the moment product, the
whole xla pass, the moment kernel, and the moment kernel with its
epilogue; then chip_smoke's six frame pairs as the lanes of one xla lane
program against the six solo aligns, one call each: wall ms, device ms,
device operations and their count per lane-iteration.

spans: one benchmark cell (BENCHMARK.json's WORKLOAD, its run's set-up
and warm-up through benchmark/harness.py) with the port's span recorder
(cvo_slam_tpu_torch/spans.py) on over a traced window of TRACED_S seconds
(default 20), its first seconds under the benchmark's profiler sessions
(benchmark/trace.py): the readings of eval/span_readings.py per window
frame and every span's self ms per frame; the complete profiler sessions'
idle gaps moved onto the spans' clock by each session's median offset of
its frames' starts (the offsets' spread: max - min, after the first frame,
and quartiles), each given to a span by span_readings.idle_by_span through
the thread that launched the operation ending it (the trace's thread ids
matched to the port's by their launches), the share left unattributed
(idle_unattributed_pct) and the ten spans with the most idle under them;
then PAIRS (default 3) pairs of
untraced windows of COST_S seconds (default 15), the recorder off and on
in turns (off, on, on, off, ...): each window's frames per second and
spans per frame; and the cost of one span site with the recorder on and
off on this host.

Each mode prints a result line per phase and exits non-zero without a CUDA
card.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
# the kernels as torch.profiler names them, in this tree and in the trees
# before it (one-block finalize kernels of the per-pair passes; the moment
# kernel's chunk reduction; pair stats through the suite's passes 2 and 3)
PASS_NAMES = ("flow_pass", "step_pass", "flow_finalize", "step_finalize")
MOMENT_NAMES = ("moment_keep_pass", "moment_sum_pass", "moment_pass",
                "moment_reduce")
PAIR_STATS_NAMES = ("pair_stats_sweep", "pair_stats_pass", "suite_")
SUITE_NAMES = ("suite_",)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def keyframe_decisions(folder: str):
    """The keyframe decision (`accept`) of every tracked frame in the
    metrics.jsonl of a run_slam run in `folder`."""
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["accept"] for r in rows if "accept" in r]


def e2e(root: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    cs = _chip_smoke()
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS
    from cvo_slam_tpu_torch.cvo import cuda_build, kernels
    from cvo_slam_tpu_torch.data import synthetic
    if not kernels.__file__.startswith(root):
        raise RuntimeError(f"imported {kernels.__file__}, not under {root}")
    cuda_build.build_all()
    card = cs.card_line()
    report = {k.name: dict(name=k.name, launches=0) for k in kernels.KERNELS}
    print(f"e2e of {root} on {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_compare_") as folder:
        gt = synthetic.make_sequence(folder, CAMERA_PRESETS["TUM1"],
                                     n_frames=cs.N_FRAMES)
        decisions = {}
        cs.tracking(folder, gt, report, card, "pallas")
        decisions["tracking pallas"] = keyframe_decisions(folder)
        cs.tracking(folder, gt, report, card, "pallas_iter", cs.ITER_FRAMES)
        decisions["tracking pallas_iter"] = keyframe_decisions(folder)
        cs.odometry(folder, gt, card)
        st, _ = cs.slam(os.path.join(folder, "slam"), report, card,
                        backend="pallas")
        decisions["SLAM pallas"] = keyframe_decisions(
            os.path.join(folder, "slam"))
    print(f"keyframe decisions per tracked frame: {decisions}", flush=True)
    per_cand = st["lc_stage_ms"]["verify"]["mean"] * st["lc_rounds"] \
        / st["lc_candidates"]
    print(f"verify per candidate (pallas): {per_cand:.1f} ms over "
          f"{st['lc_candidates']} candidates", flush=True)
    return 0


def speculation_mode(root: str) -> int:
    import numpy as np
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    cs = _chip_smoke()
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS
    from cvo_slam_tpu_torch.cvo import cuda_build, kernels
    from cvo_slam_tpu_torch.data import synthetic
    cuda_build.build_all()
    card = cs.card_line()
    report = {k.name: dict(name=k.name, launches=0) for k in kernels.KERNELS}
    with tempfile.TemporaryDirectory(prefix="chip_compare_") as folder:
        gt = synthetic.make_sequence(folder, CAMERA_PRESETS["TUM1"],
                                     n_frames=cs.N_FRAMES)
        for backend in ("pallas_mom", "pallas", "pallas_iter"):
            n = cs.ITER_FRAMES if backend == "pallas_iter" else cs.N_FRAMES
            runs = [cs.tracking(folder, gt, report, card, backend, n, spec)
                    for spec in ("0", "1", "1", "0")]
            row = "; ".join(
                f"SPECULATE={spec}: {np.mean(r['t_frame']):.1f} / "
                f"{np.median(r['t_frame']):.1f} ms/frame, "
                f"{r['stats']['speculation']}"
                for spec, r in zip(("0", "1", "1", "0"), runs))
            same = all(r["lines"] == runs[0]["lines"] for r in runs)
            print(f"speculation under {backend} on {card}: {row}; "
                  f"trajectories equal: {same}", flush=True)
            if not same:
                return 1
    return 0


@contextlib.contextmanager
def plain_align_kernels(kernels):
    """kernels.moment_pass_cuda and kernels.flow_and_step_cuda replaced by
    their plain versions inside this process for the block (what the
    pallas_mom and pallas_iter aligns call once per iteration)."""
    saved = kernels.moment_pass_cuda, kernels.flow_and_step_cuda
    kernels.moment_pass_cuda = \
        lambda x, y, fx, fy, mx, my, U, ell, p, **_: \
        kernels.moment_pass_plain(x, y, fx, fy, mx, my, U, ell, p)
    kernels.flow_and_step_cuda = \
        lambda x, y, fx, fy, mx, my, ell, p, **_: \
        kernels.flow_and_step_plain(x, y, fx, fy, mx, my, ell, p)
    try:
        yield
    finally:
        kernels.moment_pass_cuda, kernels.flow_and_step_cuda = saved


def whole_run_gaps(cs, clouds, p):
    """{backend: [(iterations, plain iterations, |dt| m, angle rad) per
    frame pair k -> k + 1]} of align_fused and of the pallas_mom and
    pallas_iter aligns against their plain versions, from the identity at
    ell 0.15."""
    import torch
    from cvo_slam_tpu_torch.cvo import engine, kernels
    gaps = {"pallas": [], "pallas_mom": [], "pallas_iter": []}
    for k in range(len(clouds) - 1):
        it, itp, dt, ang, _, _ = cs.align_pair_gap(clouds, k, p)
        gaps["pallas"].append((it, itp, dt, ang))
        fixed, moving = (engine.PointCloud(*clouds[k]),
                         engine.PointCloud(*clouds[k + 1]))
        dev = clouds[k][0].device
        eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        for backend in ("pallas_mom", "pallas_iter"):
            got = engine.align(fixed, moving, eye, zero, cs.ELLS[0], p,
                               backend)
            with plain_align_kernels(kernels):
                want = engine.align(fixed, moving, eye, zero, cs.ELLS[0], p,
                                    backend)
            dt, ang = cs.transform_gap((got.R, got.T), (want.R, want.T))
            gaps[backend].append((int(got.iters), int(want.iters), dt, ang))
    return gaps


def _summary(rows):
    """min / median / max of |iteration gap| and of |dt| over frame pairs."""
    import numpy as np
    di = np.abs([a - b for a, b, _, _ in rows])
    dt = np.array([d for _, _, d, _ in rows])
    return (f"|iteration gap| {di.min()}/{np.median(di):g}/{di.max()}, "
            f"|dt| {dt.min():.2e}/{np.median(dt):.2e}/{dt.max():.2e} m "
            f"(min/median/max)")


def solo_outputs(cs, clouds, p, ell_suite, yt):
    """The one-lane align_fused outputs on chip_smoke's frame pairs, and the
    suite's and pair stats' (both modes; rows yt, columns frame 0) on
    frames 0 -> 1 at each of chip_smoke's ells, as host arrays by name."""
    from cvo_slam_tpu_torch.cvo import kernels
    out = {}
    for k in range(len(clouds) - 1):
        for i, t in enumerate(kernels.align_fused_cuda(
                *cs.align_args(clouds, k, p))):
            out[f"align {k}->{k + 1} {i}"] = t.cpu().numpy()
    (x, fx, mx), (y, fy, my) = clouds[:2]
    for ell in ell_suite:
        for i, t in enumerate(kernels.ip_suite_cuda(x, fx, mx, y, fy, my, yt,
                                                    ell, p)):
            out[f"suite {ell} {i}"] = t.cpu().numpy()
        for mom in (False, True):
            for i, t in enumerate(kernels.pair_stats_cuda(
                    yt, fy, my, x, fx, mx, ell, p, mom)):
                out[f"pair_stats {ell} {mom} {i}"] = t.cpu().numpy()
    return out


def side_by_side(roots) -> int:
    """kernels_mode of each root in a process of its own, then the S = 1
    align_fused, suite and pair stats of the roots side by side."""
    import subprocess
    import numpy as np
    tmp = tempfile.mkdtemp(prefix="chip_compare_")
    try:
        dumps = []
        for k, root in enumerate(roots):
            dump = os.path.join(tmp, f"{k}.npz")
            rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                                  "kernels", root, "--dump", dump])
            if rc:
                return rc
            dumps.append(np.load(dump))
        a, b = dumps
        outs = sorted(k for k in a.files if not k.startswith("time "))
        differ = [k for k in outs if not np.array_equal(a[k], b[k])]
        times = {root: {k[5:]: float(d[k]) for k in d.files
                        if k.startswith("time ")}
                 for root, d in zip(roots, dumps)}
        print(f"one-lane align_fused, suite and pair stats, {roots[0]} "
              f"against "
              f"{roots[1]}: {len(outs) - len(differ)} of {len(outs)} outputs "
              f"bitwise equal{'' if not differ else f' (differ: {differ})'}; "
              f"device times {times}", flush=True)
        return 0 if not differ else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def kernels_mode(root: str, dump: str = "") -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    cs = _chip_smoke()
    import torch
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu_torch.cvo import cuda_build, kernels
    from cvo_slam_tpu_torch.data import synthetic
    from cvo_slam_tpu_torch.ops import pairwise, se3
    if not kernels.__file__.startswith(root):
        raise RuntimeError(f"imported {kernels.__file__}, not under {root}")
    tmp = tempfile.mkdtemp(prefix="chip_compare_")
    try:
        cuda_build.build_all()
        regs = {src: [line.split(":", 1)[-1].strip()
                      for line in cuda_build.build_report.get(
                          "ptxas", {}).get(src, "").splitlines()
                      if "registers" in line]
                for src in ("moment_flow_step.cu", "ip_suite.cu",
                            "pair_stats.cu", "flow_step.cu",
                            "align_fused.cu")}

        cam, p = CAMERA_PRESETS["TUM1"], SlamConfig.default_shipped().cvo
        seq = os.path.join(tmp, "seq")
        gt = synthetic.make_sequence(seq, cam, n_frames=cs.N_FRAMES)
        clouds = cs.sequence_clouds(seq, cam, cs.CAPS[0], cs.ALIGN_PAIRS + 1)
        (x, fx, mx), (y, fy, my) = clouds[:2]
        args = (x, y, fx, fy, mx, my)
        _, U = pairwise.step_moment_basis(x, mx)
        U = U.contiguous()
        yt = se3.transform_points(se3.exp_se3(torch.tensor(
            cs.TWIST, device="cuda")), y).contiguous()
        ms = {}
        for ell_v in cs.ELLS:
            ell = torch.tensor(ell_v, device="cuda")
            suite = (x, fx, mx, y, fy, my, yt, ell, p)
            got = kernels.ip_suite_cuda(*suite)
            want = kernels.ip_suite_plain(*suite)
            if [int(got[k]) for k in (1, 3, 5, 7, 9)] \
                    != [int(want[k]) for k in (1, 3, 5, 7, 9)]:
                raise AssertionError(f"suite counts differ from the plain "
                                     f"version at ell {ell_v}")
            ms[f"suite {ell_v}"] = cs.device_profile(
                lambda: kernels.ip_suite_cuda(*suite), SUITE_NAMES)
            sets = ((y, fy, my, x, fx, mx, False),
                    (yt, fy, my, x, fx, mx, True),
                    (x, fx, mx, x, fx, mx, False),
                    (y, fy, my, y, fy, my, False))
            ms[f"four pair_stats calls {ell_v}"] = cs.device_profile(
                lambda: [kernels.pair_stats_cuda(*q[:6], ell, p, q[6])
                         for q in sets], PAIR_STATS_NAMES)
            if int(kernels.moment_pass_cuda(*args, U, ell, p)[1]) \
                    != int(kernels.moment_pass_plain(*args, U, ell, p)[1]):
                raise AssertionError(f"moment nnz differs from the plain "
                                     f"version at ell {ell_v}")
            ms[f"moment {ell_v}"] = cs.device_profile(
                lambda: kernels.moment_pass_cuda(*args, U, ell, p),
                MOMENT_NAMES)
            for mom in (False, True):
                stats = (yt, fy, my, x, fx, mx, ell, p, mom)
                if float(kernels.pair_stats_cuda(*stats)[1]) \
                        != float(kernels.pair_stats_plain(*stats)[1]):
                    raise AssertionError(f"pair_stats count differs from the "
                                         f"plain version at ell {ell_v}")
                ms[f"pair_stats{' moments' if mom else ''} {ell_v}"] = \
                    cs.device_profile(
                        lambda: kernels.pair_stats_cuda(*stats),
                        PAIR_STATS_NAMES)
            want = kernels.flow_and_step_plain(*args, ell, p)
            if int(kernels.flow_and_step_cuda(*args, ell, p)[2]) \
                    != int(want[2]):
                raise AssertionError(f"nnz differs from the plain version "
                                     f"at ell {ell_v}")
            calls = {
                "flow_and_step": lambda: kernels.flow_and_step_cuda(
                    *args, ell, p),
                "flow": lambda: kernels.flow_cuda(*args, ell, p),
                "step_coeffs": lambda: kernels.step_coeffs_cuda(
                    *args, want[0], want[1], ell, p),
            }
            for k, fn in calls.items():
                ms[f"{k} {ell_v}"] = cs.device_profile(fn, PASS_NAMES)
        a = cs.align_args(clouds, 0, p)
        launch = {}
        iters = int(kernels.align_fused_cuda(*a, launch_info=launch)[3])
        t = cs.device_time_ms(lambda: kernels.align_fused_cuda(*a),
                              cs.DEVICE_NAMES["align_fused"], reps=5)
        per_iter = "no window held every launch" if t is None else \
            f"{t:.4f} ms, {t / (iters + 1):.4f} ms per iteration"
        if dump:
            import numpy as np
            out = solo_outputs(cs, clouds, p, cs.ELLS, yt)
            out["time align_fused us per iteration"] = \
                np.nan if t is None else t / (iters + 1) * 1e3
            suite_ms = ms[f"suite {cs.ELLS[0]}"][0]
            out["time suite device ms"] = \
                np.nan if suite_ms is None else suite_ms
            np.savez(dump, **out)
        gaps = whole_run_gaps(cs, clouds, p)
        card = cs.card_line()
        print(f"kernels of {root} on {card}: registers {regs}; (device ms, "
              f"launches per call) {ms}; align_fused {per_iter}, {iters + 1} "
              f"iterations, launch {launch}", flush=True)
        for backend, rows in gaps.items():
            pairs = "; ".join(
                f"{k}->{k + 1}: {a} vs {b} iterations, {dt:.2e} m, "
                f"{ang:.2e} rad" for k, (a, b, dt, ang) in enumerate(rows))
            print(f"whole-run gap of {backend} to its plain version, CAP "
                  f"{cs.CAPS[0]}, {root}: {pairs}; {_summary(rows)}",
                  flush=True)
        report = {k.name: dict(name=k.name, launches=0)
                  for k in kernels.KERNELS}
        cs.tracking(seq, gt, report, card, "pallas_mom")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def xla_mode(root: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    cs = _chip_smoke()
    import torch
    from cvo_slam_tpu_torch.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu_torch.cvo import cuda_build, engine, kernels
    from cvo_slam_tpu_torch.data import synthetic
    from cvo_slam_tpu_torch.ops import pairwise
    if not kernels.__file__.startswith(root):
        raise RuntimeError(f"imported {kernels.__file__}, not under {root}")
    cuda_build.build_all()
    card = cs.card_line()
    cam, p = CAMERA_PRESETS["TUM1"], SlamConfig.default_shipped().cvo
    with tempfile.TemporaryDirectory(prefix="chip_compare_") as folder:
        synthetic.make_sequence(folder, cam, n_frames=cs.ALIGN_PAIRS + 1)
        clouds = cs.sequence_clouds(folder, cam, cs.CAPS[0],
                                    cs.ALIGN_PAIRS + 1)
    (x, fx, mx), (y, fy, my) = clouds[:2]
    center, U = pairwise.step_moment_basis(x, mx)
    U = U.contiguous()
    ckg = pairwise.color_kernel_gated(fx, fy, mx, my, p)
    for ell_v in cs.ELLS:
        ell = torch.tensor(ell_v, device="cuda")

        def dense():
            A, keep = pairwise.cvo_kernel_from_color(x, y, ckg, ell, p)
            return pairwise.moment_product(A, U), torch.sum(keep)

        for name, fn in (
                ("kernel matrix + moment product (xla)", dense),
                ("xla pass", lambda: pairwise.flow_and_step_moments_lanes(
                    x, y, ckg, U, center, ell, p)),
                ("moment kernel", lambda: kernels.moment_pass(
                    x, y, fx, fy, mx, my, U, ell, p)),
                ("moment kernel + epilogue (pallas_mom)",
                 lambda: kernels.moment_flow_step(x, y, fx, fy, mx, my, U,
                                                  center, ell, p))):
            t = cs.cuda_time_ms(fn, reps=5, trials=3)
            d, n = cs._device_once(fn)
            print(f"{name}, CAP {cs.CAPS[0]} ell {ell_v} on {card}: "
                  f"{t:.4f} ms per call, device {d} ms in {n} device "
                  f"operations (one call)", flush=True)
    S, dev = cs.ALIGN_PAIRS, x.device
    cl = [engine.PointCloud(*c) for c in clouds]
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    ell0 = torch.tensor(cs.ELLS[0], device=dev)

    def solos():
        return [engine.align(cl[k], cl[k + 1], eye, zero, ell0, p, "xla")
                for k in range(S)]

    def lanes():
        return engine.align_lanes(cl[:S], cl[1:S + 1], [eye] * S,
                                  [zero] * S, [ell0] * S, p, "xla")

    lane_iters = sum(int(r.iters) + 1 for r in solos())
    for name, fn in (("lanes", lanes), ("solo aligns", solos)):
        w = cs._wall_ms(fn)
        d, n = cs._device_once(fn)
        print(f"xla, frames 0 -> 1 .. {S - 1} -> {S} as {S} {name} on "
              f"{card}: {w:.1f} ms, device {d} ms in {n} device operations "
              f"({n / lane_iters:.1f} per lane-iteration, {lane_iters})",
              flush=True)
    return 0


def _session_gaps(events, frames):
    """The idle gaps of one profiler session (benchmark/trace.py's window:
    its first frame's start to its last frame's end) on the harness's
    perf_counter clock, each with the trace's id of the thread that
    launched the device operation ending it (None at the window's end);
    the session's launches as (time on that clock, thread id); and the
    per-frame offsets of the trace's clock (us) that moved them."""
    from benchmark import trace as trace_mod
    frame_ann = sorted((e for e in events
                        if e.get("cat") == "user_annotation"
                        and e.get("name") == "bench.frame"),
                       key=lambda e: e["ts"])
    if not frame_ann:
        return [], [], []
    gpu = [e for e in events if e.get("cat") in trace_mod.GPU_CATS
           and "dur" in e]
    runtime = [e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})]
    launcher = {e["args"]["correlation"]: e["tid"] for e in runtime}
    starts = {}
    for e in gpu:
        c = e.get("args", {}).get("correlation")
        starts.setdefault(e["ts"], launcher.get(c))
    lo = frame_ann[0]["ts"]
    hi = max(e["ts"] + e["dur"] for e in frame_ann)
    iv = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in gpu
          if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    offsets = [a["ts"] - f0 * 1e6 for a, (f0, _) in zip(frame_ann, frames)]
    off = sorted(offsets)[len(offsets) // 2]
    return ([((a - off) / 1e6, (b - off) / 1e6, starts.get(b))
             for a, b in trace_mod._gaps(iv, lo, hi)],
            [((e["ts"] - off) / 1e6, e["tid"]) for e in runtime
             if e["name"] in trace_mod.LAUNCHES], offsets)


def _thread_map(launches, taken):
    """The trace's thread ids as the port's (native ids): each to the
    thread that was in a span other than a wait at most of its launches
    (the profiler names a thread it did not see start by another id than
    the system's). Returns ({trace id: native id}, {trace id: (launches,
    votes of the chosen thread)})."""
    import collections
    from cvo_slam_tpu_torch.eval import span_readings
    by_tid = collections.defaultdict(list)
    for sp in taken:
        by_tid[sp.tid].append(sp)
    inner = {tid: span_readings.Covering(ss) for tid, ss in by_tid.items()}
    votes = collections.defaultdict(collections.Counter)
    count = collections.Counter()
    for t, k in launches:
        count[k] += 1
        for tid, cov in inner.items():
            sp = cov.at(t)
            if sp is not None and sp.name not in span_readings.WAITS:
                votes[k][tid] += 1
    best = {k: c.most_common(1)[0] for k, c in votes.items()}
    return ({k: tid for k, (tid, _) in best.items()},
            {str(k): (count[k], best[k][1] if k in best else 0)
             for k in count})


def _span_site_us(spans, n=200000):
    """us per `with spans.span(...)` with the recorder as it is."""
    import time
    t0 = time.perf_counter()
    for _ in range(n):
        with spans.span("cost"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def spans_mode(workload: str, seed: int, traced_s: float = 20.0,
               pairs: int = 3, cost_s: float = 15.0, device="cuda:0",
               overrides=None) -> int:
    import gc
    import statistics
    import torch
    from benchmark import harness, run, spec
    from benchmark import trace as trace_mod
    from cvo_slam_tpu_torch import spans
    from cvo_slam_tpu_torch.eval import span_readings

    cell = spec.load_cell(workload)
    dev = torch.device(device)
    for k in run.PORT_KNOBS:
        os.environ.pop(k, None)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    folder = tempfile.mkdtemp(prefix="cvo-spans-")
    try:
        session = harness.Session(cell, seed, dev, folder, overrides)
        warm = cell.traffic["warmup"].get("frames", 0) or 3 * session.lap
        it = session.stream(warm + int((traced_s + 2 * pairs * cost_s)
                                       * 200) + 64)
        image, g = next(it), 0
        image, g = session.warm_up(it, image, g)
        sync()
        tracer = trace_mod.Tracer(dev, cell, folder)
        tracer.warm()
        gc.collect()

        spans.enable()
        tracer.start()
        window = session.window(it, image, g, traced_s, tracer.profiler,
                                tracer.stopped)
        spans.disable()
        taken = spans.take()
        sessions = []
        for path, frames in tracer.sessions:
            with open(path) as f:
                sessions.append((json.load(f)["traceEvents"], frames))
        summary, _ = tracer.read()
        n = len(window.frames)
        iters = sum(f.odo_iters + f.kf_iters for f in window.frames)
        out = {"mode": "spans", "workload": workload, "seed": seed,
               "card": card, "frames": n, "window_s": window.window_s,
               "spans_per_frame": len(taken) / max(n, 1),
               "readings": span_readings.readings(taken, n, iters,
                                                   window.events)}
        gaps, launches, spreads = [], [], []
        for events, frames in sessions:
            if trace_mod._read_session(events, frames)["lost"]:
                continue
            g_h, l_h, offsets = _session_gaps(events, frames)
            if not offsets:
                continue
            gaps.extend(g_h)
            launches.extend(l_h)
            q = statistics.quantiles(offsets, n=4, method="inclusive") \
                if len(offsets) > 1 else [offsets[0]] * 3
            rest = offsets[1:] or offsets
            spreads.append({"frames": len(offsets),
                            "max_min_ms": (max(offsets) - min(offsets))
                            / 1e3, "q3_q1_ms": (q[2] - q[0]) / 1e3,
                            "max_min_ms_after_first": (max(rest) - min(rest))
                            / 1e3})
        tid_map, votes = _thread_map(launches, taken)
        gaps = [(a, b, tid_map.get(k)) for a, b, k in gaps]
        unattributed, by_name = span_readings.idle_by_span(gaps, taken)
        idle = sum(g[1] - g[0] for g in gaps)
        own = span_readings.self_times(taken)
        self_ms = {}
        for sp in taken:
            self_ms[sp.name] = self_ms.get(sp.name, 0.0) \
                + 1e3 * own[sp.id] / max(n, 1)
        out.update(
            self_ms_per_frame=dict(sorted(self_ms.items(),
                                          key=lambda kv: -kv[1])),
            gaps=len(gaps),
            gaps_by_thread=sum(g[2] is not None for g in gaps),
            launch_threads=votes,
            idle_s=idle, idle_unattributed_s=unattributed,
            idle_unattributed_pct=span_readings.idle_unattributed_pct(
                gaps, taken),
            idle_by_span=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            offset_spread=spreads,
            device_idle_pct=None if not summary else 100.0 * (
                1.0 - summary["busy_s"] / summary["window_s"]))
        print(json.dumps(out), flush=True)

        cost = []
        g = window.frames[-1].g + 2
        image = next(it)
        for k in range(2 * pairs):
            on = k % 4 in (1, 2)
            if on:
                spans.enable()
            w = session.window(it, image, g, cost_s)
            spans.disable()
            n_spans = len(spans.take())
            cost.append({"recorder": on, "frames": len(w.frames),
                         "fps": len(w.frames) / w.window_s,
                         "spans_per_frame": n_spans / max(len(w.frames), 1)})
            print(json.dumps({"mode": "spans_cost", "workload": workload,
                              **cost[-1]}), flush=True)
            g = w.frames[-1].g + 2
            image = next(it)
        session.drain()
        it.close()
        session.close()
        sync()
        site_off = _span_site_us(spans)
        spans.enable()
        site_on = _span_site_us(spans)
        spans.disable()
        spans.take()
        fps = {v: [c["fps"] for c in cost if c["recorder"] == v]
               for v in (False, True)}
        # off, on, on, off: a drift linear in time cancels in each block
        blocks = [(cost[b + 1]["fps"] + cost[b + 2]["fps"])
                  / (cost[b]["fps"] + cost[b + 3]["fps"])
                  for b in range(0, len(cost) - 3, 4)]
        print(json.dumps({
            "mode": "spans_cost_summary", "workload": workload, "card": card,
            "site_us_off": site_off, "site_us_on": site_on,
            "fps_off": fps[False], "fps_on": fps[True],
            "on_over_off_by_block": blocks,
            "on_over_off": (statistics.median(fps[True])
                            / statistics.median(fps[False]))
            if pairs else None}), flush=True)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this run needs a "
              "CUDA card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["e2e"] and len(sys.argv) == 3:
        return e2e(sys.argv[2])
    if sys.argv[1:2] == ["kernels"] and len(sys.argv) == 3:
        return kernels_mode(sys.argv[2])
    if sys.argv[1:2] == ["kernels"] and len(sys.argv) == 4:
        return side_by_side(sys.argv[2:4])
    if sys.argv[1:2] == ["kernels"] and sys.argv[3:4] == ["--dump"]:
        return kernels_mode(sys.argv[2], sys.argv[4])
    if sys.argv[1:2] == ["speculation"] and len(sys.argv) == 3:
        return speculation_mode(sys.argv[2])
    if sys.argv[1:2] == ["xla"] and len(sys.argv) == 3:
        return xla_mode(sys.argv[2])
    if sys.argv[1:2] == ["spans"] and 4 <= len(sys.argv) <= 7:
        return spans_mode(sys.argv[2], int(sys.argv[3]),
                          *(float(a) for a in sys.argv[4:5]),
                          *(int(a) for a in sys.argv[5:6]),
                          *(float(a) for a in sys.argv[6:7]))
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
