#!/usr/bin/env python3
"""Same-call comparisons on one GPU, beside chip_smoke.py's own numbers.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 chip_compare.py e2e ROOT
    python3 chip_compare.py kernels ROOT [ROOT2]
    python3 chip_compare.py speculation ROOT

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
a last line sets their one-lane align_fused and suite side by side:
whether each tree's outputs on chip_smoke's frame pairs 0 -> 1 .. 5 -> 6
(align_fused from the identity at ell 0.15) and on frames 0 -> 1 (the
suite, both ells) are bitwise equal to the other's, and each tree's
device us per align_fused iteration (frames 0 -> 1) and suite device ms.

speculation: chip_smoke's tracking phase (16 frames; pallas_iter 8) on
each backend with CVO_SLAM_SPECULATE=0, 1, 1, 0 in turns: ms/frame and the
speculation's hits, misses and discards per run, and whether the runs of a
backend wrote the same trajectory, line for line.

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
    """The one-lane align_fused outputs on chip_smoke's frame pairs and the
    suite's on frames 0 -> 1 at each of chip_smoke's ells, as host arrays
    by name."""
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
    return out


def side_by_side(roots) -> int:
    """kernels_mode of each root in a process of its own, then the S = 1
    align_fused and suite of the roots side by side."""
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
        print(f"one-lane align_fused and suite, {roots[0]} against "
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
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
