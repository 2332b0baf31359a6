"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control]

from the root of a checkout. A run renders the cell's lap of frames on the
card from the seed, writes them as TUM PNGs under $TMPDIR, builds the
port's tracker as its CLI does (app/run_slam.build_tracker, the
configuration file's camera, SLAM and CVO settings, the align backend
through CVO_SLAM_BACKEND), warms up on the traffic's first frames, then
streams frames for --seconds through the port's FramePrefetcher into
KeyframeTracker.update, one frame of lookahead, the lap replayed over and
over. After the window it judges the window's answers against the plain
reference (benchmark/check.py) and prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device
(and breakdown with --trace 1), and last `check`, each compared number
beside its limit, which also ends standard error.

--control puts the reference one precision down in the program's place
(benchmark/check.py) and prints its numbers; the benchmark's own runs never
pass it.

Exits 2 without a result when CUDA is absent or has fewer cards than the
cell asks for, and 3 when a JAX module is loaded once the window closes.
"""

import time

T_START = time.perf_counter()

import argparse       # noqa: E402
import gc             # noqa: E402
import json           # noqa: E402
import math           # noqa: E402
import os             # noqa: E402
import shutil         # noqa: E402
import statistics     # noqa: E402
import sys            # noqa: E402
import tempfile       # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cvo_slam_tpu")
# environment knobs of the port that the cells run at their defaults
PORT_KNOBS = ("CVO_SLAM_SPECULATE", "CVO_SLAM_NATIVE", "CVO_SLAM_DEV_MATCH")


def forbidden_modules(names=None):
    """Loaded modules (or `names`) whose top-level name, compared whole, is
    a JAX package's or the JAX package's (the port, cvo_slam_tpu_torch, is
    not)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _limits(cell_name: str, root: str) -> dict:
    with open(os.path.join(root, "benchmark", "limits",
                           f"{cell_name}.json")) as f:
        return json.load(f)["limits"]


def end_to_end(window, setup_s: float, names) -> dict:
    lat = sorted(f.latency_s for f in window.frames)
    values = {"setup_s": (setup_s, "s")}
    if lat:
        values["fps"] = (len(lat) / window.window_s, "frames/s")
        values["frame_ms_p50"] = (statistics.median(lat) * 1e3, "ms")
        if len(lat) >= 2:
            values["frame_ms_p95"] = (
                statistics.quantiles(lat, n=20, method="inclusive")[18]
                * 1e3, "ms")
    return {n: {"value": values[n][0], "unit": values[n][1]}
            for n in names if n in values}


def _json_number(v):
    """A number for the result line; one that is not finite as a string."""
    return v if math.isfinite(v) else repr(float(v))


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             overrides: dict = None, control: bool = False,
             root: str = None, t_start: float = None,
             limits: dict = None) -> dict:
    """One run of `cell` (benchmark.spec.Cell) on `device`; returns the
    result object (the last line's). `overrides` and `limits` give the CPU
    tests' small sizes and the limits measured at them (by default the
    cell's limits file, benchmark/limits/<cell>.json)."""
    import torch
    from . import check, harness, spec, trace as trace_mod

    root = root or spec.ROOT
    t_start = T_START if t_start is None else t_start
    device = torch.device(device)
    for k in PORT_KNOBS:
        os.environ.pop(k, None)
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
    import cvo_slam_tpu_torch.app.run_slam  # noqa: F401
    parts = {"imports_context_s": time.perf_counter() - t_start}

    folder = tempfile.mkdtemp(prefix="cvo-bench-frames-")
    try:
        session = harness.Session(cell, seed, device, folder, overrides)
        parts.update(session.parts)
        check_spec = cell.traffic["check"]
        t0 = time.perf_counter()
        warm = cell.traffic["warmup"].get("frames", 0) or 3 * session.lap
        it = session.stream(warm + int(seconds * 200) + 64)
        image, g = next(it), 0
        image, g = session.warm_up(it, image, g)
        if device.type == "cuda":
            torch.cuda.synchronize()
        tracer = trace_mod.Tracer(device, cell, folder) if trace else None
        if tracer is not None:
            tracer.warm()
        gc.collect()
        parts["warmup_s"] = time.perf_counter() - t0
        setup_s = time.perf_counter() - t_start

        if tracer is not None:
            tracer.start()
        window = session.window(it, image, g, seconds,
                                tracer.profiler if tracer else None,
                                tracer.stopped if tracer else None)
        session.drain()
        it.close()
        session.ba_to_host(window)
        memory_peak = (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)
        cvo = cell.config["cvo"]
        if tracer is not None:
            t0 = time.perf_counter()
            window.trace, window.kernel_calls = tracer.read()
            print(f"trace read in {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr)
            metrics = {}
            for m in cell.per_layer:
                value = cell.readers[m["name"]](window, cvo)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
                else:
                    print(f"metric {m['name']}: nothing to read",
                          file=sys.stderr)
        else:
            metrics = end_to_end(window, setup_s,
                                 [m["name"] for m in cell.end_to_end])
        session.close()
        cam, slam, fp = harness.settings(session.cam, session.cfg)
        del session
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = check.check(window, folder, cam, fp, cvo, slam,
                              check_spec, seed, device,
                              "control" if control else "program")
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    correct, rows = check.judge(numbers, limits or _limits(cell.name, root))
    failed = window.failed + sum(f.nan_moved for f in window.frames)
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(memory_peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": bool(correct),
              "attempted": len(window.frames) + window.failed,
              "failed": int(failed), "metrics": metrics, "device": dev}
    if window.trace is not None:
        dev["busy_s"] = window.trace["busy_s"]
        dev["window_s"] = window.trace["window_s"]
        result["breakdown"] = window.trace["breakdown"]
    result["setup_parts"] = parts
    compared = {n for n, _, _ in rows}
    result["readings"] = {k: v for k, v in numbers.items()
                          if k not in compared}
    result["check"] = {name: {"value": _json_number(v), "limit": lim}
                       for name, v, lim in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    from . import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.chips} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"setup_parts": result.pop("setup_parts"),
                      "readings": result.pop("readings")}),
          file=sys.stderr)
    for name, row in result["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
