"""Helpers of the benchmark's own tests: cells at a small size on the
CPU (the port's plain versions of its kernels), through the harness's own
code."""

from __future__ import annotations

import copy
import json
import os

from benchmark import spec

ROOT = spec.ROOT
SEED = 2 ** 31 + 17          # above 32 signed bits, as the driver's are
SCALE = 0.25                 # 160 x 120 frames


def small_overrides(cell):
    """The CPU tests' sizes: a 160x120 camera (intrinsics scaled with it),
    384 cloud slots; for the SLAM backend the keyframe settings that make a
    short run reach loop closure at that size (tests/test_torch_slam.py's),
    and a 24-frame lap."""
    cam = cell.config["camera"]
    ov = {"camera": {"fx": cam["fx"] * SCALE, "fy": cam["fy"] * SCALE,
                     "cx": cam["cx"] * SCALE, "cy": cam["cy"] * SCALE,
                     "width": 160, "height": 120},
          "frontend": {"num_want": 375, "cloud_capacity": 384}}
    if not cell.traffic["tracking_only"]:
        ov["slam"] = {"Max_KF_interval": 3, "Min_KF_interval": 0,
                      "LC_MinMatch": 10}
        cell.traffic = copy.deepcopy(cell.traffic)
        cell.traffic["trajectory"]["frames"] = 24
    return ov


def cell_names():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


# The limits at the CPU tests' size (160x120, 384 slots), from CPU runs of
# this size: sound runs read kf_gap 1e-5 to 5e-4 and inner-product gaps up
# to 1.1e-2 (few points, so one pair flipping across the gate's edge, where
# the kernel is 0.8 of its peak, moves the sum by a percent); the control
# reads kf_gap 4e-2 and ip_rel_gap 0.14 there. The other numbers keep the
# cells' limits.
SMALL = {"kf_gap": 0.005, "ip_rel_gap": 0.04, "lc_ip_rel_gap": 0.04}


def small_limits(cell, root=ROOT):
    with open(os.path.join(root, "benchmark", "limits",
                           f"{cell.name}.json")) as f:
        limits = json.load(f)["limits"]
    return {k: SMALL.get(k, v) for k, v in limits.items()}


def small_cell(name, root=ROOT):
    """(cell, overrides) of a cell of root/BENCHMARK.json at the CPU
    tests' size."""
    cell = spec.load_cell(name, root)
    return cell, small_overrides(cell)


def window_seconds(cell) -> float:
    """A CPU test's window: long enough for a few tracked frames (~2 s
    each at this size on the CPU, so that a p95 exists) and, with the SLAM
    backend, for the keyframe events whose loop closures and BA the check
    samples."""
    return 8.0 if cell.traffic["tracking_only"] else 20.0
