"""Every per-layer metric reader of BENCHMARK.json on a recorded sample,
and the trace reader on a recorded chrome trace."""

from __future__ import annotations

import json
import math
import os

import pytest
import torch

from benchmark import counts, harness, spec, trace

from .util import ROOT

CVO = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                  "tum_fr1-pallas.json")))["cvo"]


def _frame(g, wait, odo, kf):
    return harness.FrameRec(g=g, lap_k=g, latency_s=0.05, wait_s=wait,
                            odo_iters=odo, kf_iters=kf, accept=1,
                            nan_moved=False)


def _clouds(n=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(n, 3, generator=gen) * 0.3 + torch.tensor([0, 0, 2.0])
    f = torch.rand(n, 5, generator=gen) * 50
    m = torch.ones(n, dtype=torch.bool)
    return x, f, m


K = "void (anonymous namespace)::"


def _window():
    x, fx, mx = _clouds(seed=1)
    y, fy, my = _clouds(seed=2)
    U = torch.zeros(64, 35)
    calls = {
        "moment_flow_step": [trace.Call("moment_flow_step",
                                        (x, y, fx, fy, mx, my, U,
                                         torch.zeros(3), 0.15), None, 0, 1)],
        "ip_suite": [trace.Call("ip_suite", (x, fx, mx, y, fy, my, y, 0.15),
                                None, 0, 1),
                     trace.Call("ip_suite", (x, fx, mx, y, fy, my, y, 0.15),
                                None, 2, 3)],
        "align_fused": [trace.Call(
            "align_fused", (x, fx, mx, y, fy, my, torch.eye(3),
                            torch.zeros(3), torch.tensor(0.15)),
            (None, None, None, torch.tensor(3), None), 0, 1)],
    }
    w = harness.Window(frames=[_frame(0, 0.001, 10, 12),
                               _frame(1, 0.003, 14, 20)],
                       window_s=0.2, failed=0,
                       events=[{"insert": 300.0, "loop_detect": 900.0,
                                "windowed_ba": 1500.0}, {"insert": 100.0}],
                       verifies=[], kernel_calls=calls)
    w.trace = {"busy_s": 0.01, "window_s": 0.2, "frames": 2,
               "launches": 6000, "breakdown": {},
               "port_kernels": [(0.4, K + "moment_keep_pass<0>()", 1e-5),
                                (0.5, K + "align_kernel<false>()", 1e-4),
                                (0.5, K + "suite_sweep<false>()", 6e-5),
                                (0.6, K + "moment_sum_pass()", 1e-5)]}
    return w


EXPECTED = {
    "frontend_wait_ms": 2.0,
    "align_iters_per_frame": 28.0,
    "launches_per_frame": 3000.0,
    "kf_event_ms": 1400.0,
    "device_idle_pct": 95.0,
}


def per_layer_names():
    return [m["name"] for m in json.load(open(os.path.join(
        ROOT, "BENCHMARK.json")))["per_layer"]]


@pytest.mark.parametrize("name", per_layer_names())
def test_reader_on_recorded_sample(name):
    read = spec.load_reader(name)
    value = read(_window(), CVO)
    assert value is not None and math.isfinite(value) and value > 0
    if name in EXPECTED:
        assert value == pytest.approx(EXPECTED[name])
    if name.startswith("roofline_pct."):
        assert value <= 100.0


@pytest.mark.parametrize("name", per_layer_names())
def test_reader_with_nothing_to_read(name):
    w = harness.Window(frames=[], window_s=0.0, failed=0, events=[],
                       verifies=[])
    assert spec.load_reader(name)(w, CVO) is None


def test_counts_are_those_of_the_inputs():
    """The pair counts follow the gates: a moving cloud moved out of reach
    leaves only the gate test of every valid pair."""
    x, fx, mx = _clouds(seed=1)
    y, fy, my = _clouds(seed=2)
    ops_near, nbytes = counts.moment_flow_step(
        (x, y, fx, fy, mx, my, torch.zeros(64, 35), torch.zeros(3), 0.15),
        CVO)
    far = y + 10.0
    ops_far, _ = counts.moment_flow_step(
        (x, far, fx, fy, mx, my, torch.zeros(64, 35), torch.zeros(3), 0.15),
        CVO)
    assert ops_far == 9 * 64 * 64 < ops_near
    assert nbytes == 2 * 64 * 33 + 64 * 35 * 4 + 12 + 4 + 44
    t, what = counts.least_seconds(67e12, 0)
    assert t == pytest.approx(1.0) and what == "operations"


def _recorded_trace():
    """A chrome trace as torch.profiler writes it: two frames, three
    launches (one on a worker thread), their kernels; the third kernel
    lost."""
    ev = [
        {"cat": "user_annotation", "name": "bench.frame", "ts": 1000.0,
         "dur": 100.0, "tid": 1},
        {"cat": "user_annotation", "name": "bench.update", "ts": 1010.0,
         "dur": 80.0, "tid": 1},
        {"cat": "user_annotation", "name": "bench.frame", "ts": 1100.0,
         "dur": 100.0, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1020.0,
         "dur": 5.0, "tid": 1, "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "name": "cudaLaunchCooperativeKernel",
         "ts": 1030.0, "dur": 5.0, "tid": 2, "args": {"correlation": 8}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1150.0,
         "dur": 5.0, "tid": 1, "args": {"correlation": 9}},
        {"cat": "kernel", "name": K + "suite_sweep<false>()", "ts": 1040.0,
         "dur": 20.0, "args": {"correlation": 7}},
        {"cat": "kernel", "name": K + "align_kernel<false>()", "ts": 1050.0,
         "dur": 30.0, "args": {"correlation": 8}},
    ]
    return ev


def test_trace_session_reading():
    r = trace._read_session(_recorded_trace(), [(0.0, 0.0001),
                                                (0.0001, 0.0002)])
    assert r["launch"] == 3 and r["lost"] == 1 and r["gpu"] == 2
    assert r["window_s"] == pytest.approx(200e-6)
    assert r["busy_s"] == pytest.approx(40e-6)    # [1040, 1080]
    assert sum(r["gaps"].values()) == pytest.approx(160e-6)
    # launches on the harness's clock: frame 0 started at trace time 1000
    assert [(pytest.approx(t), d) for t, _, d in r["port_kernels"]] == [
        (pytest.approx(20e-6), 20e-6), (pytest.approx(30e-6), 30e-6)]


def test_calls_get_their_own_kernels():
    port = [(1.0, K + "align_kernel<false>()", 3e-4),
            (1.1, K + "suite_sweep<false>()", 5e-5),
            (2.0, K + "align_kernel<false>()", 4e-4),
            (2.1, K + "align_kernel<false>()", 1e-4)]
    a = trace.Call("align_fused", (), None, 0.9, 1.2)
    b = trace.Call("align_fused", (), None, 1.95, 2.05)   # overlaps c
    c = trace.Call("align_fused", (), None, 2.04, 2.2)
    d = trace.Call("align_fused", (), None, 3.0, 3.1)     # launched none
    trace.match_calls([a, b, c, d], port, ("align_kernel",))
    assert a.device_s == pytest.approx(3e-4)
    assert b.device_s is None and c.device_s is None and d.device_s is None
