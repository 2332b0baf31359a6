"""The ETH3D camera (CAMERA_PRESETS["ETH3D_1"], 739x458: neither side a
multiple of the selector's 32-pixel blocks, odd pyramid levels) through the
port's normal path on the CPU, against the benchmark's float64 plain
reference (benchmark/reference/frontend.py): the host frontend's cloud on
seeded renders (benchmark/render.py), bit for bit, at 185x115 and at the
full size; the eth3d-pallas.track cell at 185x115 through the harness's
own run_cell, `correct` under the CPU tests' limits; the frontend's
counters of the points chosen and cut by the cloud's capacity, on the host
cloud and the device frontend; and their span attributes, which cost no
allocation while the span recorder is off."""

import dataclasses
import os
import tracemalloc
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark import check, render, run, spec
from benchmark.reference import frontend as ref_frontend
from benchmark.tests.util import SEED, SMALL, small_limits
from cvo_slam_tpu_torch import spans
from cvo_slam_tpu_torch.app import run_slam
from cvo_slam_tpu_torch.config import (CAMERA_PRESETS, CameraConfig,
                                       FrontendParams, SlamConfig)
from cvo_slam_tpu_torch.data import tum
from cvo_slam_tpu_torch.data.prefetch import FramePrefetcher
from cvo_slam_tpu_torch.frontend import device as tdev
from cvo_slam_tpu_torch.frontend import native
from cvo_slam_tpu_torch.frontend.pointcloud import (create_pointcloud,
                                                    span_attrs)

torch.set_num_threads(2)
CELL = "eth3d-pallas.track"
ETH = CAMERA_PRESETS["ETH3D_1"]
SMALL_FP = FrontendParams(num_want=375, cloud_capacity=384)


def _scaled(w: int, h: int) -> CameraConfig:
    """ETH3D_1 at w x h, its intrinsics scaled with the width."""
    s = w / ETH.width
    return dataclasses.replace(ETH, fx=ETH.fx * s, fy=ETH.fy * s,
                               cx=ETH.cx * s, cy=ETH.cy * s, width=w,
                               height=h)


SIZES = {"185x115": (_scaled(185, 115), SMALL_FP, 4),
         "739x458": (ETH, FrontendParams(), 2)}


@pytest.fixture(scope="module", params=sorted(SIZES))
def lap(request, tmp_path_factory):
    """(camera, frontend settings, folder of PNGs, frames) of the track
    mix's first frames rendered at the size from the benchmark's seed."""
    cam, fp, n = SIZES[request.param]
    traffic = spec.load_cell(CELL).traffic
    traffic["trajectory"] = dict(traffic["trajectory"], frames=n)
    frames = render.render_lap(dataclasses.asdict(cam), traffic, SEED, "cpu")
    folder = str(tmp_path_factory.mktemp(f"eth3d_{request.param}"))
    render.write_lap(folder, frames)
    return cam, fp, folder, len(frames)


def _record(k: int) -> tum.FrameRecord:
    return tum.FrameRecord(f"{k}", *render.frame_paths(k))


@pytest.mark.parametrize("selector", ["native", "numpy"])
def test_host_cloud_is_the_reference_cloud(lap, selector, monkeypatch):
    """The port's create_pointcloud (its native selector, and its NumPy
    path) on each rendered frame gives the plain reference's cloud bit for
    bit: positions, features, selected pixels, mask and count."""
    cam, fp, folder, n = lap
    if selector == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("no C++ toolchain for the native selector")
    for k in range(n):
        img = tum.load_image(folder, _record(k))
        assert img.gray.shape == (cam.height, cam.width)
        pc = create_pointcloud(img.bgr, img.gray, img.depth, cam, fp)
        rgb, dep = render.frame_paths(k)
        bgr, gray, depth = ref_frontend.load_frame(
            os.path.join(folder, rgb), os.path.join(folder, dep))
        want = ref_frontend.create_pointcloud(
            bgr, gray, depth, dataclasses.asdict(cam), dataclasses.asdict(fp))
        pos, feat, mask, count, pix = want
        assert pc.count == count > 0.75 * fp.num_want
        assert check.cloud_mismatch(pc, want) == 0
        np.testing.assert_array_equal(pc.mask, mask)
        np.testing.assert_array_equal(pc.selected_pixels, pix)
        np.testing.assert_array_equal(pc.positions, pos)
        np.testing.assert_array_equal(pc.features, feat)


def test_cell_at_a_ragged_size_is_correct():
    """The eth3d-pallas.track cell at 185x115 (scaled intrinsics, num_want
    375, CAP 384) through benchmark.run.run_cell on the CPU: the port's
    plain kernels, frames streamed through FramePrefetcher into
    KeyframeTracker.update, `correct` under the CPU tests' limits."""
    cell = spec.load_cell(CELL)
    cam = _scaled(185, 115)
    ov = {"camera": {k: getattr(cam, k) for k in ("fx", "fy", "cx", "cy",
                                                  "width", "height")},
          "frontend": {"num_want": 375, "cloud_capacity": 384}}
    # run_cell sets CVO_SLAM_BACKEND and pops the port's knobs: the test
    # process's other tests get the environment back as it was
    with mock.patch.dict(os.environ):
        res = run.run_cell(cell, SEED, 4.0, True, "cpu", overrides=ov,
                           limits=small_limits(cell))
    assert res["correct"], res["check"]
    assert res["check"]["cloud_mismatch"]["value"] == 0
    assert res["check"]["decision_mismatch"]["value"] == 0
    assert res["check"]["kf_gap"]["limit"] == SMALL["kf_gap"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def _frame(cam, fp, folder, k=0):
    img = tum.load_image(folder, _record(k))
    return img, create_pointcloud(img.bgr, img.gray, img.depth, cam, fp)


def test_selected_less_dropped_is_the_count(lap):
    """n_selected - n_dropped == count on the host cloud and on the device
    frontend, which agree; a capacity below the selector's output drops
    the difference, and the default capacity drops nothing here."""
    cam, fp, folder, _ = lap
    img, pc = _frame(cam, fp, folder)
    assert isinstance(pc.n_selected, int) and isinstance(pc.n_dropped, int)
    assert pc.n_dropped == 0 and pc.n_selected == pc.count
    cut = dataclasses.replace(fp, cloud_capacity=pc.count // 2)
    small = create_pointcloud(img.bgr, img.gray, img.depth, cam, cut)
    assert small.count == cut.cloud_capacity
    assert small.n_selected == pc.n_selected
    assert small.n_dropped == pc.n_selected - cut.cloud_capacity > 0
    for want, f in ((pc, fp), (small, cut)):
        got = tdev.create_pointcloud_device(img.bgr, img.gray, img.depth,
                                            cam, f, device="cpu")
        count, n_selected, n_dropped = (int(got[k]) for k in (3, 5, 6))
        assert count == want.count
        assert n_selected == want.n_selected
        assert n_dropped == want.n_dropped
        assert n_selected - n_dropped == count


def test_frontend_spans_carry_the_counters(lap):
    """With the recorder on, `prefetch.load` (pool worker) and
    `frontend.cloud` (the tracker's thread) carry the frame's h and w and
    the cloud's selected and dropped counts."""
    cam, fp, folder, n = lap
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True,
                                               frontend=fp)
    tracker = run_slam.build_tracker(cam, cfg, device="cpu")
    assert spans.take() == []
    spans.enable()
    try:
        images = list(FramePrefetcher(folder, [_record(k) for k in range(n)],
                                      cam, fp))
        for img in images:
            tracker.lt._make_cloud(img)
    finally:
        spans.disable()
    taken = spans.take()
    for name in ("prefetch.load", "frontend.cloud"):
        got = [s for s in taken if s.name == name]
        assert len(got) == n
        for s, img in zip(sorted(got, key=lambda s: s.t0), images):
            pc = img.precomputed_cloud
            assert s.attrs == {"h": cam.height, "w": cam.width,
                               "selected": pc.n_selected,
                               "dropped": pc.n_dropped}


def test_counters_cost_nothing_with_spans_off(lap):
    """With the recorder off a frontend span site gets the shared NULL, and
    its attributes add no allocation to the bare site's (tracemalloc over
    10000 calls of each: net and peak bytes alike); a prefetched stream
    records no span."""
    cam, fp, folder, n = lap
    img, pc = _frame(cam, fp, folder)
    shape = img.gray.shape
    assert not spans.ENABLED
    sp = spans.span("prefetch.load", 0)
    assert sp is spans.NULL
    span_attrs(sp, pc, shape)

    def bare():
        with spans.span("frontend.cloud"):
            pass

    def site():
        with spans.span("frontend.cloud") as s:
            span_attrs(s, pc, shape)

    def growth(fn):
        """(net, peak) bytes over 10000 calls of fn."""
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in range(10000):
            fn()
        after, peak = tracemalloc.get_traced_memory()
        return after - before, peak - before

    tracemalloc.start()
    try:
        growth(bare), growth(site)
        without, with_attrs = growth(bare), growth(site)
    finally:
        tracemalloc.stop()
    assert with_attrs == without, (with_attrs, without)
    assert not hasattr(spans.NULL, "__dict__")
    list(FramePrefetcher(folder, [_record(k) for k in range(n)], cam, fp))
    assert spans.take() == []
