"""A run of the port's benchmark leaves nothing running: in a process of its
own session, a small CPU run of a `track` cell through the benchmark's
run_cell (traced, and untraced), then a KeyframeTracker over a few frames
with speculative dispatch (its `speculative-frame` worker) and the span
recorder on. The process must leave no non-daemon thread behind when
run_cell returns, exit within EXIT_S of its last line, and leave nothing in
its process group."""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXIT_S = 60.0        # from the child's last line to its exit
RUN_S = 600.0        # the child's whole run

CHILD = r"""
import json, os, sys, tempfile, threading

import torch
torch.set_num_threads(2)
from benchmark import run
from benchmark.tests.util import SEED, small_cell, small_limits

trace = bool(int(sys.argv[1]))
cell, ov = small_cell("tum_fr1-pallas_mom.track")
res = run.run_cell(cell, SEED, 2.0, trace, "cpu", overrides=ov,
                   limits=small_limits(cell))
left = [t.name for t in threading.enumerate()
        if t is not threading.main_thread() and not t.daemon]
print(json.dumps({"run_cell": res["correct"], "threads": left}), flush=True)

os.environ["CVO_SLAM_SPECULATE"] = "1"
from cvo_slam_tpu_torch import spans
from cvo_slam_tpu_torch.app import run_slam
from cvo_slam_tpu_torch.config import CameraConfig, FrontendParams, SlamConfig
from cvo_slam_tpu_torch.data import synthetic, tum

cam = CameraConfig(fx=130.0, fy=130.0, cx=80.0, cy=60.0,
                   depth_factor=5000.0, width=160, height=120)
cfg = SlamConfig.default_shipped().replace(
    OnlyTracking=True, frontend=FrontendParams(num_want=300,
                                               cloud_capacity=384))
with tempfile.TemporaryDirectory() as folder:
    synthetic.make_sequence(folder, cam, n_frames=4)
    images = [tum.load_image(folder, r) for r in
              tum.load_association(os.path.join(folder, "associate.txt"))]
tracker = run_slam.build_tracker(cam, cfg, device="cpu")
tracker.init()
spans.enable()
for i, img in enumerate(images):
    tracker.update(img, next_frame=images[i + 1] if i + 1 < len(images)
                   else None)
spans.disable()
names = {s.thread.split("_")[0] for s in spans.take()}
print(json.dumps({"hits": tracker.lt.executor.hits,
                  "threads": sorted(names)}), flush=True)
"""


def _group_alive(pgid: int) -> bool:
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("trace", [1, 0])
def test_run_leaves_nothing_running(trace, tmp_path):
    err = open(tmp_path / "stderr.txt", "w+")
    proc = subprocess.Popen([sys.executable, "-c", CHILD, str(trace)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=err,
                            text=True, start_new_session=True)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append((time.monotonic(), line))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + RUN_S
        while len(lines) < 2 and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        if len(lines) == 2:
            try:
                proc.wait(timeout=max(0.0, lines[-1][0] + EXIT_S
                                      - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        exited = proc.poll() is not None
        left = _group_alive(proc.pid) if exited else True
    finally:
        if _group_alive(proc.pid):
            os.killpg(proc.pid, 9)
        proc.wait()
        reader.join(timeout=10)
        err.seek(0)
        tail = err.read()[-4000:]
        err.close()
    assert len(lines) == 2, (lines, tail)
    assert exited, f"no exit within {EXIT_S} s of the last line"
    assert proc.returncode == 0, tail
    assert not left, "a process of the run's group outlived it"
    first = json.loads(lines[0][1])
    assert first == {"run_cell": True, "threads": []}, first
    second = json.loads(lines[1][1])
    assert second["hits"] >= 1
    assert "speculative-frame" in second["threads"]
