"""The port's span recorder (cvo_slam_tpu_torch/spans.py) on the CPU: the
whole SLAM system on tests/test_torch_slam.py's out-and-back walk with
speculative frame dispatch on (CVO_SLAM_SPECULATE=1, so the
`speculative-frame` worker runs) and the loop-closure verifications on
their `lc-verify` worker, the recorder on; the timers the spans share
their clock readings with; the recorder off; the spans in run_slam's
profile trace; and the readings of eval/span_readings.py."""

import json
import os
import threading

import pytest
import torch

from cvo_slam_tpu_torch import spans
from cvo_slam_tpu_torch.app import run_slam as trun
from cvo_slam_tpu_torch.config import from_reference
from cvo_slam_tpu_torch.data import synthetic, tum
from cvo_slam_tpu_torch.eval import span_readings
from test_torch_runloop import SMALL_CFG
from test_torch_slam import CAM, _loop_trajectory

torch.set_num_threads(2)


def _track(folder, cfg, recorder: bool):
    """The run loop's frame by frame updates with one frame of lookahead;
    returns (tracker, spans taken)."""
    tracker = trun.build_tracker(from_reference(CAM), cfg, device="cpu")
    tracker.init()
    records = tum.load_association(os.path.join(folder, "associate.txt"))
    images = [tum.load_image(folder, r) for r in records]
    assert spans.take() == []
    if recorder:
        spans.enable()
    try:
        for i, img in enumerate(images):
            if i == len(images) - 1:
                tracker.force_keyframe()
            tracker.update(img, next_frame=images[i + 1]
                           if i + 1 < len(images) else None)
        tracker.lt.executor._discard()
    finally:
        spans.disable()
    return tracker, spans.take()


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("spans") / "walk")
    synthetic.make_sequence(folder, from_reference(CAM),
                            trajectory=_loop_trajectory())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CVO_SLAM_SPECULATE", "1")
        tracker, taken = _track(folder, SMALL_CFG, recorder=True)
    return tracker, taken


def _named(taken, name):
    return [s for s in taken if s.name == name]


def test_every_layer_records(walk):
    """Each span of the port's layers appears on its thread."""
    _, taken = walk
    threads = {}
    for s in taken:
        threads.setdefault(s.name, set()).add(s.thread.split("_")[0])
    main = {"MainThread"}
    assert threads["tracker.update"] == main
    assert threads["tracker.frame_step"] == main
    assert threads["tracker.decide"] == main
    assert threads["tracker.spec_wait"] == main
    assert threads["frontend.cloud"] == main
    assert threads["tracker.speculate"] == {"speculative-frame"}
    assert threads["lc.verify"] == {"lc-verify"}
    assert threads["align"] == {"MainThread", "speculative-frame",
                                "lc-verify"}
    assert {"MainThread", "speculative-frame"} <= threads["device.read"]
    assert threads["innerproduct"] == threads["align"]
    for name in ("backend.event", "backend.insert", "backend.loop_detect",
                 "backend.windowed_ba", "backend.final_ba", "lc.refresh",
                 "lc.score", "lc.ransac", "lc.verify_wait", "features.orb"):
        assert threads[name] == main, name


def test_spans_nest_within_parent(walk):
    """A span lies inside the span that held it open, on its thread; the
    spans of one thread nest or follow one another."""
    _, taken = walk
    with_parent = [s for s in taken if s.parent is not None]
    assert len(with_parent) > len(taken) // 2
    for s in with_parent:
        p = s.parent
        assert p.thread == s.thread and p.tid == s.tid
        assert p.t0 <= s.t0 <= s.t1 <= p.t1, (s, p)
        assert s.frame == p.frame
    by_thread = {}
    for s in taken:
        by_thread.setdefault(s.tid, []).append(s)
    for same in by_thread.values():
        same.sort(key=lambda s: (s.t0, -s.t1))
        for a, b in zip(same, same[1:]):
            assert b.t0 >= a.t1 or b.t1 <= a.t1, (a, b)


def test_speculation_names_its_cause(walk):
    """Each speculation serves frame i + 1 and names frame i's
    tracker.frame_step, whose spans' hits and misses are the executor's
    counters."""
    tracker, taken = walk
    spec = _named(taken, "tracker.speculate")
    assert len(spec) >= 3
    for s in spec:
        assert s.cause.name == "tracker.frame_step"
        assert s.cause.thread == "MainThread"
        assert s.frame == s.cause.frame + 1
        assert s.parent is None and s.cause.t0 <= s.t0
    steps = _named(taken, "tracker.frame_step")
    outcomes = [s.attrs["spec"] for s in steps]
    ex = tracker.lt.executor
    assert outcomes.count("hit") == ex.hits >= 1
    assert outcomes.count("miss") == ex.misses >= 1
    waits = _named(taken, "tracker.spec_wait")
    assert sum(not s.attrs["discarded"] for s in waits) == ex.hits
    assert sum(s.attrs["discarded"] for s in waits) == ex.discards
    updates = _named(taken, "tracker.update")
    assert [s.frame for s in updates] == list(range(len(updates)))


def test_timers_equal_their_spans(walk):
    """graph.stage_ms and lc_stage_ms are the durations of their spans to
    the last bit (one pair of clock readings makes both); the ORB hook's
    last_ms is its last span's."""
    tracker, taken = walk
    graph = tracker.graph
    events = _named(taken, "backend.event")
    assert len(events) == len(graph.stage_ms) >= 3
    for event, row in zip(events, graph.stage_ms):
        stages = [s for s in taken if s.parent is event]
        for key, ms in row.items():
            total = 0.0
            for s in stages:
                if s.name == f"backend.{key}":
                    total += (s.t1 - s.t0) * 1e3
            assert total == ms, key
    rounds = _named(taken, "backend.loop_detect")
    assert len(rounds) == len(graph.lc_stage_ms) >= 1
    keys = {"refresh": "lc.refresh", "score": "lc.score",
            "ransac": "lc.ransac", "verify": "lc.verify_wait"}
    n_verify = 0
    for round_, row in zip(rounds, graph.lc_stage_ms):
        inside = [s for s in taken if s.parent is round_]
        for key, name in keys.items():
            got, = (s for s in inside if s.name == name)
            assert (got.t1 - got.t0) * 1e3 == row[key]
        verifies = [s for s in taken if s.name == "lc.verify"
                    and s.cause is round_]
        assert len(verifies) == row["n_cands"]
        n_verify += len(verifies)
    assert n_verify >= 1
    orb = _named(taken, "features.orb")[-1]
    hook = tracker.lt.keyframe_feature_hook
    assert (orb.t1 - orb.t0) * 1e3 == hook.last_ms


def test_readings_of_the_walk(walk):
    """eval/span_readings.py on the walk's spans: every reading present,
    within what the spans allow."""
    tracker, taken = walk
    frames = len(_named(taken, "tracker.update"))
    got = span_readings.readings(taken, frames, 100,
                                 tracker.graph.stage_ms)
    assert set(got) == {"cloud_ms", "tracker_self_ms", "spec_wait_ms",
                        "speculation_hit_pct", "align_host_us_per_iter",
                        "readback_ms", "kf_stage_ms.loop_detect",
                        "kf_stage_ms.windowed_ba"}
    assert all(v is not None and v >= 0 for v in got.values()), got
    ex = tracker.lt.executor
    assert got["speculation_hit_pct"] == 100.0 * ex.hits / (ex.hits
                                                            + ex.misses)
    update_ms = 1e3 * sum(s.t1 - s.t0 for s in _named(
        taken, "tracker.update")) / frames
    assert got["tracker_self_ms"] < update_ms
    events = len(_named(taken, "backend.event"))
    for stage in span_readings.KF_STAGES:
        assert got[f"kf_stage_ms.{stage}"] == pytest.approx(1e3 * sum(
            s.t1 - s.t0 for s in _named(taken, f"backend.{stage}")) / events)
    assert span_readings.readings(taken, frames, 100)[
        "kf_stage_ms.loop_detect"] is None


def test_recorder_off_records_nothing(tmp_path, monkeypatch):
    """With the recorder off (the default) a span site gets the shared
    null context, and no thread's list gets a span."""
    monkeypatch.setenv("CVO_SLAM_SPECULATE", "1")
    folder = str(tmp_path / "seq")
    synthetic.make_sequence(folder, from_reference(CAM), n_frames=4)
    assert not spans.ENABLED
    assert spans.span("align") is spans.NULL
    assert spans.current() is None
    tracker, taken = _track(folder, SMALL_CFG.replace(OnlyTracking=True),
                            recorder=False)
    assert tracker.lt.executor.hits >= 1
    assert taken == []
    assert all(not done for _, done in spans._threads)


def test_take_empties_every_thread():
    """take() hands back the spans of every thread once, by start."""
    spans.enable()
    try:
        with spans.span("outer", 7) as outer:
            t = threading.Thread(target=lambda: spans.record(
                "worker", 1.0, 2.0, cause=outer))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    finally:
        spans.disable()
    got = spans.take()
    assert [s.name for s in got] == ["worker", "outer"]
    assert got[0].frame == 7 and got[0].cause is outer
    assert got[0].thread != got[1].thread
    assert spans.take() == []


def test_profile_trace_holds_the_spans(tmp_path):
    """run(profile_dir=) merges the spans of every thread into the
    profiler's trace, on its clock: each tracker.update event lies inside
    its frame's profiler mark (to 0.2 ms), and each align inside a
    tracker.update."""
    folder = str(tmp_path / "seq")
    cam = from_reference(CAM)
    synthetic.make_sequence(folder, cam, n_frames=3)
    prof = str(tmp_path / "prof")
    trun.run(folder, "associate.txt", cam,
             SMALL_CFG.replace(OnlyTracking=True), device="cpu",
             profile_dir=prof)
    assert not spans.ENABLED and spans.take() == []
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    port = [e for e in events if e.get("cat") == "port_span"]
    updates = [e for e in port if e["name"] == "tracker.update"]
    marks = sorted((e for e in events if e.get("name") == trun.FRAME_MARK
                    and e.get("ph") == "X"), key=lambda e: e["ts"])
    assert len(updates) == len(marks) == 3
    for u, m in zip(sorted(updates, key=lambda e: e["ts"]), marks):
        assert u["tid"] == m["tid"]
        assert m["ts"] - 200 <= u["ts"]
        assert u["ts"] + u["dur"] <= m["ts"] + m["dur"] + 200
    aligns = [e for e in port if e["name"] == "align"]
    assert aligns
    for a in aligns:
        assert any(u["ts"] <= a["ts"] and a["ts"] + a["dur"]
                   <= u["ts"] + u["dur"] + 1.0 for u in updates)
    names = {e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert "MainThread" in names


def test_profile_run_that_raises_leaves_the_recorder_off(tmp_path,
                                                         monkeypatch):
    """run(profile_dir=) switches the recorder off and takes its spans
    however the frame loop ends: here the first update raises."""
    folder = str(tmp_path / "seq")
    cam = from_reference(CAM)
    synthetic.make_sequence(folder, cam, n_frames=2)

    def update(self, *args, **kwargs):
        with spans.span("tracker.update"):
            raise RuntimeError("update failed")

    monkeypatch.setattr(trun.KeyframeTracker, "update", update)
    with pytest.raises(RuntimeError, match="update failed"):
        trun.run(folder, "associate.txt", cam,
                 SMALL_CFG.replace(OnlyTracking=True), device="cpu",
                 profile_dir=str(tmp_path / "prof"))
    assert not spans.ENABLED
    assert spans.span("align") is spans.NULL
    assert spans.take() == []


def test_profile_run_leaves_a_callers_recording(tmp_path):
    """A recorder the caller switched on stays on through
    run(profile_dir=), and its spans, the run's included, stay the
    caller's to take: the trace gets none of them."""
    folder = str(tmp_path / "seq")
    cam = from_reference(CAM)
    synthetic.make_sequence(folder, cam, n_frames=2)
    prof = str(tmp_path / "prof")
    spans.enable()
    try:
        with spans.span("caller"):
            pass
        trun.run(folder, "associate.txt", cam,
                 SMALL_CFG.replace(OnlyTracking=True), device="cpu",
                 profile_dir=prof)
        assert spans.ENABLED
    finally:
        spans.disable()
        taken = spans.take()
    names = [s.name for s in taken]
    assert "caller" in names and names.count("tracker.update") == 2
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert not [e for e in events if e.get("cat") == "port_span"]


def test_idle_by_span():
    """A gap goes to the innermost span, at its midpoint, of the thread that
    launched the work ending it, or, where that thread waits or is not
    known, to the shortest non-wait span of another thread; a gap under no
    such span, or ended by a thread outside every span, is left
    unattributed."""
    class S:
        def __init__(self, name, t0, t1, tid):
            self.name, self.t0, self.t1, self.tid = name, t0, t1, tid

    taken = [S("tracker.update", 0.0, 10.0, 1), S("align", 1.0, 3.0, 2),
             S("tracker.spec_wait", 4.0, 6.0, 1),
             S("tracker.speculate", 4.5, 5.5, 2)]
    gaps = [(1.5, 2.5), (4.0, 4.2), (4.8, 5.2), (11.0, 12.0),
            (4.9, 5.1, 1), (1.9, 2.1, 1), (7.0, 7.2, 2), (2.0, 2.2, 3)]
    un, by = span_readings.idle_by_span(gaps, taken)
    assert un == pytest.approx(1.4)
    assert by == pytest.approx({"align": 1.0, "tracker.update": 0.4,
                                "tracker.speculate": 0.6})
    assert span_readings.idle_unattributed_pct(gaps, taken) \
        == pytest.approx(100.0 * 1.4 / 3.4)
    assert span_readings.idle_unattributed_pct([], taken) is None
