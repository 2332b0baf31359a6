"""The traced part of a `--trace 1` window: torch.profiler sessions over
the window's first TRACE_SECONDS, read from their chrome traces.

Each session covers whole frames and lasts about SESSION_SECONDS. A
session is complete when every kernel launch the CUDA runtime recorded
has its kernel in the trace (the profiler was seen to lose kernels on the
H100); the device numbers come from the complete sessions, or from the
most complete one if none is, which stderr then says. From them:

  busy_s, window_s   the union of the device operations' intervals inside
                     the sessions' frames, and the frames' span;
  launches           kernel launches the runtime recorded, per frame;
  breakdown          the device operations that took most time, and the
                     idle gaps summed by what the main thread was doing
                     (the harness's own spans: the wait on the
                     prefetcher, `update`, a keyframe event) and which
                     runtime call, if any, was under way;
  kernel calls       the device time of each captured kernel-wrapper call
                     (benchmark/counts.py's kernels): the port's own
                     kernels (csrc/) launched while the call ran, by their
                     launches' times through the runtime's correlation
                     ids; a call that overlaps another is left out.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List

import torch

SESSION_SECONDS = 1.0
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Call:
    """One kernel-wrapper call: its arguments and outputs, its host
    interval, and its device seconds once read."""
    name: str
    args: tuple
    out: object
    t0: float
    t1: float
    device_s: float = None


class Tracer:
    """Profiler sessions and kernel-wrapper capture for one window."""

    def __init__(self, device, cell, folder: str):
        self.device = torch.device(device)
        self.folder = folder
        self.kernels = [m["name"].split(".", 1)[1] for m in cell.per_layer
                        if m["name"].startswith("roofline_pct.")]
        self.calls: Dict[str, List[Call]] = collections.defaultdict(list)
        self.sessions = []      # (chrome trace path, [(t0, t1) of frames])
        self._restore = []
        self.profiler = None

    # -- capture ------------------------------------------------------------
    def _wrap(self, kernels, name):
        orig = getattr(kernels, name)
        calls = self.calls[name]

        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            calls.append(Call(name, args, out, t0, time.perf_counter()))
            return out

        setattr(kernels, name, wrapped)
        self._restore.append((kernels, name, orig))

    def warm(self):
        """One empty session, so that the profiler's own start-up falls in
        the set-up and not in the window."""
        p = self._new()
        p.start()
        if self.device.type == "cuda":
            torch.zeros(1, device=self.device).add_(1)
            torch.cuda.synchronize()
        p.stop()

    def _new(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def start(self):
        from cvo_slam_tpu_torch.cvo import kernels
        for name in self.kernels:
            self._wrap(kernels, name)
        self.counters0 = {k.name: k.launches for k in kernels.KERNELS}
        self.profiler = SessionProfiler(self)
        self.profiler.begin()

    def stopped(self):
        from cvo_slam_tpu_torch.cvo import kernels
        for obj, name, orig in self._restore:
            setattr(obj, name, orig)
        self._restore = []
        self.counters = {k.name: k.launches - self.counters0[k.name]
                         for k in kernels.KERNELS}

    # -- reading ------------------------------------------------------------
    def read(self):
        """(trace summary, {kernel: [Call]}) of the sessions; the summary
        is None when no session recorded a device operation."""
        readings = []
        for path, frames in self.sessions:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            os.remove(path)
            readings.append(_read_session(events, frames))
        kept = [r for r in readings if r["lost"] == 0 and r["gpu"]]
        if not kept and readings:
            best = max(readings, key=lambda r: r["gpu"] / max(r["launch"], 1))
            kept = [best] if best["gpu"] else []
            print(f"trace: no complete session; {best['lost']} of "
                  f"{best['launch']} launches lost in the most complete",
                  file=sys.stderr)
        print(f"trace: {len(kept)} of {len(readings)} sessions complete; "
              f"wrapper launches {dict((k, v) for k, v in self.counters.items() if v)}",
              file=sys.stderr)
        if not kept:
            return None, dict(self.calls)
        ops, gaps = collections.Counter(), collections.Counter()
        for r in kept:
            ops.update(r["ops"])
            gaps.update(r["gaps"])
        summary = {
            "port_kernels": sorted(k for r in readings
                                   for k in r["port_kernels"]),
            "busy_s": sum(r["busy_s"] for r in kept),
            "window_s": sum(r["window_s"] for r in kept),
            "frames": sum(r["frames"] for r in kept),
            "launches": sum(r["launch"] for r in kept),
            "breakdown": {"device_ops": [[k, v] for k, v in
                                         ops.most_common(10)],
                          "idle_gaps": [[k, v] for k, v in
                                        gaps.most_common(10)]},
        }
        return summary, dict(self.calls)


class SessionProfiler:
    """The window's profiler: a new torch.profiler session every
    SESSION_SECONDS, at a frame boundary (Session.window calls
    frame_done after each frame and stop at the end). Writing a session's
    trace pauses the window between two frames."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self.prof = None

    def begin(self):
        self.prof = self.tracer._new()
        self.frames = []
        self.t_begin = time.perf_counter()
        self.prof.start()

    def frame_done(self, t0: float, t1: float):
        self.frames.append((t0, t1))
        if t1 - self.t_begin >= SESSION_SECONDS:
            self._end()
            self.begin()

    def _end(self):
        """Stop the session and write its trace at once: a profiler's
        results do not outlive the next session."""
        if self.tracer.device.type == "cuda":
            torch.cuda.synchronize()
        self.prof.stop()
        if self.frames:
            sessions = self.tracer.sessions
            path = os.path.join(self.tracer.folder,
                                f"trace-{len(sessions)}.json")
            self.prof.export_chrome_trace(path)
            sessions.append((path, self.frames))
        self.prof = None

    def stop(self):
        if self.prof is not None:
            self._end()


LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
            "cudaLaunchCooperativeKernel", "cuLaunchKernel", "cuLaunchKernelEx")


def _union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(intervals, lo, hi):
    """The (start, end) gaps of the intervals' union inside [lo, hi]."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class _Spans:
    """Spans (name, start, end) looked up by a time they cover."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda x: x[1])
        self.starts = [x[1] for x in self.spans]
        self.longest = max((e - s for _, s, e in self.spans), default=0.0)

    def covering(self, t):
        """The shortest span that covers t, or None."""
        best = None
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.starts[i] >= t - self.longest:
            name, s, e = self.spans[i]
            if e >= t and (best is None or e - s < best[2] - best[1]):
                best = self.spans[i]
            i -= 1
        return best


def _read_session(events, frames) -> dict:
    """One session's reading (module docstring)."""
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name", "").startswith("bench.")]
    frame_ann = sorted((e for e in ann if e["name"] == "bench.frame"),
                       key=lambda e: e["ts"])
    gpu = [e for e in events if e.get("cat") in GPU_CATS and "dur" in e]
    runtime = [e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launches = [e for e in runtime if e["name"] in LAUNCHES]
    by_corr = collections.defaultdict(list)
    for e in gpu:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            by_corr[c].append(e)
    lost = sum(1 for e in launches
               if not by_corr.get(e.get("args", {}).get("correlation")))
    out = {"gpu": len(gpu), "launch": len(launches), "lost": lost,
           "frames": len(frames), "busy_s": 0.0, "window_s": 0.0,
           "ops": collections.Counter(), "gaps": collections.Counter(),
           "port_kernels": []}
    if not frame_ann:
        return out
    lo = frame_ann[0]["ts"]
    hi = max(e["ts"] + e["dur"] for e in frame_ann)
    out["frames"] = len(frame_ann)
    iv = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in gpu
          if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    out["busy_s"] = _union(iv) / 1e6
    out["window_s"] = (hi - lo) / 1e6
    for e in gpu:
        out["ops"][e["name"][:160]] += e["dur"] / 1e6
    spans = _Spans([(e["name"], e["ts"], e["ts"] + e["dur"]) for e in ann])
    rt_spans = _Spans([(e["name"], e["ts"], e["ts"] + e.get("dur", 0))
                       for e in runtime if e.get("dur", 0) < 1e5])
    for s, e in _gaps(iv, lo, hi):
        mid = 0.5 * (s + e)
        host = spans.covering(mid)
        rt = rt_spans.covering(mid)
        label = (host[0] if host else "between frames") + \
            (f" / {rt[0]}" if rt else " / host code")
        out["gaps"][label] += (e - s) / 1e6

    # the harness's clock against the trace's: the frames' starts; the
    # port's own kernels (csrc/, anonymous namespaces outside at::) by the
    # time of their launch on the harness's clock
    offsets = sorted(a["ts"] - f0 * 1e6 for a, (f0, _) in
                     zip(frame_ann, frames))
    off = offsets[len(offsets) // 2]
    launch_ts = {e["args"].get("correlation"): e["ts"] for e in launches}
    for e in gpu:
        name = e["name"]
        c = e.get("args", {}).get("correlation")
        if "(anonymous namespace)::" in name and "at::" not in name \
                and c in launch_ts:
            out["port_kernels"].append(((launch_ts[c] - off) / 1e6, name,
                                        e["dur"] / 1e6))
    return out


def match_calls(calls, port_kernels, names):
    """Give each call the device seconds of the port's kernels whose names
    hold one of `names` and that were launched while it ran
    (port_kernels: (launch time on the harness's clock, name, seconds),
    sorted); a call whose interval overlaps another call's is left
    untimed, as is one that launched none."""
    calls = sorted(calls, key=lambda c: c.t0)
    port_kernels = [k for k in port_kernels if any(n in k[1] for n in names)]
    starts = [k[0] for k in port_kernels]
    for i, c in enumerate(calls):
        overlap = (i > 0 and calls[i - 1].t1 > c.t0) or \
            (i + 1 < len(calls) and calls[i + 1].t0 < c.t1)
        lo = bisect.bisect_left(starts, c.t0)
        hi = bisect.bisect_right(starts, c.t1)
        if overlap or lo == hi:
            continue
        c.device_s = sum(k[2] for k in port_kernels[lo:hi])
