"""Per-layer readings of a window's spans (spans.py), for the port's tracing
tools and tests: each reading is a function of the spans the recorder took
over a window of frames, and of what the frame loop counted there.

    cloud_ms                 ms per frame in `frontend.cloud`
    tracker_self_ms          ms per frame of `tracker.update`'s self time
                             (its span less its child spans' cover): the
                             tracker's Python no narrower span locates
    spec_wait_ms             ms per frame waited on a speculation
                             (`tracker.spec_wait`)
    speculation_hit_pct      100 x hits / (hits + misses) over the
                             `tracker.frame_step` spans' `spec` attribute
    align_host_us_per_iter   self time of every `align` span, on any thread,
                             per align iteration the frames counted: the
                             host's share of an iteration, device reads
                             (`device.read`) left out
    readback_ms              ms per frame in `device.read` on the tracker's
                             thread and the speculation worker's
    kf_stage_ms.<stage>      ms of the stage per keyframe event, from the
                             keyframe graph's stage_ms rows (the readings
                             its `backend.<stage>` span shares)
    idle_unattributed_pct    the share of the device's idle gaps (given on
                             the spans' clock) that no span explains: the
                             thread that ended the gap was outside every
                             span, or waiting while no other thread was in
                             one (idle_by_span)
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, Optional, Tuple

# spans that wait on another thread's work: an idle gap under one of them
# belongs to the thread doing the work
WAITS = ("tracker.spec_wait", "lc.verify_wait")
READBACK_THREADS = ("MainThread", "speculative-frame")
KF_STAGES = ("loop_detect", "windowed_ba")


def cover(intervals) -> float:
    """Length of the union of (start, end) intervals."""
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


def self_times(spans) -> Dict[int, float]:
    """Each span's duration less the cover of its children (the spans it
    held open on its thread), by span id."""
    children = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent.id].append((s.t0, s.t1))
    return {s.id: (s.t1 - s.t0) - cover(children[s.id]) for s in spans}


def _total(spans, name: str, threads=None) -> float:
    return sum(s.t1 - s.t0 for s in spans if s.name == name and (
        threads is None or s.thread.startswith(threads)))


def readings(spans, frames: int, iters: int,
             events=()) -> Dict[str, Optional[float]]:
    """The readings of one window: `spans` what the recorder took over it,
    `frames` the frames it tracked, `iters` their odometry and keyframe
    align iterations, `events` the graph's stage_ms rows of its keyframe
    events. A reading with nothing to read is None."""
    out = dict.fromkeys(("cloud_ms", "tracker_self_ms", "spec_wait_ms",
                         "speculation_hit_pct", "align_host_us_per_iter",
                         "readback_ms") + tuple(f"kf_stage_ms.{k}"
                                                for k in KF_STAGES))
    own = self_times(spans)
    if frames:
        per_frame = 1e3 / frames
        out["cloud_ms"] = per_frame * _total(spans, "frontend.cloud")
        out["tracker_self_ms"] = per_frame * sum(
            own[s.id] for s in spans if s.name == "tracker.update")
        out["spec_wait_ms"] = per_frame * _total(spans, "tracker.spec_wait")
        out["readback_ms"] = per_frame * _total(spans, "device.read",
                                                READBACK_THREADS)
    outcomes = collections.Counter(
        s.attrs.get("spec") for s in spans
        if s.name == "tracker.frame_step" and s.attrs)
    if outcomes["hit"] + outcomes["miss"]:
        out["speculation_hit_pct"] = 100.0 * outcomes["hit"] / (
            outcomes["hit"] + outcomes["miss"])
    if iters:
        out["align_host_us_per_iter"] = 1e6 * sum(
            own[s.id] for s in spans if s.name == "align") / iters
    if events:
        for k in KF_STAGES:
            out[f"kf_stage_ms.{k}"] = sum(r.get(k, 0.0)
                                          for r in events) / len(events)
    return out


class Covering:
    """Spans looked up by a time they cover."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: s.t0)
        self.starts = [s.t0 for s in self.spans]
        self.longest = max((s.t1 - s.t0 for s in self.spans), default=0.0)

    def at(self, t, skip_tid=None):
        """The shortest span covering t, not of thread skip_tid, or None."""
        best = None
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.starts[i] >= t - self.longest:
            s = self.spans[i]
            if s.t1 >= t and s.tid != skip_tid and (
                    best is None or s.t1 - s.t0 < best.t1 - best.t0):
                best = s
            i -= 1
        return best


def idle_by_span(gaps, spans) -> Tuple[float, Dict[str, float]]:
    """(seconds of the gaps under no span, {span name: seconds}). A gap is
    (start, end) or (start, end, tid), tid the native id of the thread
    that launched the device work ending it: the thread the device waited
    on. The gap goes to that thread's innermost span covering its midpoint
    (none: the thread was outside the port, and the gap is left
    unattributed); where that span is a wait (WAITS), or no thread is
    known, to the shortest span other than a wait, on any other thread,
    that covers the midpoint."""
    by_tid = collections.defaultdict(list)
    for s in spans:
        by_tid[s.tid].append(s)
    own = {tid: Covering(ss) for tid, ss in by_tid.items()}
    work = Covering(s for s in spans if s.name not in WAITS)
    unattributed, by_name = 0.0, collections.Counter()
    for gap in gaps:
        g0, g1 = gap[0], gap[1]
        tid = gap[2] if len(gap) > 2 else None
        mid = 0.5 * (g0 + g1)
        best = None
        if tid is not None:
            best = own[tid].at(mid) if tid in own else None
            if best is None:
                unattributed += g1 - g0
                continue
        if best is None or best.name in WAITS:
            best = work.at(mid, skip_tid=tid)
        if best is None:
            unattributed += g1 - g0
        else:
            by_name[best.name] += g1 - g0
    return unattributed, dict(by_name)


def idle_unattributed_pct(gaps, spans) -> Optional[float]:
    """100 x the gaps' unattributed seconds (idle_by_span) over their
    seconds; None without gaps."""
    total = sum(g[1] - g[0] for g in gaps)
    if total <= 0:
        return None
    return 100.0 * idle_by_span(gaps, spans)[0] / total
