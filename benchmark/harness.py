"""Set-up and the measured window of one run, driving the port as its CLI
does (cvo_slam_tpu_torch/app/run_slam.py): frames stream through the
port's FramePrefetcher into KeyframeTracker.update(image, next_frame=nxt),
one frame of lookahead, a closed loop.

The harness times the layers from its own files, around the calls into
them: the wait on the prefetcher, each `update`, and (traced runs) the
kernel wrappers. It also keeps, per window frame, the program's inputs and
outputs the correctness check compares (benchmark/check.py): the state
each alignment started from and what it returned, read off the tracker's
host state, never changed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from . import render

FRAME_HZ = 30.0         # timestamps of the replayed stream
TRACE_SECONDS = 4.0     # length of the profiled part of a traced window


@dataclasses.dataclass
class FrameRec:
    """One window frame: timing, counters and what the check needs."""
    g: int                      # index in the stream
    lap_k: int                  # frame of the rendered lap
    latency_s: float            # hand-in to the returned pose
    wait_s: float               # wait on the prefetcher for the next frame
    odo_iters: int
    kf_iters: int
    accept: int                 # the tracker's keyframe decision
    nan_moved: bool             # the tracker's NaN guard fired
    # the program's state before the frame and its outputs
    odo_R0: np.ndarray = None
    odo_T0: np.ndarray = None
    kf_transform0: np.ndarray = None
    kf_g: int = -1              # stream index of the keyframe align's
    odo_g: int = -1             # and the odometry align's fixed cloud
    frames_in_map: int = 0      # LocalMap.get_frame_number() before
    eval_inn_post: float = 0.0  # the map's reference inner product before
    T_odo: np.ndarray = None
    T_kf: np.ndarray = None
    ell_odo: float = 0.0
    ell_kf: float = 0.0
    odo_inn_post: float = 0.0
    kf_inn_post: float = 0.0
    cloud: object = None        # the program's host cloud of the frame


@dataclasses.dataclass
class VerifyRec:
    """One loop-closure verification the window issued: the keyframes,
    the align's start, the two priors it was scored under, what the
    program returned and whether the program accepted the edge."""
    ref_g: int
    cand_g: int
    R0: np.ndarray
    T0: np.ndarray
    prior: np.ndarray           # the keyframes' relative pose in the graph
    lc_prior: np.ndarray        # the RANSAC prior
    T: np.ndarray
    ell: float
    lc: dict                    # the program's scores (LC_SCORES)
    accepted: bool = False


# the scores of compute_innerproduct_lc that the accept test reads
LC_SCORES = ("inn_prior", "inn_lc_prior", "inn_lc_pre", "inn_lc_post",
             "cos_angle")


@dataclasses.dataclass
class BACall:
    """One windowed-BA solve (backend/ba.optimize_ba): its arguments and
    outputs as host arrays."""
    args: dict
    E: np.ndarray
    L: np.ndarray


BA_ARGS = ("E", "L", "free_pose", "lm_mask", "ei", "ej", "Z", "omega",
           "pemask", "p_kf", "p_lm", "p_meas", "p_w", "p_mask", "K",
           "iterations", "delta")


@dataclasses.dataclass
class Window:
    frames: List[FrameRec]
    window_s: float
    failed: int
    events: List[dict]           # graph.stage_ms rows of the window
    verifies: List[VerifyRec]
    bas: List[BACall] = dataclasses.field(default_factory=list)
    trace: Optional[dict] = None  # benchmark/trace.py's reading
    kernel_calls: Dict[str, list] = dataclasses.field(default_factory=dict)
    lap: int = 0


def build_configs(config: dict, traffic: dict, overrides: dict = None):
    """(CameraConfig, SlamConfig) of a configuration file and a traffic
    mix; `overrides` (the CPU tests' small sizes) replaces camera and
    frontend keys."""
    from cvo_slam_tpu_torch.config import (CameraConfig, CvoParams,
                                           FrontendParams, SlamConfig)
    ov = overrides or {}
    cam = CameraConfig(**{**config["camera"], **ov.get("camera", {})})
    cvo = dict(config["cvo"])
    for k in ("ell_anneal_iters", "ell_anneal_values"):
        cvo[k] = tuple(cvo[k])
    cfg = SlamConfig(**{**config["slam"], **ov.get("slam", {})},
                     cvo=CvoParams(**cvo),
                     frontend=FrontendParams(**{**config["frontend"],
                                                **ov.get("frontend", {})}))
    if traffic["tracking_only"]:
        cfg = cfg.replace(OnlyTracking=True)
    return cam, cfg


def cam_dict(cam) -> dict:
    return dataclasses.asdict(cam)


def settings(cam, cfg):
    """(camera, SLAM, frontend) settings of a run as plain dicts, for the
    reference."""
    slam = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("cvo", "frontend")}
    return cam_dict(cam), slam, dataclasses.asdict(cfg.frontend)


class Session:
    """The program under test: its tracker, its frame stream and the
    harness's records of both."""

    def __init__(self, cell, seed: int, device, folder: str,
                 overrides: dict = None):
        from cvo_slam_tpu_torch.app import run_slam
        from cvo_slam_tpu_torch.cvo import engine
        self.device = device
        self.folder = folder
        self.traffic = cell.traffic
        self.cam, self.cfg = build_configs(cell.config, cell.traffic,
                                           overrides)
        self.parts = {}
        t0 = time.perf_counter()
        frames = render.render_lap(cam_dict(self.cam), self.traffic, seed,
                                   device)
        self.lap = len(frames)
        render.write_lap(folder, frames)
        del frames
        self.parts["render_write_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        os.environ["CVO_SLAM_BACKEND"] = cell.config["align_backend"]
        self.tracker = run_slam.build_tracker(self.cam, self.cfg,
                                              device=str(device))
        run_slam.start_warmup(torch.device(device))
        self.tracker.init()
        self.parts["tracker_build_s"] = time.perf_counter() - t0

        self._apply_log = []
        self._verify_log = []
        self._ba_log = []
        self._accepted = set()
        self._cloud_g = {}          # id(positions) -> (weakref, frame)
        self.ts_to_g = {}
        self._install_hooks(engine)

    # -- hooks: record what the program returns, change nothing ----------
    def _install_hooks(self, engine):
        log = self._apply_log
        orig = engine.Cvo._apply_align

        def apply_align(cvo, R, T, transform, ell, iters, nnz):
            out = orig(cvo, R, T, transform, ell, iters, nnz)
            log.append((cvo, out.copy(), float(ell), int(iters)))
            return out

        engine.Cvo._apply_align = apply_align
        self._restore = [(engine.Cvo, "_apply_align", orig)]
        if self.tracker.graph is not None:
            vlog = self._verify_log
            graph = self.tracker.graph
            vorig = engine.lc_verify_batch

            def lc_verify_batch(fixed, movings, R0, T0, ell0, priors,
                                lc_priors, *rest):
                out = vorig(fixed, movings, R0, T0, ell0, priors, lc_priors,
                            *rest)
                ts = {id(kf.cloud.positions): kf.timestamp
                      for kf in graph.keyframes()}
                for l, (res, lc) in enumerate(out):
                    mv = movings[l] if isinstance(movings, list) else None
                    vlog.append((ts.get(id(fixed.positions)),
                                 None if mv is None
                                 else ts.get(id(mv.positions)),
                                 np.asarray(R0[l]), np.asarray(T0[l]),
                                 np.asarray(priors[l], np.float64),
                                 np.asarray(lc_priors[l], np.float64),
                                 res.transform.double().cpu().numpy(),
                                 float(res.ell),
                                 {k: float(lc[k]) for k in LC_SCORES}))
                return out

            engine.lc_verify_batch = lc_verify_batch
            self._restore.append((engine, "lc_verify_batch", vorig))

            # the edges the program accepted, as (reference, candidate)
            # keyframe timestamps
            accepted = self._accepted
            iorig = graph.insert_loop_closure

            def insert_loop_closure(ref, cand, result):
                accepted.add((ref.timestamp, cand.timestamp))
                return iorig(ref, cand, result)

            graph.insert_loop_closure = insert_loop_closure
            self._restore.append((graph, "insert_loop_closure", iorig))

            from cvo_slam_tpu_torch.backend import ba
            blog = self._ba_log
            borig = ba.optimize_ba

            def optimize_ba(*args, **kw):
                E, L = borig(*args, **kw)
                # device copies only: the host copies come after the window
                blog.append(([a.clone() if torch.is_tensor(a) else a
                              for a in args], E.clone(), L.clone()))
                return E, L

            ba.optimize_ba = optimize_ba
            self._restore.append((ba, "optimize_ba", borig))

    def close(self):
        for obj, name, orig in self._restore:
            setattr(obj, name, orig)
        self._restore = []

    # -- the stream --------------------------------------------------------
    def records(self, n: int):
        from cvo_slam_tpu_torch.data import tum
        out = []
        for g in range(n):
            rgb, dep = render.frame_paths(g % self.lap)
            ts = f"{1000.0 + g / FRAME_HZ:.6f}"
            self.ts_to_g[ts] = g
            out.append(tum.FrameRecord(ts, rgb, dep))
        return out

    def stream(self, n: int):
        from cvo_slam_tpu_torch.data.prefetch import FramePrefetcher
        return iter(FramePrefetcher(self.folder, self.records(n), self.cam,
                                    self.cfg.frontend))

    def _nan_count(self):
        m = self.tracker.lt.metrics
        return m.get("nan_odometry", 0) + m.get("nan_keyframe", 0)

    def _frame_of(self, cloud) -> int:
        """The stream index of the frame whose cloud the tracker holds
        (`cloud`, a device PointCloud), or -1."""
        if cloud is None:
            return -1
        ref, g = self._cloud_g.get(id(cloud.positions), (None, -1))
        return g if ref is not None and ref() is cloud.positions else -1

    def _register(self, cloud, g: int):
        self._cloud_g[id(cloud.positions)] = (weakref.ref(cloud.positions),
                                              g)

    def _note_clouds(self, g: int):
        """After frame g: the odometry instance holds frame g's cloud; a
        keyframe cloud not seen yet is the bootstrap frame's (the
        tracker's first image, which makes the first map's keyframe)."""
        lt = self.tracker.lt
        if lt.cvo_odometry.fixed is not None:
            self._register(lt.cvo_odometry.fixed, g)
        kf = lt.cvo_keyframe.fixed
        if kf is not None and self._frame_of(kf) < 0 \
                and self.tracker.previous is not None:
            self._register(kf, self.ts_to_g[self.tracker.previous.timestamp])

    def _state_before(self, rec: FrameRec):
        lt = self.tracker.lt
        rec.odo_R0 = lt.cvo_odometry.R.copy()
        rec.odo_T0 = lt.cvo_odometry.T.copy()
        rec.kf_transform0 = lt.cvo_keyframe.transform.copy()
        # the fixed clouds the aligns of this frame start from, as the
        # clouds' state machine (cvo.cpp:578-618) left them: the keyframe
        # align's is not always the local map's keyframe (reset_keyframe
        # before any accepted frame takes the current frame)
        rec.kf_g = self._frame_of(lt.cvo_keyframe.fixed)
        rec.odo_g = self._frame_of(lt.cvo_odometry.fixed)
        lm = lt.local_map
        if lm is not None:
            rec.frames_in_map = lm.get_frame_number()
            rec.eval_inn_post = float(self.tracker.evaluation.inn_post)

    def _outputs(self, rec: FrameRec):
        lt = self.tracker.lt
        for cvo, T, ell, iters in self._apply_log:
            if cvo is lt.cvo_odometry:
                rec.T_odo, rec.ell_odo = T, ell
            elif cvo is lt.cvo_keyframe:
                rec.T_kf, rec.ell_kf = T, ell
        m = lt.metrics
        rec.odo_inn_post = float(m.get("odo_inn_post", math.nan))
        rec.kf_inn_post = float(m.get("kf_inn_post", math.nan))

    def step(self, image, nxt, g: int, keep: bool):
        """One `update`; returns its FrameRec (timing filled in by the
        caller)."""
        rec = FrameRec(g=g, lap_k=g % self.lap, latency_s=0.0, wait_s=0.0,
                       odo_iters=0, kf_iters=0, accept=-1, nan_moved=False)
        if keep:
            self._state_before(rec)
        self._apply_log.clear()
        nan0 = self._nan_count()
        t0 = time.perf_counter()
        self.tracker.update(image, next_frame=nxt)
        rec.latency_s = time.perf_counter() - t0
        self._note_clouds(g)
        m = self.tracker.lt.metrics
        rec.odo_iters = int(m.get("odo_iters", 0))
        rec.kf_iters = int(m.get("kf_iters", 0))
        rec.accept = int(m.get("accept", -1))
        rec.nan_moved = self._nan_count() != nan0
        if keep:
            self._outputs(rec)
            rec.cloud = image.precomputed_cloud
        return rec

    def graph_events(self):
        g = self.tracker.graph
        return [] if g is None else g.stage_ms

    def warm_up(self, it, image, g: int):
        """Run the traffic's warm-up frames through the stream; returns the
        next (image, g)."""
        spec = self.traffic["warmup"]
        limit = spec.get("frames", 0) or 3 * self.lap
        while g < limit:
            nxt = next(it)
            self.step(image, nxt, g, keep=False)
            image, g = nxt, g + 1
            if "frames" not in spec and any(
                    spec["until_stage"] in row
                    for row in self.graph_events()):
                return image, g
        if "frames" not in spec:
            raise RuntimeError(f"no keyframe event with stage "
                               f"{spec['until_stage']!r} in {limit} frames")
        return image, g

    def window(self, it, image, g: int, seconds: float, profiler=None,
               on_trace_end=None) -> Window:
        """Frames until `seconds` have passed. With `profiler` (a started
        trace.SessionProfiler), the first TRACE_SECONDS of the window are
        traced, with the harness's spans around the wait on the prefetcher,
        `update` and each keyframe event, and `on_trace_end()` runs when
        the profiler stops."""
        from torch.profiler import record_function
        frames, failed = [], 0
        n_events0 = len(self.graph_events())
        n_verify0 = len(self._verify_log)
        n_ba0 = len(self._ba_log)
        tracing = profiler is not None
        graph_add = None
        if tracing and self.tracker.graph is not None:
            graph = self.tracker.graph
            graph_add = graph.add

            def add(local_map):
                with record_function("bench.keyframe_event"):
                    return graph_add(local_map)

            graph.add = add
        t_start = time.perf_counter()
        deadline = t_start + seconds
        t_end = t_start

        def span(name):
            return record_function(name) if tracing \
                else contextlib.nullcontext()

        def end_trace():
            nonlocal tracing
            profiler.stop()
            tracing = False
            if graph_add is not None:
                del self.tracker.graph.add
            if on_trace_end is not None:
                on_trace_end()

        while True:
            t0 = time.perf_counter()
            with span("bench.frame"):
                with span("bench.wait"):
                    nxt = next(it)
                wait = time.perf_counter() - t0
                try:
                    with span("bench.update"):
                        rec = self.step(image, nxt, g, keep=True)
                except Exception:   # noqa: BLE001 — a frame users see fail
                    import traceback
                    traceback.print_exc()
                    failed += 1
                    t_end = time.perf_counter()
                    break
            t_end = time.perf_counter()
            rec.wait_s = wait
            frames.append(rec)
            image, g = nxt, g + 1
            if tracing:
                profiler.frame_done(t0, t_end)
                if t_end - t_start >= TRACE_SECONDS:
                    end_trace()
            if t_end >= deadline:
                break
        if tracing:
            end_trace()
        events = self.graph_events()[n_events0:]
        verifies = []
        for ref_ts, cand_ts, *rest in self._verify_log[n_verify0:]:
            if ref_ts in self.ts_to_g and cand_ts in self.ts_to_g:
                verifies.append(VerifyRec(
                    self.ts_to_g[ref_ts], self.ts_to_g[cand_ts], *rest,
                    accepted=(ref_ts, cand_ts) in self._accepted))
        return Window(frames, t_end - t_start, failed, list(events),
                      verifies, bas=self._ba_log[n_ba0:], lap=self.lap)

    @staticmethod
    def ba_to_host(window: Window):
        """The window's captured BA solves as host arrays (after the
        window, so the copies cost it nothing)."""
        out = []
        for args, E, L in window.bas:
            vals = [a.cpu().numpy() if torch.is_tensor(a) else a
                    for a in args]
            out.append(BACall(dict(zip(BA_ARGS, vals)), E.cpu().numpy(),
                              L.cpu().numpy()))
        window.bas = out

    def drain(self):
        """Wait for the tracker's pending device work (a speculation)."""
        self.tracker.lt.executor._discard()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
