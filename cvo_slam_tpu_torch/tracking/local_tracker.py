"""Per-frame tracking orchestration: two CVO instances + the local map
(port of cvo_slam_tpu.tracking.local_tracker).

Re-expression of reference LocalTracker (reference src/local_tracker.cpp):
owns `cvo_odometry` (frame-to-frame) and `cvo_keyframe` (keyframe-to-frame)
instances (local_tracker.cpp:48-49, 143) and the current LocalMap. Signals are
plain callable lists (accept = AND over all callbacks, local_tracker.h:65-83).

The frontend runs once per frame and the cloud is shared by both instances
(the reference builds it twice with a deterministic selector). Keyframe ORB
extraction (local_tracker.cpp:292-300) is attached via the
`keyframe_feature_hook`.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import spans
from ..config import CameraConfig, SlamConfig
from ..cvo import engine
from ..cvo.engine import Cvo, PointCloud
from ..data.tum import ImagePair
from ..device import StreamWorker, resolve_device
from ..frontend.pointcloud import create_pointcloud, span_attrs
from .local_map import LocalMap
from .types import Keyframe, TrackingResult


# -- device-dispatch request protocol ----------------------------------------
# The per-frame tracking logic is written as generators that YIELD device-math
# requests and receive results via send(); `drive` runs one generator with an
# executor that services each request.
#   ("frame", odo_cvo, kf_cvo, cloud, pixels)
#       -> (T_odo, ip_odo, T_kf, ip_kf)  [the whole frame: both set_pcds,
#          odometry align+ip, device-side reset_initial warm start, keyframe
#          align+ip (engine.frame_step)]
#   ("align_ip", cvo, cloud, pixels) -> ((4,4) transform, ip dict)
#                                       [set_pcd + align + innerproduct]
#   ("ip", cvo, tran)                -> compute_innerproduct dict

def _frame_to_host(out):
    """Host copies of a frame_step's (res_odo, ip_odo, res_kf, ip_kf)."""
    res1, ip1, res2, ip2, _ = out
    return engine.to_host((tuple(res1), ip1, tuple(res2), ip2))


def _speculate(cause, *frame_step_args):
    """A speculative frame (runs on the executor's worker): the device
    results the next speculation chains from, and the host copies. `cause`
    is the frame_step span of the frame before (spans.NULL while the
    recorder is off)."""
    with spans.span("tracker.speculate",
                    None if cause.frame is None else cause.frame + 1, cause):
        out = engine.frame_step(*frame_step_args)
        return out[0], out[2], _frame_to_host(out)


def speculation_enabled(device) -> bool:
    """CVO_SLAM_SPECULATE=0/1 forces speculative frame dispatch off or on;
    by default it is on for a CUDA device, where the frame's device work
    can overlap the host's, and off on the CPU, where the wasted work of a
    wrong guess competes with the host pipeline."""
    env = os.environ.get("CVO_SLAM_SPECULATE", "")
    if env in ("0", "1"):
        return env == "1"
    return torch.device(device).type == "cuda"


class SpeculativeExecutor:
    """Solo request executor with one-frame-ahead speculative dispatch.

    Right after frame i's device work is issued, and before its results are
    copied to the host, this executor hands the NEXT frame's frame_step to
    a worker thread with a CUDA side stream of its own (device.StreamWorker),
    chaining the odometry warm start, both ells and the keyframe transform
    from frame i's device results and assuming the keyframe does not change
    (the accept case). The worker runs it while the tracker finishes frame
    i on the host (readback, keyframe decision, trajectory line, the next
    cloud).

    Exactness: the speculative frame_step is the same kernels fed the same
    values (the device results ARE the values the host copies later), so a
    VALID speculation is bitwise-identical to the dispatch it replaces.
    Validity is checked against the actual request: same cloud objects
    (previous / keyframe / current), odometry state and keyframe state
    unchanged since the speculation (np.array_equal on the host copies).
    ANY mismatch (keyframe rejection, NaN repair, forced map end, bootstrap
    requests in between) discards the speculation and dispatches the real
    inputs; a wrong guess costs only the worker's wasted work, which is
    waited for (so its failure raises) and counted in `discards`.

    The next frame's cloud comes from LocalTracker.stage_next (fed by the
    run loop one frame ahead)."""

    def __init__(self, lt: "LocalTracker"):
        self.lt = lt
        self.spec = None
        self.hits = 0       # speculations consumed
        self.misses = 0     # frame requests dispatched for real
        self.discards = 0   # speculations issued and thrown away
        self.enabled = speculation_enabled(lt.device)
        self._worker = None

    def __call__(self, req):
        if req[0] != "frame":
            # solo repair / bootstrap requests mutate cvo state the chain
            # does not track: drop any pending speculation
            self._discard()
            return execute_request(req)
        return self._frame(req[1], req[2], req[3], req[4])

    def _discard(self):
        if self.spec is not None:
            spec, self.spec = self.spec, None
            with spans.span("tracker.spec_wait") as s:
                s.set("discarded", True)
                spec["fut"].result()
            self.discards += 1

    def _speculation_valid(self, odo: Cvo, kfc: Cvo, cloud) -> bool:
        s = self.spec
        if s is None:
            return False
        # under the ell_reset policy every alignment starts at ell_init, so
        # the speculative program's ell inputs match any state by
        # construction; without it the carried ells must be unchanged
        ells_ok = odo.params.ell_reset or (odo.ell == s["odo_ell"]
                                           and kfc.ell == s["kf_ell"])
        return (s["prev"] is odo.fixed.positions
                and s["kf"] is kfc.fixed.positions
                and s["cur"] is cloud.positions
                and np.array_equal(odo.R, s["odo_R"])
                and np.array_equal(odo.T, s["odo_T"])
                and ells_ok
                and np.array_equal(kfc.transform, s["kf_transform"]))

    def _frame(self, odo: Cvo, kfc: Cvo, cloud, pixels):
        with spans.span("tracker.frame_step") as fs:
            if self._speculation_valid(odo, kfc, cloud):
                use, self.spec = self.spec, None
            else:
                use = None
                self._discard()
            fs.set("spec", "miss" if use is None else "hit")
            for cvo in (odo, kfc):
                ready = cvo.set_pcd(cloud, pixels)
                assert ready, "cvo not initialized"
            if use is not None:
                self.hits += 1
                with spans.span("tracker.spec_wait") as s:
                    s.set("discarded", False)
                    res1, res2, host = use["fut"].result()
            else:
                self.misses += 1
                out = engine.frame_step(
                    odo.fixed, kfc.fixed, odo.moving, odo.R, odo.T,
                    np.float32(odo.start_ell()),
                    kfc.transform.astype(np.float32),
                    np.float32(kfc.start_ell()), odo.params, odo.backend)
                res1, res2, host = out[0], out[2], None

            # speculate the next frame (accept-assumed) BEFORE the readback
            nxt = (self.lt.peek_staged(exclude=cloud) if self.enabled
                   else None)
            if nxt is not None:
                ncloud, _ = nxt
                p = odo.params
                if p.ell_reset:
                    ell_o = ell_k = np.float32(p.ell_init)
                else:
                    ell_o, ell_k = res1.ell, res2.ell
                if self._worker is None:
                    self._worker = StreamWorker(self.lt.device,
                                                "speculative-frame")
                fut = self._worker.submit(
                    _speculate, fs, cloud, kfc.fixed, ncloud, res1.R, res1.T,
                    ell_o, res2.transform, ell_k, p, odo.backend)
                self.spec = dict(fut=fut, prev=cloud.positions,
                                 kf=kfc.fixed.positions,
                                 cur=ncloud.positions)

            if host is None:
                host = _frame_to_host(out)
            h1, hip1, h2, hip2 = host
            result = odo._apply_align(*h1), hip1, kfc._apply_align(*h2), hip2
            if self.spec is not None:
                # record the host values the speculation's device inputs
                # equal (they diverge only through rejection / NaN repair /
                # forcing, all of which the validity check then catches)
                self.spec.update(odo_R=odo.R.copy(), odo_T=odo.T.copy(),
                                 odo_ell=odo.ell,
                                 kf_transform=kfc.transform.copy(),
                                 kf_ell=kfc.ell)
            return result


def execute_request(req):
    """Service an "align_ip" or "ip" request (the executor's frames are its
    own, SpeculativeExecutor._frame)."""
    kind, cvo = req[0], req[1]
    if kind == "align_ip":
        ready = cvo.set_pcd(req[2], req[3])   # match_odometry (cvo.cpp:461-473)
        assert ready, "cvo not initialized"
        return cvo._align_with_innerproduct()
    if kind == "ip":
        return cvo.compute_innerproduct(req[2])
    raise ValueError(f"unknown request kind {kind!r}")


def drive(gen, executor):
    """Run a request generator to completion with `executor` servicing its
    requests; returns its value."""
    try:
        req = next(gen)
        while True:
            req = gen.send(executor(req))
    except StopIteration as e:
        return e.value


class LocalTracker:

    def __init__(self, cam: CameraConfig, cfg: SlamConfig,
                 keyframe_feature_hook: Optional[Callable] = None,
                 log: Optional[Callable[[str], None]] = None,
                 device="cuda"):
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        # both instances take the align backend of CVO_SLAM_BACKEND
        # (engine.default_backend)
        self.cvo_odometry = Cvo(cfg.cvo)
        self.cvo_keyframe = Cvo(cfg.cvo)
        self.local_map: Optional[LocalMap] = None
        self.keyframe_feature_hook = keyframe_feature_hook
        self.reference_result: Optional[TrackingResult] = None  # map-init r_odometry
        self.new_map = False
        self.force = False
        self.next_kf_id = 0
        self.accept_callbacks: List[Callable] = []
        self.map_initialized_callbacks: List[Callable] = []
        self.map_complete_callbacks: List[Callable] = []
        self.log = log or (lambda s: None)
        self.metrics = {}
        self.executor = SpeculativeExecutor(self)
        self._staged = None   # (timestamp, cloud, pixels) for the NEXT frame

    # -- frontend: one cloud per frame, shared by both cvo instances
    def _make_cloud(self, image: ImagePair):
        if self._staged is not None and self._staged[0] == image.timestamp:
            _, cloud, pixels = self._staged
            self._staged = None
            return cloud, pixels
        with spans.span("frontend.cloud") as sp:
            pc = image.precomputed_cloud   # filled by data.prefetch
            if pc is None:
                pc = create_pointcloud(image.bgr, image.gray, image.depth,
                                       self.cam, self.cfg.frontend)
            span_attrs(sp, pc, image.gray.shape)
            return (PointCloud.from_host(pc, self.device),
                    pc.selected_pixels[:pc.count].copy())

    # -- one-frame lookahead for the speculative executor -------------------
    def stage_next(self, image: ImagePair):
        """Stage the NEXT frame's cloud (called by the run loop one frame
        ahead). Enables speculative frame dispatch; a run loop that never
        stages simply runs unpipelined."""
        if self._staged is not None and self._staged[0] == image.timestamp:
            return
        cloud, pixels = self._make_cloud(image)
        self._staged = (image.timestamp, cloud, pixels)

    def peek_staged(self, exclude: PointCloud = None):
        """The staged next-frame (cloud, pixels), or None. `exclude` guards
        against self-speculation when staging raced the current frame."""
        if self._staged is None:
            return None
        _, cloud, pixels = self._staged
        if exclude is not None and cloud.positions is exclude.positions:
            return None
        return cloud, pixels

    def _make_keyframe(self, image: ImagePair, pose: np.ndarray,
                       cloud: PointCloud, pixels: np.ndarray) -> Keyframe:
        kf = Keyframe(id=self.next_kf_id, timestamp=image.timestamp,
                      pose=np.asarray(pose, np.float64).copy(), cloud=cloud,
                      selected_pixels=pixels, gray=image.gray,
                      depth_m=image.depth.astype(np.float32) / self.cam.depth_factor)
        self.next_kf_id += 1
        if self.keyframe_feature_hook is not None:
            self.keyframe_feature_hook(kf)   # ORB (local_tracker.cpp:292-300)
            self.metrics["kf_feature_ms"] = self.keyframe_feature_hook.last_ms
        return kf

    # -- initNewLocalMap, public overload (local_tracker.cpp:223-284)
    def init_new_local_map(self, keyframe_img: ImagePair, frame_img: ImagePair,
                           keyframe_pose: np.ndarray):
        return drive(self.init_new_local_map_steps(keyframe_img, frame_img,
                                                   keyframe_pose),
                     self.executor)

    def init_new_local_map_steps(self, keyframe_img: ImagePair,
                                 frame_img: ImagePair,
                                 keyframe_pose: np.ndarray):
        kf_cloud, kf_pix = self._make_cloud(keyframe_img)
        fr_cloud, fr_pix = self._make_cloud(frame_img)
        self.cvo_odometry.set_pcd(kf_cloud, kf_pix)
        self.cvo_keyframe.set_pcd(kf_cloud, kf_pix)
        T, ip = yield ("align_ip", self.cvo_odometry, fr_cloud, fr_pix)
        r_odometry = TrackingResult.from_innerproduct(T, ip)
        self.cvo_odometry.update_fixed_pcd()
        self._init_new_local_map(keyframe_img, frame_img, r_odometry,
                                 keyframe_pose, kf_cloud, kf_pix)

    # -- initNewLocalMap, internal overload (local_tracker.cpp:286-347)
    def _init_new_local_map(self, keyframe_img: ImagePair, frame_img: ImagePair,
                            r_odometry: TrackingResult, keyframe_pose: np.ndarray,
                            kf_cloud: PointCloud, kf_pixels: np.ndarray):
        kf = self._make_keyframe(keyframe_img, keyframe_pose, kf_cloud, kf_pixels)
        self.local_map = LocalMap(kf, np.asarray(keyframe_pose, np.float64).copy(),
                                  self.cfg, device=self.device)
        self.local_map.add_frame(frame_img, frame_img.timestamp)
        self.log("Initialize a new local map")
        if self.cvo_keyframe.first_frame:
            self.cvo_keyframe.first_frame = False
            self.cvo_keyframe.reset_transform(r_odometry.transform)
        else:
            self.cvo_keyframe.reset_keyframe(r_odometry.transform)
            self.new_map = True
        self.local_map.add_keyframe_measurement(r_odometry)
        self.reference_result = copy.deepcopy(r_odometry)
        for cb in self.map_initialized_callbacks:
            cb(self, self.local_map, r_odometry)

    # -- update (local_tracker.cpp:349-572)
    def update(self, image: ImagePair, next_frame: ImagePair = None
               ) -> np.ndarray:
        return drive(self.update_steps(image, next_frame), self.executor)

    def update_steps(self, image: ImagePair, next_frame: ImagePair = None):
        self.new_map = False
        cloud, pixels = self._make_cloud(image)
        if next_frame is not None:
            # stage AFTER consuming this frame's own staged entry so the
            # speculative executor sees the upcoming frame's cloud
            self.stage_next(next_frame)

        # the whole frame: odometry align+ip, device-side warm start
        # (reset_initial), keyframe align+ip. The rare NaN-repair paths below
        # redo the affected pieces solo.
        T_raw, ip, T_kraw, ip2 = yield ("frame", self.cvo_odometry,
                                        self.cvo_keyframe, cloud, pixels)
        T_odo = self._nan_guard(T_raw, "odometry")
        if T_odo is not T_raw:
            ip = yield ("ip", self.cvo_odometry, T_odo.astype(np.float32))
            # the keyframe align warm-started from the bad odometry
            # transform; redo it from the repaired one (the host-sequenced
            # order: guard first, then reset_initial + align)
            self.cvo_keyframe.reset_initial(T_odo)
            T_kraw, ip2 = yield ("align_ip", self.cvo_keyframe, cloud, pixels)
        r_odometry = TrackingResult.from_innerproduct(T_odo, ip)
        self.metrics["odo_iters"] = self.cvo_odometry.iters
        self.metrics["odo_nnz"] = self.cvo_odometry.nnz

        last_cloud = self.cvo_odometry.fixed              # previous frame cloud
        last_pixels = self.cvo_odometry.fixed_pixels
        current_cloud, current_pixels = cloud, pixels
        self.cvo_odometry.update_fixed_pcd()

        T_kf = self._nan_guard(T_kraw, "keyframe",
                               fallback=self._kf_prior(T_odo))
        if T_kf is not T_kraw:
            ip2 = yield ("ip", self.cvo_keyframe, T_kf.astype(np.float32))
        self.metrics["spec_hits"] = self.executor.hits
        self.metrics["spec_misses"] = self.executor.misses
        r_keyframe = TrackingResult.from_innerproduct(T_kf, ip2)
        r_keyframe.dis_to_keyframe = self.local_map.get_frame_number()
        self.metrics["kf_iters"] = self.cvo_keyframe.iters
        self.metrics["kf_nnz"] = self.cvo_keyframe.nnz
        # structured per-frame observability: inner products, cos angles,
        # accept inputs
        self.metrics["odo_inn_post"] = r_odometry.inn_post
        self.metrics["kf_inn_post"] = r_keyframe.inn_post
        self.metrics["kf_cos_angle"] = r_keyframe.cos_angle
        self.metrics["kf_dist"] = float(np.linalg.norm(T_kf[:3, 3]))

        with spans.span("tracker.decide"):
            # keyframe decision: AND over all criteria (evaluated
            # unconditionally, matching the boost combiner + its logging
            # side effects)
            self.log("Check whether a new keyframe is needed")
            votes = [cb(self, r_odometry, r_keyframe)
                     for cb in self.accept_callbacks]
            self.metrics["accept"] = int(all(votes))
            if all(votes) and not self.force:
                self.log("Update current local pose graph")
                self.local_map.add_frame(image, image.timestamp)
                self.local_map.add_odometry_measurement(r_odometry)
                self.local_map.add_keyframe_measurement(r_keyframe)
                self.cvo_keyframe.update_previous_pcd()
            else:
                self.log("Current local pose graph completes")
                prev_frame_img = self.local_map.get_current_frame()
                current_pose = self.local_map.get_current_frame_pose()
                for cb in self.map_complete_callbacks:
                    cb(self, self.local_map)
                self._init_new_local_map(prev_frame_img, image, r_odometry,
                                         current_pose, last_cloud,
                                         last_pixels)
                if self.force:
                    # final frame: it becomes the second keyframe of the
                    # last map (local_tracker.cpp:523-567)
                    self.local_map.set_last_map()
                    kf = self._make_keyframe(
                        image, self.local_map.get_current_frame_pose(),
                        current_cloud, current_pixels)
                    self.local_map.set_last_keyframe(kf)
                    for cb in self.map_complete_callbacks:
                        cb(self, self.local_map)
                    return self.local_map.get_current_frame_pose()
            return self.local_map.get_current_frame_pose()

    # -- failure detection: a non-finite solver output falls back to the
    #    prior transform and is recorded in metrics
    def _nan_guard(self, T: np.ndarray, which: str,
                   fallback: np.ndarray = None) -> np.ndarray:
        if np.isfinite(T).all():
            return T
        self.metrics[f"nan_{which}"] = self.metrics.get(f"nan_{which}", 0) + 1
        self.log(f"WARNING: non-finite {which} transform; using prior")
        fb = np.eye(4) if fallback is None else np.asarray(fallback, np.float64)
        # re-seat the cvo state so subsequent warm starts stay finite
        cvo = self.cvo_odometry if which == "odometry" else self.cvo_keyframe
        inv = np.linalg.inv(fb)
        cvo.R = inv[:3, :3].astype(np.float32)
        cvo.T = inv[:3, 3].astype(np.float32)
        cvo.transform = fb.copy()
        return fb

    def _kf_prior(self, T_odo: np.ndarray) -> np.ndarray:
        """Prior for the keyframe transform: last keyframe transform chained
        with the current odometry (the reset_initial warm-start guess)."""
        prior = self.cvo_keyframe.transform
        if not np.isfinite(prior).all():
            return np.eye(4)
        return prior

    def get_local_map(self):
        return self.local_map

    def get_current_pose(self) -> np.ndarray:
        return self.local_map.get_current_frame_pose()

    def check_new_map(self) -> bool:
        return self.new_map

    def force_complete_current_local_map(self):
        self.force = True
