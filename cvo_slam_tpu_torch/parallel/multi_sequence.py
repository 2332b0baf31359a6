"""Multi-sequence lockstep tracking (port of
cvo_slam_tpu.parallel.multi_sequence).

S sequences are tracked in lockstep through the same KeyframeTracker /
LocalTracker state machine as solo runs (full local maps, the keyframe
policy and, unless OnlyTracking, per-sequence backend graphs with loop
closure and BA), while the device work is batched: the trackers' per-frame
logic is written as generators that yield align / inner-product requests
(tracking.local_tracker's request protocol), and this module serves all
pending requests of one kind in one batched dispatch (cvo.engine's lane
functions). Under 'pallas' (and 'pallas_iter', parallel.batch's routing)
a round of S frame requests is two align_fused lane launches and two suite
lane launches, where S solo frames are 4 S launches; under 'pallas_mom'
the aligns run lane by lane through the solo moment path and the suites as
lane launches.

The lockstep tracker drives the generators itself, so the trackers' own
speculative executors never run (checked every frame): a lockstep run
equals S solo runs with CVO_SLAM_SPECULATE=0 bit for bit.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..config import CameraConfig, SlamConfig
from ..cvo import engine, kernels
from ..data.tum import ImagePair
from .batch import _batch_backend


def _set_pcds(cvos, reqs):
    """set_pcd of each request's cloud (match_odometry, cvo.cpp:461-473)."""
    for cvo, (_, _, cloud, pixels) in zip(cvos, reqs):
        ready = cvo.set_pcd(cloud, pixels)
        assert ready, "cvo not initialized"
    return cvos


def _lane(host, j):
    """Lane j of a host tree (tuples and dicts of arrays with a leading lane
    axis)."""
    if isinstance(host, dict):
        return {k: v[j] for k, v in host.items()}
    return tuple(a[j] for a in host)


class _BatchExecutor:
    """Serves one round of same-kind requests in one batched dispatch and
    one host copy per result field."""

    def __init__(self, params, backend: str):
        self.params = params
        self.backend = _batch_backend(backend)

    @staticmethod
    def _align_inputs(cvos):
        return ([c.fixed for c in cvos], [c.moving for c in cvos],
                [c.R for c in cvos], [c.T for c in cvos],
                [np.float32(c.start_ell()) for c in cvos])

    def run_align(self, reqs):
        """reqs: [("align", cvo, cloud, pixels), ...] -> [transform, ...]."""
        cvos = _set_pcds([r[1] for r in reqs], reqs)
        res = engine.align_lanes(*self._align_inputs(cvos), self.params,
                                 self.backend)
        host = engine.to_host(tuple(res))
        return [cvo._apply_align(*_lane(host, j))
                for j, cvo in enumerate(cvos)]

    def run_align_ip(self, reqs):
        """reqs: [("align_ip", cvo, cloud, pixels), ...] ->
        [(transform, ip dict), ...]."""
        cvos = _set_pcds([r[1] for r in reqs], reqs)
        res, ip = engine.align_and_innerproduct_lanes(
            *self._align_inputs(cvos), self.params, self.backend)
        host_res, host_ip = engine.to_host((tuple(res), ip))
        return [(cvo._apply_align(*_lane(host_res, j)), _lane(host_ip, j))
                for j, cvo in enumerate(cvos)]

    def run_frame(self, reqs):
        """reqs: [("frame", odo_cvo, kf_cvo, cloud, pixels), ...] ->
        [(T_odo, ip_odo, T_kf, ip_kf), ...]: the whole frame of every
        sequence at once (engine.frame_step_lanes)."""
        odos = [r[1] for r in reqs]
        kfcs = [r[2] for r in reqs]
        for odo, kfc, (_, _, _, cloud, pixels) in zip(odos, kfcs, reqs):
            for cvo in (odo, kfc):
                ready = cvo.set_pcd(cloud, pixels)
                assert ready, "cvo not initialized"
        res1, ip1, res2, ip2, _ = engine.frame_step_lanes(
            [c.fixed for c in odos], [c.fixed for c in kfcs],
            [c.moving for c in odos], [c.R for c in odos],
            [c.T for c in odos], [np.float32(c.start_ell()) for c in odos],
            [c.transform.astype(np.float32) for c in kfcs],
            [np.float32(c.start_ell()) for c in kfcs], self.params,
            self.backend)
        h1, hip1, h2, hip2 = engine.to_host((tuple(res1), ip1, tuple(res2),
                                             ip2))
        return [(odo._apply_align(*_lane(h1, j)), _lane(hip1, j),
                 kfc._apply_align(*_lane(h2, j)), _lane(hip2, j))
                for j, (odo, kfc) in enumerate(zip(odos, kfcs))]

    def run_ip(self, reqs):
        """reqs: [("ip", cvo, tran), ...] -> [ip dict, ...]. The pass uses
        each cvo's current (post-align, annealed) ell, as the solo
        Cvo.compute_innerproduct does."""
        cvos = [r[1] for r in reqs]
        ip = engine.compute_innerproduct_lanes(
            [c.fixed for c in cvos], [c.moving for c in cvos],
            [np.asarray(r[2], np.float32) for r in reqs],
            [np.float32(c.ell) for c in cvos], self.params)
        host = engine.to_host(ip)
        return [_lane(host, j) for j in range(len(cvos))]


class MultiSequenceTracker:
    """S KeyframeTrackers advanced in lockstep with batched device work.

    OnlyTracking is read from cfg as in solo runs; without it, each
    sequence gets its own backend graph (features, loop closure, windowed
    and final BA). backend: an align backend, or "auto" for
    CVO_SLAM_BACKEND (engine.default_backend); device: where the trackers
    and their clouds live ("cuda" unless the caller asks for the CPU).
    One lane launch takes at most kernels.MAX_LANES sequences."""

    def __init__(self, cam: CameraConfig, cfg: SlamConfig, n_seq: int,
                 backend: str = "auto", device="cuda"):
        from ..app.run_slam import build_tracker
        if not 1 <= n_seq <= kernels.MAX_LANES:
            raise ValueError(f"{n_seq} sequences: lockstep runs 1 to "
                             f"{kernels.MAX_LANES} (the lanes of one launch)")
        self.cam = cam
        self.cfg = cfg
        self.n = n_seq
        self.backend = engine.default_backend() if backend == "auto" \
            else engine.check_backend(backend)
        self.trackers = []
        for _ in range(n_seq):
            t = build_tracker(cam, cfg, device=device)
            t.init()
            # the solo requests of the trackers' own paths take the same
            # backend; lockstep never hands a frame to their speculative
            # executors
            t.lt.cvo_odometry.backend = self.backend
            t.lt.cvo_keyframe.backend = self.backend
            t.lt.executor.enabled = False
            self.trackers.append(t)
        self._exec = _BatchExecutor(cfg.cvo, self.backend)
        self.rounds = {"frame": 0, "align_ip": 0, "align": 0, "ip": 0}

    def force_keyframe(self):
        for t in self.trackers:
            t.force_keyframe()

    def update(self, images: List[ImagePair]) -> List[np.ndarray]:
        """Advance every sequence by one frame; returns the poses."""
        assert len(images) == self.n
        gens = [t.update_steps(img) for t, img in zip(self.trackers, images)]
        poses: List = [None] * self.n
        pending: List = [None] * self.n

        def advance(i, send_val, first=False):
            try:
                pending[i] = gens[i].send(None if first else send_val)
            except StopIteration as e:
                poses[i] = e.value
                pending[i] = None

        for i in range(self.n):
            advance(i, None, first=True)

        runners = (("frame", self._exec.run_frame),
                   ("align_ip", self._exec.run_align_ip),
                   ("align", self._exec.run_align),
                   ("ip", self._exec.run_ip))
        while any(r is not None for r in pending):
            # every pending request of one kind in one dispatch; a sequence
            # at another phase (the bootstrap) waits for its kind's round
            for kind, runner in runners:
                idxs = [i for i, r in enumerate(pending)
                        if r is not None and r[0] == kind]
                if not idxs:
                    continue
                self.rounds[kind] += 1
                results = runner([pending[i] for i in idxs])
                for i, res in zip(idxs, results):
                    advance(i, res)
        for t in self.trackers:
            ex = t.lt.executor
            assert ex.spec is None and ex.hits == ex.misses \
                == ex.discards == 0, "a tracker's own executor ran"
        return poses
