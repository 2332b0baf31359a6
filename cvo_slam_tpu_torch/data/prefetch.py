"""Host-side frame prefetch pipeline (copy of cvo_slam_tpu.data.prefetch).

The reference is strictly sequential: imread -> pcd_generator -> CVO per
frame (run_SLAM.cpp:70-87). Here the host frontend (PNG decode, pyramid,
DSO selection, back-projection — ~10 ms/frame with the native selector) runs
on worker threads a few frames ahead of the tracker, so it overlaps with the
device-side CVO work of the current frame. Frames are delivered strictly in
order; the output is bit-identical to the synchronous path (the frontend is
deterministic and per-frame independent).

Usage:
    for image in FramePrefetcher(folder, records, cam, cfg.frontend):
        tracker.update(image)   # image.precomputed_cloud is filled in
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List

from .. import spans
from ..config import CameraConfig, FrontendParams
from ..frontend.pointcloud import create_pointcloud, span_attrs
from . import tum


class FramePrefetcher:
    """Iterate ImagePairs with `precomputed_cloud` filled by worker threads.

    depth: how many frames may be in flight ahead of the consumer (bounds
    host memory: each frame holds its images + fixed-capacity cloud)."""

    def __init__(self, folder: str, records: List[tum.FrameRecord],
                 cam: CameraConfig, fp: FrontendParams,
                 depth: int = 4, workers: int = 2):
        self.folder = folder
        self.records = records
        self.cam = cam
        self.fp = fp
        self.depth = max(1, depth)
        self.workers = max(1, workers)

    def _produce(self, k: int) -> tum.ImagePair:
        with spans.span("prefetch.load", k) as sp:
            image = tum.load_image(self.folder, self.records[k])
            pc = image.precomputed_cloud = create_pointcloud(
                image.bgr, image.gray, image.depth, self.cam, self.fp)
            span_attrs(sp, pc, image.gray.shape)
            return image

    def __len__(self):
        return len(self.records)

    def __iter__(self) -> Iterator[tum.ImagePair]:
        if not self.records:
            return
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending = {}
            next_submit = 0

            def top_up(consumed_idx):
                nonlocal next_submit
                while (next_submit < len(self.records)
                       and next_submit - consumed_idx < self.depth):
                    pending[next_submit] = pool.submit(self._produce,
                                                       next_submit)
                    next_submit += 1

            top_up(0)
            for i in range(len(self.records)):
                top_up(i)
                yield pending.pop(i).result()
