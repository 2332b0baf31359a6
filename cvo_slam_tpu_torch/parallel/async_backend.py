"""Asynchronous frontend/backend pipeline (port of
cvo_slam_tpu.parallel.async_backend).

Replacement for the reference's UseMultiThreading path, a TBB consumer
thread over a bounded queue that the authors flagged as broken
("Please do not enable multithreading", keyframe_graph.cpp:2091-2095,
shipped config UseMultiThreading 0). Completed local maps are enqueued and
consumed by one worker thread that drives the global KeyframeGraph, so loop
closure and windowed BA overlap frame tracking. `flush()` joins the queue
before the final trajectory is written; the worker's exceptions are raised
to the caller by flush() and close() instead of dying silently.

Streams: the tracker launches its kernels on its thread's current stream
(the device's default stream unless the caller set another); the worker
launches the backend's on a side stream of its own (device.side_stream).
Each map's device work starts after the stream waits on an event the
tracker recorded when it enqueued the map, so the keyframe clouds the
tracker made are complete, and the side stream is drained after each map,
so everything the backend hands back (host poses, edges) is final and the
tensors it dropped were last used by finished work.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from ..device import resolve_device, run_on_stream, side_stream, submit_event


class AsyncKeyframeGraph:
    """Wraps a backend KeyframeGraph with a single consumer thread; `device`
    is where the graph's device work runs."""

    def __init__(self, graph, device="cuda", max_queue: int = 4):
        self._graph = graph
        self._device = resolve_device(device)
        self._stream = side_stream(self._device)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="keyframe-graph-backend")
        self._thread.start()

    # -- KeyframeGraph API surface used by the tracker ---------------------
    def add(self, local_map):
        self._raise_if_failed()
        self._queue.put((local_map, submit_event(self._device)))

    def keyframes(self):
        self.flush()
        return self._graph.keyframes()

    def loop_closure_rows(self):
        self.flush()
        return self._graph.loop_closure_rows()

    def __getattr__(self, name):
        # delegate everything else (lc_num, edges, stage_ms, ...); callers
        # that inspect state should flush() first
        return getattr(self._graph, name)

    # -- pipeline control ---------------------------------------------------
    def flush(self):
        """Block until every enqueued map is processed; re-raise failures."""
        self._queue.join()
        self._raise_if_failed()

    def close(self):
        self.flush()
        self._queue.put(None)
        self._thread.join()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("backend thread failed") from err

    def _run(self):
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            local_map, ready = item
            try:
                run_on_stream(self._stream, ready, self._graph.add, local_map)
            except Exception as e:   # noqa: BLE001 — raised by flush()
                self._error = e
            finally:
                self._queue.task_done()
