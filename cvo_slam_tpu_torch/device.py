"""Device selection shared by the port's entry points, and the side-stream
worker its pipelines (speculative frame dispatch, loop-closure verification,
the async backend) run device work on."""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (the port never drops quietly to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' explicitly to run the plain PyTorch path")
    return dev


def side_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    """A new CUDA stream on `device`, or None on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def submit_event(device: torch.device):
    """An event on the calling thread's current stream, marking the work
    queued so far (None on the CPU). A side stream that waits on it sees
    every tensor the caller made before the call."""
    if device.type != "cuda":
        return None
    return torch.cuda.current_stream(device).record_event()


def run_on_stream(stream, ready, fn, *args):
    """fn(*args) with `stream` current (as given on the CPU, stream None):
    the stream first waits on `ready` (submit_event of the submitter), and
    is drained before this returns, so the results are complete for any
    thread, and every tensor fn held was last used by finished work when
    its memory goes back to the caching allocator."""
    if stream is None:
        return fn(*args)
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        try:
            return fn(*args)
        finally:
            stream.synchronize()


class StreamWorker:
    """One worker thread that runs submitted calls in order, each through
    run_on_stream on the thread's own side stream (CUDA), or plainly (CPU).

    A call's inputs may be tensors of the submitting thread's stream; its
    results are read only as host values or by later calls of the same
    worker (never on the submitter's stream, whose allocator pool does not
    own their memory)."""

    def __init__(self, device, name: str):
        self.device = torch.device(device)
        self.stream = side_stream(self.device)
        self._pool = ThreadPoolExecutor(1, thread_name_prefix=name)

    def submit(self, fn, *args) -> Future:
        return self._pool.submit(run_on_stream, self.stream,
                                 submit_event(self.device), fn, *args)
