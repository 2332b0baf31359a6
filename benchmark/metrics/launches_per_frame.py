"""launches_per_frame: CUDA kernel launches the runtime recorded in the
traced frames, per frame (benchmark/trace.py: only sessions in which every
launch has its kernel in the trace)."""


def read(window, cvo):
    t = window.trace
    if not t or not t["frames"]:
        return None
    return t["launches"] / t["frames"]
