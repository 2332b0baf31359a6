"""frontend_wait_ms: the mean ms per window frame that the frame loop
waited on the port's FramePrefetcher for the next frame (the harness's
clock around next(), benchmark/harness.py)."""


def read(window, cvo):
    if not window.frames:
        return None
    return 1e3 * sum(f.wait_s for f in window.frames) / len(window.frames)
