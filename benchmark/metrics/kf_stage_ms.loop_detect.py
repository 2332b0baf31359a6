"""kf_stage_ms.loop_detect: ms per window keyframe event in the keyframe
graph's loop_detect stage (candidates, RANSAC, verification): its
graph.stage_ms readings, the clock readings the port's
`backend.loop_detect` span shares, summed over the window's events and
divided by their number (an event without the stage counts 0)."""


def read(window, cvo):
    rows = window.events
    if not rows:
        return None
    return sum(r.get("loop_detect", 0.0) for r in rows) / len(rows)
