"""kf_stage_ms.windowed_ba: ms per window keyframe event in the keyframe
graph's windowed_ba stage (the windowed bundle adjustment): its
graph.stage_ms readings, the clock readings the port's
`backend.windowed_ba` span shares, summed over the window's events and
divided by their number (an event without the stage counts 0)."""


def read(window, cvo):
    rows = window.events
    if not rows:
        return None
    return sum(r.get("windowed_ba", 0.0) for r in rows) / len(rows)
