"""kf_event_ms: the ms of every stage of the window's keyframe events
(the keyframe graph's stage_ms rows: insert, loop_detect, windowed_ba, and
on the last map final_ba and refine_frames), summed and divided by the
number of events."""


def read(window, cvo):
    rows = window.events
    if not rows:
        return None
    return sum(sum(r.values()) for r in rows) / len(rows)
