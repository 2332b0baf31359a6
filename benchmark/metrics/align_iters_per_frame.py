"""align_iters_per_frame: the mean over window frames of the odometry and
keyframe align iterations (tracker.lt.metrics odo_iters + kf_iters)."""


def read(window, cvo):
    if not window.frames:
        return None
    return sum(f.odo_iters + f.kf_iters for f in window.frames) \
        / len(window.frames)
