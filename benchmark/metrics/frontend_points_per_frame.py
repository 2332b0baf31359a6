"""frontend_points_per_frame: the mean over window frames of the points
the port's selector chose with a valid depth before the cloud's capacity
cut them (the host cloud's `n_selected` counter,
cvo_slam_tpu_torch/frontend/pointcloud.py); nothing to read where a
frame's cloud lacks the counter."""


def read(window, cvo):
    counts = [getattr(f.cloud, "n_selected", None) for f in window.frames]
    if not counts or None in counts:
        return None
    return sum(counts) / len(counts)
