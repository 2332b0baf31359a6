"""The reader of frontend_points_per_frame on recorded window frames: the
mean of the host clouds' `n_selected`, and nothing to read where a cloud
lacks the counter (the program before it had one) or no frame was kept."""

from __future__ import annotations

import types

import pytest

from benchmark import harness, spec

READ = spec.load_reader("frontend_points_per_frame")


def _window(clouds):
    frames = [harness.FrameRec(g=g, lap_k=g, latency_s=0.05, wait_s=0.0,
                               odo_iters=10, kf_iters=12, accept=1,
                               nan_moved=False, cloud=c)
              for g, c in enumerate(clouds)]
    return harness.Window(frames=frames, window_s=0.1, failed=0, events=[],
                          verifies=[])


def _cloud(count, n_selected=None):
    c = types.SimpleNamespace(count=count)
    if n_selected is not None:
        c.n_selected = n_selected
    return c


def test_mean_of_the_selected_points():
    w = _window([_cloud(3072, 3210), _cloud(2900, 2900), _cloud(3000, 3000)])
    assert READ(w, {}) == pytest.approx((3210 + 2900 + 3000) / 3)


@pytest.mark.parametrize("clouds", [
    [_cloud(3000), _cloud(2990)],              # clouds without the counter
    [_cloud(3000, 3000), _cloud(2990)],        # one frame without it
    [None],                                    # a frame with no cloud kept
    [],                                        # no frame
])
def test_nothing_to_read(clouds):
    assert READ(_window(clouds), {}) is None
