"""The comparison that decides `correct` fails what it should: the
control (the reference one precision down in the program's place), and a
run with the timed path broken underneath, once for each fault a cell can
have. A tracking cell: an align that returns the state it started from;
a keyframe transform altered where it is produced; a cloud point altered
where it is produced. The SLAM cell, for its backend: a windowed BA that
returns the state it started from; a loop-closure verification that
returns the state it started from (its RANSAC prior); a verification's
inner product altered where it is produced; a cloud point altered. Each
at the CPU tests' size here; test_bench_gpu.py runs them at the cells'
size on the card against the cells' limits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import run

from .util import SEED, small_cell, small_limits, window_seconds

CELLS = ["tum_fr1-pallas_mom.track", "tum_fr1-pallas.slam_loop"]


def _run(name, control=False):
    cell, ov = small_cell(name)
    return run.run_cell(cell, SEED, window_seconds(cell), False, "cpu",
                        overrides=ov, control=control,
                        limits=small_limits(cell))


def _start_align(fixed, moving, R0, T0, ell0, p, backend="pallas_mom"):
    """An align that returns the state it started from."""
    from cvo_slam_tpu_torch.cvo import engine
    dev = fixed.device
    R = engine._f32(R0, dev)
    T = engine._f32(T0, dev)
    return engine.AlignResult(
        R, T, engine.se3.make_pose(R.T, -(R.T @ T)),
        engine._f32(ell0, dev).reshape(()),
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev))


def _unchanged(monkeypatch):
    from cvo_slam_tpu_torch.cvo import engine
    monkeypatch.setattr(engine, "align", _start_align)


def _altered_transform(monkeypatch):
    from cvo_slam_tpu_torch.cvo import engine
    orig = engine.frame_step
    nudge = torch.tensor([[1.0, -2e-2, 0, 2e-2], [2e-2, 1.0, 0, 0],
                          [0, 0, 1.0, 0], [0, 0, 0, 1.0]])

    def frame_step(*a, **k):
        res1, ip1, res2, ip2, guess = orig(*a, **k)
        moved = res2.transform @ nudge.to(res2.transform.device)
        return res1, ip1, res2._replace(transform=moved), ip2, guess

    monkeypatch.setattr(engine, "frame_step", frame_step)


def _altered_cloud(monkeypatch):
    from cvo_slam_tpu_torch.data import prefetch
    orig = prefetch.create_pointcloud

    def create_pointcloud(*a, **k):
        pc = orig(*a, **k)
        pc.positions[0] += np.float32(1e-3)
        return pc

    monkeypatch.setattr(prefetch, "create_pointcloud", create_pointcloud)


def _ba_unchanged(monkeypatch):
    from cvo_slam_tpu_torch.backend import ba

    def optimize_ba(E0, L0, *args, **kw):
        return E0.clone(), L0.clone()

    monkeypatch.setattr(ba, "optimize_ba", optimize_ba)


def _verification_unchanged(monkeypatch):
    from cvo_slam_tpu_torch.cvo import engine
    eye4 = np.eye(4, dtype=np.float32)

    def lc_verify_batch(fixed, movings, R0, T0, ell0, priors, lc_priors, p,
                        backend="pallas_mom"):
        out = []
        for l, moving in enumerate(movings):
            res = _start_align(fixed, moving, R0[l], T0[l], ell0[l], p)
            out.append((res, engine.compute_innerproduct_lc(
                fixed, moving, priors[l], lc_priors[l], eye4,
                res.transform, res.ell, p)))
        return out

    monkeypatch.setattr(engine, "lc_verify_batch", lc_verify_batch)


def _altered_verification(monkeypatch):
    from cvo_slam_tpu_torch.cvo import engine
    orig = engine.lc_verify_batch

    def lc_verify_batch(*a, **k):
        return [(res, dict(lc, inn_lc_post=lc["inn_lc_post"] * 1.05))
                for res, lc in orig(*a, **k)]

    monkeypatch.setattr(engine, "lc_verify_batch", lc_verify_batch)


FAULTS = {
    "tum_fr1-pallas_mom.track": {"align_unchanged": _unchanged,
                                 "transform_altered": _altered_transform,
                                 "cloud_altered": _altered_cloud},
    "tum_fr1-pallas.slam_loop": {"ba_unchanged": _ba_unchanged,
                                 "verification_altered":
                                     _altered_verification,
                                 "verification_unchanged":
                                     _verification_unchanged,
                                 "cloud_altered": _altered_cloud},
}


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in sorted(FAULTS[c])])
def test_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[name][fault](monkeypatch)
    res = _run(name)
    assert not res["correct"], res["check"]
    if fault.startswith("verification"):
        # the loop-closure numbers catch it, not a number of another layer
        assert any(not _within(r) for k, r in res["check"].items()
                   if k.startswith("lc_")), res["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = _run(name, control=True)
    assert not res["correct"], res["check"]
    assert any(not _within(r) for r in res["check"].values())


def _within(row) -> bool:
    return isinstance(row["value"], (int, float)) \
        and row["value"] <= row["limit"]
