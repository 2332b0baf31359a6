"""Batched CVO alignment over a leading lane axis (port of
cvo_slam_tpu.parallel.batch).

S alignments run together, each lane as its solo run (vmap-of-while
semantics: a lane that has stopped is frozen while the others iterate).
The JAX package vmaps engine.align; the port writes the lane axis out:
under 'pallas' the S align loops are the lanes of one align_fused launch
(cvo.kernels.align_fused_lanes), one CUDA kernel for the whole batch.
make_sharded_align splits the lanes over the shards of a mesh.
"""

from __future__ import annotations

from ..config import CvoParams
from ..cvo import engine
from .mesh import Mesh


def _batch_backend(backend: str) -> str:
    """The align backend of a batch of lanes. 'pallas' and 'pallas_iter'
    run as the lanes of one align_fused launch ('pallas'), as the JAX
    package routes them (its per-iteration kernels do not vmap). The JAX
    package routes 'pallas_mom' to its XLA moment path, which the port does
    not have (engine.check_backend): the port serves 'pallas_mom' lane by
    lane through the solo moment path, so a batch under 'pallas_mom'
    equals its solo 'pallas_mom' runs exactly, where the JAX package's
    equals its solo 'xla' runs."""
    engine.check_backend(backend)
    return "pallas" if backend in ("pallas", "pallas_iter") else backend


def batched_align(fixed: engine.PointCloud, moving: engine.PointCloud, R0,
                  T0, ell0, p: CvoParams,
                  backend: str = "auto") -> engine.AlignResult:
    """engine.align over a leading lane axis: moving (S, CAP, .) clouds,
    fixed (S, CAP, .) clouds or one (CAP, .) cloud of every lane, R0
    (S, 3, 3), T0 (S, 3), ell0 (S,). Returns an AlignResult whose entries
    have a leading lane axis; each lane equals engine.align on its inputs
    under the backend _batch_backend picks."""
    if backend == "auto":
        backend = engine.default_backend()
    backend = _batch_backend(backend)
    shared = fixed.positions.dim() == 2
    return engine.align_lanes(
        fixed if shared else engine.unstack_clouds(fixed),
        engine.unstack_clouds(moving), R0, T0, ell0, p, backend,
        moving_stacked=moving, fixed_stacked=fixed)


def make_sharded_align(mesh: Mesh, p: CvoParams, backend: str = "auto"):
    """batched_align with the lanes split over `mesh`: S lanes (S a
    multiple of the shard count) in contiguous blocks, one per shard; each
    shard runs batched_align on its block on its device (under 'pallas' one
    align_fused_lanes launch), and the results are gathered on
    mesh.device. Each lane equals batched_align's lane bit for bit. The
    returned fn takes (fixed, moving, R0, T0, ell0) as batched_align
    does."""

    def fn(fixed, moving, R0, T0, ell0):
        S = moving.positions.shape[0]
        if S % mesh.size:
            raise ValueError(f"{S} lanes do not split over {mesh.size} "
                             f"shards")
        per = S // mesh.size
        shared = fixed.positions.dim() == 2
        outs = []
        for s in mesh.local_shards:
            dev, sl = mesh.devices[s], slice(s * per, (s + 1) * per)

            def part(t):
                return t[sl].to(dev)
            f = engine.PointCloud(*(t.to(dev) if shared else part(t)
                                    for t in fixed))
            m = engine.PointCloud(*(part(t) for t in moving))
            with mesh.on(s):
                outs.append(batched_align(f, m, part(R0), part(T0),
                                          part(ell0), p, backend))
        return engine.AlignResult(*(mesh.gather([o[k] for o in outs])
                                    for k in range(len(outs[0]))))

    return fn
