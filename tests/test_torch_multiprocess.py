"""The port's mesh across a process boundary: two gloo ranks on the CPU,
each owning two shards of one 4-shard mesh, run the edge-sharded LM
(parallel.multiprocess, the counterpart of tests/test_multiprocess.py with
tests/_mp_worker.py). The worker processes import torch and the port only.

The two ranks must agree bit for bit (every branch reads a psummed value,
and the all-reduce hands both ranks the same sum), and agree with the
in-process 4-shard mesh and with the JAX package's sharded LM on its
4-device virtual CPU mesh, on the same numpy chain, within the LM bars of
tests/test_sharded_lm.py (chi2 rtol 1e-3, poses rtol 1e-3 / atol 1e-4):
the group sums the two ranks' partial sums, an order of adds neither
in-process mesh uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JMesh

from cvo_slam_tpu.backend import lm as jlm
from cvo_slam_tpu.parallel import sharded_lm as jsl
from cvo_slam_tpu_torch.parallel import multiprocess
from cvo_slam_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(2)


def test_two_ranks_agree_with_each_other_and_one_process():
    (c0, E0), (c1, E1) = multiprocess.run_ranks(
        world=2, shards_per_rank=2, device="cpu", timeout_s=240)
    assert c0 == c1
    assert np.array_equal(E0, E1)
    c, E = multiprocess.single_process(4, device="cpu")
    np.testing.assert_allclose(c0, c, rtol=1e-3)
    np.testing.assert_allclose(E0, E, rtol=1e-3, atol=1e-4)
    assert np.isfinite(E0).all() and E0.shape == (multiprocess.POSES, 4, 4)
    # the JAX package's sharded LM on the same numpy chain, 4 devices
    g = multiprocess._problem("cpu")
    jg = jlm.PoseGraph(*(jnp.asarray(t.numpy().astype(np.int32)
                                     if t.dtype == torch.int64
                                     else t.numpy()) for t in g))
    Ej, cj = jsl.optimize_sharded(
        jg, JMesh(np.array(jax.devices()[:4]), ("dp",)),
        multiprocess.ITERATIONS, robust_delta=multiprocess.DELTA)
    np.testing.assert_allclose(c0, float(cj), rtol=1e-3)
    np.testing.assert_allclose(E0, np.asarray(Ej), rtol=1e-3, atol=1e-4)


def test_run_ranks_raises_without_the_card(monkeypatch):
    """run_ranks and single_process default to the card; without CUDA they
    raise before any work starts, and never run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multiprocess.run_ranks(world=2, shards_per_rank=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multiprocess.single_process(4)


def test_mesh_with_a_one_rank_group():
    """A mesh over a one-rank gloo group in this process: the rank owns
    every shard, psum and gather go through the group's all-reduce and
    all-gather."""
    port = multiprocess._free_port()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = Mesh(["cpu"] * 3, group=dist.group.WORLD)
        assert mesh.local_shards == [0, 1, 2]
        x = [torch.full((2,), float(s)) for s in range(3)]
        assert mesh.psum(x).tolist() == [3.0, 3.0]
        assert mesh.gather([t[None] for t in x]).shape == (3, 2)
    finally:
        dist.destroy_process_group()


def test_run_ranks_reports_a_failed_worker():
    """A worker that fails fails the call (no result is made up): a mesh
    of zero shards raises in both ranks."""
    with pytest.raises(RuntimeError, match="rank worker exited"):
        multiprocess.run_ranks(world=2, shards_per_rank=0, device="cpu",
                               timeout_s=120)
