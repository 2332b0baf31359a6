"""The sharded LM over a mesh that spans processes: each rank of a gloo
group owns a contiguous run of the shards (parallel.mesh.Mesh with a
group), and every psum crosses the process boundary (the JAX package's
two-process jax.distributed run, tests/_mp_worker.py).

`run_ranks` starts `world` processes of this module on one machine, each
with `shards_per_rank` shards, on eval.scaling's chain graph (16 poses, 32
extra edges, 5 LM iterations, Cauchy delta 2), and returns each rank's
(chi2, E_opt). `single_process` solves the same problem over an in-process
mesh of as many shards, for comparison. Both run on the card unless asked
for device="cpu"; on cuda the shards are dealt round-robin over the
machine's cards (Mesh.on_cards with shared=True), so on one card every
rank's shards share it.

Worker usage (run_ranks starts it):
  python -m cvo_slam_tpu_torch.parallel.multiprocess --rank R --world W \
      --port P [--shards-per-rank 2] [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import datetime
import os
import re
import socket
import subprocess
import sys

import numpy as np
import torch.distributed as dist

from ..device import resolve_device
from ..eval.scaling import chain_pose_graph
from . import sharded_lm
from .mesh import Mesh

POSES, EXTRA_EDGES, ITERATIONS, DELTA = 16, 32, 5, 2.0
_RESULT = re.compile(r"RESULT rank=(\d+) chi2=(\S+) E=(\S+)")


def _problem(device):
    return chain_pose_graph(np.random.default_rng(0), POSES,
                            extra_random_edges=EXTRA_EDGES, device=device)


def _solve(mesh):
    g = _problem(mesh.device)
    E, chi2 = sharded_lm.make_sharded_optimizer(
        g, mesh, ITERATIONS, robust_delta=DELTA)(g.E)
    return float(chi2), E.cpu().numpy()


def single_process(shards: int, device="cuda"):
    """(chi2, E_opt) of the problem over an in-process mesh of `shards`
    shards on `device`."""
    return _solve(Mesh.on_cards(shards, device, shared=True))


def worker(rank, world, port, shards_per_rank, device="cuda",
           timeout_s=120):
    device = resolve_device(device)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = Mesh.on_cards(world * shards_per_rank, device, shared=True,
                             group=dist.group.WORLD)
        chi2, E = _solve(mesh)
    finally:
        dist.destroy_process_group()
    print(f"RESULT rank={rank} chi2={chi2.hex()} "
          f"E={base64.b64encode(E.astype(np.float32).tobytes()).decode()}",
          flush=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world=2, shards_per_rank=2, device="cuda", timeout_s=300):
    """Start `world` worker processes and return [(chi2, E_opt)] by rank.
    Raises when CUDA is asked for and absent, and when a worker fails,
    prints no result or outlasts timeout_s (every worker is stopped before
    this returns)."""
    device = str(resolve_device(device))
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cvo_slam_tpu_torch.parallel.multiprocess",
         "--rank", str(r), "--world", str(world), "--port", str(port),
         "--shards-per-rank", str(shards_per_rank), "--device", device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = {}
    for p, out in zip(procs, outs):
        m = _RESULT.search(out)
        if p.returncode != 0 or not m:
            raise RuntimeError(f"rank worker exited {p.returncode}:\n"
                               f"{out[-3000:]}")
        E = np.frombuffer(base64.b64decode(m.group(3)), np.float32)
        results[int(m.group(1))] = (float.fromhex(m.group(2)),
                                    E.reshape(POSES, 4, 4))
    return [results[r] for r in range(world)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--shards-per-rank", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    worker(args.rank, args.world, args.port, args.shards_per_rank,
           args.device)


if __name__ == "__main__":
    main()
