"""Scaling harness: the sharded LM and Schur BA by shard count, with their
results against the single-device solvers (port of
cvo_slam_tpu.eval.scaling).

For each shard count (default 1, 2, 4, 8) and each solver (dense, pcg):

  * ms per call and LM outer iterations per second, the best of
    `repeats` timed calls after one untimed call (host clock, the device
    synchronized);
  * the mesh's collectives (psum / pmax / gather) per call;
  * max |E| difference and chi2 relative difference against
    backend.lm.optimize / backend.ba.optimize_ba on the same problem.

On cuda the shards go round-robin over the cards the machine has
(Mesh.on_cards with shared=True: one per card when it has as many), so on
one card every shard shares it and the shards run one after another. On the CPU (--device cpu) every shard is on
the CPU. Each row records its shards and cards, and the payload the card's
name and power limit as nvidia-smi reports them.

CLI:
  python -m cvo_slam_tpu_torch.eval.scaling --out PATH
      [--poses 48] [--landmarks 96] [--iters 10] [--repeats 3]
      [--shards 1 2 4 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..backend import ba, lm
from ..device import resolve_device
from ..ops import se3
from ..parallel import sharded_ba, sharded_lm
from ..parallel.mesh import Mesh


def _exp(xi):
    """float32 SE(3) exponentials of the twists xi (..., 6), on the host."""
    return se3.exp_se3(torch.as_tensor(np.asarray(xi, np.float32))).numpy()


def chain_pose_graph(rng, n, noise=0.02, lc_every=8, extra_random_edges=0,
                     device="cuda"):
    """A chain of n poses with odometry edges, a loop edge every lc_every
    poses and extra_random_edges random pair edges (so the sharded
    linearization outweighs the replicated solve), the first pose fixed,
    the others perturbed."""
    twists = rng.normal(0, 0.1, (n - 1, 6)).astype(np.float32)
    poses = [np.eye(4, dtype=np.float32)]
    for k in range(n - 1):
        poses.append(poses[-1] @ _exp(twists[k]))
    poses = np.array(poses)
    E_true = np.array([np.linalg.inv(p) for p in poses], np.float32)

    ei, ej, Z = [], [], []

    def add_edge(i, j, noisy):
        ei.append(i)
        ej.append(j)
        Zk = E_true[i] @ poses[j]
        if noisy:
            Zk = _exp(rng.normal(0, noise, 6)) @ Zk
        Z.append(Zk)

    for k in range(n - 1):
        add_edge(k, k + 1, noise > 0)
    for k in range(0, n - lc_every, lc_every):
        add_edge(k, k + lc_every, False)
    for _ in range(extra_random_edges):
        i, j = rng.choice(n, 2, replace=False)
        add_edge(int(min(i, j)), int(max(i, j)), noise > 0)

    m = len(ei)
    E0 = E_true.copy()
    E0[1:] = _exp(rng.normal(0, 0.02, (n - 1, 6))) @ E0[1:]
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return lm.pose_graph(E0, fixed, np.ones(n, bool), np.array(ei),
                         np.array(ej), np.array(Z, np.float32),
                         np.tile(np.eye(6, dtype=np.float32) * 50.0,
                                 (m, 1, 1)),
                         np.ones(m, bool), device=device)


def arc_ba_problem(rng, n_poses, n_lm):
    """Poses on an arc observing a field of n_lm landmarks (as
    tests/test_ba.py): a dict of optimize_ba's arguments as numpy arrays,
    the landmarks and the first pose perturbed / fixed, and K."""
    K = np.array([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1]], np.float32)
    step = _exp(np.array([0.01, -0.02, 0.005, 0.15, 0.02, 0.01])) \
        .astype(np.float64)
    poses = [np.eye(4)]
    for _ in range(n_poses - 1):
        poses.append(poses[-1] @ step)
    poses = np.array(poses)
    E_true = np.array([np.linalg.inv(p) for p in poses], np.float32)
    lms = rng.uniform([-2, -1.5, 3.0], [2, 1.5, 5.0], (n_lm, 3)
                      ).astype(np.float32)
    p_kf, p_lm, p_meas = [], [], []
    for li in range(n_lm):
        for vi in range(n_poses):
            Pc = E_true[vi, :3, :3] @ lms[li] + E_true[vi, :3, 3]
            if Pc[2] <= 0.1:
                continue
            uv = K @ Pc
            u, v = uv[0] / uv[2], uv[1] / uv[2]
            if not (0 <= u < 320 and 0 <= v < 240):
                continue
            p_kf.append(vi)
            p_lm.append(li)
            p_meas.append((u, v))
    m = len(p_kf)
    ei = np.arange(n_poses - 1)
    E0 = E_true.copy()
    E0[1:] = _exp(rng.normal(0, 0.01, (n_poses - 1, 6))) @ E0[1:]
    free = np.ones(n_poses, bool)
    free[0] = False
    return dict(
        E0=E0, L0=lms + rng.normal(0, 0.05, (n_lm, 3)).astype(np.float32),
        free_pose=free, lm_mask=np.ones(n_lm, bool), ei=ei, ej=ei + 1,
        Z=np.array([E_true[k] @ poses[k + 1] for k in range(n_poses - 1)],
                   np.float32),
        omega=np.tile(np.eye(6, dtype=np.float32) * 100.0,
                      (n_poses - 1, 1, 1)),
        pemask=np.ones(n_poses - 1, bool), p_kf=np.array(p_kf, np.int64),
        p_lm=np.array(p_lm, np.int64),
        p_meas=np.array(p_meas, np.float32).reshape(m, 2),
        p_w=np.ones(m, np.float32), p_mask=np.ones(m, bool)), K


BA_ARGS = ("E0", "L0", "free_pose", "lm_mask", "ei", "ej", "Z", "omega",
           "pemask", "p_kf", "p_lm", "p_meas", "p_w", "p_mask")


def optimize_ba_single(prob, K, iters, delta, device, solver="dense"):
    """backend.ba.optimize_ba on the numpy problem `prob` on `device`."""
    args = [torch.as_tensor(prob[k]).to(device) for k in BA_ARGS]
    return ba.optimize_ba(*args, torch.as_tensor(K).to(device), iters,
                          delta, solver=solver)


def card_line():
    """Card 0's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _time_best(fn, repeats, device):
    """(best seconds of `repeats` calls after one untimed call, the last
    result)."""
    def call():
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out
    out = call()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = call()
        best = min(best, time.perf_counter() - t0)
    return best, out


def _row(n, mesh, solver, iters, t, collectives, repeats, **deltas):
    return dict(shards=n, cards=len({d for d in mesh.devices}),
                solver=solver, iters_per_s=iters / t, ms_per_call=t * 1e3,
                collectives_per_call=collectives / (repeats + 1), **deltas)


def bench_lm(n_poses, iters, repeats, shards, device):
    rng = np.random.default_rng(0)
    g = chain_pose_graph(rng, n_poses, extra_random_edges=24 * n_poses,
                         device=device)
    t1, (E1, c1) = _time_best(lambda: lm.optimize(g, iters, robust_delta=2.0),
                              repeats, device)
    E1, c1 = E1.cpu().numpy(), float(c1)
    rows, base = [], {}
    for n in shards:
        mesh = Mesh.on_cards(n, device, shared=True)
        for solver in ("dense", "pcg"):
            run = sharded_lm.make_sharded_optimizer(g, mesh, iters,
                                                    robust_delta=2.0,
                                                    solver=solver)
            mesh.collectives = 0
            t, (E2, c2) = _time_best(lambda: run(g.E), repeats, device)
            base.setdefault(solver, t)
            rows.append(_row(
                n, mesh, solver, iters, t, mesh.collectives, repeats,
                efficiency_vs_1shard=base[solver] / t,
                max_abs_pose_delta=float(np.abs(E2.cpu().numpy() - E1)
                                         .max()),
                chi2_rel_delta=abs(float(c2) - c1) / max(abs(c1), 1e-12)))
    return dict(problem=dict(poses=n_poses, edges=int(g.ei.shape[0]),
                             lm_iterations=iters),
                single_device_ms=t1 * 1e3, shards=rows)


def bench_ba(n_poses, n_lm, iters, repeats, shards, device):
    prob, K = arc_ba_problem(np.random.default_rng(1), n_poses, n_lm)
    t1, (E1, _) = _time_best(
        lambda: optimize_ba_single(prob, K, iters, 2.0, device), repeats,
        device)
    E1 = E1.cpu().numpy()
    rows, base = [], {}
    for n in shards:
        mesh = Mesh.on_cards(n, device, shared=True)
        sharded, _, _ = sharded_ba.shard_ba_problem(
            n, *(prob[k] for k in ("L0", "lm_mask", "p_kf", "p_lm", "p_meas",
                                   "p_w", "p_mask", "ei", "ej", "Z", "omega",
                                   "pemask")))
        for solver in ("dense", "pcg"):
            run = sharded_ba.make_ba_optimizer(prob["free_pose"], sharded, K,
                                               iters, 2.0, mesh,
                                               solver=solver)
            mesh.collectives = 0
            t, (E2, _) = _time_best(lambda: run(prob["E0"]), repeats, device)
            base.setdefault(solver, t)
            rows.append(_row(
                n, mesh, solver, iters, t, mesh.collectives, repeats,
                efficiency_vs_1shard=base[solver] / t,
                max_abs_pose_delta=float(np.abs(E2.cpu().numpy() - E1)
                                         .max())))
    return dict(problem=dict(poses=n_poses, landmarks=n_lm,
                             projection_edges=int(prob["p_kf"].shape[0]),
                             lm_iterations=iters),
                single_device_ms=t1 * 1e3, shards=rows)


def run_harness(out_path, poses=48, landmarks=96, iters=10, repeats=3,
                shards=(1, 2, 4, 8), device="cuda"):
    """Both benches; writes the payload as JSON to out_path and returns
    it."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    payload = dict(
        device=str(device),
        card=card_line() if cuda else None,
        cards=torch.cuda.device_count() if cuda else 0,
        host_cpus=os.cpu_count(),
        lm=bench_lm(poses, iters, repeats, shards, device),
        # the BA bench at up to 24 poses, as the JAX package's harness
        ba=bench_ba(min(poses, 24), landmarks, iters, repeats, shards,
                    device),
    )
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload["lm"]["shards"]))
    print(json.dumps(payload["ba"]["shards"]))
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True,
                    help="path of the JSON payload")
    ap.add_argument("--poses", type=int, default=48)
    ap.add_argument("--landmarks", type=int, default=96)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu puts every shard "
                         "on the CPU)")
    args = ap.parse_args(argv)
    run_harness(args.out, args.poses, args.landmarks, args.iters,
                args.repeats, tuple(args.shards), args.device)


if __name__ == "__main__":
    main()
