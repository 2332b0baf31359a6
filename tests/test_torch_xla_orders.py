"""The xla align's orders of sums against the JAX package's xla on the CPU:
helpers of tests/test_torch_xla.py and a script for PERF.md's tables (no
tests of its own).

Two f32 orders of the port's xla pass: the lanes' (engine.align(...,
"xla"), the one-lane run of the lane program: ops/pairwise.
flow_and_step_moments_lanes, the moved cloud per component) and the JAX
package's term order (ops/pairwise.flow_and_step_moments through
engine.align_loop, the moved cloud y0 @ R + Tt). Each is run

  * on tests/test_torch_tracking.py's 8-frame 160x120 sequence through the
    tracker (CVO_SLAM_BACKEND=xla) against the JAX package's tracker (its
    CPU default, xla): per alignment the iterations and the pose gap;
  * on chip_smoke.py's frame pairs (the synthetic sequence, seed 7,
    640x480, CAP 3072) from the identity at ell 0.15 against the JAX
    package's xla align, and (`--trace`) iteration by iteration on frames
    0 -> 1: the flow norms, the step, the se3 distance of the increment.

    python tests/test_torch_xla_orders.py [--threads 2] [--pairs 6] [--trace]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def first_pair_clouds(folder, n_pairs=1):
    """The JAX package's and the port's clouds of chip_smoke.py's first
    n_pairs + 1 frames (seed 7, 640x480, TUM1, CAP 3072), rendered into
    `folder`: (jax clouds, port clouds on the CPU)."""
    from cvo_slam_tpu.config import CAMERA_PRESETS, FrontendParams
    from cvo_slam_tpu.cvo import engine as jengine
    from cvo_slam_tpu.data import synthetic, tum
    from cvo_slam_tpu.frontend.pointcloud import create_pointcloud
    from cvo_slam_tpu_torch.cvo import engine as tengine
    cam = CAMERA_PRESETS["TUM1"]
    synthetic.make_sequence(folder, cam, n_frames=n_pairs + 1)
    fp = FrontendParams(cloud_capacity=3072)
    records = tum.load_association(os.path.join(folder, "associate.txt"))
    pcs = [create_pointcloud(im.bgr, im.gray, im.depth, cam, fp)
           for im in (tum.load_image(folder, r)
                      for r in records[:n_pairs + 1])]
    return ([jengine.PointCloud.from_host(pc) for pc in pcs],
            [tengine.PointCloud.from_host(pc, "cpu") for pc in pcs])


def _product(kind):
    """The moment product A^T U of an order: torch.mm (as the port's
    ops/pairwise.moment_product), in f64 then rounded, or as (U^T A)^T."""
    if kind == "f64":
        return lambda A, U: torch.mm(A.T.double(), U.double()).float()
    if kind == "ut":
        return lambda A, U: torch.mm(U.T, A).T
    return lambda A, U: torch.mm(A.T, U)


# the orders of sums of the solo xla align: the port's (the lanes' order,
# engine.align(..., "xla")) and the JAX package's term order
# (ops/pairwise.flow_and_step_moments, engine.py:178-220 there) with three
# moment products
ORDERS = {"lanes": None, "jax": "mm", "jax, f64 product": "f64",
          "jax, U^T A product": "ut"}


def align_order(order, fixed, moving, R0, T0, ell0, p):
    """The port's xla align in `order` (ORDERS): 'lanes' is
    engine.align(..., "xla"); the others run the JAX term order through
    engine.align_loop, the moved cloud y0 @ R + Tt."""
    from cvo_slam_tpu_torch.cvo import engine
    from cvo_slam_tpu_torch.ops import pairwise
    if ORDERS[order] is None:
        return engine.align(fixed, moving, R0, T0, ell0, p, "xla")
    x, fx, mx = fixed
    ckg = pairwise.color_kernel_gated(fx, moving.features, mx, moving.mask,
                                      p)
    center, U = pairwise.step_moment_basis(x, mx)
    product = _product(ORDERS[order])

    def iterate(y, ell):
        A, keep = pairwise.cvo_kernel_from_color(x, y, ckg, ell, p)
        return pairwise.flow_and_step_from_moments(
            product(A, U), y, center, ell, torch.sum(keep, dtype=torch.int32),
            p)
    dev = x.device
    return engine.align_loop(iterate, moving.positions, engine._f32(R0, dev),
                             engine._f32(T0, dev),
                             engine._f32(ell0, dev).reshape(()), p)


def _transform(R, T):
    R = np.asarray(R, np.float64)
    return R.T, -(R.T @ np.asarray(T, np.float64))


def pose_gap(a, b):
    """(max |dt| m, angle rad) between two align states (R, T)."""
    (Ra, ta), (Rb, tb) = _transform(*a), _transform(*b)
    D = Ra.T @ Rb
    return float(np.abs(ta - tb).max()), 0.5 * float(np.linalg.norm(
        [D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]]))


def pair_table(n_pairs):
    """Per frame pair and order: the (port, JAX) xla iterations and the
    order's pose gap to the JAX result."""
    import jax.numpy as jnp
    from cvo_slam_tpu.config import SlamConfig
    from cvo_slam_tpu.cvo import engine as jengine
    from cvo_slam_tpu_torch.config import from_reference
    p = SlamConfig.default_shipped().cvo
    tp = from_reference(p)
    rows = []
    with tempfile.TemporaryDirectory() as folder:
        jc, tc = first_pair_clouds(folder, n_pairs)
        for k in range(n_pairs):
            want = jengine.align(jc[k], jc[k + 1], jnp.eye(3), jnp.zeros(3),
                                 jnp.float32(0.15), p, "xla")
            init = (torch.eye(3), torch.zeros(3), torch.tensor(0.15))
            for order in ORDERS:
                got = align_order(order, tc[k], tc[k + 1], *init, tp)
                rows.append(dict(pair=f"{k}->{k + 1}", order=order,
                                 iters=(int(got.iters), int(want.iters)),
                                 gap=pose_gap((got.R, got.T),
                                              (want.R, want.T))))
    return rows


def engine_table():
    """tests/test_torch_xla.py's test_xla_align_matches_jax cases
    (tests/test_torch_engine.py's pairs) per order: (port, JAX)
    iterations and nnz, ell equal, the largest transform difference."""
    import jax.numpy as jnp
    from cvo_slam_tpu.config import CvoParams
    from cvo_slam_tpu.cvo import engine as jengine
    from cvo_slam_tpu_torch.config import from_reference
    sys.path.insert(0, HERE)
    from test_torch_engine import XI, _pair, _port_cloud
    p = CvoParams()
    tp = from_reference(p)
    rows = []
    for seed, which in ((0, 0), (1, 1), (0, 1)):
        fixed, moved = _pair(seed, XI[which])
        want = jengine.align(fixed, moved, jnp.eye(3), jnp.zeros(3),
                             jnp.float32(p.ell_init), p, "xla")
        for order in ORDERS:
            got = align_order(order, _port_cloud(fixed), _port_cloud(moved),
                              torch.eye(3), torch.zeros(3),
                              torch.tensor(p.ell_init), tp)
            rows.append(dict(
                case=(seed, which), order=order,
                iters=(int(got.iters), int(want.iters)),
                nnz=(int(got.nnz), int(want.nnz)),
                ell_equal=float(got.ell) == float(want.ell),
                transform=float(np.abs(got.transform.numpy() - np.asarray(
                    want.transform)).max())))
    return rows


def tracking_table():
    """tests/test_torch_tracking.py's sequence under xla: per tracked frame
    the (port, JAX) odometry and keyframe iterations, the pose gap and
    whether the decisions agree, per order (ORDERS)."""
    from cvo_slam_tpu.app import run_slam as jrun
    from cvo_slam_tpu.config import SlamConfig
    from cvo_slam_tpu.data import synthetic, tum
    from cvo_slam_tpu_torch.app import run_slam as trun
    from cvo_slam_tpu_torch.config import from_reference
    from cvo_slam_tpu_torch.cvo import engine as tengine
    from cvo_slam_tpu_torch.data import tum as ttum
    sys.path.insert(0, HERE)
    from test_torch_tracking import (CAM, N_FRAMES, SMALL_FRONTEND,
                                     STEP_TWIST, _rot_angle, _track)
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True,
                                               frontend=SMALL_FRONTEND)
    out = {}
    with tempfile.TemporaryDirectory() as folder:
        synthetic.make_sequence(folder, CAM, n_frames=N_FRAMES,
                                step_twist=STEP_TWIST)
        want = _track(jrun.build_tracker(CAM, cfg), tum.load_image, folder)
        solo = tengine.align
        os.environ["CVO_SLAM_BACKEND"] = "xla"
        try:
            for order in ORDERS:
                def swapped(f, m, R0, T0, e0, p, backend="pallas_mom",
                            order=order):
                    if backend != "xla" or ORDERS[order] is None:
                        return solo(f, m, R0, T0, e0, p, backend)
                    return align_order(order, f, m, R0, T0, e0, p)
                tengine.align = swapped
                got = _track(trun.build_tracker(
                    from_reference(CAM), from_reference(cfg), device="cpu"),
                    ttum.load_image, folder)
                out[order] = [dict(
                    odo=(g["odo_iters"], w["odo_iters"]),
                    kf=(g["kf_iters"], w["kf_iters"]),
                    pos=float(np.abs(g["pose"][:3, 3]
                                     - w["pose"][:3, 3]).max()),
                    rot=_rot_angle(g["pose"][:3, :3], w["pose"][:3, :3]),
                    same=(g["accept"], g["keyframe"]) == (w["accept"],
                                                          w["keyframe"]))
                    for g, w in zip(got, want)]
        finally:
            tengine.align = solo
            os.environ.pop("CVO_SLAM_BACKEND", None)
    return out


def trace(order):
    """Frames 0 -> 1 iteration by iteration: (k, ell, |omega|, |v|, step,
    se3 distance of the increment) until a stop rule fires, for the port's
    pass in `order` ('lanes' or 'jax') or the JAX package's pass ('jax
    package', jitted alone); the loop in Python with the port's step, stop
    and anneal, the moved cloud y0 @ R + Tt."""
    from cvo_slam_tpu.config import SlamConfig
    from cvo_slam_tpu_torch.config import from_reference
    from cvo_slam_tpu_torch.ops import cubic, pairwise, se3
    p = SlamConfig.default_shipped().cvo
    tp = from_reference(p)
    rows = []
    with tempfile.TemporaryDirectory() as folder:
        jc, tc = first_pair_clouds(folder, 1)
    if order == "jax package":
        import jax
        import jax.numpy as jnp
        from cvo_slam_tpu.ops import pairwise as jpw
        x, fx, mx = jc[0]
        y0, fy, my = jc[1]
        ckg = jpw.color_kernel_gated(fx, fy, mx, my, p)
        center, U = jpw.step_moment_basis(x, mx)
        fn = jax.jit(lambda y, ell: jpw.flow_and_step_moments(
            x, y, ckg, U, center, ell, p))

        def iterate(y, ell):
            out = fn(jnp.asarray(y.numpy()), jnp.float32(float(ell)))
            return tuple(torch.as_tensor(np.asarray(o)) for o in out)
    else:
        x, fx, mx = tc[0]
        y0, fy, my = tc[1]
        ckg = pairwise.color_kernel_gated(fx, fy, mx, my, tp)
        center, U = pairwise.step_moment_basis(x, mx)

        def iterate(y, ell):
            if order == "jax":
                return pairwise.flow_and_step_moments(x, y, ckg, U, center,
                                                      ell, tp)
            out = pairwise.flow_and_step_moments_lanes(
                x, y[None], ckg[None], U, center[None], ell.reshape(1), tp)
            return tuple(o[0] for o in out)
    y0 = torch.as_tensor(np.array(y0))
    R, T, ell = torch.eye(3), torch.zeros(3), torch.tensor(0.15)
    for k in range(tp.max_iter):
        y = y0 @ R + (-(R.T @ T))[None, :]
        omega, v, _, B, C, D, E = iterate(y, ell)
        step = cubic.min_positive_root_or(4 * E, 3 * D, 2 * C, B,
                                          tp.min_step, tp.max_step)
        dtr = se3.exp_sek3(torch.cat([omega, v]), step)
        stop1 = bool(torch.linalg.norm(omega) < tp.eps
                     and torch.linalg.norm(v) < tp.eps)
        dist = float(se3.dist_se3(dtr[:3, :3], dtr[:3, 3]))
        rows.append((k, float(ell), float(torch.linalg.norm(omega)),
                     float(torch.linalg.norm(v)), float(step), dist))
        if stop1 or dist < tp.eps_2:
            break
        T = R @ dtr[:3, 3] + T
        R = R @ dtr[:3, :3]
        for it, val in zip(tp.ell_anneal_iters, tp.ell_anneal_values):
            if k > it:
                ell = torch.tensor(val)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--no-tracking", action="store_true")
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(HERE))
    torch.set_num_threads(args.threads)
    print(f"torch threads {args.threads}", flush=True)
    if not args.no_tracking:
        for order, rows in tracking_table().items():
            worst = (max(max(abs(a - b) for a, b in (r["odo"], r["kf"]))
                         for r in rows),
                     max(r["pos"] for r in rows), max(r["rot"] for r in rows))
            print(f"tracking, {order}: per frame (port, JAX) odometry and "
                  f"keyframe iterations {[(r['odo'], r['kf']) for r in rows]}"
                  f"; decisions equal {all(r['same'] for r in rows)}; worst "
                  f"iteration gap {worst[0]}, position {worst[1]:.2e} m, "
                  f"rotation {worst[2]:.2e} rad", flush=True)
        for r in engine_table():
            print(f"engine pairs {r}", flush=True)
    for r in pair_table(args.pairs):
        print(f"pair {r}", flush=True)
    if args.trace:
        for order in ("lanes", "jax", "jax package"):
            rows = trace(order)
            print(f"trace {order}: stopped after iteration {rows[-1][0]}; "
                  "last 4 (k, ell, |omega|, |v|, step, dist): "
                  + "; ".join("(%d, %.2f, %.3e, %.3e, %.4f, %.3e)" % r
                              for r in rows[-4:]), flush=True)


if __name__ == "__main__":
    main()
