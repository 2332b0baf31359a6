"""Whether what the timed path produced is correct: the window's answers
against the plain reference (benchmark/reference/), once the window has
closed and the program's state is freed.

For a sample of the window's frames, drawn from the seed (with the frame
of the most align iterations in it), the reference rebuilds from the PNGs
the frame's cloud and the clouds both aligns started against (the frames
whose clouds the tracker's state held as fixed: the previous frame's, and
the keyframe align's, which is the local map's keyframe but after a
rejection before any accepted frame, cvo.cpp:591-604) and compares:

  cloud_mismatch     the program's cloud of the frame against the
                     reference frontend's: slots whose pixel, position or
                     features differ, plus the count difference (exact);
  odo_gap, kf_gap    the program's odometry and keyframe transforms
                     against the reference's float64 registration of the
                     same clouds: the odometry from the warm start the
                     program's tracker handed its align, the keyframe align
                     from the tracker's keyframe transform chained with
                     the reference's own odometry result (each side chains
                     its own): the larger of the translation gap (m) and
                     the rotation gap (rad);
  ip_rel_gap         the program's inner products (odometry and keyframe)
                     against the reference's at the program's transform
                     and ell, relative;
  decision_mismatch  frames of the whole window whose keyframe decision
                     differs from the policy's on the program's numbers;
  lc_gap             (cells with the SLAM backend) a sample of the
                     window's loop-closure verifications: the program's
                     transform against the reference's registration of the
                     two keyframes' clouds from the same RANSAC prior
                     (lc_gap); the verification's inner product against
                     the reference's at the program's transform and ell,
                     relative (lc_ip_rel_gap); and the program's accept
                     decision, whether the edge went into its graph,
                     against the accept test (reference/loop_closure.py)
                     on the reference's own scores at its own transform
                     and ell, counted where the test's margin is clear of
                     its boundary by LC_CLEAR (lc_accept_mismatch);
  ba_cost_excess     (cells with the SLAM backend) a sample of the
                     window's windowed-BA solves after pruning (the
                     program's problem as it handed it to its solver):
                     how far the program's keyframe poses and landmarks lie
                     above the least cost the reference reaches from the
                     same start, relative;
  ba_prune_mismatch  projection edges whose pruning between the two BA
                     stages differs from the rule (squared error over 9 px^2
                     or a point behind the camera) on the program's stage-1
                     result, away from the rule's boundary.

The control (`candidate="control"`) puts the reference itself in the
program's place, one precision down: the frontend in float16, the
registrations, inner products and BA in bfloat16 (but the BA's linear
solve, in float32, and its Jacobian, in float64, which torch does not run
in bfloat16).
"""

from __future__ import annotations

import math
import os
import random

import numpy as np
import torch

from . import render
from .reference import ba as ref_ba
from .reference import cvo as ref_cvo
from .reference import frontend as ref_frontend
from .reference import loop_closure as ref_lc
from .reference import tracker as ref_tracker

LOWER = {"cloud": np.float16, "cvo": torch.bfloat16}
# an accept decision is compared where the reference's accept test is
# further than this (relative) from its boundary: the program's scores
# sit up to ~1e-3 from the reference's at one transform, and its transform
# up to a few mm from the reference's
LC_CLEAR = 0.02


def transform_gap(A: np.ndarray, B: np.ndarray) -> float:
    """max(|t_A - t_B| in m, angle of R_A^T R_B in rad)."""
    dt = float(np.linalg.norm(A[:3, 3] - B[:3, 3]))
    c = 0.5 * (np.trace(A[:3, :3].T @ B[:3, :3]) - 1.0)
    return max(dt, math.acos(min(max(c, -1.0), 1.0)))


class Clouds:
    """Reference clouds of the lap's frames, made once each."""

    def __init__(self, folder, cam: dict, fp: dict, device, dtype):
        self.folder, self.cam, self.fp = folder, cam, fp
        self.device, self.dtype = device, dtype
        self.host, self.dev = {}, {}

    def host_cloud(self, k: int):
        if k not in self.host:
            rgb, dep = render.frame_paths(k)
            bgr, gray, depth = ref_frontend.load_frame(
                os.path.join(self.folder, rgb),
                os.path.join(self.folder, dep))
            self.host[k] = ref_frontend.create_pointcloud(
                bgr, gray, depth, self.cam, self.fp, self.dtype)
        return self.host[k]

    def device_cloud(self, k: int):
        if k not in self.dev:
            pos, feat, mask, _, _ = self.host_cloud(k)
            self.dev[k] = tuple(torch.as_tensor(a.astype(np.float32)
                                                if a.dtype != bool else a,
                                                device=self.device)
                                for a in (pos, feat, mask))
        return self.dev[k]


def cloud_mismatch(prog, ref) -> int:
    """Slots of two clouds whose pixel, position or features differ (bit
    for bit), plus the difference of their counts."""
    pos, feat, _, n, pix = ref
    m = min(n, prog.count)
    same = (np.all(prog.selected_pixels[:m] == pix[:m], axis=1)
            & np.all(prog.positions[:m] == pos[:m], axis=1)
            & np.all(prog.features[:m] == feat[:m], axis=1))
    return int(m - same.sum()) + abs(n - prog.count)


def _start_of_kf(kf_transform0, T_odo) -> tuple:
    """The keyframe align's start, as the program's frame_step makes it
    (reset_initial, cvo.cpp:611-618): the inverse of
    kf_transform @ T_odo."""
    guess = kf_transform0 @ T_odo
    R0 = guess[:3, :3].T
    return R0, -(R0 @ guess[:3, 3])


def sample_frames(window, seed: int, n: int):
    """n window frames drawn from the seed, the one of the most align
    iterations among them."""
    frames = [f for f in window.frames if f.T_odo is not None
              and f.T_kf is not None and f.kf_g >= 0 and f.odo_g >= 0]
    if not frames:
        return []
    hard = max(frames, key=lambda f: f.odo_iters + f.kf_iters)
    rest = [f for f in frames if f is not hard]
    pick = random.Random(seed).sample(rest, min(n - 1, len(rest)))
    return sorted([hard] + pick, key=lambda f: f.g)


def check(window, folder: str, cam: dict, fp: dict, cvo: dict, slam: dict,
          check_spec: dict, seed: int, device, candidate: str = "program"):
    """{number: value} of the window's answers (module docstring)."""
    lap = window.lap
    ref = Clouds(folder, cam, fp, device, np.float32)
    low = Clouds(folder, cam, fp, device, LOWER["cloud"])
    f64 = torch.float64
    out = {"cloud_mismatch": 0, "odo_gap": 0.0, "kf_gap": 0.0,
           "ip_rel_gap": 0.0, "odo_fit_loss": 0.0, "kf_fit_loss": 0.0}
    control = candidate == "control"
    for rec in sample_frames(window, seed, check_spec["frames"]):
        k, kp, kk = rec.lap_k, rec.odo_g % lap, rec.kf_g % lap
        if control:
            pos, feat, mask, n, pix = low.host_cloud(k)
            cand = _HostCloud(pos.astype(np.float32), feat.astype(np.float32),
                              n, pix)
        else:
            cand = rec.cloud
        out["cloud_mismatch"] += cloud_mismatch(cand, ref.host_cloud(k))
        cur, prev, kf = (ref.device_cloud(i) for i in (k, kp, kk))
        ell0 = cvo["ell_init"]
        T_odo, ell_o, _ = ref_cvo.align(prev, cur, rec.odo_R0, rec.odo_T0,
                                        ell0, cvo, f64)
        R0k, T0k = _start_of_kf(rec.kf_transform0, T_odo)
        T_kf, ell_k, _ = ref_cvo.align(kf, cur, R0k, T0k, ell0, cvo, f64)
        ip_odo = ref_cvo.inner_product(prev, cur, rec.T_odo, rec.ell_odo,
                                       cvo, f64)
        ip_kf = ref_cvo.inner_product(kf, cur, rec.T_kf, rec.ell_kf, cvo, f64)
        if control:
            lo = LOWER["cvo"]
            got_odo = ref_cvo.align(prev, cur, rec.odo_R0, rec.odo_T0, ell0,
                                    cvo, lo)[0]
            got_kf = ref_cvo.align(
                kf, cur, *_start_of_kf(rec.kf_transform0, got_odo), ell0,
                cvo, lo)[0]
            got_ip = (ref_cvo.inner_product(prev, cur, rec.T_odo,
                                            rec.ell_odo, cvo, lo),
                      ref_cvo.inner_product(kf, cur, rec.T_kf, rec.ell_kf,
                                            cvo, lo))
        else:
            got_odo, got_kf = rec.T_odo, rec.T_kf
            got_ip = (rec.odo_inn_post, rec.kf_inn_post)
        out["odo_gap"] = max(out["odo_gap"], transform_gap(got_odo, T_odo))
        out["kf_gap"] = max(out["kf_gap"], transform_gap(got_kf, T_kf))
        for key, fixed, T_ref, ell_ref, got in (
                ("odo_fit_loss", prev, T_odo, ell_o, got_odo),
                ("kf_fit_loss", kf, T_kf, ell_k, got_kf)):
            best = ref_cvo.inner_product(fixed, cur, T_ref, ell_ref, cvo, f64)
            mine = ref_cvo.inner_product(fixed, cur, got, ell_ref, cvo, f64)
            out[key] = max(out[key], 1.0 - mine / best)
        for want, got in zip((ip_odo, ip_kf), got_ip):
            gap = abs(got - want) / max(abs(want), 1e-30)
            out["ip_rel_gap"] = max(out["ip_rel_gap"],
                                    gap if math.isfinite(gap) else math.inf)
    out["decision_mismatch"] = sum(
        int(ref_tracker.accept(f.T_kf, f.kf_inn_post, f.eval_inn_post,
                               f.frames_in_map, slam)) != f.accept
        for f in window.frames if f.T_kf is not None)
    if check_spec.get("verifications"):
        out.update(_check_verifies(window.verifies, ref, lap, cvo,
                                   check_spec["verifications"], seed,
                                   control))
    if check_spec.get("bas"):
        out.update(_check_bas(window.bas, slam, check_spec["bas"], seed,
                              device, control))
    return out


def _lc_scores(fixed, moving, v, T, ell: float, cvo: dict, dtype) -> dict:
    """The accept test's scores (compute_innerproduct_lc, cvo.cpp:505-561)
    of `moving` under T against `fixed` at ell, worked out anew."""
    def ip(a, b, tran):
        return ref_cvo.inner_product(a, b, tran, ell, cvo, dtype)

    eye = np.eye(4)
    post = ip(fixed, moving, T)
    norm = math.sqrt(ip(fixed, fixed, eye)) * math.sqrt(ip(moving, moving,
                                                          eye))
    return {"inn_lc_post": post, "inn_lc_pre": ip(fixed, moving, eye),
            "inn_lc_prior": ip(fixed, moving, v.lc_prior),
            "inn_prior": ip(fixed, moving, v.prior),
            "cos_angle": post / max(norm, 1e-30)}


def _check_verifies(verifies, ref, lap: int, cvo: dict, n: int, seed: int,
                    control: bool) -> dict:
    """lc_gap, lc_ip_rel_gap and lc_accept_mismatch of a sample of the
    window's verifications; readings: the least margin of the reference's
    accept test over the sample and how many of it the test accepts."""
    f64, lo = torch.float64, LOWER["cvo"]
    pick = random.Random(seed + 1).sample(verifies, min(n, len(verifies)))
    gap, ip_gap, mismatch, least, accepts = 0.0, 0.0, 0, math.inf, 0
    for v in pick:
        fixed = ref.device_cloud(v.ref_g % lap)
        moving = ref.device_cloud(v.cand_g % lap)
        want, ell, _ = ref_cvo.align(fixed, moving, v.R0, v.T0,
                                     cvo["ell_init"], cvo, f64)
        scores = _lc_scores(fixed, moving, v, want, ell, cvo, f64)
        ip = ref_cvo.inner_product(fixed, moving, v.T, v.ell, cvo, f64)
        if control:
            got, got_ell, _ = ref_cvo.align(fixed, moving, v.R0, v.T0,
                                            cvo["ell_init"], cvo, lo)
            got_ip = ref_cvo.inner_product(fixed, moving, v.T, v.ell, cvo,
                                           lo)
            got_accept = ref_lc.accept(_lc_scores(fixed, moving, v, got,
                                                  got_ell, cvo, lo))
        else:
            got, got_ip, got_accept = v.T, v.lc["inn_lc_post"], v.accepted
        gap = max(gap, transform_gap(got, want))
        ip_gap = max(ip_gap, abs(got_ip - ip) / max(abs(ip), 1e-30))
        margin = ref_lc.margin(scores)
        least = min(least, abs(margin))
        accepts += ref_lc.accept(scores)
        if abs(margin) > LC_CLEAR and got_accept != ref_lc.accept(scores):
            mismatch += 1
    if not pick:
        return {k: math.nan for k in ("lc_gap", "lc_ip_rel_gap",
                                      "lc_accept_mismatch")}
    return {"lc_gap": gap, "lc_ip_rel_gap": ip_gap,
            "lc_accept_mismatch": mismatch, "lc_margin_least": least,
            "lc_ref_accepts": accepts}


def _ba_cost(problem, E, L):
    f64 = torch.float64
    dev = problem.E0.device
    return problem.cost(torch.as_tensor(E, device=dev).to(f64),
                        torch.as_tensor(L, device=dev).to(f64))


def _check_bas(bas, slam: dict, n: int, seed: int, device, control: bool):
    """ba_cost_excess and ba_prune_mismatch of the window's BA solves."""
    full = [b for b in bas
            if b.args["iterations"] == slam["OptimizationIterations"]]
    excess = 0.0
    for b in random.Random(seed + 2).sample(full, min(n, len(full))):
        args = dict(b.args, K=np.asarray(b.args["K"], np.float64))
        problem = ref_ba.Problem(args, torch.float64, device)
        best = problem.cost(*ref_ba.solve(problem))
        if control:
            low = ref_ba.Problem(args, LOWER["cvo"], device)
            E, L = (t.double().cpu().numpy() for t in ref_ba.solve(low))
            mine = _ba_cost(problem, E, L)
        else:
            mine = _ba_cost(problem, b.E, b.L)
        excess = max(excess, (mine - best) / max(best, 1e-30))
    mismatch = 0
    for first, second in zip(bas, bas[1:]):
        if first.args["iterations"] == slam["OptimizationIterations"] \
                or second.args["iterations"] \
                != slam["OptimizationIterations"]:
            continue
        a = first.args
        E = torch.as_tensor(first.E, dtype=torch.float64)
        L = torch.as_tensor(first.L, dtype=torch.float64)
        Ek = E[a["p_kf"]]
        P = (Ek[:, :3, :3] @ L[a["p_lm"]][..., None])[..., 0] + Ek[:, :3, 3]
        K = np.asarray(a["K"], np.float64)
        z = P[:, 2]
        zs = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
        uv = torch.stack([K[0, 0] * P[:, 0] / zs + K[0, 2],
                          K[1, 1] * P[:, 1] / zs + K[1, 2]], 1)
        err2 = torch.sum((torch.as_tensor(a["p_meas"], dtype=torch.float64)
                          - uv) ** 2, 1).numpy()
        z = z.numpy()
        was = np.asarray(a["p_mask"], bool)
        want = was & ~((err2 > 9.0) | (z <= 0))
        clear = (np.abs(err2 - 9.0) > 1e-3) & (np.abs(z) > 1e-6)
        mismatch += int(np.sum((want != np.asarray(second.args["p_mask"],
                                                   bool)) & clear & was))
    return {"ba_cost_excess": excess if full else math.nan,
            "ba_prune_mismatch": mismatch}


class _HostCloud:
    """The control's cloud in the shape of the program's host cloud."""

    def __init__(self, positions, features, count, pixels):
        self.positions, self.features = positions, features
        self.count, self.selected_pixels = count, pixels


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) of the numbers that have a limit:
    each at or under it; a number that is not finite, or missing, fails.
    The other numbers are readings only."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        good = math.isfinite(value) and value <= limit
        ok &= bool(good)
        rows.append((name, value, limit))
    return ok, rows
