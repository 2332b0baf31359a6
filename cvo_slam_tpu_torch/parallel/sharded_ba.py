"""Distributed Schur-complement bundle adjustment over a mesh (port of
cvo_slam_tpu.parallel.sharded_ba).

Landmarks are dealt round-robin to the shards and each projection edge goes
with its landmark's owner; pose edges are split evenly. Each shard
linearizes its edges (backend.ba._Problem.normal_eq), inverts its own
landmark 3x3 blocks and forms its Schur corrections to the reduced camera
system. Hpp and bp are psummed once per outer iteration; per damping trial
only the lambda-dependent corrections cross shards: the rhs and S
corrections in one psum (dense), or the rhs correction and one (V,6) psum
per CG iteration (pcg). The landmark back-substitution stays on the owner
shard. The LM schedule is backend.ba.optimize_ba's.

Layout: shard d's landmarks sit in rows [d * per_dev, (d + 1) * per_dev)
of the padded table, its k-th landmark (landmark d + k * n_dev) in row
d * per_dev + k, the padding at the end of each block. The JAX package's
layout (one stable argsort, padded at the end of the table) puts landmarks
in the wrong block when n_dev does not divide the landmark count; the
port is held to the single-device backend.ba instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import lm
from ..backend.ba import _Problem
from ..ops import se3
from .mesh import Mesh


def _pad_rows(a, n, fill=0):
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[:a.shape[0]] = a
    return out


def shard_ba_problem(n_dev, L, lm_mask, p_kf, p_lm, p_meas, p_w, p_mask,
                     ei, ej, Z, omega, pemask, bucket_edges: bool = False):
    """Split one BA problem (numpy arrays, as optimize_ba takes them) over
    n_dev shards. Returns (sharded dict of (n_dev, ...) arrays, perm,
    per_dev): perm[row] is the landmark in row `row` of the padded table
    (padding rows numbered from len(L) on), so L_table[np.argsort(perm)]
    lists the landmarks in their input order, the padding after them.

    bucket_edges pads each shard's projection-edge block to a power of two
    (at least 8), so the windows of one capacity class share their
    shapes."""
    NL = L.shape[0]
    per_dev = -(-NL // n_dev)
    idx = np.arange(NL)
    owner = idx % n_dev
    row = owner * per_dev + idx // n_dev
    perm = np.full(n_dev * per_dev, -1, np.int64)
    perm[row] = idx
    free_rows = np.flatnonzero(perm < 0)
    perm[free_rows] = NL + np.arange(free_rows.size)
    Lp = np.zeros((n_dev * per_dev, 3), L.dtype)
    Lp[row] = L
    lm_mask_p = np.zeros(n_dev * per_dev, bool)
    lm_mask_p[row] = lm_mask

    # projection edges with their landmark's owner; invalid edges last
    e_owner = np.where(p_mask, owner[p_lm], n_dev)
    order = np.argsort(e_owner, kind="stable")
    counts = np.bincount(e_owner, minlength=n_dev + 1)[:n_dev]
    per_dev_e = max(int(counts.max()), 1)
    if bucket_edges:
        b = 8
        while b < per_dev_e:
            b *= 2
        per_dev_e = b
    pk = np.zeros((n_dev, per_dev_e), np.int64)
    pl = np.zeros((n_dev, per_dev_e), np.int64)
    pm = np.zeros((n_dev, per_dev_e, 2), np.float32)
    pw = np.zeros((n_dev, per_dev_e), np.float32)
    pmask = np.zeros((n_dev, per_dev_e), bool)
    start = 0
    for d in range(n_dev):
        sel = order[start:start + counts[d]]
        start += counts[d]
        k = len(sel)
        pk[d, :k] = p_kf[sel]
        pl[d, :k] = p_lm[sel] // n_dev         # index within the block
        pm[d, :k] = p_meas[sel]
        pw[d, :k] = p_w[sel]
        pmask[d, :k] = True

    # pose edges split evenly
    M = ei.shape[0]
    per_pe = -(-M // n_dev)
    n_pe = n_dev * per_pe
    eye4 = np.eye(4, dtype=Z.dtype)
    eye6 = np.eye(6, dtype=omega.dtype)
    Zp = np.concatenate([Z, np.tile(eye4, (n_pe - M, 1, 1))])
    omp = np.concatenate([omega, np.tile(eye6, (n_pe - M, 1, 1))])
    sharded = dict(
        L=Lp.reshape(n_dev, per_dev, 3),
        lm_mask=lm_mask_p.reshape(n_dev, per_dev),
        p_kf=pk, p_lm=pl, p_meas=pm, p_w=pw, p_mask=pmask,
        ei=_pad_rows(np.asarray(ei, np.int64), n_pe).reshape(n_dev, per_pe),
        ej=_pad_rows(np.asarray(ej, np.int64), n_pe).reshape(n_dev, per_pe),
        Z=Zp.reshape(n_dev, per_pe, 4, 4),
        omega=omp.reshape(n_dev, per_pe, 6, 6),
        pemask=_pad_rows(pemask, n_pe).reshape(n_dev, per_pe))
    return sharded, perm, per_dev


def optimize_ba_sharded(E0, free_pose, sharded, K, iterations: int,
                        robust_delta: float, mesh: Mesh,
                        solver: str = "dense"):
    """Sharded counterpart of backend.ba.optimize_ba. `sharded` comes from
    shard_ba_problem. Returns (E_opt, L_opt (n_dev, per_dev, 3)) on
    mesh.device."""
    return make_ba_optimizer(free_pose, sharded, K, iterations, robust_delta,
                             mesh, solver)(E0)


def make_ba_optimizer(free_pose, sharded, K, iterations: int,
                      robust_delta: float, mesh: Mesh,
                      solver: str = "dense"):
    """A reusable sharded BA E0 (a host (V,4,4) array) -> (E_opt, L_opt
    (n_dev, per_dev, 3)), the shards' data placed on their devices once
    (the scaling harness calls it repeatedly). The landmarks start from
    sharded['L'].

    solver='dense' assembles the reduced camera system from the psummed
    corrections and solves it replicated; solver='pcg' applies the Schur
    operator matrix-free, the landmark sum local to each owner shard."""
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    n = mesh.size
    if sharded["L"].shape[0] != n:
        raise ValueError(f"a problem of {sharded['L'].shape[0]} shards on a "
                         f"mesh of {n}")
    dev = mesh.device
    delta = float(robust_delta)
    fp = torch.tensor(np.asarray(free_pose), dtype=torch.float32).to(dev)
    V = fp.shape[0]
    dtypes = dict(L=torch.float32, p_meas=torch.float32, p_w=torch.float32,
                  Z=torch.float32, omega=torch.float32)
    shards = {}
    for s in mesh.local_shards:
        sd = mesh.devices[s]
        a = {k: torch.as_tensor(np.asarray(v[s]), dtype=dtypes.get(k))
             .to(sd) for k, v in sharded.items()}
        Ks = torch.as_tensor(np.asarray(K), dtype=torch.float32).to(sd)
        prob = _Problem(fp.to(sd), a["lm_mask"], a["ei"], a["ej"], a["Z"],
                        a["omega"], a["pemask"], a["p_kf"], a["p_lm"],
                        a["p_meas"], a["p_w"], a["p_mask"], Ks, delta,
                        solver)
        shards[s] = (prob, a["L"])
    eye3 = {s: torch.eye(3, device=mesh.devices[s]) for s in shards}
    eye6 = torch.eye(6, device=dev)
    diag_idx = torch.arange(V, device=dev)

    def on(s, x):
        return x.to(mesh.devices[s])

    def total_chi2_and_scale(E, Ls, dxl, lam, bl):
        """psum of (chi2 of every shard at (E, Ls), the shards' landmark
        part of the LM gain scale)."""
        return mesh.psum([
            (shards[s][0].total_chi2(on(s, E), Ls[s]),
             (dxl[s] * (on(s, lam) * dxl[s] + bl[s])).sum())
            for s in shards])

    def solve(Hpp, bp, loc, lam):
        """Damped Schur solve: (dx_pose (V,6) on dev, {shard: dx_landmark})."""
        pre = {}
        for s, (prob, _) in shards.items():
            Hpl, Hll, bl = loc[s]
            lam_s = on(s, lam)
            Hll_d = torch.where(prob.fl[:, None, None] > 0,
                                Hll + lam_s * eye3[s], eye3[s])
            Hll_inv = torch.linalg.inv_ex(Hll_d)[0]
            bl_m = bl * prob.fl[:, None]
            pre[s] = (Hll_inv, bl_m,
                      torch.einsum("vlab,lbc->vlac", Hpl, Hll_inv))
        if solver == "pcg":
            corr_rhs = mesh.psum([torch.einsum("vlac,lc->va", HH, bl_m)
                                  for s, (_, bl_m, HH) in pre.items()])
            rhs = (bp - corr_rhs) * fp[:, None]
            dxp = _pcg(Hpp, loc, pre, rhs, lam)
        else:
            corr_rhs, corr_S = mesh.psum([
                (torch.einsum("vlac,lc->va", HH, bl_m),
                 torch.einsum("vlac,ulec->vuae", HH, loc[s][0]))
                for s, (_, bl_m, HH) in pre.items()])
            rhs = (bp - corr_rhs) * fp[:, None]
            S = Hpp - corr_S
            S[diag_idx, diag_idx] += lam * eye6
            S = S * fp[:, None, None, None] * fp[None, :, None, None]
            S[diag_idx, diag_idx] += (1.0 - fp)[:, None, None] * eye6
            Sd = S.permute(0, 2, 1, 3).reshape(V * 6, V * 6)
            dxp = torch.linalg.solve_ex(Sd, rhs.reshape(-1, 1))[0] \
                .reshape(V, 6)
        dxp = torch.nan_to_num(dxp) * fp[:, None]
        dxl = {}
        for s, (Hll_inv, bl_m, _) in pre.items():
            Hpl = loc[s][0]
            d = torch.einsum("lbc,lc->lb", Hll_inv,
                             bl_m - torch.einsum("vlab,va->lb", Hpl,
                                                 on(s, dxp)))
            dxl[s] = torch.nan_to_num(d) * shards[s][0].fl[:, None]
        return dxp, dxl

    def _pcg(Hpp, loc, pre, rhs, lam):
        """Matrix-free damped Schur CG on the free-pose subspace with a
        block-Jacobi preconditioner from the psummed Schur diagonal; one
        (V,6) psum per iteration, one host read per convergence test."""
        def matvec(xv):
            xt = xv * fp[:, None]
            corr = mesh.psum([
                torch.einsum("vlac,lc->va", HH,
                             torch.einsum("vlac,va->lc", loc[s][0],
                                          on(s, xt)))
                for s, (_, _, HH) in pre.items()])
            Sx = torch.einsum("vuab,ub->va", Hpp, xt) + lam * xt - corr
            return Sx * fp[:, None] + xv * (1.0 - fp)[:, None]

        diag_corr = mesh.psum([torch.einsum("vlac,vlec->vae", HH, loc[s][0])
                               for s, (_, _, HH) in pre.items()])
        Dv = torch.diagonal(Hpp, dim1=0, dim2=1).permute(2, 0, 1) \
            + lam * eye6 - diag_corr
        Dv = torch.where(fp[:, None, None] > 0, Dv, eye6)
        Dinv = torch.nan_to_num(torch.linalg.inv_ex(Dv)[0])

        def prec(r):
            return torch.einsum("vab,vb->va", Dinv, r)

        tol2 = 1e-10 * torch.clamp((rhs * rhs).sum(), min=1e-30)
        xv = torch.zeros_like(rhs)
        r = rhs
        z = prec(r)
        pv, rz = z, (r * z).sum()
        k = 0
        while k < 6 * V and bool((r * r).sum() > tol2):
            Ap = matvec(pv)
            alpha = rz / torch.clamp((pv * Ap).sum(), min=1e-30)
            xv = xv + alpha * pv
            r = r - alpha * Ap
            z = prec(r)
            rz_new = (r * z).sum()
            pv = z + rz_new / torch.clamp(rz, min=1e-30) * pv
            rz = rz_new
            k += 1
        return xv

    def run(E0):
        E = torch.tensor(np.asarray(E0), dtype=torch.float32).to(dev)
        Ls = {s: L for s, (_, L) in shards.items()}
        lam = torch.tensor(-1.0, device=dev)
        ni = torch.tensor(2.0, device=dev)
        for it in range(iterations):
            loc, parts = {}, []
            for s, (prob, _) in shards.items():
                Hpp, Hpl, Hll, bp, bl, chi2 = prob.normal_eq(on(s, E), Ls[s])
                loc[s] = (Hpl, Hll, bl)
                parts.append((Hpp, bp, chi2))
            Hpp, bp, chi2 = mesh.psum(parts)
            if it == 0:
                # Hpp is psummed; each landmark block is whole on its
                # owner shard, so a pmax finishes the max
                hll_max = mesh.pmax([
                    torch.diagonal(Hll, dim1=-2, dim2=-1).abs().max()
                    for _, Hll, _ in loc.values()])
                dmax = torch.maximum(
                    torch.diagonal(torch.diagonal(Hpp, dim1=0, dim2=1),
                                   dim1=0, dim2=1).abs().max(), hll_max)
                lam = 1e-5 * dmax
            accepted, chi2_after = False, chi2
            for _ in range(lm.N_TRIALS):
                dxp, dxl = solve(Hpp, bp, loc, lam)
                E_try = se3.exp_se3(dxp) @ E
                L_try = {s: Ls[s] + dxl[s] for s in shards}
                chi2_new, scale_l = total_chi2_and_scale(
                    E_try, L_try, dxl, lam,
                    {s: loc[s][2] for s in shards})
                scale = (dxp * (lam * dxp + bp)).sum() + scale_l + 1e-3
                rho = (chi2 - chi2_new) / scale
                accept = (rho > 0) & torch.isfinite(chi2_new)
                lam, ni = lm.lm_update(lam, ni, rho, accept)
                if bool(accept):     # psummed: every rank reads the same
                    E, Ls, chi2_after, accepted = E_try, L_try, chi2_new, \
                        True
                    break
            if not accepted or bool(chi2 - chi2_after <= 1e-9 * chi2):
                break
        return E, mesh.gather([Ls[s][None] for s in shards])

    return run
