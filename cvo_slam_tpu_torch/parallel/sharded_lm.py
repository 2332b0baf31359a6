"""Edge-sharded pose-graph LM over a mesh (port of
cvo_slam_tpu.parallel.sharded_lm).

Edges are padded with masked entries to a multiple of the shard count and
split into contiguous blocks, one per shard. Each shard linearizes its
edges into partial normal equations (backend.lm.edge_terms /
scatter_blocks); the mesh psums them, and the damped solve runs
replicated. Semantics match backend.lm.optimize: the same damping schedule
(lm.lm_update), up to lm.N_TRIALS trials per outer iteration stopping at
the first accept, and the same convergence exit.

solver='dense': one psum of (H (V,V,6,6), b, chi2) per outer iteration and
a replicated (6V)^2 solve. solver='pcg': the shard-local H stays on its
shard; one fused psum of (b, the diagonal 6x6 blocks, chi2) per outer
iteration and one (V,6) psum per CG matvec; block-Jacobi preconditioner
from the psummed diagonal; CG warm-started from the last accepted step.
Each damping trial also psums its chi2.
"""

from __future__ import annotations

import torch

from ..backend import lm
from ..ops import se3
from .mesh import Mesh


def _partial_normal_equations(E, ei, ej, Z, omega, emask, delta: float):
    """Unpinned H (V,V,6,6), b (V,6) and the robust chi2 of one shard's
    edges."""
    V = E.shape[0]
    e, Ji, Jj, chi2 = lm.edge_terms(E[None], ei[None], ej[None], Z[None],
                                    omega[None])
    w, rchi2 = lm.robust(chi2[0], delta)
    w = torch.where(emask, w, torch.zeros_like(w))
    H = E.new_zeros((1, V, V, 6, 6))
    b = E.new_zeros((1, V, 6))
    lm.scatter_blocks(H, b, ei[None], ej[None], Ji, Jj,
                      (w[:, None, None] * omega)[None], e)
    return H[0], b[0], torch.where(emask, rchi2,
                                   torch.zeros_like(rchi2)).sum()


def _chi2_shard(E, ei, ej, Z, omega, emask, delta: float):
    _, _, _, chi2 = lm.edge_terms(E[None], ei[None], ej[None], Z[None],
                                  omega[None])
    _, rchi2 = lm.robust(chi2[0], delta)
    return torch.where(emask, rchi2, torch.zeros_like(rchi2)).sum()


def optimize_sharded(g: lm.PoseGraph, mesh: Mesh, iterations: int,
                     robust_delta: float = 0.0, solver: str = "dense"):
    """Edge-sharded LM over `mesh`; semantics match backend.lm.optimize.
    Returns (E_opt, chi2) on mesh.device."""
    return make_sharded_optimizer(g, mesh, iterations, robust_delta,
                                  solver)(g.E)


def make_sharded_optimizer(g: lm.PoseGraph, mesh: Mesh, iterations: int,
                           robust_delta: float = 0.0,
                           solver: str = "dense"):
    """A reusable optimizer E0 -> (E_opt, chi2) for this graph topology
    over `mesh` (the scaling harness calls it repeatedly). The edges are
    padded and placed on their shards once."""
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    n = mesh.size
    dev = mesh.device
    M = g.ei.shape[0]
    pad = (-M) % n
    eye4 = torch.eye(4, dtype=g.Z.dtype, device=g.Z.device)
    eye6 = torch.eye(6, dtype=g.omega.dtype, device=g.omega.device)
    ei = torch.cat([g.ei, g.ei.new_zeros(pad)])
    ej = torch.cat([g.ej, g.ej.new_zeros(pad)])
    Z = torch.cat([g.Z, eye4.expand(pad, 4, 4)])
    om = torch.cat([g.omega, eye6.expand(pad, 6, 6)])
    emask = torch.cat([g.emask, g.emask.new_zeros(pad)])
    per = (M + pad) // n
    shards = [(s, *(t[s * per:(s + 1) * per].to(mesh.devices[s])
                    for t in (ei, ej, Z, om, emask)))
              for s in mesh.local_shards]
    V = g.E.shape[0]
    fm = (g.vmask & ~g.fixed).to(g.E.dtype).to(dev)
    delta = float(robust_delta)

    def on(s, x):
        return x.to(mesh.devices[s])

    def total_chi2(E):
        return mesh.psum([_chi2_shard(on(s, E), *edges, delta)
                          for s, *edges in shards])

    def accept_step(E, lam, ni, chi2, b, solve):
        """Up to lm.N_TRIALS damping trials from E; the first accepted one
        ends them. Returns (E, lam, ni, accepted, chi2 after, step)."""
        for _ in range(lm.N_TRIALS):
            dx = solve(lam)
            E_try = se3.exp_se3(dx) @ E
            chi2_new = total_chi2(E_try)
            rho = (chi2 - chi2_new) / ((dx * (lam * dx + b)).sum() + 1e-3)
            accept = (rho > 0) & torch.isfinite(chi2_new)
            lam, ni = lm.lm_update(lam, ni, rho, accept)
            if bool(accept):        # psummed: every rank reads the same
                return E_try, lam, ni, True, chi2_new, dx
        return E, lam, ni, False, chi2, None

    def converged(accepted, chi2, chi2_after):
        return not accepted or bool(chi2 - chi2_after <= 1e-9 * chi2)

    def start(E0):
        return (E0.to(dev), torch.tensor(-1.0, dtype=E0.dtype, device=dev),
                torch.tensor(2.0, dtype=E0.dtype, device=dev))

    def run_dense(E0):
        E, lam, ni = start(E0)
        diag = torch.arange(V, device=dev)
        eye6 = torch.eye(6, dtype=E.dtype, device=dev)
        eye = torch.eye(6 * V, dtype=E.dtype, device=dev)
        for it in range(iterations):
            H, b, chi2 = mesh.psum([
                _partial_normal_equations(on(s, E), *edges, delta)
                for s, *edges in shards])
            # pin fixed / invalid vertices as backend.lm does
            H = H * fm[:, None, None, None] * fm[None, :, None, None]
            H[diag, diag] += (1.0 - fm)[:, None, None] * eye6
            Hd = H.permute(0, 2, 1, 3).reshape(6 * V, 6 * V)
            b = b * fm[:, None]
            if it == 0:
                lam = 1e-5 * Hd.diagonal().amax()

            def solve(lam_t):
                dx = torch.linalg.solve_ex(Hd + lam_t * eye,
                                           b.reshape(-1, 1))[0]
                return torch.nan_to_num(dx).reshape(V, 6) * fm[:, None]
            E, lam, ni, accepted, chi2_after, _ = accept_step(
                E, lam, ni, chi2, b, solve)
            if converged(accepted, chi2, chi2_after):
                break
        return E, total_chi2(E)

    def run_pcg(E0):
        E, lam, ni = start(E0)
        dx_prev = E.new_zeros((V, 6))
        eye6 = torch.eye(6, dtype=E.dtype, device=dev)
        for it in range(iterations):
            Hs, parts = {}, []
            for s, *edges in shards:
                H, b, chi2 = _partial_normal_equations(on(s, E), *edges,
                                                       delta)
                Hs[s] = H       # stays on its shard
                parts.append((b, torch.diagonal(H, dim1=0, dim2=1)
                              .permute(2, 0, 1), chi2))
            b, diag, chi2 = mesh.psum(parts)
            b = b * fm[:, None]
            if it == 0:
                # pinned-diagonal lambda init (fixed / masked rows read
                # 1.0), as the dense path and backend.lm
                lam = 1e-5 * (torch.diagonal(diag, dim1=-2, dim2=-1)
                              * fm[:, None] + (1.0 - fm)[:, None]).amax()

            def matvec(xv, lam_t):
                xt = xv * fm[:, None]
                Hx = mesh.psum([torch.einsum("vuab,ub->va", Hs[s],
                                             on(s, xt))
                                for s, *_ in shards])
                return (Hx + lam_t * xt) * fm[:, None] \
                    + xv * (1.0 - fm)[:, None]

            def solve(lam_t):
                """Block-Jacobi preconditioned CG on the free subspace,
                warm-started from the last accepted step."""
                Dv = torch.where(fm[:, None, None] > 0, diag + lam_t * eye6,
                                 eye6)
                Dinv = torch.nan_to_num(torch.linalg.inv_ex(Dv)[0])

                def prec(r):
                    return torch.einsum("vab,vb->va", Dinv, r)
                tol2 = 1e-10 * torch.clamp((b * b).sum(), min=1e-30)
                xv = torch.nan_to_num(dx_prev) * fm[:, None]
                r = b - matvec(xv, lam_t) * fm[:, None]
                z = prec(r)
                pv, rz = z, (r * z).sum()
                k = 0
                # one host read per CG iteration: the convergence test
                while k < 6 * V and bool((r * r).sum() > tol2):
                    Ap = matvec(pv, lam_t)
                    alpha = rz / torch.clamp((pv * Ap).sum(), min=1e-30)
                    xv = xv + alpha * pv
                    r = r - alpha * Ap
                    z = prec(r)
                    rz_new = (r * z).sum()
                    pv = z + rz_new / torch.clamp(rz, min=1e-30) * pv
                    rz = rz_new
                    k += 1
                return torch.nan_to_num(xv) * fm[:, None]
            E, lam, ni, accepted, chi2_after, dx = accept_step(
                E, lam, ni, chi2, b, solve)
            if accepted:
                dx_prev = dx
            if converged(accepted, chi2, chi2_after):
                break
        return E, total_chi2(E)

    return run_pcg if solver == "pcg" else run_dense
