"""Fixed-sweep Jacobi eigenvalues for tiny symmetric matrices
(port of cvo_slam_tpu.ops.jacobi).

A cyclic-by-rounds Jacobi sweep with a *parallel ordering*: each round
rotates floor(n/2) disjoint (p, q) pairs at once via one combined Givens
matrix, so a full sweep of all n(n-1)/2 pairs is n-1 matrix sandwiches.
Static control flow only, so the eigenvalue floor of hessian_postprocess
stays on the device without a host round-trip; `sweeps=8` reaches f32
roundoff for any 6x6.
"""

from __future__ import annotations

from functools import lru_cache

import torch


@lru_cache(maxsize=None)
def _round_robin_pairs(n: int):
    """Circle-method tournament schedule: n-1 rounds of n//2 disjoint pairs
    covering every unordered pair exactly once (n even)."""
    assert n % 2 == 0
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = sorted((min(players[i], players[n - 1 - i]),
                        max(players[i], players[n - 1 - i]))
                       for i in range(n // 2))
        rounds.append(tuple(pairs))
        # rotate all but the first
        players = [players[0]] + [players[-1]] + players[1:-1]
    flat = {p for r in rounds for p in r}
    assert len(flat) == n * (n - 1) // 2
    return tuple(rounds)


@lru_cache(maxsize=None)
def _round_index(n: int, device: torch.device):
    """The schedule as (p, q) index tensors on `device`, made once."""
    return tuple((torch.tensor([p for p, _ in pairs], device=device),
                  torch.tensor([q for _, q in pairs], device=device))
                 for pairs in _round_robin_pairs(n))


def eigvalsh_jacobi(H, sweeps: int = 8):
    """Eigenvalues (unsorted) of a symmetric (n, n) matrix, n small and even."""
    n = H.shape[-1]
    A = (H + H.transpose(-1, -2)) * 0.5
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    for _ in range(sweeps):
        for ps, qs in _round_index(n, A.device):
            apq = A[..., ps, qs]
            app = A[..., ps, ps]
            aqq = A[..., qs, qs]
            # Rutishauser's stable rotation: t = sign(tau)/(|tau|+sqrt(1+tau^2))
            small = torch.abs(apq) < 1e-30
            denom = torch.where(small, torch.ones_like(apq), 2.0 * apq)
            tau = (aqq - app) / denom
            t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            c = torch.where(small, torch.ones_like(c), c)
            s = torch.where(small, torch.zeros_like(s), s)
            # combined Givens for the disjoint pairs of this round
            G = eye.expand(A.shape).clone()
            G[..., ps, ps] = c
            G[..., qs, qs] = c
            G[..., ps, qs] = s
            G[..., qs, ps] = -s
            A = G.transpose(-1, -2) @ A @ G
    return torch.diagonal(A, dim1=-2, dim2=-1)
