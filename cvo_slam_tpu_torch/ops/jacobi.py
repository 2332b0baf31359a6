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
    """The schedule on `device`, made once: per round the (p, q) index
    tensors, and for every index its partner, its pair and the sign of its
    partner's term in its rotated row (-1 for p, +1 for q)."""
    rounds = []
    for pairs in _round_robin_pairs(n):
        partner, pair, sign = [0] * n, [0] * n, [0.0] * n
        for k, (p, q) in enumerate(pairs):
            partner[p], partner[q] = q, p
            pair[p] = pair[q] = k
            sign[p], sign[q] = -1.0, 1.0
        rounds.append(tuple(torch.tensor(v, device=device) for v in (
            [p for p, _ in pairs], [q for _, q in pairs], partner, pair,
            sign)))
    return tuple(rounds)


def eigvalsh_jacobi(H, sweeps: int = 8):
    """Eigenvalues (unsorted) of symmetric (..., n, n) matrices, n small and
    even. Each round applies its combined Givens rotation G (A <- G^T A G)
    as the row, then the column mixing of its disjoint pairs, elementwise:
    every entry is c a + s b with the entry and its partner's, whatever
    the batch, so a stack of matrices gives each one's eigenvalues bit for
    bit (a batched matrix product need not sum as the one-matrix product
    does)."""
    A = (H + H.transpose(-1, -2)) * 0.5
    for _ in range(sweeps):
        for ps, qs, partner, pair, sign in _round_index(H.shape[-1],
                                                         A.device):
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
            # G[p, p] = G[q, q] = c, G[p, q] = s, G[q, p] = -s: row p of
            # G^T A is c A_p - s A_q, row q is c A_q + s A_p; the same for
            # the columns of (G^T A) G
            C = c[..., pair]
            S = s[..., pair] * sign
            A = C[..., :, None] * A + S[..., :, None] * A[..., partner, :]
            A = A * C[..., None, :] + A[..., :, partner] * S[..., None, :]
    return torch.diagonal(A, dim1=-2, dim2=-1)
