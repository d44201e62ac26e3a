"""Exact brute-force kNN and the sampled mean 1-NN spacing.

Port of ``pct_tpu.neighbors.bruteforce``: ||q-p||² = ||q||² + ||p||² −
2 q·pᵀ with the cross term as a float32 matmul (TF32 is off, see the
package ``__init__``).
"""

from __future__ import annotations

import torch


def _pairwise_sqdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(Q,3),(N,3) -> (Q,N) squared distances, cross term as a matmul."""
    qq = torch.sum(q * q, dim=1, keepdim=True)
    pp = torch.sum(p * p, dim=1, keepdim=True).T
    return torch.clamp_min(qq + pp - 2.0 * (q @ p.T), 0.0)


def knn_bruteforce(points: torch.Tensor, num_points: int, k: int,
                   tile: int = 2048):
    """Exact self-kNN of every row of ``points``, each row's own index
    excluded (query k+1, drop self); padding rows (>= num_points) are
    never candidates. Returns (indices (N,k) int32, dists (N,k) float32
    ascending)."""
    n = points.shape[0]
    ar = torch.arange(n, device=points.device)
    valid = ar < num_points
    idx_out, d_out = [], []
    for s in range(0, n, tile):
        q = points[s:s + tile]
        d2 = _pairwise_sqdist(q, points)
        own = ar[None, :] == ar[s:s + q.shape[0], None]
        d2 = torch.where(valid[None, :] & ~own, d2, torch.inf)
        neg, idx = torch.topk(-d2, k, dim=1)
        idx_out.append(idx.to(torch.int32))
        d_out.append(torch.sqrt(torch.clamp_min(-neg, 0.0)))
    return torch.cat(idx_out), torch.cat(d_out)


def _sampled_nn_fold(points: torch.Tensor, num_points: int, sample: int,
                     chunk: int):
    """(best (sample,) 1-NN distances, valid_s (sample,)) over a
    deterministic stride sample of the valid rows."""
    dev = points.device
    stride = max(num_points // sample, 1)
    sidx = (torch.arange(sample, device=dev) * stride) % max(num_points, 1)
    s = points[sidx]
    valid_s = torch.arange(sample, device=dev) < min(sample, num_points)
    best = torch.full((sample,), torch.inf, device=dev)
    for c0 in range(0, num_points, chunk):
        p = points[c0:min(c0 + chunk, num_points)]
        d2 = _pairwise_sqdist(s, p)
        gidx = torch.arange(c0, c0 + p.shape[0], device=dev)
        d2 = torch.where(gidx[None, :] == sidx[:, None], torch.inf, d2)
        best = torch.minimum(best, d2.min(dim=1).values)
    return torch.sqrt(best), valid_s


def mean_nn_distance(points: torch.Tensor, num_points: int,
                     sample: int = 1024, chunk: int = 16384) -> torch.Tensor:
    """() float32 mean nearest-neighbor distance over a deterministic
    stride sample of ``sample`` valid rows; a running-min fold over point
    chunks, so the (sample × N) distance matrix never materializes."""
    best, valid_s = _sampled_nn_fold(points, num_points, sample, chunk)
    best = torch.where(valid_s, best, 0.0)
    return torch.sum(best) / max(min(sample, num_points), 1)
