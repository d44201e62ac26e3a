"""Neighbor-count convergence study: a ladder over k instead of a
per-point binary search.

Port of ``pct_tpu.pipeline.neighbor_study`` (the reference's
``explicit_quadratic_neighbor_study``: sample up to 500 points and find,
per point, the smallest k in [3, 99] where |K(k+1) − K(k)| < tol; the
recommendation is int(mean(converged k)) + 1). The kmax+1 nearest
neighbors of the sample are found once; every rung k = kmin..kmax+1 is
the same neighborhoods under a shorter mask, fitted with the masked
frames and quadratic fit, and each sample takes its smallest converged
rung. Samples that never converge count as kmax in the mean, as in the
reference. The rungs run in chunks that bound the fit's working memory.

Documented divergence: JAX's ``jax.random.uniform(PRNGKey(seed))``
cannot be reproduced in torch, so the sample comes from a
``torch.Generator`` seeded with ``seed``, through the same formula
floor(u·n) clipped to [0, n−1]: the two packages study different
samples of the same cloud.
"""

from __future__ import annotations

import torch

from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.curvature.explicit import explicit_curvatures
from pct_tpu_torch.fit.frames import tangent_frames
from pct_tpu_torch.fit.quadratic import fit_quadratic
from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
from pct_tpu_torch.neighbors.knn import knn_grid

_LADDER_ELEMS = 1 << 22   # rungs × samples × slots per chunk of the ladder


def _ladder_converged_k(points: torch.Tensor, sample_idx: torch.Tensor,
                        nbr_idx: torch.Tensor, kmin: int, kmax: int,
                        tol: float, scale_sq=1.0, tol_rel: float = 0.0):
    """nbr_idx: (S, kmax+1) neighbor indices (ascending by distance).

    Returns (converged_k (S,) int32, converged (S,) bool): the smallest
    k in [kmin, kmax] with |K(k+1) − K(k)|·scale² < tol + tol_rel·|K(k)|
    (K scaled by ``scale_sq`` to a unit-scale cloud); kmin where no rung
    converges, with converged False.
    """
    q = points[sample_idx.long()]
    nbrs = points[nbr_idx.long()] - q[:, None, :]           # (S, kmax+1, 3)
    s, kp1 = nbr_idx.shape
    ks = torch.arange(kmin, kp1 + 1, device=points.device)  # rungs
    slots = torch.arange(kp1, device=points.device)
    step = max(1, _LADDER_ELEMS // max(s * kp1, 1))
    parts = []
    for r in range(0, ks.numel(), step):
        kr = ks[r:r + step]
        m = (slots < kr[:, None])[:, None, :]                  # (R, 1, k)
        nb = nbrs.expand((kr.numel(),) + nbrs.shape)
        rotated, _, _ = tangent_frames(nb, m)
        parts.append(explicit_curvatures(fit_quadratic(rotated, m)).K)
    K_ladder = torch.cat(parts) * scale_sq                     # (R, S)
    diff = torch.abs(K_ladder[1:] - K_ladder[:-1])             # k vs k+1
    conv = diff < tol + tol_rel * torch.abs(K_ladder[:-1])     # (R-1, S)
    first = torch.argmax(conv.to(torch.int32), dim=0)          # first True
    return (kmin + first).to(torch.int32), torch.any(conv, dim=0)


def explicit_quadratic_neighbor_study(
        cloud, tol: float = 1e-7, sample_size: int = 500, kmin: int = 3,
        kmax: int = 99, seed: int = 0, tol_rel: float = 0.0, *,
        device: str | torch.device = "cuda"):
    """(recommended k () int32, per-sample converged k (S,) int32, -1
    where a sample never converged) on ``device`` (default ``cuda``;
    raises RuntimeError without a card).

    recommended k = int(mean(converged k, kmax where not converged)) + 1.
    The tolerance applies to K scaled to a unit-size cloud (K·d², d the
    largest distance of a point from the centroid), so the reference's
    absolute tol means the same on any scale.
    """
    dev = resolve_device(device)
    points = cloud.points.to(dev)
    n = cloud.num_points
    sample_size = min(sample_size, cloud.capacity)
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand(sample_size, generator=gen, dtype=torch.float32)
    sample_idx = torch.clamp((u * float(n)).to(torch.int32), 0,
                             max(n - 1, 0)).to(dev)

    cell = estimate_cell_size(points, n, kmax + 1)
    grid = build_grid(points, n, cell)
    res = knn_grid(grid, points[sample_idx.long()], kmax + 1,
                   query_indices=sample_idx, capacity=int(2.5 * kmax) + 16,
                   tile=min(512, sample_size))
    # characteristic scale: the largest squared distance of a valid point
    # from the centroid
    valid = torch.arange(points.shape[0], device=dev) < n
    vm = valid[:, None].to(torch.float32)
    centroid = torch.sum(points * vm, dim=0) / torch.clamp_min(
        torch.sum(vm), 1.0)
    d2 = torch.sum((points - centroid) ** 2, dim=-1)
    scale_sq = torch.clamp_min(torch.max(torch.where(valid, d2, 0.0)), 1e-20)
    conv_k, conv = _ladder_converged_k(points, sample_idx, res.indices, kmin,
                                       kmax, tol, scale_sq=scale_sq,
                                       tol_rel=tol_rel)
    mean_k = torch.mean(torch.where(conv, conv_k, kmax).to(torch.float32))
    return (mean_k.to(torch.int32) + 1,
            torch.where(conv, conv_k, -1).to(torch.int32))
