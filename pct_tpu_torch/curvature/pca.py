"""PCA-based curvature proxies, from one batched covariance eigensolve.

Port of ``pct_tpu.curvature.pca``:

1. ``pca_principal_curvatures`` — the reference's
   ``principal_curvatures_via_principal_component_analysis``: per point,
   the covariance of its k neighbors, the top two eigenvalues as
   "principal curvatures" and their eigenvectors as directions, K =
   λ1·λ2, H = (λ1+λ2)/2.
2. ``surface_variation`` — the reference's ``estimate_curvature``:
   λ0/(λ0+λ1+λ2) with λ0 the smallest eigenvalue.

Both gather the neighbors' raw coordinates (the covariance subtracts
their mean), exclude the query itself as the neighbor lists do, and
take an optional (N, k) bool ``mask`` of valid slots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pct_tpu_torch.fit.eigh3 import eigh3, eigvalsh3
from pct_tpu_torch.fit.frames import neighborhood_covariance


class PCACurvatures(NamedTuple):
    k1: torch.Tensor          # largest covariance eigenvalue   (λ1)
    k2: torch.Tensor          # second covariance eigenvalue    (λ2)
    K: torch.Tensor           # λ1·λ2
    H: torch.Tensor           # (λ1+λ2)/2
    dir1: torch.Tensor        # (..., 3) eigenvector of λ1
    dir2: torch.Tensor        # (..., 3) eigenvector of λ2


def pca_principal_curvatures(points: torch.Tensor, indices: torch.Tensor,
                             mask: torch.Tensor | None = None
                             ) -> PCACurvatures:
    """points (N,3), neighbor indices (Q,k) -> PCA curvature proxies."""
    cov = neighborhood_covariance(points[indices.long()], mask)
    w, V = eigh3(cov)                         # ascending
    lam1, lam2 = w[..., 2], w[..., 1]
    return PCACurvatures(k1=lam1, k2=lam2, K=lam1 * lam2,
                         H=0.5 * (lam1 + lam2), dir1=V[..., :, 2],
                         dir2=V[..., :, 1])


def surface_variation(points: torch.Tensor, indices: torch.Tensor,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """λ0/(λ0+λ1+λ2) per point."""
    w = eigvalsh3(neighborhood_covariance(points[indices.long()], mask))
    return w[..., 0] / torch.clamp_min(torch.sum(w, dim=-1), 1e-30)
