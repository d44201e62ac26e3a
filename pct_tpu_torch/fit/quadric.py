"""Batched implicit-quadric fit: F(x,y,z) = cᵀm(x,y,z), ||c|| = 1.

Port of ``pct_tpu.fit.quadric``. The reference minimizes ||Ac||² subject
to ||c|| = 1 with SLSQP; the optimum is the eigenvector of the smallest
eigenvalue of the 10×10 Gram matrix AᵀA. The Gram matrix is built as 55
elementwise k-axis reductions (not a batched matmul), and the
eigenvector comes from shifted inverse iteration on the unrolled
Cholesky of ``fit.quadratic`` (``smallest_eigvec_10``), factored once
and applied five times; ``solver="eigh"`` keeps the full decomposition
(``torch.linalg.eigh``) as the test oracle.

Monomial order matches the reference design matrix:
[x², y², z², xy, xz, yz, x, y, z, 1].
"""

from __future__ import annotations

import torch

from pct_tpu_torch.fit.quadratic import cholesky_apply, cholesky_factor


def smallest_eigvec_10(G: torch.Tensor, iters: int = 5,
                       shift: float = 1e-6) -> torch.Tensor:
    """Smallest eigenvector of batched symmetric PSD n×n matrices (n=10
    here) by inverse iteration on G + (shift/n)·tr(G)·I.

    The rate is (λ₁+σ)/(λ₂+σ): on near-quadric data λ₁ ≈ 0 ≪ λ₂, so a few
    rounds recover the eigenvector; near-degenerate λ₁ ≈ λ₂ returns some
    vector of the subspace, as eigh's arbitrary basis does. The sign is
    canonical: the largest-|component| entry (the first of equals) is
    made positive.
    """
    n = G.shape[-1]
    tr = G.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    factor = cholesky_factor(G + (shift / n) * tr * eye)
    x = torch.full(G.shape[:-1], 1.0 / float(n) ** 0.5, dtype=G.dtype,
                   device=G.device)
    for _ in range(iters):
        x = cholesky_apply(factor, x)
        x = x / torch.sqrt(torch.clamp_min(
            torch.sum(x * x, dim=-1, keepdim=True), 1e-30))
    lead = torch.gather(x, -1, torch.argmax(torch.abs(x), dim=-1,
                                            keepdim=True))
    return x * torch.sign(torch.where(lead == 0, 1.0, lead))


def quadric_design(pts: torch.Tensor) -> torch.Tensor:
    """(..., k, 3) -> (..., k, 10) monomials."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack([x * x, y * y, z * z, x * y, x * z, y * z, x, y, z,
                        torch.ones_like(x)], dim=-1)


def fit_quadric(centered: torch.Tensor, mask: torch.Tensor | None = None,
                scale_normalize: bool = True,
                solver: str = "inverse") -> torch.Tensor:
    """(..., k, 3) query-centered neighborhoods -> (..., 10) unit
    coefficients.

    ``scale_normalize`` scales each neighborhood to unit radius before
    the Gram matrix is built (float32 conditioning), unscales the
    coefficients per monomial degree afterwards and renormalizes.
    ``solver``: "inverse" (``smallest_eigvec_10``) or "eigh". With a
    (..., k) bool ``mask`` only the valid slots count: the radius is
    their largest and every design column is multiplied by the mask.
    """
    if solver not in ("inverse", "eigh"):
        raise ValueError(f"unknown solver {solver!r}")
    if scale_normalize:
        r2 = torch.sum(centered ** 2, dim=-1)
        if mask is not None:
            r2 = r2 * mask
        h2 = torch.max(r2, dim=-1).values
        h = torch.sqrt(torch.clamp_min(h2, 1e-20))[..., None, None]
    else:
        h = torch.ones(centered.shape[:-2] + (1, 1), dtype=centered.dtype,
                       device=centered.device)
    cols = quadric_design(centered / h).unbind(-1)
    if mask is not None:
        m = torch.broadcast_to(mask, centered.shape[:-1]).to(centered.dtype)
        cols = [c * m for c in cols[:9]] + [m]
    Gq = [[None] * 10 for _ in range(10)]
    for i in range(10):
        for j in range(i, 10):
            Gq[i][j] = Gq[j][i] = torch.sum(cols[i] * cols[j], dim=-1)
    G = torch.stack([torch.stack(Gq[i], dim=-1) for i in range(10)], dim=-2)
    if solver == "inverse":
        c = smallest_eigvec_10(G)
    else:
        c = torch.linalg.eigh(G).eigenvectors[..., :, 0]
    deg = torch.tensor([2, 2, 2, 2, 2, 2, 1, 1, 1, 0], dtype=centered.dtype,
                       device=centered.device)
    c = c / h[..., 0] ** deg
    return c / torch.sqrt(torch.clamp_min(
        torch.sum(c * c, dim=-1, keepdim=True), 1e-30))
