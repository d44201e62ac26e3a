"""Batched explicit-quadratic (Monge patch) least-squares fit.

Port of ``pct_tpu.fit.quadratic``: z = A a² + B b² + C ab + D a + E b + F
over the rotated neighborhood (the reference's ``fit_quadratic_surface``
lstsq), solved as scaled 6×6 normal equations with a tiny relative ridge
and an unrolled Cholesky. The Gram matrix and right-hand side are 21 + 6
elementwise k-axis reductions, not batched matmuls.
"""

from __future__ import annotations

import torch

_RIDGE = 1e-7


def cholesky_factor(G: torch.Tensor):
    """Batched unrolled Cholesky of symmetric-positive-definite n×n
    matrices (n from the trailing shape) -> (L as nested lists of
    (...,) tensors, the inverse pivots). A pivot that collapses (exactly
    singular G, e.g. collinear lattice neighborhoods) gets an inverse of
    0, so ``cholesky_apply`` drops its component, like lstsq's min-norm
    solution, instead of returning NaN."""
    n = G.shape[-1]
    L = [[None] * n for _ in range(n)]
    invd = [None] * n
    for j in range(n):
        s = G[..., j, j]
        for t in range(j):
            s = s - L[j][t] * L[j][t]
        dead = s < 1e-10 * torch.abs(G[..., j, j]) + 1e-30
        L[j][j] = torch.sqrt(torch.clamp_min(s, 1e-30))
        invd[j] = torch.where(dead, 0.0, 1.0 / L[j][j])
        for i in range(j + 1, n):
            s = G[..., i, j]
            for t in range(j):
                s = s - L[i][t] * L[j][t]
            L[i][j] = s * invd[j]
    return L, invd


def cholesky_apply(factor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve with a ``cholesky_factor`` result: forward then backward
    substitution over (..., n) right-hand sides."""
    L, invd = factor
    n = len(invd)
    y = [None] * n
    for i in range(n):
        s = rhs[..., i]
        for t in range(i):
            s = s - L[i][t] * y[t]
        y[i] = s * invd[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for t in range(i + 1, n):
            s = s - L[t][i] * x[t]
        x[i] = s * invd[i]
    return torch.stack(x, dim=-1)


def cholesky_solve(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched symmetric-positive-definite n×n solve, fully unrolled."""
    return cholesky_apply(cholesky_factor(G), rhs)


def fit_quadratic(rotated: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """(..., k, 3) rotated neighborhoods -> (..., 6) coefficients
    [A, B, C, D, E, F].

    Each tangent axis is scaled to unit extent first (lattice-sampled
    scans have strongly elliptical neighborhoods), z is left unscaled,
    and the coefficients are unscaled afterwards. With a (..., k) bool
    ``mask`` only the valid slots count: the extents are their maxima
    and every design column is multiplied by the mask.
    """
    x2, y2 = rotated[..., 0] ** 2, rotated[..., 1] ** 2
    if mask is not None:
        x2, y2 = x2 * mask, y2 * mask
    sa = torch.sqrt(torch.clamp_min(
        torch.max(x2, dim=-1).values, 1e-20))[..., None]
    sb = torch.sqrt(torch.clamp_min(
        torch.max(y2, dim=-1).values, 1e-20))[..., None]
    a = rotated[..., 0] / sa
    b = rotated[..., 1] / sb
    cols = [a * a, b * b, a * b, a, b, torch.ones_like(a)]
    z = rotated[..., 2]
    if mask is not None:
        m = torch.broadcast_to(mask, rotated.shape[:-1]).to(rotated.dtype)
        cols = [c * m for c in cols[:5]] + [m]
        z = z * m
    Gq = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i, 6):
            Gq[i][j] = Gq[j][i] = torch.sum(cols[i] * cols[j], dim=-1)
    rhs = torch.stack([torch.sum(cols[i] * z, dim=-1) for i in range(6)],
                      dim=-1)
    G = torch.stack([torch.stack(Gq[i], dim=-1) for i in range(6)], dim=-2)
    trace = G.diagonal(dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(6, dtype=G.dtype, device=G.device)
    G = G + (_RIDGE * trace[..., None, None] / 6.0) * eye
    c = cholesky_solve(G, rhs)
    scale_back = torch.cat([
        1.0 / (sa * sa), 1.0 / (sb * sb), 1.0 / (sa * sb),
        1.0 / sa, 1.0 / sb, torch.ones_like(sa),
    ], dim=-1)
    return c * scale_back


def quadratic_design(ab: torch.Tensor) -> torch.Tensor:
    """(..., k, 2) tangent coordinates -> (..., k, 6) design matrix
    [a², b², ab, a, b, 1]."""
    a, b = ab[..., 0], ab[..., 1]
    return torch.stack([a * a, b * b, a * b, a, b, torch.ones_like(a)],
                       dim=-1)


def fit_quadratic_lstsq_oracle(rotated: torch.Tensor,
                               mask: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Reference-semantics oracle: the unscaled design solved by an
    SVD-based least squares (``torch.linalg.lstsq``, driver "gelsd"),
    (..., k, 3) -> (..., 6). Slow and CPU-only; tests bound the normal
    equations' divergence with it."""
    if mask is None:
        mask = torch.ones(rotated.shape[:-1], dtype=torch.bool,
                          device=rotated.device)
    m = mask[..., None].to(rotated.dtype)
    X = quadratic_design(rotated[..., :2]) * m
    z = rotated[..., 2] * mask
    flatX = X.reshape((-1,) + X.shape[-2:]).cpu()
    flatz = z.reshape((-1, z.shape[-1], 1)).cpu()
    c = torch.linalg.lstsq(flatX, flatz, driver="gelsd").solution
    return c.reshape(X.shape[:-2] + (6,)).to(rotated.device)
