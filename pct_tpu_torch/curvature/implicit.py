"""Implicit-quadric curvature formulas (gradient and Hessian at the
origin).

Port of ``pct_tpu.curvature.implicit``. Coefficients [A..J] of
Ax²+By²+Cz²+Dxy+Exz+Fyz+Gx+Hy+Iz+J, evaluated at the origin (the
neighborhood is centered on the query point):

  ∇F = (G, H, I);  Hess = [[2A, D, E], [D, 2B, F], [E, F, 2C]]

- mode="exact" (default): the level-set formulas
  K = ∇F·adj(Hess)·∇Fᵀ / |∇F|⁴,
  H = (∇F·Hess·∇Fᵀ − |∇F|² tr Hess) / (2|∇F|³),
  with the explicit path's discriminant clamp.
- mode="reference": the reference toolbox's K = det(Hess)/|∇F|⁴ (not the
  Gaussian curvature of a level set: a unit sphere gives 1/2) and its
  unclamped √(H²−K), which is NaN where that "K" exceeds H².

The contractions are written out elementwise (no batched 3×3 matmuls);
the determinant is a cofactor expansion.
"""

from __future__ import annotations

import torch

from pct_tpu_torch.curvature.explicit import Curvatures


def implicit_curvatures(coeffs: torch.Tensor, mode: str = "exact") -> Curvatures:
    if mode not in ("exact", "reference"):
        raise ValueError(f"unknown mode {mode!r}")
    A, B, C, D, E, F, G, H, I = coeffs[..., :9].unbind(-1)
    # Hess = [[a, D, E], [D, b, F], [E, F, c]]
    a, b, c = 2.0 * A, 2.0 * B, 2.0 * C
    mag2 = G * G + H * H + I * I
    mag = torch.sqrt(torch.clamp_min(mag2, 1e-30))
    tr = a + b + c
    gHg = (G * (a * G + D * H + E * I) + H * (D * G + b * H + F * I)
           + I * (E * G + F * H + c * I))
    H_mean = (gHg - mag2 * tr) / (2.0 * mag2 * mag)
    quartic = torch.clamp_min(mag2 * mag2, 1e-30)
    if mode == "reference":
        det = a * (b * c - F * F) - D * (D * c - F * E) + E * (D * F - b * E)
        K = det / quartic
        disc = torch.sqrt(H_mean * H_mean - K)     # unclamped: NaN kept
    else:
        # adj(Hess) of the symmetric Hessian, row by row
        adj = ((b * c - F * F, E * F - D * c, D * F - E * b),
               (F * E - D * c, a * c - E * E, E * D - a * F),
               (D * F - b * E, D * E - a * F, a * b - D * D))
        g = (G, H, I)
        gAg = sum(g[i] * (adj[i][0] * G + adj[i][1] * H + adj[i][2] * I)
                  for i in range(3))
        K = gAg / quartic
        disc = torch.sqrt(torch.clamp_min(H_mean * H_mean - K, 0.0))
    return Curvatures(K=K, H=H_mean, k1=H_mean + disc, k2=H_mean - disc,
                      H_sq=H_mean * H_mean)
