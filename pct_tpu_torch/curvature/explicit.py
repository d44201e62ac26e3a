"""Monge-patch curvature formulas for the explicit quadratic fit.

Port of ``pct_tpu.curvature.explicit``: at the origin of the rotated
frame, with z = Aa²+Bb²+Cab+Da+Eb+F,

  Fx=D, Fy=E, Fxx=2A, Fyy=2B, Fxy=C
  K  = (Fxx·Fyy − Fxy²) / (1+Fx²+Fy²)²
  H  = ((1+Fx²)Fyy − 2FxFyFxy + (1+Fy²)Fxx) / (2 (1+Fx²+Fy²)^1.5)
  k1,k2 = H ± √max(H²−K, 0)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Curvatures(NamedTuple):
    K: torch.Tensor        # Gaussian
    H: torch.Tensor        # mean
    k1: torch.Tensor       # principal max
    k2: torch.Tensor       # principal min
    H_sq: torch.Tensor     # H² (bending-energy integrand)


def explicit_curvatures(coeffs: torch.Tensor) -> Curvatures:
    A, B, C, D, E = (coeffs[..., 0], coeffs[..., 1], coeffs[..., 2],
                     coeffs[..., 3], coeffs[..., 4])
    Fx, Fy = D, E
    Fxx, Fyy, Fxy = 2.0 * A, 2.0 * B, C
    w = 1.0 + Fx * Fx + Fy * Fy
    K = (Fxx * Fyy - Fxy * Fxy) / (w * w)
    H = ((1.0 + Fx * Fx) * Fyy - 2.0 * Fx * Fy * Fxy
         + (1.0 + Fy * Fy) * Fxx) / (2.0 * w ** 1.5)
    disc = torch.sqrt(torch.clamp_min(H * H - K, 0.0))
    return Curvatures(K=K, H=H, k1=H + disc, k2=H - disc, H_sq=H * H)
