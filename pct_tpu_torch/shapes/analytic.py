"""Closed-form curvature oracles for the analytic shapes (host numpy).

The port's own copy of ``pct_tpu.shapes.analytic.analytic_curvatures``
for its two shapes (sphere, torus):
pointwise-exact Gaussian K and mean H at every sample, with the
reference's conventions (sphere H = 1/r, positive; K = 1/r²).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from pct_tpu_torch.shapes.generators import TORUS_MAJOR, TORUS_TUBE


def analytic_curvatures(
    shape: str, points: np.ndarray, radius: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Pointwise (K_gauss, H_mean) for ``points`` sampled from ``shape``
    at scale ``radius`` (the output of ``generate_shape``)."""
    p = np.asarray(points, dtype=np.float64)
    r = float(radius)
    if shape == "sphere":
        K = np.full(p.shape[0], 1.0 / r**2)
        H = np.full(p.shape[0], 1.0 / r)
    elif shape == "torus":
        R, rt = TORUS_MAJOR * r, TORUS_TUBE * r
        rho = np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)
        cos_phi = np.clip((rho - R) / rt, -1.0, 1.0)
        denom = rt * (R + rt * cos_phi)
        K = cos_phi / denom
        H = (R + 2.0 * rt * cos_phi) / (2.0 * denom)
    else:
        raise ValueError(f"unknown shape {shape!r}")
    return K, H
