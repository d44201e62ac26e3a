"""Analytic test-shape generators (host numpy).

The port's own copy of two analytic shapes of ``pct_tpu.shapes``,
bit-identical to it for the same arguments:

- sphere: Fibonacci spiral, radius 1;
- torus: theta/phi grid, major R=1, tube r=1/3, resampled to exactly n
  (the north-star cloud);
- scaled by ``radius``; optional Gaussian perturbation with amplitude
  strength·radius/(1+|H|).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

GOLDEN = (1.0 + np.sqrt(5.0)) / 2.0

TORUS_MAJOR = 1.0
TORUS_TUBE = 1.0 / 3.0


def generate_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    z = 1.0 - 2.0 * (i + 0.5) / n
    theta = 2.0 * np.pi * i / GOLDEN
    rho = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack(
        [rho * np.cos(theta), rho * np.sin(theta), z], axis=1
    ).astype(np.float32)


def generate_torus(n: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    side = int(np.ceil(np.sqrt(n)))
    theta, phi = np.meshgrid(
        np.linspace(0, 2 * np.pi, side, endpoint=False),
        np.linspace(0, 2 * np.pi, side, endpoint=False),
    )
    theta, phi = theta.ravel(), phi.ravel()
    R, r = TORUS_MAJOR, TORUS_TUBE
    x = (R + r * np.cos(phi)) * np.cos(theta)
    y = (R + r * np.cos(phi)) * np.sin(theta)
    z = r * np.sin(phi)
    pts = np.stack([x, y, z], axis=1)
    if pts.shape[0] > n:
        idx = rng.choice(pts.shape[0], n, replace=False)
        pts = pts[idx]
    elif pts.shape[0] < n:
        idx = rng.choice(pts.shape[0], n - pts.shape[0], replace=True)
        pts = np.concatenate([pts, pts[idx]], axis=0)
    return pts.astype(np.float32)


_GEN = {
    "sphere": lambda n, rng: generate_sphere(n),
    "torus": generate_torus,
}


def generate_shape(
    shape: str,
    num_points: int,
    radius: float = 1.0,
    perturbation_strength: float = 0.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (unperturbed, perturbed) point arrays, scaled by ``radius``."""
    if shape not in _GEN:
        raise ValueError(f"unknown shape {shape!r}; choose from {tuple(_GEN)}")
    rng = np.random.default_rng(seed)
    pts = _GEN[shape](num_points, rng) * np.float32(radius)
    if perturbation_strength <= 0:
        return pts, pts.copy()
    from pct_tpu_torch.shapes.analytic import analytic_curvatures

    _, H = analytic_curvatures(shape, pts / np.float32(radius), radius=1.0)
    amp = perturbation_strength * radius / (1.0 + np.abs(H))
    noise = rng.standard_normal(pts.shape).astype(np.float32)
    return pts, (pts + amp[:, None].astype(np.float32) * noise).astype(np.float32)
