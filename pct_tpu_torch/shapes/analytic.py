"""Closed-form differential-geometry oracles for the analytic shapes
(host numpy): the port's own copy of ``pct_tpu.shapes.analytic``.

Parity with ref plot_shape_validation_results.py:28-45 (theoretical H/K
per shape) and main_shape_validation.py:21-45, 66-71 (areas and
theoretical bending/stretching energies), but *pointwise-exact*: given
the sampled points we evaluate the true K and H at every sample instead
of a single representative value, so tests can gate on max relative
error. Conventions match the reference: sphere H=1/r (positive), K=1/r².
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from pct_tpu_torch.shapes.generators import EGG_AMPL, TORUS_MAJOR, TORUS_TUBE


def analytic_curvatures(
    shape: str, points: np.ndarray, radius: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Pointwise (K_gauss, H_mean) for ``points`` sampled from ``shape``
    at scale ``radius`` (i.e. the output of generators.generate_shape)."""
    p = np.asarray(points, dtype=np.float64)
    r = float(radius)
    if shape == "sphere":
        K = np.full(p.shape[0], 1.0 / r**2)
        H = np.full(p.shape[0], 1.0 / r)
    elif shape == "cylinder":
        K = np.zeros(p.shape[0])
        H = np.full(p.shape[0], 1.0 / (2.0 * r))
    elif shape == "torus":
        R, rt = TORUS_MAJOR * r, TORUS_TUBE * r
        rho = np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)
        cos_phi = np.clip((rho - R) / rt, -1.0, 1.0)
        denom = rt * (R + rt * cos_phi)
        K = cos_phi / denom
        H = (R + 2.0 * rt * cos_phi) / (2.0 * denom)
    elif shape == "egg_carton":
        # graph z = s*a*sin(pi X/s)cos(pi Y/s) with s=r, a=EGG_AMPL
        a, s = EGG_AMPL, r
        X, Y = p[:, 0], p[:, 1]
        c = np.pi / s
        sx, cx = np.sin(c * X), np.cos(c * X)
        sy, cy = np.sin(c * Y), np.cos(c * Y)
        amp = s * a
        fx = amp * c * cx * cy
        fy = -amp * c * sx * sy
        fxx = -amp * c * c * sx * cy
        fyy = -amp * c * c * sx * cy
        fxy = -amp * c * c * cx * sy
        w = 1.0 + fx * fx + fy * fy
        K = (fxx * fyy - fxy * fxy) / (w * w)
        H = ((1.0 + fx * fx) * fyy - 2.0 * fx * fy * fxy
             + (1.0 + fy * fy) * fxx) / (2.0 * w ** 1.5)
    else:
        raise ValueError(f"unknown shape {shape!r}")
    return K, H


def analytic_area(shape: str, radius: float = 1.0) -> float:
    """Closed-form surface area (ref main_shape_validation.py:66-71;
    egg-carton via numerical quadrature, ref :21-31)."""
    r = float(radius)
    if shape == "sphere":
        return 4.0 * np.pi * r**2
    if shape == "cylinder":
        return 2.0 * np.pi * r * (2.0 * r)  # lateral, height 2r
    if shape == "torus":
        return 4.0 * np.pi**2 * (TORUS_MAJOR * r) * (TORUS_TUBE * r)
    if shape == "egg_carton":
        # integral of sqrt(1+|grad f|^2) over [-r, r]^2, Gauss-Legendre
        a, s = EGG_AMPL, r
        c = np.pi / s
        nodes, weights = np.polynomial.legendre.leggauss(200)
        x = s * nodes
        wx = s * weights
        X, Y = np.meshgrid(x, x)
        fx = s * a * c * np.cos(c * X) * np.cos(c * Y)
        fy = -s * a * c * np.sin(c * X) * np.sin(c * Y)
        integrand = np.sqrt(1.0 + fx**2 + fy**2)
        return float(wx @ integrand @ wx)
    raise ValueError(f"unknown shape {shape!r}")


def analytic_energies(shape: str, radius: float = 1.0) -> Tuple[float, float]:
    """(bending ∫H²dA, stretching ∫K dA).

    Matches ref main_shape_validation.py:33-45 where the reference defines
    values (sphere 4π/4π, cylinder π/0, torus ?/0); for the torus bending
    the reference records nan — we supply the exact Willmore energy
    π²(R/rt)²/√((R/rt)²−1), and for the egg-carton numeric quadrature
    (the reference defines neither).
    """
    r = float(radius)
    if shape == "sphere":
        return 4.0 * np.pi, 4.0 * np.pi
    if shape == "cylinder":
        return np.pi, 0.0
    if shape == "torus":
        q = TORUS_MAJOR / TORUS_TUBE
        return np.pi**2 * q**2 / np.sqrt(q**2 - 1.0), 0.0
    if shape == "egg_carton":
        a, s = EGG_AMPL, r
        c = np.pi / s
        nodes, weights = np.polynomial.legendre.leggauss(200)
        x = s * nodes
        wx = s * weights
        X, Y = np.meshgrid(x, x)
        grid = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], axis=1)
        K, H = analytic_curvatures("egg_carton", grid, radius=r)
        fx = s * a * c * np.cos(c * X) * np.cos(c * Y)
        fy = -s * a * c * np.sin(c * X) * np.sin(c * Y)
        dA = np.sqrt(1.0 + fx**2 + fy**2)
        bend = float(wx @ (H.reshape(X.shape) ** 2 * dA) @ wx)
        stretch = float(wx @ (K.reshape(X.shape) * dA) @ wx)
        # ∫K dA vanishes by the sin/cos symmetry over full periods; the
        # quadrature leaves ~1e-16 which would poison percent errors
        if abs(stretch) < 1e-9 * max(1.0, abs(bend)):
            stretch = 0.0
        return bend, stretch
    raise ValueError(f"unknown shape {shape!r}")


def density_for_target_points(shape: str, num_points: int, radius: float) -> float:
    """points per unit area (ref main_shape_validation.py:16-19)."""
    return num_points / analytic_area(shape, radius)
