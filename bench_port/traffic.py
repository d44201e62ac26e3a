"""The one traffic generator: a pool of point clouds from a traffic file
and a seed.

The shapes are numpy copies, frozen here, of the reference toolbox's
sweep generators (utils.py:883-903 for the torus grid; the Dupin cyclide
of BASELINE.json's stress case) and of its perturbation recipe: strength
``perturbation * sqrt(area)`` (main_shape_validation.py:97), modulated
by curvature as strength / (1 + |H|) (utils.py:945-950, with the exact
mean curvature of the unscaled shape standing for the reference's PCA
estimate). The port's own ``shapes`` package is not used, so the
benchmark's inputs cannot move with the program.

A traffic file holds:

- ``shape``: "torus" or "dupin_cyclide"; ``params`` for the shape;
- ``points``: real points a cloud; ``radius``: uniform scale;
- ``perturbation``: the sweep's strength (0 for none);
- ``pool``: clouds cycled by the calls, cloud j drawn from the stream
  (seed, j) of the run's seed: every seed has the same shape, size and
  recipe, and new noise or new (u, v);
- ``pad_multiple``: the capacity multiple handed to ``from_numpy``.
"""

from __future__ import annotations

import numpy as np

TORUS_MAJOR = 1.0
TORUS_TUBE = 1.0 / 3.0


def torus(n: int, rng: np.random.Generator) -> np.ndarray:
    """R=1, r=1/3 theta/phi grid of ceil(sqrt(n))² points, sub- or
    re-sampled to exactly n (ref utils.py:883-903). At n = 1000² the
    grid is used whole and ``rng`` is not read."""
    side = int(np.ceil(np.sqrt(n)))
    theta, phi = np.meshgrid(
        np.linspace(0, 2 * np.pi, side, endpoint=False),
        np.linspace(0, 2 * np.pi, side, endpoint=False),
    )
    theta, phi = theta.ravel(), phi.ravel()
    x = (TORUS_MAJOR + TORUS_TUBE * np.cos(phi)) * np.cos(theta)
    y = (TORUS_MAJOR + TORUS_TUBE * np.cos(phi)) * np.sin(theta)
    z = TORUS_TUBE * np.sin(phi)
    pts = np.stack([x, y, z], axis=1)
    if pts.shape[0] > n:
        pts = pts[rng.choice(pts.shape[0], n, replace=False)]
    elif pts.shape[0] < n:
        extra = rng.choice(pts.shape[0], n - pts.shape[0], replace=True)
        pts = np.concatenate([pts, pts[extra]], axis=0)
    return pts.astype(np.float32)


def torus_mean_curvature(pts: np.ndarray) -> np.ndarray:
    """Exact H of the unscaled R=1, r=1/3 torus at its points."""
    p = pts.astype(np.float64)
    rho = np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)
    cos_phi = np.clip((rho - TORUS_MAJOR) / TORUS_TUBE, -1.0, 1.0)
    denom = TORUS_TUBE * (TORUS_MAJOR + TORUS_TUBE * cos_phi)
    return (TORUS_MAJOR + 2.0 * TORUS_TUBE * cos_phi) / (2.0 * denom)


def torus_area(radius: float) -> float:
    return 4.0 * np.pi ** 2 * (TORUS_MAJOR * radius) * (TORUS_TUBE * radius)


def dupin_cyclide(n: int, rng: np.random.Generator, a: float = 1.0,
                  b: float = 0.98, d: float = 0.3) -> np.ndarray:
    """Ring Dupin cyclide, c = sqrt(a² − b²), with (u, v) uniform on
    [0, 2π)²: the density gathers at the thin side (the pinch)."""
    c = np.sqrt(max(a * a - b * b, 1e-12))
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    cu, su, cv, sv = np.cos(u), np.sin(u), np.cos(v), np.sin(v)
    denom = a - c * cu * cv
    x = (d * (c - a * cu * cv) + b * b * cu) / denom
    y = (b * su * (a - d * cv)) / denom
    z = (b * sv * (c * cu - d)) / denom
    return np.stack([x, y, z], axis=1).astype(np.float32)


def make_cloud(traffic: dict, rng: np.random.Generator) -> np.ndarray:
    """One (points, 3) float32 cloud of the traffic's shape."""
    n = int(traffic["points"])
    radius = float(traffic.get("radius", 1.0))
    params = traffic.get("params", {})
    shape = traffic["shape"]
    if shape == "torus":
        unit = torus(n, rng)
    elif shape == "dupin_cyclide":
        unit = dupin_cyclide(n, rng, **params)
    else:
        raise ValueError(f"unknown shape {shape!r}")
    pts = unit * np.float32(radius)
    strength = float(traffic.get("perturbation", 0.0))
    if strength <= 0.0:
        return pts
    if shape != "torus":
        raise ValueError(f"no perturbation recipe for {shape!r}")
    amp = (strength * np.sqrt(torus_area(radius)) * radius
           / (1.0 + np.abs(torus_mean_curvature(unit))))
    noise = rng.standard_normal(pts.shape).astype(np.float32)
    return (pts + amp[:, None].astype(np.float32) * noise).astype(np.float32)


def seed_words(seed: int, *tail: int) -> list[int]:
    """Non-negative entropy words for numpy from any whole-number seed."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32, *tail]


def make_pool(traffic: dict, seed: int) -> list[np.ndarray]:
    """``traffic["pool"]`` clouds, cloud j from the stream (seed, j)."""
    return [make_cloud(traffic, np.random.default_rng(seed_words(seed, j)))
            for j in range(int(traffic.get("pool", 1)))]
