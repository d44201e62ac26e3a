"""Analytic test-shape generators (host numpy).

The port's own copy of ``pct_tpu.shapes.generators``, bit-identical to it
for the same arguments.

Parity with ref utils.py:833-959 ``generate_pv_shapes``:
- sphere: Fibonacci spiral (ref utils.py:858-866)
- cylinder: golden-ratio helix, r=1, z in [-1, 1] (ref utils.py:868-881)
- torus: theta/phi grid, major R=1, tube r=1/3, resampled to exact N
  (ref utils.py:883-903)
- egg_carton: grid z = 0.1 sin(pi x) cos(pi y) on [-1,1]^2 (ref utils.py:905-922)
- uniform scale by ``radius`` (ref utils.py:854-855), curvature-adaptive
  perturbation amplitude strength*scale/(1+|curvature|) (ref utils.py:945-950).

Host-side numpy: generation is fixture code, not the hot path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

GOLDEN = (1.0 + np.sqrt(5.0)) / 2.0

SHAPES = ("sphere", "cylinder", "torus", "egg_carton")

TORUS_MAJOR = 1.0
TORUS_TUBE = 1.0 / 3.0
EGG_AMPL = 0.1


def generate_sphere(n: int) -> np.ndarray:
    """Unit-radius Fibonacci-spiral sphere (ref utils.py:858-866)."""
    i = np.arange(n, dtype=np.float64)
    z = 1.0 - 2.0 * (i + 0.5) / n
    theta = 2.0 * np.pi * i / GOLDEN
    rho = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack(
        [rho * np.cos(theta), rho * np.sin(theta), z], axis=1
    ).astype(np.float32)


def generate_cylinder(n: int) -> np.ndarray:
    """r=1 golden-angle helix, z in [-1, 1], open ends (ref utils.py:868-881)."""
    i = np.arange(n, dtype=np.float64)
    theta = 2.0 * np.pi * i / GOLDEN
    z = -1.0 + 2.0 * (i + 0.5) / n
    return np.stack([np.cos(theta), np.sin(theta), z], axis=1).astype(np.float32)


def generate_torus(n: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Major R=1, tube r=1/3 grid, re/sub-sampled to exactly n (ref utils.py:883-903)."""
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


def generate_egg_carton(n: int) -> np.ndarray:
    """Grid z = 0.1 sin(pi x) cos(pi y), (x,y) in [-1,1]^2 (ref utils.py:905-922)."""
    side = int(np.ceil(np.sqrt(n)))
    x, y = np.meshgrid(np.linspace(-1, 1, side), np.linspace(-1, 1, side))
    x, y = x.ravel()[:n], y.ravel()[:n]
    # if side^2 < n pad by repeating (rare: only when n not near a square)
    if x.shape[0] < n:
        reps = n - x.shape[0]
        x = np.concatenate([x, x[:reps]])
        y = np.concatenate([y, y[:reps]])
    z = EGG_AMPL * np.sin(np.pi * x) * np.cos(np.pi * y)
    return np.stack([x, y, z], axis=1).astype(np.float32)


def generate_mobius(n: int, rng: Optional[np.random.Generator] = None,
                    width: float = 0.4) -> np.ndarray:
    """Möbius strip (non-orientable): the reference's orientation stress
    case (BASELINE.json configs: mobius_strip.txt). Centerline radius 1,
    half-twist; u ∈ [0, 2π), v ∈ [-width, width]."""
    rng = rng or np.random.default_rng(0)
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(-width, width, n)
    x = (1 + v * np.cos(u / 2)) * np.cos(u)
    y = (1 + v * np.cos(u / 2)) * np.sin(u)
    z = v * np.sin(u / 2)
    return np.stack([x, y, z], axis=1).astype(np.float32)


def generate_dupin_cyclide(n: int, rng: Optional[np.random.Generator] = None,
                           a: float = 1.0, b: float = 0.98, d: float = 0.3
                           ) -> np.ndarray:
    """Dupin cyclide (ring type): strongly non-uniform sampling density —
    the reference's kNN/density stress case (BASELINE.json configs:
    dupin_cyclide.txt). Standard parametrization with c = √(a²−b²);
    uniform (u, v) sampling concentrates points near the pinch, exactly
    the non-uniformity the certificate/repair machinery must handle."""
    rng = rng or np.random.default_rng(0)
    c = np.sqrt(max(a * a - b * b, 1e-12))
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    cu, su, cv, sv = np.cos(u), np.sin(u), np.cos(v), np.sin(v)
    denom = a - c * cu * cv
    x = (d * (c - a * cu * cv) + b * b * cu) / denom
    y = (b * su * (a - d * cv)) / denom
    z = (b * sv * (c * cu - d)) / denom
    return np.stack([x, y, z], axis=1).astype(np.float32)


_GEN = {
    "sphere": lambda n, rng: generate_sphere(n),
    "cylinder": lambda n, rng: generate_cylinder(n),
    "torus": generate_torus,
    "egg_carton": lambda n, rng: generate_egg_carton(n),
    "mobius": generate_mobius,
    "dupin_cyclide": generate_dupin_cyclide,
}


def generate_shape(
    shape: str,
    num_points: int,
    radius: float = 1.0,
    perturbation_strength: float = 0.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (unperturbed, perturbed) point arrays, scaled by ``radius``.

    Perturbation: Gaussian offset with amplitude
    strength * radius / (1 + |mean curvature proxy|), mirroring the
    curvature-modulated noise of ref utils.py:945-950 (there the modulator
    is a PCA surface-variation estimate; here we use the exact |H| of the
    unscaled shape, which serves the same "less noise where it bends" role).
    """
    if shape not in _GEN:
        raise ValueError(
            f"unknown shape {shape!r}; choose from {tuple(_GEN)}")
    rng = np.random.default_rng(seed)
    pts = _GEN[shape](num_points, rng) * np.float32(radius)
    if perturbation_strength <= 0:
        return pts, pts.copy()
    if shape in SHAPES:
        from pct_tpu_torch.shapes.analytic import analytic_curvatures

        _, H = analytic_curvatures(shape, pts / np.float32(radius), radius=1.0)
        amp = perturbation_strength * radius / (1.0 + np.abs(H))
    else:  # stress shapes (mobius, dupin_cyclide): unmodulated noise
        amp = np.full(pts.shape[0], perturbation_strength * radius)
    noise = rng.standard_normal(pts.shape).astype(np.float32)
    return pts, (pts + amp[:, None].astype(np.float32) * noise).astype(np.float32)
