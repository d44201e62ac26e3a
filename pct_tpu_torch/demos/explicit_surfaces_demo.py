"""Standalone explicit-quadratic fitting demo.

Parity with ref standalone_demos/explicit_surfaces_demo.py: re-derive
the plane-fit → rotate → quadratic-fit chain on five synthetic surfaces
(plane, paraboloid, saddle, monkey saddle, wavy) with known qualitative
curvature behavior, and plot the fits. Unlike the reference (a pure
numpy re-derivation with module-global leakage, ref :12, 76), this demo
exercises the REAL framework's fit chain (the port's ``fit`` and
``curvature`` on ``device``; no kernel), so it doubles as a smoke test.
Port of ``pct_tpu.demos.explicit_surfaces_demo``.

Run:  python -m pct_tpu_torch.demos.explicit_surfaces_demo [outdir]
(on the card; ``run(device="cpu")`` runs on the CPU)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pct_tpu_torch.core.device import resolve_device


SURFACES = {
    "plane": lambda x, y: 0.3 * x + 0.1 * y,
    "paraboloid": lambda x, y: 0.5 * (x**2 + y**2),
    "saddle": lambda x, y: 0.5 * (x**2 - y**2),
    "monkey_saddle": lambda x, y: x**3 - 3 * x * y**2,
    "wavy": lambda x, y: 0.2 * np.sin(2 * x) * np.cos(2 * y),
}

# expected (sign(K), H≈0?) at the origin
EXPECTED = {
    "plane": (0, True),
    "paraboloid": (+1, False),
    "saddle": (-1, True),
    "monkey_saddle": (0, True),
    "wavy": (+1, False),   # local extremum of sin·cos at 0? f=0.2 sin2x cos2y
}


def run(outdir: str | None = None, n: int = 400, seed: int = 0, *,
        device: str | torch.device = "cuda"):
    from pct_tpu_torch.curvature import explicit_curvatures
    from pct_tpu_torch.fit import fit_quadratic, tangent_frames

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    results = {}
    for name, f in SURFACES.items():
        xy = rng.uniform(-0.4, 0.4, (n, 2))
        z = f(xy[:, 0], xy[:, 1])
        pts = np.column_stack([xy, z]).astype(np.float32)
        # neighborhood of the origin = nearest n//4 samples
        d = np.linalg.norm(pts - [0, 0, f(0.0, 0.0)], axis=1)
        nbrs = pts[np.argsort(d)[: n // 4]] - np.array(
            [0, 0, f(0.0, 0.0)], dtype=np.float32)
        rotated, R, normal = tangent_frames(
            torch.from_numpy(nbrs[None]).to(dev))
        coeffs = fit_quadratic(rotated)
        c = explicit_curvatures(coeffs)
        K, H = float(c.K[0]), float(c.H[0])
        results[name] = (K, H)
        print(f"{name:>14}: K = {K:+.4f}  H = {H:+.4f}")
        if outdir:
            _plot(name, pts, coeffs[0].cpu().numpy(), outdir)
    return results


def _plot(name, pts, coeffs, outdir):
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(*pts.T, s=3, alpha=0.5)
    g = np.linspace(-0.3, 0.3, 25)
    X, Y = np.meshgrid(g, g)
    A, B, C, D, E, F = coeffs
    Z = A * X**2 + B * Y**2 + C * X * Y + D * X + E * Y + F
    ax.plot_surface(X, Y, Z, alpha=0.4, color="orange")
    ax.set_title(name)
    fig.savefig(os.path.join(outdir, f"explicit_demo_{name}.png"), dpi=110)
    plt.close(fig)


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else None)
