"""Standalone implicit-quadric fitting demo.

Parity with ref standalone_demos/implicit_surfaces_demo.py: fit the
10-coefficient quadric (‖c‖=1 constrained LS — closed-form smallest
eigenvector here, SLSQP in the reference) to samples of known quadric
surfaces (sphere, ellipsoid, cylinder, saddle, plane) and report/plot
both solution branches of the recovered surface. Port of
``pct_tpu.demos.implicit_surfaces_demo`` on the port's ``fit`` and
``curvature`` on ``device`` (no kernel); ``torch.einsum`` runs in full
float32 (the package keeps TF32 off).

Run:  python -m pct_tpu_torch.demos.implicit_surfaces_demo [outdir]
(on the card; ``run(device="cpu")`` runs on the CPU)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pct_tpu_torch.core.device import resolve_device


def sample_surfaces(n=600, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    out["sphere"] = (u * 1.5).astype(np.float32)
    out["ellipsoid"] = (u * [2.0, 1.0, 0.5]).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-1, 1, n)
    out["cylinder"] = np.stack([np.cos(th), np.sin(th), z], 1).astype(np.float32)
    xy = rng.uniform(-1, 1, (n, 2))
    out["saddle"] = np.column_stack(
        [xy, xy[:, 0] ** 2 - xy[:, 1] ** 2]).astype(np.float32)
    out["plane"] = np.column_stack(
        [xy, 0.2 * xy[:, 0] - 0.1 * xy[:, 1]]).astype(np.float32)
    return out


def run(outdir: str | None = None, *, device: str | torch.device = "cuda"):
    from pct_tpu_torch.curvature import implicit_curvatures
    from pct_tpu_torch.fit import fit_quadric, quadric_design

    dev = resolve_device(device)
    results = {}
    for name, pts in sample_surfaces().items():
        # center on a SURFACE sample (pipeline semantics, ref :617-633):
        # the curvature formulas evaluate at the origin, which must lie on
        # the surface (at the centroid of a sphere ∇F = 0)
        centered = pts - pts[0]
        x = torch.from_numpy(centered[None]).to(dev)
        c = fit_quadric(x)
        resid = float(torch.einsum("nki,ni->nk", quadric_design(x), c)
                      .abs().max())
        curv = implicit_curvatures(c, mode="exact")
        results[name] = (resid, float(curv.K[0]))
        print(f"{name:>10}: max residual {resid:.2e}  K_at_p0 {float(curv.K[0]):+.4f}")
        if outdir:
            _plot(name, centered, c[0].cpu().numpy(), outdir)
    return results


def _plot(name, pts, c, outdir):
    """Plot both roots z±(x, y) of the fitted quadric (ref demo behavior)."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    A, B, C, D, E, F, G, H, I, J = c
    g = np.linspace(pts[:, 0].min(), pts[:, 0].max(), 40)
    h = np.linspace(pts[:, 1].min(), pts[:, 1].max(), 40)
    X, Y = np.meshgrid(g, h)
    # C z² + (E x + F y + I) z + (A x² + B y² + D xy + G x + H y + J) = 0
    a2 = C
    a1 = E * X + F * Y + I
    a0 = A * X**2 + B * Y**2 + D * X * Y + G * X + H * Y + J
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(*pts.T, s=3, alpha=0.4)
    if abs(a2) > 1e-9:
        disc = a1**2 - 4 * a2 * a0
        ok = disc >= 0
        for sign in (+1, -1):
            Z = np.where(ok, (-a1 + sign * np.sqrt(np.maximum(disc, 0)))
                         / (2 * a2), np.nan)
            ax.plot_surface(X, Y, Z, alpha=0.3, color="orange")
    else:
        Z = np.where(np.abs(a1) > 1e-9, -a0 / np.where(a1 == 0, 1, a1), np.nan)
        ax.plot_surface(X, Y, Z, alpha=0.3, color="orange")
    ax.set_title(name)
    fig.savefig(os.path.join(outdir, f"implicit_demo_{name}.png"), dpi=110)
    plt.close(fig)


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else None)
