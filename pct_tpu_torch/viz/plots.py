"""Diagnostic plot suite (pickled matplotlib figures, reference-style).

Parity with the reference's in-class plot emitters
(ref pointCloudToolbox.py:482-615, 952-1009): curvature-colored 3D
scatters (K, H, H² views, viridis, azim=90/elev=85 — ref :559-615),
kNN neighborhood visualization for random points (ref :482-503), PCA
curvature/direction plots (ref :952-1009), and the generic surface plot
(ref :113-122). Figures are saved both as .pickle (the reference's
viewer format, see view_figs.py) and .png.

Headless-safe: forces the Agg backend. Inputs are numpy arrays.
"""

from __future__ import annotations

import os
import pickle
import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _save(fig, output_path: str, name: str):
    os.makedirs(output_path, exist_ok=True)
    with open(os.path.join(output_path, f"{name}.pickle"), "wb") as f:
        pickle.dump(fig, f)
    fig.savefig(os.path.join(output_path, f"{name}.png"), dpi=120)
    plt.close(fig)


def plot_points_colored_by_curvature(points: np.ndarray, K: np.ndarray,
                                     H: np.ndarray, output_path: str,
                                     tag: str = "", sample: int = 50_000,
                                     seed: int = 0):
    """K, H and H² scatter trio (ref pointCloudToolbox.py:559-615)."""
    rng = np.random.default_rng(seed)
    n = points.shape[0]
    idx = rng.choice(n, min(sample, n), replace=False)
    p = points[idx]
    for name, vals in (("gaussian", K[idx]), ("mean", H[idx]),
                       ("mean_sq", H[idx] ** 2)):
        fig = plt.figure(figsize=(8, 7))
        ax = fig.add_subplot(111, projection="3d")
        finite = np.isfinite(vals)
        lo, hi = (np.quantile(vals[finite], [0.02, 0.98])
                  if finite.any() else (0, 1))
        sc = ax.scatter(p[:, 0], p[:, 1], p[:, 2], c=np.clip(vals, lo, hi),
                        cmap="viridis", s=1)
        ax.view_init(elev=85, azim=90)   # ref :571
        fig.colorbar(sc, ax=ax, label=f"{name} curvature")
        ax.set_title(f"{name} curvature {tag}")
        _save(fig, output_path, f"points_by_{name}_curvature{tag}")


def visualize_knn_for_random_points(points: np.ndarray,
                                    neighbor_indices: np.ndarray,
                                    output_path: str, num_samples: int = 5,
                                    seed: int = 0):
    """Scatter each sampled point + its neighborhood (ref :482-503)."""
    rng = np.random.default_rng(seed)
    picks = rng.choice(points.shape[0], num_samples, replace=False)
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(*points[::max(1, points.shape[0] // 20000)].T,
               s=0.5, alpha=0.2, color="gray")
    for i in picks:
        nbrs = points[neighbor_indices[i]]
        ax.scatter(*nbrs.T, s=8)
        ax.scatter(*points[i], s=40, marker="x", color="red")
    ax.set_title(f"kNN neighborhoods ({num_samples} random points)")
    _save(fig, output_path, "knn_random_points")


def plot_pca_curvature(points: np.ndarray, k1: np.ndarray, k2: np.ndarray,
                       dir1: np.ndarray, dir2: np.ndarray,
                       output_path: str, sample: int = 2000, seed: int = 0):
    """PCA proxy plots: K/H scatter + principal-direction quivers
    (ref pointCloudToolbox.py:952-1009)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(points.shape[0], min(sample, points.shape[0]),
                     replace=False)
    p = points[idx]
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(111, projection="3d")
    sc = ax.scatter(*p.T, c=(k1 * k2)[idx], cmap="viridis", s=2)
    fig.colorbar(sc, ax=ax, label="PCA K = λ1·λ2")
    _save(fig, output_path, "pca_K")

    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(111, projection="3d")
    scale = 0.5 * float(np.linalg.norm(p.std(0)))
    ax.quiver(*p.T, *(dir1[idx] * scale).T, color="b", length=0.05,
              normalize=True)
    ax.quiver(*p.T, *(dir2[idx] * scale).T, color="r", length=0.05,
              normalize=True)
    ax.set_title("PCA principal directions")
    _save(fig, output_path, "pca_directions")


def plot_surface(points: np.ndarray, output_path: str, tag: str = ""):
    """Plain cloud scatter (ref pointCloudToolbox.py:113-122)."""
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(111, projection="3d")
    step = max(1, points.shape[0] // 50000)
    ax.scatter(*points[::step].T, s=1)
    ax.set_title(f"point cloud {tag}")
    _save(fig, output_path, f"surface{tag}")
