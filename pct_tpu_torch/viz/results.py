"""Sweep-results analysis plots.

Parity with ref plot_shape_validation_results.py: load the sweep CSV,
drop error rows, filter by sane error/point-count windows (ref :19-22),
log-log percent-error scatters per shape/radius (ref :62-99), and
histograms of the saved .npy curvature arrays against the closed-form
theoretical line (ref :101-151). Closed-form H/K per shape come from
pct_tpu_torch.shapes.analytic instead of the reference's inline table
(ref :28-45).
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from pct_tpu_torch.shapes import analytic_curvatures  # noqa: E402


def load_results(csv_path: str, max_error_pct: float = 100.0,
                 min_points: int = 1000, max_points: int = 1_500_000):
    """Read + filter sweep rows (ref :12-22)."""
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    out = []
    for r in rows:
        if r.get("status", "ok") != "ok":
            continue
        try:
            n = int(r["num_points"])
            err = float(r["area_error_pct"])
        except (TypeError, ValueError):
            continue
        if not (min_points <= n <= max_points) or err > max_error_pct:
            continue
        out.append(r)
    return out


def plot_error_scatter(rows, output_path: str):
    """Log-log percent error vs point count, per shape (ref :62-99)."""
    os.makedirs(output_path, exist_ok=True)
    shapes = sorted({r["shape"] for r in rows})
    for metric in ("area_error_pct", "bending_error_pct",
                   "stretching_error_pct"):
        fig, ax = plt.subplots(figsize=(7, 5))
        for shape in shapes:
            pts = [(int(r["num_points"]), float(r[metric])) for r in rows
                   if r["shape"] == shape and r.get(metric) not in (None, "")]
            if not pts:
                continue
            pts.sort()
            x, y = zip(*pts)
            ax.plot(x, np.maximum(y, 1e-6), "o-", label=shape)
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("num points")
        ax.set_ylabel(metric)
        ax.legend()
        fig.savefig(os.path.join(output_path, f"{metric}.png"), dpi=120)
        plt.close(fig)


def plot_curvature_histograms(curvature_dir: str, output_path: str,
                              radius: float = 1.0):
    """Histogram each saved .npy curvature array with the theoretical
    value(s) overlaid in red (ref :101-151)."""
    os.makedirs(output_path, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(curvature_dir, "*_gaussian.npy"))
                       + glob.glob(os.path.join(curvature_dir, "*_mean.npy"))):
        vals = np.load(path)
        vals = vals[np.isfinite(vals)]
        if vals.size == 0:
            continue
        name = os.path.splitext(os.path.basename(path))[0]
        shape = name.split("_")[0]
        kind = "gaussian" if name.endswith("gaussian") else "mean"
        fig, ax = plt.subplots(figsize=(7, 5))
        lo, hi = np.quantile(vals, [0.01, 0.99])
        ax.hist(vals, bins=100, range=(lo, hi), color="steelblue")
        try:
            # theoretical line(s): evaluate the closed form on a coarse probe
            from pct_tpu_torch.shapes import generate_shape

            probe, _ = generate_shape(shape, 2000, radius=radius)
            K_t, H_t = analytic_curvatures(shape, probe, radius=radius)
            t = K_t if kind == "gaussian" else H_t
            for v in np.unique(np.round(t, 6))[:8]:
                ax.axvline(v, color="red", alpha=0.6)
        except ValueError:
            pass
        ax.set_title(name)
        fig.savefig(os.path.join(output_path, f"hist_{name}.png"), dpi=120)
        plt.close(fig)


def plot_disp_energies(disp_csvs, energy_points, output_path: str,
                       name: str = "disp_energies"):
    """Force-displacement curves + energy points on twin axes
    (ref plot_disp_energies.py). ``disp_csvs``: [(label, csv_path)] with
    displacement,force columns; ``energy_points``: [(disp, bending,
    stretching)]."""
    os.makedirs(output_path, exist_ok=True)
    fig, ax = plt.subplots(figsize=(7, 5))
    ax2 = ax.twinx()
    for label, path in disp_csvs:
        with open(path) as f:
            rows = [r for r in csv.reader(f)]
        arr = np.asarray(rows, dtype=np.float64)
        ax.plot(arr[:, 0], arr[:, 1], label=label)
    for disp, bend, stretch in energy_points:
        ax2.plot([disp], [bend], "r^")
        ax2.plot([disp], [stretch], "bv")
    ax.set_xlabel("displacement")
    ax.set_ylabel("force")
    ax2.set_ylabel("energy")
    ax.legend()
    fig.savefig(os.path.join(output_path, f"{name}.png"), dpi=120)
    plt.close(fig)
