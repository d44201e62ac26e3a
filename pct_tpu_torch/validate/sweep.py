"""Analytic shape-validation sweep.

Port of ``pct_tpu.validate.sweep`` (the reference's
main_shape_validation.py): sweep target point counts × radii × shapes,
generate each shape (with the curvature-adaptive perturbation option),
run the validation harness, compare area and bending/stretching energies
against closed form, and append every row INCREMENTALLY to a CSV so a
crashed sweep keeps its finished rows (ref :165-167). A failing row is
recorded as an "Error" row and the sweep goes on (ref :111-117).

Two changes from the JAX package: the CSV has no ``t_compile`` and
``cache`` columns (they attribute JAX compile time), and a sweep refuses
an existing CSV whose header is not ``CSV_FIELDS`` instead of appending
misaligned rows to it. The device is resolved once, before any row, so a
sweep asked to run on a card that is not there raises instead of writing
every row as an error.

Run:  python -m pct_tpu_torch.validate.sweep --quick
      (add ``--mesh-free --device cpu`` on a machine without a card)
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch

from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.shapes import (
    SHAPES,
    analytic_area,
    analytic_energies,
    generate_shape,
)
from pct_tpu_torch.validate.harness import percent_error, validate_cloud

log = logging.getLogger("pct_tpu_torch.sweep")

CSV_FIELDS = [
    "shape", "variant", "num_points", "radius", "k_used", "converged_k",
    "converged_fraction", "study_kmax",
    "computed_area", "theoretical_area", "area_error_pct",
    "bending_energy", "theoretical_bending", "bending_error_pct",
    "stretching_energy", "theoretical_stretching", "stretching_error_pct",
    "nan_fraction", "density", "runtime_s", "status",
    # per-stage wall seconds: study, curvature and energies run on the
    # device, normals and smooth mostly; bpa and the hole passes on the host
    "t_study", "t_normals", "t_bpa", "t_holes_small", "t_smooth",
    "t_holes_large", "t_curvature", "t_energies",
]

STAGE_KEYS = ("study", "normals", "bpa", "holes_small", "smooth",
              "holes_large", "curvature", "energies")


def _check_header(path: str):
    """Raise ValueError if ``path`` holds a header other than CSV_FIELDS;
    the file is only read."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return
    with open(path, newline="") as f:
        header = next(csv.reader(f), [])
    if header == CSV_FIELDS:
        return
    i = next(i for i in range(max(len(header), len(CSV_FIELDS)))
             if i >= len(header) or i >= len(CSV_FIELDS)
             or header[i] != CSV_FIELDS[i])
    got = header[i] if i < len(header) else "(none)"
    want = CSV_FIELDS[i] if i < len(CSV_FIELDS) else "(none)"
    raise ValueError(
        f"{path}: its header is not this sweep's CSV_FIELDS; column {i} "
        f"is {got!r}, want {want!r}. Write to another file.")


def _append_row(path: str, row: dict):
    fresh = not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        if fresh:
            w.writeheader()
        w.writerow(row)


def run_sweep(
    point_counts: List[int],
    radii: List[float],
    shapes: List[str],
    out_csv: str = "incremental_shape_comparison_results.csv",
    backup_csv: Optional[str] = "backup_shape_comparison_results.csv",
    perturbation: float = 0.0,
    k_neighbors: int = 20,
    auto_k: bool = False,
    output_dir: Optional[str] = None,
    seed: int = 0,
    use_mesh: bool = True,
    smooth_iterations: int = 10,
    device: str | torch.device = "cuda",
) -> List[dict]:
    dev = resolve_device(device)
    _check_header(out_csv)
    rows = []
    for num_points in point_counts:
        for radius in radii:
            for shape in shapes:
                variants = [("Unperturbed", 0.0)]
                if perturbation > 0:
                    # ref main_shape_validation.py:97 amplitude recipe;
                    # stress shapes have no closed-form area — unscaled
                    try:
                        amp = perturbation * np.sqrt(
                            analytic_area(shape, radius))
                    except ValueError:
                        amp = perturbation
                    variants.append(("Perturbed", amp))
                for variant, strength in variants:
                    row = _run_one(shape, variant, num_points, radius,
                                   strength, k_neighbors, auto_k,
                                   output_dir, seed, use_mesh,
                                   smooth_iterations, dev)
                    rows.append(row)
                    _append_row(out_csv, row)
    if backup_csv:
        with open(backup_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_FIELDS)
            w.writeheader()
            w.writerows(rows)
    return rows


def _run_one(shape, variant, num_points, radius, strength, k_neighbors,
             auto_k, output_dir, seed, use_mesh, smooth_iterations,
             device) -> dict:
    t0 = time.perf_counter()
    try:
        # inside the try: stress shapes (mobius, dupin_cyclide) have no
        # closed-form area — they must record an Error row, not abort the
        # sweep (crash-and-continue, ref main_shape_validation.py:111-117)
        density = num_points / analytic_area(shape, radius)
        unpert, pert = generate_shape(shape, num_points, radius=radius,
                                      perturbation_strength=strength,
                                      seed=seed)
        pts = pert if variant == "Perturbed" else unpert
        res = validate_cloud(pts, shape=shape, variant=variant,
                             radius=radius,
                             k_neighbors=k_neighbors, auto_k=auto_k,
                             output_dir=output_dir, use_mesh=use_mesh,
                             smooth_iterations=smooth_iterations,
                             device=device)
        area_t = analytic_area(shape, radius)
        bend_t, stretch_t = analytic_energies(shape, radius)
        return {
            "shape": shape, "variant": variant, "num_points": num_points,
            "radius": radius, "k_used": res.k_used,
            "converged_k": res.converged_k,
            "converged_fraction": (round(res.converged_fraction, 4)
                                   if res.converged_fraction >= 0 else None),
            "study_kmax": res.study_kmax if res.study_kmax > 0 else None,
            "computed_area": res.total_area, "theoretical_area": area_t,
            "area_error_pct": percent_error(res.total_area, area_t),
            "bending_energy": res.bending_energy,
            "theoretical_bending": bend_t,
            "bending_error_pct": percent_error(res.bending_energy, bend_t),
            "stretching_energy": res.stretching_energy,
            "theoretical_stretching": stretch_t,
            "stretching_error_pct": percent_error(res.stretching_energy,
                                                  stretch_t),
            "nan_fraction": res.nan_fraction,
            "density": density, "runtime_s": time.perf_counter() - t0,
            "status": res.aborted or "ok",
            **{f"t_{s}": res.stage_timings.get(s) for s in STAGE_KEYS},
        }
    except Exception as e:  # ref :111-117 crash-and-continue
        log.exception("sweep row failed: %s %s N=%d r=%s",
                      shape, variant, num_points, radius)
        return {"shape": shape, "variant": variant, "num_points": num_points,
                "radius": radius, "k_used": k_neighbors, "converged_k": -1,
                "computed_area": np.nan, "theoretical_area": np.nan,
                "area_error_pct": None, "bending_energy": np.nan,
                "theoretical_bending": np.nan, "bending_error_pct": None,
                "stretching_energy": np.nan, "theoretical_stretching": np.nan,
                "stretching_error_pct": None, "nan_fraction": np.nan,
                "density": np.nan, "runtime_s": time.perf_counter() - t0,
                "status": f"Error: {e}",
                "converged_fraction": None, "study_kmax": None,
                **{f"t_{s}": None for s in STAGE_KEYS}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--points", type=int, nargs="+",
                   default=[200_000, 300_000, 400_000, 500_000, 1_000_000],
                   help="target point counts (ref main_shape_validation.py:61)")
    p.add_argument("--radii", type=float, nargs="+", default=[0.1, 10, 1000])
    p.add_argument("--shapes", nargs="+", default=list(SHAPES))
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--auto-k", action="store_true",
                   help="run the neighbor-convergence study per row")
    p.add_argument("--perturbation", type=float, default=0.0,
                   help="perturbation strength (0.001 in the reference)")
    p.add_argument("--out", default="incremental_shape_comparison_results.csv")
    p.add_argument("--output-dir", default=None,
                   help="dump .npy curvatures + colored PLYs here")
    p.add_argument("--quick", action="store_true",
                   help="small sanity sweep (4 shapes x 20k points x r=1)")
    p.add_argument("--no-smooth", action="store_true",
                   help="skip the Taubin x10 pre-smoothing (reference "
                        "utils.py:319-322). On analytic shapes smoothing "
                        "flattens real curvature: 1M torus bending err "
                        "6.7%% smoothed vs <1%% unsmoothed")
    p.add_argument("--mesh-free", action="store_true",
                   help="skip BPA reconstruction: fast per-point disk-area "
                        "integrals instead of the reference's mesh protocol "
                        "(biased on lattice-sampled clouds)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the device stages (default cuda; "
                        "cpu runs the plain PyTorch versions)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.quick:
        args.points, args.radii = [20_000], [1.0]
    rows = run_sweep(args.points, args.radii, args.shapes, out_csv=args.out,
                     perturbation=args.perturbation, k_neighbors=args.k,
                     auto_k=args.auto_k, output_dir=args.output_dir,
                     use_mesh=not args.mesh_free,
                     smooth_iterations=0 if args.no_smooth else 10,
                     device=args.device)
    ok = [r for r in rows if r["status"] == "ok"]
    print(f"sweep done: {len(ok)}/{len(rows)} rows ok -> {args.out}")
    for r in ok:
        print(f"  {r['shape']:>10} N={r['num_points']:>8} r={r['radius']:<6} "
              f"area%={r['area_error_pct']:.2f} "
              f"bend%={(r['bending_error_pct'] if r['bending_error_pct'] is not None else float('nan')):.2f} "
              f"stretch%={(r['stretching_error_pct'] if r['stretching_error_pct'] is not None else float('nan')):.2f}")


if __name__ == "__main__":
    main()
