"""Batch validation of real scans.

Port of ``pct_tpu.validate.scans`` (the reference's main_scans.py): glob
a scans directory, run the validation harness on every cloud, write the
rows to ``scans_results.csv``, and profile the run (``--profile``: the
reference's cProfile with the top 20 entries by cumulative time,
main_scans.py:70-73; ``--trace DIR``: a ``torch.profiler`` trace of the
CPU and, on the card, the CUDA activity, exported as Chrome JSON).

The CSV has no ``t_compile`` and ``cache`` columns (they attribute JAX
compile time), and the device is resolved once, before any row.

Run:  python -m pct_tpu_torch.validate.scans --dir ./Scans --profile
"""

from __future__ import annotations

import argparse
import cProfile
import csv
import glob
import logging
import os
import pstats

import torch

from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.validate.harness import validate_file

log = logging.getLogger("pct_tpu_torch.scans")

FIELDS = ["file", "run", "num_points", "k_used", "converged_k",
          "converged_fraction", "study_kmax", "bending_energy",
          "stretching_energy", "total_area", "nan_fraction", "runtime_s",
          "status",
          # per-stage wall seconds
          "t_study", "t_normals", "t_bpa", "t_holes_small", "t_smooth",
          "t_holes_large", "t_curvature", "t_energies"]

STAGE_KEYS = ("study", "normals", "bpa", "holes_small", "smooth",
              "holes_large", "curvature", "energies")

TRACE_FILE = "scans_trace.json"   # what ``--trace DIR`` writes into DIR


def run_scans(scan_dir: str, out_csv: str = "scans_results.csv",
              pattern: str = "*.ply", k_neighbors: int = 100,
              outlier_filter: bool = True, output_dir=None,
              use_mesh: bool = True, repeat: int = 1,
              device: str | torch.device = "cuda"):
    """``repeat > 1`` runs each cloud that many times in one process and
    writes one row per run: run 1 carries the process's first-use costs
    (the kernels' build and load), runs >= 2 the warm floor."""
    dev = resolve_device(device)
    files = sorted(glob.glob(os.path.join(scan_dir, pattern)))
    rows = []
    for path in files:
        name = os.path.splitext(os.path.basename(path))[0]
        for run in range(1, repeat + 1):
            try:
                # real scans: K is large and noisy, the reference's
                # absolute convergence tol never fires - use a relative one
                r = validate_file(path, shape=name, k_neighbors=k_neighbors,
                                  outlier_filter=outlier_filter,
                                  output_dir=output_dir, study_tol_rel=1e-2,
                                  use_mesh=use_mesh, device=dev)
                rows.append({"file": path, "run": run,
                             "num_points": r.num_points,
                             "k_used": r.k_used, "converged_k": r.converged_k,
                             "converged_fraction":
                                 (round(r.converged_fraction, 4)
                                  if r.converged_fraction >= 0 else None),
                             "study_kmax":
                                 r.study_kmax if r.study_kmax > 0 else None,
                             "bending_energy": r.bending_energy,
                             "stretching_energy": r.stretching_energy,
                             "total_area": r.total_area,
                             "nan_fraction": r.nan_fraction,
                             "runtime_s": r.runtime_s,
                             "status": r.aborted or "ok",
                             **{f"t_{s}": r.stage_timings.get(s)
                                for s in STAGE_KEYS}})
            except Exception as e:   # ref main_scans.py:46-52 crash-and-continue
                log.exception("scan failed: %s", path)
                rows.append({"file": path, "run": run,
                             "num_points": -1, "k_used": k_neighbors,
                             "converged_k": -1, "bending_energy": float("nan"),
                             "stretching_energy": float("nan"),
                             "total_area": float("nan"),
                             "nan_fraction": float("nan"), "runtime_s": 0.0,
                             "status": f"Error: {e}",
                             "converged_fraction": None, "study_kmax": None,
                             **{f"t_{s}": None for s in STAGE_KEYS}})
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(rows)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", default="./Scans")
    p.add_argument("--pattern", default="*.ply")
    p.add_argument("--out", default="scans_results.csv")
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--no-filter", action="store_true")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--profile", action="store_true",
                   help="cProfile + top-20 cumtime (ref main_scans.py:70-73)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help=f"write a torch.profiler trace to DIR/{TRACE_FILE}")
    p.add_argument("--mesh-free", action="store_true",
                   help="skip BPA reconstruction (fast disk-area integrals)")
    p.add_argument("--repeat", type=int, default=1,
                   help="rows per cloud: run 1 = fresh process (first-use "
                        "costs included), run 2+ = warm floor")
    p.add_argument("--device", default="cuda",
                   help="torch device of the device stages (default cuda; "
                        "cpu runs the plain PyTorch versions)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)

    def go():
        return run_scans(args.dir, args.out, args.pattern, args.k,
                         not args.no_filter, args.output_dir,
                         use_mesh=not args.mesh_free, repeat=args.repeat,
                         device=dev)

    def traced():
        if not args.trace:
            return go()
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            rows = go()
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, TRACE_FILE))
        return rows

    if args.profile:
        pr = cProfile.Profile()
        pr.enable()
        rows = traced()
        pr.disable()
        pstats.Stats(pr).sort_stats("cumtime").print_stats(20)
    else:
        rows = traced()
    ok = sum(1 for r in rows if r["status"] == "ok")
    print(f"scans done: {ok}/{len(rows)} ok -> {args.out}")


if __name__ == "__main__":
    main()
