#!/usr/bin/env python3
"""Where the time of the port's main paths goes, on one NVIDIA card.

Drives ``pct_tpu_torch.pipeline.fast_curvature(k)`` (``--path fast``),
the library kNN ``pct_tpu_torch.neighbors.knn_cloud_grid(k)``
(``--path knn``) or the band kNN
``pct_tpu_torch.experimental.knn_cellwise_band`` (``--path band``: grid,
row blocks of 8 cells and the fitted band built once, as chip_smoke.py
builds them) on the 1M-point torus (padded to 1<<16, as chip_smoke.py
does), warms it up, then traces one call with ``torch.profiler`` and
prints:

- the card's name and power limit (nvidia-smi);
- the call's wall time, the device's busy time (union of kernel
  intervals) and its idle share;
- device time by kernel / op, largest first.

chip_smoke.py prints the host-side stage times of the same call.

Run from the root of a checkout:
    python3 scripts/torch_trace_fast_curvature.py [--path fast|knn|band]
        [--k K]
        [--trace-out PATH]
``--k`` is the neighbor count (default 20: the list engine; k >= 64
runs the moments engine of ``fast_curvature``). ``--trace-out`` also
writes the Chrome trace of the traced call.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N_POINTS = 1_000_000


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("fast", "knn", "band"),
                    default="fast", help="fast_curvature (default), "
                    "knn_cloud_grid or knn_cellwise_band")
    ap.add_argument("--k", type=int, default=20,
                    help="neighbors per point (default 20)")
    ap.add_argument("--trace-out", type=Path, default=None,
                    help="write the Chrome trace of the traced call here")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_label, fitted_band
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.experimental import build_row_blocks, knn_cellwise_band
    from pct_tpu_torch.neighbors import cellknn, knn_cloud_grid
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.pipeline import fast_curvature
    from pct_tpu_torch.shapes import generate_shape

    label = card_label()
    print(f"card: {label}", flush=True)
    pts, _ = generate_shape("torus", N_POINTS, radius=1.0)
    cloud = from_numpy(pts, pad_multiple=1 << 16, device="cuda")
    path = {"fast": fast_curvature, "knn": knn_cloud_grid}.get(args.path)
    if args.path == "band":
        n = cloud.num_points
        grid = build_grid(cloud.points, n,
                          estimate_cell_size(cloud.points, n, args.k))
        cells, cap, _, _ = cellknn.probe_grid(grid)
        blocks = build_row_blocks(cells, 8)
        band, _ = fitted_band(grid, cells, blocks, cap, 8)

        def path(cloud, k):
            return knn_cellwise_band(grid, cells, blocks, k, cap, band=band)
        path.__name__ = f"knn_cellwise_band(band={band})"
    for _ in range(2):
        path(cloud, args.k)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        path(cloud, args.k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_s = busy * 1e-6
    print(f"[{label}] traced {path.__name__} call, k={args.k}: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy_s * 1e3:.1f} ms ({len(spans)} device events), "
          f"idle share {1 - busy_s / wall:.3f}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25))
    if args.trace_out is not None:
        args.trace_out.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace_out))


if __name__ == "__main__":
    main()
