#!/usr/bin/env python3
"""Where the warp-per-query kernels spend their time, on one NVIDIA card.

The rows select (``csrc/select_rows.cu``), the coords select
(``csrc/select_coords.cu``), the band select (``csrc/band_select.cu``)
and the moments kernel (``csrc/moments.cu``) share their first stages
(``csrc/knn_warp.cuh``: staging, d² once into the bit cache, the
four-pass radix select). Their k argument moves work between the
stages, so timing the kernels at several k on the same operands splits
a call into its stages without touching the kernels:

- rows, k=1: staging, d², the radix select, a one-key compaction;
- rows, k=20 / k=100: plus compaction, the warp sort and the writes of
  k winners;
- moments, k=1: staging, d², min/max/count, the radix select, the counts
  and first slots, the member queue with ~1 member a query;
- moments, k=100: plus the ~100 weighted members' monomial chains;
- rows and coords, k=1 / k=20, on the k=20 list engine's buckets: the
  difference between the two at one k is the coordinate emit;
- band, k=1 / k=20 with the cells' counts (the block prologue, hull
  staging, padding fill, d² and the radix select; then compaction, sort
  and the writes of 20 winners), and k=20 with every slot computed.

Operands: every bucket of ``knn_cloud_grid(cloud, 100)``'s probe on the
1M-point torus (padded to 1<<16, as chip_smoke.py builds it), the
buckets the implicit k=100 path and ``fast_curvature(k=100)`` run; every
bucket of ``fast_curvature(cloud, 20)``'s probe; the band kNN's row
blocks of 8 cells at the fitted band, as chip_smoke.py builds them.
Each time is the median of CUDA-event timings of one call per bucket,
summed over the buckets, printed beside the card's name and power limit.

Run from the root of a checkout:
    python3 scripts/torch_micro_warp_stages.py
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N_POINTS = 1_000_000
REPS = 5


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bucket_inputs, card_label, event_ms, fitted_band
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.experimental import build_row_blocks, knn_band_select
    from pct_tpu_torch.experimental.band_knn import band_operands
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.ops.moments import knn_moments
    from pct_tpu_torch.ops.select import knn_select_coords, knn_select_rows
    from pct_tpu_torch.pipeline.fused import plan_engine
    from pct_tpu_torch.shapes import generate_shape

    label = card_label()
    print(f"card: {label}", flush=True)
    pts, _ = generate_shape("torus", N_POINTS, radius=1.0)
    cloud = from_numpy(pts, pad_multiple=1 << 16, device="cuda")
    n = cloud.num_points
    grid = build_grid(cloud.points, n,
                      estimate_cell_size(cloud.points, n, 100))
    spec, mc = cellknn.probe_grid_buckets(grid)
    cells = cellknn.compact_cells(grid, mc)
    ops = [cellknn._select_operands(grid, args, sp.capacity, sp.cand_cap,
                                    with_ids=True)[0]
           for sp, args in cellknn.bucketed_tile_args(grid, cells, spec)]
    runs = [("rows", knn_select_rows, 1), ("rows", knn_select_rows, 20),
            ("rows", knn_select_rows, 100), ("moments", knn_moments, 1),
            ("moments", knn_moments, 100)]
    for name, fn, k in runs:
        per = [event_ms(lambda o=o: fn(*o, k), REPS) for o in ops]
        print(f"[{label}] {name} kernel k={k}: {sum(per):.3f} ms/call over "
              f"{len(per)} buckets (per bucket "
              f"{', '.join(f'{t:.3f}' for t in per)} ms)", flush=True)
    q_slots = sum(o[0].shape[0] * o[0].shape[1] for o in ops)
    slots = sum(o[0].shape[0] * o[0].shape[1] * o[1].shape[1] for o in ops)
    print(f"{len(ops)} buckets, {q_slots} query slots, {slots} padded "
          f"query x candidate slots; each time the median of {REPS}")

    # k=20: the list engine's buckets (rows, coords) and the band kNN
    grid = build_grid(cloud.points, n, estimate_cell_size(cloud.points, n, 20))
    _, spec, mc, _ = plan_engine(grid, 20)
    cells = cellknn.compact_cells(grid, mc)
    ops = [bucket_inputs(cellknn, grid, sp, args)[0]
           for sp, args in cellknn.bucketed_tile_args(grid, cells, spec)]
    for name, fn in (("rows", knn_select_rows), ("coords", knn_select_coords)):
        for k in (1, 20):
            per = [event_ms(lambda o=o: fn(*o, k), REPS) for o in ops]
            print(f"[{label}] {name} kernel k={k} (list engine buckets): "
                  f"{sum(per):.3f} ms/call over {len(per)} buckets (per "
                  f"bucket {', '.join(f'{t:.3f}' for t in per)} ms)",
                  flush=True)
    cells, cap, _, _ = cellknn.probe_grid(grid)
    blocks = build_row_blocks(cells, 8)
    band, _ = fitted_band(grid, cells, blocks, cap, 8)
    bops, _, counts, _ = band_operands(grid, cells, blocks, cap, 8, band)
    for k, cnt in ((1, counts), (20, counts), (20, None)):
        t = event_ms(lambda: knn_band_select(*bops, k=k, bc=8, cap=cap,
                                             band=band, counts=cnt), REPS)
        print(f"[{label}] band kernel k={k}, band {band}, "
              f"{'counts' if cnt is not None else 'every slot computed'}: "
              f"{t:.3f} ms/call ({bops[3].shape[0]} row blocks, "
              f"{int(counts.sum())} of {bops[6].shape[0] * bops[6].shape[1]}"
              f" slots real)", flush=True)


if __name__ == "__main__":
    main()
