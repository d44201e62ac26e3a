"""Fused pipeline: grid build → kNN → frames → fit → curvature.

Port of ``pct_tpu.pipeline.fused`` for the explicit method, on both of
its engines. Curvature is evaluated inside the bucketed cell loop
(``neighbors.cellknn.apply_cellwise_bucketed``); only the per-point
outputs are moved, directly to the caller's point order.

- The list engine (k < 64) takes each query's neighborhood straight from
  the select's winner coordinates and runs frames → fit → curvature on
  it.
- The moments engine (``engine="moments"``; what ``fast_curvature``
  runs for k >= 64, and for smaller k when ``list_engine_ok`` refuses a
  bucket) reduces each neighborhood to 35 moment sums in the kernel and
  rebuilds the same chain from them (``fit.moments``), once over the
  flat stats before the move.

Not in this port yet: the implicit method (raises
``NotImplementedError``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.curvature.explicit import Curvatures, explicit_curvatures
from pct_tpu_torch.fit.frames import tangent_frames
from pct_tpu_torch.fit.moments import curvature_from_moments_chunked
from pct_tpu_torch.fit.quadratic import fit_quadratic
from pct_tpu_torch.neighbors.cellknn import (
    apply_cellwise_bucketed,
    compact_cells,
    default_max_cells,
    list_engine_ok,
    moments_tile_runner,
    probe_grid_buckets,
    split_cells,
)
from pct_tpu_torch.neighbors.grid import GridIndex, build_grid, estimate_cell_size
from pct_tpu_torch.ops.select import KMAX

MOMENTS_MIN_K = 64    # fast_curvature always takes the moments engine here
SPLIT_TO = 128        # query slots a cell row at most, on the moments route


class FusedResult(NamedTuple):
    curv: Curvatures          # per-point K/H/k1/k2/H², caller's point order
    normals: torch.Tensor     # (N, 3) sign-fixed normals
    exact: torch.Tensor       # (N,) certified-exact kNN per point
    kth_dist: torch.Tensor    # (N,) distance to the kth neighbor


def _explicit_fn(centered: torch.Tensor, found: torch.Tensor):
    """Explicit chain over (..., k, 3) neighborhoods: frames → quadratic
    fit → Monge curvatures. Like the reference, all k slots are used
    unconditionally (``found`` is ignored; rows are audited through the
    exactness certificate)."""
    del found
    rotated, _, normal = tangent_frames(centered)
    return tuple(explicit_curvatures(fit_quadratic(rotated))) + (normal,)


def _moments_epilogue(out):
    """Flat (rows, 48) moment stats → (K, H, k1, k2, H², normals)."""
    (stats,) = out
    curv, normals = curvature_from_moments_chunked(
        stats[:, :35], stats[:, 38], stats[:, 39:42], stats[:, 42:45])
    return (*curv, normals)


def _check_slice(k: int, method: str, engine: str | None = None):
    if method != "explicit":
        raise NotImplementedError(
            f"method={method!r}: the implicit-quadric method belongs to a "
            "later slice of the port (fit/quadric.py, curvature/implicit.py)")
    if engine not in (None, "list", "moments"):
        raise ValueError(f"unknown engine {engine!r}")
    if k < 1:
        raise ValueError(f"k={k} must be positive")
    if engine == "list" and k > KMAX:
        raise ValueError(
            f"k={k}: the list engine's select keeps at most {KMAX} "
            "neighbors; larger k takes engine='moments'")


def _fused_on_grid(grid: GridIndex, k: int, max_cells: int, bucket_spec,
                   engine: str = "list", split=None) -> FusedResult:
    cells = compact_cells(grid, max_cells)
    if split is not None and split[1] > 1:
        cells = split_cells(cells, grid.sorted_points.shape[0], *split)
    if engine == "moments":
        out, exact, kth = apply_cellwise_bucketed(
            grid, cells, k, None, bucket_spec, runner=moments_tile_runner,
            post_fn=_moments_epilogue)
    else:
        out, exact, kth = apply_cellwise_bucketed(grid, cells, k,
                                                  _explicit_fn, bucket_spec)
    *curv, normals = out
    return FusedResult(Curvatures(*curv), normals, exact, kth)


def fused_curvature(points: torch.Tensor, num_points: int,
                    cell_size: torch.Tensor, k: int = 20, *, bucket_spec,
                    max_cells: int | None = None, method: str = "explicit",
                    engine: str = "list", split: tuple | None = None,
                    device: str | torch.device = "cuda") -> FusedResult:
    """Padded points → curvatures through the bucketed cell loop on
    ``device`` (default ``cuda``; raises RuntimeError without a card).

    ``bucket_spec`` and ``max_cells`` come from ``probe_grid_buckets``
    (``fast_curvature`` runs the probe); ``max_cells`` defaults to the
    conservative ``default_max_cells``. ``engine`` is "list" (k < 64) or
    "moments". ``split=(cap, factor)`` virtual-splits cells to <= cap
    queries a row (``split_cells``); the spec must then come from
    ``probe_grid_buckets(split_to=cap)``, which returns the factor. No
    exactness repair inside; the ``exact`` output lets the caller audit
    coverage.
    """
    _check_slice(k, method, engine)
    dev = resolve_device(device)
    if max_cells is None:
        max_cells = default_max_cells(points.shape[0], k)
    grid = build_grid(points.to(dev), num_points, cell_size.to(dev))
    return _fused_on_grid(grid, k, max_cells, bucket_spec, engine, split)


def plan_engine(grid: GridIndex, k: int):
    """The engine and layout ``fast_curvature`` runs on ``grid``:
    (engine, bucket_spec, max_cells, split factor).

    k >= 64 always takes the moments engine; smaller k takes the list
    engine unless ``list_engine_ok`` refuses one of its buckets, exactly
    where the JAX package makes the same choice. Both probes cap a
    bucket's capacity at max(256, 4k); the moments route splits cells to
    <= 128 queries a row.
    """
    cap = max(256, 4 * k)
    if k < MOMENTS_MIN_K:
        spec, mc = probe_grid_buckets(grid, capacity_cap=cap)
        if all(list_engine_ok(sp.capacity, sp.cand_cap, k) for sp in spec):
            return "list", spec, mc, 1
    spec, mc, factor = probe_grid_buckets(grid, capacity_cap=cap,
                                          split_to=SPLIT_TO)
    return "moments", spec, mc, factor


def fast_curvature(cloud, k: int = 20, method: str = "explicit", *,
                   device: str | torch.device = "cuda") -> FusedResult:
    """Probe-tuned fused curvature on a PointCloud: the fastest path.

    Estimates the grid cell size, chooses the engine and runs its
    host-side occupancy-bucket probe (``plan_engine``), and executes the
    bucketed pipeline on ``device`` (default ``cuda``; raises
    RuntimeError when no card is available). Outputs are (capacity, ...)
    in the cloud's point order; padding rows are 0.
    """
    _check_slice(k, method)
    dev = resolve_device(device)
    points = cloud.points.to(dev)
    n = cloud.num_points
    cell = estimate_cell_size(points, n, k)
    grid = build_grid(points, n, cell)
    engine, spec, mc, factor = plan_engine(grid, k)
    return _fused_on_grid(grid, k, mc, spec, engine, (SPLIT_TO, factor))
