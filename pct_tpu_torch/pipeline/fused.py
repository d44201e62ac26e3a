"""Fused pipeline: grid build → kNN → frames → fit → curvature.

Port of ``pct_tpu.pipeline.fused`` for the explicit method at k < 64 on
the list engine (the north-star path). Curvature is evaluated INSIDE the
bucketed cell loop (``neighbors.cellknn.apply_cellwise_bucketed``) on
neighborhoods taken straight from the select's winner coordinates; only
the per-point outputs are moved, directly to the caller's point order.

Not in this port yet: the moments engine (k >= 64, ``engine="moments"``)
and the implicit method; both raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.curvature.explicit import Curvatures, explicit_curvatures
from pct_tpu_torch.fit.frames import tangent_frames
from pct_tpu_torch.fit.quadratic import fit_quadratic
from pct_tpu_torch.neighbors.cellknn import (
    apply_cellwise_bucketed,
    compact_cells,
    default_max_cells,
    probe_grid_buckets,
)
from pct_tpu_torch.neighbors.grid import GridIndex, build_grid, estimate_cell_size
from pct_tpu_torch.ops.select import KMAX


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


def _check_slice(k: int, method: str, engine: str):
    if method != "explicit":
        raise NotImplementedError(
            f"method={method!r}: the implicit-quadric method belongs to a "
            "later slice of the port (fit/quadric.py, curvature/implicit.py)")
    if engine != "list":
        raise NotImplementedError(
            f"engine={engine!r}: the moments engine belongs to the "
            "moments slice of the port (ops/pallas_moments.py)")
    if k > KMAX:
        raise NotImplementedError(
            f"k={k}: k >= 64 runs the moments engine, which belongs to the "
            "moments slice of the port")
    if k < 1:
        raise ValueError(f"k={k} must be positive")


def _fused_on_grid(grid: GridIndex, k: int, max_cells: int,
                   bucket_spec) -> FusedResult:
    cells = compact_cells(grid, max_cells)
    out, exact, kth = apply_cellwise_bucketed(grid, cells, k, _explicit_fn,
                                              bucket_spec)
    *curv, normals = out
    return FusedResult(Curvatures(*curv), normals, exact, kth)


def fused_curvature(points: torch.Tensor, num_points: int,
                    cell_size: torch.Tensor, k: int = 20, *, bucket_spec,
                    max_cells: int | None = None, method: str = "explicit",
                    engine: str = "list",
                    device: str | torch.device = "cuda") -> FusedResult:
    """Padded points → curvatures through the bucketed cell loop on
    ``device`` (default ``cuda``; raises RuntimeError without a card).

    ``bucket_spec`` and ``max_cells`` come from ``probe_grid_buckets``
    (``fast_curvature`` runs the probe); ``max_cells`` defaults to the
    conservative ``default_max_cells``. No exactness repair inside; the
    ``exact`` output lets the caller audit coverage.
    """
    _check_slice(k, method, engine)
    dev = resolve_device(device)
    if max_cells is None:
        max_cells = default_max_cells(points.shape[0], k)
    grid = build_grid(points.to(dev), num_points, cell_size.to(dev))
    return _fused_on_grid(grid, k, max_cells, bucket_spec)


def fast_curvature(cloud, k: int = 20, method: str = "explicit", *,
                   device: str | torch.device = "cuda") -> FusedResult:
    """Probe-tuned fused curvature on a PointCloud: the fastest path.

    Estimates the grid cell size, runs the host-side occupancy-bucket
    probe and executes the bucketed pipeline on ``device`` (default
    ``cuda``; raises RuntimeError when no card is available). Outputs
    are (capacity, ...) in the cloud's point order; padding rows are 0.
    """
    _check_slice(k, method, "list")
    dev = resolve_device(device)
    points = cloud.points.to(dev)
    n = cloud.num_points
    cell = estimate_cell_size(points, n, k)
    grid = build_grid(points, n, cell)
    spec, mc = probe_grid_buckets(grid, capacity_cap=max(256, 4 * k))
    return _fused_on_grid(grid, k, mc, spec)
