"""Fused pipeline: grid build → kNN → frames → fit → curvature.

Port of ``pct_tpu.pipeline.fused``. Curvature is evaluated inside the
bucketed cell loop (``neighbors.cellknn.cellwise_bucket_rows``, the loop
of ``apply_cellwise_bucketed``); only the per-point outputs are moved,
directly to the caller's point order.

- The list engine takes each query's neighborhood straight from the
  select's winner coordinates and runs frames → fit → curvature on it:
  for the explicit (Monge patch) method as one kernel a select
  (``ops.list_fit.list_fit``), for the implicit (quadric) method as the
  eager chain.
- The moments engine (``engine="moments"``; what ``fast_curvature``
  runs for the explicit method at k >= 64, and at smaller k when
  ``list_engine_ok`` refuses a bucket) reduces each neighborhood to 35
  moment sums in the kernel and rebuilds the explicit chain from them
  (``ops.epilogue.moments_epilogue``, ``fit.moments``' chain as one
  kernel), once over the flat stats before the move. The
  implicit method has no moment form: where ``list_engine_ok`` refuses
  it, ``fast_curvature`` takes the staged path (``knn_cloud_grid`` +
  ``pointwise_curvature``), as the JAX package does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.curvature.explicit import Curvatures
from pct_tpu_torch.neighbors.cellknn import (
    _fit_cells,
    _scatter_outputs,
    all_points_spec,
    cellwise_bucket_rows,
    compact_cells,
    default_max_cells,
    list_engine_ok,
    moments_tile_runner,
    probe_grid_buckets,
    split_cells,
)
from pct_tpu_torch.neighbors.grid import GridIndex, build_grid, estimate_cell_size
from pct_tpu_torch.neighbors.knn import knn_cloud_grid
from pct_tpu_torch.ops import build
from pct_tpu_torch.ops.epilogue import moments_epilogue
from pct_tpu_torch.ops.list_fit import list_fit
from pct_tpu_torch.pipeline.curvature_pipeline import (
    neighborhood_curvature,
    pointwise_curvature,
)
from pct_tpu_torch.utils import trace as _trace

MOMENTS_MIN_K = 64    # fast_curvature always takes the moments engine here
SPLIT_TO = 128        # query slots a cell row at most, on the moments route


class FusedResult(NamedTuple):
    curv: Curvatures          # per-point K/H/k1/k2/H², caller's point order
    normals: torch.Tensor     # (N, 3) sign-fixed normals
    exact: torch.Tensor       # (N,) certified-exact kNN per point
    kth_dist: torch.Tensor    # (N,) distance to the kth neighbor


@_trace.stage("scatter")
def _fit_columns(out):
    """The explicit list route's ``post_fn``: its one (rows, 8) output
    (``ops.list_fit``'s layout) -> (K, H, k1, k2, H², normals), views of
    it."""
    (res,) = out
    return (*res[:, :5].unbind(1), res[:, 5:])


def _list_route(method: str, implicit_mode: str):
    """The list engine's chain: (fn, post_fn) of ``cellknn.
    cellwise_bucket_rows``. ``fn`` maps a select's winners (t, C, k, 3)
    and queries (t, C, 3) to a list of output tuples; like the reference,
    all k slots are used unconditionally (rows are audited through the
    exactness certificate). The explicit method is
    ``ops.list_fit.list_fit``, one kernel launch a select on the card and
    one (t, C, 8) output, which ``post_fn`` splits into (K, H, k1, k2,
    H², normals) once every select is concatenated. The implicit method
    runs the eager chain on the query-centred neighbourhoods in runs of
    ``_FIT_QUERIES`` query slots, which bound its per-slot intermediates,
    those six outputs a run."""
    if method == "explicit":
        def fn(nbrs: torch.Tensor, qpts: torch.Tensor):
            return [(list_fit(nbrs, qpts),)]

        return fn, _fit_columns

    def fn(nbrs: torch.Tensor, qpts: torch.Tensor):
        step = _fit_cells(qpts.shape[1])
        outs = []
        for f in range(0, nbrs.shape[0], step):
            curv, normal, _ = neighborhood_curvature(
                nbrs[f:f + step] - qpts[f:f + step, :, None, :], method,
                implicit_mode)
            outs.append((*curv, normal))
        return outs

    return fn, None


@functools.cache
def _build_moments_route():
    """Compile the moments route's kernels, the moments kernel, its
    epilogue and the run table's suffix-min, in one parallel nvcc batch
    (on a cold build cache each op's loader would otherwise build its
    own in turn)."""
    build.build_all(["moments", "epilogue", "run_table"])


@functools.cache
def _build_list_route():
    """Compile the explicit list route's kernels, the coords select, the
    list fit and the run table's suffix-min, in one parallel nvcc
    batch."""
    build.build_all(["select_coords", "list_fit", "run_table"])


@_trace.stage("fit")
def _moments_epilogue(out):
    """Flat (rows, 48) moment stats → (K, H, k1, k2, H², normals): one
    ``moments_epilogue`` over every row (one launch on the card)."""
    (stats,) = out
    res = moments_epilogue(stats)
    return (*res[:, :5].unbind(1), res[:, 5:])


def _check_slice(k: int, method: str, engine: str | None = None):
    if method not in ("explicit", "implicit"):
        raise ValueError(f"unknown method {method!r}")
    if engine not in (None, "list", "moments"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "moments" and method != "explicit":
        raise ValueError("engine='moments' supports method='explicit' only")
    if k < 1:
        raise ValueError(f"k={k} must be positive")


def _fused_rows(grid: GridIndex, k: int, max_cells: int, bucket_spec,
                engine: str = "list", split=None, method: str = "explicit",
                implicit_mode: str = "exact", share=None):
    """The cell table and the engine's cell loop on ``grid``, up to the
    final move: ``cellknn.cellwise_bucket_rows``' flat rows (K, H, k1,
    k2, H², normals), of the ``share`` of every bucket's table."""
    with _trace.span("cells"):
        cells = compact_cells(grid, max_cells)
        if split is not None and split[1] > 1:
            cells = split_cells(cells, grid.sorted_points.shape[0], *split)
    if engine == "moments":
        if grid.sorted_points.is_cuda:
            _build_moments_route()
        return cellwise_bucket_rows(
            grid, cells, k, None, bucket_spec, runner=moments_tile_runner,
            post_fn=_moments_epilogue, share=share)
    if grid.sorted_points.is_cuda and method == "explicit":
        _build_list_route()
    fn, post_fn = _list_route(method, implicit_mode)
    return cellwise_bucket_rows(grid, cells, k, fn, bucket_spec,
                                post_fn=post_fn, share=share)


def _fused_on_grid(grid: GridIndex, k: int, max_cells: int, bucket_spec,
                   engine: str = "list", split=None, method: str = "explicit",
                   implicit_mode: str = "exact") -> FusedResult:
    out, exact, kth, dest = _fused_rows(grid, k, max_cells, bucket_spec,
                                        engine, split, method, implicit_mode)
    (*curv, normals), exact, kth = _scatter_outputs(
        grid.sorted_points.shape[0], dest, out, exact, kth)
    return FusedResult(Curvatures(*curv), normals, exact, kth)


def _layout(n: int, k: int, bucket_spec, max_cells, capacity, cand_cap):
    """(bucket_spec, max_cells) of a ``fused_curvature`` call: the one
    bucket of ``all_points_spec`` without a spec, else the spec with
    ``max_cells`` defaulting to ``default_max_cells``."""
    if bucket_spec is None:
        return all_points_spec(n, k, capacity, max_cells, cand_cap)
    if max_cells is None:
        max_cells = default_max_cells(n, k)
    return bucket_spec, max_cells


def fused_curvature(points: torch.Tensor, num_points: int,
                    cell_size: torch.Tensor, k: int = 20, *,
                    bucket_spec=None, max_cells: int | None = None,
                    capacity: int | None = None, cand_cap: int | None = None,
                    method: str = "explicit",
                    implicit_mode: str = "exact", engine: str = "list",
                    split: tuple | None = None,
                    device: str | torch.device = "cuda") -> FusedResult:
    """Padded points → curvatures through the bucketed cell loop on
    ``device`` (default ``cuda``; raises RuntimeError without a card).

    ``bucket_spec`` and ``max_cells`` come from ``probe_grid_buckets``
    (``fast_curvature`` runs the probe); ``max_cells`` defaults to the
    conservative ``default_max_cells``. With ``bucket_spec=None`` the
    loop runs un-bucketed, as the JAX package's ``apply_cellwise`` does:
    one bucket that takes every cell, of ``capacity`` query slots
    (default 2.5k + 16, 8-rounded) and ``cand_cap`` candidate slots
    (default 27·capacity) a cell (``cellknn.all_points_spec``); it
    launches the same kernels as the bucketed route, for that one
    bucket.
    ``capacity`` and ``cand_cap`` are ignored with a ``bucket_spec``.
    ``method`` is "explicit" or
    "implicit" (``implicit_mode`` "exact" or "reference");
    ``engine`` is "list" or "moments" (explicit only).
    ``split=(cap, factor)`` virtual-splits cells to <= cap
    queries a row (``split_cells``); the spec must then come from
    ``probe_grid_buckets(split_to=cap)``, which returns the factor. No
    exactness repair inside; the ``exact`` output lets the caller audit
    coverage.
    """
    _check_slice(k, method, engine)
    dev = resolve_device(device)
    bucket_spec, max_cells = _layout(points.shape[0], k, bucket_spec,
                                     max_cells, capacity, cand_cap)
    grid = build_grid(points.to(dev), num_points, cell_size.to(dev))
    return _fused_on_grid(grid, k, max_cells, bucket_spec, engine, split,
                          method, implicit_mode)


def plan_engine(grid: GridIndex, k: int):
    """The engine and layout ``fast_curvature`` runs on ``grid`` for the
    explicit method: (engine, bucket_spec, max_cells, split factor).

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


@_trace.stage("fast_curvature")
def fast_curvature(cloud, k: int = 20, method: str = "explicit",
                   implicit_mode: str = "exact", *,
                   device: str | torch.device = "cuda") -> FusedResult:
    """Probe-tuned fused curvature on a PointCloud: the fastest path.

    Estimates the grid cell size and runs on ``device`` (default
    ``cuda``; raises RuntimeError when no card is available). The
    explicit method takes the engine and layout of ``plan_engine``. The
    implicit method runs the list engine when ``list_engine_ok`` admits
    every bucket of the probe (capacity cap max(256, 4k)), at any k;
    otherwise the staged path, ``knn_cloud_grid`` +
    ``pointwise_curvature``, whose ``exact`` is the repaired kNN's
    (all True) and whose kth distance is its last neighbor distance.
    Outputs are (capacity, ...) in the cloud's point order; padding rows
    are 0 on the fused routes.
    """
    _check_slice(k, method)
    dev = resolve_device(device)
    with _trace.span("load"):
        points = cloud.points.to(dev)
    n = cloud.num_points
    cell = estimate_cell_size(points, n, k)
    grid = build_grid(points, n, cell)
    if method == "explicit":
        if grid.sorted_points.is_cuda:
            # the likely route's kernels with the probe's run table, in
            # one nvcc batch before the probe needs its table
            (_build_list_route if k < MOMENTS_MIN_K
             else _build_moments_route)()
        engine, spec, mc, factor = plan_engine(grid, k)
        return _fused_on_grid(grid, k, mc, spec, engine, (SPLIT_TO, factor))
    spec, mc = probe_grid_buckets(grid, capacity_cap=max(256, 4 * k))
    if all(list_engine_ok(sp.capacity, sp.cand_cap, k) for sp in spec):
        return _fused_on_grid(grid, k, mc, spec, method=method,
                              implicit_mode=implicit_mode)
    res, _ = knn_cloud_grid(cloud, k, device=dev)
    curv, normals, _ = pointwise_curvature(points, res.indices, method=method,
                                           implicit_mode=implicit_mode)
    with _trace.span("scatter"):
        return FusedResult(curv, normals, res.exact, res.dists[:, -1])
