"""Grid-hash kNN and ε-ball queries, with certified exactness.

Port of ``pct_tpu.neighbors.knn``. ``knn_cloud_grid`` is the library
kNN of a whole cloud: the cell-centric loop (``cellknn``, the rows
select kernel), or the query-centric ``knn_grid`` for ``rings != 1``,
then a repair pass that re-resolves every query the grid could not
certify through the brute-force oracle, so results are exact for any
density. A query is certified exact iff all k neighbors were found, the
kth distance lies inside the scanned window's guaranteed coverage radius
and no scanned cell overflowed.

``knn_grid`` (the query-centric path, also behind ``ball_grid``) gathers
up to ``capacity`` candidates from each of the (2·rings+1)³ cells around
the query's cell and takes the k smallest outside any kernel, as the JAX
package takes ``lax.top_k``, in its order: ascending distance, the lower
candidate column first on equal distances (``bruteforce.smallest_k``;
``torch.topk`` alone keeps no tie order).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.neighbors.bruteforce import knn_bruteforce, smallest_k
from pct_tpu_torch.neighbors.grid import (
    PAD_ID,
    GridIndex,
    build_grid,
    cell_coords,
    estimate_cell_size,
    neighbor_cell_ids,
)
from pct_tpu_torch.utils import trace as _trace


class NeighborResult(NamedTuple):
    indices: torch.Tensor            # (Q, k) int32 original point indices
    dists: torch.Tensor              # (Q, k) float32 ascending
    valid: Optional[torch.Tensor]    # (Q, k) bool: False where not found
    exact: torch.Tensor              # (Q,) bool: certified-exact queries


def _coverage_radius(q: torch.Tensor, qc: torch.Tensor, grid: GridIndex,
                     rings: int) -> torch.Tensor:
    """(Q,) guaranteed covered radius of the scanned cell window."""
    dims = torch.tensor(grid.dims, dtype=torch.int32, device=q.device)
    lo_edge = grid.origin + (qc - rings).float() * grid.cell_size
    hi_edge = grid.origin + (qc + rings + 1).float() * grid.cell_size
    left = torch.where(qc - rings <= 0, torch.inf, q - lo_edge)
    right = torch.where(qc + rings >= dims - 1, torch.inf, hi_edge - q)
    return torch.minimum(left.min(dim=-1).values, right.min(dim=-1).values)


def _gather_candidates(grid: GridIndex, q: torch.Tensor, capacity: int,
                       rings: int):
    """(Q,3) queries -> (sorted rows (Q,M), d2 (Q,M), ok (Q,M),
    (overflow (Q,), coverage (Q,))), M = (2·rings+1)³ · capacity."""
    n = grid.sorted_points.shape[0]
    qc = cell_coords(q, grid.origin, grid.cell_size, grid.dims)
    nids = neighbor_cell_ids(qc, grid.dims, rings)            # (Q, 27)
    starts = torch.searchsorted(grid.sorted_ids, nids.contiguous(),
                                side="left").to(torch.int32)
    slot = torch.arange(capacity, dtype=torch.int32, device=q.device)
    raw = starts[..., None] + slot                            # (Q, 27, C)
    cand = torch.clamp_max(raw, n - 1).long()
    # the in-range mask is needed: without a padding tail, clipped slots
    # land on row n-1, whose id can match the queried cell
    ok = ((grid.sorted_ids[cand] == nids[..., None])
          & (nids[..., None] != PAD_ID) & (raw < n))
    # a cell overflows when the slot one past capacity still holds its id
    probe = torch.clamp_max(starts + capacity, n - 1).long()
    overflow = torch.any((grid.sorted_ids[probe] == nids) & (nids != PAD_ID)
                         & (starts + capacity <= n - 1), dim=-1)
    diff = grid.sorted_points[cand] - q[:, None, None, :]     # (Q, 27, C, 3)
    d2 = torch.sum(diff * diff, dim=-1)
    m = nids.shape[-1] * capacity
    return (cand.reshape(-1, m), d2.reshape(-1, m), ok.reshape(-1, m),
            (overflow, _coverage_radius(q, qc, grid, rings)))


def _knn_grid_parts(grid: GridIndex, queries: torch.Tensor, k: int,
                    query_indices, capacity: int, rings: int, tile: int,
                    exclude_self: bool):
    """``knn_grid`` plus each query's coverage radius and overflow flag."""
    nq = queries.shape[0]
    if query_indices is None:
        query_indices = torch.arange(nq, dtype=torch.int32,
                                     device=queries.device)
    parts = []
    for s in range(0, nq, tile):
        q, qidx = queries[s:s + tile], query_indices[s:s + tile]
        cand, d2, ok, (overflow, cover) = _gather_candidates(
            grid, q, capacity, rings)
        orig = grid.order[cand]
        if exclude_self:
            ok = ok & (orig != qidx[:, None])
        d2, pos = smallest_k(torch.where(ok, d2, torch.inf), k)
        dists = torch.sqrt(d2)
        found = torch.isfinite(d2)
        exact = found[:, k - 1] & (dists[:, k - 1] <= cover) & ~overflow
        parts.append((torch.gather(orig, 1, pos), dists, found, exact, cover,
                      overflow))
    idx, dist, val, exact, cover, overflow = (torch.cat(a) for a in
                                              zip(*parts))
    return NeighborResult(idx, dist, val, exact), cover, overflow


def knn_grid(grid: GridIndex, queries: torch.Tensor, k: int,
             query_indices: torch.Tensor | None = None, capacity: int = 64,
             rings: int = 1, tile: int = 1024,
             exclude_self: bool = True) -> NeighborResult:
    """Batched kNN of (Q,3) ``queries`` against a GridIndex, in chunks of
    ``tile`` queries. ``query_indices`` (default arange) is each query's
    original index, used for self-exclusion (the reference's "k+1, drop
    self"). Indices are original point ids."""
    return _knn_grid_parts(grid, queries, k, query_indices, capacity, rings,
                           tile, exclude_self)[0]


def ball_grid(grid: GridIndex, queries: torch.Tensor, radius,
              max_neighbors: int, query_indices: torch.Tensor | None = None,
              capacity: int = 64, rings: int = 1, tile: int = 1024,
              exclude_self: bool = False) -> NeighborResult:
    """ε-ball query: (Q, max_neighbors) nearest-first neighbor lists with
    ``valid`` marking the slots inside ``radius``. The scanned cells must
    cover the radius: build the grid with cell_size >= radius / rings.

    ``exact`` is the ball certificate: the radius lies inside the
    window's coverage, no cell overflowed, and the list is not truncated
    (its last slot is absent or beyond the radius).
    """
    res, cover, overflow = _knn_grid_parts(
        grid, queries, max_neighbors, query_indices, capacity, rings, tile,
        exclude_self)
    inside = res.valid & (res.dists <= radius)
    truncated = res.valid[:, -1] & (res.dists[:, -1] <= radius)
    exact = (radius <= cover) & ~overflow & ~truncated
    return NeighborResult(res.indices, res.dists, inside, exact)


def knn_cloud_grid(cloud, k: int, capacity: int | None = None,
                   rings: int = 1, cell_size=None, tile: int = 512,
                   exact_fallback: bool = True, *,
                   device: str | torch.device = "cuda"):
    """Grid build (auto cell size) + self-excluded kNN of every point of
    a PointCloud on ``device`` (default ``cuda``; raises RuntimeError
    without a card), with certified exactness. Returns (NeighborResult in
    the cloud's point order, GridIndex).

    The default runs the occupancy-bucketed cell loop with probed
    capacities; an explicit ``capacity`` runs one bucket of that capacity;
    ``rings != 1`` runs the query-centric ``knn_grid`` in chunks of
    ``tile`` queries (the other routes take no chunk). ``exact_fallback``
    re-resolves the rows the grid could not certify through brute force
    (one host sync to find them; a no-op on well-behaved clouds); when
    more than half of the rows need it, the whole cloud goes through
    brute force, whose slots beyond the cloud size carry inf distances
    and are not valid.
    """
    from pct_tpu_torch.neighbors.cellknn import (
        knn_all_points,
        knn_all_points_auto_bucketed,
    )

    dev = resolve_device(device)
    with _trace.span("load"):
        points = cloud.points.to(dev)
    n = cloud.num_points
    with _trace.span("grid"):
        if cell_size is None:
            cell_size = estimate_cell_size(points, n, k)
        cell_size = torch.as_tensor(cell_size, dtype=torch.float32,
                                    device=dev)
        grid = build_grid(points, n, cell_size)
    if rings != 1:
        # the cell-centric loop is a 27-cell (rings=1) design
        res = knn_grid(grid, grid.sorted_points, k, query_indices=grid.order,
                       capacity=capacity or 64, rings=rings, tile=tile)
    elif capacity is not None:
        res = knn_all_points(grid, k, capacity=capacity)
    else:
        res = knn_all_points_auto_bucketed(grid, k)
    with _trace.span("scatter"):
        order = grid.order.long()
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=dev)
        res = NeighborResult(*(a[inv] for a in res))
    if exact_fallback:
        res = _repair(res, points, n, k)
    return res, grid


@_trace.stage("repair")
def _repair(res: NeighborResult, points: torch.Tensor, n: int, k: int):
    """``res`` with every row it does not certify re-resolved by brute
    force (the whole cloud when more than half of the rows need it);
    counts the rows (``rows``, ``repair_rows``, ``repair_whole``)."""
    inexact = torch.nonzero(~res.exact[:n]).flatten()
    _trace.count("rows", n)
    _trace.count("repair_rows", inexact.numel())
    if inexact.numel() > n // 2:
        _trace.count("repair_whole", 1)
        bi, bd = knn_bruteforce(points, n, k)
        return NeighborResult(bi, bd, torch.isfinite(bd),
                              torch.ones_like(res.exact))
    if inexact.numel():
        bi, bd = knn_bruteforce(points, n, k, queries=points[inexact],
                                query_indices=inexact)
        res = NeighborResult(*(a.clone() for a in res))
        res.indices[inexact] = bi
        res.dists[inexact] = bd
        res.valid[inexact] = torch.isfinite(bd)
        res.exact[inexact] = True
    return res
