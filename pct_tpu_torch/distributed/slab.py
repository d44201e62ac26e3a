"""Slab-resident kNN + curvature with a halo exchange between ranks.

Port of ``pct_tpu.distributed.slab``. The query-sharded layer
(sharding.py) replicates the cloud; here each rank owns a slab of the
cell-sorted order and holds only its slab plus a halo:

- the cell-sorted rows (``build_grid``, or the sample sort of
  ``build_grid_distributed``) split into d equal contiguous slabs, each
  a spatially coherent piece of the cloud;
- each rank sends its first and last ``halo`` rows to its neighbours
  over ``batch_isend_irecv`` and builds a local grid over left halo ++
  slab ++ right halo;
- it runs the un-bucketed fused cell loop over its local cells and
  keeps its own rows;
- an id-range certificate marks every query whose 3³ window may reach
  past the halo as inexact; ``probe_slab_halo`` finds the smallest halo
  that certifies wherever the single-device path does.

Divergence from the JAX package: nothing is sent around the ends of the
world. JAX sends the wrap-around pairs and then masks them; here the
first rank's left halo and the last rank's right halo are PAD_ID rows
and the certificate bounds are set to -1 and 2^30 + 2 directly, which is
the same result, and a world of one makes no P2P call (NCCL has no send
to self). There is no ``select_impl`` and no ``tile_cells``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from pct_tpu_torch.curvature.explicit import Curvatures
from pct_tpu_torch.distributed.sharding import (  # noqa: F401
    POINTS_AXIS,
    P,
    _mesh_rank,
    _words,
    make_mesh,
)
from pct_tpu_torch.distributed.sort import (
    _exchange,
    _pts,
    build_grid_distributed,
)
from pct_tpu_torch.neighbors.cellknn import (
    all_points_spec,
    apply_cellwise_bucketed,
    compact_cells,
)
from pct_tpu_torch.neighbors.grid import (
    _MULT,
    PAD_ID,
    GridIndex,
    build_grid,
    cell_coords,
    estimate_cell_size,
    linearize,
)
from pct_tpu_torch.pipeline.fused import _check_slice, _list_route

_X_RIGHT_END = 2**30 + 2      # past every cell id: no right neighbour


class SlabResult(NamedTuple):
    curv: Curvatures         # (N,) in SORTED order (slabs concatenated)
    normals: torch.Tensor
    exact: torch.Tensor
    kth_dist: torch.Tensor
    order: torch.Tensor      # original index per sorted row (for unsorting)


def best_axis_order(points: torch.Tensor, num_points: int) -> tuple:
    """Axis permutation putting the largest bbox extent on the SLOWEST
    linearize axis (last): the sorted order is x-fastest/z-slowest, so
    thin slowest-axis layers make a slab boundary cost the least halo.
    One host sync (the (3,) extents)."""
    valid = points[:num_points]
    e = (valid.max(dim=0).values - valid.min(dim=0).values).cpu().numpy()
    return tuple(int(a) for a in np.argsort(e))   # ascending: largest last


def probe_slab_halo(grid: GridIndex, n_devices: int, min_halo: int = 64,
                    multiple: int = 64) -> int:
    """Certified halo width (sorted rows per side) for ``n_devices`` slabs.

    The certificate of ``slab_curvature`` passes iff x_left =
    ids[b-halo-1] sits strictly below the smallest 3³ window id of the
    slab's queries and x_right = ids[b+halo] strictly above the largest;
    a window spans at most ±W = linearize((1,1,1)) around the query's
    cell id. Reads the sorted ids once (host numpy) and returns the
    smallest multiple of ``multiple`` (at least ``min_halo``) for which
    every slab boundary satisfies both, so ``exact`` is 1.0 wherever the
    single-device path's would be. Raises ValueError if a boundary needs
    a halo >= the slab size.
    """
    ids = grid.sorted_ids.cpu().numpy().astype(np.int64)
    n = ids.shape[0]
    d = int(n_devices)
    sl = n // d
    W = _MULT[2] + _MULT[1] + 1   # unclipped 3^3 window id half-span
    pad = int(PAD_ID)
    h = int(min_halo)
    for s in range(1, d):
        b = s * sl
        if ids[b] < pad:
            # left condition for slab s: ids[b-h-1] < min window id
            lo = int(np.searchsorted(ids[:b], ids[b] - W, side="left"))
            h = max(h, b - lo)
        # right condition for slab s-1: x_right above the last VALID
        # query's window (padding rows are not queries)
        j = int(np.searchsorted(ids[:b], pad, side="left")) - 1
        if j >= (s - 1) * sl:
            hi = int(np.searchsorted(ids, ids[j] + W, side="right"))
            h = max(h, hi - b)
    h = ((h + multiple - 1) // multiple) * multiple
    if h >= sl:
        raise ValueError(
            f"certified halo {h} >= slab size {sl}: the cloud's sorted-id "
            f"layout cannot be split into {d} certified slabs — use fewer "
            "devices or the replicated query-sharded layer")
    return h


def slab_curvature(mesh: DeviceMesh, points: torch.Tensor, num_points: int,
                   cell_size: torch.Tensor, k: int = 20,
                   halo: int | None = None, capacity: int | None = None,
                   cand_cap: int | None = None, method: str = "explicit",
                   implicit_mode: str = "exact",
                   distributed_sort: bool = False,
                   axis_order: tuple | None = None) -> SlabResult:
    """The slab-resident step; call on every rank with the same arguments.

    ``halo``: sorted rows exchanged per side (default max(256, 8k),
    certified by ``exact``; ``slab_curvature_unsorted`` probes it).
    ``capacity``/``cand_cap``: the local cell loop's one bucket (default
    2.5k + 16, 8-rounded, and 27·capacity). ``axis_order``: permutation
    of the point columns before the grid sort (inverted on the normals);
    ``best_axis_order`` gives the halo-minimising one.
    ``distributed_sort``: build the sorted order with
    ``build_grid_distributed`` (O(n/d) a rank) instead of one replicated
    sort; the output is the same, and a capacity overflow there sets
    every ``exact`` to False. Every rank returns the whole (N,) result
    in sorted order, with ``order`` to unsort it.
    """
    _check_slice(k, method, "list")
    group, di, d, dev = _mesh_rank(mesh)
    if halo is None:
        halo = max(256, 8 * k)
    inv_order = None
    if axis_order is not None and tuple(axis_order) != (0, 1, 2):
        points = points[:, list(axis_order)]
        inv_order = list(np.argsort(axis_order))
    n = points.shape[0]
    if n % d:
        raise ValueError(f"{n} points do not split over {d} ranks")
    nl = n // d
    if not 0 < halo < nl:
        raise ValueError(f"halo {halo} must lie in (0, slab size {nl})")
    local_n = nl + 2 * halo

    if distributed_sort:
        grid, sort_ok = build_grid_distributed(mesh, points, num_points,
                                               cell_size)
        slab_pts, slab_ids, slab_rows = (grid.sorted_points,
                                         grid.sorted_ids, grid.order)
    else:
        grid = build_grid(points.to(dev), num_points, cell_size.to(dev))
        sort_ok = None
        own = slice(di * nl, (di + 1) * nl)
        slab_pts, slab_ids, slab_rows = (grid.sorted_points[own],
                                         grid.sorted_ids[own],
                                         grid.order[own])

    # --- halo exchange: each edge block carries, in its last row, the id
    # of the first row NOT sent (the certificate's bound) ---
    i32 = torch.int32
    zeros = torch.zeros((1, 3), dtype=i32, device=dev)
    to_left = torch.cat([_words(slab_ids[:halo], slab_pts[:halo]),
                         _words(slab_ids[halo:halo + 1], zeros)])
    to_right = torch.cat([_words(slab_ids[-halo:], slab_pts[-halo:]),
                          _words(slab_ids[nl - halo - 1:nl - halo], zeros)])
    from_left, from_right = _exchange(
        to_left, to_right,
        torch.tensor([PAD_ID, 0, 0, 0], dtype=i32, device=dev), di, d, group)
    x_left = int(from_left[-1, 0]) if di > 0 else -1
    x_right = int(from_right[-1, 0]) if di < d - 1 else _X_RIGHT_END

    local_ids = torch.cat([from_left[:-1, 0], slab_ids, from_right[:-1, 0]])
    local_pts = torch.cat([_pts(from_left[:-1, 1:]), slab_pts,
                           _pts(from_right[:-1, 1:])])
    # the local rows are cell-sorted except the PAD_ID ends: re-sort
    order_l = torch.sort(local_ids, stable=True).indices
    lgrid = GridIndex(
        sorted_points=local_pts[order_l], order=order_l.to(i32),
        sorted_ids=local_ids[order_l], origin=grid.origin,
        cell_size=grid.cell_size, dims=grid.dims,
        num_valid=int(torch.sum(local_ids != PAD_ID)))
    spec, mc = all_points_spec(local_n, k, capacity, None, cand_cap)
    fn, post_fn = _list_route(method, implicit_mode)
    (*curv_l, normal_l), exact_l, kth_l = apply_cellwise_bucketed(
        lgrid, compact_cells(lgrid, mc), k, fn, spec, post_fn=post_fn)

    # keep the slab's own rows; the id-range certificate: every cell id
    # strictly inside (x_left, x_right) is complete in slab + halo
    own_l = slice(halo, halo + nl)
    qc = cell_coords(slab_pts, grid.origin, grid.cell_size, grid.dims)
    top = torch.tensor(grid.dims, dtype=i32, device=dev) - 1
    win_lo = linearize(torch.minimum(torch.clamp_min(qc - 1, 0), top))
    win_hi = linearize(torch.minimum(torch.clamp_min(qc + 1, 0), top))
    exact = exact_l[own_l] & (win_lo > x_left) & (win_hi < x_right)

    cols = [c[own_l] for c in curv_l]
    words = _words(*cols, normal_l[own_l], kth_l[own_l], exact, slab_rows)
    slab = DTensor.from_local(words, mesh, P(POINTS_AXIS)).full_tensor()
    f = slab[:, :9].contiguous().view(torch.float32)
    *curv, kth = f[:, [0, 1, 2, 3, 4, 8]].T.contiguous()
    normals = f[:, 5:8] if inv_order is None else f[:, 5:8][:, inv_order]
    exact = slab[:, 9] > 0
    if sort_ok is not None:
        exact = exact & sort_ok
    return SlabResult(Curvatures(*curv), normals.contiguous(), exact, kth,
                      slab[:, 10].contiguous())


def slab_curvature_unsorted(mesh: DeviceMesh, cloud, k: int = 20, **kw):
    """Original-order (curvatures, normals, exact) of a PointCloud.

    Estimates the cell size; when no ``halo`` is passed it takes the
    halo-minimising axis order and probes the certified halo on the
    permuted grid (``probe_slab_halo``), so ``exact`` is 1.0 wherever the
    single-device path's would be. Other keywords go to
    ``slab_curvature``."""
    dev = _mesh_rank(mesh)[3]
    points = cloud.points.to(dev)
    n = cloud.num_points
    cell = estimate_cell_size(points, n, k)
    if kw.get("halo") is None:
        order = kw.get("axis_order")
        if order is None:
            order = best_axis_order(points, n)
            kw["axis_order"] = order
        grid = build_grid(points[:, list(order)], n, cell)
        kw["halo"] = probe_slab_halo(grid, _mesh_rank(mesh)[2])
    res = slab_curvature(mesh, points, n, cell, k=k, **kw)

    def unsort(a):
        out = torch.zeros_like(a)
        out[res.order.long()] = a
        return out

    return (Curvatures(*[unsort(c) for c in res.curv]),
            unsort(res.normals), unsort(res.exact))
