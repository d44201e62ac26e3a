"""Normal estimation and global sign consistency on the device.

Port of ``pct_tpu.mesh.normals``: covariance normals over each point's
kNN graph, then a wavefront sign propagation (the parallel counterpart
of the MST orientation the reference takes from Open3D) and a consensus
relaxation. Large clouds orient hierarchically: a strided coarse subset
runs the extremal-seed wavefront first, and the full cloud's wavefront
starts from every coarse point at once.

The kNN runs without the exactness repair (sign voting and covariance
normals tolerate a rare truncated neighbor list), on the cell loop of
``neighbors.cellknn``:

- k >= 32: the raw normals are the moments engine's fit normals
  (``moments.cu`` at k, cells split to <= 128 queries a row), and the
  voters a rows select at kv = min(voters, k) on the same grid
  (``select_rows.cu``);
- k < 32: one rows select at k gives both the raw-normal neighborhoods
  and, cut to kv, the voters;
- the coarse graph of the hierarchical path is one rows select at kc
  (<= 16) over ``knn_all_points``' one bucket.

``plan_normals`` derives every static and bucket layout of a call, and
``estimate_and_orient_normals`` runs that plan in two steps,
``raw_normals_and_voters`` and ``orient_planned``: the JAX package's two
jitted bodies as plain functions, the hierarchical seeding that both
repeat written once. The wavefront and the consensus stop early at a
fixed point (a sweep that changes nothing changes nothing after it),
which gives the JAX package's result with fewer sweeps; a consensus
2-cycle runs all its sweeps and ends on the same phase as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.fit.eigh3 import smallest_eigvec3
from pct_tpu_torch.fit.frames import neighborhood_covariance
from pct_tpu_torch.neighbors.cellknn import (
    all_points_spec,
    compact_cells,
    knn_cellwise_bucketed,
    probe_grid_buckets,
)
from pct_tpu_torch.neighbors.grid import (
    GridIndex,
    build_grid,
    estimate_cell_size,
)
from pct_tpu_torch.pipeline.fused import SPLIT_TO, _fused_on_grid

# above this padded capacity one extremal seed cannot cross the kNN graph
# in an affordable sweep count (its diameter grows as sqrt(N) on
# surfaces): a strided subset of about _COARSE_TARGET points is oriented
# first. Read at call time, so tests can lower them.
_HIER_THRESHOLD = 32768
_COARSE_TARGET = 16384
_COARSE_SWEEPS = 512
_CHECK_EVERY = 4     # wavefront sweeps between two fixed-point checks


def estimate_raw_normals(points: torch.Tensor, indices: torch.Tensor,
                         tile: int = 1 << 17) -> torch.Tensor:
    """(N,3) points + (n,k) neighbor indices -> (n,3) unoriented unit
    normals of rows 0..n-1: the smallest-eigenvalue eigenvector of each
    query-centered neighborhood's covariance, in chunks of ``tile``
    rows. Runs on the tensors' device."""
    n = indices.shape[0]
    out = []
    for s in range(0, n, tile):
        idx = indices[s:s + tile].long()
        nbrs = points[idx] - points[s:s + idx.shape[0], None, :]
        out.append(smallest_eigvec3(neighborhood_covariance(nbrs))[1])
    if not out:
        return points.new_zeros((0, 3))
    return torch.cat(out)


def _relax(step, state: torch.Tensor, sweeps: int, every: int):
    """``sweeps`` applications of ``step``; every ``every`` sweeps one
    host sync checks whether the last sweep changed anything, and a
    fixed point ends the loop (every later sweep would return it)."""
    for i in range(sweeps):
        new = step(state)
        if (i + 1) % every == 0 and torch.equal(new, state):
            return new
        state = new
    return state


def orient_normals(points: torch.Tensor, normals: torch.Tensor,
                   indices: torch.Tensor, num_points: int,
                   sweeps: int = 64, seed_mask: torch.Tensor | None = None,
                   seed_signs: torch.Tensor | None = None,
                   consensus: int = 8) -> torch.Tensor:
    """Wavefront sign propagation over the kNN graph ``indices`` (N,kv),
    then ``consensus`` sweeps of relaxation; returns the oriented (N,3)
    normals. Runs on the tensors' device.

    State 0 is unoriented, ±1 an oriented sign. Each sweep, every valid
    unoriented point with an oriented neighbor takes −1 iff its vote
    Σ_j (n_i·n_j)·s_j over its neighbors is below 0 (a vote of exactly 0
    gives +1); oriented points keep their sign. The default seed is the
    first row of the highest valid z, oriented to +z (+1 iff its normal's
    z >= 0); ``seed_mask``/``seed_signs`` (N,) instead start from many
    pre-oriented points. Rows never reached get +1. Each consensus sweep
    then flips, from the previous sweep's signs, every valid point whose
    sign disagrees with its vote (s·vote < 0).
    """
    n = points.shape[0]
    dev = points.device
    ar = torch.arange(n, device=dev)
    valid = ar < num_points
    idx = indices.long()
    nb = normals[idx]
    # elementwise in float32, in a fixed order: no matmul, no TF32
    dots = (nb[..., 0] * normals[:, None, 0] + nb[..., 1] * normals[:, None, 1]
            + nb[..., 2] * normals[:, None, 2])
    del nb

    def sweep(state):
        s_n = state[idx]
        vote = torch.sum(dots * s_n, dim=-1)
        frontier = (state == 0.0) & torch.any(s_n != 0.0, dim=-1) & valid
        return torch.where(frontier, torch.where(vote < 0, -1.0, 1.0), state)

    if seed_mask is None:
        zvals = torch.where(valid, points[:, 2], -torch.inf)
        seed = torch.where(zvals == zvals.max(), ar, n).min().view(1)
        sign = torch.where(normals.index_select(0, seed)[:, 2] >= 0, 1.0, -1.0)
        state = torch.zeros((n,), dtype=points.dtype, device=dev)
        state.scatter_(0, seed, sign.to(points.dtype))
    else:
        state = torch.where(seed_mask & valid, seed_signs, 0.0).to(points.dtype)
    state = _relax(sweep, state, sweeps, _CHECK_EVERY)
    sign = torch.where(state == 0.0, 1.0, state)

    def cons_sweep(s):
        vote = torch.sum(dots * s[idx], dim=-1)
        return torch.where(valid & (s * vote < 0.0), -s, s)

    if consensus:
        sign = _relax(cons_sweep, sign, consensus, 1)
    return normals * sign[:, None]


def _invert_order(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order.long()] = torch.arange(order.shape[0], dtype=order.dtype,
                                     device=order.device)
    return inv


def _graph(grid, layout, k: int) -> torch.Tensor:
    """(N,k) kNN indices over the occupancy buckets of ``layout`` (spec,
    max_cells), rows in the caller's point order; no exactness repair."""
    spec, max_cells = layout
    res = knn_cellwise_bucketed(grid, compact_cells(grid, max_cells), k,
                                spec, lean=True)
    return res.indices[_invert_order(grid.order).long()]


class NormalsPlan(NamedTuple):
    """What ``estimate_and_orient_normals`` runs on one cloud: the statics
    it derives from the padded capacity, the grids, and the bucket layout
    of each select as (spec, max_cells) (the moments route's with its
    split factor). The coarse fields are None off the hierarchical path.
    """
    num_points: int
    k: int
    kv: int
    hierarchical: bool
    stride: int
    kc: int
    sweeps: int                 # the fine wavefront's
    grid: GridIndex             # raw normals' and voters' grid
    moments: tuple | None       # (spec, max_cells, factor) when k >= 32
    rows: tuple                 # voters at kv (k < 32: the one pass at k)
    coarse_points: torch.Tensor | None   # (n_sel, 3), 0 on invalid rows
    coarse_num_points: int
    coarse_grid: GridIndex | None
    coarse: tuple | None        # the coarse graph's one bucket at kc


def plan_normals(points: torch.Tensor, num_points: int, k: int = 50,
                 sweeps: int = 40, voters: int = 12) -> NormalsPlan:
    """The statics, grids and bucket probes of one
    ``estimate_and_orient_normals`` call on (ncap, 3) ``points``, on
    their device.

    Every choice derives from the padded capacity ncap, not from the
    number of points, as in the JAX package: k is cut to max(4, ncap−1);
    the path is hierarchical when ncap > ``_HIER_THRESHOLD``, with stride
    max(2, ceil(ncap / ``_COARSE_TARGET``)), the coarse subset rows 0,
    stride, 2·stride, ... (a valid prefix) on their own grid, its graph
    at kc = min(16, max(4, n_sel − 1)), and the fine wavefront given
    max(sweeps, 4·ceil(sqrt(stride))) sweeps. The kNN grid is the one
    ``estimate_cell_size(k)`` sizes, for both the raw normals and the
    voters; both probes cap a bucket's capacity at max(256, 4k).
    """
    ncap = points.shape[0]
    k = min(k, max(4, ncap - 1))
    hier = ncap > _HIER_THRESHOLD
    stride = max(2, -(-ncap // _COARSE_TARGET)) if hier else 1
    n_sel = -(-ncap // stride)
    kc = min(16, max(4, n_sel - 1))
    fine = max(sweeps, 4 * math.ceil(math.sqrt(stride))) if hier else sweeps
    grid = build_grid(points, num_points,
                      estimate_cell_size(points, num_points, k))
    cap = max(256, 4 * k)
    moments = (probe_grid_buckets(grid, capacity_cap=cap, split_to=SPLIT_TO)
               if k >= 32 else None)
    rows = probe_grid_buckets(grid, capacity_cap=cap)
    cpts = grid_c = coarse = None
    m_c = 0
    if hier:
        sel = torch.arange(n_sel, device=points.device) * stride
        m_c = min(n_sel, -(-num_points // stride))
        cpts = torch.where((sel < num_points)[:, None], points[sel], 0.0)
        grid_c = build_grid(cpts, m_c, estimate_cell_size(cpts, m_c, kc))
        coarse = all_points_spec(n_sel, kc)
    return NormalsPlan(num_points, k, min(voters, k), hier, stride, kc, fine,
                       grid, moments, rows, cpts, m_c, grid_c, coarse)


def raw_normals_and_voters(plan: NormalsPlan, points: torch.Tensor):
    """(raw (ncap,3) unoriented normals, voter indices (ncap,kv)) of a
    plan: for k >= 32 the moments engine's fit normals and a rows select
    at kv, both on the plan's grid; below, one rows select at k gives the
    covariance normals' neighborhoods and, cut to kv, the voters."""
    if plan.moments is not None:
        spec, mc, factor = plan.moments
        raw = _fused_on_grid(plan.grid, plan.k, mc, spec, "moments",
                             (SPLIT_TO, factor)).normals
        return raw, _graph(plan.grid, plan.rows, plan.kv)
    idx = _graph(plan.grid, plan.rows, plan.k)
    return estimate_raw_normals(points, idx), idx[:, :plan.kv]


def orient_planned(plan: NormalsPlan, points: torch.Tensor,
                   raw: torch.Tensor, idx_o: torch.Tensor) -> torch.Tensor:
    """Orient ``raw`` over the voter graph ``idx_o``; hierarchically, the
    wavefront starts from the signs of the plan's oriented coarse subset."""
    n = plan.num_points
    if not plan.hierarchical:
        return orient_normals(points, raw, idx_o, n, sweeps=plan.sweeps)
    ncap = points.shape[0]
    dev = points.device
    cpts, m_c = plan.coarse_points, plan.coarse_num_points
    sel = torch.arange(cpts.shape[0], device=dev) * plan.stride
    valid_c = sel < n
    idx_c = _graph(plan.coarse_grid, plan.coarse, plan.kc)
    raw_c = raw[sel]
    oriented_c = orient_normals(cpts, raw_c, idx_c, m_c,
                                sweeps=_COARSE_SWEEPS)
    csign = torch.where(torch.sum(oriented_c * raw_c, dim=-1) < 0.0, -1.0, 1.0)
    seed_mask = torch.zeros((ncap,), dtype=torch.bool, device=dev)
    seed_mask[sel] = valid_c
    seed_signs = torch.ones((ncap,), dtype=points.dtype, device=dev)
    seed_signs[sel] = csign.to(points.dtype)
    return orient_normals(points, raw, idx_o, n, sweeps=plan.sweeps,
                          seed_mask=seed_mask, seed_signs=seed_signs)


def estimate_and_orient_normals(cloud, k: int = 50, sweeps: int = 40,
                                voters: int = 12, *,
                                device: str | torch.device = "cuda"
                                ) -> torch.Tensor:
    """Oriented unit normals (capacity, 3) of a PointCloud on ``device``
    (default ``cuda``; raises RuntimeError without a card): grid kNN at k
    (default 50, the reference's orientation k) → covariance normals →
    voting orientation over the kv = min(voters, k) nearest, as
    ``plan_normals`` lays it out.
    """
    dev = resolve_device(device)
    points = cloud.points.to(dev)
    plan = plan_normals(points, cloud.num_points, k, sweeps, voters)
    raw, idx_o = raw_normals_and_voters(plan, points)
    return orient_planned(plan, points, raw, idx_o)
