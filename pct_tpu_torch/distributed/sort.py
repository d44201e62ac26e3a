"""Distributed grid build: a sample sort of the cloud over the world.

Port of ``pct_tpu.distributed.sort``. Each rank sorts only its n/d rows
and the global cell-sorted order is assembled with a few collectives,
in the JAX package's five steps:

0. round-robin shuffle: one ``all_to_all_single`` sends local row j to
   rank j mod d, so a spatially coherent input chunk cannot fill one
   (sender, destination) segment;
1. the global bbox (``all_reduce`` MIN and MAX), so every rank quantizes
   exactly as ``build_grid`` does, then one local sort;
2. splitters: an ``all_gather`` of each rank's evenly spaced samples,
   sorted, read at the d-1 quantiles;
3. each rank's rows fall into d contiguous destination segments, packed
   into static (d, send_cap) buffers and exchanged with one
   ``all_to_all_single``, then merged by one local sort;
4. exact rebalance: an ``all_gather`` of the per-rank counts gives every
   row its global rank; rows within ``edge`` of a boundary move one hop
   to their owner over ``batch_isend_irecv``.

The total order is (cell id, original row), the order of the replicated
stable sort, so the result is ``build_grid``'s bit for bit, padding rows
included. The JAX package sorts on two keys; here one int64 key
``id << 32 | row`` carries both (ids and rows are below 2^30). ``ok``
certifies the assembly: False means a static capacity (``send_cap`` or
``edge``) was exceeded and rows were dropped.

Divergences from the JAX package: the returned grid holds this rank's
n/d rows (a shard of JAX's sharded arrays) with the replicated origin,
cell size, dims and valid count; the rebalance sends nothing around the
ends of the world (JAX sends the wrap-around blocks and masks them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from pct_tpu_torch.distributed.sharding import (
    POINTS_AXIS,
    P,
    _mesh_rank,
    _words,
)
from pct_tpu_torch.neighbors.grid import (
    PAD_ID,
    GridIndex,
    build_grid,
    grid_geometry,
    quantize_ids,
)

_HUGE = 1 << 30          # rank sentinel: past any real rank (n < 2^30)


class DistGrid(NamedTuple):
    grid: GridIndex      # this rank's n/d sorted rows
    ok: torch.Tensor     # () bool, every rank: every row reached its owner


def _key(ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int64 (id, row) key: ordering it is ordering by id, then row."""
    return (ids.long() << 32) | rows.long()


def _pts(words: torch.Tensor) -> torch.Tensor:
    """(rows, 3) float32 from three int32 bit-pattern columns."""
    return words.contiguous().view(torch.float32)


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-to-all: equal row blocks, block j to rank j."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _exchange(to_left, to_right, fill, rank: int, d: int, group):
    """Send ``to_left`` to rank-1 and ``to_right`` to rank+1; returns
    (from_left, from_right), each ``fill`` (a row broadcast to the block)
    where there is no neighbour. Nothing goes around the ends, so a world
    of one makes no P2P call."""
    from_left = fill.expand_as(to_right).clone()
    from_right = fill.expand_as(to_left).clone()
    ops = []
    glob = lambda r: dist.get_global_rank(group, r)   # noqa: E731
    if rank > 0:
        ops += [dist.P2POp(dist.isend, to_left.contiguous(), glob(rank - 1),
                           group),
                dist.P2POp(dist.irecv, from_left, glob(rank - 1), group)]
    if rank < d - 1:
        ops += [dist.P2POp(dist.isend, to_right.contiguous(), glob(rank + 1),
                           group),
                dist.P2POp(dist.irecv, from_right, glob(rank + 1), group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_left, from_right


def build_grid_distributed(mesh: DeviceMesh, points: torch.Tensor,
                           num_points: int, cell_size: torch.Tensor,
                           samples: int = 256, send_cap: int | None = None,
                           edge: int | None = None) -> DistGrid:
    """``build_grid`` without the replicated sort: O(n/d) per rank.

    Call on every rank with the same full (n, 3) ``points``, n divisible
    by the world size; each rank takes its n/d rows. ``samples``: sorted
    samples a rank contributes to the splitters; ``send_cap``: static
    rows a (sender, destination) segment holds (default 2× the balanced
    share + 64); ``edge``: the rebalance window (default 4n/(d·samples),
    at least 256). With a world of one this is ``build_grid``. On
    ``ok=False`` fall back to the replicated ``build_grid``.
    """
    group, di, d, dev = _mesh_rank(mesh)
    n = points.shape[0]
    if d == 1:
        return DistGrid(build_grid(points.to(dev), num_points,
                                   cell_size.to(dev)),
                        torch.ones((), dtype=torch.bool, device=dev))
    if n % d:
        raise ValueError(f"{n} points do not split over {d} ranks")
    nl = n // d
    samples = min(samples, nl)
    if send_cap is None:
        send_cap = min(nl, 2 * ((nl + d - 1) // d) + 64)
    if edge is None:
        edge = min(max(256, (4 * n) // (d * samples)), nl)
    edge = min(edge, d * send_cap)
    base = di * nl
    i32 = torch.int32
    pts = points[base:base + nl].to(dev)
    rows = base + torch.arange(nl, dtype=i32, device=dev)

    # --- 0. round-robin shuffle ---
    if nl % d == 0:
        w = _words(pts, rows)
        w = _a2a(w.reshape(nl // d, d, 4).transpose(0, 1).reshape(nl, 4),
                 group)
        pts, rows = _pts(w[:, :3]), w[:, 3].contiguous()

    # --- 1. quantize with the global bbox, sort locally ---
    valid = rows < num_points
    lo = torch.where(valid[:, None], pts, torch.inf).min(dim=0).values
    hi = torch.where(valid[:, None], pts, -torch.inf).max(dim=0).values
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    origin, dims, cell = grid_geometry(lo, hi, cell_size.to(dev))
    ids = quantize_ids(pts, valid, origin, cell, dims)
    key, perm = torch.sort(_key(ids, rows))
    pts_s = pts[perm]

    # --- 2. two-key splitters from an all-gathered sample ---
    pos = torch.arange(samples, device=dev) * (nl // samples)
    pool, _ = torch.sort(DTensor.from_local(key[pos], mesh, P(POINTS_AXIS))
                         .full_tensor())
    q = (torch.arange(1, d, device=dev) * (d * samples)) // d - 1
    splitters = pool[q]

    # --- 3. destination segments, packed and exchanged ---
    dest = torch.searchsorted(splitters, key)       # splitters below the row
    seg_start = torch.searchsorted(dest, torch.arange(d, device=dev))
    in_seg = torch.arange(nl, device=dev) - seg_start[dest]
    send_lost = torch.any(in_seg >= send_cap)
    slot = torch.where(in_seg < send_cap, dest * send_cap + in_seg,
                       d * send_cap)
    send = _words(torch.full((d * send_cap + 1,), PAD_ID, dtype=i32,
                             device=dev),
                  torch.full((d * send_cap + 1,), _HUGE, dtype=i32,
                             device=dev),
                  torch.zeros((d * send_cap + 1, 3), device=dev))
    send[slot] = _words((key >> 32).to(i32), (key & 0xFFFFFFFF).to(i32),
                        pts_s)
    recv = _a2a(send[:-1], group)

    # --- 3b. merge by (id, original row); unused slots (PAD_ID, _HUGE)
    # sort past every real row, padding rows included ---
    perm = torch.argsort(_key(recv[:, 0], recv[:, 1]))
    merged = recv[perm]
    v = int(torch.sum(merged[:, 1] != _HUGE))        # my rows, pad included

    # --- 4. exact rebalance to n/d rows a rank ---
    counts = DTensor.from_local(torch.tensor([v], device=dev), mesh,
                                P(POINTS_AXIS)).full_tensor()
    start = int(torch.sum(counts[:di]))
    total = int(torch.sum(counts))
    m = d * send_cap
    mpos = torch.arange(m, device=dev)
    real = mpos < v
    grank = torch.where(real, start + mpos, _HUGE)
    owner = torch.clamp(grank // nl, 0, d - 1)
    stuck = real & ((owner < di - 1) | (owner > di + 1)
                    | ((owner == di - 1) & (mpos >= edge))
                    | ((owner == di + 1) & (mpos < v - edge)))
    lost = (torch.any(stuck) | send_lost).to(i32)

    blocks = torch.cat([grank.to(i32)[:, None], merged], dim=1)  # (m, 6)
    tail = min(max(v - edge, 0), m - edge)
    fill = torch.tensor([_HUGE, PAD_ID, _HUGE, 0, 0, 0], dtype=i32,
                        device=dev)
    from_left, from_right = _exchange(blocks[:edge], blocks[tail:tail + edge],
                                      fill, di, d, group)
    cand = torch.cat([from_left, blocks, from_right])
    tslot = cand[:, 0].long() - base
    keep = (cand[:, 0] < total) & (tslot >= 0) & (tslot < nl)
    out = _words(torch.full((nl,), PAD_ID, dtype=i32, device=dev),
                 base + torch.arange(nl, dtype=i32, device=dev),
                 torch.zeros((nl, 3), device=dev))
    out[tslot[keep]] = cand[keep][:, 1:]
    dist.all_reduce(lost, group=group)
    grid = GridIndex(sorted_points=_pts(out[:, 2:5]), order=out[:, 1].clone(),
                     sorted_ids=out[:, 0].clone(), origin=origin,
                     cell_size=cell,
                     dims=tuple(int(x) for x in dims.tolist()),
                     num_valid=int(num_points))
    return DistGrid(grid, lost == 0)
