"""Band kNN driver: self-excluded kNN of every point with no candidate
gather, over row blocks of grid cells.

Port of ``pct_tpu.experimental.band_knn``. ``build_row_blocks`` groups
the occupied cells into blocks that never span a grid (y,z) row, so the
27-cell windows of a block's cells are 9 contiguous bands of sorted rows
of at most (bc+2)·capacity rows; ``knn_cellwise_band`` builds each
block's band starts, each cell's run windows inside them, the query
coordinates and the window edges, runs the band select
(``band_select.knn_band_select``, one launch, given the cells' point
counts so that it skips the padding slots) and scatters the per-slot
results into SORTED-space rows.
"""

from __future__ import annotations

import numpy as np
import torch

from pct_tpu_torch.experimental.band_select import MAX_BAND, knn_band_select
from pct_tpu_torch.neighbors.cellknn import CellTable, _decode, _scatter_drop
from pct_tpu_torch.neighbors.grid import MAXDIM, PAD_ID, GridIndex
from pct_tpu_torch.neighbors.knn import NeighborResult

_I32 = torch.int32


def default_band(bc: int, capacity: int) -> int:
    """The guaranteed band bound (bc+3)·capacity, rounded up to 128."""
    return ((bc + 3) * capacity + 127) // 128 * 128


def band_operands(grid: GridIndex, cells: CellTable, block_index, capacity: int,
                  bc: int, band: int):
    """The band select's operands for the row blocks of ``block_index``.

    Returns (ops, qrow (S,) each slot's row, counts (NB, bc) int32
    points a cell, 0 for padding cells, band_ok (NB,) every run of the
    block fits its band), where ops = (px, py, pz, bs, rs_rel, run_len,
    qpts, qrow_base, lo_edge, hi_edge) in ``knn_band_select``'s order
    and ``counts`` is its ``counts`` operand: slot s of cell c is real
    where s % capacity < counts[b, c]. The coordinate planes are padded by
    ``band`` zero rows (the JAX package pads by max(band, 1024) for its
    fixed-size DMA; no result depends on the pad).
    """
    n = grid.sorted_points.shape[0]
    dev = grid.sorted_points.device
    bi = torch.as_tensor(block_index, dtype=_I32, device=dev)
    nb = bi.shape[0] // bc
    bi = bi.reshape(nb, bc)
    ok_slot = bi >= 0
    bi_c = torch.where(ok_slot, bi, 0).long()
    start = torch.where(ok_slot, cells.start[bi_c], n).to(_I32)
    count = torch.where(ok_slot, cells.count[bi_c], 0)
    cid = torch.where(ok_slot, cells.cell_id[bi_c], PAD_ID)

    dims = torch.tensor(grid.dims, dtype=_I32, device=dev)
    ix, iy, iz = _decode(torch.where(cid == PAD_ID, 0, cid))
    dyz = torch.tensor([(dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)],
                       dtype=_I32, device=dev)
    ny = iy[..., None] + dyz[:, 0]
    nz = iz[..., None] + dyz[:, 1]
    ok_run = ((ny >= 0) & (ny < dims[1]) & (nz >= 0) & (nz < dims[2])
              & ok_slot[..., None])
    base = ny * MAXDIM + nz * MAXDIM * MAXDIM                  # (NB, bc, 9)
    run_lo = base + torch.clamp_min(ix - 1, 0)[..., None]
    run_hi = base + torch.minimum(ix + 1, dims[0] - 1)[..., None]
    rs = torch.searchsorted(grid.sorted_ids, run_lo.contiguous()).to(_I32)
    re = torch.searchsorted(grid.sorted_ids,
                            (run_hi + 1).contiguous()).to(_I32)
    run_len = torch.where(ok_run, re - rs, 0)

    rs_v = torch.where(run_len > 0, rs, n)
    bs = torch.min(rs_v, dim=1).values                         # (NB, 9)
    bs = torch.where(bs == n, 0, bs)
    band_end = torch.max(torch.where(run_len > 0, rs + run_len, 0),
                         dim=1).values
    band_ok = torch.all(band_end - bs <= band, dim=-1)         # (NB,)
    rs_rel = torch.clamp(rs - bs[:, None, :], 0, band - 1)
    run_len = torch.minimum(run_len, band - rs_rel)

    # cell window edges for the in-kernel coverage radius
    coords = torch.stack([ix, iy, iz], dim=-1)                 # (NB, bc, 3)
    lo_edge = grid.origin + (coords - 1).float() * grid.cell_size
    hi_edge = grid.origin + (coords + 2).float() * grid.cell_size
    lo_edge = torch.where(coords - 1 <= 0, -1e30, lo_edge)
    hi_edge = torch.where(coords + 1 >= dims - 1, 1e30, hi_edge)

    pts = grid.sorted_points
    planes = torch.cat([pts, pts.new_zeros((band, 3))]).T.contiguous()
    qslot = torch.arange(capacity, dtype=_I32, device=dev)
    qrow3 = torch.clamp_max(start[..., None] + qslot, n - 1)  # (NB, bc, C)
    qpts = pts[qrow3.reshape(nb, bc * capacity).long()]       # (NB, Q, 3)
    ops = (planes[0], planes[1], planes[2], bs.to(_I32).contiguous(),
           rs_rel.to(_I32).contiguous(), run_len.to(_I32).contiguous(),
           qpts.contiguous(), start.contiguous(), lo_edge.contiguous(),
           hi_edge.contiguous())
    return ops, qrow3.reshape(-1), count.to(_I32).contiguous(), band_ok


def knn_cellwise_band(grid: GridIndex, cells: CellTable, block_index, k: int,
                      capacity: int, bc: int = 8, band: int | None = None,
                      lean: bool = True) -> NeighborResult:
    """Self-excluded kNN of every point through the band select, rows
    and ids in SORTED order (row r's query is grid.sorted_points[r]).

    ``block_index`` (NB·bc,) int32 from ``build_row_blocks(cells, bc)``
    (numpy or tensor); ``capacity`` query slots a cell; ``band`` defaults
    to the guaranteed bound (bc+3)·capacity rounded to 128 and may not
    exceed ``MAX_BAND``. A row is certified exact when all k neighbors
    were found, the kth distance lies inside the cell window's coverage
    radius, every run of its block fit the band, and the cell table did
    not overflow. Uncovered rows get index 0, distance 0, valid False,
    exact False. ``lean`` returns only the kth distance, as ``dists`` of
    shape (n, 1), and ``valid`` None.
    """
    n = grid.sorted_points.shape[0]
    if band is None:
        band = default_band(bc, capacity)
    if band > MAX_BAND:
        raise ValueError(
            f"band {band} exceeds the kernel's window {MAX_BAND}: "
            f"reduce bc (currently {bc}) or capacity (currently {capacity}) "
            f"so (bc+3)*capacity <= {MAX_BAND}")
    ops, qrow, counts, band_ok = band_operands(grid, cells, block_index,
                                               capacity, bc, band)
    dists, rows, cover = knn_band_select(*ops, k=k, bc=bc, cap=capacity,
                                         band=band, counts=counts)
    slot = torch.arange(capacity, dtype=_I32, device=counts.device)
    ok_q = (slot < counts[..., None]).reshape(-1)   # the computed slots

    found = dists < 1e18                                       # (S, k)
    exact = (found[:, k - 1] & (dists[:, k - 1] <= cover)
             & torch.repeat_interleave(band_ok, bc * capacity)
             & ~cells.overflow)
    dest = torch.where(ok_q, qrow, n)
    out_idx = _scatter_drop(n, 0, dest, rows)
    out_e = _scatter_drop(n, False, dest, exact)
    kth = _scatter_drop(n, 0.0, dest, dists[:, k - 1])
    if lean:
        return NeighborResult(out_idx, kth[:, None], None, out_e)
    out_d = _scatter_drop(n, 0.0, dest, dists)
    out_f = _scatter_drop(n, False, dest, found)
    return NeighborResult(out_idx, out_d, out_f, out_e)


def build_row_blocks(cells: CellTable, block_cells: int) -> np.ndarray:
    """Host-side block layout for the band select: blocks of
    ``block_cells`` occupied-cell slots that never span a grid (y,z)-row
    transition, so each block's 27-cell candidate set is 9 CONTIGUOUS
    sorted-row bands of at most (block_cells+2)·capacity rows.

    Returns (NB·block_cells,) int32 indices into the CellTable arrays,
    -1 for padding slots; the same array as the JAX package's loop,
    computed with vectorised numpy.
    """
    num = int(cells.num_cells)
    cid = cells.cell_id[:num].cpu().numpy()
    if num == 0:
        return np.full(block_cells, -1, dtype=np.int32)
    row_key = cid // MAXDIM          # iy + iz*MAXDIM — constant per row
    ends = np.append(np.flatnonzero(np.diff(row_key) != 0) + 1, num)
    starts = np.concatenate([[0], ends[:-1]])
    per_row = -(-(ends - starts) // block_cells)               # blocks a row
    first = np.cumsum(per_row) - per_row
    within = np.arange(per_row.sum()) - np.repeat(first, per_row)
    b0 = np.repeat(starts, per_row) + within * block_cells     # block starts
    idx = b0[:, None] + np.arange(block_cells)
    out = np.where(idx < np.repeat(ends, per_row)[:, None], idx, -1)
    return out.astype(np.int32).reshape(-1)
