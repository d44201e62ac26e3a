"""Cell-centric kNN: the cell loop of library kNN and of both
curvature engines.

Port of ``pct_tpu.neighbors.cellknn``. Queries that share a grid cell
share their whole candidate set, so the loop runs over OCCUPIED CELLS:
per cell, the 27-cell neighborhood is fetched once as 9 contiguous runs
of 3 x-adjacent cells (contiguous in the sorted array because cell ids
linearize x fastest). A select kernel picks each query's k nearest:
library kNN (``knn_cellwise_bucketed``, ``knn_cellwise``,
``knn_all_points*``) takes the winners' ids, the list engine the
winners' coordinates and runs the caller's ``fn`` on the neighborhoods;
the moments engine's kernel reduces them to moment sums that a
``post_fn`` turns into curvature. Cells are grouped into occupancy
buckets (``probe_grid_buckets``), each with its own (capacity, cand_cap)
shape, so padding tracks each cell's size; big cells can be split into
virtual rows (``split_cells``). Every bucket makes one kernel launch
over all of its cells. Exactness is certified per query (coverage
radius, candidate budget, cell-table overflow) exactly as in the JAX
package.

Left out, because only the TPU needs them: packed candidate rows
(``_cand_pack``: the port always fetches one point per row, pack=1), the
float32 id channel of the packed fetch (the port gathers int32 ids), the
guards' select demotion and tile sizes, the XLA expanded-distance select
and the "slab"/"invert_late" output moves. The TPU select's VMEM and
compile-time model survives only as the engine choice
(``list_engine_ok``), so that both packages pick the same algorithm.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from pct_tpu_torch.neighbors.grid import MAXDIM, PAD_ID, GridIndex
from pct_tpu_torch.neighbors.knn import NeighborResult
from pct_tpu_torch.ops.moments import knn_moments
from pct_tpu_torch.ops.select import knn_select, knn_select_coords, knn_select_rows

_I32 = torch.int32


class CellTable(NamedTuple):
    """Compaction of occupied cells (statically sized at max_cells)."""
    cell_id: torch.Tensor     # (MC,) linearized id, PAD_ID beyond num_cells
    start: torch.Tensor       # (MC,) first sorted row of the cell
    count: torch.Tensor       # (MC,) points in the cell
    num_cells: torch.Tensor   # () int32
    overflow: torch.Tensor    # () bool — more occupied cells than MC
    max_count: torch.Tensor   # () int32 — fullest cell


def _scatter_drop(size: int, fill, idx: torch.Tensor, vals: torch.Tensor):
    """``full(size, fill).at[idx].set(vals, mode="drop")`` for indices in
    [0, size]: index ``size`` is a scratch slot that is cut off, so the
    only duplicate indices land there and the result is deterministic."""
    out = torch.full((size + 1,) + vals.shape[1:], fill, dtype=vals.dtype,
                     device=vals.device)
    out[idx.long()] = vals
    return out[:size]


def compact_cells(grid: GridIndex, max_cells: int) -> CellTable:
    ids = grid.sorted_ids
    n = ids.shape[0]
    dev = ids.device
    prev = torch.cat([ids.new_full((1,), -1), ids[:-1]])
    is_first = (ids != prev) & (ids != PAD_ID)
    rank = torch.cumsum(is_first.to(_I32), 0, dtype=_I32) - 1
    num_valid = torch.sum(ids != PAD_ID, dtype=_I32)
    num_cells = torch.where(num_valid > 0, rank[n - 1] + 1, 0).to(_I32)
    # rank may exceed MC on pathological clouds -> drop + flag
    slot = torch.where(is_first, torch.clamp_max(rank, max_cells), max_cells)
    start = _scatter_drop(max_cells, n, slot,
                          torch.arange(n, dtype=_I32, device=dev))
    cell_id = _scatter_drop(max_cells, PAD_ID, slot, ids)
    nxt = torch.cat([start[1:], start.new_full((1,), n)])
    c = torch.arange(max_cells, dtype=_I32, device=dev)
    end = torch.where(c + 1 < num_cells, nxt, num_valid)
    count = torch.where(c < num_cells, end - start, 0).to(_I32)
    return CellTable(cell_id, start, count, num_cells,
                     torch.any(rank > max_cells - 1), torch.max(count))


def split_cells(cells: CellTable, n: int, cap: int, factor: int) -> CellTable:
    """Virtual-split cells with count > ``cap`` into <= ``factor`` table
    rows of <= ``cap`` queries each (same cell_id, start offset by
    j·cap), so no bucket's capacity has to exceed ``cap``.

    A cell's queries need not share a kernel row, only its candidate
    runs do, and those are duplicated per virtual row. Consumers are
    row-wise: ``_runs_table`` resolves duplicate ids to the first copy,
    whose ``start`` is the cell's true run boundary; per-query outputs
    move by ``qrow``, disjoint across the virtual rows; the coverage
    certificate depends only on the (unchanged) cell coords. ``factor``
    must be >= ceil(max_count / cap): ``probe_grid_buckets(split_to=cap)``
    returns it.
    """
    dev = cells.cell_id.device
    j = torch.arange(factor, dtype=_I32, device=dev)
    cid = torch.repeat_interleave(cells.cell_id, factor)   # copies adjacent
    start = (cells.start[:, None] + j[None, :] * cap).reshape(-1)
    count = torch.clamp(cells.count[:, None] - j[None, :] * cap, 0, cap
                        ).reshape(-1).to(_I32)
    valid = (cid != PAD_ID) & (count > 0)
    out_mc = cells.cell_id.shape[0] * factor
    rank = torch.cumsum(valid.to(_I32), 0, dtype=_I32) - 1
    slot = torch.where(valid, rank, out_mc)
    return CellTable(_scatter_drop(out_mc, PAD_ID, slot, cid),
                     _scatter_drop(out_mc, n, slot, start),
                     _scatter_drop(out_mc, 0, slot, count),
                     torch.sum(valid, dtype=_I32), cells.overflow,
                     torch.max(count))


def _decode(cell_id: torch.Tensor):
    ix = cell_id % MAXDIM
    iy = (cell_id // MAXDIM) % MAXDIM
    iz = cell_id // (MAXDIM * MAXDIM)
    return ix, iy, iz


def _budget_overflow(run_len: torch.Tensor, cand_cap: int) -> torch.Tensor:
    """(...,) bool: the cell's total candidate count exceeds the budget
    (trailing candidates are then dropped — certificate void)."""
    return torch.sum(run_len, dim=-1) > cand_cap


def _clip_runs(run_len: torch.Tensor, cand_cap: int) -> torch.Tensor:
    """Clip the 9 run lengths so their TOTAL fits the budget: run i keeps
    min(len_i, max(0, cand_cap - Σ_{j<i} len_j)). Greedy front-to-back."""
    excl = torch.cumsum(run_len, -1, dtype=_I32) - run_len
    return torch.minimum(torch.clamp_min(cand_cap - excl, 0), run_len)


def _run_layout(run_len: torch.Tensor):
    """Contiguous layout of the 9 candidate runs along the M axis (one
    point per slot): (Px (..., 10) exclusive prefix of run lengths,
    tot (...,) total length)."""
    incl = torch.cumsum(run_len, -1, dtype=_I32)
    Px = torch.cat([torch.zeros_like(incl[..., :1]), incl], dim=-1)
    return Px, incl[..., -1]


DENSE_CELLS = 1 << 23    # dense boundary-map budget (32 MB int32): grids
# whose bbox holds more cell boxes take the sorted search


def _runs_table(grid: GridIndex, cells: CellTable):
    """Candidate-run table for every cell of the table.

    A run boundary is the start row of the first OCCUPIED cell at/past a
    wanted id. When the grid's cell-box count fits the dense table this
    is a direct lookup: scatter each occupied cell's start row into a
    table over compressed keys x + dims0·(y + dims1·z) (start rows are
    monotone in key), reverse-cummin to fill empty boxes with the next
    occupied cell's start, then gather every boundary. Larger grids take
    a searchsorted over the compact table. Boundaries clamp to num_valid
    so runs never reach into the padding rows.

    Returns (rs (MC,9) int32 run starts, run_len (MC,9) int32 UNCLIPPED).
    """
    n = grid.sorted_points.shape[0]
    dev = grid.sorted_points.device
    cid = cells.cell_id
    d0, d1, d2 = grid.dims
    nv = grid.num_valid
    pad = cid == PAD_ID
    ix_a, iy_a, iz_a = _decode(torch.where(pad, 0, cid))
    dyz = torch.tensor([(dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)],
                       dtype=_I32, device=dev)                 # (9, 2)
    ny_a = iy_a[:, None] + dyz[None, :, 0]
    nz_a = iz_a[:, None] + dyz[None, :, 1]
    ok_run_a = ((ny_a >= 0) & (ny_a < d1) & (nz_a >= 0) & (nz_a < d2)
                & ~pad[:, None])
    x_lo = torch.clamp_min(ix_a - 1, 0)[:, None]
    x_hi = torch.clamp_max(ix_a + 1, d0 - 1)[:, None]
    total = d0 * d1 * d2
    # static table size: grids with more boxes than ~4·n are so sparse
    # the sorted search loses nothing (n is the padded cloud size)
    dense_cap = min(DENSE_CELLS, 1 << (4 * n - 1).bit_length())

    if total <= dense_cap:
        ckey = ix_a + d0 * (iy_a + d1 * iz_a)
        # scatter-MIN: split_cells leaves duplicate cell ids (virtual
        # copies, start offset by j·cap) and the run boundary is the
        # first copy's start; the sorted search gets that from side=left
        table = torch.full((dense_cap + 1,), nv, dtype=_I32, device=dev)
        table.scatter_reduce_(0, torch.where(pad, dense_cap, ckey).long(),
                              cells.start, reduce="amin")
        table = table[:dense_cap]
        # start rows are monotone in key -> suffix-min = "start of the
        # first occupied cell at-or-after this box"
        table = torch.flip(torch.cummin(torch.flip(table, [0]), 0).values, [0])
        row = d0 * (ny_a + d1 * nz_a)                          # (MC, 9)
        q_lo = row + x_lo
        q_hi1 = row + x_hi + 1
        rs = table[torch.clamp(q_lo, 0, dense_cap - 1).long()]
        re = table[torch.clamp(q_hi1, 0, dense_cap - 1).long()]
        # a query one past the LAST box clamps onto an occupied slot: its
        # true boundary is the end of the valid rows
        re = torch.where(q_hi1 >= total, nv, re)
        rs = torch.where(ok_run_a, rs, 0)
        re = torch.where(ok_run_a, re, 0)
    else:
        base_a = ny_a * MAXDIM + nz_a * MAXDIM * MAXDIM        # (MC, 9)
        start_ext = torch.cat([torch.where(pad, nv, cells.start),
                               cells.start.new_full((1,), nv)])
        c_lo = torch.searchsorted(cid, (base_a + x_lo).contiguous())
        c_hi = torch.searchsorted(cid, (base_a + x_hi + 1).contiguous())
        rs, re = start_ext[c_lo], start_ext[c_hi]
    run_len_a = torch.where(ok_run_a, re - rs, 0).to(_I32)
    return rs.to(_I32), run_len_a


def _tile_candidates(grid: GridIndex, args, capacity: int, cand_cap: int):
    """Candidate fetch + coverage radius for a batch of T cells.

    ``args`` = (cell_id, start, count, rs, run_len, run_overflow), each
    with a leading cell axis T. The 9 runs are laid out contiguously
    along the M = cand_cap axis, runs in offset order and rows ascending
    within a run, so winner sets and first-argmin tie order match the
    JAX package. Cells whose runs exceed the budget drop trailing
    candidates (the caller flags them with ``_budget_overflow``).

    Returns (cand (T,M) sorted rows, ok_cand (T,M) bool, cpts (T,M,3),
    qpts (T,C,3), qrow (T,C), ok_q (T,C), cover (T,C) guaranteed
    coverage radius, run_overflow (T,)).
    """
    n = grid.sorted_points.shape[0]
    dev = grid.sorted_points.device
    cell_id, start, count, rs, run_len, run_overflow = args
    T = cell_id.shape[0]
    ix, iy, iz = _decode(torch.where(cell_id == PAD_ID, 0, cell_id))
    ar_c = torch.arange(capacity, dtype=_I32, device=dev)
    qrow = torch.clamp_max(start[:, None] + ar_c, n - 1)
    ok_q = ar_c[None, :] < count[:, None]

    run_len = _clip_runs(run_len, cand_cap)
    Px, tot = _run_layout(run_len)                             # (T,10),(T,)
    j = torch.arange(cand_cap, dtype=_I32, device=dev).expand(T, cand_cap)
    # run of each slot: number of runs whose end is <= j (9 = past the end)
    rj = torch.searchsorted(Px[:, 1:10].contiguous(), j.contiguous(),
                            right=True)
    inside = rj < 9
    rj_c = torch.clamp_max(rj, 8)
    g0j = torch.where(inside, torch.gather(rs, 1, rj_c), 0)
    pj = torch.where(inside, torch.gather(Px[:, :9], 1, rj_c), 0)
    ok_cand = j < tot[:, None]
    cand = torch.clamp(g0j + (j - pj), 0, n - 1).to(_I32)     # (T, M) rows
    cpts = grid.sorted_points[cand.long()]                    # (T, M, 3)
    qpts = grid.sorted_points[qrow.long()]                    # (T, C, 3)

    # --- per-query coverage radius within the 3³ window ---
    coords = torch.stack([ix, iy, iz], dim=-1)                # (T, 3)
    dims = torch.tensor(grid.dims, dtype=_I32, device=dev)
    lo_edge = grid.origin[None, :] + (coords - 1).float() * grid.cell_size
    hi_edge = grid.origin[None, :] + (coords + 2).float() * grid.cell_size
    left = torch.where((coords - 1 <= 0)[:, None, :], torch.inf,
                       qpts - lo_edge[:, None, :])
    right = torch.where((coords + 1 >= dims - 1)[:, None, :], torch.inf,
                        hi_edge[:, None, :] - qpts)
    cover = torch.minimum(left.min(dim=-1).values, right.min(dim=-1).values)
    return cand, ok_cand, cpts, qpts, qrow, ok_q, cover, run_overflow


def _select_operands(grid: GridIndex, args, capacity: int, cand_cap: int,
                     with_ids: bool = False):
    """The select kernels' operands for a batch of T cells.

    Returns ((qpts, cpts, cand, qrow, valid int32), ok_q, cover,
    run_overflow), see ``_tile_candidates``. ``with_ids``: ``cand`` and
    ``qrow`` carry ORIGINAL point ids (an int32 gather ``grid.order[rows]``)
    instead of sorted rows, so the rows select emits original ids;
    self-exclusion is unchanged, since ids are unique. The JAX package
    carries the ids through a float32 channel of its packed candidate
    fetch, exact below 2^24 points; int32 has no such limit and gives the
    same ids.
    """
    cand, ok_cand, cpts, qpts, qrow, ok_q, cover, run_overflow = \
        _tile_candidates(grid, args, capacity, cand_cap)
    if with_ids:
        cand = grid.order[cand.long()]
        qrow = grid.order[qrow.long()]
    return ((qpts, cpts, cand, qrow, ok_cand.to(_I32)), ok_q, cover,
            run_overflow)


_SELECTS = {"coords": knn_select_coords, "rows": knn_select_rows,
            "pos": knn_select}


def _tile_select(grid: GridIndex, args, k: int, capacity: int, cand_cap: int,
                 want: str = "coords", with_ids: bool = False):
    """Candidate fetch + k-selection for a batch of cells, in one kernel
    launch. ``want`` picks what the select emits beside the distances:

    - "coords": (T,C,k,3) winner coordinates (== cpts[pos]), so no
      (T,C,k) winner gather happens;
    - "rows":   (T,C,k) winner ids (== cand[pos]): sorted rows, or
      original point ids with ``with_ids``;
    - "pos":    (T,C,k) winner positions in the M candidate axis.

    Returns (win, dists (T,C,k) ascending, found (T,C,k), qpts (T,C,3),
    qrow (T,C) as given to the select, ok_q (T,C), exact (T,C)
    certificate).
    """
    ops, ok_q, cover, run_overflow = _select_operands(
        grid, args, capacity, cand_cap, with_ids)
    dists, win = _SELECTS[want](*ops, k)
    found = dists < 1e18     # the select backs missing slots with ~3e38
    exact = (found[..., k - 1] & (dists[..., k - 1] <= cover)
             & ~run_overflow[:, None])
    return win, dists, found, ops[0], ops[3], ok_q, exact


_FIT_QUERIES = 1 << 17   # query slots per chunk of the in-loop fn


def cellwise_tile_runner(grid: GridIndex, k: int, capacity: int,
                         cand_cap: int, fn: Callable):
    """Body of the fused cell loop for one bucket.

    Returns ``run(args) -> (fn outputs, each (T,C,...), exact (T,C),
    kth (T,C), qrow (T,C), ok_q (T,C))``: one select over all T cells,
    then ``fn(centered (t,C,k,3), found (t,C,k))`` in chunks of cells to
    bound the fit's working memory.
    """
    def run(args):
        nbrs, dists, found, qpts, qrow, ok_q, exact = _tile_select(
            grid, args, k, capacity, cand_cap)
        step = max(1, _FIT_QUERIES // capacity)
        parts = []
        for s in range(0, nbrs.shape[0], step):
            centered = nbrs[s:s + step] - qpts[s:s + step, :, None, :]
            parts.append(fn(centered, found[s:s + step]))
        out = tuple(torch.cat(xs) for xs in zip(*parts))
        return out, exact & ok_q, dists[..., k - 1], qrow, ok_q

    return run


def moments_tile_runner(grid: GridIndex, k: int, capacity: int,
                        cand_cap: int, fn: Callable | None = None):
    """Body of the cell loop for one bucket on the moments engine.

    Same contract as ``cellwise_tile_runner``, but the neighborhoods are
    never materialized: one ``knn_moments`` call over all T cells
    reduces each query's k nearest to its (T,C,48) moment stats, which
    are the runner's only output (the caller's ``post_fn`` turns them
    into curvature). ``fn`` is ignored: the moment form exists for the
    explicit method only. exact = found & (σ ≤ cover) & no run overflow
    & a real query slot; the kth distance is σ.
    """
    del fn

    def run(args):
        cand, ok_cand, cpts, qpts, qrow, ok_q, cover, run_overflow = \
            _tile_candidates(grid, args, capacity, cand_cap)
        stats = knn_moments(qpts, cpts, cand, qrow, ok_cand.to(_I32), k)
        sigma = stats[..., 38]
        exact = ((stats[..., 45] > 0.0) & (sigma <= cover)
                 & ~run_overflow[:, None] & ok_q)
        return (stats,), exact, sigma, qrow, ok_q

    return run


def _scatter_outputs(n: int, dest: torch.Tensor, out, exact: torch.Tensor,
                     kth: torch.Tensor):
    """Move every per-query output to its (n,) destination in one pass.

    All outputs (float32) plus ``exact`` (as a 0/1 column) and ``kth``
    pack into one (rows, D) slab; a 1-column scatter inverts the row
    permutation and ONE row gather moves the slab to destination order
    (the JAX package's "invert" strategy). Uncovered destinations are
    zero; rows with dest == n are dropped.
    """
    rows = exact.shape[0]
    cols = [exact.to(torch.float32)[:, None], kth[:, None]]
    cols += [a.reshape(rows, -1) for a in out]
    slab = torch.cat(cols, dim=1)
    ridx = _scatter_drop(n, 0, dest,
                         torch.arange(1, rows + 1, dtype=_I32,
                                      device=dest.device))
    src = torch.where(ridx > 0, ridx - 1, rows).long()
    slab = torch.cat([slab, slab.new_zeros((1, slab.shape[1]))])
    slab_n = slab[src]
    res, c = [], 2
    for a in out:
        w = math.prod(a.shape[1:])
        res.append(slab_n[:, c:c + w].reshape((n,) + a.shape[1:]))
        c += w
    return tuple(res), slab_n[:, 0] > 0.5, slab_n[:, 1]


class BucketSpec(NamedTuple):
    """Static shape class for one occupancy bucket of the cell loop.

    Cells are partitioned by ``key = max(count, ceil(total_run/27))``,
    the per-cell size class that correlates both padding axes (query
    slots and candidate width).
    """
    hi_key: int      # bucket takes cells with key in (prev.hi_key, hi_key]
    capacity: int    # query slots (>= max count among members)
    cand_cap: int    # candidate budget (>= max summed-9-run length)
    max_cells: int   # member-table size


def _bucket_tables(grid: GridIndex, cells: CellTable, spec):
    """Partition of the cell table (+ runs) by size class. The last
    bucket also absorbs any key above its threshold. Returns per bucket
    (args, slot): args = (cell_id, start, count, rs, run_len,
    run_overflow) with ``max_cells`` rows each (empty slots are PAD
    cells; run_overflow also flags a bucket whose table lost cells), and
    slot (MC,), each cell's row in the bucket's table, ``max_cells``
    where the cell is not in it."""
    n = grid.sorted_points.shape[0]
    rs_a, run_len_a = _runs_table(grid, cells)
    tot = torch.sum(run_len_a, dim=1, dtype=_I32)
    key = torch.maximum(cells.count, (tot + 26) // 27)
    valid = cells.cell_id != PAD_ID
    tables = []
    lo = 0
    for b, sp in enumerate(spec):
        member = valid & (key > lo)
        if b < len(spec) - 1:
            member = member & (key <= sp.hi_key)
        rank = torch.cumsum(member.to(_I32), 0, dtype=_I32) - 1
        slot = torch.where(member, torch.clamp_max(rank, sp.max_cells),
                           sp.max_cells)
        mcb = sp.max_cells
        run_len_b = _scatter_drop(mcb, 0, slot, run_len_a)
        lost = torch.any(member & (rank >= mcb))
        tables.append(((
            _scatter_drop(mcb, PAD_ID, slot, cells.cell_id),
            _scatter_drop(mcb, n, slot, cells.start),
            _scatter_drop(mcb, 0, slot, cells.count),
            _scatter_drop(mcb, 0, slot, rs_a),
            run_len_b,
            _budget_overflow(run_len_b, sp.cand_cap) | lost,
        ), slot))
        lo = sp.hi_key
    return tables


def bucketed_tile_args(grid: GridIndex, cells: CellTable, spec):
    """Per-bucket cell arguments: a list of (BucketSpec, args) with args
    = (cell_id, start, count, rs, run_len, run_overflow), one row per
    member-table slot (empty slots are PAD cells)."""
    return [(sp, args) for sp, (args, _) in zip(
        spec, _bucket_tables(grid, cells, spec))]


def apply_cellwise_bucketed(grid: GridIndex, cells: CellTable, k: int,
                            fn: Callable | None, spec, runner=None,
                            post_fn: Callable | None = None):
    """Run the cell loop over every point's kNN neighborhood, bucket by
    bucket.

    ``runner`` (default ``cellwise_tile_runner``, the list engine) builds
    each bucket's body from (grid, k, capacity, cand_cap, fn). With the
    list engine, ``fn(centered (T,C,k,3), found (T,C,k)) -> tuple of
    float32 (T,C,...)`` sees neighborhoods taken straight from the
    select's winner coordinates; ``moments_tile_runner`` ignores ``fn``.
    ``post_fn`` maps the concatenated flat outputs, in tile order,
    row for row to the outputs that are moved (the moments engine's
    stats → curvature), BEFORE the one invert-and-gather move to the
    caller's original point order. Padding slots and uncovered rows
    stay zero. Each bucket makes one kernel call over all of its cells.

    Returns (outputs tuple of (n, ...), exact (n,), kth_dist (n,)).
    """
    if runner is None:
        runner = cellwise_tile_runner
    n = grid.sorted_points.shape[0]
    outs, exacts, kths, dests = [], [], [], []
    for sp, args in bucketed_tile_args(grid, cells, spec):
        run = runner(grid, k, sp.capacity, sp.cand_cap, fn)
        out, exact, kth, qrow, ok_q = run(args)
        dest_rows = grid.order[qrow.reshape(-1).long()]
        dests.append(torch.where(ok_q.reshape(-1), dest_rows, n))
        outs.append(tuple(a.reshape((-1,) + a.shape[2:]) for a in out))
        exacts.append(exact.reshape(-1))
        kths.append(kth.reshape(-1))
    out = tuple(torch.cat(xs) for xs in zip(*outs))
    if post_fn is not None:
        out = post_fn(out)
    exact = torch.cat(exacts) & ~cells.overflow
    return _scatter_outputs(n, torch.cat(dests), out, exact, torch.cat(kths))


_TILE_CELLS = 128                # cell-table rounding
_MAX_BUCKETS = 6                 # occupancy buckets per cloud
_SIZE_UNIT = 4 * _TILE_CELLS     # member-table rounding per bucket


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def default_max_cells(n: int, k: int) -> int:
    """Static occupied-cell budget: expected cells ≈ n/(1.9k) for
    auto-sized grids; 4× headroom, rounded to the tile size."""
    mc = min(n, max(_TILE_CELLS, (4 * n) // max(int(1.9 * k), 1)))
    return _round_up(mc, _TILE_CELLS)


def _probe_totrun(grid: GridIndex, cells: CellTable) -> torch.Tensor:
    """(MC,) per-cell TOTAL candidate count: the summed 3-cell x-run
    length over the 9 (dy,dz) offsets."""
    _, run_len_a = _runs_table(grid, cells)
    return torch.sum(run_len_a, dim=1, dtype=_I32)


def _optimal_buckets(key_s, counts_s, tot_s, capacity_cap: int,
                     max_buckets: int, unit: int):
    """Exact min-cost partition of key-SORTED cells into <= max_buckets
    contiguous buckets; each bucket pays unit-rounded cells · capacity ·
    (cand_cap + 32), with capacity and cand_cap the 8-rounded maxima of
    its members' count and total run length. DP over the 8-aligned key
    thresholds (host numpy). Returns a non-empty tuple of BucketSpec."""
    num_cells = len(key_s)

    def r8(x):
        return np.maximum(8, ((np.asarray(x, np.int64) + 7) // 8) * 8)

    kmax = int(key_s[-1])
    bounds = sorted(
        {int(np.searchsorted(key_s, c, side="right"))
         for c in range(8, int(r8(kmax)) + 1, 8) if c < kmax}
        | {0, num_cells})
    B = np.asarray(bounds, dtype=np.int64)
    nb = len(B)
    seg_c = np.asarray([counts_s[B[j]:B[j + 1]].max(initial=0)
                        for j in range(nb - 1)], dtype=np.int64)
    seg_r = np.asarray([tot_s[B[j]:B[j + 1]].max(initial=0)
                        for j in range(nb - 1)], dtype=np.int64)
    cost = [None] * nb
    for i in range(1, nb):
        cmax = np.maximum.accumulate(seg_c[:i][::-1])[::-1]
        rmax = np.maximum.accumulate(seg_r[:i][::-1])[::-1]
        cap = np.minimum(r8(cmax), capacity_cap)
        rc = r8(rmax)
        size = ((B[i] - B[:i] + unit - 1) // unit) * unit
        cost[i] = size.astype(np.float64) * cap * (rc + 32.0)
    dp = np.full(nb, np.inf)
    dp[0] = 0.0
    # parent[b, i]: j of the bucket [B[j], B[i]) added at level b, or -1
    # when level b keeps the (b-1)-bucket solution for i
    parent = np.full((max_buckets, nb), -1, dtype=np.int64)
    for b in range(max_buckets):
        ndp = dp.copy()
        for i in range(1, nb):
            tot = dp[:i] + cost[i]
            j = int(np.argmin(tot))
            if tot[j] < ndp[i]:
                ndp[i] = tot[j]
                parent[b, i] = j
        dp = ndp
    out, b, i = [], max_buckets - 1, nb - 1
    while i > 0:
        j = parent[b, i]
        if j < 0:
            b -= 1
            continue
        out.append(BucketSpec(
            hi_key=int(key_s[B[i] - 1]),
            capacity=int(min(r8(counts_s[B[j]:B[i]].max()), capacity_cap)),
            cand_cap=int(r8(tot_s[B[j]:B[i]].max())),
            max_cells=int((((B[i] - B[j]) + unit - 1) // unit) * unit)))
        b, i = b - 1, int(j)
    return tuple(reversed(out))


def probe_grid_buckets(grid: GridIndex, capacity_cap: int = 256,
                       split_to: int | None = None):
    """Host-side bucket tuning: one compaction + runs probe + one sync.

    Partitions occupied cells by size class key = max(count,
    ceil(total_run/27)) into <= 6 buckets, choosing the 8-aligned
    thresholds that minimize Σ_b cells_b · capacity_b · (cand_cap_b +
    32). Member tables round to 512 cells. Returns (spec, max_cells_total) for
    ``apply_cellwise_bucketed`` / ``compact_cells``.

    ``split_to``: model the cells as virtually split to <= split_to
    queries a row (``split_cells``) and return (spec, max_cells_total,
    factor) instead; no bucket's capacity then exceeds ``split_to``.
    Pass the factor to ``split_cells`` (1 = no split needed).
    max_cells_total sizes the UNSPLIT table of ``compact_cells``.
    """
    n = grid.sorted_points.shape[0]
    probe = compact_cells(grid, n)
    num_cells = int(probe.num_cells)
    counts = probe.count[:num_cells].cpu().numpy()
    tot = _probe_totrun(grid, probe)[:num_cells].cpu().numpy()
    factor = 1
    num_cells_unsplit = num_cells
    if split_to is not None and num_cells and counts.max() > split_to:
        factor = -(-int(counts.max()) // split_to)
        reps = -(-counts // split_to)
        idx = np.repeat(np.arange(num_cells), reps)
        within = np.arange(len(idx)) - np.repeat(np.cumsum(reps) - reps, reps)
        counts = np.minimum(counts[idx] - within * split_to, split_to)
        tot = tot[idx]        # virtual copies keep the full candidate set
        num_cells = len(idx)
    key = np.maximum(counts, (tot + 26) // 27)

    spec = (BucketSpec(hi_key=8, capacity=8, cand_cap=216,
                       max_cells=_SIZE_UNIT),)
    if num_cells:
        order = np.argsort(key, kind="stable")
        spec = _optimal_buckets(key[order], counts[order], tot[order],
                                capacity_cap, _MAX_BUCKETS, _SIZE_UNIT)
    mc = _round_up(max(num_cells_unsplit, _TILE_CELLS), _TILE_CELLS)
    mc = min(1 << (mc - 1).bit_length(), _round_up(n, _TILE_CELLS))
    if split_to is not None:
        return spec, mc, factor
    return spec, mc


def probe_grid(grid: GridIndex, capacity_cap: int = 256):
    """Host-side tuning of the one-bucket layout: one compaction + one
    sync. Returns (cell table of the occupied cells, capacity covering
    the fullest cell (capped: overfull cells lose their certificate),
    max_cells rounded to a power of two, cand_cap = the largest total
    9-run candidate count, 8-rounded)."""
    n = grid.sorted_points.shape[0]
    probe = compact_cells(grid, n)
    num_cells = int(probe.num_cells)
    capacity = min(_round_up(max(int(probe.max_count), 4), 8), capacity_cap)
    mc = _round_up(max(num_cells, _TILE_CELLS), _TILE_CELLS)
    mc = min(1 << (mc - 1).bit_length(), _round_up(n, _TILE_CELLS))
    cells = CellTable(probe.cell_id[:mc], probe.start[:mc], probe.count[:mc],
                      probe.num_cells, probe.num_cells > mc, probe.max_count)
    cand_cap = int(_probe_totrun(grid, cells).max())
    cand_cap = min(_round_up(max(cand_cap, 4), 8), 27 * capacity)
    return cells, capacity, mc, cand_cap


def knn_cellwise_bucketed(grid: GridIndex, cells: CellTable, k: int, spec,
                          original_ids: bool = True,
                          lean: bool = False) -> NeighborResult:
    """Self-excluded kNN for every point over occupancy-bucketed cells,
    rows in SORTED order (row r's query is grid.sorted_points[r]).

    Each bucket makes one rows-select launch over all of its cells with
    its own (capacity, cand_cap). ``indices`` are original point ids
    when ``original_ids`` (carried through the select, see
    ``_select_operands``), else sorted rows. The per-cell results move to
    sorted-row order with a GATHER: row r lives in cell rank b_r at slot
    r − start[b_r], i.e. at its bucket's offset + member slot · capacity
    + slot. Uncovered rows (padding, cells past a bucket's table or
    capacity) get index 0, distance 0, valid False and exact False.
    ``lean`` returns only the kth distance, as ``dists`` of shape (n, 1),
    and ``valid`` None.
    """
    n = grid.sorted_points.shape[0]
    dev = grid.sorted_points.device
    mc_total = cells.cell_id.shape[0]
    cell_base = torch.zeros((mc_total,), dtype=torch.int64, device=dev)
    cell_cap = torch.zeros((mc_total,), dtype=_I32, device=dev)
    cell_in = torch.zeros((mc_total,), dtype=torch.bool, device=dev)
    idxs, dsts, exacts = [], [], []
    off = 0
    for sp, (args, slot) in zip(spec, _bucket_tables(grid, cells, spec)):
        rows, dists, _, _, _, ok_q, exact = _tile_select(
            grid, args, k, sp.capacity, sp.cand_cap, want="rows",
            with_ids=original_ids)
        idxs.append(rows.reshape(-1, k))
        dsts.append(dists.reshape(-1, k))
        exacts.append((exact & ok_q).reshape(-1))
        inside = slot < sp.max_cells
        cell_base = torch.where(inside, off + slot.long() * sp.capacity,
                                cell_base)
        cell_cap = torch.where(inside, sp.capacity, cell_cap)
        cell_in = cell_in | inside
        off += sp.max_cells * sp.capacity

    ids = grid.sorted_ids
    prev = torch.cat([ids.new_full((1,), -1), ids[:-1]])
    is_first = (ids != prev) & (ids != PAD_ID)
    rank = torch.cumsum(is_first.to(_I32), 0, dtype=_I32) - 1
    rank_c = torch.clamp(rank, 0, mc_total - 1).long()
    slot_r = torch.arange(n, dtype=_I32, device=dev) - cells.start[rank_c]
    covered = ((ids != PAD_ID) & (rank < mc_total) & cell_in[rank_c]
               & (slot_r >= 0) & (slot_r < cell_cap[rank_c]))
    src = torch.where(covered, cell_base[rank_c] + slot_r, 0)
    d_src = torch.cat(dsts)[src]
    out_idx = torch.where(covered[:, None], torch.cat(idxs)[src], 0)
    out_e = covered & torch.cat(exacts)[src] & ~cells.overflow
    if lean:
        kth = torch.where(covered, d_src[:, k - 1], 0.0)
        return NeighborResult(out_idx, kth[:, None], None, out_e)
    out_d = torch.where(covered[:, None], d_src, 0.0)
    out_f = covered[:, None] & (d_src < 1e18)
    return NeighborResult(out_idx, out_d, out_f, out_e)


def knn_cellwise(grid: GridIndex, cells: CellTable, k: int,
                 capacity: int = 64, cand_cap: int | None = None,
                 original_ids: bool = True,
                 lean: bool = False) -> NeighborResult:
    """``knn_cellwise_bucketed`` with one bucket that takes every cell of
    ``cells``: ``capacity`` query slots and ``cand_cap`` (default
    27·capacity, the full window at max occupancy) candidate slots a
    cell. The JAX package's un-bucketed loop computes the same winners
    and certificates."""
    spec = (BucketSpec(hi_key=1 << 30, capacity=capacity,
                       cand_cap=cand_cap or 27 * capacity,
                       max_cells=cells.cell_id.shape[0]),)
    return knn_cellwise_bucketed(grid, cells, k, spec, original_ids, lean)


def all_points_spec(n: int, k: int, capacity: int | None = None,
                    max_cells: int | None = None):
    """``knn_all_points``' layout for n grid rows: (spec, max_cells) of
    its one bucket, of conservative capacity (2.5k + 16, 8-rounded) and
    27·capacity candidate slots a cell."""
    if capacity is None:
        capacity = _round_up(int(2.5 * k) + 16, 8)
    if max_cells is None:
        max_cells = default_max_cells(n, k)
    return (BucketSpec(hi_key=1 << 30, capacity=capacity,
                       cand_cap=27 * capacity, max_cells=max_cells),), max_cells


def knn_all_points(grid: GridIndex, k: int, capacity: int | None = None,
                   max_cells: int | None = None) -> NeighborResult:
    """Cell-centric self-kNN for every point of the grid (sorted order),
    in the one bucket of ``all_points_spec``."""
    spec, mc = all_points_spec(grid.sorted_points.shape[0], k, capacity,
                               max_cells)
    return knn_cellwise_bucketed(grid, compact_cells(grid, mc), k, spec)


def knn_all_points_auto(grid: GridIndex, k: int) -> NeighborResult:
    """Self-kNN in one bucket with host-probed capacity and candidate
    budget (``probe_grid``)."""
    cells, capacity, _, cand_cap = probe_grid(grid)
    return knn_cellwise(grid, cells, k, capacity=capacity, cand_cap=cand_cap)


def knn_all_points_auto_bucketed(grid: GridIndex, k: int) -> NeighborResult:
    """Self-kNN with host-probed occupancy buckets
    (``probe_grid_buckets``): select padding tracks each cell's size."""
    spec, mc = probe_grid_buckets(grid)
    return knn_cellwise_bucketed(grid, compact_cells(grid, mc), k, spec)


# The TPU select's limits (pct_tpu.neighbors.cellknn): its Mosaic
# scoped-VMEM budget and the compile-time hazard class of the unrolled
# select at k >= 32.
_SELECT_VMEM_BYTES = (64 << 20) * 3 // 4
_SELECT_COMPILE_HAZARD = 48_000


def _select_scoped_bytes(block: int, c: int, m: int, k: int) -> int:
    """The JAX package's scoped-VMEM model of one TPU select program."""
    return (8 * block * c * m + 32 * block * m + 16 * block * c
            + 16 * block * c * k)


def list_engine_ok(capacity: int, cand_cap: int, k: int) -> bool:
    """Does ``fast_curvature`` run this bucket on the list engine?

    The JAX package's ``pallas_select_ok`` at pack=1: False when k >= 32
    and k·cand_cap > 48,000, or when the TPU select's scoped-VMEM model
    at 8 cells a block exceeds 48 MB. Its constants come from the TPU
    compiler's limits and mean nothing for the CUDA kernel; they are kept
    only so that both packages choose the same algorithm (the moments
    engine weights kth-distance ties fractionally and preconditions the
    fit with the RMS extent, so its K differs from the list engine's).
    """
    if k >= 32 and k * cand_cap > _SELECT_COMPILE_HAZARD:
        return False
    return _select_scoped_bytes(8, capacity, cand_cap, k) <= _SELECT_VMEM_BYTES
