"""Uniform grid index for neighbor search.

Port of ``pct_tpu.neighbors.grid``: quantize points to grid cells,
linearize the cell coordinates with fixed per-axis multipliers
(``MAXDIM``), and sort the rows by cell id with ONE stable sort. Padding
rows get ``PAD_ID``, which sorts past every valid id. The stable order
is part of the contract: the select's first-argmin tie order depends on
it, so ``order``/``sorted_ids`` match the JAX package exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from pct_tpu_torch.neighbors.bruteforce import mean_nn_distance
from pct_tpu_torch.utils import trace as _trace

MAXDIM = 1024            # per-axis cells; ids fit int32 (1024^3 = 2^30)
PAD_ID = 1 << 30
_MULT = (1, MAXDIM, MAXDIM * MAXDIM)


@dataclasses.dataclass(frozen=True)
class GridIndex:
    """Sorted-by-cell point index.

    sorted_points: (N,3) points permuted by cell id
    order:         (N,)  int32 original index of each sorted row
    sorted_ids:    (N,)  int32 linearized cell id per sorted row (PAD_ID
                         for padding)
    origin:        (3,)  float32 grid origin (bbox min minus half a cell)
    cell_size:     ()    float32 cell edge length
    dims:          number of cells per axis (clipped to MAXDIM)
    num_valid:     valid point count
    """

    sorted_points: torch.Tensor
    order: torch.Tensor
    sorted_ids: torch.Tensor
    origin: torch.Tensor
    cell_size: torch.Tensor
    dims: tuple[int, int, int]
    num_valid: int


def cell_coords(pts: torch.Tensor, origin: torch.Tensor,
                cell_size: torch.Tensor, dims) -> torch.Tensor:
    """(..., 3) int32 cell coordinates, clipped into the grid; ``dims``
    a (3,) int tensor or a 3-tuple."""
    dims = torch.as_tensor(dims, dtype=torch.int32, device=pts.device)
    c = torch.floor((pts - origin) / cell_size).to(torch.int32)
    return torch.minimum(torch.clamp_min(c, 0), dims - 1)


def linearize(coords: torch.Tensor) -> torch.Tensor:
    return (coords[..., 0] * _MULT[0] + coords[..., 1] * _MULT[1]
            + coords[..., 2] * _MULT[2])


def neighbor_cell_ids(qcoords: torch.Tensor, dims, rings: int) -> torch.Tensor:
    """(..., (2r+1)³) int32 ids of the cells around each cell coordinate,
    offsets in the JAX package's order (x slowest, z fastest);
    out-of-grid cells -> PAD_ID."""
    dev = qcoords.device
    r = torch.arange(-rings, rings + 1, dtype=torch.int32, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(-1, 3)
    dims = torch.as_tensor(dims, dtype=torch.int32, device=dev)
    nc = qcoords[..., None, :] + offs
    ok = torch.all((nc >= 0) & (nc < dims), dim=-1)
    ids = linearize(torch.minimum(torch.clamp_min(nc, 0), dims - 1))
    return torch.where(ok, ids, PAD_ID).to(torch.int32)


def grid_geometry(lo: torch.Tensor, hi: torch.Tensor, cell_size: torch.Tensor):
    """(origin (3,), dims (3,) int32 tensor, clamped cell_size) from a
    bounding box, in the JAX package's float32 arithmetic order."""
    cell_size = torch.clamp_min(cell_size, 1e-12)
    origin = lo - 0.5 * cell_size
    dims = torch.clamp(
        torch.ceil((hi - origin) / cell_size).to(torch.int32) + 1, 1, MAXDIM)
    return origin, dims, cell_size


def quantize_ids(points: torch.Tensor, valid: torch.Tensor,
                 origin: torch.Tensor, cell_size: torch.Tensor,
                 dims: torch.Tensor) -> torch.Tensor:
    """(N,) int32 linearized cell id per row; PAD_ID where not ``valid``."""
    vpts = torch.where(valid[:, None], points, 0.0)
    c = cell_coords(vpts, origin, cell_size, dims)
    return torch.where(valid, linearize(c), PAD_ID).to(torch.int32)


@_trace.stage("grid")
def build_grid(points: torch.Tensor, num_points: int,
               cell_size: torch.Tensor) -> GridIndex:
    """Build the index: quantize -> linearize -> one stable sort."""
    n = points.shape[0]
    valid = torch.arange(n, device=points.device) < num_points
    if num_points > 0:
        lo = points[:num_points].min(dim=0).values
        hi = points[:num_points].max(dim=0).values
    else:
        lo = torch.full((3,), torch.inf, device=points.device)
        hi = -lo
    origin, dims, cell_size = grid_geometry(lo, hi, cell_size)
    ids = quantize_ids(points, valid, origin, cell_size, dims)
    sorted_ids, order = torch.sort(ids, stable=True)
    return GridIndex(
        sorted_points=points[order],
        order=order.to(torch.int32),
        sorted_ids=sorted_ids,
        origin=origin,
        cell_size=cell_size,
        dims=tuple(int(d) for d in dims.tolist()),
        num_valid=int(num_points),
    )


@_trace.stage("grid")
def estimate_cell_size(points: torch.Tensor, num_points: int, k: int,
                       sample: int = 512) -> torch.Tensor:
    """() float32 cell edge 1.35·d̄·√k, so that the k nearest neighbors of
    a surface-sampled point fall inside the 3×3×3 cell window (d̄ the
    sampled mean 1-NN spacing; see the JAX package for the derivation).

    On the same cloud this is not the JAX package's cell size bit for
    bit: d̄ comes from expanded-form distances whose matmul rounds
    differently in PyTorch and XLA, and the form cancels at 1-NN
    separations (``mean_nn_distance``). The gap stays below 1e-4
    relative (hundreds of ulps on a 200k torus, tens on a 100k sphere),
    but it is a different grid: buckets, which rows certify and the tie
    order of the selects can differ from the JAX package's, while the
    certified winner sets and the exact fraction agree (both held by
    tests/test_torch_grid.py). The formula is kept as the port's own;
    parity tests that need the JAX grid adopt its cell size
    (``core.cloud.from_reference_arrays``)."""
    dbar = mean_nn_distance(points, num_points, sample=sample, chunk=65536)
    return 1.35 * dbar * torch.sqrt(torch.tensor(float(k), device=dbar.device))
