"""The run table's suffix-min: t[i] = min(t[i], ..., t[-1]) over a 1-D
int32 table, in place.

``neighbors.cellknn._runs_table`` scatters each occupied cell's start row
into a dense table of grid boxes and takes this suffix-min, so that every
box holds the start row of the first occupied cell at or after it.

On CUDA tensors the hand-written kernel ``csrc/run_table.cu`` runs: two
launches, each tile's minimum (``pct_run_table_tile_min``), then the scan
of each tile with the minimum of the tiles after it
(``pct_run_table_suffix_min``), built with nvcc at first use. On CPU
tensors the plain version ``suffix_min_plain`` runs. min is exact, so the
two give the same bits.
"""

from __future__ import annotations

import torch

from pct_tpu_torch.ops import build

TILE = 4096         # boxes a block of the kernel (256 threads × 16)


def suffix_min_plain(table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a new tensor, the reverse inclusive
    cumulative minimum of ``table`` along dimension 0."""
    return torch.flip(torch.cummin(torch.flip(table, [0]), 0).values, [0])


def _check(table: torch.Tensor):
    if table.dtype != torch.int32:
        raise ValueError(f"table must be int32, got {table.dtype}")
    if table.dim() != 1:
        raise ValueError(f"table must be 1-D, got shape {tuple(table.shape)}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if table.numel() >= 2**31:
        raise ValueError(f"table of {table.numel()} boxes: the kernel takes "
                         "fewer than 2^31")


def suffix_min_(table: torch.Tensor) -> torch.Tensor:
    """``table`` (1-D, contiguous, int32) overwritten by its suffix-min;
    returns it. CUDA tensors launch ``csrc/run_table.cu`` twice; CPU
    tensors copy ``suffix_min_plain``'s result in."""
    _check(table)
    size = table.numel()
    if table.device.type == "cpu":
        return table.copy_(suffix_min_plain(table))
    if size > 0:
        mins = torch.empty(((size + TILE - 1) // TILE,), dtype=torch.int32,
                           device=table.device)
        build.kernel("run_table", "pct_run_table_tile_min")(table, mins, size)
        build.kernel("run_table", "pct_run_table_suffix_min")(table, mins,
                                                              size)
    return table
