"""Voxel downsampling on the device, on the grid index.

Port of ``pct_tpu.mesh.downsample`` (the reference's Open3D
``voxel_down_sample`` and its commented-out keep-the-first-points grid
downsample). Two modes:

- "first": keep the first ``max_per_voxel`` points of each voxel in the
  original order;
- "centroid": one point a voxel, the mean of its points.
"""

from __future__ import annotations

import torch

from pct_tpu_torch.core.cloud import PAD_VALUE
from pct_tpu_torch.neighbors.grid import PAD_ID, build_grid


def voxel_downsample(points: torch.Tensor, num_points: int, voxel_size,
                     max_per_voxel: int = 1, mode: str = "first"):
    """Returns (points' (N,3), num_kept () int tensor): the kept rows
    compacted to the front in voxel order, the rest ``PAD_VALUE``; the
    output has the input's shape. Runs on the tensors' device."""
    if mode not in ("first", "centroid"):
        raise ValueError(f"unknown mode {mode!r}")
    n = points.shape[0]
    dev = points.device
    grid = build_grid(points, num_points,
                      torch.as_tensor(voxel_size, dtype=points.dtype,
                                      device=dev))
    ids = grid.sorted_ids
    prev = torch.cat([ids.new_full((1,), -1), ids[:-1]])
    is_first = (ids != prev) & (ids != PAD_ID)
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    # rank within the voxel = position − start of the voxel's run
    run_start = torch.clamp_min(torch.cummax(
        torch.where(is_first, ar, -1), dim=0).values, 0)
    rank = ar - run_start
    valid = ids != PAD_ID
    if mode == "first":
        # the stable sort kept the original order inside each voxel
        keep = (rank < max_per_voxel) & valid
        kept_sorted = torch.where(keep[:, None], grid.sorted_points,
                                  PAD_VALUE)
        order = torch.sort((~keep).to(torch.int32), stable=True).indices
        return kept_sorted[order], torch.sum(keep, dtype=torch.int32)
    # padding rows (sorted last) keep the last voxel's index, weight 0
    voxel_index = (torch.cumsum(is_first.to(torch.int32), 0,
                                dtype=torch.int32) - 1).long()
    num_kept = torch.where(torch.any(valid), voxel_index[-1] + 1, 0).to(
        torch.int32)
    voxel_index = voxel_index.clamp_min(0)     # -1 only when no row is valid
    w = valid.to(points.dtype)
    sums = torch.zeros((n, 3), dtype=points.dtype, device=dev)
    sums.index_add_(0, voxel_index, grid.sorted_points * w[:, None])
    cnts = torch.zeros((n,), dtype=points.dtype, device=dev)
    cnts.index_add_(0, voxel_index, w)
    out = torch.where((ar < num_kept)[:, None],
                      sums / torch.clamp_min(cnts, 1.0)[:, None], PAD_VALUE)
    return out, num_kept
