"""Point-cloud data model: a padded, statically-sized cloud of tensors.

Port of ``pct_tpu.core.cloud``. A cloud is a (capacity, 3) float32
tensor padded to a capacity bucket plus the number of valid rows;
padding rows hold ``PAD_VALUE`` so they land in a far-away grid cell and
never pollute neighbor queries.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.utils import trace as _trace

PAD_VALUE = 1e9


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_capacity(n: int, multiple: int = 1024) -> int:
    """Static capacity bucket for n points (rounded up to ``multiple``)."""
    return max(multiple, round_up(n, multiple))


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Padded point cloud.

    points:     (capacity, 3) float32; rows >= num_points hold PAD_VALUE.
    num_points: number of valid rows.
    normals:    (capacity, 3) float32 or None.
    """

    points: torch.Tensor
    num_points: int
    normals: Optional[torch.Tensor] = None

    PAD_VALUE = PAD_VALUE  # class constant, not a field

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def mask(self) -> torch.Tensor:
        """(capacity,) bool validity mask."""
        return (torch.arange(self.capacity, device=self.points.device)
                < self.num_points)

    # ---- norms of the whole cloud (ref pointCloudToolbox.py:43-47) ----
    def norms(self) -> dict:
        """l1, l2 and linf norms of the flattened valid coordinates."""
        flat = torch.where(self.mask()[:, None], self.points, 0.0).reshape(-1)
        return {
            "l1": torch.sum(torch.abs(flat)),
            "l2": torch.sqrt(torch.sum(flat * flat)),
            "linf": torch.max(torch.abs(flat)),
        }

    def bounds(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(min_xyz, max_xyz) over valid points."""
        m = self.mask()[:, None]
        lo = torch.min(torch.where(m, self.points, torch.inf), dim=0).values
        hi = torch.max(torch.where(m, self.points, -torch.inf), dim=0).values
        return lo, hi

    def domains(self) -> dict:
        """x/y/z extents (ref pointCloudToolbox.py:64-66)."""
        lo, hi = self.bounds()
        return {"x": (lo[0], hi[0]), "y": (lo[1], hi[1]), "z": (lo[2], hi[2])}


@_trace.stage("load")
def from_numpy(
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    pad_multiple: int = 1024,
    device: str | torch.device = "cuda",
) -> PointCloud:
    """Host-side constructor: pad to a static capacity and move to ``device``."""
    dev = resolve_device(device)
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    cap = capacity if capacity is not None else pad_capacity(n, pad_multiple)
    if cap < n:
        raise ValueError(f"capacity {cap} < num points {n}")
    padded = np.full((cap, 3), PAD_VALUE, dtype=np.float32)
    padded[:n] = points
    nrm = None
    if normals is not None and np.asarray(normals).size:
        normals = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
        nrm_np = np.zeros((cap, 3), dtype=np.float32)
        nrm_np[:n] = normals
        nrm = torch.from_numpy(nrm_np).to(dev)
    return PointCloud(torch.from_numpy(padded).to(dev), n, nrm)


def to_numpy(cloud: PointCloud) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Device -> host, dropping padding."""
    n = cloud.num_points
    pts = cloud.points[:n].cpu().numpy()
    nrm = None if cloud.normals is None else cloud.normals[:n].cpu().numpy()
    return pts, nrm


class ReferenceState(NamedTuple):
    """What ``from_reference_arrays`` carries over from the JAX package."""
    cloud: PointCloud
    bucket_spec: tuple        # tuple of neighbors.cellknn.BucketSpec
    cell_size: torch.Tensor   # () float32 grid cell edge
    max_cells: int            # occupied-cell table size
    split_factor: int = 1     # virtual split factor of the spec (split_cells)


def from_reference_arrays(
    points: np.ndarray,
    num_points: int,
    *,
    cell_size: float | np.floating | None = None,
    bucket_spec=None,
    max_cells: int | None = None,
    split_factor: int = 1,
    k: int = 20,
    device: str | torch.device = "cuda",
) -> ReferenceState:
    """Adopt an already padded cloud and its static layout.

    ``points`` is a padded (capacity, 3) array such as
    ``np.asarray(pct_tpu_cloud.points)``; ``bucket_spec``, ``max_cells``
    and ``split_factor`` are the output of a ``probe_grid_buckets`` call,
    given as a sequence of 4-int tuples (hi_key, capacity, cand_cap,
    max_cells), an int and, for a probe with ``split_to``, its factor;
    ``cell_size`` is taken bit-for-bit as float32. Taking the cell size
    from the caller keeps a last-ulp difference in a float32 sum from
    moving points across a cell boundary. Whatever is None is computed
    here for ``k`` neighbors, in this order: cell size, then the layout
    ``fast_curvature`` runs (``pipeline.fused.plan_engine``: the bucket
    probe of its engine and, on the moments engine, the split factor).
    """
    from pct_tpu_torch.neighbors.cellknn import BucketSpec
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.pipeline.fused import plan_engine

    dev = resolve_device(device)
    pts = np.asarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (capacity, 3), got {pts.shape}")
    n = int(num_points)
    if not 0 <= n <= pts.shape[0]:
        raise ValueError(f"num_points {n} outside [0, {pts.shape[0]}]")
    cloud = PointCloud(torch.from_numpy(pts.copy()).to(dev), n)
    if cell_size is None:
        cell = estimate_cell_size(cloud.points, n, k)
    else:
        cell = torch.tensor(np.float32(cell_size), device=dev)
    if bucket_spec is None:
        _, spec, mc, split_factor = plan_engine(
            build_grid(cloud.points, n, cell), k)
        max_cells = mc if max_cells is None else max_cells
    else:
        spec = tuple(BucketSpec(*map(int, s)) for s in bucket_spec)
        if max_cells is None:
            raise ValueError("a bucket_spec needs the max_cells it was probed with")
    return ReferenceState(cloud, spec, cell, int(max_cells), int(split_factor))
