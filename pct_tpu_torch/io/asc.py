"""ASC scan-format ingest + dict-free voxel downsample on import.

The port's own copy of ``pct_tpu.io.asc`` (numpy only; the same
arrays write the same bytes).

Parity with ref convert_asc_to_ply.py: reads 6-column ``.asc`` keeping
xyz (ref convert_asc_to_ply.py:5-18) and voxel-downsamples keeping the
first point per voxel (ref :20-51). The downsample here is vectorized
numpy (np.unique on quantized cells) instead of a Python dict loop; the
keep-first-per-voxel semantics is preserved by stable first-occurrence
selection.
"""

from __future__ import annotations

import numpy as np


def read_asc(path: str) -> np.ndarray:
    data = np.loadtxt(path, dtype=np.float32)
    if data.ndim == 1:
        data = data.reshape(1, -1)
    return np.ascontiguousarray(data[:, :3], dtype=np.float32)


def voxel_downsample_first(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Keep the FIRST point of each occupied voxel (ref convert_asc_to_ply.py:20-51)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    cells = np.floor(pts / np.float32(voxel_size)).astype(np.int64)
    # lexicographic cell key; np.unique returns first occurrence with stable sort
    _, first_idx = np.unique(cells, axis=0, return_index=True)
    return pts[np.sort(first_idx)]


def convert_asc_to_ply(asc_path: str, ply_path: str, voxel_size: float | None = None):
    from pct_tpu_torch.io.ply import write_ply

    pts = read_asc(asc_path)
    if voxel_size is not None:
        pts = voxel_downsample_first(pts, voxel_size)
    write_ply(ply_path, pts)
    return pts.shape[0]
