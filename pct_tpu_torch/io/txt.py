"""Whitespace-text point-cloud reader/writer.

The port's own copy of ``pct_tpu.io.txt`` (numpy only; the same
arrays write the same bytes).

Parity with the reference's ``PointCloud.read_from_file``
(ref pointCloudToolbox.py:50-66): columns 0:3 are xyz, 3:6 (if present)
are normals, float32. The reference translates x and y by -max
(pointCloudToolbox.py:56-57); we keep that behind ``translate_xy_max``
(default True to match reference behavior) and document it as a quirk.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def read_txt(
    path: str, translate_xy_max: bool = True
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    data = np.loadtxt(path, dtype=np.float32)
    if data.ndim == 1:
        data = data.reshape(1, -1)
    points = np.ascontiguousarray(data[:, 0:3], dtype=np.float32)
    normals = None
    if data.shape[1] >= 6:
        normals = np.ascontiguousarray(data[:, 3:6], dtype=np.float32)
    if translate_xy_max:
        # ref pointCloudToolbox.py:56-57 — recenter so max x/y sit at 0
        points[:, 0] -= points[:, 0].max()
        points[:, 1] -= points[:, 1].max()
    return points, normals


def write_txt(path: str, points: np.ndarray, normals: Optional[np.ndarray] = None):
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    if normals is not None:
        arr = np.hstack([pts, np.asarray(normals, dtype=np.float32).reshape(-1, 3)])
    else:
        arr = pts
    np.savetxt(path, arr, fmt="%.8g")
