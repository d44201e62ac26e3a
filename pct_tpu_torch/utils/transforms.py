"""Geometry transforms (parity with ref pointCloudToolbox.py:123-157).

The port's own numpy copy of ``pct_tpu.utils.transforms``, unchanged.

``rotate_point_cloud``: center, rotate by three Euler matrices,
un-center. Two reference quirks, both reproduced exactly under
``compat_z_from_y=True`` and fixed by default:

- the reference builds its Z matrix from the Y angle (ref :149-153);
- the reference applies ROW-vector rotations
  ``centered.dot(Rx).dot(Ry).dot(Rz)`` (ref :156), i.e. each matrix
  acts transposed relative to the column-vector convention used here.

The reference's axis-swap + lexsort prologue (ref :126-129) is dead
code — its result is assigned to a local and discarded — so neither
mode performs it. Pass ``lexsort=True`` to opt into the swap+sort the
reference *appears* to have intended (documented divergence: it
reorders rows and permutes axes, and matches no reference output).
"""

from __future__ import annotations

import numpy as np


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def rotate_point_cloud(points: np.ndarray, angle_x: float, angle_y: float,
                       angle_z: float, compat_z_from_y: bool = False,
                       lexsort: bool = False) -> np.ndarray:
    """Center, apply Rx·Ry·Rz (column-vector convention), un-center.

    ``compat_z_from_y=True`` reproduces the reference bit-for-bit:
    row-vector products ``c @ Rx @ Ry @ Rz`` with Rz built from the Y
    angle (ref :149-156). ``lexsort=True`` additionally applies the
    reference's DEAD axis-swap + lexsort (ref :126-129) live — an
    intentional divergence, off by default.
    """
    pts = np.asarray(points, dtype=np.float64)
    if lexsort:
        pts = pts[:, [1, 2, 0]]                  # ref :126 column order
        pts = pts[np.lexsort((pts[:, 0], pts[:, 1]))]  # ref :128
    center = pts.mean(0)
    c = pts - center
    if compat_z_from_y:
        # ref :156 row-vector chain, Z matrix from the Y angle (ref bug)
        out = c @ _rx(angle_x) @ _ry(angle_y) @ _rz(angle_y)
    else:
        out = c @ (_rx(angle_x) @ _ry(angle_y) @ _rz(angle_z)).T
    return (out + center).astype(np.float32)
