"""Minimal legacy-VTK (ASCII) mesh writer/reader.

The port's own copy of ``pct_tpu.io.vtk`` (numpy only; the same
arrays write the same bytes).

Artifact parity with the reference's ``mesh_snaps/*.vtk`` snapshots
(ref utils.py:356-366, written through pyvista/VTK). Legacy VTK
POLYDATA with POINTS + POLYGONS + optional per-vertex scalars is a
20-line format; no VTK dependency needed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def write_vtk(path: str, points: np.ndarray,
              faces: Optional[np.ndarray] = None,
              point_scalars: Optional[Dict[str, np.ndarray]] = None):
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("pct_tpu mesh snapshot\nASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {len(pts)} float\n")
        np.savetxt(f, pts, fmt="%.8g")
        if faces is not None and len(faces):
            faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
            f.write(f"POLYGONS {len(faces)} {len(faces) * 4}\n")
            np.savetxt(f, np.hstack([np.full((len(faces), 1), 3, np.int64),
                                     faces]), fmt="%d")
        if point_scalars:
            f.write(f"POINT_DATA {len(pts)}\n")
            for name, vals in point_scalars.items():
                f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
                np.savetxt(f, np.asarray(vals, np.float32).reshape(-1, 1),
                           fmt="%.8g")


def read_vtk(path: str):
    """Returns (points (N,3), faces (T,3) or None, scalars dict)."""
    points = faces = None
    scalars: Dict[str, np.ndarray] = {}
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0
    while i < len(lines):
        tok = lines[i].split()
        if not tok:
            i += 1
            continue
        if tok[0] == "POINTS":
            n = int(tok[1])
            vals = []
            i += 1
            while len(vals) < 3 * n:
                vals.extend(float(x) for x in lines[i].split())
                i += 1
            points = np.asarray(vals, np.float32).reshape(n, 3)
            continue
        if tok[0] == "POLYGONS":
            t = int(tok[1])
            rows = []
            i += 1
            for _ in range(t):
                parts = [int(x) for x in lines[i].split()]
                rows.append(parts[1:1 + parts[0]])
                i += 1
            faces = np.asarray(rows, np.int32)
            continue
        if tok[0] == "SCALARS":
            name = tok[1]
            n = len(points) if points is not None else 0
            i += 2  # skip LOOKUP_TABLE
            vals = []
            while len(vals) < n:
                vals.extend(float(x) for x in lines[i].split())
                i += 1
            scalars[name] = np.asarray(vals, np.float32)
            continue
        i += 1
    return points, faces, scalars
