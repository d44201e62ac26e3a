"""PLY reader/writer (ASCII + binary_little_endian), no third-party deps.

The port's own copy of ``pct_tpu.io.ply`` (numpy only; the same
arrays write the same bytes).

Covers the reference's manual ASCII parser/writer (ref utils.py:963-1004),
the curvature-colored export (ref utils.py:538-551,
pointCloudToolbox.py:699-726 ``export_ply_with_curvature_and_normals``)
and the normal-stripping tool (ref ply_remove_normals.py). Unlike the
reference (header-skip + x,y,z only), this parser honours the declared
property list and also reads normals and binary files.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class PlyData:
    points: np.ndarray                      # (N, 3) float32
    normals: Optional[np.ndarray] = None    # (N, 3) float32
    faces: Optional[np.ndarray] = None      # (T, 3) int32
    vertex_props: Dict[str, np.ndarray] = field(default_factory=dict)


def _parse_header(f) -> tuple[str, list]:
    """Returns (format, [(elem_name, count, [(prop_name, dtype)|list-prop])])."""
    magic = f.readline().strip()
    if magic not in (b"ply", "ply"):
        raise ValueError("not a PLY file")
    fmt = "ascii"
    elements: list = []
    while True:
        line = f.readline()
        if isinstance(line, bytes):
            line = line.decode("ascii", "replace")
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append((tok[-1], ("list", tok[2], tok[3])))
            else:
                elements[-1][2].append((tok[2], tok[1]))
        elif tok[0] == "end_header":
            break
    return fmt, elements


def read_ply(path: str) -> PlyData:
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        out = PlyData(points=np.zeros((0, 3), np.float32))
        for name, count, props in elements:
            if fmt == "ascii":
                rows = _read_ascii_element(f, count, props)
            elif fmt in ("binary_little_endian", "binary_big_endian"):
                rows = _read_binary_element(f, count, props, fmt)
            else:
                raise ValueError(f"unsupported PLY format {fmt!r}")
            if name == "vertex":
                _fill_vertex(out, rows, count)
            elif name == "face" and "vertex_indices" in rows:
                out.faces = rows["vertex_indices"]
            elif name == "face" and "vertex_index" in rows:
                out.faces = rows["vertex_index"]
        return out


def _fill_vertex(out: PlyData, rows: Dict[str, np.ndarray], count: int):
    if not all(k in rows for k in ("x", "y", "z")):
        raise ValueError("PLY vertex element lacks x/y/z")
    out.points = np.stack(
        [rows["x"], rows["y"], rows["z"]], axis=1
    ).astype(np.float32)
    if all(k in rows for k in ("nx", "ny", "nz")):
        out.normals = np.stack(
            [rows["nx"], rows["ny"], rows["nz"]], axis=1
        ).astype(np.float32)
    for k, v in rows.items():
        if k not in ("x", "y", "z", "nx", "ny", "nz"):
            out.vertex_props[k] = v


def _read_ascii_element(f, count: int, props) -> Dict[str, np.ndarray]:
    has_list = any(isinstance(d, tuple) for _, d in props)
    names = [n for n, _ in props]
    if not has_list:
        vals = np.loadtxt(
            (f.readline() for _ in range(count)), dtype=np.float64, ndmin=2
        )
        return {n: vals[:, i] for i, n in enumerate(names)}
    # list properties (faces): parse row by row
    lists: Dict[str, List] = {n: [] for n in names}
    for _ in range(count):
        line = f.readline()
        if isinstance(line, bytes):
            line = line.decode("ascii")
        tok = line.split()
        i = 0
        for n, d in props:
            if isinstance(d, tuple):
                cnt = int(tok[i]); i += 1
                lists[n].append([int(float(t)) for t in tok[i:i + cnt]])
                i += cnt
            else:
                lists[n].append(float(tok[i])); i += 1
    out = {}
    for n, d in props:
        if isinstance(d, tuple):
            out[n] = np.asarray(lists[n], dtype=np.int32)
        else:
            out[n] = np.asarray(lists[n], dtype=np.float64)
    return out


def _read_binary_element(f, count, props, fmt) -> Dict[str, np.ndarray]:
    endian = "<" if fmt == "binary_little_endian" else ">"
    has_list = any(isinstance(d, tuple) for _, d in props)
    if not has_list:
        dt = np.dtype([(n, endian + _PLY_DTYPES[d]) for n, d in props])
        raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
        return {n: np.asarray(raw[n]) for n, _ in props}
    # binary list props: assume uniform triangle faces (common case)
    out: Dict[str, List] = {n: [] for n, _ in props}
    for _ in range(count):
        for n, d in props:
            if isinstance(d, tuple):
                _, cnt_t, val_t = d
                cnt_dt = np.dtype(endian + _PLY_DTYPES[cnt_t])
                cnt = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
                val_dt = np.dtype(endian + _PLY_DTYPES[val_t])
                vals = np.frombuffer(f.read(val_dt.itemsize * cnt), val_dt)
                out[n].append(vals.astype(np.int32))
            else:
                dt = np.dtype(endian + _PLY_DTYPES[d])
                out[n].append(np.frombuffer(f.read(dt.itemsize), dt)[0])
    return {
        n: np.asarray(v, dtype=np.int32 if isinstance(dict(props)[n], tuple)
                      else np.float64)
        for n, v in out.items()
    }


def write_ply(
    path: str,
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
    vertex_props: Optional[Dict[str, np.ndarray]] = None,
    binary: bool = False,
):
    """ASCII (default, matching ref utils.py:963-976 / 538-551) or binary LE.

    ``vertex_props`` adds scalar float vertex properties, e.g.
    ``{"gaussian_curvature": K, "mean_curvature": H}`` for the
    curvature-colored export.
    """
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = pts.shape[0]
    props = [("x", pts[:, 0]), ("y", pts[:, 1]), ("z", pts[:, 2])]
    if normals is not None:
        nr = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
        props += [("nx", nr[:, 0]), ("ny", nr[:, 1]), ("nz", nr[:, 2])]
    for k, v in (vertex_props or {}).items():
        props.append((k, np.asarray(v, dtype=np.float32).reshape(-1)))

    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in props]
    if faces is not None:
        faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        header += [f"element face {faces.shape[0]}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    if binary:
        with open(path, "wb") as f:
            f.write(("\n".join(header) + "\n").encode("ascii"))
            vdt = np.dtype([(name, "<f4") for name, _ in props])
            rec = np.zeros(n, dtype=vdt)
            for name, col in props:
                rec[name] = col
            f.write(rec.tobytes())
            if faces is not None:
                fdt = np.dtype([("c", "u1"), ("v", "<i4", (3,))])
                frec = np.zeros(faces.shape[0], dtype=fdt)
                frec["c"] = 3
                frec["v"] = faces
                f.write(frec.tobytes())
    else:
        with open(path, "w") as f:
            f.write("\n".join(header) + "\n")
            cols = np.stack([c for _, c in props], axis=1)
            np.savetxt(f, cols, fmt="%.8g")
            if faces is not None:
                np.savetxt(
                    f,
                    np.hstack([np.full((faces.shape[0], 1), 3, np.int32), faces]),
                    fmt="%d",
                )


def strip_normals(in_path: str, out_path: str):
    """Rewrite a PLY keeping only x,y,z (ref ply_remove_normals.py)."""
    data = read_ply(in_path)
    write_ply(out_path, data.points)
