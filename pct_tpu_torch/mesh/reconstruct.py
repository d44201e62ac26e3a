"""Surface reconstruction: first-party C++ Ball-Pivoting via ctypes.

Port of ``pct_tpu.mesh.reconstruct``. Replaces Open3D
``create_from_point_cloud_ball_pivoting`` + its cleanup passes (ref
utils.py:92-106). The BPA radii recipe mirrors the reference's
``average_distance_using_kd_tree``: 25 radii linspaced over
[0.025·d̄, 5·d̄] (ref utils.py:441-470) — we trim the sub-spacing radii
(below d̄ a ball falls through the sampling and only wastes passes).
``ball_pivoting``, the radii ladders and ``cleanup_mesh`` are the JAX
package's numpy; ``reconstruct_cloud`` runs the port's own normals and
spacing on ``device``.

The shared library builds at first use from the port's own copy of the
source, ``pct_tpu_torch/native/bpa.cpp``, with the host g++ (plain C
ABI, loaded with ctypes) into the git-ignored ``pct_tpu_torch/_build/``
beside the CUDA libraries. Its file name carries a hash of the source
and of the compiler flags; it is written under a per-process temporary
name and moved into place atomically, so concurrent builds never load
a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "bpa.cpp"
BUILD_DIR = _PKG / "_build"
# -march=native: the library is always built on the machine that runs it
# (hash-keyed, never committed), and the grid scans rely on wide
# vectorization of the SoA distance loops
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> Path:
    """Where the library built from ``native/bpa.cpp`` lives: keyed on a
    content hash of the source and the flags, so a stale or
    wrong-platform library is never loaded and no binary is committed."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libbpa-{h.hexdigest()[:16]}.so"


def _build_lib(lib_path: Path):
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError:
        cmd.remove("-march=native")  # exotic hosts: portable fallback
        subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib_path)  # atomic: concurrent builds race safely


def load() -> ctypes.CDLL:
    """The BPA library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    lib_path = library_path()
    if not lib_path.exists():
        _build_lib(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.bpa_reconstruct.restype = ctypes.c_int
    lib.bpa_reconstruct.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
    ]
    lib.bpa_reconstruct_passes.restype = ctypes.c_int
    lib.bpa_reconstruct_passes.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
    ]
    lib.bpa_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def ball_pivoting(points: np.ndarray, normals: np.ndarray,
                  radii: Sequence[float],
                  degeneracy_jitter: float = 0.0,
                  mean_spacing: float | None = None,
                  passes: int = 1) -> np.ndarray:
    """(N,3) points + unit normals + ascending radii -> (T,3) int32 faces.

    ``passes``: repeat the whole radius ladder while the mesh still
    grows (late large-radius gluing could in principle unlock earlier
    seeds). Measured round 5 on the cyclide stress configs: pass 2 adds
    ZERO faces on every (n, seed) tried — the single sweep is already a
    fixed point of the ORPHAN->INSIDE state machine — so the default
    stays 1; the hook remains for other cloud classes.

    ``degeneracy_jitter``: fraction of the mean 1-NN spacing added as a
    seeded symmetry-breaking perturbation to the PIVOT GEOMETRY only
    (the returned faces index the caller's unmodified points). Exact
    lattice samplings (grid torus/egg-carton) put 4+ points on one
    pivot circumsphere, which stalls the front and leaves thousands of
    holes — measured on a 50k grid torus: 0.01·d̄ jitter cuts BPA from
    199 s/88k faces/χ=-11366 to 14 s/99.7k faces/χ=-288. Real scans
    (no exact ties) are unaffected.
    """
    if degeneracy_jitter:
        if mean_spacing is None:
            d = points[1:257] - points[0]
            mean_spacing = float(
                np.sqrt((d * d).sum(-1)[(d * d).sum(-1) > 0].min()))
        rng = np.random.default_rng(0x5EED)
        points = (np.asarray(points, np.float32)
                  + (degeneracy_jitter * mean_spacing)
                  * rng.standard_normal(points.shape).astype(np.float32))
    lib = load()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    nrm = np.ascontiguousarray(normals, dtype=np.float32)
    r = np.ascontiguousarray(sorted(radii), dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_int32)()
    t = lib.bpa_reconstruct_passes(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nrm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pts.shape[0],
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(r), int(passes), ctypes.byref(out))
    if t == 0:
        return np.zeros((0, 3), np.int32)
    faces = np.ctypeslib.as_array(out, shape=(t, 3)).copy()
    lib.bpa_free(out)
    return faces


def bpa_radii(mean_nn_dist: float, num: int = 8) -> np.ndarray:
    """Radii ladder from the mean 1-NN spacing. The reference linspaces
    25 radii over [0.025·d̄, 5·d̄] (utils.py:468); radii below ~d̄ cannot
    bridge the sampling gap, so we ladder geometrically over [d̄, 5·d̄]."""
    return np.geomspace(mean_nn_dist, 5.0 * mean_nn_dist, num)


def bpa_radii_adaptive(nn_dists: np.ndarray, max_num: int = 25) -> np.ndarray:
    """Spread-aware radii ladder from sampled per-point 1-NN distances.

    The reference's 25-rung linspace (utils.py:441-470) exists for
    multi-scale spacing; a ladder derived from the MEAN alone leaves
    ~20×-spread clouds (dupin cyclide stress config) unreconstructed on
    the sparse side.

    Two regimes by sampled spacing spread (max / median):
    - spread < 3 (uniform lattices ~1.0, bunny scan 1.47): geometric
      ladder from the median to 2.5× max spacing, ~8 rungs per 5× band,
      capped at the reference's 25. Unchanged since round 3 — the
      sweep/scan protocols' quality baselines are pinned to it.
    - spread >= 3 (möbius 3.6, cyclide 4.7): STRESS ladder
      geomspace(p10, 4·max, 24) — the dense pinch needs balls below the
      median (p10) and the sparse side needs ~2× more bridging reach.
      Measured round 5 on the cyclide (mesh F/V after the standard hole
      protocol, old → new): 8k/s0 1.66→1.91, 8k/s1 1.44→1.50,
      5k/s0 1.61→1.68, 12k/s0 1.30→1.64 — dominates on every config
      (largest component 0.23-0.89 → 0.77-0.98). The quality landscape
      is chaotic in the rung count (24: 1.91, 25: 1.88, 28: 1.65 on
      8k/s0) — treat any further rung tuning as noise unless it
      dominates across seeds AND sizes like this one.
    """
    d = np.asarray(nn_dists, np.float64)
    d = d[np.isfinite(d) & (d > 0)]
    if d.size == 0:
        return np.geomspace(1e-3, 5e-3, 8)
    med = float(np.median(d))
    mx = float(d.max())
    if mx / med >= 3.0:
        lo = float(np.percentile(d, 10))
        return np.geomspace(lo, 4.0 * mx, min(24, max_num))
    hi = max(2.5 * mx, 5.0 * med)
    num = int(np.clip(np.ceil(8.0 * np.log(hi / med) / np.log(5.0)),
                      8, max_num))
    return np.geomspace(med, hi, num)


def cleanup_mesh(faces: np.ndarray) -> np.ndarray:
    """Degenerate + duplicate triangle removal (ref utils.py:104-106)."""
    if faces.size == 0:
        return faces
    f = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
              & (faces[:, 0] != faces[:, 2])]
    key = np.sort(f, axis=1).astype(np.int64)
    # two int64 sort keys instead of np.unique(axis=0): the row-unique
    # sorts void-dtype records ~4x slower (holds for any vertex count —
    # ids pack exactly into (a<<32)|b)
    ab = (key[:, 0] << 32) | key[:, 1]
    order = np.lexsort((key[:, 2], ab))
    dup = (ab[order][1:] == ab[order][:-1]) & \
        (key[order, 2][1:] == key[order, 2][:-1])
    keep = order[np.concatenate([[True], ~dup])]
    return f[np.sort(keep)]


def reconstruct_cloud(points: np.ndarray, normals: Optional[np.ndarray] = None,
                      radii: Optional[Sequence[float]] = None,
                      num_radii: Optional[int] = None, *,
                      device: str | torch.device = "cuda") -> np.ndarray:
    """Full reconstruction convenience: normals on ``device`` (default
    ``cuda``; raises RuntimeError without a card) if absent,
    spacing-derived radii (spread-aware adaptive ladder by default;
    ``num_radii`` forces the fixed ladder), BPA, cleanup.
    Returns (T,3) faces."""
    from pct_tpu_torch.core.cloud import from_numpy
    from pct_tpu_torch.mesh.normals import estimate_and_orient_normals
    from pct_tpu_torch.neighbors.bruteforce import sampled_nn_distances

    points = np.asarray(points, np.float32)
    cloud = from_numpy(points, device=device)
    if normals is None:
        normals = estimate_and_orient_normals(
            cloud, k=min(50, points.shape[0] - 1), device=device
        )[: points.shape[0]].cpu().numpy()
    nn_d = sampled_nn_distances(cloud.points, cloud.num_points).cpu().numpy()
    dbar = float(np.nanmean(nn_d))
    if radii is None:
        radii = (bpa_radii_adaptive(nn_d) if num_radii is None
                 else bpa_radii(dbar, num_radii))
    faces = ball_pivoting(points, normals, radii,
                          degeneracy_jitter=0.01, mean_spacing=dbar)
    return cleanup_mesh(faces)
