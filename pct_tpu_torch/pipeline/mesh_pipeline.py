"""Mesh pipeline orchestrator: reconstruct → clean → fill → smooth →
curvature → energies.

Port of ``pct_tpu.pipeline.mesh_pipeline`` (the reference's
``create_mesh_with_curvature``, ref utils.py:20-377, with
``load_mesh_compute_energies``, utils.py:702-765), the stages in the same
order and with the same semantics. The device stages run on ``device``;
BPA and the hole passes are host numpy and C++:

1. normals: ``estimate_and_orient_normals`` at k = min(50, max(4, n−1))
   (device: the moments kernel at k and the rows kernel for the voters
   and, on large clouds, the coarse graph);
2. BPA radii from the sampled 1-NN spacings (device) — the spread-aware
   adaptive ladder, or the fixed geometric one for an int ``num_radii``;
3. first-party C++ ball pivoting with a 0.01·d̄ degeneracy jitter (host);
4. cleanup: degenerate/duplicate faces (host);
5. the small-hole pass twice, then cleanup (host);
6. Taubin smoothing (device);
7. the large-hole pass at bbox.mean()/10 on the smoothed vertices, then
   cleanup (host);
8. vertex curvatures: ``fast_curvature`` at ``k_neighbors`` on the mesh
   vertices (device: the coords kernel at k < 64);
9. face-averaged energy integrals (device).

Two divergences from the JAX package, neither of which changes a
result: the vertex fits take ``fast_curvature``'s tight bucket layout
(the JAX package passes ``coarse_spec=True``, which exists to share one
compiled program across clouds; on certified rows K and H are the same),
and the faces go to Taubin and the energies unpadded (the JAX package
pads them to a power of two under a ``face_mask`` for the same reason;
the mask makes padding contribute nothing).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from pct_tpu_torch.core.cloud import from_numpy
from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.mesh.boundary import fill_holes_by_size, fill_small_holes
from pct_tpu_torch.mesh.energies import MeshEnergies, mesh_energies
from pct_tpu_torch.mesh.reconstruct import (
    ball_pivoting,
    bpa_radii,
    bpa_radii_adaptive,
    cleanup_mesh,
)
from pct_tpu_torch.mesh.smooth import taubin_smooth
from pct_tpu_torch.neighbors.bruteforce import sampled_nn_distances
from pct_tpu_torch.pipeline.fused import fast_curvature


@dataclasses.dataclass
class MeshResult:
    vertices: np.ndarray
    faces: np.ndarray
    normals: np.ndarray
    K: np.ndarray
    H: np.ndarray
    energies: MeshEnergies
    n_holes_filled: int
    timings: dict = dataclasses.field(default_factory=dict)
    """Per-stage wall seconds (normals/bpa/holes_small/smooth/holes_large/
    curvature/energies), each lap taken after its stage's device work
    has finished."""


def create_mesh_with_curvature(
    points: np.ndarray,
    k_neighbors: int = 20,
    num_radii: Optional[int] = None,
    smooth_iterations: int = 10,
    fill_holes: bool = True,
    save_mesh_path: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> MeshResult:
    """(N,3) points → mesh, vertex curvatures and energy integrals; the
    device stages run on ``device`` (default ``cuda``; raises
    RuntimeError without a card).

    ``num_radii=None`` (default) uses the spread-aware adaptive ladder
    (``bpa_radii_adaptive`` — up to the reference's 25 rungs on
    high-spacing-spread clouds, utils.py:441-470); pass an int for the
    fixed geometric ladder. ``save_mesh_path`` writes the mesh with K
    and H as vertex scalars, to ``.vtk`` or else to PLY.
    """
    # imported here: mesh.normals imports this package (pipeline.fused)
    from pct_tpu_torch.mesh.normals import estimate_and_orient_normals

    dev = resolve_device(device)
    points = np.asarray(points, dtype=np.float32)
    cloud = from_numpy(points, device=dev)
    n = int(cloud.num_points)
    timings: dict = {}
    _t = time.perf_counter()

    def lap(stage):
        # every stage ends with its results copied to the host (or read
        # as Python floats), so its device work has finished here
        nonlocal _t
        now = time.perf_counter()
        timings[stage] = round(now - _t, 3)
        _t = now

    normals = estimate_and_orient_normals(
        cloud, k=min(50, max(4, n - 1)), device=dev)[:n].cpu().numpy()
    lap("normals")
    nn_d = sampled_nn_distances(cloud.points, n).cpu().numpy()
    dbar = float(np.nanmean(nn_d))
    radii = (bpa_radii_adaptive(nn_d) if num_radii is None
             else bpa_radii(dbar, num_radii))
    faces = cleanup_mesh(ball_pivoting(points, normals, radii,
                                       degeneracy_jitter=0.01,
                                       mean_spacing=dbar))
    lap("bpa")

    filled = 0
    if fill_holes and faces.size:
        # the reference runs its hole pass twice back-to-back (utils.py:151,236)
        for _ in range(2):
            faces, nf = fill_small_holes(points, faces)
            filled += nf
        faces = cleanup_mesh(faces.astype(np.int32))
        lap("holes_small")

    verts = points
    if smooth_iterations > 0 and faces.size:
        verts = taubin_smooth(torch.from_numpy(points).to(dev),
                              torch.from_numpy(faces).to(dev),
                              iterations=smooth_iterations).cpu().numpy()
        lap("smooth")

    if fill_holes and faces.size:
        # final large-hole pass after smoothing (ref utils.py:338-345:
        # pyvista fill_holes(hole_size=bbox_avg/10)) — non-planar loops
        # included, min-area triangulation
        bbox = points.max(0) - points.min(0)
        faces, nf = fill_holes_by_size(verts, faces,
                                       hole_size=float(bbox.mean()) / 10.0)
        filled += nf
        faces = cleanup_mesh(faces.astype(np.int32))
        lap("holes_large")

    # curvature on the (smoothed) mesh vertices — reference semantics:
    # a fresh PointCloud over the mesh vertices (utils.py:481-501)
    r = fast_curvature(from_numpy(verts, device=dev), k=k_neighbors,
                       device=dev)
    K_t, H_t = r.curv.K[:n], r.curv.H[:n]
    K, H = K_t.cpu().numpy(), H_t.cpu().numpy()
    lap("curvature")

    if faces.size:
        e = mesh_energies(torch.from_numpy(verts).to(dev),
                          torch.from_numpy(faces).to(dev), K_t, H_t)
        energies = MeshEnergies(*(float(x) for x in e))
    else:
        energies = MeshEnergies(float("nan"), float("nan"), 0.0)
    lap("energies")

    if save_mesh_path:
        scalars = {"gaussian_curvature": K, "mean_curvature": H}
        if save_mesh_path.lower().endswith(".vtk"):
            # mesh_snaps/*.vtk artifact parity (ref utils.py:356-366)
            from pct_tpu_torch.io.vtk import write_vtk

            write_vtk(save_mesh_path, verts, faces, scalars)
        else:
            from pct_tpu_torch.io.ply import write_ply

            write_ply(save_mesh_path, verts, normals, faces,
                      vertex_props=scalars)
    return MeshResult(verts, faces, normals, K, H, energies, filled,
                      timings)
