"""Reference-compatible façade of the port.

Drop-in surface for users of the reference toolbox: the class and
function names of ``pointCloudToolbox.PointCloud`` (ref
pointCloudToolbox.py:24) and of ``utils`` (ref utils.py) mapped onto the
port's modules, as the JAX package's ``pct_tpu.compat`` maps them onto
its own. Semantics follow the reference (query-point centering,
k+1-drop-self kNN, sign-fix, etc.); computation is batched and
device-resident instead of per-point Python loops.

The device: ``PointCloud(..., device=)`` and the functions that compute
on it take ``device`` (default ``cuda``; ``RuntimeError`` without a
card), resolved once. The cloud of ``core`` lives there; the façade's
public attributes (``points``, ``normals``, ``neighbor_indices``,
``dists``, the coefficients, ``K_*``, ``H_*``, ``pca_*``,
``estimated_normals``) are numpy arrays, as the reference has them.

Intentional divergences (documented, all improvements):
- ``downsample=True`` works (the reference calls a fully commented-out
  method and crashes, ref :59-60 / :159-193)
- ``plant_kdtree`` builds the grid index; queries are exact (certified)
- energies are O(T) (the reference's are O(T²), ref utils.py:757-760)
- SLSQP quadric fits are closed-form smallest-eigenvector solves
- the neighbor study draws its sample from a ``torch.Generator``
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.io import load_points
from pct_tpu_torch.io.ply import read_ply, write_ply
from pct_tpu_torch.mesh.downsample import voxel_downsample
from pct_tpu_torch.neighbors import knn_cloud_grid
from pct_tpu_torch.pipeline.curvature_pipeline import pointwise_curvature


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class PointCloud:
    """ref pointCloudToolbox.py:24-47 ctor surface."""

    def __init__(self, file_path: Optional[str] = None, points=None,
                 normals=None, downsample: bool = False,
                 voxel_size: float = 0.01, k_neighbors: int = 20,
                 output_path: str = "./output/",
                 max_points_per_voxel: int = 1, *,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if file_path is not None:
            points, normals = load_points(file_path)
        if points is None:
            raise ValueError("need file_path or points")
        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        if downsample:
            # the reference crashes here (commented-out method still
            # invoked); we do the voxel downsample it intended
            c0 = from_numpy(points, device=self.device)
            out, kept = voxel_downsample(c0.points, c0.num_points,
                                         voxel_size,
                                         max_per_voxel=max_points_per_voxel)
            points = _host(out[: int(kept)])
            normals = None
        self.k_neighbors = k_neighbors
        self.output_path = output_path
        self.cloud = from_numpy(points, normals, device=self.device)
        self.points = points
        self.normals = (np.zeros((0, 3), np.float32) if normals is None
                        else np.asarray(normals))
        self.num_points = points.shape[0]
        # whole-cloud norms (ref :43-47). The reference calls
        # np.linalg.norm on the (N,3) MATRIX, so these are matrix norms:
        # l1 = max column abs-sum, l2 = spectral (largest singular
        # value), linf = max row abs-sum.
        p64 = points.astype(np.float64)
        if p64.size:
            self.l1_norm = float(np.linalg.norm(p64, 1))
            self.l2_norm = float(np.linalg.norm(p64, 2))
            self.linf_norm = float(np.linalg.norm(p64, np.inf))
        else:
            self.l1_norm = self.l2_norm = self.linf_norm = 0.0
        self.dists = None
        self.neighbor_indices = None
        self.quadratic_coefficients = None
        self.quadric_coefficients = None
        self.K_quadratic = None
        self.H_quadratic = None
        self.K_H_sq_quadratic = None
        self.K_quadric = None
        self.H_quadric = None

    def _indices(self) -> torch.Tensor:
        """``neighbor_indices`` on the cloud's device (planting first)."""
        if self.neighbor_indices is None:
            self.plant_kdtree()
        return torch.as_tensor(self.neighbor_indices, device=self.device)

    # ---- kNN index (ref :69-85) ----
    def plant_kdtree(self, k_neighbors: Optional[int] = None):
        k = k_neighbors or self.k_neighbors
        self.k_neighbors = k
        res, grid = knn_cloud_grid(self.cloud, k, device=self.device)
        n = self.num_points
        self.neighbor_indices = _host(res.indices[:n])
        self.dists = _host(res.dists[:n])
        self._grid = grid
        return self.neighbor_indices, self.dists

    # ---- explicit quadratic path (ref :635-674) ----
    def fit_explicit_quadratic_surfaces_to_neighborhoods(self):
        curv, normals, coeffs = pointwise_curvature(
            self.cloud.points, self._indices(), method="explicit")
        self.quadratic_coefficients = _host(coeffs)
        self._explicit_curv = curv
        self.estimated_normals = _host(normals)
        return self.quadratic_coefficients

    def calculate_curvatures_of_explicit_quadratic_surfaces_for_all_points(self):
        if self.quadratic_coefficients is None:
            self.fit_explicit_quadratic_surfaces_to_neighborhoods()
        c = self._explicit_curv
        self.K_quadratic = _host(c.K)
        self.H_quadratic = _host(c.H)
        self.K_H_sq_quadratic = _host(c.H_sq)
        return self.K_quadratic, self.H_quadratic

    def compute_pointwise_explicit_quadratic_curvature(self):
        self.calculate_curvatures_of_explicit_quadratic_surfaces_for_all_points()
        return self.K_quadratic, self.H_quadratic

    # ---- implicit quadric path (ref :617-689) ----
    def fit_implicit_quadric_surfaces_all_points(self, mode: str = "exact"):
        curv, _, coeffs = pointwise_curvature(
            self.cloud.points, self._indices(), method="implicit",
            implicit_mode=mode)
        self.quadric_coefficients = _host(coeffs)
        self._implicit_curv = curv
        return self.quadric_coefficients

    def calculate_curvatures_of_implicit_quadric_surfaces_for_all_points(
            self, mode: str = "exact"):
        if self.quadric_coefficients is None:
            self.fit_implicit_quadric_surfaces_all_points(mode)
        c = self._implicit_curv
        self.K_quadric = _host(c.K)
        self.H_quadric = _host(c.H)
        return self.K_quadric, self.H_quadric

    def compute_pointwise_implicit_quadric_curvature(self, mode="exact"):
        self.calculate_curvatures_of_implicit_quadric_surfaces_for_all_points(mode)
        return self.K_quadric, self.H_quadric

    # ---- PCA proxy (ref :901-945) ----
    def principal_curvatures_via_principal_component_analysis(self, k: int):
        from pct_tpu_torch.curvature.pca import pca_principal_curvatures

        res, _ = knn_cloud_grid(self.cloud, k, device=self.device)
        r = pca_principal_curvatures(self.cloud.points,
                                     res.indices[: self.num_points])
        self.pca_k1 = _host(r.k1)
        self.pca_k2 = _host(r.k2)
        self.pca_K = _host(r.K)
        self.pca_H = _host(r.H)
        self.pca_dir1 = _host(r.dir1)
        self.pca_dir2 = _host(r.dir2)
        return self.pca_k1, self.pca_k2

    # ---- neighbor study (ref :732-800) ----
    def explicit_quadratic_neighbor_study(self, tolerance: float = 1e-7,
                                          sample_size: int = 500):
        from pct_tpu_torch.pipeline.neighbor_study import (
            explicit_quadratic_neighbor_study,
        )

        k_rec, _ = explicit_quadratic_neighbor_study(
            self.cloud, tol=tolerance, sample_size=sample_size,
            device=self.device)
        return int(k_rec)

    # ---- energies (ref :649-655 static form) ----
    @staticmethod
    def calculate_energies(voronoi_areas, gaussian_curvatures,
                           mean_curvatures):
        a = np.asarray(voronoi_areas, dtype=np.float64)
        K = np.asarray(gaussian_curvatures, dtype=np.float64)
        H = np.asarray(mean_curvatures, dtype=np.float64)
        bending = float(np.nansum(H**2 * a))
        stretching = float(np.nansum(K * a))
        return bending, stretching

    # ---- normals & export (ref :691-726) ----
    def compute_normals(self, k: int = 50):
        from pct_tpu_torch.mesh.normals import estimate_and_orient_normals

        nrm = estimate_and_orient_normals(
            self.cloud, k=min(k, max(4, self.num_points - 1)),
            device=self.device)
        self.normals = _host(nrm[: self.num_points])
        return self.normals

    def export_ply_with_curvature_and_normals(self, path: str):
        if self.K_quadratic is None:
            self.compute_pointwise_explicit_quadratic_curvature()
        if self.normals is None or not len(self.normals):
            self.compute_normals()
        n = self.num_points
        write_ply(path, self.points, self.normals[:n],
                  vertex_props={
                      "gaussian_curvature": self.K_quadratic[:n],
                      "mean_curvature": self.H_quadratic[:n]})
        return path

    # ---- transforms & filters (ref :123-268) ----
    def rotate_point_cloud(self, angle_x, angle_y, angle_z,
                           compat_z_from_y: bool = False):
        from pct_tpu_torch.utils.transforms import rotate_point_cloud

        self.points = rotate_point_cloud(self.points, angle_x, angle_y,
                                         angle_z,
                                         compat_z_from_y=compat_z_from_y)
        self.cloud = from_numpy(self.points, device=self.device)
        self.neighbor_indices = None
        return self.points

    def downsample_point_cloud_by_grid(self, voxel_size: float,
                                       max_points_per_voxel: int = 1):
        out, kept = voxel_downsample(self.cloud.points, self.cloud.num_points,
                                     voxel_size,
                                     max_per_voxel=max_points_per_voxel)
        self.points = _host(out[: int(kept)])
        self.num_points = self.points.shape[0]
        self.cloud = from_numpy(self.points, device=self.device)
        self.neighbor_indices = None
        return self.points

    # ---- plotting (ref :482-615, 952-1009); viz needs matplotlib ----
    def plot_points_colored_by_quadratic_curvatures(self):
        from pct_tpu_torch.viz.plots import plot_points_colored_by_curvature

        if self.K_quadratic is None:
            self.compute_pointwise_explicit_quadratic_curvature()
        n = self.num_points
        plot_points_colored_by_curvature(
            self.points, self.K_quadratic[:n], self.H_quadratic[:n],
            self.output_path, tag=f"_k{self.k_neighbors}")

    def plot_points_colored_by_quadric_curvatures(self):
        from pct_tpu_torch.viz.plots import plot_points_colored_by_curvature

        if self.K_quadric is None:
            self.compute_pointwise_implicit_quadric_curvature()
        n = self.num_points
        plot_points_colored_by_curvature(
            self.points, self.K_quadric[:n], self.H_quadric[:n],
            self.output_path, tag=f"_quadric_k{self.k_neighbors}")

    def visualize_knn_for_n_random_points(self, num_samples: int = 5):
        from pct_tpu_torch.viz.plots import visualize_knn_for_random_points

        if self.neighbor_indices is None:
            self.plant_kdtree()
        visualize_knn_for_random_points(self.points, self.neighbor_indices,
                                        self.output_path, num_samples)

    def plot_surface(self):
        from pct_tpu_torch.viz.plots import plot_surface

        plot_surface(self.points, self.output_path)


# ---- utils.py-level functions (ref utils.py) ----

def parse_ply(path):
    """ref utils.py:979-1004."""
    return read_ply(path).points


def save_points_to_ply(points, path):
    """ref utils.py:963-976."""
    write_ply(path, np.asarray(points))


def average_distance_using_kd_tree(points, sample: int = 1000, *,
                                   device: str | torch.device = "cuda"):
    """Mean 1-NN distance + the 25-radius BPA ladder (ref utils.py:441-470)."""
    from pct_tpu_torch.neighbors.bruteforce import mean_nn_distance

    cloud = from_numpy(np.asarray(points, np.float32),
                       device=resolve_device(device))
    d = float(mean_nn_distance(cloud.points, cloud.num_points,
                               sample=min(1024, max(16, sample))))
    radii = np.linspace(0.025 * d, 5 * d, 25)
    return d, radii


def detect_boundary_loops(faces):
    """ref utils.py:407-436."""
    from pct_tpu_torch.mesh.boundary import detect_boundary_loops as f

    return f(np.asarray(faces))


def estimate_curvature(points, k_fraction: float = 0.025,
                       max_neighbors: int = 100, *,
                       device: str | torch.device = "cuda"):
    """Surface-variation PCA curvature (ref utils.py:778-829). ``k`` is
    min(max(n·k_fraction, 3), max_neighbors, n - 1), ``max_neighbors``
    on any cloud over 4,000 points at the default fraction; any k runs,
    as in the JAX package."""
    from pct_tpu_torch.curvature.pca import surface_variation

    pts = np.asarray(points, np.float32)
    n = pts.shape[0]
    k = int(min(max(n * k_fraction, 3), max_neighbors, n - 1))
    cloud = from_numpy(pts, device=resolve_device(device))
    res, _ = knn_cloud_grid(cloud, k, device=cloud.points.device)
    return _host(surface_variation(cloud.points, res.indices[:n]))


def get_characteristic_scale(points):
    """Max distance from the centroid (ref utils.py:767-775)."""
    pts = np.asarray(points, np.float64)
    return float(np.linalg.norm(pts - pts.mean(0), axis=1).max())


def generate_pv_shapes(shape_name: str, num_points: int,
                       perturbation_strength: float = 0.0,
                       desired_scale: float = 1.0, radius=None, seed=0):
    """ref utils.py:833-959 (radius kwarg aliases desired_scale, ref :854)."""
    from pct_tpu_torch.shapes import generate_shape

    scale = radius if radius is not None else desired_scale
    return generate_shape(shape_name, num_points, radius=scale,
                          perturbation_strength=perturbation_strength,
                          seed=seed)


def create_mesh_with_curvature(file_path_or_points, shape_name="scan",
                               variant="none", *,
                               device: str | torch.device = "cuda", **kw):
    """ref utils.py:20-377 (array-based; no temp-file handoff)."""
    from pct_tpu_torch.pipeline.mesh_pipeline import (
        create_mesh_with_curvature as f,
    )

    dev = resolve_device(device)
    if isinstance(file_path_or_points, str):
        pts, _ = load_points(file_path_or_points)
    else:
        pts = np.asarray(file_path_or_points, np.float32)
    return f(pts, device=dev, **kw)


def load_mesh_compute_energies(vertices, faces, K_vertex, H_vertex, *,
                               device: str | torch.device = "cuda"):
    """ref utils.py:702-765, O(T) by construction."""
    from pct_tpu_torch.mesh.energies import mesh_energies

    dev = resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    e = mesh_energies(put(vertices, torch.float32), put(faces, torch.int32),
                      put(K_vertex, torch.float32),
                      put(H_vertex, torch.float32))
    return float(e.bending), float(e.stretching), float(e.total_area)


def validate_shape(file_path, flag="N", shape_name="scan", variant="none",
                   radius=None, *, device: str | torch.device = "cuda",
                   **kw):
    """ref utils.py:476-676 (flag='Y' enables the z-score outlier sweep —
    automated here, no input() prompts)."""
    from pct_tpu_torch.validate.harness import validate_file

    res = validate_file(file_path, shape=shape_name, variant=variant,
                        radius=radius, outlier_filter=(flag != "N"),
                        device=resolve_device(device), **kw)
    return res.bending_energy, res.stretching_energy, res.total_area
