"""Shape-validation harness: curvature → energies → percent errors.

Port of ``pct_tpu.validate.harness`` (the reference's ``validate_shape``,
ref utils.py:476-676), the same sequence of steps with the same guards:

1. the neighbor-convergence study (``auto_k``), aborting when the
   converged k is below ``min_converged_k`` (utils.py:490-492);
2. curvature at the CONFIGURED k (the reference's quirk: not the
   converged k, utils.py:495-498), either through the mesh protocol
   (``create_mesh_with_curvature``: normals → BPA → hole fill → Taubin →
   vertex curvature → face-averaged energies, utils.py:479 and :562) or
   mesh-free (``fast_curvature`` with per-point area weights
   a_i = π·r_k,i²/k: each point owns 1/k of its kth-neighbor disk);
3. the NaN census, aborting above ``nan_abort_fraction``
   (utils.py:524-533), and the z-score outlier filter at descending
   thresholds (utils.py:573-637, automated: no ``input()`` prompts);
4. the bending, stretching and area integrals;
5. the artifacts: ``.npy`` curvature dumps, the curvature-colored PLY
   and, in mesh mode, a ``mesh_snaps/*.vtk`` snapshot (utils.py:356-366,
   504-518, 538-551).

The device stages run on ``device`` (default ``cuda``; RuntimeError
without a card). Every stage lap is taken after its stage's results have
reached the host, so ``stage_timings`` holds device work, not launches.
The study runs at ``STUDY_KMAX`` and the result records that same value
as ``study_kmax`` (the JAX package writes the literal 99 beside a study
it runs at the study's default).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from pct_tpu_torch.core.cloud import from_numpy
from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.pipeline.fused import fast_curvature
from pct_tpu_torch.pipeline.neighbor_study import (
    explicit_quadratic_neighbor_study,
)

log = logging.getLogger("pct_tpu_torch.validate")

STUDY_KMAX = 99          # the neighbor study's ladder top (its default)


@dataclasses.dataclass
class ValidationResult:
    shape: str
    variant: str
    num_points: int
    radius: Optional[float]
    k_used: int
    converged_k: int
    bending_energy: float
    stretching_energy: float
    total_area: float
    nan_fraction: float
    runtime_s: float
    aborted: str = ""          # non-empty = abort reason (reference's "Error" rows)
    # percent errors vs closed form (filled by the sweep when known)
    area_error_pct: Optional[float] = None
    bending_error_pct: Optional[float] = None
    stretching_error_pct: Optional[float] = None
    # per-stage wall seconds (study + MeshResult.timings, or study +
    # curvature mesh-free), persisted by the sweep and scans CSVs
    stage_timings: dict = dataclasses.field(default_factory=dict)
    # the share of study samples that converged: converged_k ~ kmax can
    # mean "everything converged near kmax" or "nothing converged and
    # was clamped". -1/-1.0 = study not run.
    converged_fraction: float = -1.0
    study_kmax: int = -1


def point_area_weights(dists: torch.Tensor, k: int) -> torch.Tensor:
    """a_i = π r_k² / k — each point owns 1/k of its k-neighborhood disk."""
    r_k = dists[:, -1]
    return math.pi * r_k * r_k / k


def zscore_filter(values: np.ndarray, thresholds=(7, 5, 3, 2, 1),
                  stop_fraction: float = 0.05) -> np.ndarray:
    """Descending z-score outlier masking (ref utils.py:573-637, automated:
    keep tightening while fewer than ``stop_fraction`` of points would be
    dropped by the next threshold). Returns a boolean keep-mask."""
    keep = np.isfinite(values)
    for t in thresholds:
        v = values[keep]
        if v.size == 0:
            break
        mu, sigma = v.mean(), v.std()
        if sigma == 0:
            sigma = 1e-6           # ref utils.py:565-570 σ=0 guard
        would_drop = np.abs(values - mu) > t * sigma
        frac = (would_drop & keep).sum() / max(keep.sum(), 1)
        if frac > stop_fraction:
            break
        keep &= ~would_drop
    return keep


def _aborted(shape, variant, n, radius, k, converged_k, nan_frac, t0,
             reason, conv_frac, study_kmax) -> ValidationResult:
    return ValidationResult(shape, variant, n, radius, k, converged_k,
                            np.nan, np.nan, np.nan, nan_frac,
                            time.perf_counter() - t0, aborted=reason,
                            converged_fraction=conv_frac,
                            study_kmax=study_kmax)


def validate_cloud(
    points: np.ndarray,
    shape: str = "scan",
    variant: str = "none",
    radius: Optional[float] = None,
    k_neighbors: int = 100,
    auto_k: bool = True,
    min_converged_k: int = 10,
    nan_abort_fraction: float = 0.8,
    outlier_filter: bool = False,
    output_dir: Optional[str] = None,
    study_tol_rel: float = 0.0,
    use_mesh: bool = True,
    smooth_iterations: int = 10,
    device: str | torch.device = "cuda",
) -> ValidationResult:
    """validate_shape (the steps of ref utils.py:476) on ``device``.

    ``use_mesh=True`` (default) follows the reference's protocol: the
    triangle areas tile the surface, so the integrals do not depend on
    the sampling pattern. ``use_mesh=False`` is the fast mesh-free
    estimate with per-point disk weights, which lattice-sampled clouds
    bias by up to ~20%. ``smooth_iterations=10`` is the reference's
    Taubin ×10 before the vertex fits; on analytic shapes it flattens
    real curvature and biases ∫H² low, so pass 0 for noise-free runs.
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    cloud = from_numpy(points, device=dev)
    n = int(cloud.num_points)
    stage_t: dict = {}

    converged_k = -1
    conv_frac = -1.0
    study_kmax = -1
    if auto_k:
        t_s = time.perf_counter()
        k_rec, per_sample = explicit_quadratic_neighbor_study(
            cloud, kmax=STUDY_KMAX, tol_rel=study_tol_rel, device=dev)
        converged_k = int(k_rec)
        # samples that never converged carry -1 (they count as kmax in
        # the mean): the fraction tells "converged at kmax" from "clamped"
        ps = per_sample.cpu().numpy()
        stage_t["study"] = round(time.perf_counter() - t_s, 3)
        conv_frac = float((ps >= 0).mean()) if ps.size else 0.0
        study_kmax = STUDY_KMAX
        if converged_k < min_converged_k:
            log.warning("converged k %d < %d — aborting (ref utils.py:490)",
                        converged_k, min_converged_k)
            return _aborted(shape, variant, n, radius, k_neighbors,
                            converged_k, np.nan, t0,
                            "neighbor study did not converge", conv_frac,
                            study_kmax)

    normals = None
    mesh_path = None
    if use_mesh:
        from pct_tpu_torch.pipeline.mesh_pipeline import (
            create_mesh_with_curvature,
        )

        if output_dir:
            snaps = os.path.join(output_dir, "mesh_snaps")
            os.makedirs(snaps, exist_ok=True)
            mesh_path = os.path.join(
                snaps, f"mesh_{n}_points_{shape}_{variant}.vtk")
        mesh = create_mesh_with_curvature(points, k_neighbors=k_neighbors,
                                          save_mesh_path=mesh_path,
                                          smooth_iterations=smooth_iterations,
                                          device=dev)
        K, H = mesh.K, mesh.H
        normals = mesh.normals
        stage_t.update(mesh.timings)
        log.info("mesh stage seconds: %s", mesh.timings)
        nan_frac = float(np.isnan(K).mean())
        if nan_frac > nan_abort_fraction:
            log.error("NaN fraction %.2f > %.2f — aborting "
                      "(ref utils.py:524-533)", nan_frac, nan_abort_fraction)
            return _aborted(shape, variant, n, radius, k_neighbors,
                            converged_k, nan_frac, t0, "NaN census",
                            conv_frac, study_kmax)
        bending = float(mesh.energies.bending)
        stretching = float(mesh.energies.stretching)
        total_area = float(mesh.energies.total_area)
        if outlier_filter:
            # reference ordering: the energy integrals precede the
            # z-score pass (utils.py:562 before :573-637), so the filter
            # masks the curvature artifacts, never the integrals
            keep = zscore_filter(K) & zscore_filter(H)
            K = np.where(keep, K, np.nan)
            H = np.where(keep, H, np.nan)
    else:
        t_c = time.perf_counter()
        r = fast_curvature(cloud, k=k_neighbors, device=dev)
        K = r.curv.K[:n].cpu().numpy()
        H = r.curv.H[:n].cpu().numpy()
        r_k = r.kth_dist[:n].cpu().numpy()
        exact = r.exact[:n].cpu().numpy()
        normals = r.normals[:n].cpu().numpy()
        stage_t["curvature"] = round(time.perf_counter() - t_c, 3)

        nan_frac = float(np.isnan(K).mean())
        if nan_frac > nan_abort_fraction:
            log.error("NaN fraction %.2f > %.2f — aborting "
                      "(ref utils.py:524-533)", nan_frac, nan_abort_fraction)
            return _aborted(shape, variant, n, radius, k_neighbors,
                            converged_k, nan_frac, t0, "NaN census",
                            conv_frac, study_kmax)

        areas = np.pi * r_k * r_k / k_neighbors  # point_area_weights on r_k
        # rows whose kNN coverage is not certified carry zero outputs:
        # excluded like NaNs
        keep = np.isfinite(K) & np.isfinite(H) & exact
        if outlier_filter:
            keep &= zscore_filter(K) & zscore_filter(H)

        bending = float(np.nansum(H[keep] ** 2 * areas[keep]))
        stretching = float(np.nansum(K[keep] * areas[keep]))
        total_area = float(np.nansum(areas[keep]))

    if output_dir:
        from pct_tpu_torch.io.ply import write_ply

        os.makedirs(output_dir, exist_ok=True)
        stem = f"{shape}_{variant}_{n}"
        np.save(os.path.join(output_dir, f"{stem}_gaussian.npy"), K)
        np.save(os.path.join(output_dir, f"{stem}_mean.npy"), H)
        write_ply(os.path.join(output_dir, f"{stem}_with_curvatures.ply"),
                  points, normals,
                  vertex_props={"gaussian_curvature": K,
                                "mean_curvature": H})

    return ValidationResult(shape, variant, n, radius, k_neighbors,
                            converged_k, bending, stretching, total_area,
                            nan_frac, time.perf_counter() - t0,
                            stage_timings=stage_t,
                            converged_fraction=conv_frac,
                            study_kmax=study_kmax)


def validate_file(file_path: str, **kw) -> ValidationResult:
    """File entry point (parity with validate_shape's file interface)."""
    from pct_tpu_torch.io import load_points

    pts, _ = load_points(file_path)
    return validate_cloud(pts, **kw)


def percent_error(computed: float, theoretical: float,
                  zero_tol: float = 1e-9) -> Optional[float]:
    """Zero-division-safe percent error (ref main_shape_validation.py:121-145).

    Theoretical values below ``zero_tol`` are treated as exactly zero
    (numeric quadrature residue would otherwise explode the ratio)."""
    if theoretical is None or not np.isfinite(theoretical):
        return None
    if abs(theoretical) < zero_tol:
        return abs(computed) * 100.0   # reference's 'absolute as percent' fallback
    return abs(computed - theoretical) / abs(theoretical) * 100.0
