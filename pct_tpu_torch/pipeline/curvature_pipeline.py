"""Staged curvature pipeline: library kNN, then per-point fits.

Port of ``pct_tpu.pipeline.curvature_pipeline``, the reference toolbox's
call sequence (kd-tree, per-point fit, curvature formulas) as two
stages: ``knn_cloud_grid`` finds every point's k nearest neighbors
(certified exact after its brute-force repair), then
``pointwise_curvature`` gathers each neighborhood, centers it on the
query point (not the centroid) and runs frames → fit → curvature in
chunks of rows. Unlike ``fast_curvature`` it also returns the fit
coefficients and the neighbor indices and distances.
``pointwise_curvature(neighbor_mask=)`` fits only the valid slots of
each neighborhood.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.curvature.explicit import Curvatures, explicit_curvatures
from pct_tpu_torch.curvature.implicit import implicit_curvatures
from pct_tpu_torch.fit.frames import estimate_normals, tangent_frames
from pct_tpu_torch.fit.quadratic import fit_quadratic
from pct_tpu_torch.fit.quadric import fit_quadric
from pct_tpu_torch.neighbors.knn import knn_cloud_grid
from pct_tpu_torch.utils import trace as _trace

# Rows per chunk: the results do not depend on it. The fit chain runs
# eagerly, hundreds of small kernels a chunk, so chunks are large.
ROWS_PER_CHUNK = 1 << 17


class PipelineResult(NamedTuple):
    curv: Curvatures                # per-point K/H/k1/k2/H²
    normals: torch.Tensor           # (N, 3) sign-fixed normals
    coeffs: torch.Tensor            # (N, 6) explicit or (N, 10) implicit
    neighbor_indices: torch.Tensor  # (N, k) int32
    neighbor_dists: torch.Tensor    # (N, k) float32


def neighborhood_curvature(centered: torch.Tensor, method: str = "explicit",
                           implicit_mode: str = "exact",
                           mask: torch.Tensor | None = None):
    """(..., k, 3) query-centered neighborhoods -> (Curvatures, normals
    (..., 3), coeffs (..., 6 or 10)): the reference's per-point chain,
    batched over the leading axes. "explicit" fits the Monge patch in the
    tangent frame; "implicit" fits the quadric in the original frame
    (the frame's normal is still returned). ``mask`` (..., k) bool: the
    frame and the fit use only the valid slots."""
    if method == "explicit":
        rotated, _, normal = tangent_frames(centered, mask)
        coeffs = fit_quadratic(rotated, mask)
        return explicit_curvatures(coeffs), normal, coeffs
    if method == "implicit":
        normal, _ = estimate_normals(centered, mask)
        coeffs = fit_quadric(centered, mask)
        return implicit_curvatures(coeffs, mode=implicit_mode), normal, coeffs
    raise ValueError(f"unknown method {method!r}")


@_trace.stage("fit")
def pointwise_curvature(points: torch.Tensor, indices: torch.Tensor,
                        method: str = "explicit",
                        tile: int = ROWS_PER_CHUNK,
                        implicit_mode: str = "exact",
                        neighbor_mask: torch.Tensor | None = None):
    """points (N,3) + neighbor indices (Q,k) -> (Curvatures, normals
    (Q,3), coeffs (Q,...)); query i is points[i]. ``neighbor_mask``
    (Q,k) bool marks the valid neighbor slots (distance-sorted, as the
    sign fix reads the farthest valid one). Runs on the tensors' device,
    in chunks of ``tile`` rows."""
    nq = indices.shape[0]
    parts = []
    for s in range(0, nq, tile):
        idx = indices[s:s + tile].long()
        centered = points[idx] - points[s:s + idx.shape[0], None, :]
        mask = None if neighbor_mask is None else neighbor_mask[s:s + tile]
        parts.append(neighborhood_curvature(centered, method, implicit_mode,
                                            mask))
    curv, normals, coeffs = zip(*parts)
    return (Curvatures(*(torch.cat(c) for c in zip(*curv))),
            torch.cat(normals), torch.cat(coeffs))


@_trace.stage("curvature_pipeline")
def curvature_pipeline(cloud, k: int = 20, method: str = "explicit",
                       capacity: int | None = None, rings: int = 1,
                       tile: int = ROWS_PER_CHUNK,
                       implicit_mode: str = "exact", *,
                       device: str | torch.device = "cuda") -> PipelineResult:
    """Grid kNN (``knn_cloud_grid``) → per-point curvature on ``device``
    (default ``cuda``; raises RuntimeError without a card). Outputs are
    (capacity, ...) in the cloud's point order; padding rows are
    meaningless."""
    dev = resolve_device(device)
    res, _ = knn_cloud_grid(cloud, k, capacity=capacity, rings=rings,
                            device=dev)
    with _trace.span("load"):
        points = cloud.points.to(dev)
    curv, normals, coeffs = pointwise_curvature(
        points, res.indices, method=method, tile=tile,
        implicit_mode=implicit_mode)
    return PipelineResult(curv, normals, coeffs, res.indices, res.dists)


def compute_pointwise_explicit_quadratic_curvature(
        cloud, k: int = 20, *, device: str | torch.device = "cuda"):
    """(K, H): the reference toolbox's explicit-quadratic entry."""
    r = curvature_pipeline(cloud, k=k, method="explicit", device=device)
    return r.curv.K, r.curv.H


def compute_pointwise_implicit_quadric_curvature(
        cloud, k: int = 20, mode: str = "exact", *,
        device: str | torch.device = "cuda"):
    """(K, H): the reference toolbox's implicit-quadric entry."""
    r = curvature_pipeline(cloud, k=k, method="implicit", implicit_mode=mode,
                           device=device)
    return r.curv.K, r.curv.H
