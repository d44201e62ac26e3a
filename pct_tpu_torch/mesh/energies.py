"""Mesh energy integrals and mesh-based vertex curvatures on the device.

Port of ``pct_tpu.mesh.energies`` (the reference's
``load_mesh_compute_energies``): per-triangle areas from the cross
product, face means of the vertex K and H, bending Σ H_f² A_f,
stretching Σ K_f A_f and total area Σ A_f, with ``nansum`` semantics
for the two energies; vertex areas (a third of each face) and the
angle-deficit K and cotangent-Laplacian H of each vertex. All functions
run on the tensors' device; an optional (T,) bool ``face_mask`` makes
padding faces contribute nothing.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class MeshEnergies(NamedTuple):
    bending: torch.Tensor       # Σ H_f² A_f
    stretching: torch.Tensor    # Σ K_f A_f
    total_area: torch.Tensor    # Σ A_f


def _corners(vertices: torch.Tensor, faces: torch.Tensor):
    f = faces.long()
    return f, vertices[f[:, 0]], vertices[f[:, 1]], vertices[f[:, 2]]


def triangle_areas(vertices: torch.Tensor, faces: torch.Tensor,
                   face_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(V,3) float32, (T,3) int -> (T,) areas, 0.5·|cross|."""
    _, v0, v1, v2 = _corners(vertices, faces)
    cr = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    area = 0.5 * torch.sqrt(torch.clamp_min(torch.sum(cr * cr, dim=-1), 0.0))
    if face_mask is not None:
        area = torch.where(face_mask, area, 0.0)
    return area


def mesh_energies(vertices: torch.Tensor, faces: torch.Tensor,
                  K_vertex: torch.Tensor, H_vertex: torch.Tensor,
                  face_mask: torch.Tensor | None = None) -> MeshEnergies:
    """NaN-tolerant energy integrals: a face whose mean K (or H) is NaN
    drops out of that energy's sum; the area sums every face."""
    area = triangle_areas(vertices, faces, face_mask)
    f = faces.long()
    K_f = torch.mean(K_vertex[f], dim=1)
    H_f = torch.mean(H_vertex[f], dim=1)
    return MeshEnergies(torch.nansum(H_f * H_f * area),
                        torch.nansum(K_f * area), torch.sum(area))


def vertex_areas(vertices: torch.Tensor, faces: torch.Tensor,
                 face_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(V,) barycentric dual areas: each face gives A/3 to its vertices."""
    third = triangle_areas(vertices, faces, face_mask) / 3.0
    f = faces.long()
    v = torch.zeros(vertices.shape[0], dtype=vertices.dtype,
                    device=vertices.device)
    for i in range(3):
        v.index_add_(0, f[:, i], third)
    return v


def _cot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cotangent of the angle between edge vectors a, b (batched)."""
    cross = torch.linalg.cross(a, b, dim=-1)
    sin = torch.sqrt(torch.clamp_min(torch.sum(cross * cross, dim=-1), 1e-30))
    return torch.sum(a * b, dim=-1) / sin


def _angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an = a / torch.clamp_min(torch.linalg.vector_norm(a, dim=-1,
                                                      keepdim=True), 1e-30)
    bn = b / torch.clamp_min(torch.linalg.vector_norm(b, dim=-1,
                                                      keepdim=True), 1e-30)
    return torch.arccos(torch.clamp(torch.sum(an * bn, dim=-1), -1.0, 1.0))


def mesh_vertex_curvatures(vertices: torch.Tensor, faces: torch.Tensor,
                           face_mask: torch.Tensor | None = None):
    """Discrete (K, H) per vertex from the mesh itself: K the angle
    deficit (2π − Σ incident angles) over the dual area, H half the norm
    of the cotangent-Laplacian mean-curvature normal."""
    V = vertices.shape[0]
    f, p0, p1, p2 = _corners(vertices, faces)

    def masked(x):
        return x if face_mask is None else torch.where(face_mask, x, 0.0)

    angle_sum = torch.zeros(V, dtype=vertices.dtype, device=vertices.device)
    for i, a in enumerate((masked(_angle(p1 - p0, p2 - p0)),
                           masked(_angle(p2 - p1, p0 - p1)),
                           masked(_angle(p0 - p2, p1 - p2)))):
        angle_sum.index_add_(0, f[:, i], a)
    safe_dual = torch.clamp_min(vertex_areas(vertices, faces, face_mask),
                                1e-30)
    K = (2.0 * math.pi - angle_sum) / safe_dual

    # cotangent Laplacian: Δp_i = (1/2A_i) Σ_j (cot α + cot β)(p_j − p_i)
    cot0 = masked(_cot(p1 - p0, p2 - p0))   # angle at v0, opposite (1,2)
    cot1 = masked(_cot(p2 - p1, p0 - p1))   # at v1, opposite (2,0)
    cot2 = masked(_cot(p0 - p2, p1 - p2))   # at v2, opposite (0,1)
    lap = torch.zeros_like(vertices)
    for i, j, c in ((1, 2, cot0), (2, 0, cot1), (0, 1, cot2)):
        vi, vj = f[:, i], f[:, j]
        d = (vertices[vj] - vertices[vi]) * c[:, None]
        lap.index_add_(0, vi, d)
        lap.index_add_(0, vj, -d)
    Hn = lap / (4.0 * safe_dual[:, None])
    return K, torch.linalg.vector_norm(Hn, dim=-1)
