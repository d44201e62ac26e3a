"""Taubin λ|μ smoothing on the device.

Port of ``pct_tpu.mesh.smooth`` (the reference's Open3D
``filter_smooth_taubin(number_of_iterations=10)``): the umbrella
(uniform) Laplacian is two scatter-adds over the directed edge list,
here ``index_add_``, alternated as a shrink (λ) and an inflate (μ) step.
On the card ``index_add_`` adds with float atomics, so its summation
order, and the last bits of the result, vary from run to run.
"""

from __future__ import annotations

import torch


def mesh_edges(faces: torch.Tensor) -> torch.Tensor:
    """(T,3) int -> (3T, 2) directed edge list (with duplicates)."""
    return torch.cat([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]],
                     dim=0)


def taubin_smooth(vertices: torch.Tensor, faces: torch.Tensor,
                  iterations: int = 10, lam: float = 0.5, mu: float = -0.53,
                  vertex_mask: torch.Tensor | None = None,
                  face_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Open3D's defaults: λ=0.5, μ=−0.53, 10 iterations; returns the
    smoothed (V,3) vertices. Runs on the tensors' device.

    ``face_mask`` (T,) bool makes padding faces contribute nothing, so a
    face list padded to a size class gives the unpadded result;
    ``vertex_mask`` (V,) bool freezes the vertices where it is False.
    Vertices on no face (degree 0) stay put.
    """
    V = vertices.shape[0]
    e = mesh_edges(faces).long()
    src, dst = e[:, 0], e[:, 1]
    if face_mask is not None:
        w = face_mask.to(vertices.dtype).repeat(3)
    else:
        w = torch.ones(e.shape[0], dtype=vertices.dtype,
                       device=vertices.device)
    deg = torch.zeros(V, dtype=vertices.dtype, device=vertices.device)
    deg.index_add_(0, src, w).index_add_(0, dst, w)
    safe_deg = torch.clamp_min(deg, 1.0)[:, None]
    w3 = w[:, None]

    def umbrella(v):
        acc = torch.zeros_like(v)
        acc.index_add_(0, src, v[dst] * w3).index_add_(0, dst, v[src] * w3)
        delta = torch.where(deg[:, None] > 0, acc / safe_deg - v, 0.0)
        if vertex_mask is not None:
            delta = torch.where(vertex_mask[:, None], delta, 0.0)
        return delta

    v = vertices
    for _ in range(iterations):
        v = v + lam * umbrella(v)
        v = v + mu * umbrella(v)
    return v
