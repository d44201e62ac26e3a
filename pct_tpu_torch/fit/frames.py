"""Batched tangent frames: covariance → normal → sign fix → Rodrigues
rotation of the neighborhood into the tangent plane.

Port of ``pct_tpu.fit.frames`` (the reference's per-point
``get_best_fit_plane_and_rotate``):

- covariance of the query-centered neighborhood, mean-subtracted again
  and divided by (k - 1) (``np.cov`` semantics);
- normal = eigenvector of the smallest eigenvalue (closed-form 3×3);
- sign fix: flip the normal when its dot with ``pts[-1] - pts[0]`` (the
  farthest minus the nearest neighbor; slots are distance-sorted) is
  negative; with a mask, the farthest VALID slot stands for ``pts[-1]``;
- Rodrigues rotation R = I + K + K²(1-c)/s² taking the normal to +z,
  identity when s < 1e-8 (also for a normal of exactly -z: the
  reference's quirk, kept).

All elementwise over the leading axes — no batched 3×3 matmuls. An
optional (..., k) bool ``mask`` makes padded neighbor slots inert, with
the JAX package's masked formulas; without one, the unmasked path runs.
"""

from __future__ import annotations

import torch

from pct_tpu_torch.fit.eigh3 import smallest_eigvec3


def neighborhood_covariance(centered: torch.Tensor,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """(..., k, 3) centered neighborhoods -> (..., 3, 3) covariance. With
    a (..., k) bool ``mask``, over the valid slots only: their mean, and
    the divisor from their count (both counts clamped to at least 1)."""
    x, y, z = centered[..., 0], centered[..., 1], centered[..., 2]
    if mask is None:
        cnt = centered.shape[-2]
        inv = 1.0 / max(cnt, 1)
        x = x - (torch.sum(x, -1) * inv)[..., None]
        y = y - (torch.sum(y, -1) * inv)[..., None]
        z = z - (torch.sum(z, -1) * inv)[..., None]
        f = 1.0 / max(cnt - 1.0, 1.0)
    else:
        m = torch.broadcast_to(mask, centered.shape[:-1]).to(centered.dtype)
        cnt = torch.clamp_min(torch.sum(m, -1), 1.0)
        # the same strided layout as the unmasked sums: an all-True mask
        # then reduces in the same order and gives the same bits
        cm = centered * m[..., None]
        x, y, z = cm[..., 0], cm[..., 1], cm[..., 2]
        inv = 1.0 / cnt
        x = (x - (torch.sum(x, -1) * inv)[..., None]) * m
        y = (y - (torch.sum(y, -1) * inv)[..., None]) * m
        z = (z - (torch.sum(z, -1) * inv)[..., None]) * m
        f = 1.0 / torch.clamp_min(cnt - 1.0, 1.0)
    sxx, syy, szz = (torch.sum(x * x, -1) * f, torch.sum(y * y, -1) * f,
                     torch.sum(z * z, -1) * f)
    sxy, sxz, syz = (torch.sum(x * y, -1) * f, torch.sum(x * z, -1) * f,
                     torch.sum(y * z, -1) * f)
    return torch.stack([
        torch.stack([sxx, sxy, sxz], -1),
        torch.stack([sxy, syy, syz], -1),
        torch.stack([sxz, syz, szz], -1),
    ], dim=-2)


def estimate_normals(centered: torch.Tensor,
                     mask: torch.Tensor | None = None):
    """(..., k, 3) -> (normal (...,3) sign-fixed, λ_min (...,)). With a
    mask the sign reference is the farthest valid slot, ``last =
    max(where(mask, slot, -1))`` clamped to 0, minus slot 0."""
    lam, n = smallest_eigvec3(neighborhood_covariance(centered, mask))
    if mask is None:
        far = centered[..., -1, :]
    else:
        slots = torch.arange(centered.shape[-2], device=centered.device)
        last = torch.clamp_min(torch.max(torch.where(mask, slots, -1),
                                         dim=-1).values, 0)
        last = torch.broadcast_to(last, centered.shape[:-2])
        far = torch.gather(centered, -2, last[..., None, None].expand(
            last.shape + (1, 3)))[..., 0, :]
    ref_vec = far - centered[..., 0, :]
    flip = torch.sum(n * ref_vec, dim=-1) < 0.0
    return torch.where(flip[..., None], -n, n), lam


def rodrigues_to_z(normal: torch.Tensor) -> torch.Tensor:
    """(...,3) unit normals -> (...,3,3) rotation R with R @ n = +z.

    K = skew(v), v = n × z = (n_y, -n_x, 0); K² = v vᵀ − |v|² I is
    written out elementwise.
    """
    vx, vy = normal[..., 1], -normal[..., 0]
    s2 = vx * vx + vy * vy
    c = normal[..., 2]
    zero = torch.zeros_like(c)
    fac = (1.0 - c) / torch.clamp_min(s2, 1e-20)
    K = torch.stack([
        torch.stack([zero, zero, vy], -1),
        torch.stack([zero, zero, -vx], -1),
        torch.stack([-vy, vx, zero], -1),
    ], dim=-2)
    K2 = torch.stack([
        torch.stack([vx * vx - s2, vx * vy, zero], -1),
        torch.stack([vx * vy, vy * vy - s2, zero], -1),
        torch.stack([zero, zero, -s2], -1),
    ], dim=-2)
    eye = torch.eye(3, dtype=normal.dtype, device=normal.device)
    R = eye + K + K2 * fac[..., None, None]
    small = (torch.sqrt(torch.clamp_min(s2, 0.0)) < 1e-8)[..., None, None]
    return torch.where(small, eye, R)


def tangent_frames(centered: torch.Tensor, mask: torch.Tensor | None = None):
    """(rotated (...,k,3), R (...,3,3), normal (...,3)): the neighborhood
    expressed with its best-fit plane as the xy-plane (rotated = pts Rᵀ),
    the frame from the slots where ``mask`` is True (every slot is
    rotated).

    R p is applied as p + v×p + fac·v×(v×p), the same formula and
    fallback as ``rodrigues_to_z``.
    """
    normal, _ = estimate_normals(centered, mask)
    R = rodrigues_to_z(normal)
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    vx, vy = ny, -nx
    s2 = vx * vx + vy * vy
    fac = ((1.0 - nz) / torch.clamp_min(s2, 1e-20))[..., None]
    small = (torch.sqrt(s2) < 1e-8)[..., None]
    px, py, pz = centered[..., 0], centered[..., 1], centered[..., 2]
    vxe, vye = vx[..., None], vy[..., None]
    kp_x = vye * pz
    kp_y = -vxe * pz
    kp_z = vxe * py - vye * px
    k2p_x = vye * kp_z
    k2p_y = -vxe * kp_z
    k2p_z = vxe * kp_y - vye * kp_x
    a = torch.where(small, px, px + kp_x + fac * k2p_x)
    b = torch.where(small, py, py + kp_y + fac * k2p_y)
    c = torch.where(small, pz, pz + kp_z + fac * k2p_z)
    return torch.stack([a, b, c], dim=-1), R, normal
