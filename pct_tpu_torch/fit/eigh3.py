"""Closed-form batched symmetric 3×3 eigensolver (elementwise).

Port of ``pct_tpu.fit.eigh3``: Cardano/trigonometric eigenvalues plus
cross-row eigenvectors, all elementwise over the batch, with Frobenius
pre-normalization so every threshold works at O(1) scale. Eigenvalues
ascending, eigenvectors in columns (``numpy.linalg.eigh`` conventions,
up to sign). The determinant is written out (no batched LU).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def _det3(B: torch.Tensor) -> torch.Tensor:
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))


def _eye3(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=A.dtype, device=A.device)


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3), ascending."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * _eye3(A)
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 0.0))
    safe_p = torch.clamp_min(p, _EPS)
    r = torch.clamp(_det3(B) / (2.0 * safe_p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_hi - lam_lo
    return torch.stack([lam_lo, lam_mid, lam_hi], dim=-1)


def _eigvec_raw(A: torch.Tensor, lam: torch.Tensor):
    """Cross-row eigenvector candidate + quality (norm² of the best
    cross); quality ~0 means ``lam`` is (near-)degenerate."""
    M = A - lam[..., None, None] * _eye3(A)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    quality = torch.maximum(torch.maximum(n01, n02), n12)
    norm = torch.sqrt(torch.clamp_min(quality, _EPS))[..., None]
    return best / norm, quality


def _axis(v: torch.Tensor, i: int) -> torch.Tensor:
    e = torch.zeros(3, dtype=v.dtype, device=v.device)
    e[i] = 1.0
    return e.expand(v.shape)


def _any_perp(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to unit v (axis least aligned with v)."""
    cx, cy = _cross(v, _axis(v, 0)), _cross(v, _axis(v, 1))
    nx = torch.sum(cx * cx, dim=-1, keepdim=True)
    ny = torch.sum(cy * cy, dim=-1, keepdim=True)
    best = torch.where(nx >= ny, cx, cy)
    return best / torch.sqrt(torch.clamp_min(torch.maximum(nx, ny), _EPS))


def _fro_scale(A: torch.Tensor) -> torch.Tensor:
    """Frobenius-norm scale: without it, covariances of mm-scale
    neighborhoods (~1e-5) drop the cross-row quality below any absolute
    epsilon and every eigenvector silently falls back."""
    s = torch.sqrt(torch.sum(A * A, dim=(-2, -1)))
    return torch.clamp_min(s, 1e-30)[..., None, None]


def eigh3(A: torch.Tensor):
    """(w ascending (...,3), V (...,3,3) column eigenvectors).

    The extreme eigenvalue with the larger spectral gap gets the
    cross-row vector; the other extreme is orthogonalized against it.
    Fully isotropic input returns the canonical basis.
    """
    s = _fro_scale(A)
    A = A / s
    w = eigvalsh3(A)
    v_lo_raw, q_lo = _eigvec_raw(A, w[..., 0])
    v_hi_raw, q_hi = _eigvec_raw(A, w[..., 2])
    ez = _axis(w, 2)
    lo_better = (q_lo >= q_hi)[..., None]
    anchor = torch.where(lo_better, v_lo_raw, v_hi_raw)
    anchor = torch.where((torch.maximum(q_lo, q_hi) > _EPS)[..., None],
                         anchor, ez)
    other_raw = torch.where(lo_better, v_hi_raw, v_lo_raw)
    other = other_raw - torch.sum(other_raw * anchor, dim=-1,
                                  keepdim=True) * anchor
    on = torch.sum(other * other, dim=-1, keepdim=True)
    other = torch.where(on > 1e-12,
                        other / torch.sqrt(torch.clamp_min(on, _EPS)),
                        _any_perp(anchor))
    v_lo = torch.where(lo_better, anchor, other)
    v_hi = torch.where(lo_better, other, anchor)
    v_mid = _cross(v_hi, v_lo)
    return w * s[..., 0], torch.stack([v_lo, v_mid, v_hi], dim=-1)


def smallest_eigvec3(A: torch.Tensor):
    """(λ_min, unit eigenvector) of symmetric (...,3,3) — the normal path.
    Isotropic input falls back to +z (any direction is an eigenvector)."""
    s = _fro_scale(A)
    A = A / s
    w = eigvalsh3(A)
    v, q = _eigvec_raw(A, w[..., 0])
    v = torch.where((q > _EPS)[..., None], v, _axis(v, 2))
    return w[..., 0] * s[..., 0, 0], v
