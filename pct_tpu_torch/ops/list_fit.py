"""The list engine's explicit fit: the coords select's winners (..., k, 3)
and their query points (..., 3) -> (..., 8) curvature, one row at a time.

The chain is ``curvature_pipeline.neighborhood_curvature``'s explicit
method (``tangent_frames`` → ``fit_quadratic`` → ``explicit_curvatures``)
on the query-centred neighbourhood ``nbrs − q``, with its constants and
guards: the covariance over k − 1 (``np.cov``), ``smallest_eigvec3``
(Frobenius scale, Cardano, cross-row vector, +z fallback), the sign fix
on slot k−1 minus slot 0, the Rodrigues rotation with the |n × z| < 1e-8
identity, each tangent axis scaled by its largest extent, the ridged
6×6 normal equations with the dead-pivot Cholesky, the scale-back and
the Monge curvatures. ``found`` plays no part: every slot counts, as in
the reference. It is written as a fixed sequence of separately rounded
float32 operations: every sum over the k slots adds slot after slot,
from slot 0 (one add a slot over a (rows, ...) tensor), every sum of
more than two terms left to right, and the steps the moments route's
epilogue shares (eigenvector, sign fix, rotation, ridge and solve,
curvatures) are ``ops.epilogue``'s helpers.

Output (..., 8) float32: K, H, k1, k2, H², nx, ny, nz (``ops.epilogue``'s
layout).

On CUDA tensors the hand-written kernel ``csrc/list_fit.cu`` runs (one
launch, built with nvcc at first use); on CPU tensors the plain version
``list_fit_plain``. The kernel repeats the plain version's operations one
for one with the ``_rn`` intrinsics and libdevice's ``acosf``, ``cosf``
and ``powf``, which PyTorch's CUDA ``arccos``, ``cos`` and ``pow`` call:
on the card the two agree bit for bit. On the CPU the transcendentals are
the CPU's own, so the plain version there agrees with the card to
rounding only. Divisions are true divisions by a tensor (see
``ops.epilogue``).
"""

from __future__ import annotations

import ctypes

import torch

from pct_tpu_torch.ops import build
from pct_tpu_torch.ops.epilogue import (
    NOUT,
    _add_ridge,
    _curvatures,
    _div,
    _eigvec_min,
    _rotation,
    _sign_fix,
    _solve,
    _sum,
)

# cols = [a², b², ab, a, b] (the design's 1 is implicit): the fit's sums
# are cols_i·cols_j for i <= j, cols_i, cols_i·z and z
_PAIRS = tuple((i, j) for i in range(5) for j in range(i, 5))


def _slot_sum(t: torch.Tensor) -> torch.Tensor:
    """(rows, k, ...) -> (rows, ...): ((t0 + t1) + t2) + … over the slots."""
    acc = t[:, 0]
    for j in range(1, t.shape[1]):
        acc = acc + t[:, j]
    return acc


def list_fit_plain(nbrs: torch.Tensor, qpts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (..., k, 3) winners and (...,
    3) queries -> (..., 8), on the tensors' device."""
    k = nbrs.shape[-2]
    c = (nbrs - qpts[..., None, :]).reshape(-1, k, 3)
    # the covariance of the centred slots (np.cov: over max(k − 1, 1))
    mu = _div(_slot_sum(c), float(k))
    dx, dy, dz = (c - mu[:, None, :]).unbind(-1)
    cov = _div(_slot_sum(torch.stack(
        [dx * dx, dx * dy, dx * dz, dy * dy, dy * dz, dz * dz], -1)),
        float(max(k - 1, 1)))
    n = _eigvec_min(*cov.unbind(-1))
    n = _sign_fix(n, c[:, -1].unbind(-1), c[:, 0].unbind(-1))
    # every slot rotated; each tangent axis scaled by its largest extent
    px, py, pz = c.unbind(-1)
    ax, ay, z = (_sum(r[0][:, None] * px, r[1][:, None] * py,
                      r[2][:, None] * pz) for r in _rotation(*n))
    sa = torch.sqrt(torch.clamp_min(torch.amax(ax * ax, -1), 1e-20))
    sb = torch.sqrt(torch.clamp_min(torch.amax(ay * ay, -1), 1e-20))
    a, b = _div(ax, sa[:, None]), _div(ay, sb[:, None])
    cols = (a * a, b * b, a * b, a, b)
    terms = ([cols[i] * cols[j] for i, j in _PAIRS] + list(cols)
             + [col * z for col in cols] + [z])
    g = list(_slot_sum(torch.stack(terms, -1)).unbind(-1))
    G = [[None] * 6 for _ in range(6)]
    for i, j in _PAIRS:
        G[i][j] = G[j][i] = g.pop(0)
    for i in range(5):
        G[i][5] = G[5][i] = g.pop(0)
    G[5][5] = torch.full_like(sa, float(k))
    _add_ridge(G)
    x, _ = _solve(G, g)
    # the scale-back to the rotated frame's units
    coeffs = (x[0] * torch.reciprocal(sa * sa),
              x[1] * torch.reciprocal(sb * sb),
              x[2] * torch.reciprocal(sa * sb),
              x[3] * torch.reciprocal(sa), x[4] * torch.reciprocal(sb))
    out = torch.stack([*_curvatures(*coeffs), *n], dim=1)
    return out.reshape(qpts.shape[:-1] + (NOUT,))


def _check(nbrs: torch.Tensor, qpts: torch.Tensor):
    for name, t in (("nbrs", nbrs), ("qpts", qpts)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (nbrs.dim() < 2 or nbrs.shape[-1] != 3 or nbrs.shape[-2] < 1
            or tuple(qpts.shape) != tuple(nbrs.shape[:-2]) + (3,)):
        raise ValueError(f"nbrs must be (..., k, 3) with k >= 1 and qpts "
                         f"(..., 3), got {tuple(nbrs.shape)} and "
                         f"{tuple(qpts.shape)}")
    if nbrs.device != qpts.device:
        raise ValueError(f"nbrs on {nbrs.device}, qpts on {qpts.device}")


def list_fit_layout(k: int) -> int:
    """The kernel's variant at k (card only: builds ``csrc/list_fit.cu``):
    rows a block, positive where the block stages its rows' winners in
    shared memory, negative where each row streams from device memory."""
    fn = build.load("list_fit").pct_list_fit_layout
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return int(fn(k))


def list_fit(nbrs: torch.Tensor, qpts: torch.Tensor) -> torch.Tensor:
    """(..., k, 3) winners and (..., 3) queries -> (..., 8) float32 K, H,
    k1, k2, H², nx, ny, nz. CUDA tensors launch
    ``csrc/list_fit.cu:pct_list_fit`` once; CPU tensors run
    ``list_fit_plain``."""
    _check(nbrs, qpts)
    dev = nbrs.device
    if dev.type == "cpu":
        return list_fit_plain(nbrs, qpts)
    rows, k = qpts.numel() // 3, nbrs.shape[-2]
    out = torch.empty(qpts.shape[:-1] + (NOUT,), dtype=torch.float32,
                      device=dev)
    if rows > 0:
        build.kernel("list_fit", "pct_list_fit")(nbrs, qpts, out, rows, k)
    return out
