"""Curvature from neighborhood MOMENTS: the large-k fit path.

Port of ``pct_tpu.fit.moments``. The reference's chain (frames → fit →
curvature) needs, per query, only order-invariant sums of the
neighborhood plus two specific points (the nearest and the kth, for the
normal's sign fix):

- the 3×3 covariance                           — degree ≤ 2 moments;
- the quadratic fit's 6×6 normal equations     — degree ≤ 4 moments of
  the ROTATED coordinates.

Rotated moments are linear images of raw moments: with s = R·r,
Σ w·s^β = Σ_α c_αβ(R) · Σ w·r^α. So the moments kernel
(``ops.moments.knn_moments``) reduces each query's k nearest to 35
monomial sums, and this module turns those sums into the same chain.

Divergences from the list-based path (as in the JAX package):
- distance ties at the kth boundary get fractional weight
  (k − count_lt)/count_eq instead of first-in-candidate-order membership;
- the anisotropic preconditioning of the fit uses the tangent RMS extent
  instead of the max extent (the max is not a moment); preconditioning
  changes rounding, not the least-squares optimum.

``curvature_from_moments`` runs the whole chain through
``ops.epilogue.moments_epilogue``: one launch of the epilogue kernel on
CUDA tensors, its plain version on CPU tensors, both with the rotation
contracted one row at a time in symmetric storage and every sum in a
fixed order. ``covariance_from_moments``, ``rotated_moments`` (the
stepwise einsum contraction) and ``fit_quadratic_from_moments`` are the
chain's steps as the JAX package has them; the JAX package's symbolic
per-term expansion exists to keep an XLA compile small and has no use
here. The einsums run in full float32: TF32 is off
(``pct_tpu_torch/__init__.py``).
"""

from __future__ import annotations

import math

import torch

from pct_tpu_torch.curvature.explicit import Curvatures
from pct_tpu_torch.fit.layout import (  # noqa: F401  (the layout's home)
    _IDX,
    MOMENT_EXPS,
    NUM_MOMENTS,
    moment_index,
)
from pct_tpu_torch.fit.quadratic import _RIDGE, cholesky_solve
from pct_tpu_torch.ops.epilogue import NIN, epilogue_plain, moments_epilogue

def neighborhood_moments(centered: torch.Tensor, weights: torch.Tensor,
                         sigma: torch.Tensor) -> torch.Tensor:
    """Reference moment accumulator over explicit neighborhoods.

    centered: (..., k, 3) neighborhoods r_i = p_i - q
    weights:  (..., k) per-neighbor weights (1 for members, fractional
              at kth-distance ties, 0 otherwise)
    sigma:    (...,) per-query scale (the kth distance); the moments are
              of r̂ = r/σ, so every entry is O(1) in float32.
    Returns (..., NUM_MOMENTS).
    """
    s = torch.clamp_min(sigma, 1e-30)[..., None]
    # members satisfy |r|/σ <= 1; non-members (w = 0) may be far away:
    # the clamp keeps w·x̂⁴ from becoming 0·inf
    xh = torch.clamp(centered[..., 0] / s, -2.0, 2.0)
    yh = torch.clamp(centered[..., 1] / s, -2.0, 2.0)
    zh = torch.clamp(centered[..., 2] / s, -2.0, 2.0)
    out = []
    for (a, b, c) in MOMENT_EXPS:
        mono = weights
        for _ in range(a):
            mono = mono * xh
        for _ in range(b):
            mono = mono * yh
        for _ in range(c):
            mono = mono * zh
        out.append(torch.sum(mono, dim=-1))
    return torch.stack(out, dim=-1)


def _moment_tensors(m: torch.Tensor):
    """Moment vector -> dense symmetric moment tensors M1 (...,3),
    M2 (...,3,3), M3 (...,3,3,3), M4 (...,3,3,3,3): tensor entry
    (i1..id) is the moment whose exponent is the index multiset."""
    def idx(*axes):
        e = [0, 0, 0]
        for a in axes:
            e[a] += 1
        return _IDX[tuple(e)]

    r3 = range(3)
    lead = m.shape[:-1]
    M1 = m[..., [idx(i) for i in r3]]
    M2 = m[..., [idx(i, j) for i in r3 for j in r3]].reshape(lead + (3, 3))
    M3 = m[..., [idx(i, j, k) for i in r3 for j in r3 for k in r3]
           ].reshape(lead + (3, 3, 3))
    M4 = m[..., [idx(i, j, k, l) for i in r3 for j in r3 for k in r3
                 for l in r3]].reshape(lead + (3, 3, 3, 3))
    return M1, M2, M3, M4


def rotated_moments(m: torch.Tensor, R: torch.Tensor) -> dict:
    """s-moments Σ w·(R r̂)^β needed by the quadratic fit.

    m: (..., NUM_MOMENTS) raw moments; R: (..., 3, 3) with s = R r̂.
    Returns {(a, b, c): (...) tensor} for all (a,b,0) with a+b <= 4 and
    (a,b,1) with a+b <= 2: the 21 moments of the 6×6 normal equations.

    Degree-d tensor contractions S_d = R^{⊗d}·M_d, ONE R factor at a
    time: a joint contraction would build the R⊗R⊗R⊗R outer product
    (6561 floats a row); the stepwise form's largest intermediate is the
    81-float M4 itself.
    """
    M1, M2, M3, M4 = _moment_tensors(m)
    ein = torch.einsum
    S1 = ein("...ai,...i->...a", R, M1)
    t2 = ein("...bj,...ij->...ib", R, M2)
    S2 = ein("...ai,...ib->...ab", R, t2)
    t3 = ein("...ck,...ijk->...ijc", R, M3)
    t3 = ein("...bj,...ijc->...ibc", R, t3)
    S3 = ein("...ai,...ibc->...abc", R, t3)
    t4 = ein("...dl,...ijkl->...ijkd", R, M4)
    t4 = ein("...ck,...ijkd->...ijcd", R, t4)
    t4 = ein("...bj,...ijcd->...ibcd", R, t4)
    S4 = ein("...ai,...ibcd->...abcd", R, t4)
    S = {(0, 0, 0): m[..., _IDX[(0, 0, 0)]]}
    for (a, b, c) in [(1, 0, 0), (0, 1, 0), (0, 0, 1)]:
        S[(a, b, c)] = S1[(Ellipsis,) + tuple([0] * a + [1] * b + [2] * c)]
    for d, t in ((2, S2), (3, S3), (4, S4)):
        for a in range(d + 1):
            for b in range(d - a + 1):
                c = d - a - b
                if c > 1 or (c == 1 and a + b > 2):
                    continue  # the fit never reads these
                S[(a, b, c)] = t[(Ellipsis,)
                                 + tuple([0] * a + [1] * b + [2] * c)]
    return S


_PHI = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))  # [a²,b²,ab,a,b,1]


def fit_quadratic_from_moments(S: dict, cnt: torch.Tensor,
                               sigma: torch.Tensor) -> torch.Tensor:
    """6 Monge coefficients (true, unscaled units) from s-moments of the
    σ-scaled rotated neighborhood: ``fit_quadratic``'s normal equations,
    relative ridge and unrolled Cholesky, with RMS anisotropic
    preconditioning."""
    cnt = torch.clamp_min(cnt, 1.0)
    sa = torch.sqrt(torch.clamp_min(S[(2, 0, 0)] / cnt, 1e-20))
    sb = torch.sqrt(torch.clamp_min(S[(0, 2, 0)] / cnt, 1e-20))
    inv_a, inv_b = 1.0 / sa, 1.0 / sb

    def scaled(a, b, c):
        return S[(a, b, c)] * inv_a**a * inv_b**b

    Gq = [[None] * 6 for _ in range(6)]
    rhs = [None] * 6
    for i, (ai, bi) in enumerate(_PHI):
        for j, (aj, bj) in enumerate(_PHI[i:], start=i):
            Gq[i][j] = Gq[j][i] = scaled(ai + aj, bi + bj, 0)
        rhs[i] = scaled(ai, bi, 1)
    G = torch.stack([torch.stack(Gq[i], dim=-1) for i in range(6)], dim=-2)
    rhs = torch.stack(rhs, dim=-1)
    trace = G.diagonal(dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(6, dtype=G.dtype, device=G.device)
    G = G + (_RIDGE * trace[..., None, None] / 6.0) * eye
    c = cholesky_solve(G, rhs)
    # undo the anisotropic scale, then the σ scale (s = σ·ŝ):
    # A = Â/(sa²σ), B = B̂/(sb²σ), C = Ĉ/(sa·sb·σ), D = D̂/sa, E = Ê/sb,
    # F = F̂·σ
    s = torch.clamp_min(sigma, 1e-30)
    scale_back = torch.stack([
        inv_a * inv_a / s, inv_b * inv_b / s, inv_a * inv_b / s,
        inv_a, inv_b, s,
    ], dim=-1)
    return c * scale_back


def covariance_from_moments(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) neighborhood covariance (mean-centered, /(cnt-1)) from
    the degree ≤ 2 raw moments; the σ² scale is dropped (eigenvectors
    are scale-invariant)."""
    cnt = torch.clamp_min(m[..., _IDX[(0, 0, 0)]], 1.0)
    mu = torch.stack([m[..., _IDX[(1, 0, 0)]], m[..., _IDX[(0, 1, 0)]],
                      m[..., _IDX[(0, 0, 1)]]], dim=-1) / cnt[..., None]
    f = 1.0 / torch.clamp_min(cnt - 1.0, 1.0)

    def cov(e, i, j):
        return (m[..., _IDX[e]] - cnt * mu[..., i] * mu[..., j]) * f

    sxx = cov((2, 0, 0), 0, 0)
    syy = cov((0, 2, 0), 1, 1)
    szz = cov((0, 0, 2), 2, 2)
    sxy = cov((1, 1, 0), 0, 1)
    sxz = cov((1, 0, 1), 0, 2)
    syz = cov((0, 1, 1), 1, 2)
    return torch.stack([
        torch.stack([sxx, sxy, sxz], -1),
        torch.stack([sxy, syy, syz], -1),
        torch.stack([sxz, syz, szz], -1),
    ], dim=-2)


def curvature_from_moments(m: torch.Tensor, sigma: torch.Tensor,
                           nearest: torch.Tensor, kth_pt: torch.Tensor,
                           rotation: str = "symbolic"):
    """Moments → (Curvatures, normals): the same chain as
    tangent_frames + fit_quadratic + explicit_curvatures, over the
    leading axes of m (..., 35) and sigma (...,), as one epilogue call.

    float32 operands take ``ops.epilogue.moments_epilogue`` (one kernel
    launch on the card, its plain version on the CPU); any other
    floating dtype takes the plain version in that dtype, on the
    operands' device, so the outputs keep the operands' dtype.

    nearest/kth_pt: (..., 3) offsets p - q of the nearest and the kth
    neighbor (unscaled), for the reference's sign fix pts[-1] - pts[0].
    ``rotation`` is accepted for the JAX package's signature: the port
    has one contraction for every value.
    """
    lead = m.shape[:-1]
    rows = math.prod(lead)
    stats = m.new_zeros((rows, NIN))
    stats[:, :NUM_MOMENTS] = m.reshape(rows, NUM_MOMENTS)
    stats[:, 38] = sigma.reshape(rows)
    stats[:, 39:42] = nearest.reshape(rows, 3)
    stats[:, 42:45] = kth_pt.reshape(rows, 3)
    epilogue = (moments_epilogue if stats.dtype == torch.float32
                else epilogue_plain)
    out = epilogue(stats).reshape(lead + (-1,))
    return Curvatures(*out[..., :5].unbind(-1)), out[..., 5:]


def curvature_from_moments_chunked(m: torch.Tensor, sigma: torch.Tensor,
                                   nearest: torch.Tensor,
                                   kth_pt: torch.Tensor,
                                   chunk: int = 1 << 18,
                                   rotation: str = "symbolic"):
    """``curvature_from_moments`` over (N, ...) rows. ``chunk`` and
    ``rotation`` are accepted for the JAX package's signature: the
    epilogue keeps no intermediate that grows with the rows beyond its
    (N, 48) operand, so every N is one call."""
    del chunk
    return curvature_from_moments(m, sigma, nearest, kth_pt)
