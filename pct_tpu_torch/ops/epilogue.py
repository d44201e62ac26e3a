"""The moments route's epilogue: (rows, 48) moment stats -> (rows, 8)
curvature, one row at a time.

The chain is ``fit.moments.curvature_from_moments``' (covariance from
the moments → ``smallest_eigvec3`` → the sign fix on kth − nearest →
``rodrigues_to_z`` → the rotated moments → ``fit_quadratic_from_moments``
→ ``explicit_curvatures``), with its constants and guards, written as a
fixed sequence of separately rounded float32 elementwise operations:
no einsum, matmul or sum over a dimension, and every sum of more than
two terms added left to right, ((a + b) + c). The rotated moments are
the 21 that the fit reads, each contracted from the symmetric raw
moments one rotation row at a time (z rows first, then y, then x), so
no (3,3,3,3) tensor is formed.

Input: the layout of ``ops.moments`` ([0:35] moments, [38] σ, [39:42]
nearest offset, [42:45] kth offset; the other columns are not read).
Output (rows, 8) float32: K, H, k1, k2, H², nx, ny, nz.

On CUDA tensors the hand-written kernel ``csrc/epilogue.cu`` runs (one
launch, built with nvcc at first use); on CPU tensors the plain version
``epilogue_plain``. The kernel repeats the plain version's operations
one for one with the ``_rn`` intrinsics and libdevice's ``acosf``,
``cosf`` and ``powf``, which PyTorch's CUDA ``arccos``, ``cos`` and
``pow`` call: on the card the two agree bit for bit. On the CPU the
transcendentals are the CPU's own, so the plain version there agrees
with the card to rounding only.

Every division is a true division by a tensor: on CUDA, PyTorch divides
by a Python number as a product with its reciprocal, which rounds
differently from the kernel's ``__fdiv_rn``.
"""

from __future__ import annotations

import math

import torch

from pct_tpu_torch.fit.eigh3 import _EPS
from pct_tpu_torch.fit.layout import MOMENT_EXPS
from pct_tpu_torch.fit.quadratic import _RIDGE
from pct_tpu_torch.ops import build

NIN = 48
NOUT = 8
_IDX = {e: i for i, e in enumerate(MOMENT_EXPS)}
_PHI = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))  # [a²,b²,ab,a,b,1]
# the 21 rotated moments the fit reads: (a,b,0) with a+b <= 4 and
# (a,b,1) with a+b <= 2
_S_KEYS = tuple((a, b, c) for (a, b, c) in MOMENT_EXPS
                if c == 0 or (c == 1 and a + b <= 2))


def _div(a: torch.Tensor, b):
    """a / b, correctly rounded, for a tensor over a tensor or number."""
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.div(a, b)


def _sum(*xs):
    """((x0 + x1) + x2) + …"""
    s = xs[0]
    for x in xs[1:]:
        s = s + x
    return s


def _eigvec_min(a00, a01, a02, a11, a12, a22):
    """``smallest_eigvec3``'s unit eigenvector of the symmetric matrix
    with these entries (+z where the cross-row quality is ≤ _EPS)."""
    ent = (a00, a01, a02, a01, a11, a12, a02, a12, a22)     # row-major
    s = torch.clamp_min(torch.sqrt(_sum(*(x * x for x in ent))), 1e-30)
    a00, a01, a02, a11, a12, a22 = (_div(x, s)
                                    for x in (a00, a01, a02, a11, a12, a22))
    # eigvalsh3's smallest eigenvalue (Cardano)
    q = _div(_sum(a00, a11, a22), 3.0)
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    ent = (b00, a01, a02, a01, b11, a12, a02, a12, b22)
    p = torch.sqrt(torch.clamp_min(_div(_sum(*(x * x for x in ent)), 6.0),
                                   0.0))
    safe_p = torch.clamp_min(p, _EPS)
    det = ((b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02))
           + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(_div(det, 2.0 * ((safe_p * safe_p) * safe_p)), -1.0, 1.0)
    phi = _div(torch.arccos(r), 3.0)
    lam = q + (2.0 * p) * torch.cos(phi + 2.0 * math.pi / 3.0)
    # the cross-row eigenvector of A − λI
    r0 = (a00 - lam, a01, a02)
    r1 = (a01, a11 - lam, a12)
    r2 = (a02, a12, a22 - lam)

    def cross(u, v):
        return (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                u[0] * v[1] - u[1] * v[0])

    c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n01, n02, n12 = (_sum(*(x * x for x in c)) for c in (c01, c02, c12))
    pick01 = (n01 >= n02) & (n01 >= n12)
    pick02 = n02 >= n12
    quality = torch.maximum(torch.maximum(n01, n02), n12)
    norm = torch.sqrt(torch.clamp_min(quality, _EPS))
    ok = quality > _EPS
    v = [_div(torch.where(pick01, x01, torch.where(pick02, x02, x12)), norm)
         for x01, x02, x12 in zip(c01, c02, c12)]
    return (torch.where(ok, v[0], 0.0), torch.where(ok, v[1], 0.0),
            torch.where(ok, v[2], 1.0))


def _sign_fix(n, far, near):
    """The sign fix (the reference's pts[-1] − pts[0]): n, each component
    negated where its dot with far − near is negative."""
    d = [f - c for f, c in zip(far, near)]
    flip = _sum(n[0] * d[0], n[1] * d[1], n[2] * d[2]) < 0.0
    return tuple(torch.where(flip, -x, x) for x in n)


def _rotation(nx, ny, nz):
    """``rodrigues_to_z``'s rows (R n = +z; identity where |n × z| <
    1e-8, also for n = −z)."""
    vx, vy = ny, -nx
    s2 = vx * vx + vy * vy
    fac = _div(1.0 - nz, torch.clamp_min(s2, 1e-20))
    small = torch.sqrt(torch.clamp_min(s2, 0.0)) < 1e-8
    r01 = (vx * vy) * fac
    rows = ((1.0 + (vx * vx - s2) * fac, r01, vy),
            (r01, 1.0 + (vy * vy - s2) * fac, -vx),
            (-vy, vx, 1.0 - s2 * fac))
    eye = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    return tuple(tuple(torch.where(small, e, x) for x, e in zip(row, erow))
                 for row, erow in zip(rows, eye))


def _contract(T: dict, row) -> dict:
    """One rotation row into a symmetric tensor, stored by exponent:
    out[β] = ((r0·T[β+x] + r1·T[β+y]) + r2·T[β+z]), |β| = deg T − 1."""
    d = sum(next(iter(T)))
    out = {}
    for (a, b, c) in MOMENT_EXPS:
        if a + b + c == d - 1:
            out[(a, b, c)] = _sum(row[0] * T[(a + 1, b, c)],
                                  row[1] * T[(a, b + 1, c)],
                                  row[2] * T[(a, b, c + 1)])
    return out


def _rotated(m, R) -> dict:
    """The 21 s-moments the fit reads, s = R r̂. Target (a,b,c) takes c z
    rows, then b y rows, then a x rows; shared prefixes are shared."""
    memo = {}

    def chain(d, seq):
        if (d, seq) not in memo:
            if not seq:
                memo[(d, seq)] = {e: m[_IDX[e]] for e in MOMENT_EXPS
                                  if sum(e) == d}
            else:
                memo[(d, seq)] = _contract(chain(d, seq[:-1]),
                                           R["xyz".index(seq[-1])])
        return memo[(d, seq)]

    S = {}
    for (a, b, c) in _S_KEYS:
        d = a + b + c
        S[(a, b, c)] = chain(d, "z" * c + "y" * b + "x" * a)[(0, 0, 0)] \
            if d else m[0]
    return S


def _normal_equations(S, m0):
    """``fit_quadratic_from_moments``' RMS-preconditioned 6×6 normal
    equations with the relative ridge: (G as nested lists, rhs, the
    powers of 1/sa, of 1/sb)."""
    cnt = torch.clamp_min(m0, 1.0)
    sa = torch.sqrt(torch.clamp_min(_div(S[(2, 0, 0)], cnt), 1e-20))
    sb = torch.sqrt(torch.clamp_min(_div(S[(0, 2, 0)], cnt), 1e-20))
    ia, ib = [None, torch.reciprocal(sa)], [None, torch.reciprocal(sb)]
    for p in range(2, 5):
        ia.append(ia[p - 1] * ia[1])
        ib.append(ib[p - 1] * ib[1])

    def scaled(a, b, c):
        v = S[(a, b, c)]
        if a:
            v = v * ia[a]
        if b:
            v = v * ib[b]
        return v

    G = [[None] * 6 for _ in range(6)]
    for i, (ai, bi) in enumerate(_PHI):
        for j, (aj, bj) in enumerate(_PHI[i:], start=i):
            G[i][j] = G[j][i] = scaled(ai + aj, bi + bj, 0)
    rhs = [scaled(ai, bi, 1) for ai, bi in _PHI]
    _add_ridge(G)
    return G, rhs, ia, ib


def _add_ridge(G):
    """The relative ridge 1e-7·trace/6 on the 6×6 G's diagonal, in place."""
    ridge = _div(_RIDGE * _sum(*(G[j][j] for j in range(6))), 6.0)
    for j in range(6):
        G[j][j] = G[j][j] + ridge


def _solve(G, rhs):
    """``cholesky_solve``: the unrolled Cholesky with the dead-pivot rule
    (a pivot below 1e-10·|G_jj| + 1e-30 gets an inverse of 0), forward
    and backward substitution -> (x, the inverse pivots)."""
    L = [[None] * 6 for _ in range(6)]
    invd = [None] * 6
    for j in range(6):
        s = G[j][j]
        for t in range(j):
            s = s - L[j][t] * L[j][t]
        dead = s < 1e-10 * torch.abs(G[j][j]) + 1e-30
        pivot = torch.sqrt(torch.clamp_min(s, 1e-30))
        invd[j] = torch.where(dead, 0.0, torch.reciprocal(pivot))
        for i in range(j + 1, 6):
            s = G[i][j]
            for t in range(j):
                s = s - L[i][t] * L[j][t]
            L[i][j] = s * invd[j]
    y = [None] * 6
    for i in range(6):
        s = rhs[i]
        for t in range(i):
            s = s - L[i][t] * y[t]
        y[i] = s * invd[i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for t in range(i + 1, 6):
            s = s - L[t][i] * x[t]
        x[i] = s * invd[i]
    return x, invd


def _fit(S, m0, sigma):
    """``fit_quadratic_from_moments`` -> the Monge coefficients A, B, C,
    D, E in true units (F is not needed)."""
    G, rhs, ia, ib = _normal_equations(S, m0)
    x, _ = _solve(G, rhs)
    sg = torch.clamp_min(sigma, 1e-30)
    return (x[0] * _div(ia[1] * ia[1], sg), x[1] * _div(ib[1] * ib[1], sg),
            x[2] * _div(ia[1] * ib[1], sg), x[3] * ia[1], x[4] * ib[1])


def epilogue_plain(stats: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (rows, 48) -> (rows, 8), on
    the tensor's device."""
    m = [stats[:, j] for j in range(35)]
    sigma = stats[:, 38]
    near, kth = stats[:, 39:42], stats[:, 42:45]
    # covariance_from_moments (σ² dropped: eigenvectors are scale-free)
    cnt = torch.clamp_min(m[0], 1.0)
    mu = [_div(m[_IDX[e]], cnt) for e in ((1, 0, 0), (0, 1, 0), (0, 0, 1))]
    f = torch.reciprocal(torch.clamp_min(cnt - 1.0, 1.0))

    def cov(e, i, j):
        return (m[_IDX[e]] - (cnt * mu[i]) * mu[j]) * f

    nx, ny, nz = _eigvec_min(cov((2, 0, 0), 0, 0), cov((1, 1, 0), 0, 1),
                             cov((1, 0, 1), 0, 2), cov((0, 2, 0), 1, 1),
                             cov((0, 1, 1), 1, 2), cov((0, 0, 2), 2, 2))
    # the sign fix on kth − nearest (the reference's pts[-1] − pts[0])
    nx, ny, nz = _sign_fix((nx, ny, nz), kth.unbind(1), near.unbind(1))
    S = _rotated(m, _rotation(nx, ny, nz))
    A, B, C, D, E = _fit(S, m[0], sigma)
    return torch.stack([*_curvatures(A, B, C, D, E), nx, ny, nz], dim=1)


def _curvatures(A, B, C, D, E):
    """``explicit_curvatures`` of the Monge coefficients -> (K, H, k1, k2,
    H²)."""
    fxx, fyy = 2.0 * A, 2.0 * B
    fx2, fy2 = D * D, E * E
    w = (1.0 + fx2) + fy2
    K = _div(fxx * fyy - C * C, w * w)
    num = ((1.0 + fx2) * fyy - ((2.0 * D) * E) * C) + (1.0 + fy2) * fxx
    H = _div(num, 2.0 * torch.pow(w, 1.5))
    disc = torch.sqrt(torch.clamp_min(H * H - K, 0.0))
    return K, H, H + disc, H - disc, H * H


def _check(stats: torch.Tensor):
    if stats.dtype != torch.float32:
        raise ValueError(f"stats must be float32, got {stats.dtype}")
    if stats.dim() != 2 or stats.shape[1] != NIN:
        raise ValueError(f"stats must be (rows, {NIN}), got "
                         f"{tuple(stats.shape)}")
    if not stats.is_contiguous():
        raise ValueError("stats must be contiguous")


def moments_epilogue(stats: torch.Tensor) -> torch.Tensor:
    """(rows, 48) moment stats -> (rows, 8) float32 K, H, k1, k2, H², nx,
    ny, nz. CUDA tensors launch ``csrc/epilogue.cu:pct_moments_epilogue``
    once; CPU tensors run ``epilogue_plain``."""
    _check(stats)
    dev = stats.device
    if dev.type == "cpu":
        return epilogue_plain(stats)
    rows = stats.shape[0]
    out = torch.empty((rows, NOUT), dtype=torch.float32, device=dev)
    if rows > 0:
        build.kernel("epilogue", "pct_moments_epilogue")(stats, out, rows)
    return out
