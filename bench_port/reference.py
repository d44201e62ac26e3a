"""The plain reference: exact k nearest neighbours and the explicit
quadric fit of the reference toolbox, in plain PyTorch.

It takes the benchmark's own points and query indices and nothing the
program derived (no cell size, grid, buckets or neighbours):

1. brute force over the whole cloud: candidates ranked by the expanded
   form |p|² − 2 q·p (one matrix product a block of queries), the
   query itself excluded, the best ``k + EXTRA`` re-measured in the
   difference form (q − p)·(q − p) and the k smallest kept, ascending;
2. the neighbourhood centred on the query, its covariance (``np.cov``:
   mean-subtracted, over k − 1), the normal as the eigenvector of the
   smallest eigenvalue, flipped where it points against the farthest
   minus the nearest neighbour (pointCloudToolbox.py's sign fix);
3. the Rodrigues rotation taking the normal to +z, the least-squares
   Monge patch z = A a² + B b² + C ab + D a + E b + F (columns scaled to
   unit RMS extent, which leaves the optimum unchanged), and the
   curvature formulas K, H, k1, k2 at the origin.

``dtype=torch.float64`` is the reference. The control of the check is
the same code in float32 with TF32 (``tf32=True``): every operand of a
matrix product is rounded to TF32's 10 mantissa bits, as the tensor
cores do with TF32 allowed, so the control reads the same on the CPU
and on the card.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

EXTRA = 8            # candidates re-measured beyond k
KNN_BLOCK = 128      # queries a brute-force block
FIT_BLOCK = 8192     # queries a fit block


class Reference(NamedTuple):
    ids: torch.Tensor      # (Q, k) int64, ascending distance
    d2: torch.Tensor       # (Q, k) squared distances
    d2_next: torch.Tensor  # (Q,) squared distance of the (k+1)th
    normals: torch.Tensor  # (Q, 3)
    K: torch.Tensor
    H: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor


@contextlib.contextmanager
def tf32_matmul(allow: bool):
    """Allow or forbid TF32 in float32 matrix products for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to 10 mantissa bits (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def knn(points: torch.Tensor, queries: torch.Tensor, k: int, rnd=_same):
    """Exact kNN by brute force. points (N, 3), queries (Q,) int64 ->
    (ids (Q, k) int64, d2 (Q, k)) in ascending d², ties by rank. ``rnd``
    rounds the operands of the matrix product."""
    norms = (points * points).sum(1)
    pt = rnd(points.t().contiguous())
    ids, d2s = [], []
    m = min(k + EXTRA, points.shape[0] - 1)
    for s in range(0, queries.shape[0], KNN_BLOCK):
        qi = queries[s:s + KNN_BLOCK]
        q = points[qi]
        score = torch.addmm(norms[None, :], rnd(q), pt, alpha=-2.0)
        score[torch.arange(qi.shape[0], device=q.device), qi] = float("inf")
        cand = torch.topk(score, m, dim=1, largest=False).indices
        del score
        diff = q[:, None, :] - points[cand]
        d2 = (diff * diff).sum(-1)
        d2, order = torch.sort(d2, dim=1, stable=True)
        ids.append(torch.gather(cand, 1, order)[:, :k])
        d2s.append(d2[:, :k])
    return torch.cat(ids), torch.cat(d2s)


def rotation_to_z(n: torch.Tensor, rnd=_same) -> torch.Tensor:
    """(Q, 3) unit normals -> (Q, 3, 3) R with R n = +z (Rodrigues about
    n × z; the identity where |n × z| < 1e-8, the reference's rule)."""
    vx, vy = n[:, 1], -n[:, 0]
    s2 = vx * vx + vy * vy
    c = n[:, 2]
    zero = torch.zeros_like(c)
    kx = torch.stack([torch.stack([zero, zero, vy], -1),
                      torch.stack([zero, zero, -vx], -1),
                      torch.stack([-vy, vx, zero], -1)], -2)
    eye = torch.eye(3, dtype=n.dtype, device=n.device).expand_as(kx)
    fac = ((1.0 - c) / torch.clamp_min(s2, 1e-30))[:, None, None]
    rot = eye + kx + torch.bmm(rnd(kx), rnd(kx)) * fac
    small = (torch.sqrt(s2) < 1e-8)[:, None, None]
    return torch.where(small, eye, rot)


def fit(nbhd: torch.Tensor, rnd=_same):
    """(Q, k, 3) query-centred neighbourhoods, ascending distance ->
    (normals, K, H, k1, k2)."""
    kk = nbhd.shape[1]
    xc = rnd(nbhd - nbhd.mean(1, keepdim=True))
    cov = torch.bmm(xc.transpose(1, 2), xc) / max(kk - 1, 1)
    _, vecs = torch.linalg.eigh(cov)
    n = vecs[:, :, 0]
    flip = (n * (nbhd[:, -1] - nbhd[:, 0])).sum(-1) < 0
    n = torch.where(flip[:, None], -n, n)
    rot = torch.bmm(rnd(nbhd), rnd(rotation_to_z(n, rnd)).transpose(1, 2))
    a, b, z = rot[..., 0], rot[..., 1], rot[..., 2]
    sa = torch.sqrt(torch.clamp_min((a * a).mean(1, keepdim=True), 1e-30))
    sb = torch.sqrt(torch.clamp_min((b * b).mean(1, keepdim=True), 1e-30))
    u, v = a / sa, b / sb
    design = rnd(torch.stack([u * u, v * v, u * v, u, v, torch.ones_like(u)],
                             -1))
    gram = torch.bmm(design.transpose(1, 2), design)
    rhs = torch.bmm(design.transpose(1, 2), rnd(z[..., None]))
    coef = torch.linalg.solve(gram, rhs)[..., 0]
    sa, sb = sa[:, 0], sb[:, 0]
    A, B, C = coef[:, 0] / (sa * sa), coef[:, 1] / (sb * sb), coef[:, 2] / (sa * sb)
    D, E = coef[:, 3] / sa, coef[:, 4] / sb
    w = 1.0 + D * D + E * E
    K = (4.0 * A * B - C * C) / (w * w)
    H = ((1.0 + D * D) * 2.0 * B - 2.0 * D * E * C
         + (1.0 + E * E) * 2.0 * A) / (2.0 * w ** 1.5)
    disc = torch.sqrt(torch.clamp_min(H * H - K, 0.0))
    return n, K, H, H + disc, H - disc


def reference(points: np.ndarray, queries: np.ndarray, k: int,
              device: torch.device, dtype=torch.float64,
              tf32: bool = False) -> Reference:
    """The reference at ``queries`` (indices into ``points``, (N, 3)
    host array), computed on ``device`` in ``dtype``; outputs on the
    host in ``dtype``."""
    if tf32 and dtype != torch.float32:
        raise ValueError("TF32 rounds float32 operands only")
    rnd = tf32_round if tf32 else _same
    with tf32_matmul(tf32):
        pts = torch.from_numpy(np.ascontiguousarray(points)).to(device, dtype)
        q = torch.from_numpy(np.asarray(queries, dtype=np.int64)).to(device)
        ids, d2 = knn(pts, q, k + 1, rnd)
        ids, d2, d2_next = ids[:, :k], d2[:, :k], d2[:, k]
        parts = []
        for s in range(0, q.shape[0], FIT_BLOCK):
            nbhd = pts[ids[s:s + FIT_BLOCK]] - pts[q[s:s + FIT_BLOCK]][:, None]
            parts.append(fit(nbhd, rnd))
        n, K, H, k1, k2 = (torch.cat(x).cpu() for x in zip(*parts))
    return Reference(ids.cpu(), d2.cpu(), d2_next.cpu(), n, K, H, k1, k2)
