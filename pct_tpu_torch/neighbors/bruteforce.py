"""Exact brute-force kNN and the sampled mean 1-NN spacing.

Port of ``pct_tpu.neighbors.bruteforce``: ||q-p||² = ||q||² + ||p||² −
2 q·pᵀ with the cross term as a float32 matmul (TF32 is off, see the
package ``__init__``).
"""

from __future__ import annotations

import torch


def _pairwise_sqdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(Q,3),(N,3) -> (Q,N) squared distances, cross term as a matmul."""
    qq = torch.sum(q * q, dim=1, keepdim=True)
    pp = torch.sum(p * p, dim=1, keepdim=True).T
    return torch.clamp_min(qq + pp - 2.0 * (q @ p.T), 0.0)


def smallest_k(d2: torch.Tensor, k: int):
    """The k smallest entries of each row of ``d2`` (float32, every entry
    >= 0 or +inf) in ``lax.top_k``'s order: ascending, the lower column
    first among equal values (±0 equal). ``torch.topk`` keeps no tie
    order, so it runs on unique int64 keys (d² bits << 32 | column):
    non-negative float32 values order as their bits do, and ``+ 0.0``
    turns a −0 (which ``clamp_min`` can leave) into +0 first. Returns
    (values (..., k) float32, exactly the selected d², and columns
    (..., k) int64)."""
    key = (d2 + 0.0).view(torch.int32).to(torch.int64)
    key.bitwise_left_shift_(32).bitwise_or_(
        torch.arange(d2.shape[-1], dtype=torch.int64, device=d2.device))
    top = torch.topk(key, k, dim=-1, largest=False).values
    vals = (top >> 32).to(torch.int32).view(torch.float32)
    return vals, top & 0xFFFFFFFF


def knn_bruteforce(points: torch.Tensor, num_points: int, k: int,
                   queries: torch.Tensor | None = None,
                   query_indices: torch.Tensor | None = None,
                   exclude_self: bool = True, tile: int = 2048):
    """Exact kNN of ``queries`` (default: every row of ``points``) among
    the valid rows of ``points`` (padding rows >= num_points are never
    candidates). With ``exclude_self`` the query's own row
    (``query_indices``, default arange when ``queries`` is None) is
    removed: the reference's "query k+1, drop self". Slots beyond the
    valid candidates carry inf distances. Equal distances keep the lower
    row first, as ``lax.top_k`` does (``smallest_k``). Returns (indices
    (Q,k) int32, dists (Q,k) float32 ascending)."""
    n = points.shape[0]
    dev = points.device
    if queries is None:
        queries = points
        if query_indices is None:
            query_indices = torch.arange(n, device=dev)
    if exclude_self and query_indices is None:
        raise ValueError("exclude_self requires query_indices")
    ar = torch.arange(n, device=dev)
    valid = ar < num_points
    idx_out, d_out = [], []
    for s in range(0, queries.shape[0], tile):
        q = queries[s:s + tile]
        d2 = _pairwise_sqdist(q, points)
        ok = valid[None, :]
        if exclude_self:
            ok = ok & (ar[None, :] != query_indices[s:s + tile, None])
        d2, idx = smallest_k(torch.where(ok, d2, torch.inf), k)
        idx_out.append(idx.to(torch.int32))
        d_out.append(torch.sqrt(d2))
    if not idx_out:
        return (torch.empty((0, k), dtype=torch.int32, device=dev),
                torch.empty((0, k), device=dev))
    return torch.cat(idx_out), torch.cat(d_out)


def knn_cloud(cloud, k: int, tile: int = 2048):
    """All-points self-excluded kNN of a PointCloud (brute force)."""
    return knn_bruteforce(cloud.points, cloud.num_points, k, tile=tile)


def _sampled_nn_fold(points: torch.Tensor, num_points: int, sample: int,
                     chunk: int):
    """(best (sample,) 1-NN distances, valid_s (sample,)) over a
    deterministic stride sample of the valid rows."""
    dev = points.device
    stride = max(num_points // sample, 1)
    sidx = (torch.arange(sample, device=dev) * stride) % max(num_points, 1)
    s = points[sidx]
    valid_s = torch.arange(sample, device=dev) < min(sample, num_points)
    best = torch.full((sample,), torch.inf, device=dev)
    for c0 in range(0, num_points, chunk):
        p = points[c0:min(c0 + chunk, num_points)]
        d2 = _pairwise_sqdist(s, p)
        gidx = torch.arange(c0, c0 + p.shape[0], device=dev)
        d2 = torch.where(gidx[None, :] == sidx[:, None], torch.inf, d2)
        best = torch.minimum(best, d2.min(dim=1).values)
    return torch.sqrt(best), valid_s


def mean_nn_distance(points: torch.Tensor, num_points: int,
                     sample: int = 1024, chunk: int = 16384) -> torch.Tensor:
    """() float32 mean nearest-neighbor distance over a deterministic
    stride sample of ``sample`` valid rows; a running-min fold over point
    chunks, so the (sample × N) distance matrix never materializes.

    Not bit-equal to the JAX package's: both take the expanded form
    |q|² + |p|² − 2q·p, whose cross term is a matmul that PyTorch (BLAS,
    cuBLAS) and XLA round differently. At 1-NN separations the form
    cancels (|q|² + |p|² ≈ 2q·p), so an ulp of |q|² becomes many ulps of
    d̄ (843 on a 200k torus). tests/test_torch_grid.py bounds the
    relative gap by 1e-4."""
    best, valid_s = _sampled_nn_fold(points, num_points, sample, chunk)
    best = torch.where(valid_s, best, 0.0)
    return torch.sum(best) / max(min(sample, num_points), 1)
