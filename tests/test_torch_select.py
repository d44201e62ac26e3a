"""The port's select (plain version on the CPU) against the JAX package's
Pallas kernel in interpret mode, on the same tiles.

Tolerances: winner sets equal on found slots; distances to rtol 2e-6,
because XLA may contract the JAX side's d² into FMAs (1 ulp, see
tests/test_pallas.py) while the port rounds every operation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pct_tpu.ops.pallas_select import knn_select_coords as jax_select_coords
from pct_tpu_torch.ops.select import (
    knn_select_coords,
    select_coords_plain,
    select_pos_plain,
    select_rows_plain,
)


def _random_tile(seed, T=6, C=8, M=48):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, C, 3)).astype(np.float32)
    p = rng.standard_normal((T, M, 3)).astype(np.float32)
    cand = rng.integers(0, 500, (T, M)).astype(np.int32)
    qrow = cand[:, :C].copy()            # force self-exclusion hits
    valid = (rng.random((T, M)) < 0.85).astype(np.int32)
    return q, p, cand, qrow, valid


def _duplicate_tile(seed, T=4, C=8, M=40):
    """Every candidate point appears 4 times: exact distance ties."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((T, M // 4, 3)).astype(np.float32)
    p = np.repeat(base, 4, axis=1)
    q = base[:, :C] + np.float32(0.25)
    cand = np.tile(np.arange(M, dtype=np.int32), (T, 1))
    qrow = np.full((T, C), -1, np.int32)
    valid = np.ones((T, M), np.int32)
    return q, p, cand, qrow, valid


def _sparse_tile(seed, T=5, C=8, M=48, k=6):
    """Fewer than k valid candidates in some rows (missing slots)."""
    q, p, cand, qrow, valid = _random_tile(seed, T, C, M)
    valid[:] = 0
    for t in range(T):
        valid[t, np.random.default_rng(seed + t).choice(M, t + 1,
                                                         replace=False)] = 1
    return q, p, cand, qrow, valid


def _both(tile, k):
    q, p, cand, qrow, valid = tile
    dj, nj = jax_select_coords(jnp.asarray(q), jnp.asarray(p),
                               jnp.asarray(cand), jnp.asarray(qrow),
                               jnp.asarray(valid), k, interpret=True)
    dt, nt = knn_select_coords(*(torch.from_numpy(a) for a in tile), k)
    return (np.asarray(dj), np.asarray(nj)), (dt.numpy(), nt.numpy())


@pytest.mark.parametrize("make,k", [
    (_random_tile, 5), (_random_tile, 20), (_duplicate_tile, 7),
    (_sparse_tile, 6)], ids=["random_k5", "random_k20", "duplicates",
                             "fewer_than_k"])
def test_select_coords_matches_pallas_interpret(make, k):
    tile = make(7)
    (dj, nj), (dt, nt) = _both(tile, k)
    p = tile[1]
    found = dt < 1e18
    np.testing.assert_array_equal(found, dj < 1e18)
    np.testing.assert_allclose(dt[found], dj[found], rtol=2e-6, atol=0)
    # winner sets equal on found slots: sort each row's found winners
    for t in range(dt.shape[0]):
        for c in range(dt.shape[1]):
            f = found[t, c]
            a = nt[t, c][f]
            b = nj[t, c][f]
            key_a = np.lexsort(a.T[::-1])
            key_b = np.lexsort(b.T[::-1])
            np.testing.assert_array_equal(a[key_a], b[key_b])
    # missing slots: ~3e38-backed distance and the coords of slot 0
    miss = ~found
    assert (dt[miss] > 1e18).all()
    np.testing.assert_array_equal(
        nt[miss], np.broadcast_to(p[:, None, None, 0, :], nt.shape)[miss])


def test_select_coords_exact_ties_follow_candidate_order():
    """Distinct candidates at exactly equal distance: the earlier slot
    wins (first-argmin), winner for winner as in the JAX kernel. Points
    sit on a 1/8 lattice with axis offsets, so every d² is exact in both
    packages whether or not it is contracted into FMAs."""
    rng = np.random.default_rng(3)
    T, C, k = 3, 8, 16
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    # 4 shells of 6 candidates: d² 0.25, 0.5625, 1, 4; k cuts the third
    offs = np.concatenate([r * axes for r in (0.5, 0.75, 1.0, 2.0)])
    M = len(offs)
    q = np.repeat(rng.integers(-16, 16, (T, 1, 3)) / 8, C, axis=1)
    p = np.stack([q[t, 0] + offs[rng.permutation(M)] for t in range(T)])
    q, p = q.astype(np.float32), p.astype(np.float32)
    cand = np.tile(np.arange(M, dtype=np.int32), (T, 1))
    qrow = np.full((T, C), -1, np.int32)
    valid = np.ones((T, M), np.int32)
    (dj, nj), (dt, nt) = _both((q, p, cand, qrow, valid), k)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(nt, nj)
    d2 = ((p - q[:, :1]) ** 2).sum(-1)
    for t in range(T):
        first = np.argsort(d2[t], kind="stable")[:k]   # ascending (d², slot)
        np.testing.assert_array_equal(
            nt[t], np.broadcast_to(p[t, first], (C, k, 3)))


def test_select_wrapper_checks_operands():
    """Wrong operand types and k = 0 raise; k = 1025, past the warp
    classes and past the 48 candidate slots, runs: the usable slots in
    ascending order (numpy, same float32 operations), then the missing
    slots' (sqrt(3e38), slot 0's coordinates)."""
    tile = _random_tile(1)
    q, p, cand, qrow, valid = (torch.from_numpy(a) for a in tile)
    with pytest.raises(ValueError, match="int32"):
        knn_select_coords(q, p, cand.long(), qrow, valid, 5)
    with pytest.raises(ValueError, match="positive"):
        knn_select_coords(q, p, cand, qrow, valid, 0)
    d, nbrs = knn_select_coords(q, p, cand, qrow, valid, 1025)
    qn, pn, cn, rn, vn = tile
    diff = qn[:, :, None, :] - pn[:, None, :, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]
    ok = (vn[:, None, :] != 0) & (cn[:, None, :] != rn[:, :, None])
    masked = np.where(ok, d2, np.float32(3e38))
    order = np.argsort(masked, -1, kind="stable")
    want = np.full(d.shape, np.float32(3e38))
    want[..., :48] = np.take_along_axis(masked, order, -1)
    np.testing.assert_array_equal(
        d.numpy(), torch.sqrt(torch.from_numpy(want)).numpy())
    pos = np.zeros(d.shape, np.int64)
    pos[..., :48] = np.where(want[..., :48] < 1e38, order, 0)
    T, C, k = d.shape
    picked = pn[np.arange(T)[:, None, None], pos]
    np.testing.assert_array_equal(nbrs.numpy(), picked)
    assert (d[..., 48:] > 1e18).all() and (d[..., 0] < 1e18).all()


@pytest.mark.parametrize("make,k", [
    (_random_tile, 20), (_duplicate_tile, 7), (_sparse_tile, 6)],
    ids=["random_k20", "duplicates", "fewer_than_k"])
def test_select_coords_plain_is_the_warp_selects(make, k):
    """The coords select is the rows/positions select with another
    emitter (one kernel design in csrc/knn_warp.cuh): the same
    distances, and the coordinates of the candidates at the winner
    positions, slot 0's where a winner is missing."""
    q, p, cand, qrow, valid = (torch.from_numpy(a) for a in make(5))
    d_c, n_c = select_coords_plain(q, p, cand, qrow, valid, k)
    d_p, pos = select_pos_plain(q, p, cand, qrow, valid, k)
    d_r, rows = select_rows_plain(q, p, cand, qrow, valid, k)
    assert torch.equal(d_c, d_p) and torch.equal(d_c, d_r)
    T, C = q.shape[:2]
    picked = torch.gather(p, 1, pos.reshape(T, C * k, 1).long()
                          .expand(-1, -1, 3)).reshape(T, C, k, 3)
    assert torch.equal(n_c, picked)
    assert torch.equal(rows, torch.gather(cand, 1, pos.reshape(T, -1).long())
                       .reshape(T, C, k))
    miss = d_c > 1e18
    assert torch.equal(pos[miss], torch.zeros_like(pos[miss]))
