"""The tensor-core coords select of the port against the JAX script's
kernel, on the CPU.

``pct_tpu_torch.micro.select_mxu.select_coords_mxu`` (its plain version
here) against ``select_coords_mxu(..., interpret=True)`` of the JAX
package's TPU script ``scripts/micro_select_mxu.py`` at T=16, C=8, M=48,
k=6. On dyadic lattice tiles every d² is exact whether or not XLA
contracts it into FMAs, so distances, coordinates and ids are compared
exactly: exact ties (first slot wins), missing slots (slot 0's
coordinates and id) and ids above 2²⁴ (rounded as float32). On the
script's own random recipe the JAX side may contract d² (1 ulp), so
distances agree to rtol 2e-6 and the winner sets on found slots.
"""

import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pct_tpu_torch.micro.select_mxu import select_coords_mxu
from pct_tpu_torch.ops.select import knn_select_coords

ROOT = pathlib.Path(__file__).resolve().parent.parent
T, C, M, K = 16, 8, 48, 6


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "micro_select_mxu", ROOT / "scripts" / "micro_select_mxu.py")
    mod = importlib.util.module_from_spec(spec)
    path = sys.path[:]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    # the script puts its own root first on sys.path; gloo ranks spawned
    # later on this worker inherit sys.path, so it must not outlive the load
    assert sys.path == path
    return mod


def _lattice(seed, p_valid=0.9, big_ids=False):
    """Integer coordinates scaled by 2⁻³ within ±3 steps of a base point
    (exact d², many exact ties); queries are the first C candidates, and
    their ids make the self-exclusion hits. ``big_ids`` draws the ids
    above 2²⁴, where float32 keeps only even integers."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-32, 32, (T, 1, 3))
    p = ((base + rng.integers(-3, 4, (T, M, 3))) * 2.0**-3).astype(np.float32)
    q = p[:, :C].copy()
    lo = (1 << 24) + 1 if big_ids else 0
    cand = np.stack([lo + rng.permutation(1 << 12)[:M] for _ in range(T)]
                    ).astype(np.int32)
    qrow = cand[:, :C].copy()
    valid = (rng.random((T, M)) < p_valid).astype(np.int32)
    return q, p, cand, qrow, valid


def _both(script, tile, k=K):
    q, p, cand, qrow, valid = tile
    dj, nj, rj = script.select_coords_mxu(
        jnp.asarray(q), tuple(jnp.asarray(p[..., a]) for a in range(3)),
        jnp.asarray(cand), jnp.asarray(qrow), jnp.asarray(valid), k,
        interpret=True)
    got = select_coords_mxu(*(torch.from_numpy(np.array(a)) for a in tile),
                            k)
    return ((np.asarray(dj), np.asarray(nj), np.asarray(rj)),
            tuple(a.numpy() for a in got))


@pytest.mark.parametrize("case", ["ties", "sparse", "big_ids"])
def test_select_mxu_plain_matches_jax_on_lattice(script, case):
    tile = _lattice(5, p_valid=0.08 if case == "sparse" else 0.9,
                    big_ids=case == "big_ids")
    (dj, nj, rj), (dt, nt, rt) = _both(script, tile)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(rt, rj)
    q, p, cand, qrow, valid = tile
    found = dt < 1e18
    if case == "ties":
        d2 = ((q[:, :, None] - p[:, None]) ** 2).sum(-1)
        assert (np.diff(np.sort(d2, axis=-1), axis=-1) == 0).any()
        assert found.all()
    if case == "sparse":
        miss = ~found
        assert miss.any() and found.any()
        np.testing.assert_array_equal(
            nt[miss], np.broadcast_to(p[:, None, None, 0], nt.shape)[miss])
        np.testing.assert_array_equal(
            rt[miss], np.broadcast_to(cand[:, None, None, 0], rt.shape)[miss])
        assert (dt[miss] == np.sqrt(np.float32(3.0e38))).all()
    if case == "big_ids":
        want = cand.astype(np.float32).astype(np.int32)
        assert (want != cand).any()           # odd ids round to even
        assert set(rt.ravel()) <= set(want.ravel())
        assert not set(rt.ravel()) <= set(cand.ravel())


def test_select_mxu_plain_matches_jax_on_random_tile(script):
    qp, cp, cand, qrow, valid = script.make_inputs(T, C, M, K, seed=2)
    tile = (np.asarray(qp), np.stack([np.asarray(a) for a in cp], axis=-1),
            np.asarray(cand), np.asarray(qrow), np.asarray(valid))
    (dj, nj, rj), (dt, nt, rt) = _both(script, tile)
    found = dt < 1e18
    np.testing.assert_array_equal(found, dj < 1e18)
    np.testing.assert_allclose(dt[found], dj[found], rtol=2e-6, atol=0)
    for t in range(T):
        for c in range(C):
            f = found[t, c]
            a = np.c_[nt[t, c][f], rt[t, c][f]]
            b = np.c_[nj[t, c][f], rj[t, c][f]]
            np.testing.assert_array_equal(a[np.lexsort(a.T[::-1])],
                                          b[np.lexsort(b.T[::-1])])


def test_select_mxu_plain_equals_the_coords_select():
    """The variant's distances and coordinates are the production coords
    select's, bit for bit (the same rounds and the same missing-slot
    rule), and its ids the winners' own where they are below 2²⁴."""
    tile = [torch.from_numpy(a) for a in _lattice(9, p_valid=0.1)]
    dm, nm, rm = select_coords_mxu(*tile, K)
    dc, nc = knn_select_coords(*tile, K)
    assert torch.equal(dm.view(torch.int32), dc.view(torch.int32))
    assert torch.equal(nm.view(torch.int32), nc.view(torch.int32))
    assert (dm > 1e18).any() and (dm < 1e18).any()
    p, cand = tile[1], tile[2]
    hit = (p[:, None, None, :, :] == nm[..., None, :]).all(-1) & (
        cand[:, None, None, :] == rm[..., None])
    assert hit.any(-1).all()


def test_select_mxu_refuses_a_ragged_grid():
    tile = [torch.from_numpy(a[:12]) for a in _lattice(1)]
    with pytest.raises(ValueError, match="block_cells"):
        select_coords_mxu(*tile, K)
    d, n, r = select_coords_mxu(*tile, K, block_cells=4)
    assert d.shape == (12, C, K) and n.shape == (12, C, K, 3)
    assert r.dtype == torch.int32
