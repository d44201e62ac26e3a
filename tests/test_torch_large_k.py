"""The selects past 128 neighbors, on the CPU, against the JAX package.

The port's selects take any k, as the JAX package's Pallas selects do
(past 1024 see tests/test_torch_huge_k.py). On a 2000-point torus
(perturbed, one module-scoped cloud) at k = 160 and k = 200, each entry
point runs once in each package (one module-scoped fixture that computes
each k once):

- ``knn_cloud_grid``: every row exact after the repair in both
  packages; the port's distances within the rounding bounds of
  tests/test_torch_knn.py's ``knn_cloud_grid`` test against the float64
  truth (the grid rows' difference form within rtol 1e-5 / atol 1e-6;
  a row the repair re-resolved carries the brute force's expanded form,
  8·2⁻²⁴·(|q|²+|p|²) in d²); the kth distance to the same bounds; the id
  sets equal to the JAX package's and to the truth wherever the kth and
  (k+1)th true distances are apart by more than those bounds;
- ``fast_curvature(method="implicit")`` (the staged fallback: the list
  engine refuses every bucket at these k) and ``curvature_pipeline``
  (explicit): tests/test_torch_implicit.py's rule, K and H within
  1e-4·max|K| (max|H|) on the rows whose neighbor id sets agree (at
  least 99.9% of the cloud), plus 2e-3·|K| on 99% of them for the
  implicit fit, whose float32 noise the summation order moves; the
  normals within |dot| >= 1 - 1e-5 of the JAX package's on those rows,
  with the same sign (both packages sign-fix against the farthest
  neighbor);
- ``compat.estimate_curvature(max_neighbors=200)`` at k_fraction 0.2
  (so that k = 200): within 1e-4 of its largest value on the rows
  whose id sets agree, as in tests/test_torch_compat.py;
- the three selects' plain versions against the JAX package's
  ``knn_select`` (positions) in interpret mode at k = 160 on a tiny tile
  (M = 200 slots), with the rule of tests/test_torch_knn.py: distances
  rtol 2e-6 (XLA may contract the JAX side's d² into FMAs), winner sets
  equal on found slots, each select's winners those positions'
  (positions, ``cand[pos]``, ``cpts[pos]``: what the JAX rows and coords
  kernels emit from the same rounds). One JAX kernel, because each
  compiles its 160 unrolled rounds for ~10 s (the coords one ~25 s).

The JAX side's neighbor lists are its ``curvature_pipeline``'s (its
``knn_cloud_grid`` + the fit) and its ``exact`` its implicit
``fast_curvature``'s (the same repaired ``knn_cloud_grid``), so that
each JAX entry point compiles once; the port's ``knn_cloud_grid`` runs
on its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from pct_tpu import compat as jcompat
from pct_tpu.core import from_numpy as jax_from_numpy
from pct_tpu.ops.pallas_select import knn_select as jax_select
from pct_tpu.pipeline import curvature_pipeline as jax_curvature_pipeline
from pct_tpu.pipeline.fused import fast_curvature as jax_fast_curvature
from pct_tpu_torch import compat
from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.neighbors import knn_cloud_grid
from pct_tpu_torch.neighbors.cellknn import list_engine_ok, probe_grid_buckets
from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
from pct_tpu_torch.ops.select import (
    knn_select,
    knn_select_coords,
    knn_select_rows,
)
from pct_tpu_torch.pipeline import curvature_pipeline, fast_curvature
from pct_tpu_torch.shapes import generate_shape
from tests.test_torch_compat import _estimate_parity
from tests.test_torch_implicit import _compare
from tests.test_torch_select import _random_tile

N = 2000
KS = (160, 200)


@pytest.fixture(scope="module")
def torus():
    return generate_shape("torus", N, perturbation_strength=1e-3,
                          seed=1)[1]


@pytest.fixture(scope="module")
def runs(torus):
    """runs(k): both packages' ``knn_cloud_grid``, implicit
    ``fast_curvature`` and ``curvature_pipeline`` on the torus at k, and
    the float64 truth (k+1 neighbors past self); each k computed once."""
    done = {}

    def get(k):
        if k not in done:
            done[k] = _run(torus, k)
        return done[k]

    return get


def _run(pts, k):
    cj = jax_from_numpy(pts)
    out = {"jax_imp": jax_fast_curvature(cj, k, method="implicit"),
           "jax_pipe": jax_curvature_pipeline(cj, k)}
    out["jax_ids"] = np.asarray(out["jax_pipe"].neighbor_indices)[:N]
    out["knn"], out["grid"] = knn_cloud_grid(from_numpy(pts, device="cpu"), k,
                                             device="cpu")
    out["imp"] = fast_curvature(from_numpy(pts, device="cpu"), k,
                                method="implicit", device="cpu")
    out["pipe"] = curvature_pipeline(from_numpy(pts, device="cpu"), k,
                                     device="cpu")
    d, i = cKDTree(pts.astype(np.float64)).query(pts.astype(np.float64),
                                                 k + 2)
    out["d_true"], out["i_true"] = d[:, 1:], i[:, 1:]        # drop self
    return out


def _untied(r, pts, k):
    """(d² bound a row, rows whose kth and (k+1)th true distances are
    apart by more than it): the grid's difference form or the repair's
    expanded form, whichever is larger."""
    cell_bound = 32 * 2.0**-24 * 15 * float(r["grid"].cell_size) ** 2
    sq = np.sum(pts.astype(np.float64) ** 2, axis=1)
    bf_bound = 8 * 2.0**-24 * (sq[:, None] + sq[r["i_true"][:, :k]])
    bound = np.maximum(bf_bound, cell_bound)
    d = r["d_true"]
    gap = d[:, k] ** 2 - d[:, k - 1] ** 2
    return bound, gap > 1e-4 * d[:, k] ** 2 + 2 * bound[:, -1]


@pytest.mark.parametrize("k", KS)
def test_knn_cloud_grid_large_k_matches_jax(runs, torus, k):
    run, pts = runs(k), torus
    rt = run["knn"]
    assert rt.indices.shape[1] == k and rt.indices.shape[0] >= N
    assert rt.exact[:N].all() and np.asarray(run["jax_imp"].exact)[:N].all()
    assert rt.valid[:N].all()
    d_t = rt.dists[:N].numpy().astype(np.float64)
    d_true = run["d_true"][:, :k]
    bound, untied = _untied(run, pts, k)
    err = np.abs(d_t ** 2 - d_true ** 2)
    rel = np.abs(d_t - d_true) <= 1e-5 * d_true + 1e-6
    assert (rel | (err <= bound)).all()
    assert (np.diff(d_t, axis=1) >= 0).all()
    assert untied.mean() > 0.8
    ids_t = np.sort(rt.indices[:N].numpy(), 1)
    ids_j = np.sort(run["jax_ids"], 1)
    ids_true = np.sort(run["i_true"][:, :k], 1)
    assert (ids_t == ids_j).all(1)[untied].all()
    assert (ids_t == ids_true).all(1)[untied].all()


@pytest.mark.parametrize("k", KS)
def test_fast_curvature_implicit_large_k_matches_jax(runs, torus, k):
    """The staged route at these k: ``knn_cloud_grid`` + the implicit
    fit, ``exact`` all True in both packages."""
    run, pts = runs(k), torus
    cloud = from_numpy(pts, device="cpu")
    grid = build_grid(cloud.points, N, estimate_cell_size(cloud.points, N, k))
    spec, _ = probe_grid_buckets(grid, capacity_cap=max(256, 4 * k))
    assert not any(list_engine_ok(sp.capacity, sp.cand_cap, k)
                   for sp in spec)
    rt, rj = run["imp"], run["jax_imp"]
    assert rt.exact[:N].all() and np.asarray(rj.exact)[:N].all()
    np.testing.assert_array_equal(rt.kth_dist[:N].numpy(),
                                  run["knn"].dists[:N, -1].numpy())
    idx_t = run["knn"].indices[:N].numpy()
    idx_j = run["jax_ids"]
    _compare("torus", pts, rt, rj, idx_j, idx_t, "implicit")
    _normals_agree(rt.normals, rj.normals, idx_t, idx_j)


@pytest.mark.parametrize("k", KS)
def test_curvature_pipeline_large_k_matches_jax(runs, torus, k):
    run, pts = runs(k), torus
    rt, rj = run["pipe"], run["jax_pipe"]
    idx_t = rt.neighbor_indices[:N].numpy()
    idx_j = run["jax_ids"]
    assert idx_t.shape == (N, k)
    np.testing.assert_array_equal(idx_t, run["knn"].indices[:N].numpy())
    _compare("torus", pts, rt, rj, idx_j, idx_t, "explicit")
    _normals_agree(rt.normals, rj.normals, idx_t, idx_j)
    assert rt.coeffs.shape == (len(rt.normals), 6)


def _normals_agree(nt, nj, idx_t, idx_j):
    rows = (np.sort(idx_t, 1) == np.sort(idx_j, 1)).all(1)
    a, b = nt[:N].numpy(), np.asarray(nj)[:N]
    dot = np.sum(a * b, axis=1)
    assert (dot[rows] >= 1 - 1e-5).all()


def test_estimate_curvature_large_k_matches_jax(runs, torus):
    """max_neighbors=200 at k_fraction 0.2 (k = min(400, 200, n - 1) =
    200), on the rows whose id sets agree with the JAX package's
    ``knn_cloud_grid`` (the fixture's, at the same k); max_neighbors=1025
    at the default fraction runs at the JAX package's k = 50 and matches
    the JAX package by tests/test_torch_compat.py's rule."""
    run, pts = runs(200), torus
    sj = jcompat.estimate_curvature(pts, k_fraction=0.2, max_neighbors=200)
    st = compat.estimate_curvature(pts, k_fraction=0.2, max_neighbors=200,
                                   device="cpu")
    assert st.shape == (N,) and (st >= 0).all()
    rows = (np.sort(run["knn"].indices[:N].numpy(), 1)
            == np.sort(run["jax_ids"], 1)).all(1)
    assert rows.mean() >= 0.999
    np.testing.assert_allclose(st[rows], np.asarray(sj)[rows], rtol=0,
                               atol=1e-4 * np.abs(sj).max())
    assert _estimate_parity(pts, 0.025, 1025) == 50


@pytest.fixture(scope="module")
def tile_k160():
    """A tiny tile (2 rows, 4 queries, 200 candidate slots) and the JAX
    package's positions select on it at k = 160, interpret mode."""
    tile = _random_tile(11, T=2, C=4, M=200)
    dj, pj = (np.asarray(a) for a in jax_select(
        *(jnp.asarray(a) for a in tile), 160, interpret=True))
    return tile, dj, pj


@pytest.mark.parametrize("want", ["coords", "rows", "pos"])
def test_selects_k160_match_pallas_interpret(tile_k160, want):
    k, T, C = 160, 2, 4
    tile, dj, pj = tile_k160
    ops = [torch.from_numpy(a) for a in tile]
    tfn = {"coords": knn_select_coords, "rows": knn_select_rows,
           "pos": knn_select}[want]
    dt, wt = (a.numpy() for a in tfn(*ops, k))
    assert dt.shape == (T, C, k)
    found = dt < 1e18
    assert found.any()
    np.testing.assert_array_equal(found, dj < 1e18)
    np.testing.assert_allclose(dt[found], dj[found], rtol=2e-6, atol=0)
    idx = np.arange(T)[:, None, None]
    wj = {"pos": pj, "rows": tile[2][idx, pj], "coords": tile[1][idx, pj]
          }[want]
    assert wt.shape == wj.shape
    for t in range(T):
        for c in range(C):
            f = found[t, c]
            np.testing.assert_array_equal(np.sort(wt[t, c][f], 0),
                                          np.sort(wj[t, c][f], 0))
    _, pos = knn_select(*ops, k)
    if want == "rows":
        assert torch.equal(torch.from_numpy(wt), torch.gather(
            ops[2], 1, pos.reshape(T, -1).long()).reshape(T, C, k))
    elif want == "coords":
        assert torch.equal(torch.from_numpy(wt), torch.gather(
            ops[1], 1, pos.reshape(T, -1, 1).long().expand(-1, -1, 3)
        ).reshape(T, C, k, 3))
