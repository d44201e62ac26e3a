"""Grid, cell table, candidate runs and bucket probe: the port against
the JAX package on the same cloud and the same cell size; and the bound
on the packages' own cell sizes, which differ in their last bits
(``estimate_cell_size``'s docstring)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pct_tpu.neighbors.cellknn as jck
from pct_tpu.core import from_numpy as jax_from_numpy
from pct_tpu.neighbors import knn_cloud_grid as jax_knn_cloud_grid
from pct_tpu.neighbors.grid import build_grid as jax_build_grid
from pct_tpu.neighbors.grid import estimate_cell_size as jax_cell_size
from pct_tpu.shapes import generate_shape as jax_generate_shape
import pct_tpu_torch.neighbors.cellknn as tck
from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.neighbors import knn_cloud_grid
from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
from pct_tpu_torch.shapes import generate_shape


def _two_clusters(n=1500):
    """A sparse bounding box: more cell boxes than the dense run table
    holds, so ``_runs_table`` takes its sorted-search branch."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((n // 2, 3)).astype(np.float32) * 0.05
    b = a + np.float32(40.0)
    return np.concatenate([a, b])


CLOUDS = {
    "torus": lambda: generate_shape("torus", 3000)[0],
    "sphere": lambda: generate_shape("sphere", 2000)[0],
    "clusters": _two_clusters,
}


def _both(name, k=20):
    pts = CLOUDS[name]()
    cj = jax_from_numpy(pts)
    ct = from_numpy(pts, device="cpu")
    cell = jax_cell_size(cj.points, cj.num_points, k)
    gj = jax_build_grid(cj.points, cj.num_points, cell)
    gt = build_grid(ct.points, ct.num_points,
                    torch.tensor(np.float32(cell)))
    return pts, cj, ct, cell, gj, gt


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_build_grid_matches(name):
    _, _, _, _, gj, gt = _both(name)
    np.testing.assert_array_equal(_np(gt.order), _np(gj.order))
    np.testing.assert_array_equal(_np(gt.sorted_ids), _np(gj.sorted_ids))
    np.testing.assert_array_equal(_np(gt.sorted_points),
                                  _np(gj.sorted_points))
    np.testing.assert_array_equal(_np(gt.origin), _np(gj.origin))
    assert gt.dims == tuple(int(d) for d in np.asarray(gj.dims))


@pytest.mark.parametrize("name", ["torus", "sphere"])
def test_estimate_cell_size_matches(name):
    pts, cj, ct, cell, _, _ = _both(name)
    for k in (10, 20):
        want = float(jax_cell_size(cj.points, cj.num_points, k))
        got = float(estimate_cell_size(ct.points, ct.num_points, k))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_cells_runs_and_candidates_match(name):
    _, _, _, _, gj, gt = _both(name)
    n = gt.sorted_points.shape[0]
    mc = 1 << (n - 1).bit_length()
    cj = jck.compact_cells(gj, mc)
    ct = tck.compact_cells(gt, mc)
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(_np(a), _np(b))
    dense_cap = min(tck.DENSE_CELLS, 1 << (4 * n - 1).bit_length())
    assert (np.prod(gt.dims) > dense_cap) == (name == "clusters")
    rs_j, rl_j = jck._runs_table(gj, cj)
    rs_t, rl_t = tck._runs_table(gt, ct)
    np.testing.assert_array_equal(_np(rl_t), _np(rl_j))
    np.testing.assert_array_equal(_np(rs_t), _np(rs_j))

    # one bucket's candidate fetch, on the JAX bucket tables
    spec, _ = jck.probe_grid_buckets(gj)
    sp = spec[-1]
    args_j = [(sp, a) for sp, a, _ in jck.bucketed_tile_args(
        gj, cj, spec, 128, "xla", demote_pallas=False, pack=1)][-1][1]
    flat = [np.array(a).reshape((-1,) + a.shape[2:]) for a in args_j]
    cand_j, ok_j, cpts_j, qpts_j, qrow_j, okq_j, cover_j, _, _ = \
        jck._tile_candidates(gj, tuple(jnp.asarray(a) for a in flat),
                             sp.capacity, sp.cand_cap, pack=1)
    cand_t, ok_t, cpts_t, qpts_t, qrow_t, okq_t, cover_t, _ = \
        tck._tile_candidates(gt, tuple(torch.from_numpy(a) for a in flat),
                             sp.capacity, sp.cand_cap)
    np.testing.assert_array_equal(_np(cand_t), _np(cand_j))
    np.testing.assert_array_equal(_np(ok_t), _np(ok_j))
    np.testing.assert_array_equal(_np(cpts_t),
                                  np.stack([_np(a) for a in cpts_j], -1))
    np.testing.assert_array_equal(_np(qpts_t), _np(qpts_j))
    np.testing.assert_array_equal(_np(qrow_t), _np(qrow_j))
    np.testing.assert_array_equal(_np(okq_t), _np(okq_j))
    np.testing.assert_array_equal(_np(cover_t), _np(cover_j))


@pytest.mark.parametrize("max_cells", [64, 128])
def test_cell_table_overflow_matches(max_cells):
    """A table smaller than the occupied-cell count drops cells and sets
    ``overflow`` exactly as the JAX package does."""
    _, _, _, _, gj, gt = _both("torus")
    cj = jck.compact_cells(gj, max_cells)
    ct = tck.compact_cells(gt, max_cells)
    assert bool(ct.overflow)
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(tck._runs_table(gt, ct), jck._runs_table(gj, cj)):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_probe_grid_buckets_same_spec(name):
    _, _, _, _, gj, gt = _both(name)
    spec_j, mc_j = jck.probe_grid_buckets(gj, capacity_cap=256)
    spec_t, mc_t = tck.probe_grid_buckets(gt, capacity_cap=256)
    assert mc_t == mc_j
    assert [tuple(s) for s in spec_t] == [tuple(s) for s in spec_j]


def test_port_generators_match_reference():
    for shape in ("sphere", "torus"):
        for strength in (0.0, 0.01):
            a = generate_shape(shape, 777, radius=2.0,
                               perturbation_strength=strength, seed=3)
            b = jax_generate_shape(shape, 777, radius=2.0,
                                   perturbation_strength=strength, seed=3)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,n", [("torus", 200_000), ("sphere", 100_000)])
def test_own_cell_size_within_1e4_of_jax(name, n):
    """Each package's own cell size on the same cloud, at k=20 and
    k=100: relative gap <= 1e-4 (measured 5.6e-5 on the torus, 3.9e-6
    on the sphere; both take d̄ from expanded-form distances whose
    matmul rounds differently)."""
    pts = generate_shape(name, n)[0]
    cj, ct = jax_from_numpy(pts), from_numpy(pts, device="cpu")
    for k in (20, 100):
        want = float(jax_cell_size(cj.points, cj.num_points, k))
        got = float(estimate_cell_size(ct.points, ct.num_points, k))
        assert abs(got - want) / want <= 1e-4, (k, got, want)


@pytest.mark.parametrize("cloud,k", [("torus_blob", 20), ("torus", 12)])
def test_own_cell_size_exact_fraction_matches_jax(cloud, k):
    """``knn_cloud_grid`` without the repair, each package on its own cell
    size: the certified fractions agree within 1e-3 (4 rows of the 4000
    of the torus + blob cloud, whose overfull blob cells stay
    uncertified; 10 of the 10k torus). A grid a few ulps wider or
    narrower can move only certificates whose kth distance sits on a
    window edge; measured: equal."""
    from tests.test_torch_knn import _torus_blob
    pts = (_torus_blob() if cloud == "torus_blob"
           else generate_shape("torus", 10_000)[0])
    n = len(pts)
    rj, _ = jax_knn_cloud_grid(jax_from_numpy(pts), k, exact_fallback=False)
    rt, _ = knn_cloud_grid(from_numpy(pts, device="cpu"), k,
                           exact_fallback=False, device="cpu")
    frac_j = float(np.asarray(rj.exact)[:n].mean())
    frac_t = float(rt.exact[:n].float().mean())
    assert abs(frac_t - frac_j) <= 1e-3, (frac_t, frac_j)
    assert frac_t > 0.9
