"""The whole slice: the port's explicit k=20 curvature path against the
JAX package, on the CPU.

(a) Same carried state (padded cloud, cell size, bucket spec): the
    port's ``fused_curvature`` against the JAX cell loop
    ``apply_cellwise_bucketed`` with the Pallas select in interpret
    mode. ``exact`` equal; kth distance to rtol 1e-6; K and H within
    1e-5·max|K| (resp. max|H|) on certified rows; normals within 1e-5
    up to sign.
(b) Public entry points, each side computing its own state: the JAX
    ``fast_curvature`` (XLA select, expanded-form distances on the CPU,
    hence the looser bound) against the port's ``fast_curvature``.
(c) Degenerate clouds stay finite.
"""

import numpy as np
import pytest
import torch

import pct_tpu.neighbors.cellknn as jck
from pct_tpu.core import from_numpy as jax_from_numpy
from pct_tpu.neighbors.grid import build_grid as jax_build_grid
from pct_tpu.neighbors.grid import estimate_cell_size as jax_cell_size
from pct_tpu.pipeline.fused import _curvature_of_neighborhoods
from pct_tpu.pipeline.fused import fast_curvature as jax_fast_curvature
from pct_tpu_torch.core import from_numpy, from_reference_arrays
from pct_tpu_torch.neighbors import knn_bruteforce
from pct_tpu_torch.pipeline import fast_curvature, fused_curvature
from pct_tpu_torch.shapes import generate_shape

K_NN = 20


def _cloud(shape):
    """The torus is perturbed: its lattice has exactly symmetric
    neighbors, whose float32 distances tie to the last ulp, and 1-ulp
    differences in d² between XLA's and PyTorch's arithmetic then swap
    their order; the covariance sums change with the order and nearly
    one-dimensional neighborhoods (the torus lattice is 3:1 anisotropic)
    amplify that into visible normal and K differences."""
    if shape == "torus":
        return generate_shape("torus", 3000, perturbation_strength=1e-3,
                              seed=1)[1]
    return generate_shape("sphere", 2000)[0]


CLOUDS = ("sphere", "torus")


def _jax_reference(pts):
    """JAX cell loop with the Pallas select (interpret) + its state."""
    cj = jax_from_numpy(pts)
    cell = jax_cell_size(cj.points, cj.num_points, K_NN)
    grid = jax_build_grid(cj.points, cj.num_points, cell)
    spec, mc = jck.probe_grid_buckets(grid, capacity_cap=256)
    cells = jck.compact_cells(grid, mc)

    def fn(centered, found):
        return _curvature_of_neighborhoods(centered, "explicit", "exact")

    (curv, normals), exact, kth = jck.apply_cellwise_bucketed(
        grid, cells, K_NN, fn, spec, select_impl="pallas_interpret")
    return cj, cell, spec, mc, curv, normals, exact, kth


@pytest.fixture(scope="module", params=CLOUDS)
def slice_pair(request):
    pts = _cloud(request.param)
    n = len(pts)
    cj, cell, spec, mc, curv, normals, exact, kth = _jax_reference(pts)
    state = from_reference_arrays(np.asarray(cj.points), n, cell_size=cell,
                                  bucket_spec=spec, max_cells=mc,
                                  device="cpu")
    res = fused_curvature(state.cloud.points, n, state.cell_size, K_NN,
                          max_cells=state.max_cells,
                          bucket_spec=state.bucket_spec, device="cpu")
    jres = (np.asarray(exact)[:n], np.asarray(kth)[:n],
            np.asarray(curv.K)[:n], np.asarray(curv.H)[:n],
            np.asarray(normals)[:n])
    return pts, n, state, res, jres


def test_slice_matches_jax_cell_loop(slice_pair):
    _, n, _, res, (e_j, kth_j, K_j, H_j, n_j) = slice_pair
    e_t = res.exact[:n].numpy()
    np.testing.assert_array_equal(e_t, e_j)
    assert e_t.mean() > 0.99
    np.testing.assert_allclose(res.kth_dist[:n].numpy(), kth_j, rtol=1e-6)
    c = e_t
    K_t, H_t = res.curv.K[:n].numpy(), res.curv.H[:n].numpy()
    np.testing.assert_allclose(K_t[c], K_j[c], rtol=0,
                               atol=1e-5 * np.abs(K_j[c]).max())
    np.testing.assert_allclose(H_t[c], H_j[c], rtol=0,
                               atol=1e-5 * np.abs(H_j[c]).max())
    nrm = res.normals[:n].numpy()
    sign = np.sign(np.sum(nrm * n_j, axis=1))[:, None]
    np.testing.assert_allclose((nrm * sign)[c], n_j[c], rtol=0, atol=1e-5)


def test_slice_kth_matches_bruteforce(slice_pair):
    """Certified rows carry the true kth-neighbor distance."""
    _, n, state, res, _ = slice_pair
    _, d = knn_bruteforce(state.cloud.points, n, K_NN)
    e = res.exact[:n].numpy()
    np.testing.assert_allclose(res.kth_dist[:n].numpy()[e],
                               d[:n, -1].numpy()[e], rtol=1e-4)


def test_from_reference_arrays_probes_what_is_missing(slice_pair):
    pts, n, state, _, _ = slice_pair
    own = from_reference_arrays(from_numpy(pts, device="cpu").points.numpy(),
                                n, device="cpu")
    # the sampled spacing uses the expanded |q|²+|p|²−2q·p form, whose
    # cancellation leaves ~5e-5 relative error per sample; XLA fuses
    # that arithmetic differently, so the mean agrees to a few 1e-6
    np.testing.assert_allclose(float(own.cell_size), float(state.cell_size),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="max_cells"):
        from_reference_arrays(own.cloud.points.numpy(), n,
                              bucket_spec=own.bucket_spec, device="cpu")


@pytest.mark.parametrize("shape", CLOUDS)
def test_fast_curvature_matches_jax_public_path(shape):
    pts = _cloud(shape)
    n = len(pts)
    rj = jax_fast_curvature(jax_from_numpy(pts), k=K_NN)
    rt = fast_curvature(from_numpy(pts, device="cpu"), K_NN, device="cpu")
    e_j = np.asarray(rj.exact)[:n]
    e_t = rt.exact[:n].numpy()
    assert (e_j == e_t).mean() >= 0.999
    both = e_j & e_t
    K_j = np.asarray(rj.curv.K)[:n]
    K_t = rt.curv.K[:n].numpy()
    np.testing.assert_allclose(K_t[both], K_j[both], rtol=0,
                               atol=1e-4 * np.abs(K_j[both]).max())
    # padding rows of the outputs stay zero
    assert not rt.exact[n:].any() and (rt.curv.K[n:] == 0).all()


@pytest.mark.parametrize("pts", [
    np.random.default_rng(0).standard_normal((7, 3)).astype(np.float32),
    np.ones((300, 3), np.float32),
], ids=["n_below_k", "identical_points"])
def test_degenerate_clouds_stay_finite(pts):
    r = fast_curvature(from_numpy(pts, device="cpu"), K_NN, device="cpu")
    for a in (*r.curv, r.normals, r.kth_dist):
        assert torch.isfinite(a).all()
