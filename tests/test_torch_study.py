"""Masked neighborhoods, PCA curvature, the neighbor study and the numpy
helpers: the port against the JAX package, on the CPU.

- Masked ``neighborhood_covariance``/``estimate_normals``/
  ``tangent_frames``/``fit_quadratic`` on k=20 neighborhoods of a
  perturbed torus with ragged masks (a random valid prefix of 12–20
  slots, plus random holes), rtol 1e-5 with absolute parts scaled by
  each quantity's magnitude, as tests/test_torch_fit.py holds the
  unmasked chain; masked ``fit_quadric`` on tests/test_torch_implicit.py's
  ellipsoid caps (40 slots, a valid prefix of 30–40 plus holes) at its
  bound 2e-4: with 20 valid slots neither package's quadric is
  determined by float32 (both 0.024 from float64 at worst), with 30
  both agree to 9e-5. ``mask=None`` runs the unmasked path, and an
  all-True mask gives its numbers bit for bit.
- ``pointwise_curvature(neighbor_mask=)``, both methods, on the same
  points, indices and mask in both packages: explicit K/H within
  1e-4·max|K| (max|H|); implicit, on k=30 neighborhoods with a valid
  prefix of 20–30 slots, under tests/test_torch_implicit.py's rule for
  its float32 noise (1e-4·max + 2e-3·|value| on 99% of rows).
- ``pca_principal_curvatures`` and ``surface_variation``, with and
  without a mask: 1e-4 of each quantity's largest value (eigenvectors
  up to sign). Both packages gather raw coordinates (~1.3 from the
  origin) and subtract their mean in the covariance, so its entries
  carry ~1e-7 absolute rounding against a largest eigenvalue of ~0.02.
- ``_ladder_converged_k`` on the same sample and neighbor lists: the
  converged k of every sample equal. The threshold is placed in a gap
  of the rung differences, so that no decision sits within float32
  noise of it.
- The study's neighbor lists on a tied cloud (a dyadic lattice surface,
  every distance exact, ties at many rungs): each package's own
  ``knn_grid`` gives the same lists in the same order (the lower
  candidate first on equal distances, as ``lax.top_k``), so each
  package's ladder on its own lists converges at the same k.
- ``explicit_quadratic_neighbor_study`` on a small sphere: the two
  packages draw different samples (torch's generator cannot reproduce
  jax.random), so the recommended k may differ by the sampling noise:
  at most 2 here.
- ``utils.filters`` and ``utils.transforms``: equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pct_tpu.curvature.explicit as jcurv
import pct_tpu.fit as jfit
import pct_tpu.pipeline.neighbor_study as jstudy
import pct_tpu.utils.filters as jfilters
import pct_tpu.utils.transforms as jtransforms
from pct_tpu.core import from_numpy as jax_from_numpy
from pct_tpu.neighbors.grid import build_grid as jax_build_grid
from pct_tpu.neighbors.knn import knn_grid as jax_knn_grid
from pct_tpu.curvature.pca import pca_principal_curvatures as jax_pca
from pct_tpu.curvature.pca import surface_variation as jax_sv
from pct_tpu.pipeline import pointwise_curvature as jax_pointwise
from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.curvature import (
    explicit_curvatures,
    pca_principal_curvatures,
    surface_variation,
)
from pct_tpu_torch.fit import (
    estimate_normals,
    fit_quadratic,
    fit_quadric,
    neighborhood_covariance,
    tangent_frames,
)
from pct_tpu_torch.pipeline import (
    explicit_quadratic_neighbor_study,
    pointwise_curvature,
)
from pct_tpu_torch.neighbors import knn_grid
from pct_tpu_torch.neighbors.grid import build_grid
from pct_tpu_torch.pipeline.neighbor_study import _ladder_converged_k
from pct_tpu_torch.shapes import generate_shape
from pct_tpu_torch.utils import filters, transforms
from tests.test_torch_implicit import _ellipsoid_caps

RTOL = 1e-5
K_NB = 20


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _knn(pts, k):
    """Distance-sorted k nearest (self excluded) by numpy brute force."""
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.argsort(d2, axis=1, kind="stable")[:, :k].astype(np.int32)


def _ragged_mask(rng, shape, lo=12):
    """A valid prefix of lo..k slots per row, plus ~10% holes after the
    first ``lo`` slots."""
    q, k = shape
    keep = rng.integers(lo, k + 1, q)
    mask = np.arange(k)[None, :] < keep[:, None]
    holes = rng.random(shape) < 0.1
    holes[:, :lo] = False
    return mask & ~holes


@pytest.fixture(scope="module")
def torus():
    _, pts = generate_shape("torus", 1200, perturbation_strength=0.002,
                            seed=4)
    idx = _knn(pts, K_NB)
    centered = (pts[idx] - pts[:, None, :]).astype(np.float32)
    mask = _ragged_mask(np.random.default_rng(7), idx.shape)
    return pts, idx, centered, mask


def test_masked_frames_match_jax(torus):
    _, _, c, m = torus
    ct, mt = torch.from_numpy(c), torch.from_numpy(m)
    cj, mj = jnp.asarray(c), jnp.asarray(m)
    _close(neighborhood_covariance(ct, mt).numpy(),
           jfit.neighborhood_covariance(cj, mj))
    n_t, lam_t = estimate_normals(ct, mt)
    n_j, lam_j = jfit.estimate_normals(cj, mj)
    _close(n_t.numpy(), n_j)
    _close(lam_t.numpy(), lam_j)
    rot_t, R_t, nn_t = tangent_frames(ct, mt)
    rot_j, R_j, nn_j = jfit.tangent_frames(cj, mj)
    _close(nn_t.numpy(), nn_j)
    _close(R_t.numpy(), R_j)
    _close(rot_t.numpy(), rot_j)
    # the sign reference is the farthest VALID slot: flipping the masks'
    # last slots off moves it, and the normals still agree
    assert (~m[:, -1]).mean() > 0.5


def test_masked_quadratic_fit_matches_jax(torus):
    _, _, c, m = torus
    rot = np.array(jfit.tangent_frames(jnp.asarray(c), jnp.asarray(m))[0])
    c_j = np.array(jfit.fit_quadratic(jnp.asarray(rot), jnp.asarray(m)))
    c_t = fit_quadratic(torch.from_numpy(rot), torch.from_numpy(m)).numpy()
    for col in range(5):
        _close(c_t[:, col], c_j[:, col])
    np.testing.assert_allclose(c_t[:, 5], c_j[:, 5], rtol=0,
                               atol=RTOL * np.abs(rot[..., 2]).max())
    for a, b in zip(explicit_curvatures(torch.from_numpy(c_j)),
                    jcurv.explicit_curvatures(jnp.asarray(c_j))):
        _close(a.numpy(), b)
    # masking really changes the fit
    assert np.abs(c_t - fit_quadratic(torch.from_numpy(rot)).numpy()).max() \
        > 1e-2 * np.abs(c_t).max()


def test_masked_quadric_fit_matches_jax():
    caps = _ellipsoid_caps(3)
    m = _ragged_mask(np.random.default_rng(8), caps.shape[:2], lo=30)
    cj = np.asarray(jfit.fit_quadric(jnp.asarray(caps), jnp.asarray(m)))
    ct = fit_quadric(torch.from_numpy(caps), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(ct, cj, rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(ct, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("fn", ["covariance", "normals", "frames",
                                "quadratic", "quadric"])
def test_mask_none_and_all_true(torus, fn):
    """``mask=None`` is the unmasked call; an all-True mask gives the
    same bits (the masked sums run in the unmasked layout)."""
    _, _, c, _ = torus
    ct = torch.from_numpy(c)
    ones = torch.ones(c.shape[:2], dtype=torch.bool)
    f = {"covariance": neighborhood_covariance,
         "normals": lambda x, m=None: estimate_normals(x, m)[0],
         "frames": lambda x, m=None: tangent_frames(x, m)[0],
         "quadratic": fit_quadratic,
         "quadric": fit_quadric}[fn]
    plain = f(ct)
    assert torch.equal(f(ct, None), plain)
    assert torch.equal(f(ct, ones), plain)


@pytest.mark.parametrize("method", ["explicit", "implicit"])
def test_pointwise_curvature_mask_matches_jax(torus, method):
    pts, idx, _, m = torus
    if method == "implicit":        # the 10-coefficient fit needs more slots
        idx = _knn(pts, 30)
        m = _ragged_mask(np.random.default_rng(7), idx.shape, lo=20)
    rj = jax_pointwise(jnp.asarray(pts), jnp.asarray(idx), method=method,
                       tile=512, neighbor_mask=jnp.asarray(m))
    rt = pointwise_curvature(torch.from_numpy(pts), torch.from_numpy(idx),
                             method=method, tile=512,
                             neighbor_mask=torch.from_numpy(m))
    _close(rt[1].numpy(), rj[1])                              # normals
    for name in ("K", "H"):
        a = getattr(rt[0], name).numpy()
        b = np.asarray(getattr(rj[0], name))
        assert np.isfinite(a).all()
        tol = 1e-4 * np.abs(b).max()
        if method == "explicit":
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)
        else:
            assert (np.abs(a - b) <= tol + 2e-3 * np.abs(b)).mean() >= 0.99
    unmasked = pointwise_curvature(torch.from_numpy(pts),
                                   torch.from_numpy(idx), method=method)
    assert not torch.equal(unmasked[0].K, rt[0].K)
    ones = pointwise_curvature(torch.from_numpy(pts), torch.from_numpy(idx),
                               method=method,
                               neighbor_mask=torch.ones(idx.shape, dtype=bool))
    for a, b in zip((*unmasked[0], *unmasked[1:]), (*ones[0], *ones[1:])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_pca_matches_jax(torus, masked):
    pts, idx, _, m = torus
    mt = torch.from_numpy(m) if masked else None
    mj = jnp.asarray(m) if masked else None
    rt = pca_principal_curvatures(torch.from_numpy(pts),
                                  torch.from_numpy(idx), mt)
    rj = jax_pca(jnp.asarray(pts), jnp.asarray(idx), mj)
    for name in ("k1", "k2", "K", "H"):
        _close(getattr(rt, name).numpy(), getattr(rj, name), rtol=1e-4)
    for name in ("dir1", "dir2"):
        dots = np.abs(np.sum(getattr(rt, name).numpy()
                             * np.asarray(getattr(rj, name)), -1))
        np.testing.assert_allclose(dots, 1.0, atol=1e-4)
    _close(surface_variation(torch.from_numpy(pts), torch.from_numpy(idx),
                             mt).numpy(),
           jax_sv(jnp.asarray(pts), jnp.asarray(idx), mj), rtol=1e-4)


def _gap_threshold(values):
    """A threshold in the widest relative gap between the middle 80% of
    ``values``: every value lies at least that gap's half away."""
    v = np.sort(values[values > 0])
    v = v[int(0.1 * len(v)):int(0.9 * len(v))]
    ratio = v[1:] / v[:-1]
    i = int(np.argmax(ratio))
    assert ratio[i] > 1.01, ratio[i]
    return float(np.sqrt(v[i] * v[i + 1]))


@pytest.mark.parametrize("criterion", ["absolute", "relative"])
def test_ladder_converged_k_matches_jax(criterion):
    _, pts = generate_shape("torus", 3000, perturbation_strength=1e-3,
                            seed=2)
    sample = np.random.default_rng(0).choice(3000, 64, replace=False
                                             ).astype(np.int32)
    kmin, kmax = 6, 24
    d2 = ((pts[sample, None, :] - pts[None, :, :]) ** 2).sum(-1)
    d2[np.arange(64), sample] = np.inf
    nbr = np.argsort(d2, axis=1, kind="stable")[:, :kmax + 1].astype(np.int32)
    # the port's rung curvatures place the threshold
    nb = torch.from_numpy(pts[nbr] - pts[sample][:, None, :])
    K = np.stack([explicit_curvatures(fit_quadratic(
        tangent_frames(nb, m)[0], m)).K.numpy() for m in (
        torch.arange(kmax + 1) < k for k in range(kmin, kmax + 2))])
    diff = np.abs(K[1:] - K[:-1]).astype(np.float64)
    if criterion == "absolute":
        tol, tol_rel = _gap_threshold(diff), 0.0
    else:
        tol, tol_rel = 0.0, _gap_threshold(diff / np.abs(K[:-1]))
    scale_sq = 1.0
    k_j, c_j = jstudy._ladder_converged_k(
        jnp.asarray(pts), jnp.asarray(sample), jnp.asarray(nbr), kmin, kmax,
        tol, scale_sq=scale_sq, tol_rel=tol_rel)
    k_t, c_t = _ladder_converged_k(
        torch.from_numpy(pts), torch.from_numpy(sample),
        torch.from_numpy(nbr), kmin, kmax, tol, scale_sq=scale_sq,
        tol_rel=tol_rel)
    assert k_t.dtype == torch.int32
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    assert 0.2 < c_t.float().mean() and k_t[c_t].float().std() > 1


def test_study_ladder_from_own_knn_grid_on_tied_cloud():
    """The study's steps after its sample and cell size, in each package
    on its own: ``knn_grid`` of the sample (kmax + 1 neighbors, the
    study's capacity), then ``_ladder_converged_k``. The cloud is
    z = (x² − y²)/8 + x³/64 over an integer (x, y) lattice: dyadic
    coordinates, exact d², many neighbors at equal distance; the cell
    size is fixed, as the packages' own estimates differ in the last
    bits (tests/test_torch_grid.py)."""
    rng = np.random.default_rng(4)
    x, y = np.meshgrid(np.arange(-9, 10), np.arange(-9, 10), indexing="ij")
    z = (x * x - y * y) / 8 + x ** 3 / 64
    pts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    pts = pts[rng.permutation(len(pts))]
    n = len(pts)
    sample = rng.choice(n, 64, replace=False).astype(np.int32)
    kmin, kmax = 6, 24
    cell = np.float32(3.0)
    gj = jax_build_grid(jnp.asarray(pts), n, jnp.asarray(cell))
    gt = build_grid(torch.from_numpy(pts), n, torch.tensor(cell))
    kw = dict(capacity=int(2.5 * kmax) + 16, tile=64)
    rj = jax_knn_grid(gj, jnp.asarray(pts[sample]), kmax + 1,
                      query_indices=jnp.asarray(sample), **kw)
    rt = knn_grid(gt, torch.from_numpy(pts[sample]), kmax + 1,
                  query_indices=torch.from_numpy(sample), **kw)
    nbr_j, nbr_t = np.asarray(rj.indices), rt.indices.numpy()
    d = rt.dists.numpy()
    assert (d[:, 1:] == d[:, :-1]).mean() > 0.1      # ties at many rungs
    np.testing.assert_array_equal(nbr_t, nbr_j)
    # the port's rung curvatures place the threshold, as above
    nb = torch.from_numpy(pts[nbr_t] - pts[sample][:, None, :])
    K = np.stack([explicit_curvatures(fit_quadratic(
        tangent_frames(nb, m)[0], m)).K.numpy() for m in (
        torch.arange(kmax + 1) < k for k in range(kmin, kmax + 2))])
    tol = _gap_threshold(np.abs(K[1:] - K[:-1]).astype(np.float64))
    k_j, c_j = jstudy._ladder_converged_k(
        jnp.asarray(pts), jnp.asarray(sample), jnp.asarray(nbr_j), kmin,
        kmax, tol, scale_sq=1.0)
    k_t, c_t = _ladder_converged_k(
        torch.from_numpy(pts), torch.from_numpy(sample),
        torch.from_numpy(nbr_t), kmin, kmax, tol, scale_sq=1.0)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    assert 0.2 < c_t.float().mean()


def test_neighbor_study_sphere_matches_jax():
    pts, _ = generate_shape("sphere", 2000, radius=1.0)
    k_t, per_t = explicit_quadratic_neighbor_study(
        from_numpy(pts, device="cpu"), tol=1e-3, sample_size=64, kmax=30,
        device="cpu")
    k_j, per_j = jstudy.explicit_quadratic_neighbor_study(
        jax_from_numpy(pts), tol=1e-3, sample_size=64, kmax=30)
    print(f"recommended k: port {int(k_t)}, JAX {int(k_j)}")
    assert abs(int(k_t) - int(k_j)) <= 2
    assert per_t.shape == (64,) and per_t.dtype == torch.int32
    assert (per_t[per_t > 0] >= 3).all() and (per_t <= 30).all()
    # the same seed draws the same sample
    k_again, per_again = explicit_quadratic_neighbor_study(
        from_numpy(pts, device="cpu"), tol=1e-3, sample_size=64, kmax=30,
        device="cpu")
    assert int(k_again) == int(k_t) and torch.equal(per_again, per_t)


@pytest.mark.parametrize("case", [
    "running_mean", "running_mean_compat", "median", "absolute"])
def test_filters_match_jax(case):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(200) * 3.0
    x[rng.choice(200, 12, replace=False)] *= 400.0
    fn, kw = {"running_mean": ("running_mean_outlier", {}),
              "running_mean_compat": ("running_mean_outlier",
                                      {"compat_first_iteration": True}),
              "median": ("filter_outliers_median", {"threshold": 5.0}),
              "absolute": ("filter_outliers_absolute", {"max_abs": 50.0})
              }[case]
    got = getattr(filters, fn)(x, **kw)
    want = getattr(jfilters, fn)(x, **kw)
    np.testing.assert_array_equal(got, want)
    if case != "running_mean_compat":     # one step: nothing replaced here
        assert not np.array_equal(np.nan_to_num(got), x)


@pytest.mark.parametrize("compat_z_from_y,lexsort", [
    (False, False), (True, False), (False, True), (True, True)])
def test_transforms_match_jax(compat_z_from_y, lexsort):
    pts = np.random.default_rng(4).standard_normal((300, 3)).astype(
        np.float32)
    args = (pts, 0.3, -1.1, 2.0)
    got = transforms.rotate_point_cloud(*args, compat_z_from_y=compat_z_from_y,
                                        lexsort=lexsort)
    want = jtransforms.rotate_point_cloud(
        *args, compat_z_from_y=compat_z_from_y, lexsort=lexsort)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
