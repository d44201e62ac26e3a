"""The loose ends the mesh path needs, the analytic shapes and the
sampled 1-NN distances, against the JAX package on the CPU.

- Every shape of ``SHAPES``, the Möbius strip and the Dupin cyclide,
  clean and perturbed: the same (n, seed) gives the JAX package's
  float32 points bit for bit; ``analytic_curvatures``, ``analytic_area``,
  ``analytic_energies`` and ``density_for_target_points`` agree to 1e-7
  relative.
- ``sampled_nn_distances``: NaN on the same rows; the mean within 1e-4
  relative of the JAX package's (the cell-size bound C2); each sample's
  distance, in both packages, against a float64 brute-force 1-NN of the
  same sample row. Both packages take the expanded-form distance
  |s|² + |p|² − 2s·p, which cancels at 1-NN separations: its error in
  d² is a few ulps of |s|², so in d about eps·|s|²/d. Each distance is
  held to 4·eps·|s|²/d_ref + 1e-6·d_ref; the largest measured error is
  1.8·eps·|s|²/d_ref in either package (the cyclide's near-duplicate
  pairs reach 36% relative in both, the same float32 value).
"""

import numpy as np
import pytest

import pct_tpu.shapes as jshapes
from pct_tpu.core import from_numpy as jax_from_numpy
from pct_tpu.neighbors.bruteforce import (
    sampled_nn_distances as jax_sampled_nn_distances,
)
import pct_tpu_torch.shapes as tshapes
from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.neighbors import sampled_nn_distances

ALL_SHAPES = tshapes.SHAPES + ("mobius", "dupin_cyclide")


def test_shape_tables_match():
    assert tshapes.SHAPES == jshapes.SHAPES
    assert set(ALL_SHAPES) == {"sphere", "cylinder", "torus", "egg_carton",
                               "mobius", "dupin_cyclide"}


@pytest.mark.parametrize("shape", ALL_SHAPES)
@pytest.mark.parametrize("n,radius,strength,seed", [
    (1000, 1.0, 0.0, 0), (2047, 2.5, 0.02, 3)], ids=["clean", "perturbed"])
def test_generate_shape_bit_identical(shape, n, radius, strength, seed):
    got = tshapes.generate_shape(shape, n, radius, strength, seed)
    want = jshapes.generate_shape(shape, n, radius, strength, seed)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == (n, 3)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", tshapes.SHAPES)
def test_analytic_oracles_match(shape):
    pts = jshapes.generate_shape(shape, 3000, radius=1.7)[0]
    for a, b in zip(tshapes.analytic_curvatures(shape, pts, radius=1.7),
                    jshapes.analytic_curvatures(shape, pts, radius=1.7)):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=0)
    np.testing.assert_allclose(tshapes.analytic_area(shape, 1.7),
                               jshapes.analytic_area(shape, 1.7), rtol=1e-7)
    for a, b in zip(tshapes.analytic_energies(shape, 1.7),
                    jshapes.analytic_energies(shape, 1.7)):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=0)
    np.testing.assert_allclose(
        tshapes.density_for_target_points(shape, 5000, 1.7),
        jshapes.density_for_target_points(shape, 5000, 1.7), rtol=1e-7)


@pytest.mark.parametrize("shape,n", [("dupin_cyclide", 8000),
                                     ("torus", 700), ("torus", 20_000),
                                     ("sphere", 5000)])
def test_sampled_nn_distances_match_jax(shape, n):
    """700 points leave 324 of the 1024 sample rows invalid (NaN)."""
    pts = tshapes.generate_shape(shape, n)[0]
    cj = jax_from_numpy(pts)
    want = np.asarray(jax_sampled_nn_distances(cj.points, cj.num_points))
    got = sampled_nn_distances(from_numpy(pts, device="cpu").points, n).numpy()
    assert got.shape == want.shape == (1024,)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() == max(0, 1024 - n)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok].mean(), want[ok].mean(), rtol=1e-4)
    # float64 brute force over the same sample rows (i·stride) mod n
    stride = max(n // 1024, 1)
    si = ((np.arange(1024) * stride) % n)[ok]
    p = pts.astype(np.float64)
    ref = np.full(len(si), np.inf)
    for c0 in range(0, n, 2048):
        d = np.linalg.norm(p[si][:, None] - p[None, c0:c0 + 2048], axis=-1)
        d[si[:, None] == np.arange(c0, min(c0 + 2048, n))[None]] = np.inf
        ref = np.minimum(ref, d.min(axis=1))
    tol = (4 * np.finfo(np.float32).eps * np.sum(p[si] ** 2, axis=1) / ref
           + 1e-6 * ref)
    for name, x in (("port", got[ok]), ("jax", want[ok])):
        err = np.abs(x.astype(np.float64) - ref)
        assert (err <= tol).all(), (name, float((err / tol).max()))
