"""The moments route's epilogue (``ops.epilogue``) against the JAX
package, on the CPU.

``epilogue_plain``, the plain version of ``csrc/epilogue.cu`` (which
holds it bit for bit on the card, tests/test_torch_cuda.py), against
``pct_tpu.fit.moments.curvature_from_moments`` at the port's existing
tolerances (tests/test_torch_moments.py: 1e-5·max|x| for K, H, k1, k2,
H², 1e-5 for the normals): on every real query row of a 3000-point
torus at k=100, and on rows that take the chain's guarded branches
(padding, the +z fallback, a dead Cholesky pivot, the small-rotation
identity). Then the public path on a second cloud, and the wrapper's
operand checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pct_tpu.fit.moments as jmom
import pct_tpu_torch.ops.epilogue as ep
from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.fit.moments import MOMENT_EXPS
from pct_tpu_torch.neighbors import cellknn
from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
from pct_tpu_torch.ops.moments import knn_moments
from pct_tpu_torch.pipeline.fused import SPLIT_TO, plan_engine
from pct_tpu_torch.shapes import generate_shape
from tests.test_torch_moments import _public_paths_agree

K_MOM = 100


def _jax_rows(stats: np.ndarray, rotation: str) -> np.ndarray:
    """The JAX package's chain on (rows, 48) stats, in the kernel's
    (rows, 8) layout."""
    curv, n = jmom.curvature_from_moments(
        jnp.asarray(stats[:, :35]), jnp.asarray(stats[:, 38]),
        jnp.asarray(stats[:, 39:42]), jnp.asarray(stats[:, 42:45]),
        rotation=rotation)
    return np.concatenate([np.stack([np.asarray(c) for c in curv], 1),
                           np.asarray(n)], 1)


def _agree_with_jax(stats: np.ndarray) -> np.ndarray:
    got = ep.epilogue_plain(torch.from_numpy(stats)).numpy()
    for rotation in ("symbolic", "tensor"):
        want = _jax_rows(stats, rotation)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        for c in range(5):
            b = want[:, c]
            np.testing.assert_allclose(got[:, c], b, rtol=0,
                                       atol=1e-5 * np.abs(b[b == b]).max(
                                           initial=0.0))
        np.testing.assert_allclose(got[:, 5:], want[:, 5:], rtol=0,
                                   atol=1e-5)
    return got


def _stats_of(pts, near, kth, sigma=1.0):
    """One (48,) stats row of an explicit neighbourhood (offsets from the
    query), moments of r/σ summed in float64."""
    p = np.asarray(pts, np.float64) / sigma
    s = np.zeros(48, np.float64)
    for i, (a, b, c) in enumerate(MOMENT_EXPS):
        s[i] = np.sum(p[:, 0]**a * p[:, 1]**b * p[:, 2]**c)
    s[38], s[39:42], s[42:45] = sigma, near, kth
    return s.astype(np.float32)


@pytest.fixture(scope="module")
def torus_stats():
    """The stats of every real query slot of a 3000-point perturbed
    torus at k=100 through the moments kernel's plain version, on the
    layout ``fast_curvature`` plans (every bucket). Padding slots are
    left out: their stats (σ up to ~1.7e9 from far candidates, or all
    zero) feed no output, and where they are not all zero both chains
    compute noise there (the all-zero case is in the guarded rows)."""
    pts = generate_shape("torus", 3000, perturbation_strength=1e-3,
                         seed=1)[1]
    c = from_numpy(pts, device="cpu")
    cell = estimate_cell_size(c.points, c.num_points, K_MOM)
    grid = build_grid(c.points, c.num_points, cell)
    engine, spec, mc, factor = plan_engine(grid, K_MOM)
    assert engine == "moments"
    cells = cellknn.compact_cells(grid, mc)
    if factor > 1:
        cells = cellknn.split_cells(cells, grid.sorted_points.shape[0],
                                    SPLIT_TO, factor)
    rows = []
    for sp, args in cellknn.bucketed_tile_args(grid, cells, spec):
        cand, ok, cpts, qpts, qrow, ok_q = cellknn._tile_candidates(
            grid, args, sp.capacity, sp.cand_cap)[:6]
        stats = knn_moments(qpts, cpts, cand, qrow, ok.to(torch.int32), K_MOM)
        rows.append(stats[ok_q])
    return torch.cat(rows).numpy()


def test_epilogue_plain_matches_jax_on_torus_rows(torus_stats):
    assert torus_stats.shape == (3000, 48)
    got = _agree_with_jax(torus_stats)
    assert np.isfinite(got).all()


def _case(name):
    g = np.arange(-2, 3) / 4.0
    x, y = (a.ravel() for a in np.meshgrid(g, g))
    t = np.arange(-8, 9) / 16.0
    if name == "padding":
        return np.zeros((1, 48), np.float32)
    if name == "isotropic":                      # ±x, ±y, ±z at 0.5
        pts = 0.5 * np.concatenate([np.eye(3), -np.eye(3)])
        return _stats_of(pts, pts[0], pts[0])[None]
    if name == "collinear":                      # a line off every axis
        pts = np.stack([t, t / 2, t / 4], 1)
        return _stats_of(pts, pts[8], pts[-1])[None]
    sign = 1.0 if name == "plus_z" else -1.0     # the sign fix picks ±z
    pts = np.stack([x, y, (x * x + y * y) / 2], 1)
    return _stats_of(pts, np.zeros(3), np.array([0.0, 0.0, sign]))[None]


@pytest.mark.parametrize("name", ["padding", "isotropic", "collinear",
                                  "plus_z", "minus_z"])
def test_epilogue_plain_matches_jax_on_guarded_rows(name):
    """Each case takes the branch it is named for, and agrees with the
    JAX package there: all-zero padding rows (the count clamp, NaN
    curvature from the overflowing 1/sa⁴ as in the JAX chain); an
    isotropic covariance (the +z fallback); a collinear neighbourhood
    (dead Cholesky pivots); a normal already on ±z (the identity
    rotation of the small-rotation test)."""
    stats = _case(name)
    got = _agree_with_jax(stats)
    t = torch.from_numpy(stats)
    m = [t[:, j] for j in range(35)]
    R = ep._rotation(*(torch.from_numpy(got[:, c]) for c in (5, 6, 7)))
    eye = [[float(R[i][j][0]) for j in range(3)] for i in range(3)]
    if name == "padding":
        assert np.isnan(got[:, :5]).all()
        assert (got[:, 5:] == [0.0, 0.0, 1.0]).all()
    elif name == "isotropic":
        assert (got[:, 5:] == [0.0, 0.0, 1.0]).all()
    elif name == "collinear":
        G, rhs, *_ = ep._normal_equations(ep._rotated(m, R), m[0])
        _, invd = ep._solve(G, rhs)
        assert any(float(d[0]) == 0.0 for d in invd)
        assert np.isfinite(got).all()
    else:
        assert (got[:, 5:] == [0.0, 0.0, 1.0 if name == "plus_z"
                                else -1.0]).all()
        assert eye == [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        assert np.abs(got[:, 0]).max() > 0.1     # a curved patch


def test_fast_curvature_k100_on_sphere_matches_jax_public_path():
    """The public path through the epilogue on a second cloud, at
    ``test_fast_curvature_k100_matches_jax_public_path``'s tolerances."""
    pts = generate_shape("sphere", 3000, perturbation_strength=1e-3,
                         seed=2)[1]
    _, e_t = _public_paths_agree(pts, K_MOM)
    assert e_t.mean() > 0.99


def test_moments_epilogue_checks_its_operands():
    ok = torch.zeros(4, 48)
    assert ep.moments_epilogue(ok).shape == (4, 8)
    with pytest.raises(ValueError, match="float32"):
        ep.moments_epilogue(ok.double())
    with pytest.raises(ValueError, match=r"\(rows, 48\)"):
        ep.moments_epilogue(torch.zeros(4, 47))
    with pytest.raises(ValueError, match=r"\(rows, 48\)"):
        ep.moments_epilogue(torch.zeros(48))
    with pytest.raises(ValueError, match="contiguous"):
        ep.moments_epilogue(torch.zeros(4, 96)[:, ::2])
    with pytest.raises(ValueError, match="no epilogue kernel"):
        ep.moments_epilogue(torch.zeros(4, 48, device="meta"))
