"""The moments engine of the port against the JAX package, on the CPU.

(a) ``fit.moments`` on real k=100 neighborhoods of a perturbed torus.
(b) The kernel's plain version, ``moments_plain``, against the JAX
    Pallas kernel in interpret mode and its XLA oracle: on a dyadic
    lattice, where every d² is exact with or without FMA, columns 35–45
    are equal bit for bit (exact ties included, so the fractional tie
    weights are exercised); on real cell-loop tiles, to tolerance.
(c) The slice on carried state: ``fused_curvature(engine="moments")``
    against the JAX one (its XLA path on the CPU) at k=100.
(d) The public path: ``fast_curvature(k=100)`` against the JAX one.

The split layout and the engine choice at k < 64 are in
tests/test_torch_moments_engine.py.

The torus is perturbed for the near-tie reason given in
tests/test_torch_fused.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pct_tpu.fit.moments as jmom
import pct_tpu.neighbors.cellknn as jck
from pct_tpu.core import from_numpy as jax_from_numpy
from pct_tpu.fit.frames import rodrigues_to_z as jax_rodrigues_to_z
from pct_tpu.neighbors.grid import build_grid as jax_build_grid
from pct_tpu.neighbors.grid import estimate_cell_size as jax_cell_size
from pct_tpu.ops.pallas_moments import knn_moments as jax_knn_moments
from pct_tpu.ops.pallas_moments import xla_moment_stats
from pct_tpu.pipeline.fused import fast_curvature as jax_fast_curvature
from pct_tpu.pipeline.fused import fused_curvature as jax_fused_curvature
from pct_tpu_torch.core import from_numpy, from_reference_arrays
from pct_tpu_torch.curvature.explicit import explicit_curvatures
from pct_tpu_torch.fit import moments as tmom
from pct_tpu_torch.fit.eigh3 import smallest_eigvec3
from pct_tpu_torch.fit.frames import rodrigues_to_z
from pct_tpu_torch.neighbors import cellknn
from pct_tpu_torch.neighbors.grid import build_grid
from pct_tpu_torch.ops.epilogue import epilogue_plain
from pct_tpu_torch.ops.moments import knn_moments, stats_agreement
from pct_tpu_torch.pipeline import fast_curvature, fused_curvature
from pct_tpu_torch.shapes import generate_shape

K_MOM = 100


def _torus():
    return generate_shape("torus", 3000, perturbation_strength=1e-3,
                          seed=1)[1]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- (a) fit/moments on real k=100 neighborhoods --------------------------

@pytest.fixture(scope="module")
def moment_inputs():
    """Brute-force k=100 neighborhoods of 300 query points, their
    moments (from the JAX package) and the sign-fix offsets."""
    pts = _torus()
    q = np.random.default_rng(0).choice(len(pts), 300, replace=False)
    d2 = ((pts[q, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    d2[np.arange(len(q)), q] = np.inf
    idx = np.argsort(d2, axis=1)[:, :K_MOM]
    centered = (pts[idx] - pts[q, None, :]).astype(np.float32)
    w = np.ones(centered.shape[:2], np.float32)
    w[::7, -1] = 0.5                        # some fractional tie weights
    sigma = np.linalg.norm(centered, axis=-1).max(-1).astype(np.float32)
    m = np.asarray(jmom.neighborhood_moments(jnp.asarray(centered),
                                             jnp.asarray(w),
                                             jnp.asarray(sigma)))
    return centered, w, sigma, m


def test_neighborhood_moments_match_jax(moment_inputs):
    centered, w, sigma, m_j = moment_inputs
    m_t = tmom.neighborhood_moments(_t(centered), _t(w), _t(sigma)).numpy()
    assert tmom.NUM_MOMENTS == 35 and tmom.MOMENT_EXPS == jmom.MOMENT_EXPS
    assert tmom.moment_index(1, 2, 1) == jmom.moment_index(1, 2, 1)
    # sums of 100 terms of |x| <= 1 in another order: a few ulps of 100
    np.testing.assert_allclose(m_t, m_j, rtol=0, atol=2e-5)


def test_covariance_from_moments_matches_jax(moment_inputs):
    *_, m = moment_inputs
    c_j = np.asarray(jmom.covariance_from_moments(jnp.asarray(m)))
    c_t = tmom.covariance_from_moments(_t(m)).numpy()
    np.testing.assert_allclose(c_t, c_j, rtol=0,
                               atol=1e-6 * np.abs(c_j).max())


def test_rotated_moments_match_jax(moment_inputs):
    *_, m = moment_inputs
    nrm = np.random.default_rng(5).standard_normal((m.shape[0], 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    R_j = jax_rodrigues_to_z(jnp.asarray(nrm))
    R_t = rodrigues_to_z(_t(nrm))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-6)
    S_t = tmom.rotated_moments(_t(m), _t(R_j))
    S_j = jmom.rotated_moments(jnp.asarray(m), R_j)
    S_s = jmom.rotated_moments_symbolic(jnp.asarray(m), R_j)
    assert set(S_t) == set(S_j) == set(S_s) and len(S_t) == 21
    for key in S_s:
        # the same bound as the JAX package's own tensor-vs-symbolic test
        # (tests/test_moments.py), on moments of magnitude up to ~100
        for ref in (S_j, S_s):
            np.testing.assert_allclose(S_t[key].numpy(), np.asarray(ref[key]),
                                       rtol=2e-5, atol=2e-5 * 100,
                                       err_msg=str(key))


def test_curvature_from_moments_matches_jax(moment_inputs):
    """The port runs the chain through ``ops.epilogue`` (on the CPU its
    plain version); it is held against the JAX default (the symbolic
    expansion) and the JAX contraction, both to 1e-5·max (measured:
    2.9e-6 and 2.5e-6 of max|K|, 3.6e-6 of max|H²|)."""
    centered, _, sigma, m = moment_inputs
    near, kth = centered[:, 0], centered[:, -1]
    curv_t, n_t = tmom.curvature_from_moments(_t(m), _t(sigma), _t(near),
                                              _t(kth))
    for rotation in ("symbolic", "tensor"):
        curv_j, n_j = jmom.curvature_from_moments(
            jnp.asarray(m), jnp.asarray(sigma), jnp.asarray(near),
            jnp.asarray(kth), rotation=rotation)
        for a, b in zip(curv_t, curv_j):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
        np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=0,
                                   atol=1e-5)


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_chunked_epilogue_matches_unchunked(moment_inputs):
    """``curvature_from_moments`` is ``epilogue_plain`` on the (rows, 48)
    stats built by hand from its operands (moments in columns 0:35, σ in
    38, the nearest and kth offsets in 39:42 and 42:45), bit for bit;
    ``_chunked`` is the same at any ``chunk``, and so are both over two
    leading axes."""
    centered, _, sigma, m = moment_inputs
    args = (_t(m), _t(sigma), _t(centered[:, 0]), _t(centered[:, -1]))
    rows = m.shape[0]
    stats = torch.zeros(rows, 48)
    stats[:, :35], stats[:, 38] = args[0], args[1]
    stats[:, 39:42], stats[:, 42:45] = args[2], args[3]
    want = epilogue_plain(stats)

    def flat(curv, n):
        return torch.cat([torch.stack(list(curv), -1), n], -1).reshape(-1, 8)

    got = [tmom.curvature_from_moments(*args),
           tmom.curvature_from_moments_chunked(*args),
           tmom.curvature_from_moments_chunked(*args, chunk=96)]
    lead = (3, rows // 3)
    two = [a.reshape(lead + a.shape[1:]) for a in args]
    for curv, n in (tmom.curvature_from_moments(*two),
                    tmom.curvature_from_moments_chunked(*two, chunk=1)):
        assert curv.K.shape == lead and n.shape == lead + (3,)
        got.append((curv, n))
    for curv, n in got:
        assert torch.equal(_bits(flat(curv, n)), _bits(want))


def test_curvature_from_moments_float64(moment_inputs):
    """float64 operands take the plain version in float64 and keep their
    dtype; the result is the einsum chain's (``covariance_from_moments``
    → ``smallest_eigvec3`` → sign fix → ``rodrigues_to_z`` →
    ``rotated_moments`` → ``fit_quadratic_from_moments`` →
    ``explicit_curvatures``) in float64 to 1e-9·max|x|."""
    centered, _, sigma, m = moment_inputs
    m64, s64, near, kth = (torch.from_numpy(np.asarray(a, np.float64))
                           for a in (m, sigma, centered[:, 0],
                                     centered[:, -1]))
    curv, n = tmom.curvature_from_moments(m64, s64, near, kth)
    assert n.dtype == torch.float64
    assert all(c.dtype == torch.float64 for c in curv)
    _, ref_n = smallest_eigvec3(tmom.covariance_from_moments(m64))
    flip = torch.sum(ref_n * (kth - near), dim=-1) < 0.0
    ref_n = torch.where(flip[:, None], -ref_n, ref_n)
    S = tmom.rotated_moments(m64, rodrigues_to_z(ref_n))
    ref = explicit_curvatures(tmom.fit_quadratic_from_moments(
        S, m64[:, 0], s64))
    for a, b in zip(curv, ref):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-9 * float(b.abs().max()))
    torch.testing.assert_close(n, ref_n, rtol=0, atol=1e-9)


# ---- (b) the kernel's plain version ---------------------------------------

def _lattice_tiles(k, T=4, C=8, M=192):
    """Dyadic lattice: integer coordinates < 64 scaled by 2^-4, so every
    d² is exact in float32 with or without FMA. Candidates are clustered
    within ±6 lattice steps of a base point (many exact ties); queries
    are the first C candidates (self-exclusion). Tile 0 fully valid,
    tile 1 with 5 valid (under-k rows), tile 2 with none (empty rows),
    tile 3 80% valid."""
    rng = np.random.default_rng(7)
    base = rng.integers(8, 56, (T, 1, 3))
    p = ((base + rng.integers(-6, 7, (T, M, 3))) * 2.0**-4).astype(np.float32)
    q = p[:, :C].copy()
    cand = np.stack([rng.permutation(4096)[:M] for _ in range(T)]
                    ).astype(np.int32)
    qrow = cand[:, :C].copy()
    valid = np.ones((T, M), np.int32)
    valid[1, 5:] = 0
    valid[2] = 0
    valid[3] = rng.random(M) < 0.8
    return q, p, cand, qrow, valid


@pytest.mark.parametrize("k", [20, 64])
def test_moments_plain_matches_pallas_on_lattice(k):
    tile = _lattice_tiles(k)
    got = knn_moments(*(_t(a) for a in tile), k)
    pal = _t(jax_knn_moments(*(jnp.asarray(a) for a in tile), k,
                             interpret=True))
    ora = _t(xla_moment_stats(*(jnp.asarray(a) for a in tile), k))
    found = got[..., 45] > 0
    lt, le = got[..., 36], got[..., 37]
    assert found[0].all() and not found[1].any() and not found[2].any()
    assert (got[2, :, :35] == 0).all() and (got[2, :, 35] == 0).all()
    # 5 valid slots, minus the query itself for the first 5 queries
    assert (got[1, :5, 37] == 4).all() and (got[1, 5:, 37] == 5).all()
    assert (found & (le - lt > 1) & (le > k)).any()   # fractional ties
    differing, ratio, _ = stats_agreement(got, pal)
    assert differing == 0 and ratio <= 1.0, (differing, ratio)
    # the XLA oracle forms p − q as −(q − p): −0.0 where they coincide
    np.testing.assert_array_equal(got[..., 35:].numpy(),
                                  ora[..., 35:].numpy())
    np.testing.assert_allclose(got[..., :35].numpy(), ora[..., :35].numpy(),
                               rtol=2e-5, atol=1e-5)


@pytest.fixture(scope="module")
def carried():
    """The JAX package's state for the torus at k=100: padded cloud,
    cell size, the moments probe, and its fused result (XLA path)."""
    pts = _torus()
    n = len(pts)
    cj = jax_from_numpy(pts)
    cell = jax_cell_size(cj.points, cj.num_points, K_MOM)
    grid = jax_build_grid(cj.points, cj.num_points, cell)
    spec, mc, factor = jck.probe_grid_buckets(grid, capacity_cap=4 * K_MOM,
                                              split_to=128)
    rj = jax_fused_curvature(cj.points, cj.num_points, cell, k=K_MOM,
                             max_cells=mc, bucket_spec=spec,
                             engine="moments", split=(128, factor))
    state = from_reference_arrays(np.asarray(cj.points), n, cell_size=cell,
                                  bucket_spec=spec, max_cells=mc,
                                  split_factor=factor, k=K_MOM, device="cpu")
    return pts, n, state, rj


def test_moments_plain_matches_pallas_on_cell_tiles(carried):
    """Real tiles of the k=100 cell loop (4 cells of the first bucket):
    the JAX side may contract d² into FMAs (1 ulp), so τ, σ and the
    offsets agree to float32 rounding and the moments to 2e-4."""
    _, _, state, _ = carried
    grid = build_grid(state.cloud.points, state.cloud.num_points,
                      state.cell_size)
    cells = cellknn.compact_cells(grid, state.max_cells)
    sp, args = cellknn.bucketed_tile_args(grid, cells, state.bucket_spec)[0]
    args = tuple(a[:4] for a in args)
    cand, ok, cpts, qpts, qrow = cellknn._tile_candidates(
        grid, args, sp.capacity, sp.cand_cap)[:5]
    tile = (qpts, cpts, cand, qrow, ok.to(torch.int32))
    got = knn_moments(*tile, K_MOM).numpy()
    want = np.asarray(jax_knn_moments(*(jnp.asarray(a.numpy()) for a in tile),
                                      K_MOM, interpret=True))
    assert (got[..., 45] > 0).mean() > 0.9
    np.testing.assert_array_equal(got[..., [36, 37, 45, 46, 47]],
                                  want[..., [36, 37, 45, 46, 47]])
    np.testing.assert_allclose(got[..., 35:45], want[..., 35:45], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got[..., :35], want[..., :35], rtol=2e-4,
                               atol=2e-4)


def test_knn_moments_checks_its_operands():
    tile = [_t(a) for a in _lattice_tiles(20)]
    with pytest.raises(ValueError, match="query slots"):
        knn_moments(torch.zeros(1, 513, 3), torch.zeros(1, 8, 3),
                    torch.zeros(1, 8, dtype=torch.int32),
                    torch.zeros(1, 513, dtype=torch.int32),
                    torch.ones(1, 8, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="int32"):
        knn_moments(*tile[:2], tile[2].long(), *tile[3:], 20)
    with pytest.raises(ValueError, match="positive"):
        knn_moments(*tile, 0)
    # no candidate-slot limit: M of ~10 staging chunks of the kernel
    rng = np.random.default_rng(2)
    big = (rng.standard_normal((1, 4, 3)).astype(np.float32),
           rng.standard_normal((1, 5000, 3)).astype(np.float32),
           np.arange(5000, dtype=np.int32)[None],
           np.arange(4, dtype=np.int32)[None],
           np.ones((1, 5000), np.int32))
    got = knn_moments(*(_t(a) for a in big), K_MOM).numpy()
    want = np.asarray(xla_moment_stats(*(jnp.asarray(a) for a in big), K_MOM))
    assert got.shape == (1, 4, 48) and (got[..., 45] == 1).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


# ---- (c) the slice on carried state ---------------------------------------

def test_slice_matches_jax_moments_engine(carried):
    _, n, state, rj = carried
    res = fused_curvature(state.cloud.points, n, state.cell_size, K_MOM,
                          bucket_spec=state.bucket_spec,
                          max_cells=state.max_cells, engine="moments",
                          split=(128, state.split_factor), device="cpu")
    e_j = np.asarray(rj.exact)[:n]
    e_t = res.exact[:n].numpy()
    np.testing.assert_array_equal(e_t, e_j)
    assert e_t.mean() > 0.99
    np.testing.assert_allclose(res.kth_dist[:n].numpy(),
                               np.asarray(rj.kth_dist)[:n], rtol=1e-6)
    for fld in ("K", "H"):
        a = getattr(res.curv, fld)[:n].numpy()[e_t]
        b = np.asarray(getattr(rj.curv, fld))[:n][e_t]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    nrm = res.normals[:n].numpy()
    n_j = np.asarray(rj.normals)[:n]
    sign = np.sign(np.sum(nrm * n_j, axis=1))[:, None]
    np.testing.assert_allclose((nrm * sign)[e_t], n_j[e_t], rtol=0,
                               atol=1e-5)
    assert not res.exact[n:].any() and (res.curv.K[n:] == 0).all()


# ---- (d) the public path --------------------------------------------------

def _public_paths_agree(pts, k):
    n = len(pts)
    rj = jax_fast_curvature(jax_from_numpy(pts), k=k)
    rt = fast_curvature(from_numpy(pts, device="cpu"), k, device="cpu")
    e_j = np.asarray(rj.exact)[:n]
    e_t = rt.exact[:n].numpy()
    assert (e_j == e_t).mean() >= 0.999
    both = e_j & e_t
    K_j = np.asarray(rj.curv.K)[:n]
    K_t = rt.curv.K[:n].numpy()
    np.testing.assert_allclose(K_t[both], K_j[both], rtol=0,
                               atol=1e-4 * np.abs(K_j[both]).max())
    assert torch.isfinite(rt.curv.K).all()
    return rt, e_t


def test_fast_curvature_k100_matches_jax_public_path(carried):
    pts, n, _, _ = carried
    _, e_t = _public_paths_agree(pts, K_MOM)
    assert e_t.mean() > 0.99
