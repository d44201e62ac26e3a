"""The device half of the mesh module: the port against the JAX package,
on the CPU.

Normals, piece by piece on identical inputs (the JAX package's neighbor
indices and raw normals of a 6k Dupin cyclide at k=16, whose sparse side
leaves slots missing):

- ``estimate_raw_normals``: |n_port · n_jax| >= 1 − 1e-5 on every row;
- ``orient_normals``: the same sign on every row, from the extremal
  seed and from seeds (``seed_mask``/``seed_signs``), with 0 and 8
  consensus sweeps;
- a hand-built graph whose consensus is a 2-cycle ends on the JAX
  package's phase after an even and an odd number of sweeps.

Normals end to end (``estimate_and_orient_normals``): the sphere (2000
points, k=16, the list route), the torus (5000 points, k=40, the
moments route, hierarchical with ``_HIER_THRESHOLD`` lowered to 2000 in
both packages), the 6k Dupin cyclide (k=16) and the Möbius strip (4000
points, k=12). Each passes the JAX test's own analytic check
(tests/test_mesh.py, tests/test_stress_shapes.py). Sign agreement with
the JAX package is >= 0.999 (>= 0.99 on the Möbius strip, whose seam
may move); measured 1.0 on all four, the directions within 2.4e-7 on
the list route (|n_port · n_jax| >= 1 − 1e-5) and 9.5e-4 on the moments
route (>= 1 − 2e-3). The JAX side runs here with its
Pallas select in interpret mode and one point a gathered candidate row
(``_cand_pack`` 1), the layout the port keeps: the packed fetch, a TPU
row-gather device the port leaves out, gives a missing slot (a row whose
27-cell window holds fewer than k candidates) the id of whatever point
starts its 8-point group, and the unrepaired kNN of the orientation
feeds that id to the covariance and to the vote. With the JAX package's
CPU defaults (XLA select, packing 8) the measured agreement is 1.0
(sphere, torus), 0.9527 (cyclide) and 0.813 (Möbius): a few such rows
tip a wavefront vote, and the cascade moves a pocket or the seam.

Taubin smoothing, energies, vertex curvatures and voxel downsampling on
an icosphere(3) and a jittered copy: the JAX package's numbers to 1e-6
(the angle-deficit K, a difference of nearly equal float32 angle sums,
to 1e-6 of 2π over the dual area); padded faces under ``face_mask`` give
the unpadded result; orphan vertices stay put; NaN-tolerant energies;
both downsample modes equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pct_tpu.mesh as jmesh
import pct_tpu.mesh.normals as jnormals
import pct_tpu.neighbors.cellknn as jck
from pct_tpu.core import from_numpy as jax_from_numpy
from pct_tpu.neighbors.grid import build_grid as jax_build_grid
from pct_tpu.neighbors.grid import estimate_cell_size as jax_cell_size
import pct_tpu_torch.mesh.normals as tnormals
from pct_tpu_torch import mesh as tmesh
from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.neighbors import knn_cloud_grid
from pct_tpu_torch.shapes import generate_shape


def icosphere(subdiv=3):
    """Unit icosphere via midpoint subdivision (no external deps)."""
    t = (1 + np.sqrt(5)) / 2
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    for _ in range(subdiv):
        cache = {}
        verts = v.tolist()

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m.tolist())
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, dtype=np.int64)
    return v.astype(np.float32), f.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- normals: pieces on identical inputs -----------------------------------

N_CYC, K_CYC, KV = 6000, 16, 12


@pytest.fixture(scope="module")
def jax_pieces():
    """The JAX package's own kNN (no repair, rows in point order) and raw
    normals of the 6k cyclide at k=16, as its k < 32 route builds them."""
    pts, _ = generate_shape("dupin_cyclide", N_CYC)
    cj = jax_from_numpy(pts)
    grid = jax_build_grid(cj.points, cj.num_points,
                          jax_cell_size(cj.points, cj.num_points, K_CYC))
    spec, mc = jck.probe_grid_buckets(grid, capacity_cap=256)
    res = jck.knn_cellwise_bucketed(grid, jck.compact_cells(grid, mc),
                                    K_CYC, spec)
    idx = np.asarray(res.indices)[np.asarray(
        jnormals._invert_order(grid.order))]
    raw = np.asarray(jnormals.estimate_raw_normals(cj.points,
                                                   jnp.asarray(idx)))
    missing = int((~np.asarray(res.valid)).sum())
    return np.asarray(cj.points), idx, raw, missing


def test_raw_normals_match_jax_on_its_indices(jax_pieces):
    pts, idx, raw, missing = jax_pieces
    assert missing > 0          # the sparse side leaves slots missing
    got = tmesh.estimate_raw_normals(_t(pts), _t(idx)).numpy()
    assert got.shape == raw.shape
    dot = np.abs(np.sum(got[:N_CYC] * raw[:N_CYC], axis=1))
    assert dot.min() >= 1 - 1e-5


def _seeds(n):
    rng = np.random.default_rng(7)
    mask = rng.random(n) < 0.05
    signs = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return mask, signs


@pytest.mark.parametrize("seeded,consensus", [
    (False, 8), (False, 0), (True, 8), (True, 0)],
    ids=["extremal_seed", "extremal_seed_no_consensus", "seeds",
         "seeds_no_consensus"])
def test_orient_normals_match_jax_on_identical_inputs(jax_pieces, seeded,
                                                      consensus):
    pts, idx, raw, _ = jax_pieces
    n = pts.shape[0]
    vot = idx[:, :KV]
    kw_j, kw_t = {}, {}
    if seeded:
        mask, signs = _seeds(n)
        kw_j = dict(seed_mask=jnp.asarray(mask), seed_signs=jnp.asarray(signs))
        kw_t = dict(seed_mask=_t(mask), seed_signs=_t(signs))
    want = np.asarray(jnormals.orient_normals(
        jnp.asarray(pts), jnp.asarray(raw), jnp.asarray(vot),
        jnp.asarray(N_CYC), sweeps=40, consensus=consensus, **kw_j))
    got = tmesh.orient_normals(_t(pts), _t(raw), _t(vot), N_CYC, sweeps=40,
                               consensus=consensus, **kw_t).numpy()
    same = np.sign(got) == np.sign(want)
    assert same[:N_CYC].all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("consensus", [7, 8])
def test_consensus_two_cycle_ends_on_jax_phase(consensus):
    """Points 0 and 1 are each other's only voter, with equal normals
    and seeded with opposite signs: every consensus sweep flips both, so
    the result depends on the parity of the sweep count. Points 2 and 3
    agree and stay; point 4 is padding."""
    pts = np.arange(15, dtype=np.float32).reshape(5, 3)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (5, 1))
    idx = np.array([[1], [0], [3], [2], [0]], np.int32)
    mask = np.array([True, True, True, True, False])
    signs = np.array([1.0, -1.0, -1.0, -1.0, 1.0], np.float32)
    want = np.asarray(jnormals.orient_normals(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(idx), jnp.asarray(4),
        sweeps=4, seed_mask=jnp.asarray(mask), seed_signs=jnp.asarray(signs),
        consensus=consensus))
    got = tmesh.orient_normals(_t(pts), _t(nrm), _t(idx), 4, sweeps=4,
                               seed_mask=_t(mask), seed_signs=_t(signs),
                               consensus=consensus).numpy()
    np.testing.assert_array_equal(got, want)
    phase = 1.0 if consensus % 2 == 0 else -1.0
    np.testing.assert_array_equal(got[:2, 2], [phase, -phase])
    np.testing.assert_array_equal(got[2:, 2], [-1.0, -1.0, 1.0])


# --- normals end to end ----------------------------------------------------

def _tube_normal(pts):
    rho = np.linalg.norm(pts[:, :2], axis=1, keepdims=True)
    c = np.concatenate([pts[:, :2] / np.maximum(rho, 1e-9),
                        np.zeros((len(pts), 1), pts.dtype)], axis=1)
    return pts - 0.75 * rho.max() * c


def _neighbor_agreement(pts, nrm):
    res, _ = knn_cloud_grid(from_numpy(pts, device="cpu"), 8, device="cpu")
    idx = res.indices[:len(pts)].numpy()
    return (np.einsum("nd,nkd->nk", nrm, nrm[idx]) > 0).mean()


# name: (shape, n, k, _HIER_THRESHOLD, check, sign agreement, 1 - |dot|)
CASES = {
    "sphere_k16": ("sphere", 2000, 16, None, "radial", 0.999, 1e-5),
    "torus_k40_hier": ("torus", 5000, 40, 2000, "tube", 0.999, 2e-3),
    "cyclide_k16": ("dupin_cyclide", 6000, 16, None, "neighbors", 0.999,
                    1e-5),
    "mobius_k12": ("mobius", 4000, 12, None, "seam", 0.99, 1e-5),
}


@pytest.fixture(scope="module", params=list(CASES))
def normals_pair(request):
    shape, n, k, hier, check, bound, dot_tol = CASES[request.param]
    pts, _ = generate_shape(shape, n)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jck, "default_select_impl", lambda: "pallas_interpret")
        mp.setattr(jck, "_cand_pack", lambda n: 1)
        if hier is not None:
            mp.setattr(jnormals, "_HIER_THRESHOLD", hier)
            mp.setattr(tnormals, "_HIER_THRESHOLD", hier)
        jax.clear_caches()      # retrace under the patched statics
        want = np.asarray(jnormals.estimate_and_orient_normals(
            jax_from_numpy(pts), k=k))[:n]
        jax.clear_caches()
        got = tmesh.estimate_and_orient_normals(
            from_numpy(pts, device="cpu"), k=k, device="cpu")
    return pts, n, got, want, check, bound, dot_tol


def test_normals_pass_the_analytic_check(normals_pair):
    pts, n, got, _, check, _, _ = normals_pair
    nrm = got[:n].numpy()
    assert np.isfinite(nrm).all()
    assert np.abs(np.linalg.norm(nrm, axis=1) - 1).max() <= 1e-5
    if check == "radial":
        frac = (np.sum(nrm * pts, axis=1) > 0).mean()
        assert frac > 0.99 or frac < 0.01
    elif check == "tube":
        frac = (np.sum(nrm * _tube_normal(pts), axis=1) > 0).mean()
        assert frac > 0.999 or frac < 0.001
    elif check == "neighbors":
        assert _neighbor_agreement(pts, nrm) > 0.99
    else:
        assert _neighbor_agreement(pts, nrm) > 0.9


def test_normals_agree_with_jax(normals_pair):
    """Signs, and directions: to 1e-5 on the list route; the moments
    route's fit normals (raw normals at k >= 32) on the 3:1 anisotropic
    torus lattice, nearly one-dimensional neighborhoods, to 2e-3
    (measured 9.5e-4, as in tests/test_torch_moments.py's chain)."""
    _, n, got, want, _, bound, dot_tol = normals_pair
    got = got[:n].numpy()
    dot = np.sum(got * want, axis=1)
    assert (dot > 0).mean() >= bound
    assert np.abs(dot).min() >= 1 - dot_tol


# --- smoothing, energies, downsampling -------------------------------------

@pytest.fixture(scope="module", params=["icosphere", "jittered"])
def mesh(request):
    v, f = icosphere(3)
    if request.param == "jittered":
        v = v + np.random.default_rng(3).standard_normal(v.shape).astype(
            np.float32) * 0.01
    return v, f


def test_taubin_matches_jax(mesh):
    v, f = mesh
    want = np.asarray(jmesh.taubin_smooth(jnp.asarray(v), jnp.asarray(f),
                                          iterations=10))
    got = tmesh.taubin_smooth(_t(v), _t(f), iterations=10).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    vm = np.arange(len(v)) % 3 != 0
    want = np.asarray(jmesh.taubin_smooth(jnp.asarray(v), jnp.asarray(f),
                                          iterations=3,
                                          vertex_mask=jnp.asarray(vm)))
    got = tmesh.taubin_smooth(_t(v), _t(f), iterations=3,
                              vertex_mask=_t(vm)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[~vm], v[~vm])


def test_energies_and_areas_match_jax(mesh):
    v, f = mesh
    rng = np.random.default_rng(5)
    K = rng.standard_normal(len(v)).astype(np.float32)
    H = rng.standard_normal(len(v)).astype(np.float32)
    K[::17] = np.nan
    jv, jf = jnp.asarray(v), jnp.asarray(f)
    want = jmesh.mesh_energies(jv, jf, jnp.asarray(K), jnp.asarray(H))
    got = tmesh.mesh_energies(_t(v), _t(f), _t(K), _t(H))
    assert np.isfinite(float(got.stretching))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    np.testing.assert_allclose(
        tmesh.triangle_areas(_t(v), _t(f)).numpy(),
        np.asarray(jmesh.triangle_areas(jv, jf)), rtol=1e-6)
    np.testing.assert_allclose(
        tmesh.vertex_areas(_t(v), _t(f)).numpy(),
        np.asarray(jmesh.vertex_areas(jv, jf)), rtol=1e-6)


def test_vertex_curvatures_match_jax(mesh):
    v, f = mesh
    Kj, Hj = (np.asarray(a) for a in jmesh.mesh_vertex_curvatures(
        jnp.asarray(v), jnp.asarray(f)))
    K, H = (a.numpy() for a in tmesh.mesh_vertex_curvatures(_t(v), _t(f)))
    dual = np.asarray(jmesh.vertex_areas(jnp.asarray(v), jnp.asarray(f)))
    assert (np.abs(K - Kj) <= 1e-6 * 2 * np.pi / dual).all()
    np.testing.assert_allclose(H, Hj, rtol=1e-6, atol=1e-6 * np.abs(Hj).max())


def test_face_mask_padding_gives_the_unpadded_result(mesh):
    v, f = mesh
    T = len(f)
    fp = np.zeros((T + 77, 3), np.int32)
    fp[:T] = f
    fm = np.arange(T + 77) < T
    rng = np.random.default_rng(2)
    K = rng.standard_normal(len(v)).astype(np.float32)
    H = rng.standard_normal(len(v)).astype(np.float32)
    e0 = tmesh.mesh_energies(_t(v), _t(f), _t(K), _t(H))
    e1 = tmesh.mesh_energies(_t(v), _t(fp), _t(K), _t(H), face_mask=_t(fm))
    for a, b in zip(e0, e1):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    s0 = tmesh.taubin_smooth(_t(v), _t(f), iterations=5)
    s1 = tmesh.taubin_smooth(_t(v), _t(fp), iterations=5, face_mask=_t(fm))
    np.testing.assert_array_equal(s0.numpy(), s1.numpy())
    k0 = tmesh.mesh_vertex_curvatures(_t(v), _t(f))
    k1 = tmesh.mesh_vertex_curvatures(_t(v), _t(fp), face_mask=_t(fm))
    for a, b in zip(k0, k1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_taubin_orphan_vertices_stay_put():
    v = np.random.default_rng(4).standard_normal((10, 3)).astype(np.float32)
    f = np.array([[0, 1, 2], [1, 2, 3]], np.int32)    # vertices 4..9 orphan
    s = tmesh.taubin_smooth(_t(v), _t(f), iterations=10).numpy()
    np.testing.assert_array_equal(s[4:], v[4:])
    want = np.asarray(jmesh.taubin_smooth(jnp.asarray(v), jnp.asarray(f),
                                          iterations=10))
    np.testing.assert_allclose(s, want, rtol=0, atol=1e-6)


def test_mesh_edges_match_jax(mesh):
    _, f = mesh
    np.testing.assert_array_equal(tmesh.mesh_edges(_t(f)).numpy(),
                                  np.asarray(jmesh.mesh_edges(jnp.asarray(f))))


@pytest.mark.parametrize("mode,max_per_voxel", [
    ("first", 1), ("first", 3), ("centroid", 1)])
def test_voxel_downsample_matches_jax(mesh, mode, max_per_voxel):
    v, _ = mesh
    cap = len(v) + 200                     # padded like a PointCloud
    pts = np.full((cap, 3), 1e9, np.float32)
    pts[:len(v)] = v
    want, kept_j = jmesh.voxel_downsample(
        jnp.asarray(pts), jnp.asarray(len(v)), jnp.float32(0.3),
        max_per_voxel=max_per_voxel, mode=mode)
    got, kept = tmesh.voxel_downsample(_t(pts), len(v), 0.3,
                                       max_per_voxel=max_per_voxel, mode=mode)
    assert int(kept) == int(kept_j) and 0 < int(kept) < len(v)
    assert got.shape == (cap, 3)
    want = np.asarray(want)
    if mode == "first":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
