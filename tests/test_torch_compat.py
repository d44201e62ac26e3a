"""The port's reference-API façade (``pct_tpu_torch.compat``) against the
JAX package's (``pct_tpu.compat``), on the CPU, with the clouds and
arguments of tests/test_compat.py.

Each cloud goes through both façades once (module-scoped fixtures). The
tolerances are those of the counterpart tests:

- ``plant_kdtree``: each package finds its own neighbors (the JAX
  package's XLA select on the CPU expands the distances around the cell
  corner), so the rule of tests/test_torch_knn.py's ``knn_cloud_grid``
  test holds: every row certified, the port's distances within rtol
  1e-5 / atol 1e-6 of the float64 truth, the two packages' d² within
  the cell-local rounding bound 32·2⁻²⁴·15·cell², and the id sets equal
  wherever the kth and (k+1)th true distances are apart;
- the explicit chain, K, H and coefficients within 1e-4 of their
  largest value on the rows whose id sets agree (tests/test_torch_
  implicit.py's pipeline rule);
- the implicit chain: on the unit sphere at k=16 a neighborhood's
  quadric is not determined by float32 (the two packages' unit
  coefficients differ by a median 3.7e-2 here, each fitting its
  neighborhood), so the rule is tests/test_torch_implicit.py's
  statistical one: the port's error against the analytic K and |H| may
  exceed the JAX package's by at most 5% at the median and the 90th
  percentile;
- PCA as tests/test_torch_study.py (rtol 1e-4 of the largest value,
  directions |dot| >= 1 - 1e-4); normals as tests/test_torch_mesh.py's
  sphere case (sign agreement >= 0.999, |dot| >= 1 - 1e-5);
- ``validate_shape`` as tests/test_torch_validate.py's mesh protocol
  (1e-5 relative).
"""

import numpy as np
import pytest
from scipy.spatial import cKDTree

from pct_tpu import compat as jcompat
from pct_tpu_torch import compat
from pct_tpu_torch.shapes import analytic_curvatures, generate_shape

N_SPHERE = 2000
K = 16


def _both(fn, *args, **kw):
    """(JAX result, port result) of the façade function ``fn``."""
    return (getattr(jcompat, fn)(*args, **kw),
            getattr(compat, fn)(*args, device="cpu", **kw))


@pytest.fixture(scope="module")
def sphere_pair():
    """Both façades on the 2000-point unit sphere at k=16, every chain
    run once; ``out`` maps a step to its (JAX, port) results."""
    pts, _ = generate_shape("sphere", N_SPHERE, radius=1.0)
    pcs = (jcompat.PointCloud(points=pts, k_neighbors=K),
           compat.PointCloud(points=pts, k_neighbors=K, device="cpu"))
    out = {}
    for step, call in (
            ("knn", lambda pc: pc.plant_kdtree(K)),
            ("explicit",
             lambda pc: pc.compute_pointwise_explicit_quadratic_curvature()),
            ("implicit",
             lambda pc: pc.compute_pointwise_implicit_quadric_curvature()),
            ("pca", lambda pc: (
                pc.principal_curvatures_via_principal_component_analysis(12),
                pc)),
            ("normals", lambda pc: pc.compute_normals(K))):
        out[step] = tuple(call(pc) for pc in pcs)
    return pts, pcs, out


def _agreeing_rows(out):
    (ij, _), (it, _) = out["knn"]
    return (np.sort(ij, 1) == np.sort(it, 1)).all(1)


def test_ctor_norms_match_jax(sphere_pair):
    _, (j, t), _ = sphere_pair
    assert t.num_points == j.num_points == N_SPHERE
    for name in ("l1_norm", "l2_norm", "linf_norm"):
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_array_equal(t.points, j.points)
    assert t.normals.shape == (N_SPHERE, 3)   # set by compute_normals


def test_plant_kdtree_matches_jax(sphere_pair):
    pts, (_, t), out = sphere_pair
    (ij, dj), (it, dt) = out["knn"]
    assert it.shape == dt.shape == ij.shape == (N_SPHERE, K)
    assert it.dtype == np.int32
    P = pts.astype(np.float64)
    d_true, _ = cKDTree(P).query(P, K + 2)
    d_true = d_true[:, 1:]
    np.testing.assert_allclose(dt, d_true[:, :K], rtol=1e-5, atol=1e-6)
    cell_bound = 32 * 2.0**-24 * 15 * float(t._grid.cell_size) ** 2
    d64 = [d.astype(np.float64) for d in (dj, dt)]
    assert (np.abs(d64[0] ** 2 - d64[1] ** 2) <= cell_bound).all()
    untied = (d_true[:, K] ** 2 - d_true[:, K - 1] ** 2
              > 1e-4 * d_true[:, K] ** 2 + 2 * cell_bound)
    assert untied.mean() > 0.8
    assert _agreeing_rows(out)[untied].all()


def test_explicit_chain_matches_jax(sphere_pair):
    _, (j, t), out = sphere_pair
    rows = _agreeing_rows(out)
    assert rows.mean() >= 0.999
    (Kj, Hj), (Kt, Ht) = out["explicit"]
    pairs = [(Kt, Kj), (Ht, Hj), (t.K_H_sq_quadratic, j.K_H_sq_quadratic),
             (t.quadratic_coefficients, j.quadratic_coefficients),
             (t.estimated_normals, j.estimated_normals)]
    for a, b in pairs:
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a[rows], b[rows], rtol=0,
                                   atol=1e-4 * np.abs(b[rows]).max())
    assert np.isclose(np.median(Kt), 1.0, rtol=0.05)


def test_implicit_chain_matches_jax(sphere_pair):
    pts, (j, t), out = sphere_pair
    (Kj, Hj), (Kt, Ht) = out["implicit"]
    assert t.quadric_coefficients.shape == j.quadric_coefficients.shape
    np.testing.assert_allclose(np.linalg.norm(t.quadric_coefficients, axis=1),
                               1.0, atol=1e-5)
    Ka, Ha = analytic_curvatures("sphere", pts)
    for a, b, truth in ((Kt, Kj, Ka), (np.abs(Ht), np.abs(Hj), np.abs(Ha))):
        assert np.isfinite(a).all()
        ea, eb = np.abs(a - truth), np.abs(b - truth)
        for q in (0.5, 0.9):
            assert np.quantile(ea, q) <= 1.05 * np.quantile(eb, q), q
    assert np.isclose(np.median(Kt), 1.0, rtol=0.1)


def test_pca_matches_jax(sphere_pair):
    _, _, out = sphere_pair
    ((k1j, k2j), j), ((k1t, k2t), t) = out["pca"]
    assert (k1t >= k2t - 1e-7).all()
    for name in ("pca_k1", "pca_k2", "pca_K", "pca_H"):
        a, b = getattr(t, name), getattr(j, name)
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())
    for name in ("pca_dir1", "pca_dir2"):
        dots = np.abs(np.sum(getattr(t, name) * getattr(j, name), -1))
        np.testing.assert_allclose(dots, 1.0, atol=1e-4)


def test_normals_match_jax(sphere_pair):
    pts, (j, t), out = sphere_pair
    nj, nt = out["normals"]
    assert nt is t.normals and nt.shape == (N_SPHERE, 3)
    dot = np.sum(nt * nj, axis=1)
    assert (dot > 0).mean() >= 0.999
    assert np.abs(dot).min() >= 1 - 1e-5
    frac = (np.sum(nt * pts, axis=1) > 0).mean()
    assert frac > 0.99 or frac < 0.01


def test_neighbor_study_is_the_ports(sphere_pair):
    """The façade delegates to the port's study (its sample comes from a
    ``torch.Generator``, so its k is held to the port's own function)."""
    from pct_tpu_torch.pipeline import explicit_quadratic_neighbor_study

    _, (_, t), _ = sphere_pair
    k_rec = t.explicit_quadratic_neighbor_study(tolerance=1e-3,
                                                sample_size=32)
    want, _ = explicit_quadratic_neighbor_study(
        t.cloud, tol=1e-3, sample_size=32, device="cpu")
    assert k_rec == int(want) and 1 <= k_rec <= 100


def test_energies_static_match_jax():
    args = ([1.0, 2.0, 0.5], [1.0, 1.0, np.nan], [2.0, 3.0, 1.5])
    assert (compat.PointCloud.calculate_energies(*args)
            == jcompat.PointCloud.calculate_energies(*args))


def test_export_reads_back(tmp_path, sphere_pair):
    """The ASCII PLY keeps 8 significant digits (``%.8g``)."""
    from pct_tpu_torch.io import read_ply

    _, (_, t), _ = sphere_pair
    path = t.export_ply_with_curvature_and_normals(str(tmp_path / "o.ply"))
    d = read_ply(path)
    for got, want in ((d.points, t.points), (d.normals, t.normals),
                      (d.vertex_props["gaussian_curvature"], t.K_quadratic),
                      (d.vertex_props["mean_curvature"], t.H_quadratic)):
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_downsample_matches_jax():
    pts, _ = generate_shape("sphere", 1000, radius=1.0)
    j = jcompat.PointCloud(points=pts, downsample=True, voxel_size=0.3)
    t = compat.PointCloud(points=pts, downsample=True, voxel_size=0.3,
                          device="cpu")
    assert 0 < t.num_points == j.num_points < 1000
    np.testing.assert_array_equal(t.points, j.points)
    assert t.cloud.points.device.type == "cpu"
    back = t.downsample_point_cloud_by_grid(0.5)
    np.testing.assert_array_equal(back, j.downsample_point_cloud_by_grid(0.5))


@pytest.fixture(scope="module")
def torus_1500():
    pts, _ = generate_shape("torus", 1500, radius=1.0)
    return pts


def test_average_distance_matches_jax(torus_1500):
    """Within 1e-4 relative: ``mean_nn_distance``'s documented gap."""
    (dj, rj), (dt, rt) = _both("average_distance_using_kd_tree", torus_1500)
    assert abs(dt - dj) <= 1e-4 * dj
    assert rt.shape == (25,) and rt[0] < rt[-1]
    np.testing.assert_allclose(rt, rj, rtol=1e-4)


def _estimate_parity(pts, k_fraction, max_neighbors, repair_bound=False):
    """Both façades' ``estimate_curvature`` within 1e-4 of its largest
    value on the rows whose neighbor id sets agree, those sets equal
    wherever the kth and (k+1)th float64 distances are apart by more
    than the rounding bound: the grid's cell-local one, or with
    ``repair_bound`` the larger of it and the brute-force repair's
    expanded form 8·2⁻²⁴·(|q|²+|p|²) (tests/test_torch_knn.py)."""
    from pct_tpu.core import from_numpy as jax_from_numpy
    from pct_tpu.neighbors import knn_cloud_grid as jax_knn_cloud_grid
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.neighbors import knn_cloud_grid

    n = len(pts)
    k = int(min(max(n * k_fraction, 3), max_neighbors, n - 1))
    sj, st = _both("estimate_curvature", pts, k_fraction=k_fraction,
                   max_neighbors=max_neighbors)
    assert st.shape == (n,) and (st >= 0).all()
    ij = np.asarray(jax_knn_cloud_grid(jax_from_numpy(pts), k)[0].indices)[:n]
    rt, grid = knn_cloud_grid(from_numpy(pts, device="cpu"), k, device="cpu")
    it = rt.indices[:n].numpy()
    rows = (np.sort(ij, 1) == np.sort(it, 1)).all(1)
    P = pts.astype(np.float64)
    d_true, i_true = cKDTree(P).query(P, k + 2)
    d_true, i_true = d_true[:, 1:], i_true[:, 1:]
    bound = 32 * 2.0**-24 * 15 * float(grid.cell_size) ** 2
    if repair_bound:
        sq = np.sum(P * P, axis=1)
        bound = np.maximum(bound, 8 * 2.0**-24 * (sq + sq[i_true[:, k - 1]]))
    untied = (d_true[:, k] ** 2 - d_true[:, k - 1] ** 2
              > 1e-4 * d_true[:, k] ** 2 + 2 * bound)
    assert untied.any() and rows[untied].all()
    assert rows.mean() >= 0.5
    np.testing.assert_allclose(st[rows], sj[rows], rtol=0,
                               atol=1e-4 * np.abs(sj).max())
    return k


@pytest.mark.parametrize("k_fraction", [0.01, 0.025])
def test_estimate_curvature_matches_jax(torus_1500, k_fraction):
    """Surface variation at k = min(max(n·k_fraction, 3), 100, n - 1),
    within 1e-4 of its largest value on the rows whose neighbor id sets
    agree. The unperturbed torus lattice ties the kth neighbor of most
    rows (75-79% of the rows agree here), so the id sets are held equal
    where the kth and (k+1)th float64 distances are apart, as in
    ``test_plant_kdtree_matches_jax``."""
    _estimate_parity(torus_1500, k_fraction, 100)


def test_estimate_curvature_refuses_past_the_selects(torus_1500):
    """Nothing the JAX package accepts is refused. Past 128 neighbors the
    selects run: ``max_neighbors=200`` at k_fraction 0.2 (k = 200)
    matches the JAX package by the rule above, with the repair's bound
    (most rows of a 1500-point cloud at k = 200 go to brute force). And
    ``max_neighbors=5000`` at the default fraction, which the port once
    refused above 1024 whatever k it would use, runs at the JAX
    package's k = min(max(1500·0.025, 3), 5000, 1499) = 37 and matches
    it."""
    assert _estimate_parity(torus_1500, 0.2, 200, repair_bound=True) == 200
    assert _estimate_parity(torus_1500, 0.025, 5000) == 37


def test_shapes_scale_and_ply_match_jax(tmp_path, torus_1500):
    pts = torus_1500
    assert (compat.get_characteristic_scale(pts)
            == jcompat.get_characteristic_scale(pts) > 1.0)
    for kw in ({"radius": 2.0}, {"desired_scale": 0.5,
                                 "perturbation_strength": 0.01, "seed": 3}):
        for a, b in zip(compat.generate_pv_shapes("sphere", 500, **kw),
                        jcompat.generate_pv_shapes("sphere", 500, **kw)):
            np.testing.assert_array_equal(a, b)
    paths = [str(tmp_path / f"{side}.ply") for side in ("port", "jax")]
    compat.save_points_to_ply(pts, paths[0])
    jcompat.save_points_to_ply(pts, paths[1])
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(compat.parse_ply(paths[0]),
                                  jcompat.parse_ply(paths[1]))


def test_mesh_functions_match_jax(tmp_path):
    """``load_mesh_compute_energies`` and ``detect_boundary_loops`` on an
    open icosphere cap."""
    from tests.test_torch_mesh import icosphere

    v, f = icosphere(2)
    f = f[v[f].mean(1)[:, 2] < 0.5]
    rng = np.random.default_rng(0)
    Kv = rng.random(len(v)).astype(np.float32)
    Hv = rng.random(len(v)).astype(np.float32)
    ej, et = _both("load_mesh_compute_energies", v, f, Kv, Hv)
    np.testing.assert_allclose(et, ej, rtol=1e-5)
    lj = jcompat.detect_boundary_loops(f)
    lt = compat.detect_boundary_loops(f)
    assert len(lt) == len(lj) >= 1
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a, b)


def test_validate_shape_matches_jax(tmp_path):
    pts, _ = generate_shape("sphere", 4000, radius=1.0)
    p = str(tmp_path / "s.ply")
    compat.save_points_to_ply(pts, p)
    args = (p, "N", "sphere", "Unperturbed", 1.0)
    kw = dict(k_neighbors=16, auto_k=False)
    want = jcompat.validate_shape(*args, **kw)
    got = compat.validate_shape(*args, device="cpu", **kw)
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w)
    b, s, a = got
    assert np.isclose(a, 4 * np.pi, rtol=0.12)
    assert np.isclose(b, 4 * np.pi, rtol=0.15)
