"""The validation harness of the port (``pct_tpu_torch.validate.harness``)
against the JAX package's, on the CPU.

Each cloud goes through both packages' ``validate_cloud`` once (a
module-scoped fixture: the JAX package's mesh normals alone take ~11 s
a call here):

- mesh-free with the neighbor study on a 3000-point torus, perturbed
  (1e-3, seed 0) for the near-tie reason of tests/test_torch_fused.py:
  on the unperturbed lattice 85 of its 3000 rows take other neighbors
  at tied kth distances in the two packages, which moves the stretching
  by 5.0e-4 of Σ|K|·a;
- the mesh protocol on a 2000-point sphere at k=12 with the z-score
  filter and every artifact written.

The study draws its sample from a ``torch.Generator`` in the port
(tests/test_torch_study.py), so ``converged_k`` is held within 2 and the
converged fraction is printed. The integrals are held to 1e-4 relative
mesh-free (the stretching, a cancelling sum, to 1e-4 of Σ|K|·a) and to
1e-5 relative on the mesh.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.shapes import generate_shape

K_FREE = 20
K_MESH = 12


def _torus():
    return generate_shape("torus", 3000, perturbation_strength=1e-3,
                          seed=0)[1]


@pytest.fixture(scope="module")
def mesh_free_pair():
    from pct_tpu.validate import validate_cloud as jax_validate
    from pct_tpu_torch.validate import validate_cloud

    pts = _torus()
    kw = dict(shape="torus", radius=1.0, k_neighbors=K_FREE, auto_k=True,
              use_mesh=False)
    return pts, jax_validate(pts, **kw), validate_cloud(pts, device="cpu",
                                                        **kw)


@pytest.fixture(scope="module")
def mesh_pair(tmp_path_factory):
    from pct_tpu.validate import validate_cloud as jax_validate
    from pct_tpu_torch.validate import validate_cloud

    pts, _ = generate_shape("sphere", 2000, radius=1.0)
    dirs = [tmp_path_factory.mktemp(side) for side in ("jax", "port")]
    kw = dict(shape="sphere", variant="Unperturbed", radius=1.0,
              k_neighbors=K_MESH, auto_k=False, outlier_filter=True)
    want = jax_validate(pts, output_dir=str(dirs[0]), **kw)
    got = validate_cloud(pts, output_dir=str(dirs[1]), device="cpu", **kw)
    return pts, want, got, dirs


def _same_fields(got, want):
    for f in ("shape", "variant", "num_points", "radius", "k_used",
              "study_kmax", "aborted", "area_error_pct", "bending_error_pct",
              "stretching_error_pct"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_equal(got.nan_fraction, want.nan_fraction)
    assert list(got.stage_timings) == list(want.stage_timings)


def test_result_fields_match_jax():
    from pct_tpu.validate import ValidationResult as JaxResult
    from pct_tpu_torch.validate import ValidationResult

    def layout(cls):
        return [(f.name, f.default, f.default_factory)
                for f in dataclasses.fields(cls)]

    assert layout(ValidationResult) == layout(JaxResult)


def test_mesh_free_matches_jax(mesh_free_pair):
    pts, want, got = mesh_free_pair
    print(f"converged k: port {got.converged_k} (fraction "
          f"{got.converged_fraction}), JAX {want.converged_k} (fraction "
          f"{want.converged_fraction})")
    _same_fields(got, want)
    assert got.study_kmax == 99 and got.aborted == ""
    assert list(got.stage_timings) == ["study", "curvature"]
    assert abs(got.converged_k - want.converged_k) <= 2
    assert 0.0 <= got.converged_fraction <= 1.0
    for f in ("total_area", "bending_energy"):
        g, w = getattr(got, f), getattr(want, f)
        assert abs(g - w) <= 1e-4 * abs(w), f
    # the stretching cancels towards the torus' 0: bound it by Σ|K|·a
    from pct_tpu_torch.pipeline import fast_curvature

    r = fast_curvature(from_numpy(pts, device="cpu"), K_FREE, device="cpu")
    n = len(pts)
    a = np.pi * r.kth_dist[:n].numpy() ** 2 / K_FREE
    mass = float(np.sum(np.abs(r.curv.K[:n].numpy()) * a))
    assert abs(got.stretching_energy - want.stretching_energy) <= 1e-4 * mass


def test_mesh_mode_matches_jax(mesh_pair):
    _, want, got, _ = mesh_pair
    _same_fields(got, want)
    assert got.converged_k == want.converged_k == -1
    assert got.converged_fraction == want.converged_fraction == -1.0
    assert got.nan_fraction == 0.0 and got.aborted == ""
    for f in ("total_area", "bending_energy", "stretching_energy"):
        g, w = getattr(got, f), getattr(want, f)
        assert abs(g - w) <= 1e-5 * abs(w), f


def _artifacts(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_mesh_mode_artifacts_match_jax(mesh_pair):
    """The same files; the .npy dumps carry the same z-score NaN mask and
    values within 1e-4 of max|K| (max|H|); the curvature PLY reads back
    through both packages' readers with the same vertex properties."""
    from pct_tpu.io import read_ply as jax_read_ply
    from pct_tpu_torch.io import read_ply

    pts, _, _, (d_j, d_t) = mesh_pair
    names = _artifacts(d_t)
    assert names == _artifacts(d_j)
    stem = "sphere_Unperturbed_2000"
    assert names == sorted([f"{stem}_gaussian.npy", f"{stem}_mean.npy",
                            f"{stem}_with_curvatures.ply",
                            os.path.join("mesh_snaps", "mesh_2000_points_"
                                         "sphere_Unperturbed.vtk")])
    for which in ("gaussian", "mean"):
        a = np.load(d_t / f"{stem}_{which}.npy")
        b = np.load(d_j / f"{stem}_{which}.npy")
        assert a.shape == b.shape == (len(pts),)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        fin = ~np.isnan(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0,
                                   atol=1e-4 * np.abs(b[fin]).max())
    ply = f"{stem}_with_curvatures.ply"
    port = [read_ply(str(d / ply)) for d in (d_t, d_j)]
    jax = [jax_read_ply(str(d / ply)) for d in (d_t, d_j)]
    for p, j in zip(port, jax):
        assert sorted(p.vertex_props) == sorted(j.vertex_props) == [
            "gaussian_curvature", "mean_curvature"]
        np.testing.assert_array_equal(p.points, j.points)
        for key in p.vertex_props:
            np.testing.assert_array_equal(p.vertex_props[key],
                                          j.vertex_props[key])
    for key in port[0].vertex_props:
        a, b = port[0].vertex_props[key], port[1].vertex_props[key]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        fin = ~np.isnan(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0,
                                   atol=1e-4 * np.abs(b[fin]).max())
    np.testing.assert_array_equal(port[0].points, port[1].points)


def test_study_abort_matches_jax():
    """A flat plane converges at the ladder's bottom rung everywhere and
    recommends k < 10: both packages abort (tests/test_validate.py)."""
    from pct_tpu.validate import validate_cloud as jax_validate
    from pct_tpu_torch.validate import validate_cloud

    rng = np.random.default_rng(0)
    pts = np.zeros((4000, 3), np.float32)
    pts[:, :2] = rng.random((4000, 2)).astype(np.float32)
    want = jax_validate(pts, auto_k=True, use_mesh=False)
    got = validate_cloud(pts, auto_k=True, use_mesh=False, device="cpu")
    assert got.aborted == want.aborted == "neighbor study did not converge"
    assert got.converged_k < 10 and want.converged_k < 10
    assert got.converged_fraction > 0.9
    assert got.study_kmax == want.study_kmax == 99
    for f in ("bending_energy", "stretching_energy", "total_area",
              "nan_fraction"):
        assert np.isnan(getattr(got, f)) and np.isnan(getattr(want, f)), f
    assert got.stage_timings == {} == want.stage_timings


def test_nan_census_abort_matches_jax(mesh_free_pair):
    from pct_tpu.validate import validate_cloud as jax_validate
    from pct_tpu_torch.validate import validate_cloud

    pts = mesh_free_pair[0]
    kw = dict(k_neighbors=K_FREE, auto_k=False, use_mesh=False,
              nan_abort_fraction=-1.0)
    want = jax_validate(pts, **kw)
    got = validate_cloud(pts, device="cpu", **kw)
    assert got.aborted == want.aborted == "NaN census"
    assert got.nan_fraction == want.nan_fraction == 0.0
    for f in ("bending_energy", "stretching_energy", "total_area"):
        assert np.isnan(getattr(got, f)) and np.isnan(getattr(want, f)), f
    assert got.converged_k == want.converged_k == -1


def test_zscore_filter_matches_jax():
    from pct_tpu.validate import zscore_filter as jax_zscore
    from pct_tpu_torch.validate import zscore_filter

    rng = np.random.default_rng(0)
    for dtype in (np.float64, np.float32):
        v = rng.standard_normal(1000).astype(dtype)
        v[:5] = 100.0
        v[7] = np.nan
        for kw in ({}, {"stop_fraction": 0.2}, {"thresholds": (3, 1)}):
            got = zscore_filter(v, **kw)
            np.testing.assert_array_equal(got, jax_zscore(v, **kw))
        assert not got[:5].any() and not got[7]
    flat = np.ones(50)
    np.testing.assert_array_equal(zscore_filter(flat), jax_zscore(flat))


def test_percent_error_matches_jax():
    from pct_tpu.validate import percent_error as jax_pe
    from pct_tpu_torch.validate import percent_error

    cases = [(11.0, 10.0), (0.02, 0.0), (1.0, float("nan")), (1.0, None),
             (-3.0, 5e-10), (2.5, -4.0), (np.float32(1.1), 1.0)]
    for c, t in cases:
        assert percent_error(c, t) == jax_pe(c, t), (c, t)
    assert percent_error(11.0, 10.0) == pytest.approx(10.0)


def test_point_area_weights_matches_jax():
    import jax.numpy as jnp

    from pct_tpu.validate import point_area_weights as jax_weights
    from pct_tpu_torch.validate import point_area_weights

    d = np.sort(np.random.default_rng(0).random((500, 20)).astype(
        np.float32), axis=1)
    got = point_area_weights(torch.from_numpy(d), 20)
    want = np.asarray(jax_weights(jnp.asarray(d), 20))
    assert got.dtype == torch.float32 and got.shape == (500,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_validate_file_gives_validate_cloud(mesh_free_pair, tmp_path):
    from pct_tpu_torch.io import write_ply
    from pct_tpu_torch.validate import validate_cloud, validate_file

    pts = mesh_free_pair[0]
    path = tmp_path / "torus.ply"
    write_ply(str(path), pts, binary=True)
    kw = dict(shape="torus", k_neighbors=K_FREE, auto_k=False,
              use_mesh=False, device="cpu")
    got = validate_file(str(path), **kw)
    want = validate_cloud(pts, **kw)
    skip = ("runtime_s", "stage_timings")
    for f in dataclasses.fields(want):
        if f.name not in skip:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert list(got.stage_timings) == ["curvature"]


@pytest.mark.parametrize("kmax", [None, 40], ids=["default", "patched"])
def test_study_kmax_is_the_kmax_the_study_ran(monkeypatch, kmax):
    """A spy on the study: ``study_kmax`` records the ``kmax`` the study
    received, the module's STUDY_KMAX (99, the study's default)."""
    import pct_tpu_torch.validate.harness as harness

    if kmax is not None:
        monkeypatch.setattr(harness, "STUDY_KMAX", kmax)
    seen = []
    study = harness.explicit_quadratic_neighbor_study

    def spy(cloud, **kw):
        seen.append(kw["kmax"])
        return study(cloud, **kw)

    monkeypatch.setattr(harness, "explicit_quadratic_neighbor_study", spy)
    pts = generate_shape("sphere", 1500, perturbation_strength=0.01,
                         seed=0)[1]
    res = harness.validate_cloud(pts, k_neighbors=K_FREE, use_mesh=False,
                                 min_converged_k=0, device="cpu")
    assert seen == [res.study_kmax] == [kmax or 99]
    assert harness.STUDY_KMAX == (kmax or 99)
