"""``create_mesh_with_curvature(device="cpu")`` end to end against the
JAX package's on the same points, on the CPU.

The 3000-point sphere at the JAX test's settings (k_neighbors=16,
num_radii=4, smooth_iterations=5) and a 5000-point torus at the
defaults, each package's pipeline run once per cloud (a module-scoped
fixture: the JAX package's normals alone take ~11 s a call on the CPU).
Each side computes its own normals (last-bit differences; the torus'
moments-route directions within 2.2e-4) and spacings; measured: the
same normal signs, the same face sets (symmetric difference 0 on both),
the same holes filled, area within 1e-7 and bending and stretching
within 5e-7 relative, K and H within 1e-4·max|K| (resp. max|H|) on the
port's certified rows, the tolerance of ``tests/test_torch_fused.py``
for two packages that compute their own state. The JAX test's analytic
checks hold too, the port's run writes its mesh through its own PLY
(sphere) and VTK (torus) writers, and a cloud that meshes to no face
gives NaN energies.
"""

import numpy as np
import pytest

from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.shapes import generate_shape

PIPE_CASES = {
    "sphere": ("sphere", 3000, dict(k_neighbors=16, num_radii=4,
                                    smooth_iterations=5), ".ply"),
    "torus": ("torus", 5000, {}, ".vtk"),
}


@pytest.fixture(scope="module", params=list(PIPE_CASES))
def pipeline_pair(request, tmp_path_factory):
    """Both packages' ``create_mesh_with_curvature`` on the same points,
    run once per cloud and shared by the tests below; the port's run
    also saves its mesh (the path is the last element)."""
    from pct_tpu.pipeline.mesh_pipeline import (
        create_mesh_with_curvature as jax_pipeline,
    )
    from pct_tpu_torch.pipeline import create_mesh_with_curvature

    shape, n, kw, ext = PIPE_CASES[request.param]
    pts, _ = generate_shape(shape, n, radius=1.0)
    path = tmp_path_factory.mktemp(shape) / f"mesh{ext}"
    got = create_mesh_with_curvature(pts, device="cpu",
                                     save_mesh_path=str(path), **kw)
    return request.param, pts, jax_pipeline(pts, **kw), got, path


def _face_set(f):
    return set(map(tuple, np.sort(f, axis=1).tolist()))


def test_pipeline_mesh_matches_jax(pipeline_pair):
    _, pts, want, got, _ = pipeline_pair
    n = len(pts)
    assert got.vertices.shape == want.vertices.shape == (n, 3)
    assert got.normals.shape == (n, 3) and got.K.shape == got.H.shape == (n,)
    assert (np.sum(got.normals * want.normals, axis=1) > 0).all()
    assert _face_set(got.faces) ^ _face_set(want.faces) == set()
    assert got.faces.dtype == np.int32 and len(got.faces) == len(want.faces)
    assert got.n_holes_filled == want.n_holes_filled
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0,
                               atol=1e-5)
    assert list(got.timings) == list(want.timings)


def test_pipeline_energies_match_jax(pipeline_pair):
    _, _, want, got, _ = pipeline_pair
    assert abs(got.energies.total_area / want.energies.total_area - 1) <= 1e-5
    for name in ("bending", "stretching"):
        g, w = getattr(got.energies, name), getattr(want.energies, name)
        assert abs(g - w) <= 1e-3 * abs(w), name


def test_pipeline_curvature_matches_jax(pipeline_pair):
    """K and H on the vertices, on the rows the port's own vertex fit
    certifies (its ``exact``), to 1e-4 of max|K| (max|H|)."""
    from pct_tpu_torch.pipeline import fast_curvature

    shape, pts, want, got, _ = pipeline_pair
    n = len(pts)
    k = PIPE_CASES[shape][2].get("k_neighbors", 20)
    exact = fast_curvature(from_numpy(got.vertices, device="cpu"), k,
                           device="cpu").exact[:n].numpy()
    assert exact.mean() > 0.99
    for a, b in ((got.K, want.K), (got.H, want.H)):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a[exact], b[exact], rtol=0,
                                   atol=1e-4 * np.abs(b[exact]).max())


def test_pipeline_analytic_checks(pipeline_pair):
    """The JAX package's own checks (tests/test_reconstruct.py) on the
    sphere; on the torus the analytic area and energies and consistent
    normals."""
    from pct_tpu_torch.shapes import analytic_area, analytic_energies

    shape, pts, _, got, _ = pipeline_pair
    e = got.energies
    if shape == "sphere":
        assert got.faces.shape[0] > 4000
        assert np.isclose(e.total_area, 4 * np.pi, rtol=0.1)
        assert np.isclose(e.bending, 4 * np.pi, rtol=0.25)
        assert np.isclose(e.stretching, 4 * np.pi, rtol=0.25)
        frac = (np.sum(got.normals * pts, axis=1) > 0).mean()
    else:
        bend, _ = analytic_energies("torus")
        assert np.isclose(e.total_area, analytic_area("torus"), rtol=0.01)
        assert np.isclose(e.bending, bend, rtol=0.1)
        assert abs(e.stretching) <= 1.0
        rho = np.hypot(pts[:, 0], pts[:, 1])[:, None]
        tube = pts - 0.75 * rho.max() * np.concatenate(
            [pts[:, :2] / rho, np.zeros((len(pts), 1))], 1)
        frac = (np.sum(got.normals * tube, axis=1) > 0).mean()
    assert frac > 0.999 or frac < 0.001


def test_pipeline_saves_its_mesh(pipeline_pair):
    """``save_mesh_path`` through the port's own writers (PLY for the
    sphere, VTK for the torus): the file reads back to the result's
    vertices, faces, normals (PLY), K and H, at the writers' %.8g."""
    from pct_tpu_torch.io import read_ply, read_vtk

    _, _, _, got, path = pipeline_pair
    if path.suffix == ".ply":
        d = read_ply(str(path))
        v, f = d.points, d.faces
        sc = d.vertex_props
        np.testing.assert_allclose(d.normals, got.normals, rtol=1e-7,
                                   atol=1e-7)
    else:
        v, f, sc = read_vtk(str(path))
    np.testing.assert_array_equal(f, got.faces)
    np.testing.assert_allclose(v, got.vertices, rtol=1e-7, atol=1e-7)
    for key, want in (("gaussian_curvature", got.K),
                      ("mean_curvature", got.H)):
        np.testing.assert_allclose(sc[key], want, rtol=1e-7, atol=1e-7)


def test_pipeline_without_faces_gives_nan_energies():
    from pct_tpu_torch.pipeline import create_mesh_with_curvature

    line = np.stack([np.linspace(0, 1, 64), np.zeros(64), np.zeros(64)],
                    1).astype(np.float32)
    r = create_mesh_with_curvature(line, k_neighbors=8, num_radii=2,
                                   device="cpu")
    assert r.faces.shape == (0, 3) and r.n_holes_filled == 0
    assert np.isnan(r.energies.bending) and np.isnan(r.energies.stretching)
    assert r.energies.total_area == 0.0
    assert "smooth" not in r.timings and "holes_small" not in r.timings
    np.testing.assert_array_equal(r.vertices, line)
