"""The host half of the mesh path and the last loose ends of the ported
modules, against the JAX package on the CPU.

Boundary loops and hole filling (``pct_tpu_torch.mesh.boundary``), on
identical inputs: an icosphere with two caps cut out, and the BPA mesh
of a 3000-point uniformly random sphere (radius 1.2·d̄: 256 loops of 3 to
61 vertices, 83 of them not simple cycles). ``boundary_edges``,
``detect_boundary_loops``, ``order_loop``, ``fill_hole``,
``fill_small_holes``, ``fill_holes_by_size`` and ``is_planar`` give the
JAX package's results exactly.

Ball pivoting (``pct_tpu_torch.mesh.reconstruct``, the port's own copy of
``native/bpa.cpp`` built into ``pct_tpu_torch/_build/``): the same faces
as the JAX package's on the same points, normals and radii, with and
without the degeneracy jitter; ``cleanup_mesh``, both radii ladders and
``reconstruct_cloud`` equal; the JAX package's watertight-icosphere and
degenerate-input tests. The mesh pipeline end to end is in
``tests/test_torch_mesh_pipeline.py``.

A16: ``PointCloud.norms``/``bounds``/``domains``,
``fit_quadratic_lstsq_oracle`` and the un-bucketed
``fused_curvature(bucket_spec=None)``.
"""

import pathlib
import subprocess
import types

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import pct_tpu.mesh.boundary as jb
import pct_tpu.mesh.reconstruct as jr
import pct_tpu_torch.mesh.boundary as tb
import pct_tpu_torch.mesh.reconstruct as tr
from pct_tpu.core import from_numpy as jax_from_numpy
from pct_tpu_torch.core import from_numpy, from_reference_arrays
from pct_tpu_torch.shapes import generate_shape
from tests.test_torch_mesh import icosphere

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _random_sphere(n, seed):
    p = np.random.default_rng(seed).standard_normal((n, 3))
    return (p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)


def _mean_spacing(pts):
    d, _ = cKDTree(pts).query(pts, k=2)
    return float(d[:, 1].mean())


def _capped_icosphere():
    v, f = icosphere(3)
    z = v[f][..., 2]
    keep = ~((z > 0.8).any(1) | (z < -0.55).all(1))
    return v, f[keep]


def _bpa_sphere():
    pts = _random_sphere(3000, 11)
    faces = jr.cleanup_mesh(jr.ball_pivoting(pts, pts, [1.2 * _mean_spacing(pts)]))
    return pts, faces


@pytest.fixture(scope="module", params=["capped_icosphere", "bpa_sphere"])
def holed(request):
    v, f = _capped_icosphere() if request.param == "capped_icosphere" \
        else _bpa_sphere()
    return v, f, jb.boundary_edges(f)


def _same_loops(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# --- boundary loops and hole filling ---------------------------------------

def test_boundary_edges_and_loops_match_jax(holed):
    v, f, be = holed
    got = tb.boundary_edges(f)
    assert got.dtype == be.dtype and len(got) > 0
    np.testing.assert_array_equal(got, be)
    loops = tb.detect_boundary_loops(f)
    _same_loops(loops, jb.detect_boundary_loops(f))
    assert len(loops) >= 2
    partition, edge_loop = tb._loop_partition(be)
    want_p, want_e = jb._loop_partition(be)
    _same_loops(partition, want_p)
    np.testing.assert_array_equal(edge_loop, want_e)
    for loop in loops[:40]:
        assert tb.loop_perimeter(v, loop, f, be) == \
            jb.loop_perimeter(v, loop, f, be)
    assert tb.detect_boundary_loops(icosphere(1)[1]) == []


def test_order_loop_and_fill_hole_match_jax(holed):
    v, _, be = holed
    simple = 0
    for loop in jb._loop_partition(be)[0]:
        got, want = tb.order_loop(be, loop), jb.order_loop(be, loop)
        assert (got is None) == (want is None)
        if want is not None:
            simple += 1
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tb.fill_hole(v, loop),
                                      jb.fill_hole(v, loop))
    assert simple >= 2


def test_fill_hole_degenerate_loops_match_jax():
    """A collinear loop (Qhull refuses both the Delaunay and the hull:
    no faces) and loops of fewer than 4 vertices."""
    v = np.stack([np.linspace(0, 1, 6), np.zeros(6), np.zeros(6)],
                 1).astype(np.float32)
    for loop in (np.arange(6), np.arange(3), np.arange(2)):
        got, want = tb.fill_hole(v, loop), jb.fill_hole(v, loop)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert tb.fill_hole(v, np.arange(6)).shape == (0, 3)


@pytest.mark.parametrize("factor, tol", [(0.5, 1e-2), (3.0, 0.1)],
                         ids=["defaults", "wide"])
def test_fill_small_holes_matches_jax(holed, factor, tol):
    v, f, _ = holed
    got, n = tb.fill_small_holes(v, f, perimeter_factor=factor,
                                 planar_tol=tol)
    want, n_j = jb.fill_small_holes(v, f, perimeter_factor=factor,
                                    planar_tol=tol)
    assert n == n_j
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hole_size, max_loop", [(0.05, 256), (0.6, 256),
                                                 (0.6, 8)],
                         ids=["small", "large", "fan"])
def test_fill_holes_by_size_matches_jax(holed, hole_size, max_loop):
    v, f, _ = holed
    got, n = tb.fill_holes_by_size(v, f, hole_size, max_loop)
    want, n_j = jb.fill_holes_by_size(v, f, hole_size, max_loop)
    assert n == n_j
    np.testing.assert_array_equal(got, want)


def test_fill_passes_on_a_closed_mesh_return_it():
    v, f = icosphere(2)
    for got, n in (tb.fill_small_holes(v, f), tb.fill_holes_by_size(v, f, 1.0)):
        assert n == 0 and got is f


def test_is_planar_matches_jax():
    rng = np.random.default_rng(5)
    plane = rng.standard_normal((40, 3)) * np.array([1.0, 1.0, 0.0])
    cases = [plane, plane + rng.standard_normal((40, 3)) * 1e-4,
             plane + rng.standard_normal((40, 3)) * 0.1,
             rng.standard_normal((40, 3)), np.zeros((5, 3)),
             np.ones((3, 3))]
    got = [tb.is_planar(c) for c in cases]
    assert got == [jb.is_planar(c) for c in cases]
    assert got[:2] == [True, True] and got[3] is False
    assert [tb.is_planar(c, tol=0.5) for c in cases] == \
        [jb.is_planar(c, tol=0.5) for c in cases]


# --- ball pivoting ---------------------------------------------------------

def _bpa_clouds():
    sphere = _random_sphere(3000, 11)
    torus, _ = generate_shape("torus", 3000, radius=1.0)
    rho = np.hypot(torus[:, 0], torus[:, 1])
    ax = np.stack([torus[:, 0] / rho, torus[:, 1] / rho,
                   np.zeros(len(torus))], 1)
    t_nrm = torus - ax * 0.75 * rho.max()
    t_nrm /= np.linalg.norm(t_nrm, axis=1, keepdims=True)
    return {"random_sphere": (sphere, sphere),
            "lattice_torus": (torus, t_nrm.astype(np.float32))}


BPA_CLOUDS = _bpa_clouds()


@pytest.mark.parametrize("jitter", ["none", "jitter", "jitter_own_spacing"])
@pytest.mark.parametrize("cloud", list(BPA_CLOUDS))
def test_ball_pivoting_matches_jax(cloud, jitter):
    pts, nrm = BPA_CLOUDS[cloud]
    dbar = _mean_spacing(pts)
    radii = tr.bpa_radii(dbar, 6)
    kw = {"none": {}, "jitter": dict(degeneracy_jitter=0.01,
                                     mean_spacing=dbar),
          "jitter_own_spacing": dict(degeneracy_jitter=0.01)}[jitter]
    got = tr.ball_pivoting(pts, nrm, radii, **kw)
    want = jr.ball_pivoting(pts, nrm, radii, **kw)
    assert got.dtype == want.dtype == np.int32
    assert len(got) > len(pts)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tr.cleanup_mesh(got), jr.cleanup_mesh(want))


def test_bpa_passes_match_jax():
    pts, nrm = BPA_CLOUDS["random_sphere"]
    radii = [1.2 * _mean_spacing(pts)]
    got = tr.ball_pivoting(pts, nrm, radii, passes=2)
    np.testing.assert_array_equal(got, jr.ball_pivoting(pts, nrm, radii,
                                                        passes=2))
    assert len(tr.ball_pivoting(pts[:2], nrm[:2], radii)) == 0


def test_cleanup_mesh_matches_jax():
    rng = np.random.default_rng(3)
    f = rng.integers(0, 60, size=(4000, 3)).astype(np.int32)
    f = np.concatenate([f, f[:500][:, ::-1], f[:300][:, [1, 2, 0]]])
    got = tr.cleanup_mesh(f)
    np.testing.assert_array_equal(got, jr.cleanup_mesh(f))
    assert len(got) < len(f)
    empty = np.zeros((0, 3), np.int32)
    assert tr.cleanup_mesh(empty) is empty


def test_radii_ladders_match_jax():
    rng = np.random.default_rng(4)
    for dbar, num in ((0.01, 8), (0.37, 4), (2.0, 25)):
        np.testing.assert_array_equal(tr.bpa_radii(dbar, num),
                                      jr.bpa_radii(dbar, num))
    spreads = [rng.uniform(0.9, 1.1, 500),          # uniform: spread < 3
               rng.uniform(0.2, 1.0, 500) * 0.01,   # spread >= 3
               np.r_[rng.uniform(1, 2, 200), np.nan, 0.0, np.inf],
               np.array([np.nan, np.nan]), np.array([])]
    for d in spreads:
        for max_num in (25, 10):
            np.testing.assert_array_equal(
                tr.bpa_radii_adaptive(d, max_num),
                jr.bpa_radii_adaptive(d, max_num))


def test_bpa_icosphere_watertight():
    """The JAX package's test on the port's library: icosphere(3) with its
    exact normals reconstructs to its own triangulation, watertight."""
    v, f_true = icosphere(3)
    nrm = v / np.linalg.norm(v, axis=1, keepdims=True)
    dbar = _mean_spacing(v)
    faces = tr.cleanup_mesh(tr.ball_pivoting(v, nrm, [1.2 * dbar, 2 * dbar,
                                                      4 * dbar]))
    assert faces.shape[0] == f_true.shape[0]
    assert tb.boundary_edges(faces).size == 0
    used = np.zeros(len(v), bool)
    used[faces.ravel()] = True
    assert used.all()


def test_bpa_degenerate_inputs_terminate():
    """The JAX package's test on the port's library: exact duplicates and
    a collinear run terminate, index only valid vertices, and the sphere
    part still reconstructs."""
    pts, _ = generate_shape("sphere", 2000, radius=1.0)
    pts = np.asarray(pts, np.float32)
    line = np.stack([np.linspace(2.0, 3.0, 60), np.zeros(60), np.zeros(60)],
                    -1).astype(np.float32)
    cloud = np.concatenate([pts, pts[:50], line])
    normals = cloud / np.maximum(
        np.linalg.norm(cloud, axis=1, keepdims=True), 1e-9)
    d = float(np.linalg.norm(pts[0] - pts[1:], axis=1).min())
    faces = tr.cleanup_mesh(tr.ball_pivoting(cloud, normals, [d, 2 * d, 4 * d]))
    assert faces.min() >= 0 and faces.max() < len(cloud)
    assert (faces < len(pts)).all(axis=1).sum() > 0.8 * len(pts)
    np.testing.assert_array_equal(
        faces, jr.cleanup_mesh(jr.ball_pivoting(cloud, normals,
                                                [d, 2 * d, 4 * d])))


def _tree(root):
    return {p.relative_to(root): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_library_builds_under_the_port_build_dir(tmp_path, monkeypatch):
    """The port's library comes from ``pct_tpu_torch/native/bpa.cpp`` and
    lives in ``pct_tpu_torch/_build/``; a build (here into a fresh
    directory, the compiler a stub that records its command and writes
    its output; every other test of this file builds and loads the real
    library) runs one g++ on that source, renames its per-process
    temporary into place and writes nothing under ``pct_tpu/`` (whose
    own library, which the JAX package's tests may build meanwhile, is
    set aside)."""
    assert tr.SRC == ROOT / "pct_tpu_torch" / "native" / "bpa.cpp"
    assert tr.library_path().parent == ROOT / "pct_tpu_torch" / "_build"
    assert tr.library_path().name.startswith("libbpa-")
    jax_lib = pathlib.Path(jr._lib_path()).name
    jax_pkg = ROOT / "pct_tpu"

    def outside_jax_lib(tree):
        return {p: s for p, s in tree.items()
                if not p.name.startswith(jax_lib)}

    before = outside_jax_lib(_tree(jax_pkg))
    calls = []

    def run(cmd, **kw):
        calls.append(list(cmd))
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(tr, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tr, "subprocess", types.SimpleNamespace(
        run=run, CalledProcessError=subprocess.CalledProcessError))
    lib = tr.library_path()
    tr._build_lib(lib)
    assert lib.exists() and lib.parent == tmp_path / "_build"
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]
    assert calls and calls[-1][0] == "g++" and str(tr.SRC) in calls[-1]
    out = pathlib.Path(calls[-1][calls[-1].index("-o") + 1])
    assert out.parent == tmp_path / "_build" and out != lib
    assert out.name.startswith(lib.name) and "-march=native" in calls[-1]
    assert outside_jax_lib(_tree(jax_pkg)) == before
    assert not list(jax_pkg.rglob(lib.name))


def test_reconstruct_cloud_matches_jax():
    """Given normals, each package's own spacings and adaptive radii give
    the same faces; without them the port estimates its own normals on
    the device it is given (the JAX package's are not recomputed here:
    they cost ~10 s on the CPU)."""
    from pct_tpu_torch.mesh import estimate_and_orient_normals

    pts = _random_sphere(800, 9)
    got = tr.reconstruct_cloud(pts, normals=pts, device="cpu")
    assert len(got) > len(pts)
    np.testing.assert_array_equal(got, jr.reconstruct_cloud(pts, normals=pts))
    nrm = estimate_and_orient_normals(from_numpy(pts, device="cpu"), k=50,
                                      device="cpu")[:800].numpy()
    got = tr.reconstruct_cloud(pts, num_radii=4, device="cpu")
    np.testing.assert_array_equal(
        got, jr.reconstruct_cloud(pts, normals=nrm, num_radii=4))


# --- A16: cloud norms and extents, the lstsq oracle, un-bucketed fused -----

def test_cloud_norms_bounds_domains_match_jax():
    pts = np.random.default_rng(8).standard_normal((1000, 3)).astype(
        np.float32) * np.float32(3.0)
    c, cj = from_numpy(pts, device="cpu"), jax_from_numpy(pts)
    assert c.capacity == cj.capacity > 1000
    got, want = c.norms(), cj.norms()
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-6)
    assert float(got["linf"]) == float(want["linf"])
    for a, b in zip(c.bounds(), cj.bounds()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(c.bounds()[1].numpy(), pts.max(0))
    dom, dom_j = c.domains(), cj.domains()
    assert dom.keys() == dom_j.keys() == {"x", "y", "z"}
    for key in dom:
        assert tuple(float(x) for x in dom[key]) == \
            tuple(float(x) for x in dom_j[key])


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_fit_quadratic_lstsq_oracle_matches_jax(masked):
    import jax.numpy as jnp

    from pct_tpu.fit.quadratic import fit_quadratic_lstsq_oracle as jax_oracle
    from pct_tpu_torch.fit import fit_quadratic, fit_quadratic_lstsq_oracle

    rng = np.random.default_rng(12)
    coefs = rng.standard_normal((16, 6)).astype(np.float32) * 0.3
    ab = rng.standard_normal((16, 40, 2)).astype(np.float32) * 0.5
    a, b = ab[..., 0], ab[..., 1]
    z = (coefs[:, 0, None] * a * a + coefs[:, 1, None] * b * b
         + coefs[:, 2, None] * a * b + coefs[:, 3, None] * a
         + coefs[:, 4, None] * b + coefs[:, 5, None])
    z = z + rng.standard_normal(z.shape).astype(np.float32) * 1e-3
    rot = np.concatenate([ab, z[..., None]], -1).astype(np.float32)
    mask = rng.uniform(size=(16, 40)) > 0.3 if masked else None
    got = fit_quadratic_lstsq_oracle(
        torch.from_numpy(rot), None if mask is None else torch.from_numpy(mask))
    want = np.asarray(jax_oracle(jnp.asarray(rot),
                                 None if mask is None else jnp.asarray(mask)))
    assert got.shape == (16, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if not masked:
        ne = fit_quadratic(torch.from_numpy(rot)).numpy()
        np.testing.assert_allclose(ne, got.numpy(), rtol=5e-3, atol=5e-4)


@pytest.fixture(scope="module")
def unbucketed():
    """A perturbed 3k torus (as in tests/test_torch_fused.py) on the JAX
    package's cell size, through the port's un-bucketed and bucketed
    routes and the JAX package's un-bucketed route."""
    from pct_tpu.neighbors.grid import estimate_cell_size as jax_cell_size
    from pct_tpu.pipeline.fused import fused_curvature as jax_fused
    from pct_tpu_torch.pipeline import fused_curvature

    pts = generate_shape("torus", 3000, perturbation_strength=1e-3,
                         seed=1)[1]
    cj = jax_from_numpy(pts)
    cell = jax_cell_size(cj.points, cj.num_points, 20)
    rj = jax_fused(cj.points, cj.num_points, cell, k=20)
    state = from_reference_arrays(np.asarray(cj.points), 3000,
                                  cell_size=np.asarray(cell), k=20,
                                  device="cpu")
    un = fused_curvature(state.cloud.points, 3000, state.cell_size, 20,
                         device="cpu")
    bk = fused_curvature(state.cloud.points, 3000, state.cell_size, 20,
                         bucket_spec=state.bucket_spec,
                         max_cells=state.max_cells, device="cpu")
    return rj, un, bk


def test_unbucketed_fused_equals_bucketed(unbucketed):
    _, un, bk = unbucketed
    n = 3000
    both = (un.exact & bk.exact)[:n]
    assert both.float().mean() > 0.99
    for a, b in ((un.curv.K, bk.curv.K), (un.curv.H, bk.curv.H),
                 (un.kth_dist, bk.kth_dist), (un.normals, bk.normals)):
        assert torch.equal(a[:n][both], b[:n][both])


def test_unbucketed_fused_matches_jax(unbucketed):
    rj, un, _ = unbucketed
    n = 3000
    e = un.exact[:n].numpy()
    np.testing.assert_array_equal(e, np.asarray(rj.exact)[:n])
    K_j, H_j = np.asarray(rj.curv.K)[:n][e], np.asarray(rj.curv.H)[:n][e]
    np.testing.assert_allclose(un.curv.K[:n].numpy()[e], K_j, rtol=0,
                               atol=1e-4 * np.abs(K_j).max())
    np.testing.assert_allclose(un.curv.H[:n].numpy()[e], H_j, rtol=0,
                               atol=1e-4 * np.abs(H_j).max())
    np.testing.assert_allclose(un.kth_dist[:n].numpy()[e],
                               np.asarray(rj.kth_dist)[:n][e], rtol=1e-5)


def test_unbucketed_fused_takes_capacity_and_cand_cap():
    """``capacity`` and ``cand_cap`` size the one bucket; a capacity below
    the fullest cell leaves that cell's rows uncertified."""
    from pct_tpu_torch.neighbors.cellknn import all_points_spec
    from pct_tpu_torch.pipeline import fused_curvature

    spec, mc = all_points_spec(4096, 20, 40, None, 600)
    assert len(spec) == 1 and spec[0].capacity == 40
    assert spec[0].cand_cap == 600 and spec[0].max_cells == mc
    assert all_points_spec(4096, 20)[0][0].cand_cap == 27 * 72
    pts = generate_shape("sphere", 2000)[0]
    state = from_reference_arrays(pts, 2000, k=20, device="cpu")
    wide = fused_curvature(state.cloud.points, 2000, state.cell_size, 20,
                           device="cpu")
    tight = fused_curvature(state.cloud.points, 2000, state.cell_size, 20,
                            capacity=8, cand_cap=64, device="cpu")
    assert wide.exact[:2000].all()
    assert tight.exact[:2000].float().mean() < wide.exact[:2000].float().mean()
