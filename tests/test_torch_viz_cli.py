"""The port's plots, viewers and command line (``pct_tpu_torch.viz``,
``pct_tpu_torch.cli``) against the JAX package's, on the CPU.

- Each plot function runs in both packages on the same input; the
  pickled figures are unpickled and their data compared (each axes'
  title, labels and limits, each collection's 3D offsets or segments,
  colour array and face colours), not the pickle bytes. Figures that
  are only saved as PNG (the results plots) are compared by their bytes
  (the Agg backend is deterministic on one matplotlib).
- ``load_results`` and ``plot_error_scatter`` run in both packages on
  each CSV that each package's ``run_sweep([2000], [1.0], ["sphere"],
  k_neighbors=12)`` wrote; the two sweeps' energies agree within the
  harness's mesh parity (1e-5 relative, tests/test_torch_validate.py).
- ``cli.main`` of both packages on the same files: ``convert``,
  ``downsample`` and ``strip-normals`` write the same bytes; the
  ``curvature`` PLY carries the same points and K and H within the
  pipeline's 1e-4 of their largest value on the rows whose neighbor id
  sets agree (tests/test_torch_implicit.py).
"""

import pickle

import numpy as np
import pytest

import pct_tpu.viz as jviz
import pct_tpu_torch.viz as tviz
from pct_tpu_torch.shapes import generate_shape

N = 500


@pytest.fixture(scope="module")
def small_cloud():
    pts, _ = generate_shape("sphere", N, radius=1.0)
    return pts


def _figure_data(path):
    """The data of an unpickled figure, as a flat list of arrays and
    strings."""
    with open(path, "rb") as f:
        fig = pickle.load(f)
    out = []
    for ax in fig.axes:
        out += [ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                np.asarray(ax.get_xlim()), np.asarray(ax.get_ylim())]
        if hasattr(ax, "get_zlim"):
            out.append(np.asarray(ax.get_zlim()))
        for c in ax.collections:
            for attr in ("_offsets3d", "_segments3d"):
                if hasattr(c, attr):
                    out += [np.asarray(a, dtype=np.float64)
                            for a in getattr(c, attr)]
            arr = c.get_array()
            out.append(None if arr is None else np.asarray(arr))
            out.append(np.asarray(c.get_facecolor()))
    return out


def _same_figures(dirs):
    names = [sorted(p.name for p in d.iterdir()) for d in dirs]
    assert names[0] == names[1] and names[0]
    pickles = [n for n in names[0] if n.endswith(".pickle")]
    for name in pickles:
        a, b = (_figure_data(d / name) for d in dirs)
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            if isinstance(x, str) or x is None:
                assert x == y, name
            else:
                np.testing.assert_array_equal(x, y, err_msg=name)
    return names[0]


def _both(tmp_path, call):
    dirs = [tmp_path / side for side in ("jax", "port")]
    for mod, d in zip((jviz, tviz), dirs):
        d.mkdir()
        call(mod, str(d))
    return dirs


def test_curvature_figures_match_jax(tmp_path, small_cloud):
    rng = np.random.default_rng(0)
    K, H = rng.standard_normal(N), rng.standard_normal(N)
    K[3] = np.nan
    names = _same_figures(_both(tmp_path, lambda m, d: (
        m.plot_points_colored_by_curvature(small_cloud, K, H, d, tag="_t",
                                           sample=400))))
    assert "points_by_gaussian_curvature_t.pickle" in names
    assert "points_by_mean_sq_curvature_t.png" in names


def test_knn_surface_and_pca_figures_match_jax(tmp_path, small_cloud):
    rng = np.random.default_rng(1)
    idx = rng.integers(0, N, (N, 10))
    k1, k2 = rng.random(N), rng.random(N)
    d1, d2 = rng.standard_normal((N, 3)), rng.standard_normal((N, 3))

    def call(m, d):
        m.visualize_knn_for_random_points(small_cloud, idx, d)
        m.plot_surface(small_cloud, d, tag="_s")
        m.plot_pca_curvature(small_cloud, k1, k2, d1, d2, d, sample=300)

    names = _same_figures(_both(tmp_path, call))
    assert [n for n in names if n.endswith(".pickle")] == [
        "knn_random_points.pickle", "pca_K.pickle", "pca_directions.pickle",
        "surface_s.pickle"]


def test_view_figs_exports_as_jax(tmp_path, small_cloud):
    figs = tmp_path / "figs"
    figs.mkdir()
    tviz.plot_surface(small_cloud, str(figs))
    tviz.visualize_knn_for_random_points(
        small_cloud, np.tile(np.arange(10), (N, 1)), str(figs))
    got = tviz.view_figs(str(figs), show=False,
                         export_dir=str(tmp_path / "port"))
    want = jviz.view_figs(str(figs), show=False,
                          export_dir=str(tmp_path / "jax"))
    assert got == want and len(got) == 2
    assert (sorted(p.name for p in (tmp_path / "port").iterdir())
            == sorted(p.name for p in (tmp_path / "jax").iterdir())
            == ["knn_random_points.png", "surface.png"])


def test_view_meshes_fallback_as_jax(tmp_path):
    """pyvista is absent: both packages export a matplotlib trisurf (PLY
    with faces, through each package's reader) or scatter (VTK) PNG."""
    from pct_tpu_torch.io import write_ply, write_vtk
    from tests.test_torch_mesh import icosphere

    v, f = icosphere(2)
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        write_ply(str(d / "a.ply"), v, faces=f)
        write_vtk(str(d / "b.vtk"), v, f)
    for pattern in ("*.ply", "*.vtk"):
        want = jviz.view_meshes(str(tmp_path / "jax"), pattern=pattern,
                                show=False)
        got = tviz.view_meshes(str(tmp_path / "port"), pattern=pattern,
                               show=False)
        assert [p.split("/")[-1] for p in got] == [
            p.split("/")[-1] for p in want]
    for name in ("a.ply.png", "b.vtk.png"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


@pytest.fixture(scope="module")
def sweep_csvs(tmp_path_factory):
    """Each package's one-row sweep CSV (the mesh protocol)."""
    from pct_tpu.validate.sweep import run_sweep as jax_run_sweep
    from pct_tpu_torch.validate.sweep import run_sweep

    d = tmp_path_factory.mktemp("sweeps")
    paths = [str(d / f"{side}.csv") for side in ("jax", "port")]
    jax_run_sweep([2000], [1.0], ["sphere"], out_csv=paths[0],
                  backup_csv=None, k_neighbors=12)
    run_sweep([2000], [1.0], ["sphere"], out_csv=paths[1], backup_csv=None,
              k_neighbors=12, device="cpu")
    return paths


def test_sweep_csvs_agree(sweep_csvs):
    rows = [tviz.load_results(p) for p in sweep_csvs]
    assert len(rows[0]) == len(rows[1]) == 1
    (j,), (t,) = rows
    for key in ("shape", "variant", "num_points", "radius", "status"):
        assert t[key] == j[key], key
    for key in ("computed_area", "bending_energy", "stretching_energy"):
        assert abs(float(t[key]) - float(j[key])) <= 1e-5 * abs(float(j[key]))


@pytest.mark.parametrize("which", ["jax", "port"])
def test_results_plots_match_jax(tmp_path, sweep_csvs, which):
    csv_path = sweep_csvs[("jax", "port").index(which)]
    rows_j = jviz.load_results(csv_path)
    rows_t = tviz.load_results(csv_path)
    assert rows_t == rows_j and len(rows_t) == 1
    dirs = _both(tmp_path, lambda m, d: m.plot_error_scatter(rows_t, d))
    names = sorted(p.name for p in dirs[1].iterdir())
    assert names == ["area_error_pct.png", "bending_error_pct.png",
                     "stretching_error_pct.png"]
    for name in names:
        assert (dirs[0] / name).read_bytes() == (dirs[1] / name).read_bytes()


def test_histograms_and_disp_energies_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    npy = tmp_path / "npy"
    npy.mkdir()
    np.save(npy / "sphere_Unperturbed_2000_gaussian.npy",
            1 + 0.1 * rng.standard_normal(2000))
    np.save(npy / "torus_Unperturbed_2000_mean.npy",
            rng.standard_normal(2000))
    disp = tmp_path / "disp.csv"
    np.savetxt(disp, np.column_stack([np.linspace(0, 1, 20),
                                      rng.random(20)]), delimiter=",")

    def call(m, d):
        m.plot_curvature_histograms(str(npy), d)
        m.plot_disp_energies([("run", str(disp))], [(0.5, 1.0, 2.0)], d)

    dirs = _both(tmp_path, call)
    names = sorted(p.name for p in dirs[1].iterdir())
    assert names == sorted(p.name for p in dirs[0].iterdir()) == [
        "disp_energies.png", "hist_sphere_Unperturbed_2000_gaussian.png",
        "hist_torus_Unperturbed_2000_mean.png"]
    for name in names:
        assert (dirs[0] / name).read_bytes() == (dirs[1] / name).read_bytes()


def _cli_pair(out_dir, argv_of):
    """Both command lines on the same input, each writing its PLY into
    ``out_dir``; ``argv_of(out)`` is the argument list for output
    ``out``. Returns the two outputs (JAX, port)."""
    from pct_tpu.cli import main as jax_main
    from pct_tpu_torch.cli import main

    out_dir.mkdir(exist_ok=True)
    outs = [out_dir / f"{side}.ply" for side in ("jax", "port")]
    jax_main(argv_of(outs[0]))
    main(argv_of(outs[1]))
    return outs


def test_cli_convert_downsample_strip_match_jax(tmp_path, small_cloud):
    from pct_tpu_torch.io import write_ply

    rng = np.random.default_rng(3)
    asc = tmp_path / "scan.asc"
    np.savetxt(asc, np.hstack([small_cloud, rng.standard_normal((N, 3))]))
    conv = _cli_pair(tmp_path / "c", lambda out: [
        "convert", str(asc), str(out), "--voxel-size", "0.2"])
    assert conv[0].read_bytes() == conv[1].read_bytes()
    for mode in ("first", "centroid"):
        down = _cli_pair(tmp_path / mode, lambda out: [
            "downsample", str(conv[0]), str(out), "--voxel-size", "0.5",
            "--mode", mode, *(["--device", "cpu"] if "port" in out.name
                              else [])])
        assert down[0].read_bytes() == down[1].read_bytes(), mode
    withn = tmp_path / "with_normals.ply"
    write_ply(str(withn), small_cloud, rng.standard_normal((N, 3)))
    stripped = _cli_pair(tmp_path / "s", lambda out: ["strip-normals", str(withn),
                                         str(out)])
    assert stripped[0].read_bytes() == stripped[1].read_bytes()


def test_cli_curvature_matches_jax(tmp_path, small_cloud):
    from pct_tpu.core import from_numpy as jax_from_numpy
    from pct_tpu.neighbors import knn_cloud_grid as jax_knn_cloud_grid
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.io import read_ply, write_ply
    from pct_tpu_torch.neighbors import knn_cloud_grid

    inp = tmp_path / "in.ply"
    write_ply(str(inp), small_cloud)
    outs = _cli_pair(tmp_path, lambda out: [
        "curvature", str(inp), str(out), "--k", "12",
        *(["--device", "cpu"] if "port" in out.name else [])])
    j, t = (read_ply(str(p)) for p in outs)
    np.testing.assert_array_equal(t.points, j.points)
    ij = np.asarray(jax_knn_cloud_grid(jax_from_numpy(small_cloud),
                                       12)[0].indices)[:N]
    it = knn_cloud_grid(from_numpy(small_cloud, device="cpu"), 12,
                        device="cpu")[0].indices[:N].numpy()
    rows = (np.sort(ij, 1) == np.sort(it, 1)).all(1)
    assert rows.mean() >= 0.99
    for key in ("gaussian_curvature", "mean_curvature"):
        a, b = t.vertex_props[key], j.vertex_props[key]
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a[rows], b[rows], rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    dot = np.sum(t.normals * j.normals, axis=1)[rows]
    assert np.abs(dot).min() >= 1 - 1e-5
