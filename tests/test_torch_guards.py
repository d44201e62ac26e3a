"""Guards of the port: no JAX anywhere in it, CUDA by default with no
quiet CPU fallback, TF32 off, the kernel launcher's operand checks, and
the slices of earlier refusals run."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import pct_tpu_torch
from pct_tpu_torch.core import from_numpy, from_reference_arrays
from pct_tpu_torch.neighbors import knn_cloud_grid
from pct_tpu_torch.pipeline import (
    curvature_pipeline,
    explicit_quadratic_neighbor_study,
    fast_curvature,
    fused_curvature,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "pct_tpu")


def _port_files():
    files = sorted((ROOT / "pct_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_pct_tpu():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def test_import_leaves_jax_unloaded():
    code = ("import sys; before = set(sys.modules); "
            "import pct_tpu_torch, pct_tpu_torch.pipeline, "
            "pct_tpu_torch.core, pct_tpu_torch.shapes; "
            "print(sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'pct_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    cloud = from_numpy(pts, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        fast_curvature(cloud, 20)
    with pytest.raises(RuntimeError, match="cuda"):
        fused_curvature(cloud.points, 64, torch.tensor(1.0), 20,
                        bucket_spec=())
    with pytest.raises(RuntimeError, match="cuda"):
        from_numpy(pts)
    with pytest.raises(RuntimeError, match="cuda"):
        fast_curvature(cloud, 20, method="implicit")
    with pytest.raises(RuntimeError, match="cuda"):
        knn_cloud_grid(cloud, 20)
    with pytest.raises(RuntimeError, match="cuda"):
        curvature_pipeline(cloud, 20)


def test_tf32_is_off_after_import():
    assert pct_tpu_torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("kwargs", [
    {"k": 64}, {"method": "implicit"}, {"engine": "moments"}],
    ids=["k64", "implicit", "moments"])
def test_later_slices_refuse(kwargs):
    """Every slice named here now runs on the CPU and stays finite: the
    moments engine (k >= 64, or ``engine="moments"``) and the implicit
    method (the list engine on this 64-point cloud)."""
    pts = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    cloud = from_numpy(pts, device="cpu")
    if "engine" in kwargs:
        state = from_reference_arrays(cloud.points.numpy(), 64, k=20,
                                      device="cpu")
        res = fused_curvature(state.cloud.points, 64, state.cell_size, 20,
                              max_cells=state.max_cells,
                              bucket_spec=state.bucket_spec, device="cpu",
                              **kwargs)
        assert res.exact[:64].all()
    else:
        res = fast_curvature(cloud, device="cpu", **kwargs)
        if "k" in kwargs:
            assert not res.exact.any()    # 63 other points: every row under k
        else:
            assert res.exact[:64].all()
    for a in (*res.curv, res.normals, res.kth_dist):
        assert torch.isfinite(a).all()


NEW_MODULES = ["pct_tpu_torch.experimental",
               "pct_tpu_torch.experimental.band_select",
               "pct_tpu_torch.experimental.band_knn",
               "pct_tpu_torch.curvature.pca",
               "pct_tpu_torch.pipeline.neighbor_study",
               "pct_tpu_torch.utils.filters",
               "pct_tpu_torch.utils.transforms",
               "pct_tpu_torch.mesh",
               "pct_tpu_torch.mesh.normals",
               "pct_tpu_torch.mesh.smooth",
               "pct_tpu_torch.mesh.energies",
               "pct_tpu_torch.mesh.downsample",
               "pct_tpu_torch.shapes.generators",
               "pct_tpu_torch.shapes.analytic",
               "pct_tpu_torch.io",
               "pct_tpu_torch.io.txt",
               "pct_tpu_torch.io.ply",
               "pct_tpu_torch.io.asc",
               "pct_tpu_torch.io.vtk",
               "pct_tpu_torch.mesh.boundary",
               "pct_tpu_torch.mesh.reconstruct",
               "pct_tpu_torch.pipeline.mesh_pipeline",
               "pct_tpu_torch.validate",
               "pct_tpu_torch.validate.harness",
               "pct_tpu_torch.validate.sweep",
               "pct_tpu_torch.validate.scans",
               "pct_tpu_torch.compat",
               "pct_tpu_torch.cli",
               "pct_tpu_torch.viz",
               "pct_tpu_torch.viz.plots",
               "pct_tpu_torch.viz.results",
               "pct_tpu_torch.viz.view",
               "pct_tpu_torch.demos",
               "pct_tpu_torch.demos.explicit_surfaces_demo",
               "pct_tpu_torch.demos.implicit_surfaces_demo"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_band_and_study_modules_import_no_jax(module):
    """Each module of the band kNN, PCA and study slice, and of the mesh
    slice, names neither JAX nor the JAX package among its imports."""
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert not [m for m in _imported_roots(path) if m in FORBIDDEN]


def test_band_and_study_modules_leave_jax_unloaded():
    code = (f"import sys; import {', '.join(NEW_MODULES)}; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'pct_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_neighbor_study_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        explicit_quadratic_neighbor_study(from_numpy(pts, device="cpu"))


def test_normals_default_to_cuda(monkeypatch):
    from pct_tpu_torch.mesh import estimate_and_orient_normals

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    cloud = from_numpy(pts, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        estimate_and_orient_normals(cloud)


def test_mesh_path_defaults_to_cuda(monkeypatch):
    """The mesh pipeline and ``reconstruct_cloud`` run their device stages
    on ``cuda`` unless told otherwise, and raise without a card before
    any host stage runs."""
    from pct_tpu_torch.mesh.reconstruct import reconstruct_cloud
    from pct_tpu_torch.pipeline import create_mesh_with_curvature

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        create_mesh_with_curvature(pts)
    with pytest.raises(RuntimeError, match="cuda"):
        reconstruct_cloud(pts)
    with pytest.raises(RuntimeError, match="cuda"):
        reconstruct_cloud(pts, normals=pts)


def test_validate_defaults_to_cuda(monkeypatch, tmp_path):
    """The harness, the sweep, the scans and both command lines run on ``cuda``
    unless told otherwise, and raise without a card before any row or
    file is written."""
    from pct_tpu_torch.io import write_ply
    from pct_tpu_torch.validate import run_scans, run_sweep, scans, sweep
    from pct_tpu_torch.validate import validate_cloud

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    pts = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    scan_dir = tmp_path / "scans"
    scan_dir.mkdir()
    write_ply(str(scan_dir / "cloud.ply"), pts)
    before = sorted(p.name for p in tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="cuda"):
        validate_cloud(pts, output_dir=str(tmp_path / "artifacts"))
    with pytest.raises(RuntimeError, match="cuda"):
        validate_cloud(pts, use_mesh=False, auto_k=False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_sweep([64], [1.0], ["sphere"], out_csv=str(tmp_path / "s.csv"),
                  backup_csv=str(tmp_path / "b.csv"), use_mesh=False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_scans(str(scan_dir), out_csv=str(tmp_path / "scans.csv"))
    with pytest.raises(RuntimeError, match="cuda"):
        sweep.main(["--points", "64", "--radii", "1", "--shapes", "sphere",
                    "--out", str(tmp_path / "main.csv")])
    with pytest.raises(RuntimeError, match="cuda"):
        scans.main(["--dir", str(scan_dir), "--out",
                    str(tmp_path / "main_scans.csv")])
    assert sorted(p.name for p in tmp_path.iterdir()) == before


def test_build_cache_keys_on_shared_headers(tmp_path, monkeypatch):
    """A library's path changes when any ``csrc/*.cuh`` changes, so an
    edited shared header never loads a stale library; another source's
    bytes leave it alone. No nvcc needed: only the key is computed."""
    import shutil

    from pct_tpu_torch.ops import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build.library_path("select_rows")
    assert build.library_path("select_rows") == first
    (csrc / "extra.cuh").write_text("// a new shared header\n")
    second = build.library_path("select_rows")
    assert second != first
    (csrc / "extra.cuh").write_text("// the same header, edited\n")
    third = build.library_path("select_rows")
    assert third not in (first, second)
    (csrc / "band_select.cu").write_text("// another source\n")
    assert build.library_path("select_rows") == third


@pytest.mark.parametrize("case", ["cpu", "meta", "int", "two_devices"])
def test_kernel_launcher_refuses_before_loading(monkeypatch, case):
    """``build.kernel``'s launcher checks its operands before it loads a
    library, so each refusal raises ``ValueError`` with no nvcc, and
    counts no launch."""
    from pct_tpu_torch.ops import build
    from pct_tpu_torch.utils import trace

    def no_load(name):
        raise AssertionError(f"{name} loaded before the operand checks")

    monkeypatch.setattr(build, "load", no_load)
    stats, out = torch.zeros(4, 48), torch.empty(4, 8)
    meta = (stats.to("meta"), out.to("meta"))
    operands, match = {
        "cpu": ((stats, out, 4), "no epilogue kernel for device cpu"),
        "meta": ((*meta, 4), "no epilogue kernel for device meta"),
        "int": ((*meta, 2**31), "not a 32-bit int"),
        "two_devices": ((stats, meta[1], 4), "2 devices"),
    }[case]
    before = trace.counters()
    with pytest.raises(ValueError, match=match):
        build.kernel("epilogue", "pct_moments_epilogue")(*operands)
    assert trace.counters() == before


@pytest.mark.parametrize("op", ["knn_moments", "list_fit",
                                "moments_epilogue"])
def test_cpu_paths_count_no_launch(op):
    """On CPU tensors the wrappers run their plain versions: no
    ``launches.*`` counter moves."""
    from pct_tpu_torch.ops.epilogue import moments_epilogue
    from pct_tpu_torch.ops.list_fit import list_fit
    from pct_tpu_torch.ops.moments import knn_moments
    from pct_tpu_torch.utils import trace

    gen = torch.Generator().manual_seed(0)
    tile = (torch.rand(1, 4, 3, generator=gen),
            torch.rand(1, 8, 3, generator=gen),
            torch.arange(8, dtype=torch.int32)[None],
            torch.full((1, 4), -1, dtype=torch.int32),
            torch.ones(1, 8, dtype=torch.int32))
    call, shape = {
        "knn_moments": (lambda: knn_moments(*tile, 3), (1, 4, 48)),
        "list_fit": (lambda: list_fit(torch.rand(4, 5, 3, generator=gen),
                                      torch.rand(4, 3, generator=gen)),
                     (4, 8)),
        "moments_epilogue": (
            lambda: moments_epilogue(knn_moments(*tile, 3)[0]), (4, 8)),
    }[op]

    def launches():
        return {key: n for key, n in trace.counters().items()
                if key.startswith("launches.")}

    before = launches()
    assert tuple(call().shape) == shape
    assert launches() == before


def test_facade_cli_and_demos_leave_matplotlib_unloaded():
    """matplotlib is not on the card's machine: the façade, the command
    line and the demos import it (through ``viz``) only inside the calls
    that plot."""
    code = ("import sys; import pct_tpu_torch.compat, pct_tpu_torch.cli, "
            "pct_tpu_torch.demos.explicit_surfaces_demo, "
            "pct_tpu_torch.demos.implicit_surfaces_demo; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'matplotlib' or m.startswith("
            "'pct_tpu_torch.viz')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_facade_cli_and_demos_default_to_cuda(monkeypatch, tmp_path):
    """The façade, its device functions, the command line's device
    commands and the demos run on ``cuda`` unless told otherwise, and
    raise without a card before writing anything."""
    from pct_tpu_torch import cli, compat
    from pct_tpu_torch.demos import (
        explicit_surfaces_demo,
        implicit_surfaces_demo,
    )
    from pct_tpu_torch.io import write_ply

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    inp = tmp_path / "in.ply"
    write_ply(str(inp), pts)
    before = sorted(p.name for p in tmp_path.iterdir())
    calls = [
        lambda: compat.PointCloud(points=pts),
        lambda: compat.PointCloud(points=pts, downsample=True),
        lambda: compat.estimate_curvature(pts),
        lambda: compat.average_distance_using_kd_tree(pts),
        lambda: compat.create_mesh_with_curvature(pts),
        lambda: compat.load_mesh_compute_energies(
            pts, np.zeros((1, 3), np.int32), pts[:, 0], pts[:, 0]),
        lambda: compat.validate_shape(str(inp)),
        lambda: cli.main(["curvature", str(inp), str(tmp_path / "o.ply")]),
        lambda: cli.main(["downsample", str(inp), str(tmp_path / "d.ply"),
                          "--voxel-size", "0.1"]),
        lambda: cli.main(["reconstruct", str(inp), str(tmp_path / "r.ply")]),
        lambda: explicit_surfaces_demo.run(),
        lambda: implicit_surfaces_demo.run(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert sorted(p.name for p in tmp_path.iterdir()) == before
