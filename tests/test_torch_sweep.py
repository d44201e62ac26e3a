"""The sweep and the scans of the port (``pct_tpu_torch.validate.sweep``
and ``.scans``) against the JAX package's, on the CPU.

One module-scoped fixture runs both packages' sweep, another both
packages' scans, each into its own CSV in a temporary directory:

- ``run_sweep([3000], [1.0], ["sphere", "mobius"], perturbation=1e-3,
  k_neighbors=12, use_mesh=False)``: sphere Unperturbed and Perturbed,
  and the Möbius strip as Error rows (it has no closed-form area);
- ``run_scans(dir, use_mesh=False, k_neighbors=20, repeat=2)`` on two
  PLY files written here: a sphere perturbed by 0.01 (as in
  tests/test_validate.py) and a torus perturbed by 1e-3 (the near-tie
  reason of tests/test_torch_validate.py).

Rows are held to the harness tolerances of tests/test_torch_validate.py
(``runtime_s`` and the ``t_*`` columns are times and are not compared).
The port's CSV has the JAX columns without ``t_compile`` and ``cache``,
and it refuses to append to a CSV with another header.
"""

import csv
import json
import math
import pathlib

import numpy as np
import pytest

from pct_tpu_torch.shapes import generate_shape

ROOT = pathlib.Path(__file__).resolve().parent.parent
DROPPED = ("t_compile", "cache")
ENERGIES = ("computed_area", "bending_energy", "stretching_energy")


@pytest.fixture(scope="module")
def sweep_pair(tmp_path_factory):
    from pct_tpu.validate.sweep import run_sweep as jax_sweep
    from pct_tpu_torch.validate.sweep import run_sweep

    d = tmp_path_factory.mktemp("sweep")
    kw = dict(perturbation=1e-3, k_neighbors=12, use_mesh=False)
    args = ([3000], [1.0], ["sphere", "mobius"])
    want = jax_sweep(*args, out_csv=str(d / "jax.csv"),
                     backup_csv=str(d / "jax_backup.csv"), **kw)
    got = run_sweep(*args, out_csv=str(d / "port.csv"),
                    backup_csv=str(d / "port_backup.csv"), device="cpu",
                    **kw)
    return d, want, got


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_sweep_rows_match_jax(sweep_pair):
    _, want, got = sweep_pair
    assert [(r["shape"], r["variant"]) for r in got] == [
        (r["shape"], r["variant"]) for r in want] == [
        ("sphere", "Unperturbed"), ("sphere", "Perturbed"),
        ("mobius", "Unperturbed"), ("mobius", "Perturbed")]
    assert [r["status"] for r in got] == [r["status"] for r in want]
    assert [r["status"] for r in got[:2]] == ["ok", "ok"]
    assert all(r["status"].startswith("Error: ") for r in got[2:])
    for g, w in zip(got, want):
        assert set(g) == set(w) - set(DROPPED)
        for key in g:
            if key in ENERGIES:
                if math.isnan(w[key]):
                    assert math.isnan(g[key]), key
                else:
                    assert abs(g[key] - w[key]) <= 1e-4 * abs(w[key]), key
            elif key.endswith("_error_pct") and w[key] is not None:
                assert abs(g[key] - w[key]) <= 1e-2, key
            elif key != "runtime_s" and not key.startswith("t_"):
                np.testing.assert_equal(g[key], w[key], err_msg=key)


def test_sweep_csv_columns_and_backup(sweep_pair):
    from pct_tpu.validate.sweep import CSV_FIELDS as JAX_FIELDS
    from pct_tpu_torch.validate.sweep import CSV_FIELDS, STAGE_KEYS

    d, want, got = sweep_pair
    assert CSV_FIELDS == [f for f in JAX_FIELDS if f not in DROPPED]
    header, rows = _read(d / "port.csv")
    assert header == CSV_FIELDS and len(rows) == len(got) == 4
    assert [r[0] for r in rows] == ["sphere"] * 2 + ["mobius"] * 2
    b_header, b_rows = _read(d / "port_backup.csv")
    assert b_header == CSV_FIELDS and b_rows == rows
    assert set(STAGE_KEYS) == {f[2:] for f in CSV_FIELDS
                               if f.startswith("t_")}
    assert got[0]["t_curvature"] is not None and got[0]["t_study"] is None


def test_sweep_refuses_a_foreign_header(tmp_path):
    """An ``out_csv`` that starts with the committed CSV's 19-column
    header raises before any row is computed, and stays byte-identical."""
    from pct_tpu_torch.validate.sweep import run_sweep

    with open(ROOT / "incremental_shape_comparison_results.csv") as f:
        head = f.readline()
    out = tmp_path / "old.csv"
    out.write_text(head + "sphere,Unperturbed,1,1.0\n")
    before = out.read_bytes()
    with pytest.raises(ValueError, match=r"old\.csv.*column 6.*"
                       r"'computed_area'.*'converged_fraction'"):
        run_sweep([2000], [1.0], ["sphere"], out_csv=str(out),
                  backup_csv=None, use_mesh=False, device="cpu")
    assert out.read_bytes() == before


def test_two_sweeps_append_under_one_header(tmp_path):
    from pct_tpu_torch.validate.sweep import CSV_FIELDS, run_sweep

    out = tmp_path / "inc.csv"
    for _ in range(2):
        rows = run_sweep([2000], [1.0], ["sphere"], out_csv=str(out),
                         backup_csv=None, k_neighbors=12, use_mesh=False,
                         device="cpu")
        assert [r["status"] for r in rows] == ["ok"]
    header, body = _read(out)
    assert header == CSV_FIELDS and len(body) == 2
    assert out.read_text().count("shape,variant") == 1
    assert body[0][:6] == body[1][:6]


@pytest.fixture(scope="module")
def scans_pair(tmp_path_factory):
    from pct_tpu.validate.scans import run_scans as jax_scans
    from pct_tpu_torch.io import write_ply
    from pct_tpu_torch.validate.scans import run_scans

    d = tmp_path_factory.mktemp("scans")
    scans = d / "scans"
    scans.mkdir()
    clouds = {
        "s": generate_shape("sphere", 3000, radius=1.0,
                            perturbation_strength=0.01)[1],
        "t": generate_shape("torus", 3000, perturbation_strength=1e-3,
                            seed=0)[1],
    }
    for name, pts in clouds.items():
        write_ply(str(scans / f"{name}.ply"), pts)
    kw = dict(use_mesh=False, k_neighbors=20, repeat=2)
    want = jax_scans(str(scans), out_csv=str(d / "jax.csv"), **kw)
    got = run_scans(str(scans), out_csv=str(d / "port.csv"), device="cpu",
                    **kw)
    return d, scans, want, got


def test_scans_rows_match_jax(scans_pair):
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.io import load_points
    from pct_tpu_torch.pipeline import fast_curvature

    _, scans, want, got = scans_pair
    assert [(r["file"], r["run"]) for r in got] == [
        (r["file"], r["run"]) for r in want] == [
        (str(scans / f), run) for f in ("s.ply", "t.ply") for run in (1, 2)]
    for g, w in zip(got, want):
        print(f"{g['file']} run {g['run']}: converged k port "
              f"{g['converged_k']} ({g['converged_fraction']}), JAX "
              f"{w['converged_k']} ({w['converged_fraction']})")
        assert g["status"] == w["status"] == "ok"
        for key in ("num_points", "k_used", "study_kmax", "nan_fraction"):
            assert g[key] == w[key], key
        assert g["study_kmax"] == 99
        assert abs(g["converged_k"] - w["converged_k"]) <= 2
        for key in ("total_area", "bending_energy"):
            assert abs(g[key] - w[key]) <= 1e-4 * abs(w[key]), key
        pts, _ = load_points(g["file"])
        r = fast_curvature(from_numpy(pts, device="cpu"), 20, device="cpu")
        n = len(pts)
        a = np.pi * r.kth_dist[:n].numpy() ** 2 / 20
        mass = float(np.sum(np.abs(r.curv.K[:n].numpy()) * a))
        assert abs(g["stretching_energy"]
                   - w["stretching_energy"]) <= 1e-4 * mass
    for first, second in (got[0:2], got[2:4]):
        for key in ("converged_k", "total_area", "bending_energy",
                    "stretching_energy"):
            assert first[key] == second[key], key


def test_scans_csv_columns(scans_pair):
    from pct_tpu.validate.scans import FIELDS as JAX_FIELDS
    from pct_tpu_torch.validate.scans import FIELDS

    d, _, _, got = scans_pair
    assert FIELDS == [f for f in JAX_FIELDS if f not in DROPPED]
    header, rows = _read(d / "port.csv")
    assert header == FIELDS and len(rows) == len(got) == 4


def test_scans_main_profiles_and_traces(scans_pair, tmp_path, capsys):
    from pct_tpu_torch.validate import scans

    _, scan_dir, _, _ = scans_pair
    out, trace = tmp_path / "out.csv", tmp_path / "trace"
    scans.main(["--dir", str(scan_dir), "--pattern", "s.ply", "--out",
                str(out), "--k", "20", "--mesh-free", "--device", "cpu",
                "--profile", "--trace", str(trace)])
    text = capsys.readouterr().out
    assert "scans done: 1/1 ok" in text and "cumulative" in text
    events = json.loads((trace / scans.TRACE_FILE).read_text())
    assert events["traceEvents"]
    header, rows = _read(out)
    assert header == scans.FIELDS and len(rows) == 1


def test_sweep_main_writes_its_row(tmp_path, monkeypatch, capsys):
    from pct_tpu_torch.validate import sweep

    monkeypatch.chdir(tmp_path)          # the backup CSV's default path
    out = tmp_path / "out.csv"
    sweep.main(["--points", "3000", "--radii", "1", "--shapes", "sphere",
                "--mesh-free", "--device", "cpu", "--out", str(out)])
    assert "sweep done: 1/1 rows ok" in capsys.readouterr().out
    header, rows = _read(out)
    assert header == sweep.CSV_FIELDS and len(rows) == 1
    assert rows[0][:5] == ["sphere", "Unperturbed", "3000", "1.0", "20"]
    assert (tmp_path / "backup_shape_comparison_results.csv").exists()
