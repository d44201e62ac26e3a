"""The moments engine's layout and routing in the port against the JAX
package, on the CPU: ``split_cells`` and ``probe_grid_buckets(split_to=
...)`` against the JAX tables, split against unsplit, and the engine
choice at k < 64 (``list_engine_ok``, ``plan_engine``).

The kernel, the fit and the k=100 slice are in
tests/test_torch_moments.py.
"""

import numpy as np
import pytest

import pct_tpu.neighbors.cellknn as jck
from pct_tpu.core import from_numpy as jax_from_numpy
from pct_tpu.neighbors.grid import build_grid as jax_build_grid
from pct_tpu.neighbors.grid import estimate_cell_size as jax_cell_size
from pct_tpu_torch.core import from_reference_arrays
from pct_tpu_torch.neighbors import cellknn
from pct_tpu_torch.neighbors.grid import build_grid
from pct_tpu_torch.pipeline import fused_curvature, plan_engine
from pct_tpu_torch.shapes import generate_shape
from pct_tpu_torch.utils import trace
from tests.test_torch_moments import _public_paths_agree


def _shell_cluster():
    """Sparse shell + one dense cluster: the cluster cell holds a few
    hundred points (tests/test_moments.py's split fixture)."""
    rng = np.random.default_rng(3)
    shell, _ = generate_shape("sphere", 1000, radius=1.0)
    cluster = (0.02 * rng.standard_normal((320, 3)) + 0.5).astype(np.float32)
    return np.concatenate([np.asarray(shell, np.float32), cluster])


# ---- split layout and engine choice ---------------------------------------

@pytest.fixture(scope="module")
def shell_cluster():
    pts = _shell_cluster()
    cj = jax_from_numpy(pts)
    k = 72
    cell = jax_cell_size(cj.points, cj.num_points, k)
    jgrid = jax_build_grid(cj.points, cj.num_points, cell)
    state = from_reference_arrays(np.asarray(cj.points), len(pts),
                                  cell_size=cell, k=k, device="cpu")
    grid = build_grid(state.cloud.points, len(pts), state.cell_size)
    return pts, k, jgrid, grid, state


def test_probe_split_to_matches_jax(shell_cluster):
    _, k, jgrid, grid, state = shell_cluster
    for split_to in (128, 64):
        s_j, mc_j, f_j = jck.probe_grid_buckets(jgrid, capacity_cap=4 * k,
                                                split_to=split_to)
        s_t, mc_t, f_t = cellknn.probe_grid_buckets(grid, capacity_cap=4 * k,
                                                    split_to=split_to)
        assert f_t == f_j > 1 and mc_t == mc_j
        assert [tuple(s) for s in s_t] == [tuple(s) for s in s_j]
        assert all(sp.capacity <= split_to for sp in s_t)
    # a k >= 64 state probes the moments route and carries its factor
    s128 = cellknn.probe_grid_buckets(grid, capacity_cap=4 * k,
                                      split_to=128)
    assert state.bucket_spec == s128[0] and state.split_factor == s128[2]
    assert cellknn.probe_grid_buckets(grid, capacity_cap=4 * k,
                                      split_to=4096)[2] == 1


def test_split_cells_matches_jax(shell_cluster):
    _, k, jgrid, grid, _ = shell_cluster
    _, mc, factor = cellknn.probe_grid_buckets(grid, capacity_cap=4 * k,
                                               split_to=128)
    n = grid.sorted_points.shape[0]
    sc_j = jck.split_cells(jck.compact_cells(jgrid, mc), n, 128, factor)
    sc_t = cellknn.split_cells(cellknn.compact_cells(grid, mc), n, 128,
                               factor)
    for a, b in zip(sc_t, sc_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(sc_t.max_count) <= 128 < int(
        cellknn.compact_cells(grid, mc).max_count)
    # the run table resolves duplicate ids to the first copy
    rs_s, rl_s = cellknn._runs_table(grid, sc_t)
    rs_j, rl_j = jck._runs_table(jgrid, sc_j)
    np.testing.assert_array_equal(rs_s.numpy(), np.asarray(rs_j))
    np.testing.assert_array_equal(rl_s.numpy(), np.asarray(rl_j))


def test_split_cells_moments_matches_unsplit(shell_cluster):
    """The virtual split is a pure layout change: split and unsplit runs
    agree on ``exact`` row for row and on K of certified rows."""
    pts, k, _, grid, state = shell_cluster
    n = len(pts)
    spec_s, mc_s, factor = cellknn.probe_grid_buckets(
        grid, capacity_cap=4 * k, split_to=128)
    spec_u, mc_u = cellknn.probe_grid_buckets(grid, capacity_cap=512)
    kw = dict(engine="moments", device="cpu")
    r_s = fused_curvature(state.cloud.points, n, state.cell_size, k,
                          bucket_spec=spec_s, max_cells=mc_s,
                          split=(128, factor), **kw)
    r_u = fused_curvature(state.cloud.points, n, state.cell_size, k,
                          bucket_spec=spec_u, max_cells=mc_u, **kw)
    e = r_s.exact[:n].numpy()
    np.testing.assert_array_equal(e, r_u.exact[:n].numpy())
    assert e.mean() > 0.5 and e.sum() > 500
    np.testing.assert_allclose(r_s.curv.K[:n].numpy()[e],
                               r_u.curv.K[:n].numpy()[e], rtol=2e-4,
                               atol=1e-5)


def test_list_engine_ok_matches_jax():
    grid = [(c, m, k) for c in (8, 32, 128, 256, 400)
            for m in (200, 760, 1000, 1500, 3000, 6000)
            for k in (1, 20, 31, 32, 48, 63)]
    got = [cellknn.list_engine_ok(c, m, k) for c, m, k in grid]
    want = [jck.pallas_select_ok(c, m, k) for c, m, k in grid]
    assert got == want
    assert any(got) and not all(got)


def test_fast_curvature_takes_moments_where_jax_does():
    """At k=48 the shell+cluster cloud's list-engine spec is refused by
    both packages' rule, so both run the moments engine."""
    k = 48
    pts = _shell_cluster()
    cj = jax_from_numpy(pts)
    cell = jax_cell_size(cj.points, cj.num_points, k)
    spec_j, _ = jck.probe_grid_buckets(
        jax_build_grid(cj.points, cj.num_points, cell), capacity_cap=256)
    assert not all(jck.pallas_select_ok(s.capacity, s.cand_cap, k)
                   for s in spec_j)
    state = from_reference_arrays(np.asarray(cj.points), len(pts),
                                  cell_size=cell, k=k, device="cpu")
    grid = build_grid(state.cloud.points, len(pts), state.cell_size)
    spec_t, _ = cellknn.probe_grid_buckets(grid, capacity_cap=256)
    assert [tuple(s) for s in spec_t] == [tuple(s) for s in spec_j]
    assert not all(cellknn.list_engine_ok(s.capacity, s.cand_cap, k)
                   for s in spec_t)
    engine, spec, _, factor = plan_engine(grid, k)
    assert engine == "moments" and state.bucket_spec == spec
    assert state.split_factor == factor > 1
    before = trace.counters().get("launches.pct_knn_moments", 0)
    _public_paths_agree(pts, k)
    # CPU tensors: no kernel
    assert trace.counters().get("launches.pct_knn_moments", 0) == before
