"""The port's library kNN against the JAX package, on the CPU.

(a) The rows and positions selects (plain versions) against the JAX
    Pallas kernels in interpret mode, on the tiles of
    tests/test_torch_select.py. Distances rtol 2e-6 (XLA may contract
    the JAX side's d² into FMAs, 1 ulp); winner sets equal on found
    slots, in order where every d² is exact; rows == cand[pos].
(b) The cell loop (``knn_cellwise_bucketed``, ``knn_cellwise``) against
    the JAX one with the Pallas select in interpret mode, on the same
    grid: ``exact`` equal row for row, ids equal on valid slots,
    distances rtol 2e-6.
(c) ``knn_cloud_grid`` against the JAX one (XLA expanded-form select on
    the CPU): every row exact after the repair, distances rtol 1e-5 /
    atol 1e-6, id sets equal wherever the kth neighbor is not nearly
    tied with the next.
(d) ``knn_grid`` and ``ball_grid`` against the JAX ones.
(e) Past the warp classes' 1024: k = 1024 and k = 1025 run and give the
    smallest usable distances (the selects take any k).
(f) ``lax.top_k``'s tie order: on an integer lattice, where every
    distance is exact in both packages and ties sit at the kth distance
    and among masked inf slots, ``knn_grid`` (rings 1 and 2),
    ``ball_grid``, ``knn_bruteforce`` and ``knn_cloud`` return the JAX
    package's indices in order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import pct_tpu.neighbors.cellknn as jck
from pct_tpu.core import from_numpy as jax_from_numpy
from pct_tpu.neighbors import knn_cloud_grid as jax_knn_cloud_grid
from pct_tpu.neighbors.bruteforce import knn_bruteforce as jax_knn_bruteforce
from pct_tpu.neighbors.bruteforce import knn_cloud as jax_knn_cloud
from pct_tpu.neighbors.grid import build_grid as jax_build_grid
from pct_tpu.neighbors.grid import estimate_cell_size as jax_cell_size
from pct_tpu.neighbors.knn import ball_grid as jax_ball_grid
from pct_tpu.neighbors.knn import knn_grid as jax_knn_grid
from pct_tpu.ops.pallas_select import knn_select as jax_select
from pct_tpu.ops.pallas_select import knn_select_coords as jax_select_coords
from pct_tpu.ops.pallas_select import knn_select_rows as jax_select_rows
from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.neighbors import (
    ball_grid,
    knn_bruteforce,
    knn_cloud,
    knn_cloud_grid,
    knn_grid,
)
from pct_tpu_torch.neighbors import cellknn
from pct_tpu_torch.neighbors.grid import build_grid
from pct_tpu_torch.ops.select import (
    knn_select,
    knn_select_coords,
    knn_select_rows,
    select_pos_plain,
    select_rows_plain,
)
from pct_tpu_torch.shapes import generate_shape
from tests.test_torch_cuda import tied_lattice
from tests.test_torch_select import _duplicate_tile, _random_tile, _sparse_tile


def _lattice_tile(seed=3, T=3, C=8):
    """Distinct candidates at exactly equal distance on a 1/8 lattice:
    every d² is exact with or without FMA contraction."""
    rng = np.random.default_rng(seed)
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    offs = np.concatenate([r * axes for r in (0.5, 0.75, 1.0, 2.0)])
    M = len(offs)
    q = np.repeat(rng.integers(-16, 16, (T, 1, 3)) / 8, C, axis=1)
    p = np.stack([q[t, 0] + offs[rng.permutation(M)] for t in range(T)])
    cand = np.tile(np.arange(100, 100 + M, dtype=np.int32), (T, 1))
    return (q.astype(np.float32), p.astype(np.float32), cand,
            np.full((T, C), -1, np.int32), np.ones((T, M), np.int32))


TILES = [(_random_tile, 5), (_random_tile, 20), (_duplicate_tile, 7),
         (_sparse_tile, 6), (_lattice_tile, 16)]
TILE_IDS = ["random_k5", "random_k20", "duplicates", "fewer_than_k",
            "lattice_ties"]


@pytest.mark.parametrize("want", ["rows", "pos"])
@pytest.mark.parametrize("make,k", TILES, ids=TILE_IDS)
def test_select_rows_and_pos_match_pallas_interpret(make, k, want):
    tile = make(7) if make is not _lattice_tile else make()
    jfn, tfn = ((jax_select_rows, select_rows_plain) if want == "rows"
                else (jax_select, select_pos_plain))
    dj, wj = (np.asarray(a) for a in jfn(
        *(jnp.asarray(a) for a in tile), k, interpret=True))
    dt, wt = (a.numpy() for a in tfn(*(torch.from_numpy(a) for a in tile),
                                     k))
    assert wt.dtype == np.int32
    found = dt < 1e18
    np.testing.assert_array_equal(found, dj < 1e18)
    np.testing.assert_allclose(dt[found], dj[found], rtol=2e-6, atol=0)
    for t in range(dt.shape[0]):
        for c in range(dt.shape[1]):
            f = found[t, c]
            np.testing.assert_array_equal(np.sort(wt[t, c][f]),
                                          np.sort(wj[t, c][f]))
    if make is _lattice_tile:       # exact d²: same winners in order
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(wt, wj)
    cand = tile[2]
    miss = ~found
    want_miss = cand[:, :1, None] if want == "rows" else 0
    np.testing.assert_array_equal(
        wt[miss], np.broadcast_to(want_miss, wt.shape)[miss])
    # rows == cand[pos], and the coords select picks the same winners
    ops = [torch.from_numpy(a) for a in tile]
    dr, rows = knn_select_rows(*ops, k)
    dp, pos = knn_select(*ops, k)
    dc, nbrs = knn_select_coords(*ops, k)
    assert torch.equal(dr, dp) and torch.equal(dr, dc)
    T, C, _ = pos.shape
    assert torch.equal(rows, torch.gather(
        ops[2], 1, pos.reshape(T, -1).long()).reshape(T, C, k))
    assert torch.equal(nbrs, torch.gather(
        ops[1], 1, pos.reshape(T, -1, 1).long().expand(-1, -1, 3)
    ).reshape(T, C, k, 3))


def _torus_blob():
    """tests/test_neighbors.py's torus + dense-blob cloud: several
    occupancy buckets, and blob cells beyond the capacity cap (333
    points), whose rows stay uncertified. The torus is perturbed: its
    lattice has exactly symmetric neighbors whose float32 distances tie
    to the last ulp, and the JAX side's FMA contraction then swaps their
    order; the blob is 0.04 wide (not 0.05) so that the perturbed
    torus's cell size still overfills its cells."""
    rng = np.random.default_rng(9)
    a = generate_shape("torus", 3000, perturbation_strength=1e-3, seed=1)[1]
    b = rng.standard_normal((1000, 3)).astype(np.float32) * 0.04
    return np.concatenate([a, b]).astype(np.float32)


K_CELL = 12


@pytest.fixture(scope="module")
def cell_grids():
    """The same grid in both packages (the JAX cell size, bit for bit)."""
    pts = _torus_blob()
    cj = jax_from_numpy(pts)
    cell = jax_cell_size(cj.points, cj.num_points, K_CELL)
    gj = jax_build_grid(cj.points, cj.num_points, cell)
    gt = build_grid(torch.from_numpy(np.array(cj.points)), len(pts),
                    torch.tensor(np.float32(cell)))
    np.testing.assert_array_equal(gt.order.numpy(), np.asarray(gj.order))
    return len(pts), gj, gt


@pytest.fixture(scope="module")
def jax_cell_results(cell_grids):
    """The JAX cell loops, Pallas select in interpret mode: (bucketed
    spec, max_cells, result; one-bucket probe, result)."""
    _, gj, _ = cell_grids
    spec, mc = jck.probe_grid_buckets(gj)
    rb = jck.knn_cellwise_bucketed(gj, jck.compact_cells(gj, mc), K_CELL,
                                   tuple(spec),
                                   select_impl="pallas_interpret")
    probe = jck.probe_grid(gj)
    cells, cap, _, rc = probe
    r1 = jck.knn_cellwise(gj, cells, K_CELL, capacity=cap, cand_cap=rc,
                          select_impl="pallas_interpret")
    return spec, mc, rb, probe[1:], r1


def _compare_cell_results(n, rj, rt, lean=False, order=None):
    """``rj`` a full JAX result with original ids; ``lean``: ``rt`` keeps
    only the kth distance; ``order``: ``rt`` carries sorted rows."""
    e_j, e_t = np.asarray(rj.exact)[:n], rt.exact[:n].numpy()
    np.testing.assert_array_equal(e_t, e_j)
    assert 0.9 < e_t.mean() < 1.0       # the blob's overfull cells
    idx_j, idx_t = np.asarray(rj.indices)[:n], rt.indices[:n].numpy()
    if order is not None:
        idx_t = order[idx_t]
    d_j, d_t = np.asarray(rj.dists)[:n], rt.dists[:n].numpy()
    if lean:        # the JAX lean result is the kth column of the full one
        assert rt.valid is None and d_t.shape == (n, 1)
        d_j = np.where(e_j | np.asarray(rj.valid)[:n, -1], d_j[:, -1], 0.0)
        np.testing.assert_allclose(d_t[:, 0], d_j, rtol=2e-6, atol=0)
        np.testing.assert_array_equal(idx_t[e_t], idx_j[e_j])
        return
    np.testing.assert_allclose(d_t, d_j, rtol=2e-6, atol=0)
    v_j, v_t = np.asarray(rj.valid)[:n], rt.valid[:n].numpy()
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(idx_t[v_t], idx_j[v_j])


@pytest.mark.parametrize("lean,original_ids", [
    (False, True), (True, True), (False, False)],
    ids=["full", "lean", "sorted_rows"])
def test_knn_cellwise_bucketed_matches_jax(cell_grids, jax_cell_results,
                                           lean, original_ids):
    n, _, gt = cell_grids
    spec_j, mc_j, rj = jax_cell_results[:3]
    spec_t, mc_t = cellknn.probe_grid_buckets(gt)
    assert len(spec_t) > 1
    assert [tuple(s) for s in spec_t] == [tuple(s) for s in spec_j]
    assert mc_t == mc_j
    rt = cellknn.knn_cellwise_bucketed(gt, cellknn.compact_cells(gt, mc_t),
                                       K_CELL, spec_t,
                                       original_ids=original_ids, lean=lean)
    order = None if original_ids else gt.order.numpy()
    _compare_cell_results(n, rj, rt, lean=lean, order=order)


def test_knn_cellwise_matches_jax(cell_grids, jax_cell_results):
    """The one-bucket loop against the JAX un-bucketed loop, and against
    the bucketed one: the same winners and certificates."""
    n, _, gt = cell_grids
    probe_j, rj = jax_cell_results[3:]
    cells_t, cap_t, mc_t, rc_t = cellknn.probe_grid(gt)
    assert (cap_t, mc_t, rc_t) == tuple(probe_j)
    rt = cellknn.knn_cellwise(gt, cells_t, K_CELL, capacity=cap_t,
                              cand_cap=rc_t)
    _compare_cell_results(n, rj, rt)
    spec_t, mc_b = cellknn.probe_grid_buckets(gt)
    rb = cellknn.knn_cellwise_bucketed(gt, cellknn.compact_cells(gt, mc_b),
                                       K_CELL, spec_t)
    assert torch.equal(rb.exact, rt.exact) and torch.equal(rb.valid, rt.valid)
    assert torch.equal(rb.indices[rt.valid], rt.indices[rt.valid])


def _two_density():
    """tests/test_neighbors.py's two clusters at densities 100x apart."""
    rng = np.random.default_rng(1234)
    a = rng.standard_normal((3000, 3)).astype(np.float32) * 0.01
    b = rng.standard_normal((1000, 3)).astype(np.float32) * 1.0 + 5.0
    return np.concatenate([a, b])


@pytest.mark.parametrize("cloud_name,k", [
    ("torus", 20), ("torus_blob", 12), ("two_density", 8)])
def test_knn_cloud_grid_matches_jax(cloud_name, k):
    """Every row exact after the repair in both packages, the grid
    certifying the same rows. Distances: the port's grid rows use the
    exact difference form and are held to the float64 truth with rtol
    1e-5 / atol 1e-6. The JAX package's XLA select on the CPU expands
    |q−c|²+|p−c|²−2(q−c)·(p−c) around the cell corner c, and the
    brute-force repair of both packages expands around the origin: each
    is held to its own rounding bound in d², 32·2⁻²⁴·15·cell² for the
    cell-local form (|q−c|²+|p−c|² ≤ 15 cells²; 21 measured on the dense
    blob) and 8·2⁻²⁴·(|q|²+|p|²) for the brute force (below 4 measured in
    the far cluster of the two-density cloud, ~5e-3 relative there). Id
    sets agree wherever the kth and (k+1)th true distances are apart by
    more than those errors."""
    pts = {"two_density": _two_density, "torus_blob": _torus_blob,
           "torus": lambda: generate_shape(
               "torus", 3000, perturbation_strength=1e-3, seed=1)[1]
           }[cloud_name]()
    n = len(pts)
    cj = jax_from_numpy(pts)
    rj, _ = jax_knn_cloud_grid(cj, k)
    raw_j, _ = jax_knn_cloud_grid(cj, k, exact_fallback=False)
    cloud = from_numpy(pts, device="cpu")
    rt, grid = knn_cloud_grid(cloud, k, device="cpu")
    raw_t, _ = knn_cloud_grid(cloud, k, exact_fallback=False, device="cpu")
    grid_ok = raw_t.exact[:n].numpy()
    np.testing.assert_array_equal(grid_ok, np.asarray(raw_j.exact)[:n])
    assert rt.exact[:n].all() and np.asarray(rj.exact)[:n].all()
    assert rt.valid[:n].all()
    P = pts.astype(np.float64)
    d_true, i_true = cKDTree(P).query(P, k + 2)
    d_true, i_true = d_true[:, 1:], i_true[:, 1:]       # drop self
    d_t = rt.dists[:n].numpy().astype(np.float64)
    d_j = np.asarray(rj.dists)[:n].astype(np.float64)
    np.testing.assert_allclose(d_t[grid_ok], d_true[grid_ok, :k], rtol=1e-5,
                               atol=1e-6)
    cell_bound = 32 * 2.0**-24 * 15 * float(grid.cell_size) ** 2
    assert (np.abs(d_j ** 2 - d_t ** 2)[grid_ok] <= cell_bound).all()
    sq = np.sum(P * P, axis=1)
    bound = 8 * 2.0**-24 * (sq[:, None] + sq[i_true[:, :k]])
    for d in (d_t, d_j):
        err = np.abs(d ** 2 - d_true[:, :k] ** 2)
        assert (err[~grid_ok] <= bound[~grid_ok]).all()
    gap = d_true[:, k] ** 2 - d_true[:, k - 1] ** 2
    untied = gap > 1e-4 * d_true[:, k] ** 2 + 2 * np.where(
        grid_ok, cell_bound, bound[:, -1])
    assert untied.mean() > 0.8
    same = (np.sort(rt.indices[:n].numpy(), 1)
            == np.sort(np.asarray(rj.indices)[:n], 1)).all(1)
    assert same[untied].all()
    # the repair: none on the torus, a few rows of the blob (brute force
    # on those queries), most of the two-density cloud (the whole cloud)
    repaired = 1.0 - grid_ok.mean()
    assert {"torus": repaired == 0, "torus_blob": 0 < repaired < 0.5,
            "two_density": repaired > 0.5}[cloud_name]


def test_knn_cloud_grid_capacity_and_rings_routes():
    pts = generate_shape("torus", 3000, perturbation_strength=1e-3,
                         seed=1)[1]
    n = len(pts)
    cloud = from_numpy(pts, device="cpu")
    base, _ = knn_cloud_grid(cloud, 10, device="cpu")
    for kw in ({"capacity": 64}, {"rings": 2}):
        r, _ = knn_cloud_grid(cloud, 10, device="cpu", **kw)
        assert r.exact[:n].all()
        np.testing.assert_allclose(r.dists[:n].numpy(),
                                   base.dists[:n].numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def query_grids():
    pts = generate_shape("torus", 3000, perturbation_strength=1e-3,
                         seed=1)[1]
    cj = jax_from_numpy(pts)
    cell = jax_cell_size(cj.points, cj.num_points, 10)
    gj = jax_build_grid(cj.points, cj.num_points, cell)
    gt = build_grid(torch.from_numpy(np.array(cj.points)), len(pts),
                    torch.tensor(np.float32(cell)))
    q = np.array(gj.sorted_points)[:700]
    qi = np.array(gj.order)[:700]
    return gj, gt, q, qi


@pytest.mark.parametrize("rings", [1, 2])
def test_knn_grid_matches_jax(query_grids, rings):
    gj, gt, q, qi = query_grids
    rj = jax_knn_grid(gj, jnp.asarray(q), 10, query_indices=jnp.asarray(qi),
                      capacity=32, rings=rings, tile=256)
    rt = knn_grid(gt, torch.from_numpy(q), 10,
                  query_indices=torch.from_numpy(qi), capacity=32,
                  rings=rings, tile=256)
    np.testing.assert_array_equal(rt.exact.numpy(), np.asarray(rj.exact))
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    np.testing.assert_allclose(rt.dists.numpy(), np.asarray(rj.dists),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(rt.indices.numpy(), np.asarray(rj.indices))
    assert rt.exact.float().mean() > 0.9


def test_ball_grid_matches_jax(query_grids):
    gj, gt, q, qi = query_grids
    radius = 2.0 * float(gt.cell_size) / 3.0
    rj = jax_ball_grid(gj, jnp.asarray(q), radius, 24, capacity=32)
    rt = ball_grid(gt, torch.from_numpy(q), radius, 24, capacity=32)
    for name in ("valid", "exact", "indices"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)))
    assert rt.valid.any(1).all() and rt.exact.any()


@pytest.mark.parametrize("wrapper", [knn_select_coords, knn_select_rows,
                                     knn_select],
                         ids=["coords", "rows", "pos"])
def test_select_list_limit(wrapper):
    """1024 and 1025 neighbors (the warp classes' largest k and the block
    class's first) run on the CPU and give the k smallest usable distances
    in order (numpy, same float32 operations), and their winners: the
    positions, ids or coordinates of those slots (no ties here). Neither
    raises: the selects take any k."""
    q, p, cand, qrow, valid = _random_tile(4, T=2, C=4, M=1100)
    diff = q[:, :, None, :] - p[:, None, :, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]
    ok = (valid[:, None, :] != 0) & (cand[:, None, :] != qrow[:, :, None])
    masked = np.where(ok, d2, np.float32(3e38))
    order = np.argsort(masked, -1, kind="stable")
    for k in (1024, 1025):
        d, w = wrapper(*(torch.from_numpy(a)
                         for a in (q, p, cand, qrow, valid)), k)
        want = np.take_along_axis(masked, order, -1)[..., :k]
        # torch's square root on the CPU: numpy's differs in the last ulp
        np.testing.assert_array_equal(
            d.numpy(), torch.sqrt(torch.from_numpy(want)).numpy())
        found = want < 1e38
        pos = np.where(found, order[..., :k], 0)
        if wrapper is knn_select:
            np.testing.assert_array_equal(w.numpy(), pos)
        elif wrapper is knn_select_rows:
            np.testing.assert_array_equal(
                w.numpy(), np.take_along_axis(cand[:, None, :].repeat(4, 1),
                                              pos, -1))
        else:
            np.testing.assert_array_equal(
                w.numpy(), np.take_along_axis(p[:, None], pos[..., None],
                                              2))


def test_select_coords_k64_matches_pallas_interpret():
    """k = 64, past the old 63-neighbor list, on the coords route."""
    tile = _random_tile(5, T=3, C=8, M=96)
    dj, nj = (np.asarray(a) for a in jax_select_coords(
        *(jnp.asarray(a) for a in tile), 64, interpret=True))
    dt, nt = (a.numpy() for a in knn_select_coords(
        *(torch.from_numpy(a) for a in tile), 64))
    found = dt < 1e18
    np.testing.assert_array_equal(found, dj < 1e18)
    np.testing.assert_allclose(dt[found], dj[found], rtol=2e-6, atol=0)
    np.testing.assert_array_equal(np.sort(nt[found], 0), np.sort(nj[found], 0))


def _tie_case(case):
    """(JAX result, port result) of one query kind on ``tied_lattice``."""
    pts, n = tied_lattice()
    if case in ("knn_bruteforce", "knn_bruteforce_inf_slots"):
        k = 10 if case == "knn_bruteforce" else n + 2   # 3 inf slots
        return (jax_knn_bruteforce(jnp.asarray(pts), n, k),
                knn_bruteforce(torch.from_numpy(pts), n, k))
    if case == "knn_cloud":
        return (jax_knn_cloud(jax_from_numpy(pts[:n]), 14),
                knn_cloud(from_numpy(pts[:n], device="cpu"), 14))
    rings = 2 if case == "knn_grid_rings2" else 1
    cell = np.float32(2.0 / rings)
    gj = jax_build_grid(jnp.asarray(pts), n, jnp.asarray(cell))
    gt = build_grid(torch.from_numpy(pts), n, torch.tensor(cell))
    q, qi = np.array(gj.sorted_points)[:n], np.array(gj.order)[:n]
    if case == "ball_grid":
        return (jax_ball_grid(gj, jnp.asarray(q), 1.5, 24, capacity=16),
                ball_grid(gt, torch.from_numpy(q), 1.5, 24, capacity=16))
    kw = dict(capacity=16 // rings ** 3 + 1, rings=rings, tile=128)
    return (jax_knn_grid(gj, jnp.asarray(q), 10,
                         query_indices=jnp.asarray(qi), **kw),
            knn_grid(gt, torch.from_numpy(q), 10,
                     query_indices=torch.from_numpy(qi), **kw))


@pytest.mark.parametrize("case", [
    "knn_grid_rings1", "knn_grid_rings2", "ball_grid", "knn_bruteforce",
    "knn_bruteforce_inf_slots", "knn_cloud"])
def test_tie_order_matches_lax_top_k(case):
    rj, rt = _tie_case(case)
    idx_j, d_j = (np.asarray(a) for a in rj[:2])
    idx_t, d_t = (a.numpy() for a in rt[:2])
    # the same exact d²; XLA's float32 square root on the CPU can be 1 ulp
    # from the correctly rounded one
    np.testing.assert_allclose(d_t, d_j, rtol=2.4e-7, atol=0)
    k = d_j.shape[1]
    fin = np.isfinite(d_j)
    # ties at the kth distance and inf slots are both present
    assert (fin[:, k - 1] & (d_j[:, k - 1] == d_j[:, k - 2])).any() \
        or not fin.all()
    np.testing.assert_array_equal(idx_t, idx_j)
    if case.startswith("knn_grid") or case == "ball_grid":
        for name in ("valid", "exact"):
            np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                          np.asarray(getattr(rj, name)))
