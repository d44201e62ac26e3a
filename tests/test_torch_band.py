"""The port's band kNN (``pct_tpu_torch.experimental``) against the JAX
package's, on the CPU.

The setup is tests/test_pallas.py's band test: a 2500-point torus at
k=10 with blocks of 8 cells, plus the same torus under a seeded 1e-4
jitter for the order-sensitive checks. Both packages run on the same
padded cloud and the same float32 cell size. The JAX side runs its
Pallas kernel in interpret mode (one compile, ~9 s, per call; called
once per case in module-scoped fixtures).

Tolerances: distances rtol 1e-6, because XLA may contract the JAX side's
d² into FMAs (1 ulp of d²) while the port rounds every operation; the
coverage radius to 1 ulp (the JAX side may contract its window edges
too); ``exact`` and found slots equal. On the lattice torus
equal float32 distances can break differently, so winners compare as
sets on rows whose kth and (k+1)th true distances are apart; on the
jittered torus they compare in order.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import pct_tpu.neighbors.cellknn as jck
from pct_tpu.core import from_numpy as jax_from_numpy
from pct_tpu.experimental.band_knn import build_row_blocks as jax_row_blocks
from pct_tpu.experimental.band_knn import knn_cellwise_band as jax_band_knn
from pct_tpu.experimental.pallas_band import knn_band_select as jax_band_select
from pct_tpu.neighbors.grid import build_grid as jax_build_grid
from pct_tpu.neighbors.grid import estimate_cell_size as jax_cell_size
from pct_tpu.shapes import generate_shape
from pct_tpu_torch.experimental import (
    MAX_BAND,
    build_row_blocks,
    knn_band_select,
    knn_cellwise_band,
)
from pct_tpu_torch.experimental.band_knn import band_operands, default_band
from pct_tpu_torch.neighbors import cellknn
from pct_tpu_torch.neighbors.grid import build_grid

N, K, BC = 2500, 10, 8


def _cloud(name):
    pts, _ = generate_shape("torus", N, radius=1.0)
    if name == "jitter":
        rng = np.random.default_rng(11)
        pts = pts + np.float32(1e-4) * rng.standard_normal(
            pts.shape).astype(np.float32)
    return pts.astype(np.float32)


@functools.cache
def _setup(name):
    """Both packages' grid, cell table and row blocks on one cloud."""
    cj = jax_from_numpy(_cloud(name))
    cell = jax_cell_size(cj.points, cj.num_points, K)
    gj = jax_build_grid(cj.points, cj.num_points, cell)
    probe_j = jck.probe_grid(gj)
    gt = build_grid(torch.from_numpy(np.array(cj.points)), N,
                    torch.tensor(np.float32(cell)))
    probe_t = cellknn.probe_grid(gt)
    return types.SimpleNamespace(
        name=name, gj=gj, probe_j=probe_j, gt=gt, probe_t=probe_t,
        blocks=build_row_blocks(probe_t[0], BC))


@pytest.fixture(scope="module", params=["lattice", "jitter"])
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def jax_result(setup):
    """The JAX band kNN, Pallas kernel in interpret mode: the lean result
    on the lattice, the full one on the jittered cloud."""
    cells, cap = setup.probe_j[:2]
    return jax_band_knn(setup.gj, cells, jnp.asarray(setup.blocks), K, cap,
                        bc=BC, lean=setup.name == "lattice", interpret=True)


def test_probe_and_row_blocks_match_jax(setup):
    cells_j, *rest_j = setup.probe_j
    cells_t, *rest_t = setup.probe_t
    assert tuple(rest_t) == tuple(rest_j)
    for f in cells_t._fields:
        np.testing.assert_array_equal(getattr(cells_t, f).numpy(),
                                      np.asarray(getattr(cells_j, f)))
    want = jax_row_blocks(cells_j, BC)
    assert setup.blocks.dtype == np.int32
    np.testing.assert_array_equal(setup.blocks, want)


@pytest.mark.parametrize("cell_ids,block_cells", [
    ([], 8),                                   # no occupied cell
    ([5], 8),                                  # one cell
    (list(range(16)), 8),                      # one row, exact multiple
    ([1, 2, 3, 1024, 1025, 2048 + 7, 1 << 20, (1 << 20) + 3], 2),
    (list(range(9)) + [1024 * 3 + i for i in range(17)], 4),
])
def test_row_blocks_vectorised_equals_loop(cell_ids, block_cells):
    """The vectorised layout against the JAX package's row loop on cell
    tables with row breaks, ragged rows and no cells at all."""
    cid = np.full(32, 1 << 30, np.int32)
    cid[:len(cell_ids)] = cell_ids
    table = types.SimpleNamespace(cell_id=torch.from_numpy(cid),
                                  num_cells=torch.tensor(len(cell_ids)))
    got = build_row_blocks(table, block_cells)
    want = jax_row_blocks(types.SimpleNamespace(
        cell_id=cid, num_cells=np.int32(len(cell_ids))), block_cells)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _untied(gt, k):
    """Rows (sorted space) whose kth and (k+1)th float64 neighbor
    distances are more than 1e-6 apart, relatively."""
    P = gt.sorted_points[:N].numpy().astype(np.float64)
    d, _ = cKDTree(P).query(P, k + 2)
    return d[:, k + 1] - d[:, k] > 1e-6 * d[:, k]


def test_band_knn_matches_jax(setup, jax_result):
    cells, cap, _, cand_cap = setup.probe_t
    rj = jax_result
    lean = setup.name == "lattice"
    rt = knn_cellwise_band(setup.gt, cells, setup.blocks, K, cap, bc=BC,
                           lean=lean)
    e_t, e_j = rt.exact[:N].numpy(), np.asarray(rj.exact)[:N]
    np.testing.assert_array_equal(e_t, e_j)
    assert e_t.all()
    d_t, d_j = rt.dists[:N].numpy(), np.asarray(rj.dists)[:N]
    i_t, i_j = rt.indices[:N].numpy(), np.asarray(rj.indices)[:N]
    if lean:
        assert rt.valid is None and d_t.shape == (N, 1)
        np.testing.assert_allclose(d_t, d_j, rtol=1e-6, atol=0)
        untied = _untied(setup.gt, K)
        assert untied.mean() > 0.3
        np.testing.assert_array_equal(np.sort(i_t[untied], 1),
                                      np.sort(i_j[untied], 1))
    else:
        f_t, f_j = rt.valid[:N].numpy(), np.asarray(rj.valid)[:N]
        np.testing.assert_array_equal(f_t, f_j)
        np.testing.assert_allclose(d_t[f_t], d_j[f_j], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(i_t[f_t], i_j[f_j])     # in order
    # the port's rows path in sorted space: the same kth bits and winners
    full = knn_cellwise_band(setup.gt, cells, setup.blocks, K, cap, bc=BC,
                             lean=False)
    rows = cellknn.knn_cellwise(setup.gt, cells, K, capacity=cap,
                                cand_cap=cand_cap, original_ids=False)
    assert torch.equal(full.exact, rows.exact)
    assert torch.equal(full.dists, rows.dists)
    assert torch.equal(full.indices[:N], rows.indices[:N])
    # the lean result is the full one's kth column
    assert torch.equal(rt.indices, full.indices)
    assert torch.equal(rt.dists[:, -1], full.dists[:, -1])


def _under_k_block(ops):
    """The first block of ``ops`` again, its cells' runs cut to a few
    positions (fewer than K candidates for every query slot) and one
    cell with no run at all."""
    px, py, pz, bs, rs_rel, run_len, qpts, qbase, lo, hi = ops
    short = torch.clamp_max(run_len[:1], 1)
    short[:, 0] = 0
    return (px, py, pz, torch.cat([bs, bs[:1]]), torch.cat([rs_rel,
                                                             rs_rel[:1]]),
            torch.cat([run_len, short]), torch.cat([qpts, qpts[:1]]),
            torch.cat([qbase, qbase[:1]]), torch.cat([lo, lo[:1]]),
            torch.cat([hi, hi[:1]]))


def test_band_select_matches_jax_kernel():
    """The select itself on the port's operands of the jittered cloud
    plus an under-k block: rows in order, distances, coverage radii and
    the missing-slot contract (sqrt(3e38), row bs[b, 0])."""
    setup = _setup("jitter")
    cells, cap = setup.probe_t[:2]
    band = default_band(BC, cap)
    ops, _, counts, band_ok = band_operands(setup.gt, cells, setup.blocks,
                                            cap, BC, band)
    assert band_ok.all()
    ok_q = (torch.arange(cap) < counts[..., None]).reshape(-1)
    ops = _under_k_block(ops)
    dt, rt, ct = (a.numpy() for a in knn_band_select(
        *ops, k=K, bc=BC, cap=cap, band=band))
    # the JAX kernel DMAs a fixed 1024 rows a band: its planes need that pad
    planes = [jnp.asarray(np.pad(a.numpy(), (0, 1024))) for a in ops[:3]]
    dj, rj, cj = (np.asarray(a) for a in jax_band_select(
        *planes, *(jnp.asarray(a.numpy()) for a in ops[3:]), k=K, bc=BC,
        cap=cap, band=band, interpret=True))
    found = dt < 1e18
    np.testing.assert_array_equal(found, dj < 1e18)
    np.testing.assert_allclose(dt[found], dj[found], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_max_ulp(ct, cj, maxulp=1)
    q = BC * cap
    last = slice(dt.shape[0] - q, None)
    assert not found[last].all(1).any()                  # every slot under k
    np.testing.assert_array_equal(dt[last][~found[last]],
                                  np.float32(np.sqrt(np.float32(3e38))))
    assert (rt[last][~found[last]] == int(ops[3][-1, 0])).all()
    assert found[:-q][ok_q.numpy()].all()                # real blocks full


def test_band_select_counts_fill_padding_slots(setup):
    """``counts`` changes nothing on the computed slots and gives every
    padding slot the missing-slot fill (sqrt(3e38), row bs[b, 0]) in all
    k places, with its cover as computed: on the cloud's own counts (row
    blocks with padding cells), with one cell cut to one point and one
    made a padding cell."""
    cells, cap = setup.probe_t[:2]
    band = default_band(BC, cap)
    ops, _, counts, _ = band_operands(setup.gt, cells, setup.blocks, cap,
                                      BC, band)
    slot = torch.arange(cap)
    assert int(counts.sum()) == N
    assert (counts == 0).any() and (counts > 1).any()
    counts = counts.clone()
    real = (counts > 1).nonzero()
    counts[tuple(real[0])] = 1
    counts[tuple(real[-1])] = 0
    full = knn_band_select(*ops, k=K, bc=BC, cap=cap, band=band)
    got = knn_band_select(*ops, k=K, bc=BC, cap=cap, band=band,
                          counts=counts)
    pad = (slot >= counts[..., None]).reshape(-1)
    assert pad.any() and not pad.all()
    for a, b in zip(got[:2], full[:2]):
        assert torch.equal(a[~pad], b[~pad])
    assert torch.equal(got[2], full[2])
    assert (got[0][pad] == torch.sqrt(torch.tensor(3e38))).all()
    bs0 = ops[3][:, 0].repeat_interleave(BC * cap)
    assert torch.equal(got[1][pad], bs0[pad, None].expand(-1, K))
    one = (counts == 1).reshape(-1).repeat_interleave(cap) & ~pad
    assert one.sum() == (counts == 1).sum() and (got[0][one] < 1e18).all()


def numpy_band(ops, k, bc, cap, band):
    """The band select in numpy float32 (the module docstring's rule):
    each query slot's window sorted by (d², concatenated position),
    stably -> (dists (S,k) float32 through torch's square root, as the
    port takes it on the CPU, rows (S,k) int32)."""
    px, py, pz, bs, rs_rel, run_len, qpts, qrow_base = (
        a.numpy() for a in ops[:8])
    nb, npad, m = bs.shape[0], px.shape[0], 9 * band
    g = bs[:, :, None] + np.arange(band)                     # (nb, 9, band)
    gi = np.clip(g, 0, npad - 1)
    inside = (g >= 0) & (g < npad)
    c = [np.where(inside, a[gi], np.float32(0)).reshape(nb, 1, 1, m)
         for a in (px, py, pz)]
    q = qpts.reshape(nb, bc, cap, 3)
    dx, dy, dz = (q[..., a, None] - c[a] for a in range(3))
    d2 = (dx * dx + dy * dy) + dz * dz                       # (nb,bc,cap,m)
    p = np.arange(band)
    run = ((p >= rs_rel[..., None]) & (p < (rs_rel + run_len)[..., None]))
    qrow = qrow_base[..., None] + np.arange(cap)
    ok = (run.reshape(nb, bc, 1, m) & (g.reshape(nb, 1, 1, m)
                                       != qrow[..., None])
          & (d2 < np.float32(3e38)))
    masked = np.where(ok, d2, np.float32(3e38)).reshape(nb * bc * cap, m)
    order = np.argsort(masked, -1, kind="stable")[:, :k]
    want = np.full((len(masked), k), np.float32(3e38))
    want[:, :order.shape[1]] = np.take_along_axis(masked, order, -1)
    found = want < 1e38
    flat = np.repeat(g.reshape(nb, m), bc * cap, axis=0)
    rows = np.repeat(bs[:, :1], bc * cap, axis=0).repeat(k, 1)
    rows[:, :order.shape[1]] = np.where(
        found[:, :order.shape[1]], np.take_along_axis(flat, order, -1),
        rows[:, :order.shape[1]])
    return torch.sqrt(torch.from_numpy(want)).numpy(), rows.astype(np.int32)


@pytest.mark.parametrize("case", ["band", "k", "queries", "counts"])
def test_band_limits_raise(case):
    """A band past the JAX package's window and malformed counts raise,
    as in the JAX package. k = 1025 (past the warp classes) and bc·cap =
    1032 query slots a block (past the kernel's old 1024) run, as they do
    in the JAX package, and give the numpy sort of each slot's window."""
    pts = _cloud("jitter")
    gt = build_grid(torch.from_numpy(pts), N, torch.tensor(np.float32(0.2)))
    cells, cap, _, _ = cellknn.probe_grid(gt)
    blocks = build_row_blocks(cells, BC)
    if case == "band":
        with pytest.raises(ValueError, match="exceeds the kernel's window"):
            knn_cellwise_band(gt, cells, blocks, K, 128, bc=BC)
        assert default_band(BC, 128) > MAX_BAND
        return
    if case == "counts":
        ops = band_operands(gt, cells, blocks, cap, BC,
                            default_band(BC, cap))[0]
        nb = ops[3].shape[0]
        for bad in (torch.zeros((nb, BC), dtype=torch.int64),
                    torch.zeros((nb, BC + 1), dtype=torch.int32)):
            with pytest.raises(ValueError, match="counts must be"):
                knn_band_select(*ops, k=K, bc=BC, cap=cap,
                                band=default_band(BC, cap), counts=bad)
        return
    k, cap = (1025, cap) if case == "k" else (K, 129)
    band = default_band(BC, cap) if case == "k" else MAX_BAND
    ops = band_operands(gt, cells, blocks[:16 * BC], cap, BC, band)[0]
    if case == "queries":
        assert BC * cap > 1024
    d, r, _ = knn_band_select(*ops, k=k, bc=BC, cap=cap, band=band)
    want_d, want_r = numpy_band(ops, k, BC, cap, band)
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(r.numpy(), want_r)
    assert (d < 1e18).any()
