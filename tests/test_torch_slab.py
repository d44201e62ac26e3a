"""The port's slab path (``pct_tpu_torch.distributed.slab``) on four gloo
ranks: halo exchange, the id-range certificate and the probed halo,
against the port's single-device path, the analytic shapes and the JAX
package's ``slab_curvature_unsorted`` on its 4-device CPU mesh.

All cases run in one ``torch.multiprocessing.spawn`` of four gloo ranks
(module-level rank bodies, a file store in a temporary directory, one
thread a rank); rank 0 writes the outputs to an .npz. No JAX at module
level: a spawned rank imports only torch, numpy and the port.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.distributed import (
    make_mesh,
    slab_curvature,
    slab_curvature_unsorted,
)
from pct_tpu_torch.distributed.slab import best_axis_order, probe_slab_halo
from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
from pct_tpu_torch.pipeline import fused_curvature
from pct_tpu_torch.shapes import analytic_curvatures, generate_shape

N = 4096
N_PROBE = 8192         # the probed-halo cloud (the JAX test's: 65,536)
K = 12
WORLD = 4


def _rank(rank, world, tmp, body, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = body(make_mesh(world, device="cpu"), *args)
        if rank == 0:
            np.savez(f"{tmp}/out.npz", **out)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path_factory, world, body, *args):
    tmp = tmp_path_factory.mktemp(f"world{world}")
    mp.spawn(_rank, args=(world, str(tmp), body, args), nprocs=world)
    with np.load(tmp / "out.npz") as f:
        return dict(f)


def _cloud(pts, n=N):
    return from_numpy(pts, pad_multiple=n, device="cpu")


def _unsorted(prefix, curv, normals, exact):
    return {f"{prefix}K": curv.K.numpy(), f"{prefix}normals": normals.numpy(),
            f"{prefix}exact": exact.numpy()}


def _body(mesh, torus, sphere, probe_torus, perturbed, jax_cell):
    out = {}
    out.update(_unsorted("wide_", *slab_curvature_unsorted(
        mesh, _cloud(torus), k=K, halo=1000)))
    out.update(_unsorted("thin_", *slab_curvature_unsorted(
        mesh, _cloud(sphere), k=K, halo=16)))
    out.update(_unsorted("probed_", *slab_curvature_unsorted(
        mesh, _cloud(probe_torus, N_PROBE), k=K)))
    # the JAX comparison: the JAX package's cell size, its sorted order
    c = _cloud(perturbed)
    res = slab_curvature(mesh, c.points, c.num_points, torch.tensor(jax_cell),
                         k=K, halo=1000)
    rows = res.order.long()
    for name, a in (("K", res.curv.K), ("normals", res.normals),
                    ("exact", res.exact)):
        u = torch.zeros_like(a)
        u[rows] = a
        out[f"jaxcell_{name}"] = u.numpy()
    return out


@pytest.fixture(scope="module")
def clouds():
    """The analytic torus and sphere, the probed-halo torus, and the JAX
    comparison's perturbed torus: the lattice has exactly symmetric
    neighbors whose float32 distances tie to the last ulp, and 1-ulp
    differences between XLA's and PyTorch's arithmetic then swap their
    order and move the normals of nearly one-dimensional neighborhoods
    (tests/test_torch_fused.py perturbs its torus for the same reason)."""
    torus, _ = generate_shape("torus", N, radius=1.0)
    sphere, _ = generate_shape("sphere", N, radius=1.0)
    probe_torus, _ = generate_shape("torus", N_PROBE, radius=1.0)
    perturbed = generate_shape("torus", N, perturbation_strength=1e-3,
                               seed=1)[1]
    return torus, sphere, probe_torus, perturbed


@pytest.fixture(scope="module")
def jax_slab(clouds):
    """The JAX package's slab path on its 4-device CPU mesh (Pallas select
    in interpret mode), and its cell size for the port's run."""
    from pct_tpu.core import from_numpy as jax_from_numpy
    from pct_tpu.distributed import make_mesh as jax_make_mesh
    from pct_tpu.distributed import slab_curvature_unsorted as jax_unsorted
    from pct_tpu.neighbors.grid import estimate_cell_size as jax_cell_size

    cj = jax_from_numpy(clouds[3], pad_multiple=N)
    curv, normals, exact = jax_unsorted(jax_make_mesh(WORLD), cj, k=K,
                                        halo=1000,
                                        select_impl="pallas_interpret")
    cell = float(jax_cell_size(cj.points, cj.num_points, K))
    return cell, (np.asarray(curv.K)[:N], np.asarray(normals)[:N],
                  np.asarray(exact)[:N])


@pytest.fixture(scope="module")
def slabs(clouds, jax_slab, tmp_path_factory):
    return _spawn(tmp_path_factory, WORLD, _body, *clouds, jax_slab[0])


def _single(pts, n=N, axis_order=None):
    """The port's single-device un-bucketed fused path, on the columns in
    ``axis_order``, with the cell size of the unpermuted cloud."""
    c = _cloud(pts, n)
    cell = estimate_cell_size(c.points, c.num_points, K)
    p = c.points if axis_order is None else c.points[:, list(axis_order)]
    return fused_curvature(p, c.num_points, cell, k=K, device="cpu")


def test_slab_wide_halo_exact_and_accurate(clouds, slabs):
    e = slabs["wide_exact"][:N]
    K_ = slabs["wide_K"][:N]
    Ka, _ = analytic_curvatures("torus", clouds[0])
    assert e.mean() > 0.9
    ok = e & (np.abs(Ka) > 0.5)
    rel = np.abs(K_[ok] - Ka[ok]) / np.abs(Ka[ok])
    assert np.median(rel) < 0.06


def test_slab_certified_rows_match_single_device(clouds, slabs):
    single = _single(clouds[0])
    e = slabs["wide_exact"][:N] & single.exact.numpy()[:N]
    assert e.mean() > 0.9
    assert np.isclose(slabs["wide_K"][:N][e], single.curv.K.numpy()[:N][e],
                      rtol=1e-5, atol=1e-7).all()


def test_slab_certificate_catches_thin_halo(clouds, slabs):
    e = slabs["thin_exact"][:N]
    Ka, _ = analytic_curvatures("sphere", clouds[1])
    assert e.mean() < 1.0
    assert e.any()
    rel = np.abs(slabs["thin_K"][:N][e] - Ka[e]) / np.abs(Ka[e])
    assert np.median(rel) < 0.06


def test_probed_halo_fully_certifies(clouds, slabs):
    pts = clouds[2]
    n = N_PROBE
    e = slabs["probed_exact"][:n]
    assert e.mean() == 1.0
    c = _cloud(pts, n)
    order = best_axis_order(c.points, c.num_points)
    single = _single(pts, n, order)
    assert single.exact.numpy()[:n].mean() == 1.0
    K_sl = slabs["probed_K"][:n]
    assert np.isclose(K_sl, single.curv.K.numpy()[:n], rtol=1e-5,
                      atol=1e-7).all()
    Ka, _ = analytic_curvatures("torus", pts)
    strong = np.abs(Ka) > 0.5
    rel = np.abs(K_sl[strong] - Ka[strong]) / np.abs(Ka[strong])
    assert np.median(rel) < 0.06
    cell = estimate_cell_size(c.points, c.num_points, K)
    grid = build_grid(c.points[:, list(order)], c.num_points, cell)
    assert probe_slab_halo(grid, WORLD) < (n // WORLD) // 2


def test_slab_matches_jax_mesh(slabs, jax_slab):
    K_j, n_j, e_j = jax_slab[1]
    e = slabs["jaxcell_exact"][:N]
    np.testing.assert_array_equal(e, e_j)
    assert e.mean() > 0.9
    K_t = slabs["jaxcell_K"][:N]
    np.testing.assert_allclose(K_t[e], K_j[e], rtol=0,
                               atol=1e-5 * np.abs(K_j[e]).max())
    nrm = slabs["jaxcell_normals"][:N]
    sign = np.sign(np.sum(nrm * n_j, axis=1))[:, None]
    np.testing.assert_allclose((nrm * sign)[e], n_j[e], rtol=0, atol=1e-5)


@pytest.mark.parametrize("devices", [2, 4, 8, 512])
def test_axis_order_and_probed_halo_match_jax(clouds, devices):
    """Same cloud, same grid: the JAX package's best_axis_order and
    probe_slab_halo (or its refusal) and the port's agree."""
    import jax.numpy as jnp

    from pct_tpu.distributed.slab import best_axis_order as jax_axis_order
    from pct_tpu.distributed.slab import probe_slab_halo as jax_probe
    from pct_tpu.neighbors.grid import build_grid as jax_build_grid

    pts = clouds[2]
    c = _cloud(pts, N_PROBE)
    order = best_axis_order(c.points, c.num_points)
    assert order == jax_axis_order(jnp.asarray(c.points.numpy()),
                                   c.num_points)
    cell = estimate_cell_size(c.points, c.num_points, K)
    p = c.points[:, list(order)]
    grid = build_grid(p, c.num_points, cell)
    jgrid = jax_build_grid(jnp.asarray(p.numpy()), c.num_points,
                           jnp.float32(cell))
    np.testing.assert_array_equal(grid.sorted_ids.numpy(),
                                  np.asarray(jgrid.sorted_ids))
    try:
        want = jax_probe(jgrid, devices)
    except ValueError:
        with pytest.raises(ValueError, match="certified halo"):
            probe_slab_halo(grid, devices)
    else:
        assert probe_slab_halo(grid, devices) == want
