"""The port's query-sharded curvature (``pct_tpu_torch.distributed``) on
gloo ranks, against the port's single-device path, the analytic torus
and the JAX package's ``sharded_curvature`` on its 4-device CPU mesh.

Each world size runs in one ``torch.multiprocessing.spawn`` of gloo
ranks (module-level rank bodies, a file store in a temporary directory,
one thread a rank); rank 0 writes the replicated outputs to an .npz.
This module imports no JAX at module level, so a spawned rank imports
only torch, numpy and the port; the JAX reference runs in a fixture of
the test process. Tolerances are tests/test_torch_fused.py's.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.distributed import make_mesh, sharded_curvature
from pct_tpu_torch.neighbors.cellknn import probe_grid_buckets
from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
from pct_tpu_torch.pipeline import fused_curvature
from pct_tpu_torch.shapes import analytic_curvatures, generate_shape

N = 4096
K_LIST, K_MOM = 16, 64


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


def _arrays(res, prefix):
    return {f"{prefix}K": res.curv.K.numpy(), f"{prefix}H": res.curv.H.numpy(),
            f"{prefix}normals": res.normals.numpy(),
            f"{prefix}exact": res.exact.numpy(),
            f"{prefix}kth": res.kth_dist.numpy(),
            f"{prefix}stats": torch.stack(list(res.stats)).numpy()}


def _cloud(pts):
    return from_numpy(pts, pad_multiple=N, device="cpu")


def _body(mesh, pts, cell16, moments_layout):
    c = _cloud(pts)
    out = _arrays(sharded_curvature(mesh, c.points, c.num_points,
                                    torch.tensor(cell16), k=K_LIST), "list_")
    if moments_layout is not None:
        cell, spec, mc, factor = moments_layout
        out.update(_arrays(sharded_curvature(
            mesh, c.points, c.num_points, torch.tensor(cell), k=K_MOM,
            max_cells=mc, bucket_spec=spec, engine="moments",
            split=(128, factor)), "mom_"))
    return out


@pytest.fixture(scope="module")
def torus():
    pts, _ = generate_shape("torus", N, radius=1.0)
    c = _cloud(pts)
    cell16 = estimate_cell_size(c.points, c.num_points, K_LIST)
    single = fused_curvature(c.points, c.num_points, cell16, k=K_LIST,
                             device="cpu")
    cell = estimate_cell_size(c.points, c.num_points, K_MOM)
    spec, mc, factor = probe_grid_buckets(
        build_grid(c.points, c.num_points, cell),
        capacity_cap=max(256, 4 * K_MOM), split_to=128)
    single_mom = fused_curvature(c.points, c.num_points, cell, k=K_MOM,
                                 max_cells=mc, bucket_spec=spec,
                                 engine="moments", split=(128, factor),
                                 device="cpu")
    layout = (float(cell), spec, mc, factor)
    return pts, float(cell16), single, single_mom, layout


@pytest.fixture(scope="module")
def worlds(torus, tmp_path_factory):
    pts, cell16, _, _, layout = torus
    return {2: _spawn(tmp_path_factory, 2, _body, pts, cell16, None),
            4: _spawn(tmp_path_factory, 4, _body, pts, cell16, layout)}


@pytest.fixture(scope="module")
def jax_sharded(torus):
    """The JAX package's sharded_curvature on its 4-device CPU mesh, with
    the Pallas select in interpret mode and the port's cell size."""
    import jax.numpy as jnp

    from pct_tpu.core import from_numpy as jax_from_numpy
    from pct_tpu.distributed import make_mesh as jax_make_mesh
    from pct_tpu.distributed import sharded_curvature as jax_sharded_curvature

    pts, cell16 = torus[:2]
    cj = jax_from_numpy(pts, pad_multiple=N)
    res = jax_sharded_curvature(jax_make_mesh(4), cj.points, cj.num_points,
                                jnp.float32(cell16), k=K_LIST,
                                select_impl="pallas_interpret")
    return (np.asarray(res.exact), np.asarray(res.kth_dist),
            np.asarray(res.curv.K), np.asarray(res.curv.H),
            np.asarray(res.normals))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_curvature_matches_analytic(torus, worlds, world):
    pts = torus[0]
    out = worlds[world]
    Ka, _ = analytic_curvatures("torus", pts)
    strong = np.abs(Ka) > 0.5
    K = out["list_K"][:N]
    rel = np.abs(K[strong] - Ka[strong]) / np.abs(Ka[strong])
    assert np.median(rel) < 0.05
    mean_abs_K, _, nan_fraction = out["list_stats"]
    assert nan_fraction == 0.0
    assert mean_abs_K > 0.5
    assert out["list_exact"][:N].all()


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_matches_single_device_bit_for_bit(torus, worlds, world):
    single = torus[2]
    out = worlds[world]
    np.testing.assert_array_equal(out["list_exact"], single.exact.numpy())
    for key, ref in (("kth", single.kth_dist), ("K", single.curv.K),
                     ("H", single.curv.H), ("normals", single.normals)):
        assert np.array_equal(out[f"list_{key}"].view(np.int32),
                              ref.numpy().view(np.int32)), key


def test_sharded_moments_matches_single_device(torus, worlds):
    single = torus[3]
    out = worlds[4]
    np.testing.assert_array_equal(out["mom_exact"], single.exact.numpy())
    np.testing.assert_array_equal(out["mom_kth"].view(np.int32),
                                  single.kth_dist.numpy().view(np.int32))
    K_1 = single.curv.K.numpy()[:N]
    dn = np.abs(out["mom_K"][:N] - K_1) / np.median(np.abs(K_1))
    assert dn.max() < 1e-4
    assert out["mom_exact"][:N].all()
    mean_abs_K, _, nan_fraction = out["mom_stats"]
    assert nan_fraction == 0.0 and mean_abs_K > 0.5


def test_sharded_matches_jax_mesh(worlds, jax_sharded):
    e_j, kth_j, K_j, H_j, n_j = (a[:N] for a in jax_sharded)
    out = worlds[4]
    e = out["list_exact"][:N]
    np.testing.assert_array_equal(e, e_j)
    assert e.mean() > 0.99
    np.testing.assert_allclose(out["list_kth"][:N], kth_j, rtol=1e-6)
    np.testing.assert_allclose(out["list_K"][:N][e], K_j[e], rtol=0,
                               atol=1e-5 * np.abs(K_j[e]).max())
    np.testing.assert_allclose(out["list_H"][:N][e], H_j[e], rtol=0,
                               atol=1e-5 * np.abs(H_j[e]).max())
    nrm = out["list_normals"][:N]
    sign = np.sign(np.sum(nrm * n_j, axis=1))[:, None]
    np.testing.assert_allclose((nrm * sign)[e], n_j[e], rtol=0, atol=1e-5)


@pytest.fixture
def world_of_one():
    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_world_of_one_mesh_and_moments_rejects_implicit(torus, world_of_one):
    assert world_of_one.size() == 1
    assert world_of_one.mesh_dim_names == ("points",)
    c = _cloud(torus[0])
    with pytest.raises(ValueError, match="explicit"):
        sharded_curvature(world_of_one, c.points, c.num_points,
                          torch.tensor(torus[1]), k=K_LIST,
                          engine="moments", method="implicit")


def test_make_mesh_size_must_equal_the_world():
    with pytest.raises(ValueError, match="n_devices=2"):
        make_mesh(n_devices=2, device="cpu")
    assert not dist.is_initialized()


def test_make_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
    assert not dist.is_initialized()
