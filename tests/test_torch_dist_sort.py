"""The port's distributed sample-sort grid build
(``pct_tpu_torch.distributed.sort``) on two and four gloo ranks.

The contract: the gathered slabs of ``build_grid_distributed`` are the
port's replicated ``build_grid`` bit for bit (same stable tie order,
same padding layout), a starved exchange capacity is certified through
``ok``, the slab path on the distributed sort is bit-identical to the
slab path on the replicated sort, and the result is the JAX package's
``build_grid_distributed`` on its 4-device CPU mesh.

Each world size runs in one ``torch.multiprocessing.spawn`` of gloo
ranks (module-level rank bodies, a file store in a temporary directory,
one thread a rank); rank 0 writes the outputs to an .npz. No JAX at
module level: a spawned rank imports only torch, numpy and the port.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.distributed import (
    build_grid_distributed,
    make_mesh,
    slab_curvature_unsorted,
)
from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
from pct_tpu_torch.shapes import generate_shape

N = 4096
CASES = ("torus", "padded", "skewed", "giant_tie")
FIELDS = ("sorted_ids", "order", "sorted_points")


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


def _cloud(pts):
    return from_numpy(pts, pad_multiple=N, device="cpu")


def _gathered(mesh, pts, cell, prefix, **kw):
    """This world's distributed grid, slabs gathered in rank order."""
    c = _cloud(pts)
    grid, ok = build_grid_distributed(mesh, c.points, c.num_points,
                                      torch.tensor(cell), **kw)
    out = {f"{prefix}ok": ok.numpy(),
           f"{prefix}geometry": np.array([*grid.origin.tolist(),
                                          float(grid.cell_size),
                                          *grid.dims])}
    for name in FIELDS:
        a = getattr(grid, name)
        parts = [torch.empty_like(a) for _ in range(mesh.size())]
        dist.all_gather(parts, a.contiguous())
        out[prefix + name] = torch.cat(parts).numpy()
    return out


def _body(mesh, clouds, slab_torus):
    out = {}
    for name, (pts, cell) in clouds.items():
        out.update(_gathered(mesh, pts, cell, f"{name}_"))
    if slab_torus is not None:
        pts, cell = clouds["sphere"]
        out["starved_ok"] = _gathered(mesh, pts, cell, "starved_",
                                      send_cap=8)["starved_ok"]
        for sort in (False, True):
            curv, nrm, ex = slab_curvature_unsorted(
                mesh, _cloud(slab_torus), k=12, halo=512,
                distributed_sort=sort)
            out[f"slab{int(sort)}_K"] = curv.K.numpy()
            out[f"slab{int(sort)}_normals"] = nrm.numpy()
            out[f"slab{int(sort)}_exact"] = ex.numpy()
    return out


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(12)
    torus, _ = generate_shape("torus", N, radius=1.0)
    sphere, _ = generate_shape("sphere", N, radius=1.0)
    dense = (rng.normal(size=(3072, 3)) * 0.05).astype(np.float32)
    sparse = rng.uniform(-3, 3, size=(1024, 3)).astype(np.float32)
    pts = {"torus": torus, "sphere": sphere,
           "padded": rng.normal(size=(3000, 3)).astype(np.float32),
           "skewed": np.concatenate([dense, sparse]),
           "giant_tie": np.zeros((N, 3), np.float32)}
    out = {}
    for name, p in pts.items():
        c = _cloud(p)
        k = 12 if name == "torus" else 8
        out[name] = (p, float(estimate_cell_size(c.points, c.num_points, k)))
    return out


@pytest.fixture(scope="module")
def worlds(clouds, tmp_path_factory):
    torus = clouds["torus"][0]
    return {2: _spawn(tmp_path_factory, 2, _body, clouds, None),
            4: _spawn(tmp_path_factory, 4, _body, clouds, torus)}


def _replicated(clouds, name):
    pts, cell = clouds[name]
    c = _cloud(pts)
    return build_grid(c.points, c.num_points, torch.tensor(cell))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_distributed_sort_bit_identical(clouds, worlds, world, case):
    out = worlds[world]
    ref = _replicated(clouds, case)
    if case == "padded":
        assert clouds[case][0].shape[0] < N
    assert bool(out[f"{case}_ok"])
    for name in FIELDS:
        a = getattr(ref, name).contiguous()
        if a.dtype == torch.float32:
            a = a.view(torch.int32)
        b = out[case + "_" + name]
        np.testing.assert_array_equal(
            b.view(np.int32) if b.dtype == np.float32 else b, a.numpy(),
            err_msg=name)
    np.testing.assert_array_equal(
        out[f"{case}_geometry"],
        [*ref.origin.tolist(), float(ref.cell_size), *ref.dims])


def test_distributed_sort_overflow_is_certified(worlds):
    assert not bool(worlds[4]["starved_ok"])


def test_slab_distributed_sort_matches_replicated(worlds):
    out = worlds[4]
    for name in ("K", "normals", "exact"):
        a, b = out[f"slab0_{name}"], out[f"slab1_{name}"]
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert out["slab1_exact"][:N].mean() > 0.5


def test_distributed_sort_matches_jax_mesh(clouds, worlds):
    """The JAX package's sample sort on its 4-device CPU mesh, same cloud
    and cell size: the same rows in the same places, bit for bit."""
    import jax.numpy as jnp

    from pct_tpu.core import from_numpy as jax_from_numpy
    from pct_tpu.distributed import build_grid_distributed as jax_build
    from pct_tpu.distributed import make_mesh as jax_make_mesh

    pts, cell = clouds["torus"]
    cj = jax_from_numpy(pts, pad_multiple=N)
    grid, ok = jax_build(jax_make_mesh(4), cj.points, cj.num_points,
                         jnp.float32(cell))
    assert bool(ok)
    out = worlds[4]
    for name in FIELDS:
        b = np.asarray(getattr(grid, name))
        a = out["torus_" + name]
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)
