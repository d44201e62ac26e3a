"""Query-sharded fused curvature over a ``torch.distributed`` world.

Port of ``pct_tpu.distributed.sharding``. The JAX package runs one
program over a device mesh (``shard_map``); here every rank of a process
group runs the same function on its own device (SPMD), NCCL on the card
and gloo on the CPU. The decomposition is the JAX package's:

- the cloud is replicated and every rank builds the same grid and cell
  table (one sort each);
- the sharded work is the cell loop: each bucket's member table is
  padded with empty cells to a multiple of the world size and every rank
  runs its contiguous share of the rows, one kernel launch a bucket on
  the moments engine and one a chunk of it on the list engine
  (``cellknn.cellwise_bucket_rows(share=)``, the same per-bucket loop
  the single-device ``fused_curvature`` runs);
- the moments engine's epilogue runs on each rank's own rows;
- the global statistics reduce with one ``all_reduce``, and the flat
  rows come together with one ``all_gather`` before the replicated
  move to the caller's point order.

A rank computes exactly what the single-device path computes for the
same cells, so the outputs are the single-device outputs.

Divergences from the JAX package: ``make_mesh(n_devices)`` must equal
the world size (JAX takes a prefix of one process's devices; a process
group spans its processes), and ``sharded_curvature`` has no
``select_impl`` and no ``tile_cells`` (the port has one select; the
list engine runs a bucket in chunks of ``cellknn.list_select_cells``
cells, the moments engine in one launch).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from pct_tpu_torch.core.device import resolve_device
from pct_tpu_torch.curvature.explicit import Curvatures
from pct_tpu_torch.neighbors.cellknn import _scatter_outputs
from pct_tpu_torch.neighbors.grid import PAD_ID, build_grid
from pct_tpu_torch.pipeline.fused import _check_slice, _fused_rows, _layout

POINTS_AXIS = "points"


def P(*axes) -> list:
    """The DTensor placements of the JAX ``PartitionSpec(*axes)`` on a
    mesh from ``make_mesh``: dimension i sharded where ``axes[i]`` is
    ``POINTS_AXIS`` (``P(POINTS_AXIS)`` = rows split over the ranks),
    replicated otherwise (``P()``)."""
    for i, a in enumerate(axes):
        if a == POINTS_AXIS:
            return [Shard(i)]
    return [Replicate()]


def _local_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` on the card (``cuda:0``
    in a world of one), else the CPU. Raises RuntimeError for ``cuda``
    without a card."""
    if device_type == "cuda":
        return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    return resolve_device(device_type)


def make_mesh(n_devices: int | None = None,
              device: str | torch.device = "cuda") -> DeviceMesh:
    """A 1-D ``DeviceMesh`` named ``POINTS_AXIS`` over the world.

    When the default process group is already initialised (``torchrun``,
    or a caller's ``init_process_group``) the mesh spans it. Otherwise
    this initialises a world of one from an in-process ``HashStore``:
    NCCL on ``cuda`` (bound to ``cuda:0``), gloo on ``cpu``. ``device``
    defaults to ``cuda`` and raises RuntimeError without a card.
    ``n_devices`` must equal the world size (ValueError otherwise).
    """
    dev = _local_device(torch.device(device).type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"n_devices={n_devices} but the process group has {world} "
            "ranks; a mesh spans the whole world")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if dev.type == "cuda":
            dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                    world_size=1, device_id=dev)
        else:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
    return init_device_mesh(dev.type, (world,),
                            mesh_dim_names=(POINTS_AXIS,))


def _mesh_rank(mesh: DeviceMesh):
    """(process group, this rank's index, world size, device) of a mesh
    from ``make_mesh``."""
    return (mesh.get_group(POINTS_AXIS), mesh.get_local_rank(POINTS_AXIS),
            mesh.size(), _local_device(mesh.device_type))


def _words(*cols: torch.Tensor) -> torch.Tensor:
    """(rows, D) int32 slab of 32-bit columns (float32 bit patterns,
    int32, bool as 0/1), so one collective moves them all bit for bit."""
    out = []
    for c in cols:
        c = c.reshape(c.shape[0], -1)
        if c.dtype == torch.float32:
            c = c.view(torch.int32)
        out.append(c.to(torch.int32))
    return torch.cat(out, dim=1).contiguous()


def _share(args, n: int, rank: int, d: int):
    """This rank's share of a bucket's member table: the table padded
    with PAD cells (no queries, so no outputs) to a multiple of ``d``
    rows, then its rank-th contiguous block; every share has as many
    rows."""
    rows = args[0].shape[0]
    per = -(-rows // d)
    pad = per * d - rows
    if pad:
        fills = (PAD_ID, n, 0, 0, 0, False)
        args = tuple(torch.cat([a, a.new_full((pad,) + a.shape[1:], f)])
                     for a, f in zip(args, fills))
    return tuple(a[rank * per:(rank + 1) * per] for a in args)


class ShardedStats(NamedTuple):
    mean_abs_K: torch.Tensor     # global mean |K| over finite query rows
    mean_abs_H: torch.Tensor
    nan_fraction: torch.Tensor   # NaN K share (ref utils.py:524-533)


class ShardedResult(NamedTuple):
    curv: Curvatures          # per-point, caller's point order, every rank
    normals: torch.Tensor
    exact: torch.Tensor       # (N,) certified-exact kNN coverage per point
    kth_dist: torch.Tensor    # (N,) distance to the kth neighbor
    stats: ShardedStats


def sharded_curvature(mesh: DeviceMesh, points: torch.Tensor,
                      num_points: int, cell_size: torch.Tensor, k: int = 20,
                      *, capacity: int | None = None,
                      max_cells: int | None = None,
                      cand_cap: int | None = None, method: str = "explicit",
                      implicit_mode: str = "exact", bucket_spec=None,
                      engine: str = "list",
                      split: tuple | None = None) -> ShardedResult:
    """``fused_curvature`` with the cell loop sharded over ``mesh``.

    Call it on every rank with the same arguments (SPMD); every rank
    returns the whole result. The layout arguments are
    ``fused_curvature``'s: without ``bucket_spec`` one bucket takes every
    cell (``capacity``, ``cand_cap``); with one (``probe_grid_buckets``)
    pass its ``max_cells``. ``engine="moments"`` (explicit only) runs the
    moments engine and its epilogue on each rank's own rows;
    ``split=(cap, factor)`` virtual-splits the cells. ``exact`` is the
    per-point certificate; ``stats`` are the NaN-tolerant global means
    over finite query rows and the NaN share of K, reduced across ranks.
    """
    _check_slice(k, method, engine)
    group, rank, d, dev = _mesh_rank(mesh)
    n = points.shape[0]
    spec, max_cells = _layout(n, k, bucket_spec, max_cells, capacity,
                              cand_cap)
    grid = build_grid(points.to(dev), num_points, cell_size.to(dev))
    out, exact, kth, dest = _fused_rows(
        grid, k, max_cells, spec, engine, split, method, implicit_mode,
        share=lambda args: _share(args, n, rank, d))
    K, H = out[0], out[1]
    ok_q = dest < n
    finite = ok_q & torch.isfinite(K) & torch.isfinite(H)
    f32 = torch.float32
    sums = torch.stack([
        finite.sum(dtype=f32),
        torch.where(finite, K.abs(), 0.0).sum(),
        torch.where(finite, H.abs(), 0.0).sum(),
        ok_q.sum(dtype=f32),
        (ok_q & ~torch.isfinite(K)).sum(dtype=f32)])
    dist.all_reduce(sums, group=group)
    cnt = torch.clamp_min(sums[0], 1.0)
    stats = ShardedStats(sums[1] / cnt, sums[2] / cnt,
                         sums[4] / torch.clamp_min(sums[3], 1.0))

    # every rank's rows: K, H, k1, k2, H², normals (3), kth, exact, dest
    slab = DTensor.from_local(_words(*out, kth, exact, dest), mesh,
                              P(POINTS_AXIS)).full_tensor()
    f = slab[:, :9].contiguous().view(f32)
    (*curv, normals), exact_n, kth_n = _scatter_outputs(
        n, slab[:, 10], (*f[:, :5].unbind(1), f[:, 5:8]), slab[:, 9] > 0,
        f[:, 8])
    return ShardedResult(Curvatures(*curv), normals, exact_n, kth_n, stats)
