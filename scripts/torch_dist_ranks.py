#!/usr/bin/env python3
"""The port's distributed layer on several ranks, one process a rank.

    python3 scripts/torch_dist_ranks.py --ranks 4            # 4 cards, NCCL
    python3 scripts/torch_dist_ranks.py --ranks 4 --device cpu --points 20000

Rank r runs on cuda:r (LOCAL_RANK=r; gloo ranks on the CPU with
``--device cpu``), joined through tcp://localhost:<a free port>. On the
torus of ``--points`` points (padded to a multiple of 1<<16 as
chip_smoke.py pads the 1M torus) every rank runs each path once cold
and three times warm, and rank 0 holds the result against its
single-device counterpart on its own device:

- ``sharded_curvature`` k=20 (list) and k=100 (moments) on
  ``plan_engine``'s layouts against ``fused_curvature`` on the same
  layout: the list engine bit-identical in every output; the moments
  engine's exact and kth bit-identical and K within 1e-4 of the median
  |K| (its epilogue runs on each rank's own rows, and the batched
  products of ``fit.moments`` round with the batch's shape: the JAX
  package's tests/test_distributed.py holds its mesh to the same);
  each rank's kernel launches;
- ``build_grid_distributed``: the gathered slabs bit-identical to
  ``build_grid``;
- ``slab_curvature_unsorted`` k=20 at the probed halo, with and without
  ``distributed_sort``: bit-identical to each other; against the
  un-bucketed ``fused_curvature`` on the same axis-permuted points and
  cell size, every certified row certified there too and K within rtol
  1e-5 and atol 1e-7 on the rows both certify (tests/test_slab.py's
  rule; bit-equal rows counted). Each rank's local cell table takes the
  JAX package's size rule, an average occupancy; a slab that holds more
  occupied cells drops them and its rows lose ``exact`` (printed).

Rank 0 prints each wall (median of the warm calls, between barriers)
beside the single-device one, the card's name and power limit, and one
JSON line last; any failed check raises, and the script exits non-zero.
"""

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

K_LIST, K_MOM = 20, 100


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def same_bits(a, b):
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


REPS = 3                # warm calls after the cold one


def walls(call, sync, reps=REPS):
    """(result, [cold, warm...] seconds) of an SPMD call, each between
    barriers so every rank's share is in the time."""
    import torch.distributed as dist

    out = []
    for _ in range(1 + reps):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        res = call()
        sync()
        dist.barrier()
        out.append(time.perf_counter() - t0)
    return res, out


def rank_main(rank, world, port, device, points):
    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            **({"device_id": torch.device("cuda", rank)}
                               if on_card else {}))
    try:
        _run(rank, world, device, points)
    finally:
        dist.destroy_process_group()


def _run(rank, world, device, points):
    import torch
    import torch.distributed as dist

    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.distributed import (
        build_grid_distributed,
        make_mesh,
        sharded_curvature,
        slab_curvature_unsorted,
    )
    from pct_tpu_torch.distributed.slab import best_axis_order
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.pipeline import fused_curvature
    from pct_tpu_torch.pipeline.fused import SPLIT_TO, plan_engine
    from pct_tpu_torch.shapes import generate_shape
    from pct_tpu_torch.utils import trace

    def launched(symbol):
        """This process's launches of kernel ``symbol`` so far."""
        return trace.counters().get("launches." + symbol, 0)

    mesh = make_mesh(world, device=device)
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(
        "cpu")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    pts, _ = generate_shape("torus", points, radius=1.0)
    cloud = from_numpy(pts, pad_multiple=1 << 16, device=dev)
    n = cloud.num_points
    log = print if rank == 0 else (lambda *a, **k: None)
    rec = {}

    for tag, k in (("sharded_k20", K_LIST), ("sharded_k100", K_MOM)):
        cell = estimate_cell_size(cloud.points, n, k)
        engine, spec, mc, factor = plan_engine(
            build_grid(cloud.points, n, cell), k)
        kw = dict(bucket_spec=spec, max_cells=mc, engine=engine,
                  split=(SPLIT_TO, factor))
        counter = ("pct_select_coords" if engine == "list"
                   else "pct_knn_moments")
        before = launched(counter)
        res, w = walls(lambda: sharded_curvature(mesh, cloud.points, n, cell,
                                                 k, **kw), sync)
        per_rank = [None] * world
        dist.all_gather_object(per_rank,
                               (launched(counter) - before) // (1 + REPS))
        single, w1 = walls(lambda: fused_curvature(cloud.points, n, cell, k,
                                                   device=dev, **kw), sync)
        outs = [*zip(("K", "H", "k1", "k2", "H2"), res.curv, single.curv),
                ("normals", res.normals, single.normals),
                ("exact", res.exact, single.exact),
                ("kth_dist", res.kth_dist, single.kth_dist)]
        differ = [name for name, a, b in outs if not same_bits(a, b)]
        K_s, K_1 = res.curv.K[:n], single.curv.K[:n]
        dK = float((K_s - K_1).abs().max() / K_1.abs().median())
        bit_rows = int((K_s.view(torch.int32) == K_1.view(torch.int32)).sum())
        if engine == "list":
            check(not differ, f"{tag}: {differ} bit-identical to "
                  "fused_curvature on the same layout")
        else:
            check(not {"exact", "kth_dist"} & set(differ),
                  f"{tag}: exact and kth bit-identical")
            check(dK < 1e-4, f"{tag}: K within 1e-4 of the median |K|")
        check(float(res.stats.nan_fraction) == 0.0, f"{tag}: no NaN")
        rec[tag] = dict(engine=engine, buckets=len(spec), launches=per_rank,
                        wall=statistics.median(w[1:]), cold=w[0],
                        single_wall=statistics.median(w1[1:]),
                        exact=float(res.exact[:n].float().mean()),
                        differing_outputs=differ, K_bit_equal_rows=bit_rows,
                        K_max_diff_over_median=dK)
        log(f"{tag}: {engine}, {len(spec)} buckets, launches a call by rank "
            f"{per_rank}; outputs not bit-identical to fused_curvature: "
            f"{differ or 'none'} (K bit-equal on {bit_rows} of {n} rows, max "
            f"|dK| / median |K| {dK:.3e}); wall {rec[tag]['wall']:.4f} s "
            f"(cold {w[0]:.3f} s), single device "
            f"{rec[tag]['single_wall']:.4f} s", flush=True)
        del res, single

    cell = estimate_cell_size(cloud.points, n, 12)
    dgrid, w = walls(lambda: build_grid_distributed(mesh, cloud.points, n,
                                                    cell), sync)
    ref, w1 = walls(lambda: build_grid(cloud.points, n, cell), sync)
    check(bool(dgrid.ok), "sort: ok")
    for name in ("sorted_ids", "order", "sorted_points"):
        a = getattr(dgrid.grid, name).contiguous()
        parts = [torch.empty_like(a) for _ in range(world)]
        dist.all_gather(parts, a)
        check(same_bits(torch.cat(parts), getattr(ref, name)),
              f"sort: {name} bit-identical to build_grid")
    rec["sort"] = dict(wall=statistics.median(w[1:]), cold=w[0],
                       single_wall=statistics.median(w1[1:]))
    log(f"sort: the gathered slabs bit-identical to build_grid; wall "
        f"{rec['sort']['wall']:.4f} s, build_grid "
        f"{rec['sort']['single_wall']:.4f} s", flush=True)
    del dgrid, ref

    slabs = {}
    for tag, kw in (("slab", {}), ("slab_sort", {"distributed_sort": True})):
        before = launched("pct_select_coords")
        slabs[tag], w = walls(lambda: slab_curvature_unsorted(
            mesh, cloud, K_LIST, **kw), sync)
        per_rank = [None] * world
        dist.all_gather_object(
            per_rank,
            (launched("pct_select_coords") - before) // (1 + REPS))
        rec[tag] = dict(wall=statistics.median(w[1:]), cold=w[0],
                        launches=per_rank)
    (c_r, n_r, e_r), (c_d, n_d, e_d) = slabs["slab"], slabs["slab_sort"]
    check(all(same_bits(a, b) for a, b in zip((*c_r, n_r, e_r),
                                              (*c_d, n_d, e_d))),
          "slab: the distributed sort's result bit-identical")
    order = best_axis_order(cloud.points, n)
    cell = estimate_cell_size(cloud.points, n, K_LIST)
    single, w1 = walls(lambda: fused_curvature(
        cloud.points[:, list(order)], n, cell, K_LIST, device=dev), sync)
    e_s, e_1 = e_r[:n], single.exact[:n]
    both = e_s & e_1
    K_s, K_1 = c_r.K[:n][both], single.curv.K[:n][both]
    close = torch.isclose(K_s, K_1, rtol=1e-5, atol=1e-7)
    bit_rows = int((K_s.view(torch.int32) == K_1.view(torch.int32)).sum())
    rec["slab"].update(exact=float(e_s.float().mean()),
                       exact_single=float(e_1.float().mean()),
                       single_wall=statistics.median(w1[1:]),
                       K_bit_equal_rows=bit_rows,
                       K_close_rows=int(close.sum()))
    log(f"slab: exact {rec['slab']['exact']} (un-bucketed fused_curvature "
        f"{rec['slab']['exact_single']}); on the {int(both.sum())} rows both "
        f"certify K bit-equal on {bit_rows}, within rtol 1e-5 atol 1e-7 on "
        f"{int(close.sum())}; walls "
        f"{rec['slab']['wall']:.4f} / {rec['slab_sort']['wall']:.4f} s "
        f"(sort), single device {rec['slab']['single_wall']:.4f} s; "
        f"launches a call by rank {rec['slab']['launches']}", flush=True)
    check(not bool((e_s & ~e_1).any()), "slab: every certified row is "
          "certified by the un-bucketed fused_curvature")
    check(bool(close.all()), "slab: K within rtol 1e-5, atol 1e-7 on the "
          "rows both certify")
    if rank == 0:
        print(json.dumps({"ranks": world, "device": device, "points": n,
                          **rec}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--points", type=int, default=1_000_000)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            raise SystemExit(f"{args.ranks} ranks need {args.ranks} cards; "
                             f"{torch.cuda.device_count()} visible")
        from pct_tpu_torch.ops import build

        build.build_all()          # once, before the ranks load it
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(rank_main, args=(args.ranks, port, args.device, args.points),
             nprocs=args.ranks)


if __name__ == "__main__":
    main()
