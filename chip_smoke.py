#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pct_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero
without printing its result line:

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the port from the checkout's sources
   (each ``csrc/*.cu`` library, its nvcc seconds and its kernels'
   registers, spills and stack from ``-Xptxas=-v`` printed);
3. the list engine, k=20, on the 1M-point torus (padded to 1<<16):
   a. the coords select kernel against its plain PyTorch version on
      every occupancy bucket of the main path: bit-identical; beside
      each bucket, the partial library yardstick (``torch.topk`` over
      int64 (d² bits << 32 | m) keys of the prebuilt masked d², whose
      winners' coordinates are the kernel's) and the first design's
      time;
   b. the main path, ``fast_curvature(k=20)``: launch counts (one
      ``list_fit`` launch a coords select), kNN certificate, NaNs, K against
      the analytic torus, kth distances against brute force on sampled
      rows; one more call with ``list_fit`` watched: every select's
      kernel output against ``list_fit_plain`` on the card, bit for bit,
      then timed beside the plain version and its bytes bound (12k + 44
      B a row); the sharded, slab, vertex and k=1100 list calls below
      hold the kernel to its plain version the same way (k=1100 on the
      first 2048 rows), and the implicit k=20 call launches it never;
   c. (run before b) the run table of that grid: ``_runs_table``'s run
      starts and lengths with the suffix-min kernel equal to those with
      ``suffix_min_plain`` on the card, the kernel's table bit-identical
      to the plain version's, then timed beside the plain version,
      ``torch.cummin`` and its bytes bound (8 B a box); every driven
      path below counts its launches, one of each pass a dense run table
      (two tables a cell-loop entry: the probe's and the cells');
4. the moments engine, k=100, on the same cloud:
   a. the moments kernel against its plain version on every bucket of
      ``fast_curvature``'s own probe: columns 35–45 bit-identical, the
      35 moment columns within count_le²·2⁻²⁴; beside each bucket, the
      partial library yardstick (``torch.kthvalue`` of the prebuilt
      masked d²: τ only) and the first design's time;
   b. the main path, ``fast_curvature(k=100)``, with the same checks
      and one epilogue launch a call;
   c. the epilogue kernel of that path: one more call with its
      ``moments_epilogue`` watched, the (rows, 8) output it returned
      against ``epilogue_plain`` on the card over the same stats, bit
      for bit on every column (padding rows included), then timed
      beside the plain version and its bytes bound (224 B a row);
   d. the virtual split on the card: ``fused_curvature(engine=
      "moments")`` with cells split to 64 queries a row against the
      unsplit layout;
5. library kNN, the staged pipeline and the implicit method, same cloud:
   a. the rows and positions kernels against their plain versions on
      every bucket of ``knn_cloud_grid(cloud, 20)``'s probe and of the
      unsplit k=100 probe, bit for bit, and rows = cand[pos]; beside
      each bucket, the partial library yardstick (``torch.topk`` over
      int64 (d² bits << 32 | m) keys of the prebuilt masked d², the same
      winners in the same order) and the first design's time;
   b. ``knn_cloud_grid(cloud, 20)``: launches, exact 1.0 after the
      repair, kth distance against brute force;
   c. ``curvature_pipeline(cloud, 20)`` against ``fast_curvature`` on
      certified rows;
   d. ``fast_curvature(method="implicit")`` at k=20 (the list engine)
      and k=100 (``knn_cloud_grid`` + ``pointwise_curvature``), against
      the analytic torus;
   e. the band kNN at k=20 on the whole cloud, at the smallest band
      (multiple of 128) that every row block fits (the exact fraction at
      the default band is printed): the band kernel against
      its plain version, bit for bit, with every slot computed
      (``counts=None``) and with the cells' counts (padding slots
      filled), each on every row block the plain version reaches within
      BAND_PLAIN_BUDGET_S (in a seeded random order); its times at the
      fitted and the default band beside the first design's;
      ``knn_cellwise_band`` against the port's rows path in
      sorted space (``knn_cellwise(original_ids=False)``): exact >=
      0.999, kth distances bit-equal and winner sets equal up to ties at
      the kth distance on rows both certify; 1 band launch a call;
   f. the neighbor study at its defaults, and ``pointwise_curvature``
      with an all-True mask (K as unmasked) and with the farthest half
      of every row masked (no NaN);
6. timings, each printed beside the card's name and power limit (after
   phases 7 to 12, which print their own);
7. the device half of the mesh path:
   a. ``estimate_and_orient_normals(cloud, k=50)`` on the same cloud
      (hierarchical): on every bucket of the layouts ``plan_normals``
      gives it, the moments kernel at k=50 (split probe) as in 4a, the
      rows kernel at kv=12 (voters) and at kc=16 (the one-bucket coarse
      graph) bit for bit; launches counted at each k against the plan's
      buckets (and one epilogue launch: the fit normals come from the
      moments route's epilogue), sign agreement with the analytic tube
      normal, unit length, no NaN;
   b. ``fast_curvature(k=20)`` on the vertices of a structured 1000 x
      1000 torus mesh (1M vertices, 2M faces): the coords kernel
      bit-identical to its plain version on every bucket, launches,
      exact, NaN and K error as in 3b;
   c. on that mesh: ``taubin_smooth`` x10 on the card against the CPU,
      ``mesh_energies`` with 7b's K and H against the analytic torus,
      ``voxel_downsample`` of the 1M cloud in both modes against the
      CPU; each timed;
8. the mesh path, ``create_mesh_with_curvature`` on the 1M torus at the
   reference's defaults (Taubin x10, both hole passes, adaptive radii):
   a. the BPA library built from the checkout's ``native/bpa.cpp`` into
      ``pct_tpu_torch/_build/`` (build seconds printed);
   b. one call: vertices, faces per vertex, boundary edges, NaN in K and
      H, normals' sign agreement with the tube normal, area, bending and
      stretching against the analytic torus, beside the JAX package's
      own 1M run;
   c. the stage timings, device stages against host stages;
   d. the launches of that call at each k (moments and one epilogue
      at k=50, rows at
      kv=12 and kc=16, coords at k=20 once a bucket of the smoothed
      vertices' layout), then the coords kernel bit-identical to its
      plain version on every bucket of that layout;
   e. the mesh written as binary PLY and read back equal;
9. the validation harness (``pct_tpu_torch.validate``) on the same 1M
   torus, each path driven with the counts set to 0 just before it:
   a. ``run_sweep`` of one row (torus, r=1, k=20) at the defaults, the
      mesh protocol with Taubin x10: status ok, no NaN, area, bending
      and stretching within phase 8's limits beside the JAX package's
      own 1M row, the row's points equal to phase 8's, its energies
      within 1e-3 of phase 8's (the stretching, a cancelling sum, within
      1e-3 of its mesh's sum |K|_f A_f), launches at each k as phase 8d
      counts them, the CSV read back under ``CSV_FIELDS``;
   b. ``validate_cloud(auto_k=True, use_mesh=False)`` at k=20: the study
      and the coords kernel (launches as phase 3b), the three integrals
      recomputed from a separate ``fast_curvature`` call within 1e-6;
   c. ``run_scans(repeat=2)`` at its defaults (k=100, outlier filter,
      study tolerance 1e-2) on the torus written as a points-only binary
      PLY: two ok rows with equal energies, the moments and epilogue
      kernels launched as in phase 4b each run;
10. the distributed layer (``pct_tpu_torch.distributed``) in a NCCL
    world of one on cuda:0 (``make_mesh()``; the process group is
    destroyed after the phase), same cloud, each path driven with the
    counts set to 0 just before it:
    a. ``sharded_curvature(k=20)`` on ``plan_engine``'s list layout:
       coords launches as phase 3b, every output bit-identical to
       ``fused_curvature`` on the same layout, the reduced stats (NaN
       0, mean |K| beside the result's), exact and K error as in 3b,
       the warm wall beside ``fused_curvature``'s on that layout and
       phase 3b's;
    b. the same at k=100 on the moments engine and its split layout:
       moments and epilogue launches as phase 4b, bit-identical, K error
       as in 4b;
    c. ``slab_curvature_unsorted(k=20)`` at the probed halo, then with
       ``distributed_sort=True``: bit-identical to each other, exact
       equal to the un-bucketed ``fused_curvature`` on the same
       axis-permuted points and cell size, K within rtol 1e-5 and atol
       1e-7 (bit-equal rows counted), one coords launch a call, the
       walls beside that ``fused_curvature``'s;
11. the TPU scripts' kernels (``pct_tpu_torch.micro``; no entry point
    launches them, and every main path above is checked to launch them
    0 times), each at its script's shapes:
    a. ``moments_variant``, every mode, on the three k=100 buckets of
       ``scripts/torch_micro_moments_split.py`` (its operand recipe):
       columns 35–47 bit-identical to the plain version and the sums
       within count_le²·2⁻²⁴ (all rows of the first bucket, the first
       MICRO_CUT_ROWS of the others), ``full`` against ``knn_moments``
       the same way, tb = 4, 8, 16 bit-identical to tb = 1; each mode's
       time, the production kernel's, the bound, the plain version's
       and ``torch.kthvalue`` (τ only); before them, for each mode and
       bucket, the kernel's path (bits a lane in registers, or in shared
       memory), its registers and spills from the build log and its
       blocks an SM (``variant_info``);
    b. ``select_coords_mxu`` at (8192, 128, 504), k=20: every output
       bit-identical to the plain version (missing slots: slot 0), the
       distances and found coordinates to ``knn_select_coords``; its
       time beside that select's, the bound (the extraction's product
       at the bf16 tensor-core peak), the plain version and the partial
       ``torch.topk`` yardstick; its first design's time in the log;
    c. ``moments_like`` at (8, 266, 1024): bit-identical to the plain
       version; one call's time (``ms``, as every kernel's) and its
       device time (``device_ms``: 20 calls queued behind a device
       sleep, so the wrapper's host time is not in it), each beside
       ``torch.bmm`` of the product alone (TF32 off) timed the same way
       (``library_ms``, ``library_device_ms``), the bound; its first
       design's time and the no-FMA ceiling (twice the bound, an FMUL
       and an FADD a multiply-add) in the log;
12. the reference-API façade, the command line and the demos
    (``pct_tpu_torch.compat``, ``cli``, ``demos``) on the same 1M torus,
    each path driven with the counts set to 0 just before it; neither
    ``viz`` nor matplotlib is imported (the card's machine has no
    matplotlib):
    a. ``compat.PointCloud(points, k_neighbors=20)`` on the card (its
       norms printed): ``plant_kdtree`` with the explicit chain (rows
       launches as phase 5b, indices and dists bit-identical to phase
       5b's ``knn_cloud_grid``, K, H and the fit normals bit-identical
       to phase 5c's ``curvature_pipeline``, no NaN, median K error <=
       1.5e-3); the implicit chain within phase 5d's k=20 limits; PCA at
       k=20 (k1 >= k2, no NaN); ``compute_normals(50)`` with its
       launches at k=50, kv=12 and kc=16 as phase 7a counts them (on
       the façade's cloud, whose padded capacity, and so its coarse
       stride, differs), bit-identical to phase 7a's
       ``estimate_and_orient_normals``; the PLY export read back equal;
       ``estimate_curvature`` at its default k=100 (rows launches on the
       k=100 layout, >= 0, no NaN); ``downsample=True`` keeping phase
       7c's rows;
    b. ``cli.main(["curvature", ...])`` in-process on the torus as a
       points-only binary PLY (rows launches as phase 5b; K and H read
       back equal to phase 5c's; the wall split into PLY read, compute
       and PLY write) and ``cli.main(["downsample", ...])`` (the rows
       written equal phase 7c's);
    c. both demos' ``run()`` on the card against ``run(device="cpu")``
       within 1e-5, with the JAX tests' sign and residual rules;
    each path's warm wall beside the card's name and power limit;
14. past 128 neighbors (the warp classes, k <= 1024), same cloud:
    a. the rows, positions and coords kernels against their plain
       versions, bit for bit, on every bucket of ``knn_cloud_grid(k)``'s
       probe at k = 129, 200 and 256 (past WIDE_PLAIN_BUDGET_S of
       plain-version time at 129 or 256, the later buckets' first
       WIDE_LATE_ROWS cell rows) and on the first WIDE_CUT_ROWS cell
       rows of each bucket at k = 512 and 1024; each bucket's layout (staged or streamed, shared bytes
       a block) logged; at k = 200 each bucket's kernel ms, plain ms,
       the partial ``torch.topk`` yardstick and the bound; the band
       kernel at k = 129 and 200 on phase 5e's operands, with every slot
       computed and with the counts, on the row blocks the plain version
       reaches in WIDE_BAND_PLAIN_S, and its time at k = 200;
    b. at k = 200, each driven with the counts set to 0 just before it:
       ``knn_cloud_grid`` (rows launches one a bucket, exact 1.0 after
       the repair, kth distance against brute force),
       ``fast_curvature(method="implicit")`` (the staged route: NaN 0,
       exact 1.0, median K error printed, kth distance knn_cloud_grid's),
       ``curvature_pipeline`` (neighbors bit-identical to
       ``knn_cloud_grid``'s, no NaN), ``compat.estimate_curvature(
       max_neighbors=200)`` (the surface variation of knn_cloud_grid's
       neighbors, bit for bit);
    c. ``knn_cloud_grid`` at k = 1024 once: ~8 GB of indices and
       distances, its exact fraction (1.0), wall and peak memory, kth
       distance against brute force;
15. past 1024 neighbors (the block class: a whole block a query slot),
    same cloud:
    a. the rows, positions and coords kernels against their plain
       versions, bit for bit, on the first HUGE_CUT_ROWS cell rows of
       each bucket of ``knn_cloud_grid(k)``'s probe at k = 1025, 1536,
       2048 and 4096, each bucket's layout logged; at k = 2048 each
       bucket's kernel ms on the whole bucket and on the compared rows,
       the plain version's and the partial ``torch.topk`` yardstick's ms
       on the compared rows, and the bound; past 16,384 winners a
       query, k = 20,000 on the k = 4096 probe's largest bucket cut to
       HUGE_CUT_ROWS cell rows and HUGE_SORT_QUERIES query slots (the
       device-memory sort); the band kernel at k = 1025 and 2048 on
       the first HUGE_BAND_BLOCKS row blocks of phase 5e's operands,
       with every slot computed and with the counts, and its time at
       k = 2048;
    b. ``knn_cloud_grid`` at k = 2048 once (~17 GB of indices and
       distances): rows launches one a bucket, exact 1.0, kth distance
       against brute force on sampled rows, wall and peak memory;
    c. at k = 1100, each driven with the counts set to 0 just before it
       and read just after: ``fast_curvature(method="implicit")`` (the
       staged route), ``curvature_pipeline``, ``compat.
       estimate_curvature(k_fraction=0.0011, max_neighbors=1100)`` (k =
       1100; the surface variation of knn_cloud_grid's neighbors, bit
       for bit) and ``fused_curvature(engine="list")`` on the implicit
       probe's buckets (coords launches one a bucket): NaN 0, median K
       errors printed; then explicit ``fast_curvature(2048)`` (the
       moments engine and one epilogue launch): NaN 0, exact and K
       error printed;
13. the kernel table (one JSON line, nine kernels, each with the card's
    name and power limit; each package kernel's ``mesh_path`` lists its
    records at phase 7's and phase 8's shapes, ``validation`` its
    launches in phase 9, ``distributed`` its launches in 10a-10c,
    ``compat`` its launches in phase 12; the coords, rows, positions and
    band kernels' ``k200`` their phase 14 numbers at k = 200 and
    ``k2048`` their phase 15 numbers at k = 2048; each script kernel
    names its ``script``) and the result line.

The script imports nothing of JAX or of the JAX package.
"""

import json
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

N_POINTS = 1_000_000
PAD_MULTIPLE = 1 << 16
K_LIST = 20                      # list engine (select kernel)
K_MOM = 100                      # moments engine (moments kernel)
FP32_PEAK = 67e12                # H100 SXM FP32 (non-tensor) FLOP/s
BF16_TC_PEAK = 989e12            # H100 SXM bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PAIR_FLOPS = 9                   # 3 sub, 3 mul, 2 add, 1 compare per pair
MEMBER_FLOPS = 70                # 35 mul + 35 add per weighted member
TIMED_REPS = 5
PLAIN_BUDGET_S = 60.0            # plain-version time for the k=100 rows check
CUT_ROWS = 4096                  # cell rows a bucket keeps past that budget
MICRO_CUT_ROWS = 1024            # rows of the 2nd/3rd script bucket held to
                                 # the variants' plain versions (phase 11a)
# The first designs' per-bucket ms on the same buckets of the 1M torus
# (PERF.md's tables: the one-thread-per-query list and bisection kernels,
# NVIDIA H100 80GB HBM3, 700 W; select_coords as the list kernel's own
# chip_smoke.py measured it on these buckets, beside the warp design).
FIRST_DESIGN_MS = {
    "select_coords": (4.710, 6.509, 2.181, 0.243),
    "select_rows k=20": (4.625, 6.468, 2.160, 0.234),
    "select_pos k=20": (4.680, 6.435, 2.141, 0.245),
    "select_rows k=100": (41.027, 69.422, 75.434, 106.951, 56.090, 41.825),
    "moments": (3.564, 7.456, 6.986, 11.210, 5.639, 3.821),
}
FIRST_DESIGN_CALL_MS = {"select_coords": (13.62, 13.904),
                        "select_rows k=20": (13.385, 13.487),
                        "select_pos k=20": (13.222, 13.501),
                        "select_rows k=100": (390.7, 391.2),
                        "moments": (38.68, 38.99)}
MISSING_D2 = 3.0e38
BAND_BC = 8                      # cells a row block of the band kNN
NINE_BANDS = 9                   # bands a row block's windows make
BAND_PLAIN_BUDGET_S = 30.0       # plain-version time for the band check
BAND_CHUNK_BLOCKS = 512          # row blocks a plain-version call
# the band kernel's first design (one thread a slot), ms per call at the
# fitted band 1024 and the default band 384 (PERF.md, NVIDIA H100 80GB
# HBM3, 700 W)
BAND_FIRST_DESIGN_MS = {1024: 37.771, 384: 19.381}
# the script kernels' first designs at their scripts' shapes, ms (PERF.md,
# NVIDIA H100 80GB HBM3, 700 W): the FP64 one-query-a-warp extraction and
# the 16-row SIMT tiles
EARLIER_MS = {"select_coords_mxu": 38.04, "moments_like": 0.209}
K_NORMALS = 50                   # estimate_and_orient_normals' default k
MESH_SIDE = 1000                 # (u, v) lattice of the structured torus mesh
VOXEL = 0.02                     # voxel edge of the downsample check
# the JAX package's own 1M torus under the mesh protocol
# (incremental_shape_comparison_results.csv, row "torus, Unperturbed"):
# area, bending and stretching against the analytic torus
JAX_MESH_TORUS = {"area_err": 0.11476384911336748e-2,
                  "bending_err": -6.738290212835834e-2,
                  "stretching": 0.14316698908805847}
DEVICE_STAGES = ("normals", "smooth", "curvature", "energies")
K_WIDE = 200                     # phase 14's entry points (past 128)
WIDE_KS = (129, K_WIDE, 256, 512, 1024)   # phase 14's kernel checks
WIDE_CUT_ROWS = 2                # cell rows a bucket compared at k > 256
WIDE_PLAIN_BUDGET_S = 60.0       # plain-version time a k, untimed k
WIDE_LATE_ROWS = 256             # cell rows a bucket compared past it
WIDE_BAND_PLAIN_S = 8.0          # band plain-version time a (k, mode)
K_HUGE = 1100                    # phase 15's entry points (past 1024)
K_HUGE_KNN = 2048                # knn_cloud_grid once, the timed kernels
HUGE_KS = (1025, 1536, K_HUGE_KNN, 4096)   # phase 15's kernel checks
HUGE_CUT_ROWS = 2                # cell rows a bucket compared past 1024
K_SORT = 20_000                  # past the block's 16,384 shared keys
HUGE_SORT_QUERIES = 16           # query slots a row at k = K_SORT
HUGE_BAND_BLOCKS = 2048          # row blocks of the band at k > 1024
HUGE_FIT_ROWS = 2048             # list_fit rows compared at k = 1100


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def ptxas_kernels(text):
    """Each kernel's ``-Xptxas=-v`` report in an nvcc log: a list of
    {name, registers, stack, spill_stores, spill_loads} (bytes)."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"name": m.group(1)}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m[1])
            rows.append(cur)
            cur = None
    return rows


def event_ms(fn, reps):
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps, calls=20, sleep_cycles=10_000_000):
    """Median device time of one ``fn()`` with the host's enqueue kept
    out: ``reps`` runs of ``calls`` back-to-back calls between CUDA
    events, each run queued behind a device sleep (~5 ms) that holds the
    card until every call is enqueued. For kernels of tens of µs, whose
    wrapper's host time ``event_ms`` would count."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def bound(pairs, flops_per_pair, extra_flops, nbytes, tc_flops=0):
    """(bound ms, what bounds it): the largest of the FP32 operations over
    the FP32 peak, the bf16 tensor-core operations ``tc_flops`` over
    theirs (the two units run side by side) and the bytes over the
    memory rate."""
    t_ops = max((pairs * flops_per_pair + extra_flops) / FP32_PEAK,
                tc_flops / BF16_TC_PEAK) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations")


def bucket_inputs(cellknn, grid, sp, args):
    """The kernel operands the main path builds for one bucket, and the
    valid query×candidate pairs its data needs."""
    import torch

    cand, ok_cand, cpts, qpts, qrow, ok_q = cellknn._tile_candidates(
        grid, args, sp.capacity, sp.cand_cap)[:6]
    count = args[2].to(torch.int64)
    tot = torch.clamp_max(args[4].sum(-1), sp.cand_cap).to(torch.int64)
    ops = (qpts, cpts, cand, qrow, ok_cand.to(torch.int32))
    return ops, ok_q, int((count * tot).sum())


def nbytes(*tensors):
    return sum(a.numel() * a.element_size() for a in tensors)


def masked_d2(ops):
    """The plain versions' masked (T,C,M) d² of one bucket's operands:
    difference form, 3e38 where the slot is unusable (valid is 0 or 1
    here, so the selects' valid != 0 and the moments' valid > 0 agree)."""
    import torch

    q, p, cand, qrow, valid = ops
    d = [q[:, :, None, a] - p[:, None, :, a] for a in range(3)]
    d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    del d
    ok = (valid[:, None, :] > 0) & (cand[:, None, :] != qrow[:, :, None])
    return torch.where(ok, d2, MISSING_D2)


def topk_yardstick(ops, k, d_k, won, emit=None):
    """The selects' partial library yardstick: one ``torch.topk`` over
    int64 keys (d² bits << 32 | m) of the prebuilt masked d², which
    returns the same winners in the same order. Checks ``emit`` of its
    winner positions (default: the positions themselves) against a
    kernel's output ``won`` on found slots; returns the call's median
    ms."""
    import torch

    d2 = masked_d2(ops)
    M = d2.shape[-1]
    key = d2.view(torch.int32).to(torch.int64)
    del d2
    key.bitwise_left_shift_(32).bitwise_or_(
        torch.arange(M, dtype=torch.int64, device=key.device))
    top = torch.topk(key, k, dim=-1, largest=False).values
    pos = top & 0xFFFFFFFF
    same = (pos if emit is None else emit(pos)) == won
    if same.dim() > d_k.dim():
        same = same.all(-1)
    check(bool(same[d_k < 1e18].all()),
          "torch.topk yardstick: the kernel's winners in the same order")
    ms = event_ms(lambda: torch.topk(key, k, dim=-1, largest=False), 3)
    del key, top
    return ms


def kthvalue_yardstick(ops, k, got):
    """The moments kernel's partial library yardstick: one
    ``torch.kthvalue`` of the prebuilt masked d² (τ only). Checks τ
    against the kernel's column 35 where at least k slots are usable;
    returns the call's median ms."""
    import torch

    d2 = masked_d2(ops)
    if d2.shape[-1] < k:
        return None
    tau = torch.kthvalue(d2, k, dim=-1).values
    full = ((d2 < MISSING_D2).sum(-1) >= k)
    check(bool((tau.view(torch.int32) == got[..., 35].contiguous()
                .view(torch.int32))[full].all()),
          "torch.kthvalue yardstick: the kernel's tau")
    ms = event_ms(lambda: torch.kthvalue(d2, k, dim=-1), 3)
    del d2, tau
    return ms


def select_vs_plain(cellknn, grid, cells, spec, k):
    import torch
    from pct_tpu_torch.ops.select import knn_select_coords, select_coords_plain

    rows = mismatched = 0
    max_err = 0.0
    per_bucket = []
    for b, (sp, args) in enumerate(cellknn.bucketed_tile_args(
            grid, cells, spec)):
        sel, _, pairs = bucket_inputs(cellknn, grid, sp, args)
        d_k, n_k = knn_select_coords(*sel, k)
        torch.cuda.synchronize()
        d_p, n_p = select_coords_plain(*sel, k)
        torch.cuda.synchronize()
        same = ((d_k.view(torch.int32) == d_p.view(torch.int32)).all(-1)
                & (n_k.view(torch.int32) == n_p.view(torch.int32))
                .all(-1).all(-1))
        rows += same.numel()
        mismatched += int((~same).sum())
        max_err = max(max_err, float((d_k - d_p).abs().max()),
                      float((n_k - n_p).abs().max()))
        T, C = sel[0].shape[:2]
        lib_ms = topk_yardstick(
            sel, k, d_k, n_k, lambda pos, sel=sel, T=T, C=C: torch.gather(
                sel[1], 1, pos.reshape(T, C * k, 1).expand(-1, -1, 3))
            .reshape(T, C, k, 3))
        nb = nbytes(*sel, d_k, n_k)
        b_ms, b_by = bound(pairs, PAIR_FLOPS, 0, nb)
        per_bucket.append(dict(
            bucket=b, cells=int((args[0] != cellknn.PAD_ID).sum()),
            capacity=sp.capacity, M=sel[1].shape[1], pairs=pairs, bytes=nb,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            ms=event_ms(lambda sel=sel: knn_select_coords(*sel, k),
                        TIMED_REPS),
            plain_ms=event_ms(lambda sel=sel: select_coords_plain(*sel, k),
                              3)))
        del d_k, n_k, d_p, n_p
    log(f"select_coords kernel vs plain: {rows} query rows compared, "
        f"{mismatched} mismatched, max abs err {max_err}")
    check(mismatched == 0 and max_err == 0.0,
          "select_coords kernel bit-identical to its plain version")
    return per_bucket, max_err


def moments_vs_plain(cellknn, grid, cells, spec, k):
    import torch
    from pct_tpu_torch.ops.moments import (
        knn_moments,
        moments_plain,
        stats_agreement,
    )

    rows = differing = 0
    max_err = max_ratio = 0.0
    per_bucket = []
    for b, (sp, args) in enumerate(cellknn.bucketed_tile_args(
            grid, cells, spec)):
        ops, ok_q, pairs = bucket_inputs(cellknn, grid, sp, args)
        got = knn_moments(*ops, k)
        torch.cuda.synchronize()
        want = moments_plain(*ops, k)
        torch.cuda.synchronize()
        d, ratio, err = stats_agreement(got, want)
        rows += ok_q.numel()
        differing += d
        max_err, max_ratio = max(max_err, err), max(max_ratio, ratio)
        check(bool((got[..., 46:] == 0).all()), "moments columns 46-47 are 0")
        # weighted members of the real query slots: w > 0 below tau, and
        # at tau when the tie weight is positive
        lt, le = want[..., 36], want[..., 37]
        members = int(torch.where(lt < k, le, lt)[ok_q].sum())
        lib_ms = kthvalue_yardstick(ops, k, got)
        nb = nbytes(*ops, got)
        b_ms, b_by = bound(pairs, PAIR_FLOPS, MEMBER_FLOPS * members, nb)
        per_bucket.append(dict(
            bucket=b, cells=int((args[0] != cellknn.PAD_ID).sum()),
            capacity=sp.capacity, M=ops[1].shape[1], pairs=pairs,
            members=members, bytes=nb, bound_ms=b_ms, bound_by=b_by,
            ratio=ratio, library_ms=lib_ms,
            ms=event_ms(lambda ops=ops: knn_moments(*ops, k), TIMED_REPS),
            plain_ms=event_ms(lambda ops=ops: moments_plain(*ops, k), 3)))
        log(f"  moments bucket {b}: C {sp.capacity}, M {ops[1].shape[1]}, "
            f"{per_bucket[-1]['cells']} cells, {pairs} pairs: {d} rows "
            f"differ, moment error ratio {ratio:.4g}")
        del got, want
    log(f"moments kernel vs plain: {rows} query rows compared, {differing} "
        f"with a column 35-47 differing, max moment error / "
        f"(count_le^2 2^-24) {max_ratio:.4g}, max abs err {max_err}")
    check(differing == 0, "moments columns 35-47 bit-identical")
    check(max_ratio <= 1.0, "moment columns within count_le^2 2^-24")
    return per_bucket, max_err, max_ratio


EPILOGUE_ROW_BYTES = 224         # a row's 48 float32 stats in, 8 out


def epilogue_vs_plain(cloud, k):
    """Phase 4c: one more ``fast_curvature(k)`` call with the fused
    route's ``moments_epilogue`` watched; the output the call got from
    the kernel against ``epilogue_plain`` on the card over the same
    stats, bit for bit on every column (float32 compared as int32, so
    the padding rows' NaNs count too). Then the kernel and the plain
    version timed on those stats. Returns the kernel's per-call record
    (one "bucket": the call's every row)."""
    import torch

    import pct_tpu_torch.pipeline.fused as fused
    from pct_tpu_torch.ops.epilogue import epilogue_plain

    seen = []
    real = fused.moments_epilogue

    def watched(stats):
        out = real(stats)
        seen.append((stats.clone(), out.clone()))
        return out

    fused.moments_epilogue = watched
    try:
        fused.fast_curvature(cloud, k)
        torch.cuda.synchronize()
    finally:
        fused.moments_epilogue = real
    check(len(seen) == 1, f"fast_curvature k={k}: one epilogue call, got "
          f"{len(seen)}")
    (stats, got), = seen
    want = epilogue_plain(stats)
    torch.cuda.synchronize()
    differing = (got.view(torch.int32) != want.view(torch.int32)).sum(0)
    rows = stats.shape[0]
    nan_rows = int(torch.isnan(want[:, 0]).sum())
    max_err = float((got - want).abs().nan_to_num(0.0).max())
    nb = rows * EPILOGUE_ROW_BYTES
    b_ms, b_by = bound(0, 0, 0, nb)
    rec = dict(bucket=0, cells=0, capacity=0, M=0, pairs=0, rows=rows,
               nan_rows=nan_rows, bytes=nb, bound_ms=b_ms, bound_by=b_by,
               library_ms=None,
               ms=event_ms(lambda: real(stats), TIMED_REPS),
               plain_ms=event_ms(lambda: epilogue_plain(stats), 3))
    log(f"epilogue kernel vs plain on fast_curvature k={k}'s stats: {rows} "
        f"rows ({nan_rows} with NaN K: padding slots), differing words by "
        f"column {differing.tolist()}; kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{EPILOGUE_ROW_BYTES} B a row)")
    check(int(differing.sum()) == 0,
          "epilogue kernel bit-identical to its plain version on every "
          "column of the main path's rows")
    return rec, max_err


LIST_FIT_ROW_BYTES = 44          # a row's query (12 B) and output (32 B),
                                 # beside its k winners' 12 B each


def list_fit_vs_plain(call, label, want, timed=False, max_rows=None):
    """One more ``call()`` with the list route's ``list_fit`` watched
    (``pipeline.fused.list_fit``, which every explicit list-engine caller
    reaches through ``fused._list_route``): ``want`` calls, one a
    select, and the output the call got from the kernel against
    ``list_fit_plain`` on the card over the same winners and queries, bit
    for bit on every column; with ``max_rows``, only the first select's
    first ``max_rows`` rows are kept and compared. ``timed``: the kernel
    and the plain version timed over the call's selects. Returns (record
    of the call, max abs error)."""
    import torch

    import pct_tpu_torch.pipeline.fused as fused
    from pct_tpu_torch.ops.list_fit import list_fit_plain

    real = fused.list_fit
    seen, chunks = [], []

    def watched(nbrs, qpts):
        out = real(nbrs, qpts)
        chunks.append(qpts.numel() // 3)
        if max_rows is None:
            seen.append((nbrs.clone(), qpts.clone(), out.clone()))
        elif not seen:
            k = nbrs.shape[-2]
            seen.append((nbrs.reshape(-1, k, 3)[:max_rows].clone(),
                         qpts.reshape(-1, 3)[:max_rows].clone(),
                         out.reshape(-1, 8)[:max_rows].clone()))
        return out

    fused.list_fit = watched
    try:
        call()
        torch.cuda.synchronize()
    finally:
        fused.list_fit = real
    check(len(chunks) == want, f"{label}: {want} list_fit calls, got "
          f"{len(chunks)}")
    differing, max_err, rows = 0, 0.0, 0
    for nbrs, qpts, got in seen:
        want_out = list_fit_plain(nbrs, qpts)
        differing += int((got.view(torch.int32)
                          != want_out.view(torch.int32)).sum())
        max_err = max(max_err, float((got - want_out).abs().nan_to_num(
            0.0).max()))
        rows += qpts.numel() // 3
    k = seen[0][0].shape[-2]
    log(f"list_fit kernel vs plain on {label}: {len(chunks)} selects, "
        f"{sum(chunks)} rows, {rows} compared at k={k}, differing words "
        f"{differing}")
    check(differing == 0, f"{label}: list_fit kernel bit-identical to its "
          "plain version")
    rec = None
    if timed:
        nb = sum(chunks) * (12 * k + LIST_FIT_ROW_BYTES)
        b_ms, b_by = bound(0, 0, 0, nb)
        rec = dict(bucket=0, cells=0, capacity=0, M=0, pairs=0,
                   rows=sum(chunks), bytes=nb, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None,
                   ms=sum(event_ms(lambda: real(a, q), TIMED_REPS)
                          for a, q, _ in seen),
                   plain_ms=sum(event_ms(lambda: list_fit_plain(a, q), 1)
                                for a, q, _ in seen))
        log(f"list_fit kernel on {label}: {rec['ms']:.4f} ms/call over "
            f"{len(chunks)} launches, plain {rec['plain_ms']:.2f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {12 * k + LIST_FIT_ROW_BYTES} B a row)")
    del seen
    torch.cuda.empty_cache()
    return rec, max_err


RUN_TABLE_BOX_BYTES = 8          # a box's int32 read once, written once


def tables(t):
    """The run-table kernel's launches for ``t`` dense run tables a call:
    one of each pass (tile minima, then the scan) a table."""
    return {"run_table": t, "run_table_scan": t}


def run_table_vs_plain(cellknn, grid, cells):
    """Phase 3c: the run table of the main path's grid. ``_runs_table``
    once with the kernel and once with ``suffix_min_plain`` in its place,
    on the card: equal run starts and lengths (integers). The table the
    kernel was handed, against ``suffix_min_plain`` bit for bit, then the
    kernel timed on it beside the plain version, ``torch.cummin`` of the
    pre-flipped table and the bytes bound (8 B a box). Returns (record,
    max abs error)."""
    import torch

    from pct_tpu_torch.ops.run_table import suffix_min_, suffix_min_plain

    real = cellknn.suffix_min_
    seen = []

    def watched(t):
        seen.append(t.clone())
        return real(t)

    cellknn.suffix_min_ = watched
    try:
        rs, run_len = cellknn._runs_table(grid, cells)
        cellknn.suffix_min_ = lambda t: t.copy_(suffix_min_plain(t))
        rs_p, run_len_p = cellknn._runs_table(grid, cells)
    finally:
        cellknn.suffix_min_ = real
    torch.cuda.synchronize()
    check(len(seen) == 1, "the main path's grid takes the dense run table")
    check(torch.equal(rs, rs_p) and torch.equal(run_len, run_len_p),
          "_runs_table: run starts and lengths equal with the kernel and "
          "with the plain suffix-min")
    (table,) = seen
    got, want = suffix_min_(table.clone()), suffix_min_plain(table)
    differing = int((got != want).sum())
    max_err = float((got.long() - want.long()).abs().max())
    boxes = table.numel()
    nb = boxes * RUN_TABLE_BOX_BYTES
    b_ms, b_by = bound(0, 0, 0, nb)
    work, flipped = table.clone(), torch.flip(table, [0])
    rec = dict(bucket=0, cells=0, capacity=0, M=0, pairs=0, rows=boxes,
               bytes=nb, bound_ms=b_ms, bound_by=b_by,
               ms=device_ms(lambda: suffix_min_(work), TIMED_REPS),
               plain_ms=event_ms(lambda: suffix_min_plain(table), 3),
               library_ms=event_ms(lambda: torch.cummin(flipped, 0), 3))
    log(f"run table kernel vs plain on the k={K_LIST} grid {grid.dims}: "
        f"{boxes} boxes, {int(cells.num_cells)} cells, differing boxes "
        f"{differing}; kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.3f} ms, torch.cummin {rec['library_ms']:.3f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}, {RUN_TABLE_BOX_BYTES} B a box)")
    check(differing == 0, "run table kernel bit-identical to its plain "
          "version on the main path's table")
    del seen, table, got, want, work, flipped
    return rec, max_err


def read_counts(counters, since):
    """The launches of each kernel in ``counters`` (name -> entry point
    symbol) since the ``trace.counters()`` reading ``since``, and for
    each name {k: launches at k} (the selects count their launches by k
    too). The counters are never reset: the probe's share the
    registry."""
    from pct_tpu_torch.utils import trace

    now = trace.counters()

    def got(key):
        return now.get(key, 0) - since.get(key, 0)

    by_k = {}
    for name, symbol in counters.items():
        pre = f"launches.{symbol}.k"
        by_k[name] = {int(key[len(pre):]): got(key) for key in now
                      if key.startswith(pre) and got(key)}
    return ({name: got("launches." + symbol)
             for name, symbol in counters.items()}, by_k)


def drive(call, label, counters, want_launches, warm=3, want_by_k=None):
    """A main path: one cold and ``warm`` warm calls of ``call()``, the
    launches of each counted. ``want_launches`` maps each counter's name
    to the launches one call must add; ``want_by_k`` maps a select
    counter's name to {k: launches one call must add at that k}. Returns
    the last result, the walls and the launches of the whole run."""
    import torch

    from pct_tpu_torch.utils import trace

    want_by_k = want_by_k or {}
    since = trace.counters()
    walls = []
    for i in range(1 + warm):
        before = trace.counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches, by_k = read_counts(counters, before)
        for name, got in launches.items():
            check(got == want_launches[name],
                  f"{label} call {i}: {name} launched {got} times, want "
                  f"{want_launches[name]}")
        for name, want in want_by_k.items():
            check(by_k[name] == want, f"{label} call {i}: {name} launches "
                  f"by k {by_k[name]}, want {want}")
    return res, walls, read_counts(counters, since)[0]


def accuracy(res, cloud, pts, k, med_limit):
    import numpy as np

    from pct_tpu_torch.shapes import analytic_curvatures

    n = cloud.num_points
    K_t = res.curv.K[:n].cpu().numpy()
    exact = res.exact[:n].cpu().numpy()
    Ka, _ = analytic_curvatures("torus", pts)
    relK = np.abs(K_t - Ka) / np.abs(Ka).max()
    exact_frac = float(exact.mean())
    nan_frac = float(np.isnan(K_t).mean())
    med_err = float(np.median(relK))
    log(f"main path k={k}: exact {exact_frac:.6f}, NaN fraction {nan_frac}, "
        f"median scale-relative K error {med_err:.4e}, "
        f"p99 {float(np.quantile(relK, 0.99)):.4e}")
    check(tuple(res.curv.K.shape) == (cloud.capacity,)
          and tuple(res.normals.shape) == (cloud.capacity, 3),
          "output shapes")
    check(exact_frac >= 0.999, "exact fraction >= 0.999")
    check(nan_frac == 0.0, "no NaN in K")
    check(med_err <= med_limit,
          f"median scale-relative K error <= {med_limit}")


def kth_vs_bruteforce(res, cloud, k):
    """kth distances of 2048 sampled rows against brute force
    (difference form)."""
    import numpy as np
    import torch

    dev = cloud.points.device
    n = cloud.num_points
    sample = torch.from_numpy(
        np.random.default_rng(0).choice(n, 2048, replace=False)).to(dev)
    P = cloud.points[:n]
    kth_bf = []
    for s in range(0, sample.numel(), 64):
        qi = sample[s:s + 64]
        d = P[None, :, :] - P[qi][:, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        d2[torch.arange(qi.numel(), device=dev), qi] = torch.inf
        kth_bf.append(torch.sqrt(torch.topk(d2, k, largest=False)
                                 .values[:, -1]))
    kth_bf = torch.cat(kth_bf)
    sel_exact = res.exact[sample]
    check(int(sel_exact.sum()) > 0, "certified rows among the sample")
    kth_err = float((res.kth_dist[sample] - kth_bf)[sel_exact].abs().max())
    log(f"k={k} kth distance vs brute force on {int(sel_exact.sum())} "
        f"certified sampled rows: max abs diff {kth_err}")
    check(kth_err <= 1e-6 * float(kth_bf.max()), "kth distance = brute force")


def ids_vs_plain(cellknn, grid, cells, spec, k, kernels, label):
    """The rows/positions kernels against their plain versions on every
    bucket, on the operands ``knn_cellwise_bucketed`` gives them (original
    ids). ``kernels`` maps a name to (kernel, plain). Past PLAIN_BUDGET_S
    of plain-version time, later buckets keep their first CUT_ROWS cell
    rows. Returns per-kernel lists of per-bucket rows and the largest
    abs error."""
    import torch

    from pct_tpu_torch.ops.select import knn_select

    per = {name: [] for name in kernels}
    rows = mismatched = 0
    max_err = 0.0
    plain_s = 0.0
    for b, (sp, args) in enumerate(cellknn.bucketed_tile_args(
            grid, cells, spec)):
        ops, ok_q, _, _ = cellknn._select_operands(
            grid, args, sp.capacity, sp.cand_cap, with_ids=True)
        count = args[2].to(torch.int64)
        tot = torch.clamp_max(args[4].sum(-1), sp.cand_cap).to(torch.int64)
        if plain_s > PLAIN_BUDGET_S:
            ops = tuple(a[:CUT_ROWS] for a in ops)
            count, tot = count[:CUT_ROWS], tot[:CUT_ROWS]
            log(f"  {label} bucket {b}: plain-version time so far "
                f"{plain_s:.1f} s > {PLAIN_BUDGET_S} s, comparing its first "
                f"{CUT_ROWS} cell rows only")
        pairs = int((count * tot).sum())
        outs = {}
        d_pos, pos = knn_select(*ops, k)
        lib_ms = topk_yardstick(ops, k, d_pos, pos)
        del d_pos, pos
        for name, (kernel, plain) in kernels.items():
            d_k, w_k = kernel(*ops, k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d_p, w_p = plain(*ops, k)
            torch.cuda.synchronize()
            plain_s += time.perf_counter() - t0
            same = ((d_k.view(torch.int32) == d_p.view(torch.int32))
                    & (w_k == w_p)).all(-1)
            rows += same.numel()
            mismatched += int((~same).sum())
            max_err = max(max_err, float((d_k - d_p).abs().max()),
                          float((w_k - w_p).abs().max()))
            outs[name] = w_k
            nb = nbytes(*ops, d_k, w_k)
            b_ms, b_by = bound(pairs, PAIR_FLOPS, 0, nb)
            per[name].append(dict(
                bucket=b, cells=int((args[0] != cellknn.PAD_ID).sum()),
                capacity=sp.capacity, M=ops[1].shape[1],
                cell_rows=ops[0].shape[0], pairs=pairs, bytes=nb,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                ms=event_ms(lambda ops=ops, f=kernel: f(*ops, k), 3),
                plain_ms=event_ms(lambda ops=ops, f=plain: f(*ops, k), 1)))
            del d_k, d_p, w_p
        if "select_rows" in outs and "select_pos" in outs:
            T, C, _ = outs["select_pos"].shape
            picked = torch.gather(ops[2], 1, outs["select_pos"].reshape(
                T, -1).long()).reshape(T, C, k)
            check(bool((picked == outs["select_rows"]).all()),
                  f"{label} bucket {b}: rows kernel = cand[pos kernel]")
        del outs
    log(f"{label} vs plain: {rows} query rows compared, {mismatched} "
        f"mismatched, max abs err {max_err}, plain-version time "
        f"{plain_s:.1f} s")
    check(mismatched == 0 and max_err == 0.0,
          f"{label}: kernels bit-identical to their plain versions")
    return per, max_err


def implicit_accuracy(res, cloud, pts, k, K_limit=None, H_limit=None):
    """bench.py's implicit metrics: median scale-relative K error and
    median relative |H| error against the analytic torus."""
    import numpy as np

    from pct_tpu_torch.shapes import analytic_curvatures

    n = cloud.num_points
    K = res.curv.K[:n].cpu().numpy()
    H = res.curv.H[:n].cpu().numpy()
    exact = res.exact[:n].cpu().numpy()
    Ka, Ha = analytic_curvatures("torus", pts)
    med_K = float(np.median(np.abs(K - Ka) / np.abs(Ka).max()))
    med_H = float(np.median(np.abs(np.abs(H) - np.abs(Ha)) / np.abs(Ha)))
    nan = float(np.isnan(K).mean())
    log(f"implicit k={k}: exact {float(exact.mean()):.6f}, NaN fraction "
        f"{nan}, median scale-relative K error {med_K:.4e}, median "
        f"relative |H| error {med_H:.4e}")
    check(nan == 0.0 and not np.isnan(H).any(), f"implicit k={k}: no NaN")
    check(tuple(res.curv.K.shape) == (cloud.capacity,), "output shape")
    if K_limit is not None:
        check(exact.mean() >= 0.999, f"implicit k={k}: exact >= 0.999")
        check(med_K <= K_limit, f"implicit k={k}: median K error <= "
              f"{K_limit}")
        check(med_H <= H_limit, f"implicit k={k}: median |H| error <= "
              f"{H_limit}")
    else:
        check(bool(exact.all()), f"implicit k={k}: exact 1.0")
    return med_K, med_H


def stage_times(label, cloud, k):
    """Host-clock stages of one ``fast_curvature`` call, synchronized
    after each: cell size, grid, engine choice with its bucket probe,
    cell loop."""
    import torch

    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.pipeline.fused import (
        SPLIT_TO,
        _fused_on_grid,
        plan_engine,
    )

    def stage(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    n = cloud.num_points
    for rep in range(3):
        cell_s, t_cell = stage(lambda: estimate_cell_size(cloud.points, n, k))
        grid_s, t_grid = stage(lambda: build_grid(cloud.points, n, cell_s))
        (engine, spec, mc, factor), t_probe = stage(
            lambda: plan_engine(grid_s, k))
        _, t_loop = stage(lambda: _fused_on_grid(grid_s, k, mc, spec, engine,
                                                 (SPLIT_TO, factor)))
        log(f"[{label}] k={k} stages rep {rep}: cell size {t_cell:.1f} ms, "
            f"grid {t_grid:.1f} ms, bucket probe {t_probe:.1f} ms, cell "
            f"loop {t_loop:.1f} ms")


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.3f} ms"


def log_buckets(label, name, per_bucket):
    first = FIRST_DESIGN_MS.get(name)
    for r in per_bucket:
        extra = (f", {r['members']} members, error ratio {r['ratio']:.4g}"
                 if "members" in r else "")
        old = first[r["bucket"]] if first else None
        lib = (f", library yardstick (partial) {fmt_ms(r['library_ms'])}"
               if "library_ms" in r else "")
        log(f"[{label}] {name} bucket {r['bucket']}: {r['cells']} cells, C "
            f"{r['capacity']}, M {r['M']}, {r['pairs']} pairs{extra}: kernel "
            f"{r['ms']:.3f} ms (first design {fmt_ms(old)}), plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){lib}, 1 launch/call")
    if name in FIRST_DESIGN_CALL_MS:
        lo, hi = FIRST_DESIGN_CALL_MS[name]
        log(f"[{label}] {name}: {sum(r['ms'] for r in per_bucket):.3f} "
            f"ms/call over {len(per_bucket)} buckets; first design {lo}-{hi}"
            f" ms/call (PERF.md)")


def library_total(per_bucket):
    libs = [r.get("library_ms") for r in per_bucket]
    return None if None in libs else sum(libs)


def call_numbers(per_bucket, flops=None, tc_flops=0):
    """Per call of the entry point: the buckets' ms, plain ms and
    library ms summed, and the bound of the work they do together
    (``tc_flops`` on the bf16 tensor cores, beside the FP32 ``flops``)."""
    if flops is None:
        flops = sum(r["pairs"] for r in per_bucket) * PAIR_FLOPS
    t_ops = max(flops / FP32_PEAK, tc_flops / BF16_TC_PEAK)
    t_bytes = sum(r["bytes"] for r in per_bucket) / HBM_BYTES_PER_S
    return {
        "ms": sum(r["ms"] for r in per_bucket),
        "plain_ms": sum(r["plain_ms"] for r in per_bucket),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_total(per_bucket),
    }


def kernel_row(name, source, replaces, launches, max_err, per_bucket,
               flops=None, tc_flops=0):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_err,
        **call_numbers(per_bucket, flops, tc_flops),
    }


def band_vs_plain(ops, k, bc, cap, band, counts=None,
                  budget_s=BAND_PLAIN_BUDGET_S):
    """The band kernel against its plain version, bit for bit, on row
    blocks in a seeded random order until ``budget_s`` of plain-version
    time, with ``counts`` (None: every slot computed).
    Returns (kernel outputs, blocks checked, rows checked, max abs err,
    plain seconds, whether every block was checked)."""
    import torch

    from pct_tpu_torch.experimental import band_select_plain, knn_band_select

    nb = ops[3].shape[0]
    q = bc * cap
    mode = "all slots" if counts is None else "counts"
    got = knn_band_select(*ops, k=k, bc=bc, cap=cap, band=band,
                          counts=counts)
    torch.cuda.synchronize()
    d_k, r_k, c_k = (a.reshape(nb, q, *a.shape[1:]) for a in got)
    order = torch.randperm(nb, generator=torch.Generator().manual_seed(0))
    checked = mismatched = 0
    max_err = 0.0
    plain_s = 0.0
    for s in range(0, nb, BAND_CHUNK_BLOCKS):
        if plain_s > budget_s:
            break
        idx = order[s:s + BAND_CHUNK_BLOCKS].to(ops[3].device)
        sub = ops[:3] + tuple(a[idx] for a in ops[3:])
        t0 = time.perf_counter()
        d_p, r_p, c_p = band_select_plain(
            *sub, k, bc, cap, band, None if counts is None else counts[idx])
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        d_p, r_p, c_p = (a.reshape(idx.numel(), q, *a.shape[1:])
                         for a in (d_p, r_p, c_p))
        same = ((d_k[idx].view(torch.int32) == d_p.view(torch.int32))
                .all(-1) & (r_k[idx] == r_p).all(-1)
                & (c_k[idx].view(torch.int32) == c_p.view(torch.int32)))
        checked += idx.numel()
        mismatched += int((~same).sum())
        max_err = max(max_err, float((d_k[idx] - d_p).abs().max()),
                      float((r_k[idx] - r_p).abs().max()),
                      float((c_k[idx] - c_p).abs().max()))
    log(f"band kernel k={k} vs plain ({mode}): {checked} of {nb} row blocks "
        f"({checked * q} query slots) compared in {plain_s:.1f} s of "
        f"plain-version time, {mismatched} slots mismatched, max abs err "
        f"{max_err}")
    check(mismatched == 0 and max_err == 0.0,
          f"band kernel bit-identical to its plain version ({mode})")
    return got, checked, checked * q, max_err, plain_s, checked == nb


def band_vs_rows(band_res, rows_res, n, k):
    """``knn_cellwise_band`` against the rows path on rows both certify:
    kth distances bit-equal, winner sets equal except for candidates at
    the kth distance. Returns (rows compared, rows whose sets differ,
    rows that differ only in order, rows with a tie inside the list at
    the kth distance)."""
    import torch

    both = band_res.exact[:n] & rows_res.exact[:n]
    kth_b = band_res.dists[:n, k - 1][both]
    kth_r = rows_res.dists[:n, k - 1][both]
    check(bool((kth_b.view(torch.int32) == kth_r.view(torch.int32)).all()),
          "band kth distances bit-equal to the rows path's")
    rows = both.nonzero().flatten()
    differ = order_only = tied = 0
    for s in range(0, rows.numel(), 1 << 17):
        r = rows[s:s + (1 << 17)]
        ib, ir = band_res.indices[r], rows_res.indices[r]
        db, dr = band_res.dists[r], rows_res.dists[r]
        kth = db[:, k - 1:k]
        in_r = (ib[:, :, None] == ir[:, None, :]).any(-1)
        in_b = (ir[:, :, None] == ib[:, None, :]).any(-1)
        check(bool(((in_r | (db == kth)).all() & (in_b | (dr == kth)).all())),
              "band winners differ from the rows path's only at the kth "
              "distance")
        set_diff = ~in_r.all(-1)
        differ += int(set_diff.sum())
        order_only += int((~set_diff & (ib != ir).any(-1)).sum())
        tied += int((db[:, k - 2] == db[:, k - 1]).sum())
    return rows.numel(), differ, order_only, tied


def fitted_band(grid, cells, blocks, cap, bc):
    """(band, span): the smallest multiple of 128 rows that holds every
    row block's runs, and the widest block's span in rows (at most
    MAX_BAND: a wider block is clipped to it and fails its band check)."""
    import torch

    from pct_tpu_torch.experimental import MAX_BAND
    from pct_tpu_torch.experimental.band_knn import band_operands

    wide = band_operands(grid, cells, blocks, cap, bc, MAX_BAND)[0]
    span = int(torch.where(wide[5] > 0, wide[4] + wide[5], 0).max())
    return -(-span // 128) * 128, span


def band_phase(label, cloud, counters, none):
    """Phase 5e: the band kNN on the whole cloud at k=20."""
    import torch

    from pct_tpu_torch.experimental import (
        band_select_plain,
        build_row_blocks,
        knn_band_select,
        knn_cellwise_band,
    )
    from pct_tpu_torch.experimental.band_knn import band_operands, default_band
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.ops.select import knn_select_rows

    n = cloud.num_points
    k, bc = K_LIST, BAND_BC
    cell = estimate_cell_size(cloud.points, n, k)
    grid = build_grid(cloud.points, n, cell)
    cells, cap, mc, cand_cap = cellknn.probe_grid(grid)
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        blocks = build_row_blocks(cells, bc)
        host.append(time.perf_counter() - t0)
    nb = blocks.shape[0] // bc
    # The default band (bc+3)*cap does not hold a block whose row has gaps
    # in x (its runs in a neighbor row span more than bc+2 cells), and its
    # rows lose their certificate. The phase runs at the smallest multiple
    # of 128 that every block's runs fit, and reports the default's exact.
    band_d = default_band(bc, cap)
    ops_d, _, counts_d, ok_d = band_operands(grid, cells, blocks, cap, bc,
                                             band_d)
    exact_d = float(knn_cellwise_band(grid, cells, blocks, k, cap, bc=bc)
                    .exact[:n].float().mean())
    band, span = fitted_band(grid, cells, blocks, cap, bc)
    log(f"band kNN k={k}: {int(cells.num_cells)} cells, {nb} row blocks of "
        f"{bc}, cap {cap}, cand_cap {cand_cap}, {nb * bc * cap} query slots;"
        f" default band {band_d}: {int(ok_d.sum())} blocks fit, exact "
        f"{exact_d:.6f}; widest block span {span} rows, band {band}")
    ops, _, counts, band_ok = band_operands(grid, cells, blocks, cap, bc,
                                            band)
    check(bool(band_ok.all()), "every row block's runs fit the band")
    err_all = band_vs_plain(ops, k, bc, cap, band)[3]
    got, blocks_checked, rows_checked, band_err, plain_s, all_blocks = \
        band_vs_plain(ops, k, bc, cap, band, counts)
    band_err = max(band_err, err_all)
    # the work the data needs: each real query slot against its cell's runs
    pairs = int((ops[5].sum(-1).to(torch.int64) * counts).sum())
    nb_bytes = nbytes(*ops, counts, *got)
    del got

    res, walls, launches = drive(
        lambda: knn_cellwise_band(grid, cells, blocks, k, cap, bc=bc,
                                  band=band, lean=False),
        f"knn_cellwise_band k={k}", counters,
        {**none, "band_select": 1, **tables(0)})
    rows_res = cellknn.knn_cellwise(grid, cells, k, capacity=cap,
                                    cand_cap=cand_cap, original_ids=False)
    exact = float(res.exact[:n].float().mean())
    log(f"knn_cellwise_band k={k}: exact {exact:.6f} (rows path "
        f"{float(rows_res.exact[:n].float().mean()):.6f})")
    check(exact >= 0.999, "band kNN exact fraction >= 0.999")
    compared, differ, order_only, tied = band_vs_rows(res, rows_res, n, k)
    log(f"band vs rows path on {compared} rows both certify: kth distances "
        f"bit-equal; {differ} rows whose winner sets differ (ties at the "
        f"kth distance), {order_only} rows differing only in order, {tied} "
        f"rows with a tie inside the list at the kth distance")
    del res, rows_res

    ms = event_ms(lambda: knn_band_select(*ops, k=k, bc=bc, cap=cap,
                                          band=band, counts=counts),
                  TIMED_REPS)
    ms_d = event_ms(lambda: knn_band_select(*ops_d, k=k, bc=bc, cap=cap,
                                            band=band_d, counts=counts_d),
                    TIMED_REPS)
    ms_all = event_ms(lambda: knn_band_select(*ops, k=k, bc=bc, cap=cap,
                                              band=band), TIMED_REPS)
    del ops_d
    if not all_blocks:      # else the check above timed a whole plain pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        band_select_plain(*ops, k, bc, cap, band, counts)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    plain_ms = plain_s * 1e3
    b_ms, b_by = bound(pairs, PAIR_FLOPS, 0, nb_bytes)
    # the rows kernel on the same cells, one bucket (the compared path)
    spec = (cellknn.BucketSpec(hi_key=1 << 30, capacity=cap,
                               cand_cap=cand_cap, max_cells=mc),)
    (_, args), = cellknn.bucketed_tile_args(grid, cells, spec)
    sel = cellknn._select_operands(grid, args, cap, cand_cap)[0]
    rows_ms = event_ms(lambda: knn_select_rows(*sel, k), TIMED_REPS)
    del sel, ops
    wall = statistics.median(walls[1:])
    log(f"[{label}] knn_cellwise_band k={k}, 1M torus: warm wall "
        f"{wall:.4f} s/call (median of {len(walls) - 1}; cold first call "
        f"{walls[0]:.3f} s), {N_POINTS / wall:.0f} points/s; "
        f"build_row_blocks host time {statistics.median(host) * 1e3:.1f} ms "
        f"(median of 3)")
    first = BAND_FIRST_DESIGN_MS
    log(f"[{label}] band kernel k={k} (counts, the main path's mode): "
        f"{ms:.3f} ms/call (1 launch/call) over {nb} blocks, cap {cap}, "
        f"band {band} (first design {fmt_ms(first.get(band))}), "
        f"{ms * 1e3 / nb:.3f} us/block; every slot computed: {ms_all:.3f} "
        f"ms/call; plain {plain_ms:.1f} ms; bound {b_ms:.4f} ms ({b_by}); "
        f"at the default band {band_d}: {ms_d:.3f} ms/call (first design "
        f"{fmt_ms(first.get(band_d))}); rows kernel on the same cells in "
        f"one bucket (C {cap}, M {cand_cap}): {rows_ms:.3f} ms")
    return dict(pairs=pairs, bytes=nb_bytes, ms=ms, plain_ms=plain_ms,
                default_band_ms=ms_d, all_slots_ms=ms_all,
                launches=launches["band_select"], max_err=band_err,
                blocks_checked=blocks_checked, rows_checked=rows_checked,
                dense_key_bytes=nb * bc * cap * NINE_BANDS * band * 8)


def study_phase(label, cloud):
    """Phase 5f: the neighbor study and masked ``pointwise_curvature``."""
    import torch

    from pct_tpu_torch.neighbors import knn_cloud_grid
    from pct_tpu_torch.pipeline import (
        explicit_quadratic_neighbor_study,
        pointwise_curvature,
    )

    n = cloud.num_points
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k_rec, per = explicit_quadratic_neighbor_study(cloud)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    conv = per >= 0
    log(f"[{label}] neighbor study (500 samples, kmax 99), 1M torus: "
        f"recommended k {int(k_rec)}, {int(conv.sum())} samples converged "
        f"(median k {float(per[conv].float().median()) if conv.any() else -1}"
        f"), wall {wall:.3f} s")
    check(tuple(per.shape) == (500,) and 4 <= int(k_rec) <= 100,
          "neighbor study: 500 samples, recommended k in [4, 100]")
    res, _ = knn_cloud_grid(cloud, K_LIST)
    pts, idx = cloud.points, res.indices
    plain = pointwise_curvature(pts, idx)[0].K[:n]
    ones = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    masked = pointwise_curvature(pts, idx, neighbor_mask=ones)[0].K[:n]
    fin = torch.isfinite(plain)
    diff = float((masked - plain)[fin].abs().max())
    scale = float(plain[fin].abs().max())
    log(f"pointwise_curvature, all-True mask vs unmasked k={K_LIST}: "
        f"{int(fin.sum())} finite rows, max |dK| {diff:.3e} (max|K| "
        f"{scale:.4g})")
    check(diff <= 1e-6 * scale, "all-True mask K within 1e-6 max|K|")
    near = ones & (torch.arange(K_LIST, device=idx.device) < K_LIST // 2)
    half = pointwise_curvature(pts, idx, neighbor_mask=near)
    nan = sum(int(a[:n].isnan().sum()) for a in (*half[0], half[1]))
    log(f"pointwise_curvature, nearest {K_LIST // 2} of {K_LIST} slots: "
        f"{nan} NaN")
    check(nan == 0, "half-masked pointwise_curvature: no NaN")


def tube_normal_agreement(nrm, pts):
    """Fraction of rows whose normal points away from the torus' center
    circle (the JAX test's rule: > 0.999 or < 0.001 is consistent)."""
    import numpy as np

    rho = np.linalg.norm(pts[:, :2], axis=1, keepdims=True)
    c = np.concatenate([pts[:, :2] / np.maximum(rho, 1e-9),
                        np.zeros((len(pts), 1), pts.dtype)], axis=1)
    ana = pts - 0.75 * rho.max() * c
    return float((np.sum(nrm * ana, axis=1) > 0).mean())


def normals_phase(label, cloud, pts, counters, none):
    """Phase 7a: ``estimate_and_orient_normals(cloud, k=50)``, its kernels
    held against their plain versions on every bucket of the layouts
    ``plan_normals`` gives it, then driven."""
    import numpy as np

    import pct_tpu_torch.mesh.normals as nm
    from pct_tpu_torch.mesh import estimate_and_orient_normals
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.ops.select import knn_select_rows, select_rows_plain
    from pct_tpu_torch.pipeline.fused import SPLIT_TO
    from pct_tpu_torch.utils import trace

    n, ncap = cloud.num_points, cloud.capacity
    rows = {"select_rows": (knn_select_rows, select_rows_plain)}
    plan = nm.plan_normals(cloud.points, n, K_NORMALS)
    k, kv, kc = plan.k, plan.kv, plan.kc
    check(plan.hierarchical and plan.moments is not None,
          "the 1M cloud takes the hierarchical path and the moments route")
    check(kv != kc, "voters and coarse graph select at different k")
    spec_m, mc_m, factor = plan.moments
    spec_v, mc_v = plan.rows
    spec_c, mc_c = plan.coarse
    log(f"normals k={k}: capacity {ncap}, stride {plan.stride}, kc {kc}, "
        f"{plan.sweeps} fine sweeps; moments split factor {factor}, "
        f"{len(spec_m)} buckets {[tuple(s) for s in spec_m]}; voters kv={kv}: "
        f"{len(spec_v)} buckets {[tuple(s) for s in spec_v]}; coarse graph: "
        f"{plan.coarse_num_points} points, {[tuple(s) for s in spec_c]}")
    cells = cellknn.compact_cells(plan.grid, mc_m)
    if factor > 1:
        cells = cellknn.split_cells(cells, ncap, SPLIT_TO, factor)
    mom, mom_err, mom_ratio = moments_vs_plain(cellknn, plan.grid, cells,
                                               spec_m, k)
    del cells
    rows_v, err_v = ids_vs_plain(cellknn, plan.grid, cellknn.compact_cells(
        plan.grid, mc_v), spec_v, kv, rows, f"rows kv={kv} (voters)")
    rows_c, err_c = ids_vs_plain(
        cellknn, plan.coarse_grid, cellknn.compact_cells(plan.coarse_grid,
                                                         mc_c),
        spec_c, kc, rows, f"rows kc={kc} (coarse graph)")
    del plan

    since = trace.counters()
    nrm, walls, launches = drive(
        lambda: estimate_and_orient_normals(cloud, k=K_NORMALS),
        f"estimate_and_orient_normals k={k}", counters,
        {**none, "moments": len(spec_m), "select_rows": len(spec_v) + 1,
         "epilogue": 1, **tables(5)},
        want_by_k={"select_rows": {kv: len(spec_v), kc: 1}})
    by_k = read_counts(counters, since)[1]["select_rows"]
    got = nrm[:n].cpu().numpy()
    agree = tube_normal_agreement(got, pts)
    norm_err = float(np.abs(np.linalg.norm(got, axis=1) - 1).max())
    nan = int(np.isnan(got).sum())
    calls = len(walls)
    log(f"normals k={k}: sign agreement with the analytic tube normal "
        f"{agree:.6f}, max |norm - 1| {norm_err:.3g}, {nan} NaN; launches "
        f"in the driven run ({calls} calls): moments {launches['moments']}, "
        f"select_rows at kv={kv} {by_k[kv]}, at kc={kc} {by_k[kc]}")
    check(tuple(nrm.shape) == (ncap, 3), "normals shape")
    check(agree > 0.999 or agree < 0.001, "normals globally consistent")
    check(norm_err <= 1e-5, "unit normals")
    check(nan == 0, "no NaN in the normals")
    normals_stage_times(label, cloud, K_NORMALS)
    wall = statistics.median(walls[1:])
    log(f"[{label}] estimate_and_orient_normals k={k}, 1M torus: warm wall "
        f"{wall:.4f} s/call (median of {len(walls) - 1}; cold first call "
        f"{walls[0]:.3f} s)")
    return dict(
        moments=dict(buckets=mom, max_err=mom_err, ratio=mom_ratio,
                     launches=launches["moments"], calls=calls,
                     label=f"k={k} (normals, split to {SPLIT_TO})"),
        rows_v=dict(buckets=rows_v["select_rows"], max_err=err_v,
                    launches=by_k[kv], calls=calls,
                    label=f"kv={kv} (normals voters)"),
        rows_c=dict(buckets=rows_c["select_rows"], max_err=err_c,
                    launches=by_k[kc], calls=calls,
                    label=f"kc={kc} (normals coarse graph)"),
        wall=wall, walls=walls, agree=agree)


def normals_stage_times(label, cloud, k):
    """Host-clock stages of one ``estimate_and_orient_normals`` call,
    synchronized after each, through the steps its body runs: the plan
    (cell size, grids, bucket probes), the raw normals and voter kNN,
    the orientation (coarse graph, coarse and fine wavefronts,
    consensus)."""
    import torch

    import pct_tpu_torch.mesh.normals as nm

    def stage(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    n, pts = cloud.num_points, cloud.points
    for rep in range(3):
        plan, t_plan = stage(lambda: nm.plan_normals(pts, n, k))
        (raw, idx_o), t_nb = stage(
            lambda: nm.raw_normals_and_voters(plan, pts))
        _, t_orient = stage(lambda: nm.orient_planned(plan, pts, raw, idx_o))
        log(f"[{label}] estimate_and_orient_normals k={k} stages rep {rep}: "
            f"plan (cell size, grids, bucket probes) {t_plan:.1f} ms, moments "
            f"raw normals + voter kNN {t_nb:.1f} ms, orientation "
            f"{t_orient:.1f} ms")
        del plan, raw, idx_o


def vertex_curvature_phase(label, verts, counters, none):
    """Phase 7b: ``fast_curvature`` at k=20 on the structured torus mesh's
    vertices (the vertex fits of the mesh energies), its coords kernel
    held against its plain version on every bucket, then driven."""
    import torch

    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.pipeline import fast_curvature, plan_engine

    k = K_LIST
    cloud = from_numpy(verts, device=torch.device("cuda"))
    n = cloud.num_points
    grid = build_grid(cloud.points, n, estimate_cell_size(cloud.points, n, k))
    engine, spec, mc, _ = plan_engine(grid, k)
    check(engine == "list", f"mesh vertices k={k} run the list engine")
    log(f"vertex curvature k={k}, {n} mesh vertices: {len(spec)} buckets "
        f"{[tuple(s) for s in spec]}")
    per, err = select_vs_plain(cellknn, grid, cellknn.compact_cells(grid, mc),
                               spec, k)
    del grid
    n_sel = cellknn.list_select_launches(spec)
    res, walls, launches = drive(
        lambda: fast_curvature(cloud, k), f"fast_curvature k={k} mesh vertices",
        counters, {**none, "select_coords": n_sel, "list_fit": n_sel,
                   **tables(2)},
        want_by_k={"select_coords": {k: n_sel}})
    list_fit_vs_plain(lambda: fast_curvature(cloud, k),
                      f"fast_curvature k={k} mesh vertices", n_sel)
    accuracy(res, cloud, verts, k, 1.5e-3)
    wall = statistics.median(walls[1:])
    log(f"[{label}] fast_curvature k={k}, 1000x1000 torus mesh vertices: warm "
        f"wall {wall:.4f} s/call (median of {len(walls) - 1}; cold first call "
        f"{walls[0]:.3f} s); coords kernel "
        f"{sum(r['ms'] for r in per):.3f} ms/call over {len(spec)} buckets")
    rec = dict(buckets=per, max_err=err, launches=launches["select_coords"],
               calls=len(walls), wall=wall, walls=walls,
               label=f"k={k} (torus mesh vertices)")
    return rec, res


def torus_mesh(side):
    """Structured torus mesh, R=1, r=1/3: a side x side (u, v) lattice,
    two triangles a lattice cell, every edge shared by two faces."""
    import numpy as np

    t = 2 * np.pi * np.arange(side) / side
    U, V = np.meshgrid(t, t, indexing="ij")
    rho = 1.0 + np.cos(V) / 3.0
    verts = np.stack([rho * np.cos(U), rho * np.sin(U), np.sin(V) / 3.0],
                     -1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    a = i * side + j
    b = ((i + 1) % side) * side + j
    c = ((i + 1) % side) * side + (j + 1) % side
    d = i * side + (j + 1) % side
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    return verts, faces.astype(np.int32)


def mesh_ops_phase(label, cloud, verts, faces, vres):
    """Phase 7c: Taubin smoothing and energies on the structured torus
    mesh (with 7b's vertex curvatures ``vres``) and voxel downsampling of
    the 1M cloud, on the card against the CPU and the analytic torus."""
    import numpy as np
    import torch

    from pct_tpu_torch.mesh import mesh_energies, taubin_smooth, voxel_downsample
    from pct_tpu_torch.shapes import analytic_area, analytic_energies

    dev = cloud.points.device
    v_c, f_c = torch.from_numpy(verts), torch.from_numpy(faces)
    v_g, f_g = v_c.to(dev), f_c.to(dev)
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    got = taubin_smooth(v_g, f_g)
    t0 = time.perf_counter()
    want = taubin_smooth(v_c, f_c)
    cpu_s = time.perf_counter() - t0
    d = float((got.cpu() - want).abs().max())
    log(f"taubin_smooth x10, {len(verts)} vertices, {len(faces)} faces: card "
        f"vs CPU max |d| {d:.3e} (bbox diagonal {diag:.4f}, limit "
        f"{1e-5 * diag:.3e})")
    check(d <= 1e-5 * diag, "taubin_smooth on the card = the CPU run")
    smooth_ms = event_ms(lambda: taubin_smooth(v_g, f_g), 3)
    del got, want

    nv = len(verts)
    K, H = vres.curv.K[:nv], vres.curv.H[:nv]
    e = mesh_energies(v_g, f_g, K, H)
    bend, stretch, area = (float(x) for x in e)
    a_ref = analytic_area("torus")
    b_ref, s_ref = analytic_energies("torus")
    log(f"mesh_energies on the torus mesh with fast_curvature(k={K_LIST}) "
        f"K/H: area {area:.6f} vs {a_ref:.6f} "
        f"({abs(area / a_ref - 1):.4%}), bending {bend:.6f} vs {b_ref:.6f} "
        f"({abs(bend / b_ref - 1):.4%}), stretching {stretch:.6f} vs {s_ref}; "
        f"vertex exact {float(vres.exact[:nv].float().mean()):.6f}")
    check(abs(area / a_ref - 1) <= 5e-3, "area within 0.5% of analytic")
    check(abs(bend / b_ref - 1) <= 1e-2, "bending within 1% of analytic")
    check(abs(stretch) <= 0.1, "|stretching| <= 0.1")
    energies_ms = event_ms(lambda: mesh_energies(v_g, f_g, K, H), 5)
    del K, H

    n = cloud.num_points
    p_c = cloud.points.cpu()
    ds_ms = {}
    for mode in ("first", "centroid"):
        out_g, kept_g = voxel_downsample(cloud.points, n, VOXEL, mode=mode)
        out_c, kept_c = voxel_downsample(p_c, n, VOXEL, mode=mode)
        kept = int(kept_g)
        rows = out_g.cpu()
        diff = float((rows[:kept] - out_c[:kept]).abs().max())
        log(f"voxel_downsample {mode} (voxel {VOXEL}): {kept} of {n} kept "
            f"(CPU {int(kept_c)}), max |d| of the kept rows {diff:.3g}")
        check(kept == int(kept_c) and 0 < kept < n,
              f"voxel_downsample {mode}: num_kept = the CPU run's")
        if mode == "first":
            check(torch.equal(rows, out_c),
                  "voxel_downsample first: rows = the CPU run's")
        else:
            # the voxel sums are float atomics on the card
            check(diff <= 1e-6 * float(p_c[:n].abs().max()),
                  "voxel_downsample centroid: rows within 1e-6 of the CPU's")
            check(bool((rows[kept:] == out_c[kept:]).all()),
                  "voxel_downsample centroid: padding rows")
        ds_ms[mode] = event_ms(
            lambda mode=mode: voxel_downsample(cloud.points, n, VOXEL,
                                               mode=mode), 3)
    log(f"[{label}] mesh operations, 1000x1000 torus mesh / 1M torus cloud "
        f"(CUDA events, median of 3-5): taubin_smooth x10 {smooth_ms:.3f} ms "
        f"(CPU {cpu_s:.3f} s), mesh_energies {energies_ms:.3f} ms, "
        f"voxel_downsample first {ds_ms['first']:.3f} ms, centroid "
        f"{ds_ms['centroid']:.3f} ms")


def mesh_path_phase(label, pts, counters, none):
    """Phase 8: ``create_mesh_with_curvature`` on the 1M torus at the
    reference's defaults, once, with its launches counted; then the coords
    kernel against its plain version on every bucket of the smoothed
    vertices' layout, and the mesh through the port's binary PLY."""
    import tempfile

    import numpy as np
    import torch

    import pct_tpu_torch.mesh.normals as nm
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.io import read_ply, write_ply
    from pct_tpu_torch.mesh import boundary_edges, reconstruct
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.pipeline import create_mesh_with_curvature, plan_engine
    from pct_tpu_torch.shapes import analytic_area, analytic_energies
    from pct_tpu_torch.utils import trace

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    # --- 8a. the BPA library, built from the checkout's native/bpa.cpp ---
    lib = reconstruct.library_path()
    fresh = not lib.exists()
    t0 = time.perf_counter()
    reconstruct.load()
    build_s = time.perf_counter() - t0
    log(f"[{label}] BPA library {lib.relative_to(lib.parents[2])}: "
        f"{'built with g++' if fresh else 'already built'} in {build_s:.2f} s")
    check(lib.exists() and lib.parent.name == "_build"
          and lib.parent.parent.name == "pct_tpu_torch",
          "the BPA library lies in pct_tpu_torch/_build/")

    # --- 8b. the mesh path, driven once ---
    n = len(pts)
    plan = nm.plan_normals(from_numpy(pts, device=dev).points, n, K_NORMALS)
    kv, kc = plan.kv, plan.kc
    spec_m, spec_v = plan.moments[0], plan.rows[0]
    check(plan.hierarchical and plan.moments is not None,
          "the mesh path's normals take the hierarchical moments route")
    del plan
    since = trace.counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = create_mesh_with_curvature(pts, k_neighbors=K_LIST, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_k = read_counts(counters, since)

    V, F = len(res.vertices), len(res.faces)
    nb = len(boundary_edges(res.faces))
    e = res.energies
    a_ref = analytic_area("torus")
    b_ref, _ = analytic_energies("torus")
    area_err, bend_err = e.total_area / a_ref - 1, e.bending / b_ref - 1
    agree = tube_normal_agreement(res.normals, pts)
    nan_k, nan_h = int(np.isnan(res.K).sum()), int(np.isnan(res.H).sum())
    log(f"[{label}] create_mesh_with_curvature, 1M torus, k_neighbors="
        f"{K_LIST}, Taubin x10, both hole passes, adaptive radii: {V} "
        f"vertices, {F} faces ({F / V:.4f} per vertex), {nb} boundary edges "
        f"({nb / (3 * F):.3e} of 3F), {res.n_holes_filled} holes filled; "
        f"NaN K {nan_k}, H {nan_h}; normals' sign agreement with the tube "
        f"normal {agree:.6f}")
    log(f"[{label}] mesh energies: area {e.total_area:.6f} vs {a_ref:.6f} "
        f"({area_err:+.4%}; JAX package's 1M run "
        f"{JAX_MESH_TORUS['area_err']:+.4%}), bending {e.bending:.6f} vs "
        f"{b_ref:.6f} ({bend_err:+.4%}; JAX {JAX_MESH_TORUS['bending_err']:+.4%}"
        f"), stretching {e.stretching:.6f} (JAX "
        f"{JAX_MESH_TORUS['stretching']:.6f}; analytic 0)")
    check(V == N_POINTS, "the mesh keeps every point as a vertex")
    check(F >= 1.9 * V, "faces >= 1.9 x vertices")
    check(nb <= 0.01 * 3 * F, "boundary edges <= 1% of 3 x faces")
    check(nan_k == 0 and nan_h == 0, "no NaN in the vertex K and H")
    check(agree > 0.999 or agree < 0.001, "mesh normals globally consistent")
    check(abs(area_err) <= 5e-3, "mesh area within 0.5% of analytic")
    check(abs(bend_err) <= 0.1, "mesh bending within 10% of analytic")
    check(abs(e.stretching) <= 0.3, "|mesh stretching| <= 0.3")

    # --- 8c. where the wall goes ---
    t = res.timings
    dev_s = sum(t.get(s, 0.0) for s in DEVICE_STAGES)
    host_s = sum(v for s, v in t.items() if s not in DEVICE_STAGES)
    log(f"[{label}] create_mesh_with_curvature timings (s): {t}; wall "
        f"{wall:.3f} s (one call); device "
        f"stages {dev_s:.3f} s ({dev_s / (dev_s + host_s):.2%} of the staged "
        f"time), host stages (bpa with the spacing sample, holes_small, "
        f"holes_large) {host_s:.3f} s ({host_s / (dev_s + host_s):.2%})")

    # --- 8d. launches, and the coords kernel at the vertex shapes ---
    vcloud = from_numpy(res.vertices, device=dev)
    grid = build_grid(vcloud.points, n, estimate_cell_size(vcloud.points, n,
                                                           K_LIST))
    engine, spec, mc, _ = plan_engine(grid, K_LIST)
    check(engine == "list", f"mesh vertices k={K_LIST} run the list engine")
    log(f"vertex curvature k={K_LIST} on the BPA mesh's smoothed vertices: "
        f"{len(spec)} buckets {[tuple(s) for s in spec]}")
    n_sel = cellknn.list_select_launches(spec)
    want = {**none, "moments": len(spec_m), "epilogue": 1,
            "select_rows": len(spec_v) + 1, "select_coords": n_sel,
            "list_fit": n_sel, **tables(7)}
    log(f"mesh path launches: {launches}; select_rows by k "
        f"{by_k['select_rows']}, select_coords by k {by_k['select_coords']}")
    check(launches == want, f"mesh path launches {launches}, want {want}")
    check(by_k["select_rows"] == {kv: len(spec_v), kc: 1},
          f"select_rows by k {by_k['select_rows']}")
    check(by_k["select_coords"] == {K_LIST: n_sel},
          f"select_coords by k {by_k['select_coords']}")
    per, err = select_vs_plain(cellknn, grid, cellknn.compact_cells(grid, mc),
                               spec, K_LIST)
    del grid, vcloud
    log(f"[{label}] coords kernel on the BPA mesh vertices: "
        f"{sum(r['ms'] for r in per):.3f} ms/call over {len(spec)} buckets")

    # --- 8e. the mesh through the port's binary PLY ---
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "torus_mesh.ply")
        t0 = time.perf_counter()
        write_ply(path, res.vertices, res.normals, res.faces,
                  vertex_props={"gaussian_curvature": res.K,
                                "mean_curvature": res.H}, binary=True)
        back = read_ply(path)
        io_s = time.perf_counter() - t0
    check(np.array_equal(back.points, res.vertices)
          and np.array_equal(back.faces, res.faces)
          and np.array_equal(back.vertex_props["gaussian_curvature"], res.K),
          "binary PLY round trip: vertices, faces and K equal")
    log(f"[{label}] binary PLY write + read of the mesh: {io_s:.2f} s; "
        f"phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return dict(buckets=per, max_err=err, launches=launches["select_coords"],
                calls=1, wall=wall, timings=t, energies=e,
                label=f"k={K_LIST} (BPA mesh of the 1M torus, smoothed "
                      "vertices)")


def vertex_buckets(verts, k):
    """The buckets ``fast_curvature(k)`` runs on these points."""
    import torch

    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.pipeline import plan_engine

    c = from_numpy(verts, device=torch.device("cuda"))
    grid = build_grid(c.points, c.num_points,
                      estimate_cell_size(c.points, c.num_points, k))
    return plan_engine(grid, k)[1]


def validation_phase(label, pts, counters, none, phase8, n20, n100):
    """Phase 9: the validation harness on the 1M torus: one sweep row
    under the mesh protocol, one mesh-free ``validate_cloud`` with the
    study, and ``run_scans`` at k=100 on a PLY of the cloud. ``n20``
    and ``n100`` are phase 3b's and 4b's launches a call."""
    import csv
    import tempfile

    import numpy as np
    import torch

    import pct_tpu_torch.mesh.normals as nm
    import pct_tpu_torch.pipeline.mesh_pipeline as mp
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.io import write_ply
    from pct_tpu_torch.mesh import mesh_energies
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.pipeline import fast_curvature
    from pct_tpu_torch.shapes import analytic_area, analytic_energies
    from pct_tpu_torch.validate import run_scans, run_sweep, validate_cloud
    from pct_tpu_torch.validate.sweep import CSV_FIELDS, STAGE_KEYS
    from pct_tpu_torch.utils import trace

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    n = len(pts)
    a_ref = analytic_area("torus")
    b_ref, _ = analytic_energies("torus")

    # --- 9a. one sweep row, the mesh protocol ---
    plan = nm.plan_normals(from_numpy(pts, device=dev).points, n, K_NORMALS)
    kv, kc = plan.kv, plan.kc
    n_mom, n_voters = len(plan.moments[0]), len(plan.rows[0])
    del plan
    meshes = []                       # what the row's mesh path received
    inner = mp.create_mesh_with_curvature

    def spy(points, **kw):
        meshes.append((np.array(points, copy=True), inner(points, **kw)))
        return meshes[-1][1]

    mp.create_mesh_with_curvature = spy
    with tempfile.TemporaryDirectory() as tmp:
        out_csv = str(Path(tmp) / "sweep.csv")
        since = trace.counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = run_sweep([N_POINTS], [1.0], ["torus"], out_csv=out_csv,
                         backup_csv=str(Path(tmp) / "backup.csv"),
                         k_neighbors=K_LIST)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        launches, by_k = read_counts(counters, since)
        mp.create_mesh_with_curvature = inner
        with open(out_csv, newline="") as f:
            header, *body = list(csv.reader(f))
    check(len(rows) == 1 and len(meshes) == 1, "one sweep row, one mesh")
    row = rows[0]
    (seen, mesh), = meshes
    check(row["status"] == "ok", f"sweep row status {row['status']!r}")
    check(row["nan_fraction"] == 0.0, "sweep row: no NaN")
    check(header == CSV_FIELDS and len(body) == 1
          and body[0][CSV_FIELDS.index("status")] == "ok",
          "the sweep CSV reads back under CSV_FIELDS with one ok row")
    check(seen.dtype == pts.dtype and np.array_equal(seen, pts),
          "the sweep row's points equal phase 8's bit for bit")
    area_err = row["computed_area"] / a_ref - 1
    bend_err = row["bending_energy"] / b_ref - 1
    stretch = row["stretching_energy"]
    log(f"[{label}] run_sweep([1M], [1.0], ['torus'], k_neighbors="
        f"{K_LIST}), mesh protocol, Taubin x10: area {row['computed_area']:.6f}"
        f" ({area_err:+.4%}; JAX package's 1M row "
        f"{JAX_MESH_TORUS['area_err']:+.4%}), bending "
        f"{row['bending_energy']:.6f} ({bend_err:+.4%}; JAX "
        f"{JAX_MESH_TORUS['bending_err']:+.4%}), stretching {stretch:.6f} "
        f"(JAX {JAX_MESH_TORUS['stretching']:.6f}); error columns: area "
        f"{row['area_error_pct']:.4f}%, bending {row['bending_error_pct']:.4f}%"
        f", stretching {row['stretching_error_pct']:.4f}")
    check(abs(area_err) <= 5e-3, "sweep area within 0.5% of analytic")
    check(abs(bend_err) <= 0.1, "sweep bending within 10% of analytic")
    check(abs(stretch) <= 0.3, "|sweep stretching| <= 0.3")
    e8 = phase8["energies"]
    mass = float(mesh_energies(
        torch.from_numpy(mesh.vertices).to(dev),
        torch.from_numpy(mesh.faces).to(dev),
        torch.from_numpy(np.abs(mesh.K)).to(dev),
        torch.from_numpy(mesh.H).to(dev)).stretching)
    d_area = abs(row["computed_area"] / e8.total_area - 1)
    d_bend = abs(row["bending_energy"] / e8.bending - 1)
    d_str = abs(stretch - e8.stretching)
    log(f"sweep row vs phase 8b: area rel {d_area:.3e}, bending rel "
        f"{d_bend:.3e}, stretching |diff| {d_str:.3e} (relative "
        f"{d_str / abs(e8.stretching):.3e}; sum |K|_f A_f {mass:.6f})")
    check(d_area <= 1e-3 and d_bend <= 1e-3,
          "sweep area and bending within 1e-3 of phase 8b")
    check(d_str <= 1e-3 * mass,
          "sweep stretching within 1e-3 sum |K|_f A_f of phase 8b")
    spec_v = vertex_buckets(mesh.vertices, K_LIST)
    n_sel = cellknn.list_select_launches(spec_v)
    want = {**none, "moments": n_mom, "epilogue": 1,
            "select_rows": n_voters + 1, "select_coords": n_sel,
            "list_fit": n_sel, **tables(7)}
    log(f"sweep row launches: {launches}; select_rows by k "
        f"{by_k['select_rows']}, select_coords by k {by_k['select_coords']}"
        f" (the row's smoothed vertices: {len(spec_v)} buckets)")
    check(launches == want, f"sweep row launches {launches}, want {want}")
    check(by_k["select_rows"] == {kv: n_voters, kc: 1},
          f"sweep select_rows by k {by_k['select_rows']}")
    check(by_k["select_coords"] == {K_LIST: n_sel},
          f"sweep select_coords by k {by_k['select_coords']}")
    del meshes, mesh, seen
    t_cols = {f"t_{s}": row[f"t_{s}"] for s in STAGE_KEYS}
    log(f"[{label}] sweep row: runtime_s {row['runtime_s']:.3f} (wall "
        f"{wall_a:.3f} s), {t_cols}; phase 8b's timings {phase8['timings']}")
    sweep_launches = launches

    # --- 9b. mesh-free validate_cloud with the study, k=20 ---
    spec20 = vertex_buckets(pts, K_LIST)
    check(len(spec20) == n20, f"the unpadded cloud's k={K_LIST} plan has "
          f"phase 3b's {n20} buckets ({len(spec20)})")
    since = trace.counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = validate_cloud(pts, shape="torus", radius=1.0, k_neighbors=K_LIST,
                         auto_k=True, use_mesh=False)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches, _ = read_counts(counters, since)
    n_sel = cellknn.list_select_launches(spec20)
    want = {**none, "select_coords": n_sel, "list_fit": n_sel, **tables(2)}
    log(f"[{label}] validate_cloud(auto_k=True, use_mesh=False, k="
        f"{K_LIST}), 1M torus: converged k {res.converged_k} (study kmax "
        f"{res.study_kmax}, converged fraction {res.converged_fraction}), "
        f"NaN {res.nan_fraction}, wall {wall_b:.3f} s, stages "
        f"{res.stage_timings}; launches {launches}")
    check(res.aborted == "", f"validate_cloud aborted: {res.aborted!r}")
    check(res.converged_k >= 10 and res.study_kmax == 99,
          "study: converged k >= 10, kmax 99")
    check(launches == want, f"validate_cloud launches {launches}, want "
          f"{want}")
    validate_launches = launches
    r = fast_curvature(from_numpy(pts, device=dev), K_LIST)
    K = r.curv.K[:n].cpu().numpy()
    H = r.curv.H[:n].cpu().numpy()
    r_k = r.kth_dist[:n].cpu().numpy()
    keep = np.isfinite(K) & np.isfinite(H) & r.exact[:n].cpu().numpy()
    del r
    areas = np.pi * r_k * r_k / K_LIST
    again = {"total_area": float(np.nansum(areas[keep])),
             "bending_energy": float(np.nansum(H[keep] ** 2 * areas[keep])),
             "stretching_energy": float(np.nansum(K[keep] * areas[keep]))}
    for key, v in again.items():
        got = getattr(res, key)
        log(f"  {key}: harness {got:.9g}, recomputed {v:.9g}")
        check(abs(got - v) <= 1e-6 * abs(v),
              f"{key} within 1e-6 of the recomputed integral")
    log(f"[{label}] mesh-free integrals vs the analytic torus (disk "
        f"weights, no limit): area {res.total_area / a_ref - 1:+.4%}, "
        f"bending {res.bending_energy / b_ref - 1:+.4%}, stretching "
        f"{res.stretching_energy:.6f} (analytic 0); certified rows "
        f"{keep.mean():.6f}")

    # --- 9c. run_scans at its defaults on a PLY of the cloud ---
    spec100 = vertex_buckets(pts, K_MOM)
    check(len(spec100) == n100, f"the unpadded cloud's k={K_MOM} plan has "
          f"phase 4b's {n100} buckets ({len(spec100)})")
    with tempfile.TemporaryDirectory() as tmp:
        scan_dir = Path(tmp) / "scans"
        scan_dir.mkdir()
        write_ply(str(scan_dir / "torus_1M.ply"), pts, binary=True)
        since = trace.counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan_rows = run_scans(str(scan_dir),
                              out_csv=str(Path(tmp) / "scans.csv"),
                              use_mesh=False, repeat=2)
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - t0
        launches, _ = read_counts(counters, since)
    want = {**none, "moments": 2 * n100, "epilogue": 2, **tables(4)}
    for sr in scan_rows:
        log(f"[{label}] run_scans row {sr['run']}: {sr['status']}, "
            f"{sr['num_points']} points, converged k {sr['converged_k']} "
            f"({sr['converged_fraction']}), area {sr['total_area']:.6f}, "
            f"bending {sr['bending_energy']:.6f}, stretching "
            f"{sr['stretching_energy']:.6f}, NaN {sr['nan_fraction']}, "
            f"runtime_s {sr['runtime_s']:.3f}, t_study {sr['t_study']}, "
            f"t_curvature {sr['t_curvature']}")
    log(f"run_scans(repeat=2) wall {wall_c:.3f} s; launches {launches}")
    check(len(scan_rows) == 2 and all(
        sr["status"] == "ok" and sr["nan_fraction"] == 0.0
        and sr["num_points"] == n for sr in scan_rows),
        "two ok scans rows with no NaN")
    check(all(scan_rows[0][key] == scan_rows[1][key] for key in (
        "total_area", "bending_energy", "stretching_energy")),
        "the two scans rows' energies equal")
    check(launches == want, f"run_scans launches {launches}, want {want}")
    log(f"[{label}] phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return {"select_coords": {"sweep_mesh": sweep_launches["select_coords"],
                              "validate_mesh_free_k20":
                                  validate_launches["select_coords"]},
            "moments": {"sweep_mesh": sweep_launches["moments"],
                        "scans_k100_two_runs": launches["moments"]},
            "epilogue": {"sweep_mesh": sweep_launches["epilogue"],
                         "scans_k100_two_runs": launches["epilogue"]},
            "select_rows": {"sweep_mesh": sweep_launches["select_rows"]},
            "list_fit": {"sweep_mesh": sweep_launches["list_fit"],
                         "validate_mesh_free_k20":
                             validate_launches["list_fit"]},
            "select_pos": {}, "band_select": {}}


def same_bits(a, b):
    """Equal shapes and equal bits (float32 compared as int32, so NaN
    payloads and signed zeros count too)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def fused_outputs(res):
    """(name, tensor) of every per-point output of a fused-style result."""
    return [*zip(("K", "H", "k1", "k2", "H2"), res.curv),
            ("normals", res.normals), ("exact", res.exact),
            ("kth_dist", res.kth_dist)]


def distributed_phase(label, cloud, pts, counters, none, walls20, walls100):
    """Phase 10: the distributed layer in a NCCL world of one on cuda:0.
    ``walls20`` and ``walls100`` are phase 3b's and 4b's
    ``fast_curvature`` walls. Returns each kernel's launches in 10a-10c."""
    import torch
    import torch.distributed as dist

    from pct_tpu_torch.distributed import (
        make_mesh,
        sharded_curvature,
        slab_curvature_unsorted,
    )
    from pct_tpu_torch.distributed.slab import (
        best_axis_order,
        probe_slab_halo,
    )
    from pct_tpu_torch.neighbors.cellknn import (all_points_spec,
                                                 list_select_launches)
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.pipeline import fused_curvature
    from pct_tpu_torch.pipeline.fused import SPLIT_TO, plan_engine

    t_phase = time.perf_counter()
    n = cloud.num_points
    mesh = make_mesh()
    check(dist.get_backend() == "nccl" and mesh.size() == 1
          and mesh.device_type == "cuda", "make_mesh(): a NCCL world of one")
    log(f"[{label}] phase 10: {mesh}, backend {dist.get_backend()}")
    launches, walls = {}, {}

    # --- 10a / 10b. sharded_curvature on fast_curvature's own layouts ---
    for tag, k, want_engine, limit, phase_walls in (
            ("10a", K_LIST, "list", 1.5e-3, walls20),
            ("10b", K_MOM, "moments", 1.0e-3, walls100)):
        cell = estimate_cell_size(cloud.points, n, k)
        engine, spec, mc, factor = plan_engine(
            build_grid(cloud.points, n, cell), k)
        check(engine == want_engine, f"{tag}: k={k} plans the {want_engine} "
              "engine")
        kw = dict(bucket_spec=spec, max_cells=mc, engine=engine,
                  split=(SPLIT_TO, factor))
        want = ({**none, "select_coords": list_select_launches(spec),
                 "list_fit": list_select_launches(spec), **tables(1)}
                if engine == "list"
                else {**none, "moments": len(spec), "epilogue": 1,
                      **tables(1)})
        res, w, got = drive(
            lambda: sharded_curvature(mesh, cloud.points, n, cell, k, **kw),
            f"{tag} sharded_curvature k={k}", counters, want)
        if engine == "list":
            list_fit_vs_plain(
                lambda: sharded_curvature(mesh, cloud.points, n, cell, k,
                                          **kw),
                f"{tag} sharded_curvature k={k}", want["list_fit"])
        launches[tag], walls[tag] = got, w
        ref, w_ref, _ = drive(
            lambda: fused_curvature(cloud.points, n, cell, k, **kw),
            f"{tag} fused_curvature k={k}", counters, want)
        for name, a in fused_outputs(res):
            check(same_bits(a, dict(fused_outputs(ref))[name]),
                  f"{tag}: {name} bit-identical to fused_curvature on the "
                  "same layout")
        mean_K = float(res.curv.K[:n][res.exact[:n]].abs().mean())
        log(f"[{label}] {tag} sharded_curvature k={k} ({engine}, "
            f"{len(spec)} buckets, split factor {factor}): every output "
            f"bit-identical to fused_curvature; stats mean |K| "
            f"{float(res.stats.mean_abs_K):.6f} (the result's, certified "
            f"rows: {mean_K:.6f}), mean |H| {float(res.stats.mean_abs_H):.6f}"
            f", NaN fraction {float(res.stats.nan_fraction)}")
        check(float(res.stats.nan_fraction) == 0.0, f"{tag}: stats NaN 0")
        accuracy(res, cloud, pts, k, limit)
        log(f"[{label}] {tag} sharded_curvature k={k}: warm wall "
            f"{statistics.median(w[1:]):.4f} s/call (cold {w[0]:.3f} s); "
            f"fused_curvature on the same layout "
            f"{statistics.median(w_ref[1:]):.4f} s; fast_curvature (phase "
            f"3b/4b) {statistics.median(phase_walls[1:]):.4f} s")
        del res, ref

    # --- 10c. the slab path: probed halo, then the distributed sort ---
    order = best_axis_order(cloud.points, n)
    cell = estimate_cell_size(cloud.points, n, K_LIST)
    cap = cloud.points.shape[0]
    halo = probe_slab_halo(build_grid(cloud.points[:, list(order)], n, cell),
                           1)
    outs = {}
    slab_spec = all_points_spec(cap + 2 * halo, K_LIST)[0]
    list_fit_vs_plain(lambda: slab_curvature_unsorted(mesh, cloud, K_LIST),
                      f"10c slab_curvature_unsorted k={K_LIST}",
                      list_select_launches(slab_spec))
    for tag, kw in (("10c", {}), ("10c_sort", {"distributed_sort": True})):
        out, w, got = drive(
            lambda: slab_curvature_unsorted(mesh, cloud, K_LIST, **kw),
            f"{tag} slab_curvature_unsorted k={K_LIST}", counters,
            {**none, "select_coords": list_select_launches(slab_spec),
             "list_fit": list_select_launches(slab_spec), **tables(1)})
        launches[tag], walls[tag], outs[tag] = got, w, out
        log(f"[{label}] {tag} slab_curvature_unsorted k={K_LIST} {kw}: warm "
            f"wall {statistics.median(w[1:]):.4f} s/call (cold {w[0]:.3f} s)")
    curv_r, nrm_r, ex_r = outs["10c"]
    curv_d, nrm_d, ex_d = outs["10c_sort"]
    check(all(same_bits(a, b) for a, b in zip(
        (*curv_r, nrm_r, ex_r), (*curv_d, nrm_d, ex_d))),
        "10c: the distributed sort's slab result bit-identical to the "
        "replicated sort's")
    single, w_ref, _ = drive(
        lambda: fused_curvature(cloud.points[:, list(order)], n, cell,
                                K_LIST),
        f"10c un-bucketed fused_curvature k={K_LIST}", counters,
        {**none, "select_coords": list_select_launches(
            all_points_spec(cap, K_LIST)[0]),
         "list_fit": list_select_launches(all_points_spec(cap, K_LIST)[0]),
         **tables(1)})
    e_s, e_1 = ex_r[:n], single.exact[:n]
    K_s, K_1 = curv_r.K[:n], single.curv.K[:n]
    close = torch.isclose(K_s, K_1, rtol=1e-5, atol=1e-7)
    bit_rows = int((K_s.view(torch.int32) == K_1.view(torch.int32)).sum())
    log(f"[{label}] 10c: the un-bucketed fused_curvature on the permuted "
        f"points: warm wall {statistics.median(w_ref[1:]):.4f} s/call")
    log(f"[{label}] 10c: axis order {order}, exact {float(e_s.float().mean())}"
        f" (un-bucketed fused_curvature: {float(e_1.float().mean())}), "
        f"rows differing in exact {int((e_s != e_1).sum())}; K bit-equal on "
        f"{bit_rows} of {n} rows, within rtol 1e-5 atol 1e-7 on "
        f"{int(close.sum())}, max |dK| {float((K_s - K_1).abs().max()):.3e}")
    check(bool(torch.equal(e_s, e_1)), "10c: exact equal to the un-bucketed "
          "fused_curvature on the permuted points")
    check(bool(close.all()), "10c: K within rtol 1e-5, atol 1e-7")
    del outs, curv_r, curv_d, single
    dist.destroy_process_group()
    check(not dist.is_initialized(), "phase 10: process group destroyed")
    log(f"[{label}] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return {name: {tag: got[name] for tag, got in launches.items()}
            for name in counters}, walls


def micro_phase(label, launches):
    """Phase 11: the TPU scripts' kernels (``pct_tpu_torch.micro``), each
    held against its plain version at its script's shapes and timed.
    ``launches`` maps each one's counter to its main-path launches.
    Returns their three kernel rows."""
    import numpy as np
    import torch
    from pct_tpu_torch.micro.moments_like import (
        moments_like,
        moments_like_plain,
    )
    from pct_tpu_torch.micro.moments_split import (
        MODES,
        SCRIPT_BUCKETS,
        SCRIPT_K,
        make_args,
        moments_variant,
        moments_variant_plain,
        variant_info,
    )
    from pct_tpu_torch.micro.select_mxu import (
        SCRIPT_SHAPE,
        make_inputs,
        select_coords_mxu,
        select_coords_mxu_plain,
    )
    from pct_tpu_torch.ops import build
    from pct_tpu_torch.ops.moments import knn_moments, stats_agreement
    from pct_tpu_torch.ops.select import knn_select_coords

    t_phase = time.perf_counter()
    # --- 11a. every moments_variant mode on the script's three buckets ---
    # the kernel each mode runs at each bucket (its path: bits a lane in
    # registers, or 0 / -1 past them), its registers and spills from the
    # build log, and its blocks an SM (CUDA's occupancy calculator)
    text = build.library_path("moments_split").with_suffix(".log").read_text()
    built = {}
    for kern in ptxas_kernels(text):
        m = re.search(r"variant_kernelILi(\d+)ELi(n?\d+)E", kern["name"])
        if m:
            built[(int(m[1]), int(m[2].replace("n", "-")))] = kern
    check(len(built) == 5 * len(MODES),
          f"moments_split: {len(built)} kernels in the build log")
    occupancy = {}
    for i, mode in enumerate(MODES):
        occupancy[mode] = []
        for _, c, m in SCRIPT_BUCKETS:
            info = variant_info(c, m, mode)
            kern = built[(i, info["path"])]
            occupancy[mode].append(dict(
                path=info["path"], registers=kern["registers"],
                spill_bytes=kern["spill_stores"] + kern["spill_loads"],
                stack=kern["stack"], blocks_per_sm=info["blocks_per_sm"],
                warps_per_sm=info["blocks_per_sm"] * info["warps"]))
        log(f"[{label}] moments_split {mode} by bucket (path, registers, "
            f"spill bytes, blocks / warps an SM): " + "; ".join(
                f"{o['path']}, {o['registers']}, {o['spill_bytes']}, "
                f"{o['blocks_per_sm']} / {o['warps_per_sm']}"
                for o in occupancy[mode]))
    k = SCRIPT_K
    per_bucket, max_err, max_ratio = [], 0.0, 0.0
    by_mode = {m: 0.0 for m in MODES}
    by_tb = {tb: 0.0 for tb in (4, 8, 16)}
    prod_ms = 0.0
    for b, (t, c, m) in enumerate(SCRIPT_BUCKETS):
        ops = make_args(t, c, m, seed=0, device="cuda")
        rows = t if b == 0 else MICRO_CUT_ROWS
        b_ratio = 0.0
        cut = [a[:rows] for a in ops]
        prod = knn_moments(*ops, k)
        for mode in MODES:
            got = moments_variant(*ops, k, mode=mode)
            torch.cuda.synchronize()
            want = moments_variant_plain(*cut, k, mode=mode)
            d, ratio, err = stats_agreement(got[:rows], want)
            check(d == 0 and ratio <= 1.0,
                  f"moments_variant {mode} bucket {b}: columns 35-47 "
                  f"bit-identical ({d} rows differ), sums within "
                  f"count_le^2 2^-24 (ratio {ratio:.4g})")
            max_err, b_ratio = max(max_err, err), max(b_ratio, ratio)
            if mode == "full":
                d, ratio, _ = stats_agreement(got, prod)
                check(d == 0 and ratio <= 1.0, f"moments_variant full bucket "
                      f"{b} against knn_moments ({d} rows, ratio {ratio:.4g})")
                full = got
            by_mode[mode] += event_ms(
                lambda mode=mode: moments_variant(*ops, k, mode=mode),
                TIMED_REPS)
            del got, want
        for tb in by_tb:
            check(same_bits(moments_variant(*ops, k, tb=tb), full),
                  f"moments_variant full tb={tb} bucket {b}: tb=1's bits")
            by_tb[tb] += event_ms(lambda tb=tb: moments_variant(*ops, k,
                                                                tb=tb),
                                  TIMED_REPS)
        prod_ms += event_ms(lambda: knn_moments(*ops, k), TIMED_REPS)
        max_ratio = max(max_ratio, b_ratio)
        lt, le = full[..., 36], full[..., 37]
        members = int(torch.where(lt < k, le, lt).sum())
        pairs = c * int(ops[4].sum())
        nb = nbytes(*ops, full)
        b_ms, b_by = bound(pairs, PAIR_FLOPS, MEMBER_FLOPS * members, nb)
        per_bucket.append(dict(
            bucket=b, cells=t, capacity=c, M=m, pairs=pairs,
            members=members, bytes=nb, bound_ms=b_ms, bound_by=b_by,
            ratio=b_ratio, rows_checked=rows,
            library_ms=kthvalue_yardstick(ops, k, full),
            ms=event_ms(lambda: moments_variant(*ops, k), TIMED_REPS),
            plain_ms=event_ms(lambda: moments_variant_plain(*ops, k), 1)))
        del ops, cut, prod, full
    log_buckets(label, "moments_split full", per_bucket)
    for mode, ms in by_mode.items():
        log(f"[{label}] moments_split {mode} tb=1: {ms:.3f} ms over the 3 "
            f"buckets (production knn_moments {prod_ms:.3f} ms)")
    for tb, ms in by_tb.items():
        log(f"[{label}] moments_split full tb={tb}: {ms:.3f} ms")
    split = kernel_row(
        "moments_split", "pct_tpu_torch/csrc/moments_split.cu",
        "scripts/micro_moments_split.py:55", launches["moments_split"],
        max_err, per_bucket,
        sum(r["pairs"] * PAIR_FLOPS + r["members"] * MEMBER_FLOPS
            for r in per_bucket))
    split.update(
        script="scripts/torch_micro_moments_split.py", max_err_ratio=max_ratio,
        ms_by_mode=by_mode, ms_full_by_tb=by_tb, production_ms=prod_ms,
        rows_checked=[r["rows_checked"] for r in per_bucket],
        library_call="torch.kthvalue of the prebuilt masked d2 (partial: "
                     "tau only)")

    t_11a = time.perf_counter() - t_phase
    # --- 11b. the tensor-core coords select at the script's shape ---
    t_11b = time.perf_counter()
    T, C, M, k = SCRIPT_SHAPE
    ops = make_inputs(T, C, M, seed=0, device="cuda")
    got = select_coords_mxu(*ops, k)
    torch.cuda.synchronize()
    want = select_coords_mxu_plain(*ops, k)
    for name, a, w in zip(("dists", "nbrs", "rows"), got, want):
        check(same_bits(a, w), f"select_coords_mxu {name} bit-identical to "
              "its plain version (missing slots: slot 0)")
    d_p, n_p = knn_select_coords(*ops, k)
    found = d_p < 1e18
    check(same_bits(got[0], d_p) and bool(
        (got[1].view(torch.int32) == n_p.view(torch.int32)).all(-1)[found]
        .all()), "select_coords_mxu: knn_select_coords' distances, and its "
        "coordinates on found slots")
    mxu_err = max(float((a.float() - w.float()).abs().max())
                  for a, w in zip(got, want))
    pairs = C * int(ops[4].sum())
    nb = nbytes(*ops, *got)
    # the extraction: a one-hot row times P (M x 4) a round, on the bf16
    # tensor cores (the three-piece cut is the design's, not the work's)
    ext_flops = 8 * k * C * M * T
    b_ms, b_by = bound(pairs, PAIR_FLOPS, 0, nb, ext_flops)
    lib_ms = topk_yardstick(
        ops, k, got[0], got[1], lambda pos: torch.gather(
            ops[1], 1, pos.reshape(T, C * k, 1).expand(-1, -1, 3))
        .reshape(T, C, k, 3))
    mxu = dict(bucket=0, cells=T, capacity=C, M=M, pairs=pairs, bytes=nb,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               ms=event_ms(lambda: select_coords_mxu(*ops, k), TIMED_REPS),
               plain_ms=event_ms(lambda: select_coords_mxu_plain(*ops, k), 1))
    base_ms = event_ms(lambda: knn_select_coords(*ops, k), TIMED_REPS)
    t_11b = time.perf_counter() - t_11b
    log(f"[{label}] select_coords_mxu at (T, C, M, k) = {SCRIPT_SHAPE}: "
        f"{int(found.sum())} of {found.numel()} slots found; kernel "
        f"{mxu['ms']:.3f} ms ({T * C / mxu['ms'] / 1e3:.2f} Mq/s; earlier "
        f"design {EARLIER_MS['select_coords_mxu']} ms) against "
        f"knn_select_coords {base_ms:.3f} ms ({T * C / base_ms / 1e3:.2f} "
        f"Mq/s), plain {mxu['plain_ms']:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), library yardstick (partial) {fmt_ms(lib_ms)}")
    mxu_row = kernel_row(
        "select_coords_mxu", "pct_tpu_torch/csrc/select_mxu.cu",
        "scripts/micro_select_mxu.py:30", launches["select_coords_mxu"],
        mxu_err, [mxu], pairs * PAIR_FLOPS, ext_flops)
    mxu_row.update(
        script="scripts/torch_micro_select_mxu.py", production_ms=base_ms,
        library_call="torch.topk over int64 (d2 bits << 32 | m) keys of the "
                     "prebuilt masked d2 (partial: no d2, no extraction)")
    del ops, got, want, d_p, n_p

    # --- 11c. the moments-shaped toy kernel at the script's shapes ---
    t_11c = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 off for bmm")
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.standard_normal(
        (8, n, 256)).astype(np.float32)).cuda() for n in (266, 1024))
    got = moments_like(x, y)
    torch.cuda.synchronize()
    want = moments_like_plain(x, y)
    check(same_bits(got, want),
          "moments_like bit-identical to its plain version")
    like_err = float((got - want).abs().max())
    T, C, M = x.shape[0], x.shape[1], y.shape[1]
    nb = nbytes(x, y, got)
    b_ms, b_by = bound(0, 0, 2 * T * C * M * 256, nb)

    def bmm():
        return torch.bmm(x, y.transpose(1, 2))

    # one call as every kernel is timed (the host's enqueue in it), and
    # the device time alone: the wrapper's Python takes longer than the
    # kernel
    like = dict(bucket=0, cells=T, capacity=C, M=M, pairs=0, bytes=nb,
                bound_ms=b_ms, bound_by=b_by,
                library_ms=event_ms(bmm, TIMED_REPS),
                ms=event_ms(lambda: moments_like(x, y), TIMED_REPS),
                plain_ms=event_ms(lambda: moments_like_plain(x, y), 3))
    dev = dict(device_ms=device_ms(lambda: moments_like(x, y), TIMED_REPS),
               library_device_ms=device_ms(bmm, TIMED_REPS))
    # the bit rule's FMUL + FADD a multiply-add: twice the flop bound
    ceiling_ms = 2 * 2 * T * C * M * 256 / FP32_PEAK * 1e3
    log(f"[{label}] moments_like at (T, C, M) = ({T}, {C}, {M}): kernel "
        f"{like['ms']:.4f} ms a call, {dev['device_ms']:.4f} ms on the "
        f"device (earlier design {EARLIER_MS['moments_like']} ms a call), "
        f"plain {like['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"no-FMA ceiling {ceiling_ms:.4f} ms), torch.bmm of the product "
        f"alone {like['library_ms']:.4f} ms a call, "
        f"{dev['library_device_ms']:.4f} ms on the device")
    like_row = kernel_row(
        "moments_like", "pct_tpu_torch/csrc/moments_like.cu",
        "scripts/repro_mosaic_cold.py:67", launches["moments_like"], like_err,
        [like], 2 * T * C * M * 256)
    like_row.update(
        script="scripts/torch_repro_cold_build.py", **dev,
        library_call="torch.bmm of x and y^T, TF32 off (partial: the "
                     "product only)")
    t_end = time.perf_counter()
    log(f"[{label}] phase 11 took {t_end - t_phase:.1f} s (11a {t_11a:.1f}, "
        f"11b {t_11b:.1f}, 11c {t_end - t_11c:.1f})")
    return [split, mxu_row, like_row]


def knn_buckets(points, n, k):
    """The buckets ``knn_cloud_grid(k)`` runs on a cloud's padded points
    (its probe: one rows launch a bucket)."""
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size

    grid = build_grid(points, n, estimate_cell_size(points, n, k))
    return cellknn.probe_grid_buckets(
        grid, capacity_cap=cellknn.library_capacity_cap(k))[0]


def close_to_ascii(got, want):
    """``got``, read back from an ASCII PLY, equals ``want`` up to the
    writer's 8 significant digits (``%.8g``) and the float32 parse."""
    import numpy as np

    want = np.asarray(want, np.float64)
    return bool((np.abs(np.asarray(got, np.float64) - want)
                 <= 2e-7 * np.abs(want)).all())


def facade_phase(label, cloud, pts, counters, none, n_knn20):
    """Phase 12: the reference-API façade, the command line and the demos
    on the 1M torus, each path driven with the counts set to 0 just
    before it and read just after. ``n_knn20`` is phase 5b's rows
    launches a call. Neither ``viz`` nor matplotlib is imported."""
    import tempfile

    import numpy as np

    import pct_tpu_torch.io as tio
    import pct_tpu_torch.mesh.normals as nm
    from pct_tpu_torch import cli, compat
    from pct_tpu_torch.demos import (
        explicit_surfaces_demo,
        implicit_surfaces_demo,
    )
    from pct_tpu_torch.mesh import estimate_and_orient_normals, voxel_downsample
    from pct_tpu_torch.neighbors import knn_cloud_grid
    from pct_tpu_torch.pipeline import curvature_pipeline
    from pct_tpu_torch.shapes import analytic_curvatures

    t_phase = time.perf_counter()
    n = len(pts)
    Ka, Ha = analytic_curvatures("torus", pts)
    launches = {}     # path -> launches of its driven run
    walls = {}        # path -> wall of each driven call (s)

    def counted(path, call, want, warm=0, want_by_k=None):
        """``drive``: counts to 0, ``1 + warm`` calls, each holding
        ``want`` launches (and ``want_by_k``); the last call's result."""
        res, walls[path], launches[path] = drive(
            call, path, counters, {**none, **want}, warm=warm,
            want_by_k=want_by_k)
        return res

    def no_plots():
        loaded = sorted(m for m in sys.modules if m.split(".")[0] ==
                        "matplotlib" or m.startswith("pct_tpu_torch.viz"))
        check(not loaded, f"phase 12 loaded no plotting module ({loaded})")

    def host(t):
        return t[:n].cpu().numpy()

    no_plots()
    # the references, each the call of an earlier phase (not counted)
    ref = knn_cloud_grid(cloud, K_LIST)[0]                       # 5b
    idx_5b, d_5b = host(ref.indices), host(ref.dists)
    ref = curvature_pipeline(cloud, K_LIST)                      # 5c
    K_5c, H_5c, nrm_5c = host(ref.curv.K), host(ref.curv.H), host(ref.normals)
    out, kept = voxel_downsample(cloud.points, n, VOXEL, mode="first")  # 7c
    ds_7c = out[:int(kept)].cpu().numpy()
    del ref, out

    # --- 12a. the façade ---
    pc = counted("construction", lambda: compat.PointCloud(
        points=pts, k_neighbors=K_LIST), tables(0), warm=1)
    check(pc.cloud.points.device.type == "cuda" and pc.num_points == n,
          "the façade's cloud lives on the card")
    p64 = pts.astype(np.float64)
    log(f"façade: {n} points, capacity {pc.cloud.capacity}; norms l1 "
        f"{pc.l1_norm!r}, l2 {pc.l2_norm!r}, linf {pc.linf_norm!r}")
    check(pc.l2_norm == float(np.linalg.norm(p64, 2))
          and pc.l1_norm == float(np.linalg.norm(p64, 1))
          and pc.linf_norm == float(np.linalg.norm(p64, np.inf)),
          "façade norms = numpy's matrix norms")

    def plant_and_fit():
        pc.quadratic_coefficients = None          # refit on every call
        idx, d = pc.plant_kdtree()
        K, H = pc.compute_pointwise_explicit_quadratic_curvature()
        return idx, d, K, H

    idx, d, K, H = counted("plant_kdtree + explicit", plant_and_fit,
                           {"select_rows": n_knn20, **tables(2)}, warm=1)
    check(isinstance(idx, np.ndarray) and idx.shape == (n, K_LIST)
          and isinstance(K, np.ndarray), "numpy attributes of (n, k)")
    check(np.array_equal(idx, idx_5b) and np.array_equal(d, d_5b),
          "plant_kdtree: indices and dists bit-identical to phase 5b")
    relK = np.abs(K - Ka) / np.abs(Ka).max()
    med = float(np.median(relK))
    log(f"façade explicit k={K_LIST}: K/H bit-identical to phase 5c "
        f"{np.array_equal(K, K_5c)} / {np.array_equal(H, H_5c)}, NaN "
        f"{int(np.isnan(K).sum())}, median scale-relative K error {med:.4e}")
    check(np.array_equal(K, K_5c) and np.array_equal(H, H_5c),
          "explicit chain: K and H bit-identical to phase 5c")
    check(not np.isnan(K).any() and med <= 1.5e-3,
          "explicit chain: no NaN, median K error <= 1.5e-3")
    check(np.array_equal(pc.estimated_normals, nrm_5c),
          "explicit chain: fit normals bit-identical to phase 5c")

    K, H = counted("implicit", pc.compute_pointwise_implicit_quadric_curvature,
                   tables(0))
    med_K = float(np.median(np.abs(K - Ka) / np.abs(Ka).max()))
    med_H = float(np.median(np.abs(np.abs(H) - np.abs(Ha)) / np.abs(Ha)))
    log(f"façade implicit k={K_LIST} (exact): NaN {int(np.isnan(K).sum())}, "
        f"median scale-relative K error {med_K:.4e}, median relative |H| "
        f"error {med_H:.4e}")
    check(not np.isnan(K).any() and not np.isnan(H).any(),
          "implicit chain: no NaN")
    check(med_K <= 7e-3 and med_H <= 1.25e-2,
          "implicit chain: median K <= 7e-3, |H| <= 1.25e-2")

    k1, k2 = counted("pca", lambda: pc.
                     principal_curvatures_via_principal_component_analysis(
                         K_LIST), {"select_rows": n_knn20, **tables(2)})
    check(k1.shape == (n,) and not np.isnan(k1).any()
          and not np.isnan(k2).any() and bool((k1 >= k2).all()),
          "PCA: k1 >= k2, no NaN")

    plan = nm.plan_normals(pc.cloud.points, n, K_NORMALS)
    kv, kc = plan.kv, plan.kc
    want_n = {"moments": len(plan.moments[0]), "epilogue": 1,
              "select_rows": len(plan.rows[0]) + 1, **tables(5)}
    want_k = {"select_rows": {kv: len(plan.rows[0]), kc: 1}}
    log(f"façade normals k={K_NORMALS}: stride {plan.stride} (phase 7a's "
        f"cloud: {nm.plan_normals(cloud.points, n, K_NORMALS).stride}), "
        f"launches a call {want_n}, by k {want_k['select_rows']}")
    del plan
    nrm = counted("compute_normals", lambda: pc.compute_normals(K_NORMALS),
                  want_n, warm=1, want_by_k=want_k)
    nrm_7a = host(estimate_and_orient_normals(cloud, K_NORMALS))
    agree = tube_normal_agreement(nrm, pts)
    log(f"compute_normals vs phase 7a's call (capacity {cloud.capacity}): "
        f"bit-identical rows {float((nrm == nrm_7a).all(1).mean()):.6f}; "
        f"tube-normal agreement {agree:.6f}")
    check(np.array_equal(nrm, nrm_7a), "compute_normals bit-identical to "
          "phase 7a's estimate_and_orient_normals")
    del nrm_7a

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        path = str(tmp / "facade.ply")
        counted("export", lambda: pc.export_ply_with_curvature_and_normals(
            path), tables(0))
        back = tio.read_ply(path)
        check(close_to_ascii(back.points, pc.points)
              and close_to_ascii(back.normals, pc.normals)
              and close_to_ascii(back.vertex_props["gaussian_curvature"],
                                 pc.K_quadratic)
              and close_to_ascii(back.vertex_props["mean_curvature"],
                                 pc.H_quadratic),
              "export_ply_with_curvature_and_normals read back equal")
        del back

        n100 = len(knn_buckets(pc.cloud.points, n, K_MOM))
        sv = counted("estimate_curvature", lambda: compat.estimate_curvature(
            pts), {"select_rows": n100, **tables(2)})
        log(f"estimate_curvature(k={K_MOM}): {n100} rows launches, min "
            f"{float(sv.min()):.4e}, median {float(np.median(sv)):.4e}")
        check(sv.shape == (n,) and not np.isnan(sv).any()
              and bool((sv >= 0).all()), "estimate_curvature >= 0, no NaN")
        del sv, pc

        ds = counted("downsample=True", lambda: compat.PointCloud(
            points=pts, downsample=True, voxel_size=VOXEL), tables(0))
        log(f"PointCloud(downsample=True, voxel {VOXEL}): {ds.num_points} "
            f"kept, phase 7c's first mode {len(ds_7c)}")
        check(ds.num_points == len(ds_7c) and np.array_equal(ds.points, ds_7c),
              "downsample=True keeps phase 7c's rows")
        del ds

        # --- 12b. the command line, in-process ---
        inp, out, out_ds = (str(tmp / name) for name in (
            "torus.ply", "curv.ply", "down.ply"))
        tio.write_ply(inp, pts, binary=True)
        io_s = {}

        def timed(name, fn):
            def wrapped(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    io_s[name] = time.perf_counter() - t0
            return wrapped

        saved = tio.load_points, tio.write_ply
        tio.load_points = timed("read", saved[0])
        tio.write_ply = timed("write", saved[1])
        try:
            counted("cli curvature", lambda: cli.main(
                ["curvature", inp, out, "--k", str(K_LIST)]),
                {"select_rows": n_knn20, **tables(2)})
        finally:
            tio.load_points, tio.write_ply = saved
        io_s["compute"] = walls["cli curvature"][0] - io_s["read"] \
            - io_s["write"]
        back = tio.read_ply(out)
        check(close_to_ascii(back.points, pts)
              and close_to_ascii(back.vertex_props["gaussian_curvature"], K_5c)
              and close_to_ascii(back.vertex_props["mean_curvature"], H_5c),
              "cli curvature: points, K and H read back equal phase 5c's")
        del back
        counted("cli downsample", lambda: cli.main(
            ["downsample", inp, out_ds, "--voxel-size", str(VOXEL)]),
            tables(0))
        back = tio.read_ply(out_ds).points
        check(back.shape == ds_7c.shape and close_to_ascii(back, ds_7c),
              "cli downsample: the rows written equal phase 7c's")

    # --- 12c. the demos, on the card against the CPU ---
    for name, mod in (("explicit demo", explicit_surfaces_demo),
                      ("implicit demo", implicit_surfaces_demo)):
        got = counted(name, mod.run, tables(0))
        want = mod.run(device="cpu")
        diff = max(abs(a - b) for key in want
                   for a, b in zip(got[key], want[key]))
        log(f"{name}: card vs CPU max |d| {diff:.3e}; {got}")
        check(list(got) == list(want) and diff <= 1e-5,
              f"{name}: card within 1e-5 of the CPU")
        if mod is explicit_surfaces_demo:
            check(got["paraboloid"][0] > 0.5 and got["saddle"][0] < -0.5
                  and abs(got["saddle"][1]) < 0.05
                  and abs(got["plane"][0]) < 1e-3
                  and abs(got["monkey_saddle"][0]) < 0.2,
                  "explicit demo: the JAX tests' sign rules")
        else:
            check(all(got[s][0] < 1e-3 for s in ("sphere", "cylinder",
                                                 "plane"))
                  and abs(got["sphere"][1] / (1 / 1.5**2) - 1) <= 0.05,
                  "implicit demo: the JAX tests' residual rules")
    no_plots()

    log(f"[{label}] phase 12 warm walls, 1M torus (s, the last of "
        "the driven calls): " + ", ".join(
            f"{path} {w[-1]:.4f}" for path, w in walls.items()))
    log(f"[{label}] cli curvature, 1M torus: wall "
        f"{walls['cli curvature'][0]:.4f} s = PLY read {io_s['read']:.4f} "
        f"+ compute {io_s['compute']:.4f} + PLY write {io_s['write']:.4f}")
    log(f"[{label}] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return {name: {path: got[name] for path, got in launches.items()
                   if got[name]} for name in counters}


def knn_layout(cloud, k):
    """``knn_cloud_grid(k)``'s grid, cell table and bucket probe."""
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size

    n = cloud.num_points
    grid = build_grid(cloud.points, n, estimate_cell_size(cloud.points, n, k))
    spec, mc = cellknn.probe_grid_buckets(
        grid, capacity_cap=cellknn.library_capacity_cap(k))
    log(f"knn_cloud_grid k={k}: {len(spec)} buckets "
        f"{[tuple(s) for s in spec]}")
    return grid, cellknn.compact_cells(grid, mc), spec


def wide_vs_plain(cellknn, grid, cells, spec, k, label, timed=False,
                  cut_rows=None):
    """The rows, positions and coords kernels against their plain
    versions, bit for bit, on every bucket of ``knn_cloud_grid(k)``'s
    probe (the operands ``knn_cellwise_bucketed`` gives them); with
    ``cut_rows`` on the first cut_rows cell rows of each bucket only;
    untimed, past WIDE_PLAIN_BUDGET_S of plain-version time the later
    buckets keep their first WIDE_LATE_ROWS cell rows. With ``timed``,
    each bucket's kernel ms (CUDA events, full bucket; with ``cut_rows``
    also on the compared rows), the plain version's ms (the compared
    call, one run) and the partial ``torch.topk`` yardstick's on the
    compared rows, and the bound of the full bucket. Returns ({name:
    per-bucket rows}, largest abs error, each bucket's layout)."""
    import torch

    from pct_tpu_torch.ops.select import (
        knn_select,
        knn_select_coords,
        knn_select_rows,
        select_coords_plain,
        select_layout,
        select_pos_plain,
        select_rows_plain,
    )

    kernels = {"select_rows": (knn_select_rows, select_rows_plain, 1),
               "select_pos": (knn_select, select_pos_plain, 1),
               "select_coords": (knn_select_coords, select_coords_plain, 3)}
    per = {name: [] for name in kernels}
    layouts = []
    rows = mismatched = 0
    max_err = plain_s = 0.0
    for b, (sp, args) in enumerate(cellknn.bucketed_tile_args(
            grid, cells, spec)):
        ops = cellknn._select_operands(grid, args, sp.capacity, sp.cand_cap,
                                       with_ids=True)[0]
        T, C = ops[0].shape[:2]
        M = ops[1].shape[1]
        lay = select_layout(sp.capacity, M, k)
        layouts.append(lay)
        log(f"  {label} bucket {b}: C {sp.capacity}, M {M}, "
            f"{int((args[0] != cellknn.PAD_ID).sum())} cells: "
            f"{'staged' if lay > 0 else 'streamed'}, {abs(lay)} shared "
            f"bytes a block")
        if not timed and plain_s > WIDE_PLAIN_BUDGET_S and cut_rows is None:
            cut_rows = WIDE_LATE_ROWS
            log(f"  {label}: plain-version time so far {plain_s:.1f} s > "
                f"{WIDE_PLAIN_BUDGET_S} s, the later buckets compare their "
                f"first {WIDE_LATE_ROWS} cell rows")
        cmp_ops = ops if cut_rows is None else tuple(a[:cut_rows]
                                                     for a in ops)
        count = args[2].to(torch.int64)
        tot = torch.clamp_max(args[4].sum(-1), sp.cand_cap).to(torch.int64)
        pairs = int((count * tot).sum())
        lib_ms = None
        if timed:
            d_pos, pos = knn_select(*cmp_ops, k)
            lib_ms = topk_yardstick(cmp_ops, k, d_pos, pos)
            del d_pos, pos
        for name, (kernel, plain, width) in kernels.items():
            d_k, w_k = kernel(*cmp_ops, k)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            d_p, w_p = plain(*cmp_ops, k)
            z.record()
            torch.cuda.synchronize()
            plain_s += time.perf_counter() - t0
            T_c = d_k.shape[0]
            same = ((d_k.view(torch.int32) == d_p.view(torch.int32))
                    & (w_k.view(torch.int32) == w_p.view(torch.int32))
                    .reshape(T_c, C, k, -1).all(-1)).all(-1)
            rows += same.numel()
            mismatched += int((~same).sum())
            max_err = max(max_err, float((d_k - d_p).abs().max()),
                          float((w_k - w_p).abs().max()))
            del d_k, w_k, d_p, w_p
            if timed:
                nb = nbytes(*ops) + T * C * k * 4 * (1 + width)
                b_ms, b_by = bound(pairs, PAIR_FLOPS, 0, nb)
                rec = dict(
                    bucket=b, cells=int((args[0] != cellknn.PAD_ID).sum()),
                    capacity=sp.capacity, M=M, cell_rows=T, pairs=pairs,
                    bytes=nb, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, layout_bytes=lay,
                    ms=event_ms(lambda f=kernel: f(*ops, k), 3),
                    plain_ms=a.elapsed_time(z))
                if cut_rows is not None:
                    rec["compared_rows"] = T_c
                    rec["ms_compared_rows"] = event_ms(
                        lambda f=kernel: f(*cmp_ops, k), 3)
                per[name].append(rec)
                torch.cuda.empty_cache()
    log(f"{label} vs plain: {rows} query rows compared, {mismatched} "
        f"mismatched, max abs err {max_err}, plain-version time "
        f"{plain_s:.1f} s")
    check(mismatched == 0 and max_err == 0.0,
          f"{label}: rows, positions and coords kernels bit-identical to "
          "their plain versions")
    return per, max_err, layouts


def band_inputs(cloud):
    """Phase 5e's band operands on the 1M torus at k=20: the grid, its
    probed cells and row blocks, the fitted band and the operands with
    the cells' counts."""
    from pct_tpu_torch.experimental import build_row_blocks
    from pct_tpu_torch.experimental.band_knn import band_operands
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size

    n = cloud.num_points
    grid = build_grid(cloud.points, n,
                      estimate_cell_size(cloud.points, n, K_LIST))
    cells, cap, mc, cand_cap = cellknn.probe_grid(grid)
    blocks = build_row_blocks(cells, BAND_BC)
    band, _ = fitted_band(grid, cells, blocks, cap, BAND_BC)
    ops, _, counts, band_ok = band_operands(grid, cells, blocks, cap, BAND_BC,
                                            band)
    check(bool(band_ok.all()), "every row block's runs fit the band")
    return ops, counts, cap, band


def wide_k_phase(label, cloud, pts, counters, none):
    """Phase 14: the selects past 128 neighbors on the 1M torus. The
    kernels at k = 129, 200, 256 (every bucket) and 512, 1024 (the first
    WIDE_CUT_ROWS cell rows of every bucket) against their plain versions,
    the band kernel at k = 129 and 200 on phase 5e's operands; then each
    entry point at k = 200 driven with the counts set to 0 just before it
    and read just after, and ``knn_cloud_grid`` at k = 1024 once."""
    import numpy as np
    import torch

    from pct_tpu_torch import compat
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.curvature.pca import surface_variation
    from pct_tpu_torch.experimental import knn_band_select
    from pct_tpu_torch.neighbors import cellknn, knn_cloud_grid
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.pipeline import curvature_pipeline, fast_curvature

    t_phase = time.perf_counter()
    n = cloud.num_points
    out = {"walls": {}}

    # --- 14a. the kernels against their plain versions ---
    for k in WIDE_KS:
        grid, cells, spec = knn_layout(cloud, k)
        cut = WIDE_CUT_ROWS if k > 256 else None
        per, err, layouts = wide_vs_plain(
            cellknn, grid, cells, spec, k, f"selects k={k}",
            timed=(k == K_WIDE), cut_rows=cut)
        out.setdefault("max_err", {})[k] = err
        out.setdefault("layouts", {})[k] = layouts
        if k == K_WIDE:
            out["buckets"], out["spec"] = per, spec
        del grid, cells
    ops, counts, cap, band = band_inputs(cloud)
    band_err = 0.0
    for k in (129, K_WIDE):
        for mode_counts in (None, counts):
            got, blocks, rows_checked, err, plain_s, _ = band_vs_plain(
                ops, k, BAND_BC, cap, band, mode_counts,
                budget_s=WIDE_BAND_PLAIN_S)
            band_err = max(band_err, err)
            if k == K_WIDE and mode_counts is not None:
                out["band_plain"] = (plain_s * 1e3, blocks)
            del got
    nb = ops[3].shape[0]
    pairs = int((ops[5].sum(-1).to(torch.int64) * counts).sum())
    band_ms = event_ms(lambda: knn_band_select(
        *ops, k=K_WIDE, bc=BAND_BC, cap=cap, band=band, counts=counts),
        TIMED_REPS)
    s_all = nb * BAND_BC * cap
    nb_bytes = nbytes(*ops, counts) + s_all * (K_WIDE * 8 + 4)
    b_ms, b_by = bound(pairs, PAIR_FLOPS, 0, nb_bytes)
    plain_ms, plain_blocks = out["band_plain"]
    out["band"] = dict(ms=band_ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None, max_err=band_err,
                       plain_blocks=plain_blocks, blocks=nb)
    log(f"[{label}] band kernel k={K_WIDE} (counts): {band_ms:.3f} ms/call "
        f"over {nb} blocks, band {band}; plain {plain_ms:.1f} ms over "
        f"{plain_blocks} of {nb} blocks; bound {b_ms:.4f} ms ({b_by})")
    del ops, counts
    torch.cuda.empty_cache()

    # --- 14b. the entry points at k = 200 ---
    k = K_WIDE
    nk = len(out["spec"])
    want = {**none, "select_rows": nk, **tables(2)}
    by_k = {"select_rows": {k: nk}}
    knn, out["walls"]["knn_cloud_grid"], launches = drive(
        lambda: knn_cloud_grid(cloud, k)[0], f"knn_cloud_grid k={k}",
        counters, want, warm=2, want_by_k=by_k)
    out["launches"] = launches["select_rows"]
    exact = float(knn.exact[:n].float().mean())
    log(f"knn_cloud_grid k={k}: exact {exact}, valid "
        f"{float(knn.valid[:n].float().mean())}")
    check(bool(knn.exact[:n].all()) and bool(knn.valid[:n].all()),
          f"knn_cloud_grid k={k}: exact 1.0 and every slot found after the "
          "repair")
    check(tuple(knn.indices.shape) == (cloud.capacity, k),
          f"knn_cloud_grid k={k}: output shape")
    kth_vs_bruteforce(types.SimpleNamespace(
        exact=knn.exact, kth_dist=knn.dists[:, -1]), cloud, k)

    grid = build_grid(cloud.points, n, estimate_cell_size(cloud.points, n, k))
    probe, _ = cellknn.probe_grid_buckets(grid, capacity_cap=max(256, 4 * k))
    check(not any(cellknn.list_engine_ok(sp.capacity, sp.cand_cap, k)
                  for sp in probe),
          f"implicit k={k} takes the staged route (knn_cloud_grid)")
    del grid
    imp, out["walls"]["implicit"], _ = drive(
        lambda: fast_curvature(cloud, k, method="implicit"),
        f"implicit k={k}", counters, {**want, **tables(3)}, warm=2,
        want_by_k=by_k)
    out["implicit_err"] = implicit_accuracy(imp, cloud, pts, k)
    check(bool((imp.kth_dist[:n] == knn.dists[:n, -1]).all()),
          f"implicit k={k}: kth distance is knn_cloud_grid's")
    del imp

    pipe, out["walls"]["curvature_pipeline"], _ = drive(
        lambda: curvature_pipeline(cloud, k), f"curvature_pipeline k={k}",
        counters, want, warm=2, want_by_k=by_k)
    check(torch.equal(pipe.neighbor_indices[:n], knn.indices[:n])
          and torch.equal(pipe.neighbor_dists[:n], knn.dists[:n]),
          f"curvature_pipeline k={k}: neighbors bit-identical to "
          "knn_cloud_grid's")
    K = pipe.curv.K[:n].cpu().numpy()
    from pct_tpu_torch.shapes import analytic_curvatures

    Ka, _ = analytic_curvatures("torus", pts)
    out["pipeline_err"] = float(np.median(np.abs(K - Ka) / np.abs(Ka).max()))
    log(f"curvature_pipeline k={k}: NaN fraction {float(np.isnan(K).mean())}"
        f", median scale-relative K error {out['pipeline_err']:.4e}")
    check(not np.isnan(K).any(), f"curvature_pipeline k={k}: no NaN")
    del pipe, K

    fc = from_numpy(pts, device=cloud.points.device)   # compat's padding
    k_est = int(min(max(n * 0.025, 3), k, n - 1))      # its default fraction
    n_est = len(knn_buckets(fc.points, n, k_est))
    sv, out["walls"]["estimate_curvature"], _ = drive(
        lambda: compat.estimate_curvature(pts, max_neighbors=k),
        f"estimate_curvature max_neighbors={k}", counters,
        {**none, "select_rows": n_est, **tables(2)}, warm=1,
        want_by_k={"select_rows": {k_est: n_est}})
    ref = knn_cloud_grid(fc, k_est)[0]
    want_sv = surface_variation(fc.points, ref.indices[:n]).cpu().numpy()
    check(sv.shape == (n,) and not np.isnan(sv).any()
          and bool((sv >= 0).all()), f"estimate_curvature k={k}: >= 0, no "
          "NaN")
    check(bool((sv == want_sv).all()), f"estimate_curvature k={k}: surface "
          "variation of knn_cloud_grid's neighbors, bit for bit")
    log(f"estimate_curvature(max_neighbors={k}): k={k_est}, {n_est} rows "
        f"launches a call, median {float(np.median(sv)):.4e}")
    del sv, ref, fc, knn
    torch.cuda.empty_cache()

    # --- 14c. knn_cloud_grid at k = 1024, once ---
    k = WIDE_KS[-1]
    grid = build_grid(cloud.points, n, estimate_cell_size(cloud.points, n, k))
    spec1024, _ = cellknn.probe_grid_buckets(
        grid, capacity_cap=cellknn.library_capacity_cap(k))
    del grid
    big, walls, _ = drive(
        lambda: knn_cloud_grid(cloud, k)[0], f"knn_cloud_grid k={k}",
        counters, {**none, "select_rows": len(spec1024), **tables(2)}, warm=0,
        want_by_k={"select_rows": {k: len(spec1024)}})
    out["walls"]["knn_cloud_grid k=1024"] = walls
    out_bytes = nbytes(big.indices, big.dists)
    exact = float(big.exact[:n].float().mean())
    log(f"[{label}] knn_cloud_grid k={k}, 1M torus: wall {walls[0]:.3f} s "
        f"(one call), {out_bytes / 1e9:.2f} GB of indices and distances, "
        f"exact {exact}, valid {float(big.valid[:n].float().mean())}, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    check(bool(big.exact[:n].all()), f"knn_cloud_grid k={k}: exact 1.0")
    kth_vs_bruteforce(types.SimpleNamespace(
        exact=big.exact, kth_dist=big.dists[:, -1]), cloud, k)
    del big
    torch.cuda.empty_cache()
    log(f"[{label}] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return out


def device_sort_check(cloud, grid, cells, spec, k):
    """Past 16,384 winners a query the block class sorts over a
    device-memory workspace: k = ``k`` on the largest bucket of ``spec``
    cut to its HUGE_CUT_ROWS cell rows with the most candidates and
    HUGE_SORT_QUERIES query slots,
    every kernel bit-identical to its plain version, and some query with
    more than 16,384 winners (so the device-memory merge steps ran).
    Returns the largest abs error."""
    import torch

    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.ops.select import (
        SORT_KEYS,
        knn_select,
        knn_select_coords,
        knn_select_rows,
        select_coords_plain,
        select_layout,
        select_pos_plain,
        select_rows_plain,
    )

    b = max(range(len(spec)), key=lambda i: spec[i].cand_cap)
    sp, args = list(cellknn.bucketed_tile_args(grid, cells, spec))[b]
    ops = cellknn._select_operands(grid, args, sp.capacity, sp.cand_cap,
                                   with_ids=True)[0]
    top = ops[4].sum(1).argsort(descending=True)[:HUGE_CUT_ROWS]
    q, p, cand, qrow, valid = (a[top].contiguous() for a in ops)
    cut = (q[:, :HUGE_SORT_QUERIES].contiguous(), p, cand,
           qrow[:, :HUGE_SORT_QUERIES].contiguous(), valid)
    M = p.shape[1]
    max_err = 0.0
    for kernel, plain in ((knn_select_rows, select_rows_plain),
                          (knn_select, select_pos_plain),
                          (knn_select_coords, select_coords_plain)):
        d_k, w_k = kernel(*cut, k)
        torch.cuda.synchronize()
        d_p, w_p = plain(*cut, k)
        found = int((d_k < 1e18).sum(-1).max())
        check(torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
              and torch.equal(w_k.view(torch.int32), w_p.view(torch.int32)),
              f"k={k}, M={M}: {kernel.__name__} bit-identical to its plain "
              "version (device-memory sort)")
        max_err = max(max_err, float((d_k - d_p).abs().max()))
    log(f"device-memory sort, k={k} on bucket {b} (M {M}, layout "
        f"{select_layout(HUGE_SORT_QUERIES, M, k)} shared bytes): "
        f"{HUGE_CUT_ROWS} cell rows x {HUGE_SORT_QUERIES} query slots, "
        f"up to {found} winners a query, bit-identical")
    check(found > SORT_KEYS, f"k={k}: a query sorts more than {SORT_KEYS} "
          "winners (the device-memory merge steps ran)")
    return max_err


def cut_band(ops, counts, blocks):
    """Phase 5e's band operands and counts on their first ``blocks`` row
    blocks (the planes whole)."""
    return ops[:3] + tuple(a[:blocks].contiguous() for a in ops[3:]), \
        counts[:blocks].contiguous()


def huge_k_phase(label, cloud, pts, counters, none):
    """Phase 15: the selects past 1024 neighbors on the 1M torus (the
    docstring's 15a-15c)."""
    import numpy as np
    import torch

    from pct_tpu_torch import compat
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.curvature.pca import surface_variation
    from pct_tpu_torch.experimental import knn_band_select
    from pct_tpu_torch.neighbors import cellknn, knn_cloud_grid
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.pipeline import (
        curvature_pipeline,
        fast_curvature,
        fused_curvature,
    )
    from pct_tpu_torch.pipeline.fused import plan_engine
    from pct_tpu_torch.shapes import analytic_curvatures

    t_phase = time.perf_counter()
    n = cloud.num_points
    out = {"walls": {}, "max_err": {}, "layouts": {}}

    # --- 15a. the kernels against their plain versions ---
    for k in HUGE_KS:
        grid, cells, spec = knn_layout(cloud, k)
        per, err, layouts = wide_vs_plain(
            cellknn, grid, cells, spec, k, f"selects k={k}",
            timed=(k == K_HUGE_KNN), cut_rows=HUGE_CUT_ROWS)
        out["max_err"][k], out["layouts"][k] = err, layouts
        if k == K_HUGE_KNN:
            out["buckets"], out["spec"] = per, spec
        if k == HUGE_KS[-1]:
            out["max_err"][K_SORT] = device_sort_check(cloud, grid, cells,
                                                       spec, K_SORT)
        del grid, cells
        torch.cuda.empty_cache()
    ops, counts, cap, band = band_inputs(cloud)
    ops, counts = cut_band(ops, counts, HUGE_BAND_BLOCKS)
    band_err = 0.0
    for k in (1025, K_HUGE_KNN):
        for mode_counts in (None, counts):
            got, blocks, _, err, plain_s, _ = band_vs_plain(
                ops, k, BAND_BC, cap, band, mode_counts,
                budget_s=WIDE_BAND_PLAIN_S)
            band_err = max(band_err, err)
            if k == K_HUGE_KNN and mode_counts is not None:
                out["band_plain"] = (plain_s * 1e3, blocks)
            del got
    nb = ops[3].shape[0]
    pairs = int((ops[5].sum(-1).to(torch.int64) * counts).sum())
    band_ms = event_ms(lambda: knn_band_select(
        *ops, k=K_HUGE_KNN, bc=BAND_BC, cap=cap, band=band, counts=counts),
        TIMED_REPS)
    b_ms, b_by = bound(pairs, PAIR_FLOPS, 0, nbytes(*ops, counts)
                       + nb * BAND_BC * cap * (K_HUGE_KNN * 8 + 4))
    plain_ms, plain_blocks = out["band_plain"]
    out["band"] = dict(ms=band_ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None, max_err=band_err,
                       plain_blocks=plain_blocks, blocks=nb)
    log(f"[{label}] band kernel k={K_HUGE_KNN} (counts): {band_ms:.3f} "
        f"ms/call over the first {nb} blocks, band {band}; plain "
        f"{plain_ms:.1f} ms over {plain_blocks} of them; bound {b_ms:.4f} "
        f"ms ({b_by})")
    del ops, counts
    torch.cuda.empty_cache()

    # --- 15b. knn_cloud_grid at k = 2048, once ---
    k = K_HUGE_KNN
    nk = len(out["spec"])
    torch.cuda.reset_peak_memory_stats()
    big, walls, launches = drive(
        lambda: knn_cloud_grid(cloud, k)[0], f"knn_cloud_grid k={k}",
        counters, {**none, "select_rows": nk, **tables(2)}, warm=0,
        want_by_k={"select_rows": {k: nk}})
    out["walls"][f"knn_cloud_grid k={k}"] = walls
    out["launches"] = launches["select_rows"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    exact = float(big.exact[:n].float().mean())
    log(f"[{label}] knn_cloud_grid k={k}, 1M torus: wall {walls[0]:.3f} s "
        f"(one call), {nbytes(big.indices, big.dists) / 1e9:.2f} GB of "
        f"indices and distances, exact {exact}, valid "
        f"{float(big.valid[:n].float().mean())}, peak device memory "
        f"{out['peak_gb']:.1f} GB")
    check(bool(big.exact[:n].all()) and bool(big.valid[:n].all()),
          f"knn_cloud_grid k={k}: exact 1.0 and every slot found")
    check(tuple(big.indices.shape) == (cloud.capacity, k),
          f"knn_cloud_grid k={k}: output shape")
    kth_vs_bruteforce(types.SimpleNamespace(
        exact=big.exact, kth_dist=big.dists[:, -1]), cloud, k)
    del big
    torch.cuda.empty_cache()

    # --- 15c. the entry points at k = 1100, explicit k = 2048 ---
    k = K_HUGE
    Ka, _ = analytic_curvatures("torus", pts)
    n_knn = len(knn_layout(cloud, k)[2])
    want = {**none, "select_rows": n_knn, **tables(2)}
    by_k = {"select_rows": {k: n_knn}}
    grid = build_grid(cloud.points, n, estimate_cell_size(cloud.points, n, k))
    probe, mc = cellknn.probe_grid_buckets(grid, capacity_cap=max(256, 4 * k))
    check(not any(cellknn.list_engine_ok(sp.capacity, sp.cand_cap, k)
                  for sp in probe),
          f"implicit k={k} takes the staged route (knn_cloud_grid)")
    imp, out["walls"]["implicit"], _ = drive(
        lambda: fast_curvature(cloud, k, method="implicit"),
        f"implicit k={k}", counters, {**want, **tables(3)}, warm=1,
        want_by_k=by_k)
    out["implicit_err"] = implicit_accuracy(imp, cloud, pts, k)
    del imp

    pipe, out["walls"]["curvature_pipeline"], _ = drive(
        lambda: curvature_pipeline(cloud, k), f"curvature_pipeline k={k}",
        counters, want, warm=1, want_by_k=by_k)
    K = pipe.curv.K[:n].cpu().numpy()
    out["pipeline_err"] = float(np.median(np.abs(K - Ka) / np.abs(Ka).max()))
    log(f"curvature_pipeline k={k}: NaN fraction {float(np.isnan(K).mean())}"
        f", median scale-relative K error {out['pipeline_err']:.4e}")
    check(not np.isnan(K).any(), f"curvature_pipeline k={k}: no NaN")
    del pipe, K

    fc = from_numpy(pts, device=cloud.points.device)   # compat's padding
    frac = k / n
    k_est = int(min(max(n * frac, 3), k, n - 1))
    check(k_est == k, f"estimate_curvature at k_fraction {frac}: k = {k}")
    n_est = len(knn_buckets(fc.points, n, k_est))
    sv, out["walls"]["estimate_curvature"], _ = drive(
        lambda: compat.estimate_curvature(pts, k_fraction=frac,
                                          max_neighbors=k),
        f"estimate_curvature max_neighbors={k}", counters,
        {**none, "select_rows": n_est, **tables(2)}, warm=1,
        want_by_k={"select_rows": {k_est: n_est}})
    ref = knn_cloud_grid(fc, k_est)[0]
    want_sv = surface_variation(fc.points, ref.indices[:n]).cpu().numpy()
    check(sv.shape == (n,) and not np.isnan(sv).any()
          and bool((sv >= 0).all()), f"estimate_curvature k={k}: >= 0, no "
          "NaN")
    check(bool((sv == want_sv).all()), f"estimate_curvature k={k}: surface "
          "variation of knn_cloud_grid's neighbors, bit for bit")
    log(f"estimate_curvature(k_fraction={frac}, max_neighbors={k}): "
        f"k={k_est}, {n_est} rows launches a call, median "
        f"{float(np.median(sv)):.4e}")
    del sv, ref, fc
    torch.cuda.empty_cache()

    cell = estimate_cell_size(cloud.points, n, k)
    n_sel = cellknn.list_select_launches(probe)
    fl, out["walls"]["fused_curvature list"], _ = drive(
        lambda: fused_curvature(cloud.points, n, cell, k, bucket_spec=probe,
                                max_cells=mc, engine="list"),
        f"fused_curvature(engine='list') k={k}", counters,
        {**none, "select_coords": n_sel, "list_fit": n_sel, **tables(1)},
        warm=1,
        want_by_k={"select_coords": {k: n_sel}})
    list_fit_vs_plain(
        lambda: fused_curvature(cloud.points, n, cell, k, bucket_spec=probe,
                                max_cells=mc, engine="list"),
        f"fused_curvature(engine='list') k={k}", n_sel,
        max_rows=HUGE_FIT_ROWS)
    K = fl.curv.K[:n].cpu().numpy()
    out["list_err"] = float(np.median(np.abs(K - Ka) / np.abs(Ka).max()))
    log(f"fused_curvature(engine='list') k={k}: {len(probe)} buckets, "
        f"{n_sel} coords launches a call, exact "
        f"{float(fl.exact[:n].float().mean()):.6f}, NaN fraction "
        f"{float(np.isnan(K).mean())}, median scale-relative K error "
        f"{out['list_err']:.4e}")
    check(not np.isnan(K).any(), f"fused_curvature list k={k}: no NaN")
    del fl, K, grid
    torch.cuda.empty_cache()

    k = K_HUGE_KNN
    grid = build_grid(cloud.points, n, estimate_cell_size(cloud.points, n, k))
    engine, spec, _, _ = plan_engine(grid, k)
    check(engine == "moments", f"explicit k={k} runs the moments engine")
    del grid
    mom, out["walls"][f"fast_curvature k={k}"], _ = drive(
        lambda: fast_curvature(cloud, k), f"fast_curvature k={k}", counters,
        {**none, "moments": len(spec), "epilogue": 1, **tables(2)}, warm=1)
    K = mom.curv.K[:n].cpu().numpy()
    out["moments_err"] = float(np.median(np.abs(K - Ka) / np.abs(Ka).max()))
    log(f"fast_curvature k={k} (moments, {len(spec)} buckets): exact "
        f"{float(mom.exact[:n].float().mean()):.6f}, NaN fraction "
        f"{float(np.isnan(K).mean())}, median scale-relative K error "
        f"{out['moments_err']:.4e}")
    check(not np.isnan(K).any(), f"fast_curvature k={k}: no NaN")
    del mom, K
    torch.cuda.empty_cache()
    log(f"[{label}] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return out


def mesh_record(rec, flops=None):
    """A kernel's record at one of phase 7's shapes, per call of the
    driven entry point, with its buckets."""
    return {
        "shape": rec["label"],
        "launches": rec["launches"],
        "launches_per_call": rec["launches"] // rec["calls"],
        "max_abs_err": rec["max_err"],
        **call_numbers(rec["buckets"], flops),
        "buckets": [dict(C=r["capacity"], M=r["M"], cells=r["cells"],
                         ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"],
                         library_ms=r.get("library_ms"))
                    for r in rec["buckets"]],
    }


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    root = Path(__file__).resolve().parent
    if not (root / "pct_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: no pct_tpu_torch package in {root}")
    sys.path.insert(0, str(root))

    # --- 1. the card ---
    label = card_label()
    log(f"card: {label}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.ops import build
    from pct_tpu_torch.neighbors import knn_cloud_grid
    from pct_tpu_torch.ops.select import (
        knn_select,
        knn_select_rows,
        select_pos_plain,
        select_rows_plain,
    )
    from pct_tpu_torch.pipeline import (
        curvature_pipeline,
        fast_curvature,
        fused_curvature,
    )
    from pct_tpu_torch.pipeline.fused import SPLIT_TO, plan_engine
    from pct_tpu_torch.shapes import generate_shape

    # --- 2. build every kernel from the checkout ---
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        logf = lib.with_suffix(".log")
        text = logf.read_text() if logf.exists() else ""
        ks = ptxas_kernels(text)
        for line in text.splitlines():
            if line.startswith("nvcc "):
                log(f"  {name}: {line.strip()}")
        if ks:
            log(f"  {name}: {len(ks)} kernels, registers "
                f"{min(k['registers'] for k in ks)}-"
                f"{max(k['registers'] for k in ks)}, spill stores / loads "
                f"up to {max(k['spill_stores'] for k in ks)} / "
                f"{max(k['spill_loads'] for k in ks)} B, stack up to "
                f"{max(k['stack'] for k in ks)} B")

    dev = torch.device("cuda")
    pts, _ = generate_shape("torus", N_POINTS, radius=1.0)
    cloud = from_numpy(pts, pad_multiple=PAD_MULTIPLE, device=dev)
    n = cloud.num_points
    # each kernel's entry point, whose launches ``ops.build.kernel`` counts
    counters = {"select_coords": "pct_select_coords",
                "moments": "pct_knn_moments",
                "select_rows": "pct_select_rows",
                "select_pos": "pct_select_pos",
                "band_select": "pct_band_select",
                "moments_split": "pct_moments_variant",
                "select_coords_mxu": "pct_select_coords_mxu",
                "moments_like": "pct_moments_like",
                "epilogue": "pct_moments_epilogue", "list_fit": "pct_list_fit",
                "run_table": "pct_run_table_tile_min",
                "run_table_scan": "pct_run_table_suffix_min"}
    none = {name: 0 for name in counters}

    # --- 3. list engine, k=20 ---
    cell = estimate_cell_size(cloud.points, n, K_LIST)
    grid = build_grid(cloud.points, n, cell)
    engine, spec20, mc20, _ = plan_engine(grid, K_LIST)
    check(engine == "list", f"k={K_LIST} runs the list engine")
    log(f"cloud: {n} points, capacity {cloud.capacity}; k={K_LIST}: cell "
        f"{float(cell):.6g}, grid {grid.dims}, {len(spec20)} buckets "
        f"{[tuple(s) for s in spec20]}")
    sel_buckets, sel_err = select_vs_plain(
        cellknn, grid, cellknn.compact_cells(grid, mc20), spec20, K_LIST)
    rt = run_table_vs_plain(cellknn, grid, cellknn.compact_cells(grid, mc20))
    res20, walls20, launches20 = drive(
        lambda: fast_curvature(cloud, K_LIST), f"fast_curvature k={K_LIST}",
        counters,
        {**none, "select_coords": cellknn.list_select_launches(spec20),
         "list_fit": cellknn.list_select_launches(spec20), **tables(2)})
    lf = list_fit_vs_plain(lambda: fast_curvature(cloud, K_LIST),
                           f"fast_curvature k={K_LIST}",
                           cellknn.list_select_launches(spec20), timed=True)
    accuracy(res20, cloud, pts, K_LIST, 1.5e-3)
    kth_vs_bruteforce(res20, cloud, K_LIST)
    del res20

    # --- 4. moments engine, k=100 ---
    cap100 = max(256, 4 * K_MOM)            # fast_curvature's probe setting
    cell = estimate_cell_size(cloud.points, n, K_MOM)
    grid = build_grid(cloud.points, n, cell)
    engine, spec100, mc100, factor = plan_engine(grid, K_MOM)
    check(engine == "moments", f"k={K_MOM} runs the moments engine")
    log(f"k={K_MOM}: cell {float(cell):.6g}, grid {grid.dims}, split factor "
        f"{factor}, {len(spec100)} buckets {[tuple(s) for s in spec100]}")
    cells = cellknn.compact_cells(grid, mc100)
    if factor > 1:
        cells = cellknn.split_cells(cells, cloud.capacity, SPLIT_TO, factor)
    mom_buckets, mom_err, mom_ratio = moments_vs_plain(
        cellknn, grid, cells, spec100, K_MOM)
    del cells
    res100, walls100, launches100 = drive(
        lambda: fast_curvature(cloud, K_MOM), f"fast_curvature k={K_MOM}",
        counters, {**none, "moments": len(spec100), "epilogue": 1,
                   **tables(2)})
    accuracy(res100, cloud, pts, K_MOM, 1.0e-3)
    kth_vs_bruteforce(res100, cloud, K_MOM)
    del res100
    epi = epilogue_vs_plain(cloud, K_MOM)

    # the virtual split on the card: cells of <= 64 queries a row
    spec64, mc64, f64 = cellknn.probe_grid_buckets(
        grid, capacity_cap=cap100, split_to=64)
    spec_u, mc_u = cellknn.probe_grid_buckets(grid, capacity_cap=cap100)
    check(f64 >= 2, f"split_to=64 splits the cloud (factor {f64})")
    r_s = fused_curvature(cloud.points, n, cell, K_MOM, bucket_spec=spec64,
                          max_cells=mc64, engine="moments", split=(64, f64))
    r_u = fused_curvature(cloud.points, n, cell, K_MOM, bucket_spec=spec_u,
                          max_cells=mc_u, engine="moments")
    e = r_u.exact[:n]
    k_diff = (r_s.curv.K[:n] - r_u.curv.K[:n])[e].abs()
    k_tol = 1e-5 + 2e-4 * r_u.curv.K[:n][e].abs()
    log(f"split check: factor {f64}, {len(spec64)} buckets of capacity <= "
        f"{max(s.capacity for s in spec64)} vs {len(spec_u)} unsplit of "
        f"<= {max(s.capacity for s in spec_u)}; exact rows differing "
        f"{int((r_s.exact[:n] != e).sum())}, certified rows "
        f"{int(e.sum())}, max K diff {float(k_diff.max()):.3e}")
    check(bool((r_s.exact[:n] == e).all()), "split exact equals unsplit")
    check(bool((k_diff <= k_tol).all()),
          "split K within rtol 2e-4, atol 1e-5 of unsplit on certified rows")
    del r_s, r_u

    # --- 5. library kNN, the staged pipeline, the implicit method ---
    cell = estimate_cell_size(cloud.points, n, K_LIST)
    grid = build_grid(cloud.points, n, cell)
    spec_knn, mc_knn = cellknn.probe_grid_buckets(grid)   # knn_cloud_grid's
    log(f"knn_cloud_grid k={K_LIST}: {len(spec_knn)} buckets "
        f"{[tuple(s) for s in spec_knn]}")
    ids_buckets, ids_err = ids_vs_plain(
        cellknn, grid, cellknn.compact_cells(grid, mc_knn), spec_knn, K_LIST,
        {"select_rows": (knn_select_rows, select_rows_plain),
         "select_pos": (knn_select, select_pos_plain)}, f"rows/pos k={K_LIST}")
    cell = estimate_cell_size(cloud.points, n, K_MOM)
    grid = build_grid(cloud.points, n, cell)
    spec_knn100, mc_knn100 = cellknn.probe_grid_buckets(grid)
    log(f"knn_cloud_grid k={K_MOM}: {len(spec_knn100)} buckets "
        f"{[tuple(s) for s in spec_knn100]}")
    rows100_buckets, rows100_err = ids_vs_plain(
        cellknn, grid, cellknn.compact_cells(grid, mc_knn100), spec_knn100,
        K_MOM, {"select_rows": (knn_select_rows, select_rows_plain),
                "select_pos": (knn_select, select_pos_plain)},
        f"rows/pos k={K_MOM}")
    del grid

    knn20, walls_knn, launches_knn = drive(
        lambda: knn_cloud_grid(cloud, K_LIST)[0], f"knn_cloud_grid k={K_LIST}",
        counters, {**none, "select_rows": len(spec_knn), **tables(2)})
    log(f"knn_cloud_grid k={K_LIST}: exact {float(knn20.exact[:n].float().mean())}"
        f", valid {float(knn20.valid[:n].float().mean())}")
    check(bool(knn20.exact[:n].all()) and bool(knn20.valid[:n].all()),
          "knn_cloud_grid: exact 1.0 and every slot found after the repair")
    check(tuple(knn20.indices.shape) == (cloud.capacity, K_LIST),
          "knn_cloud_grid output shape")
    kth_vs_bruteforce(types.SimpleNamespace(
        exact=knn20.exact, kth_dist=knn20.dists[:, -1]), cloud, K_LIST)
    del knn20

    pipe20, walls_pipe, _ = drive(
        lambda: curvature_pipeline(cloud, K_LIST),
        f"curvature_pipeline k={K_LIST}", counters,
        {**none, "select_rows": len(spec_knn), **tables(2)})
    fast20 = fast_curvature(cloud, K_LIST)
    e = fast20.exact[:n]
    K_f, K_s = fast20.curv.K[:n][e], pipe20.curv.K[:n][e]
    pipe_err = float((K_s - K_f).abs().max() / K_f.abs().max())
    log(f"curvature_pipeline vs fast_curvature k={K_LIST}: {int(e.sum())} "
        f"certified rows, max |dK| / max|K| {pipe_err:.3e}")
    check(pipe_err <= 2e-4, "curvature_pipeline K within 2e-4 max|K| of "
          "fast_curvature on certified rows")
    check(not bool(pipe20.curv.K[:n].isnan().any()), "pipeline: no NaN")
    del pipe20, fast20

    imp20, walls_imp20, launches_imp20 = drive(
        lambda: fast_curvature(cloud, K_LIST, method="implicit"),
        f"implicit k={K_LIST}", counters,
        {**none, "select_coords": cellknn.list_select_launches(spec20),
         **tables(2)})
    log(f"implicit k={K_LIST}: {launches_imp20['list_fit']} list_fit "
        f"launches (the eager chain), {launches_imp20['select_coords']} "
        "coords launches")
    imp20_err = implicit_accuracy(imp20, cloud, pts, K_LIST, 7e-3, 1.25e-2)
    del imp20
    imp100, walls_imp100, launches_imp100 = drive(
        lambda: fast_curvature(cloud, K_MOM, method="implicit"),
        f"implicit k={K_MOM}", counters,
        {**none, "select_rows": len(spec_knn100), **tables(3)}, warm=2)
    imp100_err = implicit_accuracy(imp100, cloud, pts, K_MOM)
    del imp100

    band_row = band_phase(label, cloud, counters, none)
    study_phase(label, cloud)

    # --- 7. the device half of the mesh path ---
    mesh_normals = normals_phase(label, cloud, pts, counters, none)
    verts, faces = torus_mesh(MESH_SIDE)
    mesh_vertex, vres = vertex_curvature_phase(label, verts, counters, none)
    mesh_ops_phase(label, cloud, verts, faces, vres)
    del vres, verts, faces

    # --- 8. the mesh path ---
    mesh_path = mesh_path_phase(label, pts, counters, none)

    # --- 9. the validation harness ---
    validation = validation_phase(label, pts, counters, none, mesh_path,
                                  len(spec20), len(spec100))

    # --- 10. the distributed layer, a NCCL world of one ---
    distributed, dist_walls = distributed_phase(
        label, cloud, pts, counters, none, walls20, walls100)

    # --- 11. the TPU scripts' kernels (no entry point launches them) ---
    micro_rows = micro_phase(label, launches20)

    # --- 12. the reference-API façade, the command line, the demos ---
    facade = facade_phase(label, cloud, pts, counters, none, len(spec_knn))

    # --- 14. past 128 neighbors ---
    wide = wide_k_phase(label, cloud, pts, counters, none)

    # --- 15. past 1024 neighbors ---
    huge = huge_k_phase(label, cloud, pts, counters, none)

    # --- 6. numbers ---
    for name, walls in ((f"fast_curvature k={K_LIST}", walls20),
                        (f"fast_curvature k={K_MOM}", walls100),
                        (f"knn_cloud_grid k={K_LIST}", walls_knn),
                        (f"curvature_pipeline k={K_LIST}", walls_pipe),
                        (f"fast_curvature implicit k={K_LIST}", walls_imp20),
                        (f"fast_curvature implicit k={K_MOM}", walls_imp100)):
        wall = statistics.median(walls[1:])
        log(f"[{label}] {name}, 1M torus: warm wall {wall:.4f} s/call "
            f"(median of {len(walls) - 1}; cold first call {walls[0]:.3f} "
            f"s), {N_POINTS / wall:.0f} points/s")
    log(f"[{label}] implicit median K / |H| errors: k={K_LIST} "
        f"{imp20_err[0]:.4e} / {imp20_err[1]:.4e}, k={K_MOM} "
        f"{imp100_err[0]:.4e} / {imp100_err[1]:.4e}")
    stage_times(label, cloud, K_LIST)
    stage_times(label, cloud, K_MOM)
    log_buckets(label, "select_coords", sel_buckets)
    log_buckets(label, "moments", mom_buckets)
    log_buckets(label, f"select_rows k={K_LIST}", ids_buckets["select_rows"])
    log_buckets(label, f"select_pos k={K_LIST}", ids_buckets["select_pos"])
    log_buckets(label, f"select_rows k={K_MOM}", rows100_buckets["select_rows"])
    log_buckets(label, f"select_pos k={K_MOM}", rows100_buckets["select_pos"])
    for name in ("select_rows", "select_pos", "select_coords"):
        log_buckets(label, f"{name} k={K_WIDE}", wide["buckets"][name])
    for name, walls in wide["walls"].items():
        log(f"[{label}] phase 14 {name}: walls {[round(w, 4) for w in walls]}"
            f" s (first call cold)")
    log(f"[{label}] phase 14 median errors: implicit k={K_WIDE} K / |H| "
        f"{wide['implicit_err'][0]:.4e} / {wide['implicit_err'][1]:.4e}, "
        f"curvature_pipeline k={K_WIDE} K {wide['pipeline_err']:.4e}")
    for name in ("select_rows", "select_pos", "select_coords"):
        log_buckets(label, f"{name} k={K_HUGE_KNN}", huge["buckets"][name])
        for r in huge["buckets"][name]:
            log(f"[{label}] {name} k={K_HUGE_KNN} bucket {r['bucket']} on "
                f"its first {r['compared_rows']} cell rows: kernel "
                f"{r['ms_compared_rows']:.3f} ms, plain {r['plain_ms']:.3f}"
                f" ms, torch.topk {fmt_ms(r['library_ms'])}")
    for name, walls in huge["walls"].items():
        log(f"[{label}] phase 15 {name}: walls {[round(w, 4) for w in walls]}"
            f" s (first call cold)")
    log(f"[{label}] phase 15 median K errors: implicit k={K_HUGE} "
        f"{huge['implicit_err'][0]:.4e} (|H| {huge['implicit_err'][1]:.4e})"
        f", curvature_pipeline {huge['pipeline_err']:.4e}, fused list "
        f"{huge['list_err']:.4e}; explicit k={K_HUGE_KNN} (moments) "
        f"{huge['moments_err']:.4e}; knn_cloud_grid k={K_HUGE_KNN} peak "
        f"{huge['peak_gb']:.1f} GB")
    rows = [
        kernel_row("select_coords", "pct_tpu_torch/csrc/select_coords.cu",
                   "pct_tpu/ops/pallas_select.py:88",
                   launches20["select_coords"], sel_err, sel_buckets),
        kernel_row("moments", "pct_tpu_torch/csrc/moments.cu",
                   "pct_tpu/ops/pallas_moments.py:58",
                   launches100["moments"], mom_err, mom_buckets,
                   sum(r["pairs"] * PAIR_FLOPS + r["members"] * MEMBER_FLOPS
                       for r in mom_buckets)),
        kernel_row("select_rows", "pct_tpu_torch/csrc/select_rows.cu",
                   "pct_tpu/ops/pallas_select.py:131",
                   launches_knn["select_rows"], max(ids_err, rows100_err),
                   ids_buckets["select_rows"]),
        kernel_row("select_pos", "pct_tpu_torch/csrc/select_rows.cu",
                   "pct_tpu/ops/pallas_select.py:60",
                   launches_knn["select_pos"], ids_err,
                   ids_buckets["select_pos"]),
        kernel_row("band_select", "pct_tpu_torch/csrc/band_select.cu",
                   "pct_tpu/experimental/pallas_band.py:49",
                   band_row["launches"], band_row["max_err"], [band_row]),
    ]
    epi_rec, epi_err = epi
    rows.append(kernel_row("epilogue", "pct_tpu_torch/csrc/epilogue.cu",
                           "pct_tpu/fit/moments.py:313",
                           launches100["epilogue"], epi_err, [epi_rec],
                           flops=0))
    rows[-1]["rows"] = epi_rec["rows"]
    rows[-1]["bound_counts"] = (f"bytes only, {EPILOGUE_ROW_BYTES} B a row "
                                "(its operations are not counted)")
    rows[-1]["library_call"] = ("none: the eager einsum chain it replaces "
                                "is not kept")
    lf_rec, lf_err = lf
    rows.append(kernel_row("list_fit", "pct_tpu_torch/csrc/list_fit.cu",
                           "pct_tpu/pipeline/fused.py:57",
                           launches20["list_fit"], lf_err, [lf_rec],
                           flops=0))
    rows[-1]["rows"] = lf_rec["rows"]
    rows[-1]["bound_counts"] = (f"bytes only, 12k + {LIST_FIT_ROW_BYTES} B "
                                "a row (its operations are not counted)")
    rows[-1]["library_call"] = ("none: the eager neighbourhood chain it "
                                "replaces is the implicit method's")
    rt_rec, rt_err = rt
    rows.append(kernel_row("run_table", "pct_tpu_torch/csrc/run_table.cu",
                           "pct_tpu/neighbors/cellknn.py:354",
                           launches20["run_table"]
                           + launches20["run_table_scan"], rt_err, [rt_rec],
                           flops=0))
    rows[-1]["rows"] = rt_rec["rows"]
    rows[-1]["bound_counts"] = (f"bytes only, {RUN_TABLE_BOX_BYTES} B a box "
                                "(read once, written once)")
    rows[-1]["library_call"] = ("torch.cummin of the pre-flipped table "
                                "(partial: no flips; it also writes int64 "
                                "indices)")
    rows[1]["max_err_ratio"] = mom_ratio
    # k=100: the rows kernel on the implicit k=100 path (knn_cloud_grid's
    # k=100 buckets), the positions kernel on the same operands
    for r, name, launches in ((rows[2], "select_rows",
                               launches_imp100["select_rows"]),
                              (rows[3], "select_pos", 0)):
        r["k100"] = kernel_row(name, r["source"], r["replaces"], launches,
                               rows100_err, rows100_buckets[name])
    rows[1]["library_call"] = ("torch.kthvalue of the prebuilt masked d2 "
                               "(partial: tau only)")
    for r in rows[0:1] + rows[2:4]:
        r["library_call"] = ("torch.topk over int64 (d2 bits << 32 | m) "
                             "keys of the prebuilt masked d2 (partial: no "
                             "d2, no missing-slot rule)")
    rows[4]["library_call"] = (
        "none: no single call selects over the band runs; a dense topk "
        "over S x 9*band int64 keys would need "
        f"{band_row['dense_key_bytes'] / 1e9:.0f} GB")
    for key in ("blocks_checked", "rows_checked", "default_band_ms",
                "all_slots_ms"):
        rows[4][key] = band_row[key]
    # k=200 (phase 14): the rows kernel on knn_cloud_grid(k=200)'s path,
    # the positions and coords kernels on the same operands (no entry
    # point launches them at k=200), the band kernel on phase 5e's
    # operands (no entry point at k=200)
    wide_err = max(wide["max_err"].values())
    for r, name, launches in ((rows[0], "select_coords", 0),
                              (rows[2], "select_rows", wide["launches"]),
                              (rows[3], "select_pos", 0)):
        r["k200"] = kernel_row(name, r["source"], r["replaces"], launches,
                               wide_err, wide["buckets"][name])
        r["k200"]["layout_bytes"] = [b["layout_bytes"]
                                     for b in wide["buckets"][name]]
        r["max_abs_err_past_128"] = wide["max_err"]
    # k=2048 (phase 15, the block class): the rows kernel on
    # knn_cloud_grid(k=2048)'s path, the positions and coords kernels on
    # the same operands, the band kernel on the first HUGE_BAND_BLOCKS row
    # blocks of phase 5e's operands (no entry point launches those three
    # at k=2048); plain and library ms on each bucket's compared rows
    huge_err = max(huge["max_err"].values())
    for r, name, launches in ((rows[0], "select_coords", 0),
                              (rows[2], "select_rows", huge["launches"]),
                              (rows[3], "select_pos", 0)):
        r["k2048"] = kernel_row(name, r["source"], r["replaces"], launches,
                                huge_err, huge["buckets"][name])
        r["k2048"]["plain_and_library_on_rows"] = HUGE_CUT_ROWS
        r["k2048"]["ms_compared_rows"] = sum(
            b["ms_compared_rows"] for b in huge["buckets"][name])
        r["k2048"]["layout_bytes"] = [b["layout_bytes"]
                                      for b in huge["buckets"][name]]
        r["max_abs_err_past_1024"] = huge["max_err"]
    rows[4]["k2048"] = {"name": "band_select", "route": "cuda",
                        "source": rows[4]["source"],
                        "replaces": rows[4]["replaces"], "launches": 0,
                        "max_abs_err": huge["band"]["max_err"],
                        **{key: huge["band"][key] for key in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "plain_blocks", "blocks")}}
    rows[4]["k200"] = {"name": "band_select", "route": "cuda",
                       "source": rows[4]["source"],
                       "replaces": rows[4]["replaces"], "launches": 0,
                       "max_abs_err": wide["band"]["max_err"],
                       **{key: wide["band"][key] for key in (
                           "ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms", "plain_blocks", "blocks")}}
    # calls per driven path: 1 cold + 3 warm, the implicit k=100 path 1 + 2
    for r, calls, k in [(r, 4, "") for r in rows] + [
            (rows[2]["k100"], 3, " k=100"), (rows[3]["k100"], 3, " k=100"),
            (rows[0]["k200"], 3, " k=200"), (rows[2]["k200"], 3, " k=200"),
            (rows[3]["k200"], 3, " k=200"), (rows[4]["k200"], 1, " k=200"),
            (rows[0]["k2048"], 1, " k=2048"), (rows[2]["k2048"], 1, " k=2048"),
            (rows[3]["k2048"], 1, " k=2048"),
            (rows[4]["k2048"], 1, " k=2048")]:
        lib = ("" if r["library_ms"] is None else
               f", library yardstick (partial) {r['library_ms']:.3f} ms")
        log(f"[{label}] {r['name']}{k} kernel: {r['ms']:.3f} ms/call "
            f"({r['launches'] // calls} launches/call), plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){lib}")
    log("select_pos: no entry point of either package selects positions "
        "(the JAX package's only caller is _tile_select(want='pos')), so its "
        "main-path launches are 0; it is held to its plain version above")
    # the mesh path's shapes (phase 7), per call of its entry point
    mesh = {r["name"]: r.setdefault("mesh_path", []) for r in rows}
    mesh["moments"].append(mesh_record(
        mesh_normals["moments"],
        sum(r["pairs"] * PAIR_FLOPS + r["members"] * MEMBER_FLOPS
            for r in mesh_normals["moments"]["buckets"])))
    mesh["moments"][-1]["max_err_ratio"] = mesh_normals["moments"]["ratio"]
    for key in ("rows_v", "rows_c"):
        mesh["select_rows"].append(mesh_record(mesh_normals[key]))
    mesh["select_coords"].append(mesh_record(mesh_vertex))
    mesh["select_coords"].append(mesh_record(mesh_path))
    for name, recs in mesh.items():
        for r in recs:
            lib = ("" if r["library_ms"] is None else
                   f", library yardstick (partial) {r['library_ms']:.3f} ms")
            log(f"[{label}] {name} at {r['shape']}: {r['ms']:.3f} ms/call "
                f"({r['launches_per_call']} launches/call, {r['launches']} in "
                f"the driven run), plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}){lib}")
    for name, wall in (("estimate_and_orient_normals k=50",
                        mesh_normals["wall"]),
                       (f"fast_curvature k={K_LIST} on the mesh vertices",
                        mesh_vertex["wall"])):
        log(f"[{label}] {name}, 1M torus: warm wall {wall:.4f} s/call, "
            f"{N_POINTS / wall:.0f} points/s")
    log(f"[{label}] create_mesh_with_curvature, 1M torus: wall "
        f"{mesh_path['wall']:.3f} s (one call), stages (s) "
        f"{mesh_path['timings']}")

    rows += micro_rows
    for r in rows:
        r["card"] = label
        r["validation"] = validation.get(r["name"], {})   # phase 9 checks 0
        r["distributed"] = distributed[r["name"]]
        r["compat"] = facade[r["name"]]                  # phase 12 checks 0
        log(f"[{label}] {r['name']} launches in phase 9: {r['validation']}, "
            f"in phase 10: {r['distributed']}, in phase 12: {r['compat']}")
    for tag, walls in dist_walls.items():
        log(f"[{label}] phase {tag}, 1M torus: warm wall "
            f"{statistics.median(walls[1:]):.4f} s/call (median of "
            f"{len(walls) - 1}; cold first call {walls[0]:.3f} s)")

    # --- 13. result ---
    log(f"[{label}] chip_smoke.py: {time.perf_counter() - t_start:.1f} s "
        "from start to the result")
    log(f"kernels: {[r['name'] for r in rows]}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
