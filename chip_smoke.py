#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pct_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero
without printing its result line:

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the port from the checkout's sources;
3. each kernel against its plain PyTorch version on the card, on the
   inputs the main path gives it: the 1M-point torus (padded to 1<<16),
   k=20, every occupancy bucket — results must be bit-identical;
4. the main path, ``pct_tpu_torch.pipeline.fast_curvature(k=20)``, on
   that cloud: launch counts, kNN certificate, NaNs, K against the
   analytic torus, kth distances against brute force on sampled rows;
5. timings, each printed beside the card's name and power limit;
6. the kernel table (one JSON line) and the result line.

The script imports nothing of JAX or of the JAX package.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_POINTS = 1_000_000
K = 20
PAD_MULTIPLE = 1 << 16
CAPACITY_CAP = max(256, 4 * K)   # fast_curvature's probe setting
FP32_PEAK = 67e12                # H100 SXM FP32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PAIR_FLOPS = 9                   # 3 sub, 3 mul, 2 add, 1 compare per pair
TIMED_REPS = 5


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


def main():
    import torch

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

    import numpy as np

    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.ops import build
    from pct_tpu_torch.ops.select import knn_select_coords, select_coords_plain
    from pct_tpu_torch.pipeline import fast_curvature
    from pct_tpu_torch.shapes import analytic_curvatures, generate_shape

    # --- 2. build every kernel from the checkout ---
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        logf = lib.with_suffix(".log")
        for line in (logf.read_text().splitlines() if logf.exists() else []):
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # --- 3. kernel vs plain version on the main path's inputs ---
    dev = torch.device("cuda")
    pts, _ = generate_shape("torus", N_POINTS, radius=1.0)
    cloud = from_numpy(pts, pad_multiple=PAD_MULTIPLE, device=dev)
    n = cloud.num_points
    cell = estimate_cell_size(cloud.points, n, K)
    grid = build_grid(cloud.points, n, cell)
    spec, mc = cellknn.probe_grid_buckets(grid, capacity_cap=CAPACITY_CAP)
    cells = cellknn.compact_cells(grid, mc)
    log(f"cloud: {n} points, capacity {cloud.capacity}, cell "
        f"{float(cell):.6g}, grid {grid.dims}, {len(spec)} buckets "
        f"{[tuple(s) for s in spec]}")

    rows = mismatched = 0
    max_err = 0.0
    per_bucket = []
    for b, (sp, args) in enumerate(cellknn.bucketed_tile_args(
            grid, cells, spec)):
        cand, ok_cand, cpts, qpts, qrow = cellknn._tile_candidates(
            grid, args, sp.capacity, sp.cand_cap)[:5]
        sel = (qpts, cpts, cand, qrow, ok_cand.to(torch.int32))
        d_k, n_k = knn_select_coords(*sel, K)
        torch.cuda.synchronize()
        d_p, n_p = select_coords_plain(*sel, K)
        torch.cuda.synchronize()
        same = ((d_k.view(torch.int32) == d_p.view(torch.int32)).all(-1)
                & (n_k.view(torch.int32) == n_p.view(torch.int32))
                .all(-1).all(-1))
        rows += same.numel()
        mismatched += int((~same).sum())
        max_err = max(max_err, float((d_k - d_p).abs().max()),
                      float((n_k - n_p).abs().max()))

        # bound: the pairs this bucket's data needs, and its tensors' bytes
        count = args[2].to(torch.int64)
        tot = torch.clamp_max(args[4].sum(-1), sp.cand_cap).to(torch.int64)
        pairs = int((count * tot).sum())
        nbytes = sum(a.numel() * a.element_size() for a in sel) \
            + d_k.numel() * 4 + n_k.numel() * 4
        t_ops = pairs * PAIR_FLOPS / FP32_PEAK * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        per_bucket.append(dict(
            bucket=b, cells=int((args[0] != cellknn.PAD_ID).sum()),
            capacity=sp.capacity, M=sel[1].shape[1], pairs=pairs,
            bytes=nbytes, bound_ms=max(t_ops, t_bytes),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            ms=event_ms(lambda sel=sel: knn_select_coords(*sel, K),
                        TIMED_REPS),
            plain_ms=event_ms(lambda sel=sel: select_coords_plain(*sel, K),
                              3)))
        del d_k, n_k, d_p, n_p
    log(f"select_coords kernel vs plain: {rows} query rows compared, "
        f"{mismatched} mismatched, max abs err {max_err}")
    check(mismatched == 0 and max_err == 0.0,
          "select_coords kernel bit-identical to its plain version")

    # --- 4. the main path ---
    knn_select_coords.launches = 0
    walls = []
    for i in range(1 + 3):
        before = knn_select_coords.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fast_curvature(cloud, K)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = knn_select_coords.launches - before
        check(got == len(spec),
              f"call {i}: select_coords launched {got} times, "
              f"want one per bucket ({len(spec)})")
    launches = knn_select_coords.launches

    K_t = res.curv.K[:n].cpu().numpy()
    exact = res.exact[:n].cpu().numpy()
    Ka, _ = analytic_curvatures("torus", pts)
    relK = np.abs(K_t - Ka) / np.abs(Ka).max()
    exact_frac = float(exact.mean())
    nan_frac = float(np.isnan(K_t).mean())
    med_err = float(np.median(relK))
    log(f"main path: exact {exact_frac:.6f}, NaN fraction {nan_frac}, "
        f"median scale-relative K error {med_err:.4e}, "
        f"p99 {float(np.quantile(relK, 0.99)):.4e}")
    check(tuple(res.curv.K.shape) == (cloud.capacity,)
          and tuple(res.normals.shape) == (cloud.capacity, 3),
          "output shapes")
    check(exact_frac >= 0.999, "exact fraction >= 0.999")
    check(nan_frac == 0.0, "no NaN in K")
    check(med_err <= 1.5e-3, "median scale-relative K error <= 1.5e-3")

    # kth distances of sampled rows against brute force (difference form)
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
        kth_bf.append(torch.sqrt(torch.topk(d2, K, largest=False).values[:, -1]))
    kth_bf = torch.cat(kth_bf)
    sel_exact = res.exact[sample]
    kth_err = float((res.kth_dist[sample] - kth_bf)[sel_exact].abs().max())
    log(f"kth distance vs brute force on {int(sel_exact.sum())} certified "
        f"sampled rows: max abs diff {kth_err}")
    check(kth_err <= 1e-6 * float(kth_bf.max()), "kth distance = brute force")

    # --- 5. numbers ---
    wall = statistics.median(walls[1:])
    log(f"[{label}] fast_curvature 1M torus k={K}: warm wall "
        f"{wall:.4f} s/call (median of 3; cold first call "
        f"{walls[0]:.3f} s), {N_POINTS / wall:.0f} points/s")

    def stage(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    from pct_tpu_torch.pipeline.fused import _fused_on_grid
    for rep in range(3):
        cell_s, t_cell = stage(lambda: estimate_cell_size(cloud.points, n, K))
        grid_s, t_grid = stage(lambda: build_grid(cloud.points, n, cell_s))
        (spec_s, mc_s), t_probe = stage(lambda: cellknn.probe_grid_buckets(
            grid_s, capacity_cap=CAPACITY_CAP))
        _, t_loop = stage(lambda: _fused_on_grid(grid_s, K, mc_s, spec_s))
        log(f"[{label}] stages rep {rep}: cell size {t_cell:.1f} ms, grid "
            f"{t_grid:.1f} ms, bucket probe {t_probe:.1f} ms, cell loop "
            f"{t_loop:.1f} ms")
    for r in per_bucket:
        log(f"[{label}] bucket {r['bucket']}: {r['cells']} cells, C "
            f"{r['capacity']}, M {r['M']}, {r['pairs']} pairs: kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), 1 launch/call")

    # --- 6. result ---
    kernel_ms = sum(r["ms"] for r in per_bucket)
    t_ops = sum(r["pairs"] for r in per_bucket) * PAIR_FLOPS / FP32_PEAK
    t_bytes = sum(r["bytes"] for r in per_bucket) / HBM_BYTES_PER_S
    log('kernels: ["select_coords"]')
    log(json.dumps({"kernels": [{
        "name": "select_coords",
        "route": "cuda",
        "source": "pct_tpu_torch/csrc/select_coords.cu",
        "replaces": "pct_tpu/ops/pallas_select.py:88",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": sum(r["plain_ms"] for r in per_bucket),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
