#!/usr/bin/env python3
"""Time the moments route's epilogue on the card, at the main path's rows.

    python3 scripts/torch_micro_epilogue.py [--points 1000000] [--k 100]

Captures the (rows, 48) stats that ``fast_curvature(k)`` hands its
epilogue on the perturbed torus (every bucket's query slots, padding
included), then times on those rows, with CUDA events over warm
repetitions: the kernel (``ops.epilogue.moments_epilogue``) and its
plain version (``epilogue_plain``, the same operations as eager PyTorch
ops). Prints one JSON line with the card's name and power limit, the
row count, each time in ms, the kernel's bytes bound (192 B read and
32 B written a row at the card's published bandwidth) and whether
kernel and plain version agree bit for bit.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import pct_tpu_torch.pipeline.fused as fused  # noqa: E402
from pct_tpu_torch.core import from_numpy  # noqa: E402
from pct_tpu_torch.ops.epilogue import (  # noqa: E402
    NIN,
    NOUT,
    epilogue_plain,
    moments_epilogue,
)
from pct_tpu_torch.shapes import generate_shape  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published


def capture_stats(points: int, k: int) -> torch.Tensor:
    cloud = from_numpy(generate_shape("torus", points,
                                      perturbation_strength=1e-3,
                                      seed=1)[1], device="cuda")
    seen = []
    orig = fused._moments_epilogue

    def spy(out):
        seen.append(out[0].clone())
        return orig(out)

    fused._moments_epilogue = spy
    try:
        fused.fast_curvature(cloud, k)
    finally:
        fused._moments_epilogue = orig
    torch.cuda.synchronize()
    return seen[0]


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    stats = capture_stats(args.points, args.k)
    rows = stats.shape[0]
    got = moments_epilogue(stats)
    want = epilogue_plain(stats)
    bits = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
    print(json.dumps({
        "card": card, "rows": rows, "bit_identical": bits,
        "kernel_ms": time_ms(lambda: moments_epilogue(stats), 50),
        "plain_ms": time_ms(lambda: epilogue_plain(stats), 3),
        "bound_ms": rows * (NIN + NOUT) * 4 / HBM_BYTES_PER_S * 1e3,
    }))


if __name__ == "__main__":
    main()
