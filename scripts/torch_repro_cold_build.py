#!/usr/bin/env python3
"""What a cold first use of a kernel costs, inside a larger program and
alone, on one NVIDIA card.

Counterpart of the JAX package's TPU script ``scripts/repro_mosaic_cold.py``
(a cold Mosaic compile inside a big XLA program against the same kernel
compiled alone first). Here "cold" is ``csrc/moments_like.cu`` built by
nvcc into a fresh temporary directory (``ops.build.BUILD_DIR`` points
there for this process) and its library loaded; "warm" is
``ops.build.load``'s in-process cache. The kernel is
``pct_tpu_torch.micro.moments_like`` at the script's shapes (8 tiles,
C=266, M=1024, 256-wide rows); the program around it is the script's 24
elementwise steps before and 24 after. The two orders need two
processes, as the script's do:

    python3 scripts/torch_repro_cold_build.py prog-first
        A.  whole program, kernel COLD
        C.  variant program, kernel WARM
    python3 scripts/torch_repro_cold_build.py kernel-first
        B.  kernel alone, COLD
        A'. whole program, kernel WARM

Each leg is the host time of its first call up to a synchronize; a cold
leg is split into nvcc's seconds, the library's load, and the rest (the
program's first pass and the first launch). Every time is printed beside
the card's name and power limit.
"""

import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TILES, C, M, CHUNK = 8, 266, 1024, 256


def big_program(x, y, moments_like):
    import torch

    for i in range(24):
        x = x * (1.0 + 1e-6 * i) + torch.roll(x, i % 3, dims=-1) * 1e-7
    stats = moments_like(x, y)
    z = stats[..., 0] - stats[..., 32] + stats[..., 64] * 1e-9
    for i in range(24):
        z = torch.tanh(z * (1.0 - 1e-6 * i)) + 1e-8 * torch.cumsum(z, dim=-1)
    return torch.sum(z), stats


def main(order: str):
    import torch

    if order not in ("prog-first", "kernel-first"):
        raise SystemExit("usage: torch_repro_cold_build.py "
                         "prog-first|kernel-first")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_label
    from pct_tpu_torch.micro.moments_like import moments_like
    from pct_tpu_torch.ops import build

    label = card_label()
    build.BUILD_DIR = Path(tempfile.mkdtemp(prefix="cold_build_"))
    print(f"card: {label}\nbuild dir: {build.BUILD_DIR}", flush=True)
    laps = {"nvcc": 0.0, "load": 0.0}
    build_all, load = build.build_all, build.load

    def timed_build_all(names=None):
        t0 = time.perf_counter()
        try:
            return build_all(names)
        finally:
            laps["nvcc"] += time.perf_counter() - t0

    def timed_load(name):
        t0 = time.perf_counter()
        try:
            return load(name)
        finally:
            laps["load"] += time.perf_counter() - t0

    build.build_all, build.load = timed_build_all, timed_load
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((TILES, C, CHUNK), generator=gen, device="cuda")
    y = torch.randn((TILES, M, CHUNK), generator=gen, device="cuda")
    torch.cuda.synchronize()

    def timed(tag, fn):
        before = dict(laps)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        nvcc = laps["nvcc"] - before["nvcc"]
        lib = laps["load"] - before["load"] - nvcc
        split = (f" = nvcc {nvcc:.3f} s + library load {lib:.4f} s + "
                 f"program and first launch {dt - nvcc - lib:.4f} s"
                 if laps["load"] > before["load"] else "")
        print(f"[{label}] {tag}: {dt:8.4f} s{split}", flush=True)
        return dt

    try:
        if order == "prog-first":
            t_a = timed("A  whole program, kernel COLD",
                        lambda: big_program(x, y, moments_like))
            t_c = timed("C  variant program, kernel WARM",
                        lambda: big_program(x, y, moments_like)[0] + 1.0)
            print(f"verdict: cold-in-program pays {t_a - t_c:.3f} s over "
                  f"warm", flush=True)
        else:
            t_b = timed("B  kernel alone, COLD", lambda: moments_like(x, y))
            t_a2 = timed("A' whole program, kernel WARM",
                         lambda: big_program(x, y, moments_like))
            print(f"verdict: primed total = {t_b + t_a2:.3f} s (alone "
                  f"{t_b:.3f} + program {t_a2:.3f})", flush=True)
    finally:
        shutil.rmtree(build.BUILD_DIR, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "prog-first")
