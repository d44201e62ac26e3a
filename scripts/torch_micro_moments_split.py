#!/usr/bin/env python3
"""Where the moments kernel's time goes, stage by stage, on one NVIDIA card.

Counterpart of the JAX package's TPU script
``scripts/micro_moments_split.py``: the same three k=100 buckets of the
1M torus, (T, C, M) = (11776, 56, 168), (7680, 72, 216), (4096, 120,
312), on that script's operand recipe (``make_args``: normal points,
seeded numpy draws). For each bucket it times, as CUDA-event medians:

- the production kernel, ``knn_moments`` (``csrc/moments.cu``: τ by the
  four-pass radix select);
- every mode of ``moments_variant`` (``csrc/moments_split.cu``) at tb=1:
  the bisection as the TPU ran it (``full``), 26 fixed rounds, 4-ary and
  8-ary rounds, false position, no search, no moment sums, no
  nearest/kth pass, d² and one count only;
- ``full`` at tb = 4, 8, 16 cell rows a block;
- ``quad``, ``quad_fixed``, ``oct_fixed`` and ``interp4`` at tb=8;

and prints each one's largest absolute difference from the production
output (the fixed-round modes and ``no_bisect`` stop away from τ, the
stage-dropping modes zero their columns: their differences are the
modes' own). Every time is printed beside the card's name and power
limit.

Run from the root of a checkout:
    python3 scripts/torch_micro_moments_split.py [--reps N]
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_label, event_ms
    from pct_tpu_torch.micro.moments_split import (
        MODES,
        SCRIPT_BUCKETS,
        SCRIPT_K,
        make_args,
        moments_variant,
    )
    from pct_tpu_torch.ops.moments import knn_moments

    label = card_label()
    print(f"card: {label}", flush=True)
    k = SCRIPT_K
    for t, c, m in SCRIPT_BUCKETS:
        print(f"bucket t={t} c={c} m={m} k={k}", flush=True)
        ops = make_args(t, c, m, seed=0, device="cuda")
        base = knn_moments(*ops, k)

        def timed(tag, fn):
            out = fn()
            ms = event_ms(fn, args.reps)
            d = float((out - base).abs().max())
            print(f"[{label}]   {tag:22s} {ms:8.3f} ms   max abs diff vs "
                  f"prod {d:.2e}", flush=True)

        timed("prod knn_moments", lambda: knn_moments(*ops, k))
        for mode in MODES:
            timed(f"{mode} tb=1",
                  lambda mode=mode: moments_variant(*ops, k, mode=mode))
        for tb in (4, 8, 16):
            timed(f"full tb={tb}",
                  lambda tb=tb: moments_variant(*ops, k, tb=tb))
        for mode in ("quad", "quad_fixed", "oct_fixed", "interp4"):
            timed(f"{mode} tb=8",
                  lambda mode=mode: moments_variant(*ops, k, tb=8, mode=mode))
        del ops, base
    print(f"each time the median of {args.reps} CUDA-event timings of one "
          f"call", flush=True)


if __name__ == "__main__":
    main()
