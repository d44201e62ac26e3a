#!/usr/bin/env python3
"""The coords select against its tensor-core extraction variant, on one
NVIDIA card.

Counterpart of the JAX package's TPU A/B script
``scripts/micro_select_mxu.py``, at its shape: T=8192 cell rows, C=128
query slots, M=504 candidate slots, k=20, on its operand recipe
(``make_inputs``: candidates scattered around their tile's queries,
seeded numpy draws). First the parity: the variant
(``select_coords_mxu``, ``csrc/select_mxu.cu``: winners extracted as a
one-hot product on the tensor cores, FP64 ``mma.sync``) against the
production select (``knn_select_coords``, ``csrc/select_coords.cu``) on
found slots, and against its own plain version on every slot. Then both
kernels timed (CUDA-event medians) and their rates in million queries a
second, beside the card's name and power limit.

Run from the root of a checkout:
    python3 scripts/torch_micro_select_mxu.py [--reps N]
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
    from pct_tpu_torch.micro.select_mxu import (
        SCRIPT_SHAPE,
        make_inputs,
        select_coords_mxu,
        select_coords_mxu_plain,
    )
    from pct_tpu_torch.ops.select import knn_select_coords

    label = card_label()
    print(f"card: {label}", flush=True)
    T, C, M, k = SCRIPT_SHAPE
    ops = make_inputs(T, C, M, seed=0, device="cuda")
    d0, n0 = knn_select_coords(*ops, k)
    d1, n1, r1 = select_coords_mxu(*ops, k)
    torch.cuda.synchronize()
    found = d0 < 1e18
    ed = float((d0 - d1).abs()[found].max())
    en = float((n0 - n1).abs().amax(-1)[found].max())
    print(f"parity: max|d|={ed:.3e} max|coords|={en:.3e} on "
          f"{int(found.sum())} found slots of {found.numel()}", flush=True)
    plain = select_coords_mxu_plain(*ops, k)
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip((d1, n1, r1), plain))
    print(f"variant vs its plain version: bit-identical {same}", flush=True)
    if not (same and ed == 0.0 and en == 0.0):
        raise SystemExit("parity failed")
    del plain
    q = T * C
    for tag, fn in (("base", lambda: knn_select_coords(*ops, k)),
                    ("mxu ", lambda: select_coords_mxu(*ops, k))):
        ms = event_ms(fn, args.reps)
        print(f"[{label}] {tag}: {ms:8.3f} ms  ({q / ms / 1e3:.2f} Mq/s)",
              flush=True)


if __name__ == "__main__":
    main()
