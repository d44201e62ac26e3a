#!/usr/bin/env python3
"""The two readings each limit of a cell's check is set between, on the
card at the cell's own size, in one process.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 4] [--rows-per-call 1024] [--out FILE]

For every seed: the program's pool is made and warmed, the timed path
runs a short window at the cell's load with ``--rows-per-call`` sampled
rows a call (set it so a seed compares as many rows as a full run does),
and the check's numbers are read twice on the same rows: the program
against the reference (the lower readings) and the control against the
reference (the upper readings). The control is the reference itself in
the program's place, computed in float32 with TF32 (``reference.py``),
the precision below the configuration's float32 with TF32 off. One JSON
line a seed, then the summary: the largest program reading and the
smallest control reading of each number. The benchmark's own runs do
not run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_sample(sample: dict, ctrl: dict, with_neighbours: bool) -> dict:
    """The control's outputs in the program's place: every row
    certified, the kth distance (and the neighbours, on routes that
    return them) from the control's own kNN."""
    import numpy as np

    out = {key: sample[key] for key in ("call", "cloud", "row")}
    out.update(K=ctrl["K"], H=ctrl["H"], k1=ctrl["k1"], k2=ctrl["k2"],
               normals=ctrl["normals"], kth=np.sqrt(ctrl["d2"][:, -1]))
    if with_neighbours:
        out.update(ids=ctrl["ids"], dists=np.sqrt(ctrl["d2"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--rows-per-call", type=int, default=1024)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port import check, harness
    from bench_port.spec import load_cell
    from bench_port.trace import Tracer
    from bench_port.traffic import make_pool

    cell = load_cell(args.workload)
    runner = harness.Runner(cell.config, cell.traffic, "cuda")
    k = runner.k
    n = int(cell.traffic["points"])
    rows_out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        pool = make_pool(cell.traffic, seed)
        runner.warm(pool, 1)
        sampler = harness.Sampler(n, args.rows_per_call, seed, runner.device)
        w = runner.window(pool, args.seconds, sampler, Tracer(False))
        sample = sampler.collect()
        del sampler
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = harness.reference_rows(sample, pool, k, runner.device)
        t_ref = time.perf_counter() - t0
        line = {"seed": seed, "calls": len(w.times), "failed": w.failed,
                "rows": int(sample["row"].size), "reference_s": t_ref,
                "program": check.numbers(sample, ref, lambda j: pool[j])}
        ctrl = harness.reference_rows(sample, pool, k, runner.device,
                                      torch.float32, tf32=True, ids=True)
        line["control"] = check.numbers(
            control_sample(sample, ctrl, "ids" in sample), ref,
            lambda j: pool[j])
        rows_out.append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows_out),
               "lower": {}, "upper": {}}
    for name in rows_out[0]["program"]:
        summary["lower"][name] = max(r["program"][name] for r in rows_out)
        summary["upper"][name] = min(r["control"][name] for r in rows_out)
    print(json.dumps(summary), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for line in rows_out + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
