#!/usr/bin/env python3
"""Where a call's time goes, stage by stage: device ms, launches and
idle ms under each of the port's ``pct.*`` spans
(``pct_tpu_torch.utils.trace``), the synchronising runtime calls inside
them, and the port's counters, from ``torch.profiler`` with CPU and CUDA
activity.

The stage of a device event is the innermost port span open on the host
when it was launched: a device event and the runtime call that launched
it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) carry the same
correlation ``id`` in the profile, and the runtime call's start is the
launch's host time. A gap of the
device goes whole to the innermost span open at its middle, the rule of
``trace.breakdown``. Times in microseconds on the profiler's clock; a
call is a ``trace.SPAN`` span, and a device event belongs to the call in
whose span it starts.

    python3 bench_port/stages.py --workload <cell> --seed <n> \
        [--calls 3] [--turns 2] [--out FILE]

runs the cell's calls on the card, after one warm pass over the pool:
untraced calls for the untraced median, then ``--turns`` pairs of
profiles of ``--calls`` calls, one with the spans on and one with
``span`` swapped for its no-op (off-on, on-off, ...), and a CUDA-only
profile as ``run.py``'s device profile records it. Prints one JSON
line: the stage table of the first profile with spans and its detail,
its coverage, the counters, the call medians, the no-profiler cost of a
span, and what the CUDA-only profile holds of the port's spans.
"""

from __future__ import annotations

import argparse
import gc
import json
import re
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.trace import (  # noqa: E402
    SPAN, idle_gaps, in_calls, is_memory_op)

PREFIX = "pct."
STAGES = ("load", "grid", "probe", "cells", "run_table", "candidates",
          "kernel", "fit", "scatter", "repair")
# runtime calls that make the host wait for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")
RUNTIME = re.compile(r"cu(da)?[A-Z]")    # cudaLaunchKernel, cuLaunchKernel, ...


@dataclass
class StageRecord:
    """Times in microseconds on the profiler's clock."""
    device: list = field(default_factory=list)  # (name, start, end, launch)
    spans: list = field(default_factory=list)   # (name, start, end), pct.*
    syncs: list = field(default_factory=list)   # (name, start, end)
    calls: list = field(default_factory=list)   # (start, end) of SPAN


def port_counters() -> dict:
    """The port's counters (``pct_tpu_torch.utils.trace.counters()``);
    empty where the port has none."""
    try:
        from pct_tpu_torch.utils import trace
    except ImportError:
        return {}
    return trace.counters()


def record(prof) -> StageRecord:
    """A profile with CPU and CUDA activity as a ``StageRecord``; a
    device event whose runtime call the profile lacks has launch None."""
    from torch.autograd import DeviceType

    rec = StageRecord()
    launched_at = {}
    device = []
    for e in prof.events():
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation and not e.name.startswith("bench."):
                device.append((e.name, a, b, e.id))
            continue
        if e.name == SPAN:
            rec.calls.append((a, b))
        elif e.name.startswith(PREFIX):
            rec.spans.append((e.name[len(PREFIX):], a, b))
        elif RUNTIME.match(e.name):
            launched_at[e.id] = a
            if e.name in SYNCS:
                rec.syncs.append((e.name, a, b))
    rec.device = sorted(((n, a, b, launched_at.get(c)) for n, a, b, c
                         in device), key=lambda ev: ev[1])
    rec.calls.sort()
    rec.spans.sort(key=lambda s: s[1])
    return rec


class Innermost:
    """The innermost port span open at a host time."""

    def __init__(self, spans):
        self.names = [s[0] for s in spans]
        self.start = np.array([s[1] for s in spans], dtype=np.float64)
        self.end = np.array([s[2] for s in spans], dtype=np.float64)

    def at(self, t) -> str | None:
        if t is None or not self.names:
            return None
        idx = np.nonzero((self.start <= t) & (self.end >= t))[0]
        if not idx.size:
            return None
        return self.names[idx[np.argmin(self.end[idx] - self.start[idx])]]

    def path(self, t) -> str:
        """Every port span open at ``t``, outermost first, joined by
        ">"."""
        if t is None or not self.names:
            return ""
        idx = np.nonzero((self.start <= t) & (self.end >= t))[0]
        idx = idx[np.argsort(self.start[idx] - self.end[idx], kind="stable")]
        return ">".join(self.names[i] for i in idx)


def read(rec: StageRecord) -> dict:
    """Per call: ``stage_ms.<S>``, ``stage_launches.<S>``,
    ``stage_idle_ms.<S>`` for each stage S but the kernel, ``host_syncs``;
    and the coverage figures ``kernel_ms_in_span`` (device ms under
    ``pct.kernel``), ``device_ms`` (every device event of the call),
    ``launches`` and ``launch_share_in_stages`` (the share of kernels
    launched under a stage span). Empty without a call."""
    if not rec.calls:
        return {}
    calls = len(rec.calls)
    inner = Innermost(rec.spans)
    ms, launches, idle = {}, {}, {}
    events = in_calls(rec, rec.device)
    for name, a, b, launch in events:
        stage = inner.at(launch)
        ms[stage] = ms.get(stage, 0.0) + (b - a)
        if not is_memory_op(name):
            launches[stage] = launches.get(stage, 0) + 1
    lo, hi = rec.calls[0][0], rec.calls[-1][1]
    for a, b in idle_gaps([(e[1], e[2]) for e in rec.device], lo, hi):
        stage = inner.at(0.5 * (a + b))
        idle[stage] = idle.get(stage, 0.0) + (b - a)
    out = {}
    for s in STAGES:
        if s == "kernel":
            continue
        if s in ms or s in idle:
            out[f"stage_ms.{s}"] = ms.get(s, 0.0) * 1e-3 / calls
            out[f"stage_launches.{s}"] = launches.get(s, 0) / calls
            out[f"stage_idle_ms.{s}"] = idle.get(s, 0.0) * 1e-3 / calls
    if rec.spans:
        syncs = [s for s in in_calls(rec, rec.syncs)
                 if inner.at(s[1]) is not None]
        out["host_syncs"] = len(syncs) / calls
    kernels = sum(launches.values())
    out.update(
        kernel_ms_in_span=ms.get("kernel", 0.0) * 1e-3 / calls,
        kernel_idle_ms_in_span=idle.get("kernel", 0.0) * 1e-3 / calls,
        device_ms=sum(ms.values()) * 1e-3 / calls,
        launches=kernels / calls,
        launch_share_in_stages=(sum(launches.get(s, 0) for s in STAGES)
                                / kernels if kernels else None),
        syncs_in_calls=len(in_calls(rec, rec.syncs)) / calls,
        unlinked=sum(e[3] is None for e in events) / calls,
        unattributed_ms={str(s): v * 1e-3 / calls for s, v in ms.items()
                         if s not in STAGES},
        unattributed_idle_ms={str(s): v * 1e-3 / calls
                              for s, v in idle.items() if s not in STAGES},
    )
    return out


def detail(rec: StageRecord, top: int = 3) -> dict:
    """Per call, for reading a stage table: device ms by the whole path
    of open spans where a stage runs inside another (``by_path_ms``);
    each stage's ``top`` device ops by ms (``top_ops``); the
    synchronising runtime calls under each stage, their count and host
    ms (``syncs``)."""
    calls = len(rec.calls)
    if not calls:
        return {}
    inner = Innermost(rec.spans)
    by_path, ops, syncs = {}, {}, {}
    for name, a, b, launch in in_calls(rec, rec.device):
        path = inner.path(launch)
        if path.count(">") > 1:
            by_path[path] = by_path.get(path, 0.0) + (b - a)
        per = ops.setdefault(str(inner.at(launch)), {})
        per[name] = per.get(name, 0.0) + (b - a)
    for name, a, b in in_calls(rec, rec.syncs):
        n, t = syncs.get(str(inner.at(a)), (0, 0.0))
        syncs[str(inner.at(a))] = (n + 1, t + b - a)
    return {
        "by_path_ms": {k: v * 1e-3 / calls for k, v in by_path.items()},
        "top_ops": {st: [[n[:100], v * 1e-3 / calls] for n, v in sorted(
            per.items(), key=lambda x: -x[1])[:top]]
            for st, per in ops.items()},
        "syncs": {st: [n / calls, t * 1e-3 / calls]
                  for st, (n, t) in syncs.items()},
    }


def fill(counters: dict) -> dict:
    """The counters' ratios, in %: ``slot_fill`` (real query slots over
    launched ones), ``candidate_fill`` (real candidates over candidate
    slots), ``repaired_share`` (rows repaired by brute force over rows
    checked); each only where its denominator was counted."""
    out = {}
    for name, num, den in (("slot_fill", "real_queries", "query_slots"),
                           ("candidate_fill", "real_candidates",
                            "candidate_slots"),
                           ("repaired_share", "repair_rows", "rows")):
        if counters.get(den):
            out[name] = 100.0 * counters.get(num, 0) / counters[den]
    return out


def counter_metric(ctx, name: str):
    """``fill(port_counters())[name]`` for a metric reader; None where
    the traced run caught no device activity (a run on the CPU, whose
    plain versions the benchmark does not measure) or the port keeps no
    such counter."""
    if not ctx.record.device:
        return None
    return fill(port_counters()).get(name)


def span_cost_ns(reps: int = 200_000) -> dict:
    """With no profiler running, the ns a ``with span(...)`` block
    costs (``span``), and the ns a call of a ``stage``-decorated function
    costs over the undecorated one (``stage``); each the best of 5."""
    from pct_tpu_torch.utils import trace

    def plain():
        pass

    spanned = trace.stage("grid")(plain)

    def best(body):
        out = float("inf")
        for _ in range(5):
            t0 = time.perf_counter_ns()
            body()
            out = min(out, (time.perf_counter_ns() - t0) / reps)
        return out

    def with_span():
        for _ in range(reps):
            with trace.span("grid"):
                pass

    def calls(fn):
        return lambda: [fn() for _ in range(reps)]

    return {"span": best(with_span),
            "stage": best(calls(spanned)) - best(calls(plain))}


def _profile(runner, pool, calls: int, first: int, cuda_only=False):
    """(profile, host seconds of each call) of ``calls`` calls, each in
    a ``SPAN``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA]
    if not cuda_only:
        acts.append(ProfilerActivity.CPU)
    walls = []
    with profile(activities=acts) as prof:
        for i in range(first, first + calls):
            t0 = time.perf_counter()
            with record_function(SPAN):
                runner.call(pool[i % len(pool)])
            walls.append(time.perf_counter() - t0)
    return prof, walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--turns", type=int, default=2,
                    help="profiles with spans on and off, each")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch

    from bench_port import harness
    from bench_port.spec import load_cell, load_json
    from bench_port.trace import TraceContext, _record
    from bench_port.traffic import make_pool

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    runner = harness.Runner(cell.config, cell.traffic, "cuda")
    pool = make_pool(cell.traffic, args.seed)
    runner.warm(pool, 1)
    i = 0
    plain = []
    for _ in range(4 * args.calls):
        t0 = time.perf_counter()
        runner.call(pool[i % len(pool)])
        plain.append(time.perf_counter() - t0)
        i += 1

    try:
        from pct_tpu_torch.utils import trace as port_trace
    except ImportError:
        port_trace = None
    walls = {"spans": [], "no_spans": []}
    first = None
    for turn in range(args.turns):
        for mode in sorted(walls, reverse=turn % 2 == 1):
            if port_trace is None and mode == "no_spans":
                continue
            gc.collect()
            saved = port_trace.span if port_trace is not None else None
            if mode == "no_spans":
                port_trace.span = lambda name: port_trace._NOOP
            if port_trace is not None:
                port_trace.reset()
            try:
                prof, w = _profile(runner, pool, args.calls, i)
            finally:
                if saved is not None:
                    port_trace.span = saved
            i += args.calls
            walls[mode] += w
            if first is None and mode == "spans":
                first = (prof, port_counters())
            del prof

    prof, counters = first
    rec = record(prof)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(), "calls": len(rec.calls),
           "stages": read(rec), "detail": detail(rec),
           "counters": counters, "fill": fill(counters)}
    # the name-matched kernel time of the same calls, as run.py reads it
    host = _record(prof)
    ctx = TraceContext(host, int(cell.traffic["points"]), runner.k,
                       out["card"])
    kernel = cell.config.get("roofline_kernel")
    if kernel:
        params = load_json(Path(__file__).parent / "metrics"
                           / f"kernel_ms.{kernel}.json")
        from bench_port import readers

        out["kernel_ms"] = readers.kernel_ms(ctx, params["kernel"])
    spans_a_call = len(rec.spans) / max(len(rec.calls), 1)
    out["spans_a_call"] = spans_a_call
    if port_trace is not None:
        out["span_ns"] = span_cost_ns()
        out["span_cost_us_a_call"] = (out["span_ns"]["span"]
                                      + out["span_ns"]["stage"]
                                      ) * spans_a_call * 1e-3
    out["call_median_s"] = {
        "untraced": statistics.median(plain),
        **{m: statistics.median(w) for m, w in walls.items() if w}}
    out["call_s"] = {"untraced": plain, **walls}

    cuda_prof, _ = _profile(runner, pool, 2, i, cuda_only=True)
    dev = _record(cuda_prof)
    from torch.autograd import DeviceType

    kinds = {}
    for e in cuda_prof.events():
        if e.name.startswith(PREFIX):
            key = (f"{'gpu' if e.device_type == DeviceType.CUDA else 'cpu'}"
                   f"{'_annotation' if e.is_user_annotation else ''}")
            kinds[key] = kinds.get(key, 0) + 1
    out["cuda_only_profile"] = {
        "pct_events": kinds,
        "pct_in_record_device": sum(e[0].startswith(PREFIX)
                                    for e in dev.device),
        "pct_in_record_cpu": sum(e[0].startswith(PREFIX) for e in dev.cpu),
        "cpu_events": len(dev.cpu)}
    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
