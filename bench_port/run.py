#!/usr/bin/env python3
"""Run one cell of the port's benchmark on one NVIDIA card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (entry point, k, method) and a
traffic mix (a pool of clouds made from the seed). The run warms every
cloud of the pool, runs a closed loop of calls for ``--seconds``,
checks a seeded sample of every call's outputs against the plain
reference (``reference.py``), and prints one JSON line last on standard
output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from ``torch.profiler`` over a
few calls of the window. The set-up's parts, the call count and each
compared number beside its limit go to standard error, the numbers
last.

Exits non-zero, with no result line, without a CUDA card (or with fewer
than the cell asks for), when the port cannot be imported, or when JAX
or the JAX package ``pct_tpu`` is loaded once the window has closed.
"""

import time

T_SCRIPT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WARMUP_PASSES = 2


class Refused(Exception):
    """The run cannot give a result."""


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def process_start() -> float:
    """``time.perf_counter()`` reading of this process's start (from
    /proc; the script's first line where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_SCRIPT
    return time.perf_counter() - max(age, 0.0)


def card_label() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, wrap=None, warmup_passes: int = WARMUP_PASSES,
             rows_per_call: int | None = None, stamps=()) -> dict:
    """One run of ``cell``; returns the result line as a dict. The
    set-up's parts are logged from ``t_start`` (the process's start)
    through ``stamps`` ((name, perf_counter) pairs taken before the
    call) to the first timed call."""
    import numpy as np
    import torch

    from bench_port import check, harness, trace as trace_mod
    from bench_port.spec import load_reader
    from bench_port.traffic import make_pool

    t = {"start": t_start, "script": T_SCRIPT, **dict(stamps),
         "harness": time.perf_counter()}
    runner = harness.Runner(cell.config, cell.traffic, device, wrap)
    t["port"] = time.perf_counter()
    dev = runner.device
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    t["cuda"] = time.perf_counter()
    pool = make_pool(cell.traffic, seed)
    n = int(cell.traffic["points"])
    rows = rows_per_call or int(cell.checks["rows_per_call"])
    sampler = harness.Sampler(n, rows, seed, dev)
    t["clouds"] = time.perf_counter()
    clocks = ClockLog() if dev.type == "cuda" else None
    t["nvml"] = time.perf_counter()
    logs = harness.build_logs()
    warm_calls = runner.warm(pool, warmup_passes)
    built = harness.nvcc_seconds(logs)
    t["warm"] = time.perf_counter()
    tracer = trace_mod.Tracer(trace)
    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        w = runner.window(pool, seconds, sampler, tracer, log)
        log(host_line(ru))
    finally:
        if clocks is not None:
            clocks.close()
    if clocks is not None:
        log(clocks.summary(w.start, w.start + w.seconds))
    found = harness.forbidden_modules()
    if found:
        raise Refused(f"loaded after the window: {', '.join(found)}")
    if w.failed == len(w.times):
        raise Refused(f"all {w.failed} calls of the window failed")

    steps = list(t.items())
    parts = ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                      for a, b in zip(steps, steps[1:]))
    nvcc = (", ".join(f"{k} {v:.2f} s" for k, v in sorted(built.items()))
            or "none, every library cached")
    setup_s = w.start - t_start
    log(f"setup {setup_s:.3f} s: {parts} ({warm_calls} warm-up calls); "
        f"nvcc this run: {nvcc}")
    done = [x for x in w.times if x != float("inf")]
    log(f"window {w.seconds:.3f} s: {len(w.times)} calls, {w.failed} failed; "
        f"call median {np.median(done) if done else float('nan'):.4f} s, "
        f"p95 {harness.p95(w.times):.4f} s over {len(w.times)} calls")

    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": cell.chips,
        "memory_peak_bytes": w.peak_bytes,
    }
    result = {"correct": False, "attempted": len(w.times), "failed": w.failed}
    if trace:
        record, host_record = tracer.records()
        ctx = trace_mod.TraceContext(
            record, n, runner.k, device_info["kind"],
            trace_mod.port_kernel_names(harness.build_dir().parent / "csrc"))
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy, win = trace_mod.busy_and_window(record)
        device_info.update(busy_s=busy, window_s=win)
        result.update(metrics=metrics, device=device_info,
                      breakdown=trace_mod.breakdown(record, host_record))
        log(f"traced {len(record.calls)} calls on the device: "
            f"{len(record.device)} device events, busy {busy:.4f} of "
            f"{win:.4f} s; {len(host_record.calls)} with the host's ops")
    else:
        values = {
            "points_per_s": (len(w.times) - w.failed) * n / w.seconds,
            "call_p95_s": harness.p95(w.times),
            "peak_device_gb": w.peak_bytes / 1e9,
            "setup_s": setup_s,
        }
        result.update(metrics={m["name"]: {"value": values[m["name"]],
                                           "unit": m["unit"]}
                               for m in cell.end_to_end},
                      device=device_info)

    sample = sampler.collect()
    del sampler, runner
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = harness.reference_rows(sample, pool, int(cell.config["k"]), dev)
    nums = check.numbers(sample, ref, lambda j: pool[j])
    ok, checks = check.judge(nums, cell.checks["limits"])
    log(f"reference: {sample['row'].shape[0]} sampled rows of "
        f"{len(w.times) - w.failed} calls in {time.perf_counter() - t_ref:.3f} "
        f"s, {nums['tied_rows']} tied at the kth neighbour")
    result["correct"] = bool(ok and w.failed == 0)
    result["checks"] = checks
    return result


def host_line(before) -> str:
    """The host's share in the window: the CPUs the process may use, and
    its CPU seconds and context switches since ``before`` (a
    getrusage)."""
    now = resource.getrusage(resource.RUSAGE_SELF)
    return (f"host: cpus allowed {sorted(os.sched_getaffinity(0))}; "
            f"in the window "
            f"user {now.ru_utime - before.ru_utime:.3f} s, "
            f"sys {now.ru_stime - before.ru_stime:.3f} s, "
            f"{now.ru_nvcsw - before.ru_nvcsw} voluntary and "
            f"{now.ru_nivcsw - before.ru_nivcsw} involuntary switches")


class ClockLog:
    """The card's SM clock, power draw, temperature and clock-event
    reasons every half second through the window, read from NVML
    (``libnvidia-ml``, through ctypes) by a thread of this process;
    ``close`` stops the thread and waits for it."""

    PERIOD_S = 0.5

    def __init__(self, index: int = 0):
        import ctypes

        self.samples = []
        self.thread = None
        self.stop = threading.Event()
        try:
            nvml = ctypes.CDLL("libnvidia-ml.so.1")
            handle = ctypes.c_void_p()
            if (nvml.nvmlInit_v2() != 0 or nvml.nvmlDeviceGetHandleByIndex_v2(
                    index, ctypes.byref(handle)) != 0):
                return
        except (OSError, AttributeError):
            return
        self.nvml, self.handle, self.ct = nvml, handle, ctypes
        self.thread = threading.Thread(target=self._poll, daemon=True)
        self.thread.start()

    def _poll(self):
        ct, nvml, h = self.ct, self.nvml, self.handle
        sm, mw, temp = ct.c_uint(), ct.c_uint(), ct.c_uint()
        why = ct.c_ulonglong()
        while not self.stop.is_set():
            ok = (nvml.nvmlDeviceGetClockInfo(h, 1, ct.byref(sm)) == 0
                  and nvml.nvmlDeviceGetPowerUsage(h, ct.byref(mw)) == 0
                  and nvml.nvmlDeviceGetTemperature(h, 0, ct.byref(temp)) == 0)
            if nvml.nvmlDeviceGetCurrentClocksThrottleReasons(
                    h, ct.byref(why)) != 0:
                why.value = 0
            if ok:
                self.samples.append((time.perf_counter(), sm.value,
                                     mw.value / 1000.0, temp.value, why.value))
            self.stop.wait(self.PERIOD_S)

    def close(self):
        if self.thread is not None:
            self.stop.set()
            self.thread.join(timeout=10)
            self.nvml.nvmlShutdown()

    def summary(self, t0: float, t1: float) -> str:
        """min / median / max of each quantity sampled in [t0, t1], and
        every clock-event reason seen (NVML's bits)."""
        cols = [s[1:] for s in self.samples if t0 <= s[0] <= t1]
        if not cols:
            return "card in the window: no NVML sample"
        sm, power, temp, why = zip(*cols)
        reasons = 0
        for r in why:
            reasons |= r
        parts = [f"{name} {min(v):g} / {statistics.median(v):g} / {max(v):g} "
                 f"{unit}" for name, unit, v in (("sm clock", "MHz", sm),
                                                  ("power", "W", power),
                                                  ("temperature", "C", temp))]
        return (f"card in the window ({len(cols)} NVML samples, min / median"
                f" / max): {', '.join(parts)}; clock-event reasons "
                f"{reasons:#x}")


def finite(obj):
    """``obj`` with every non-finite float written as a string ("inf")."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    sys.path.insert(0, str(ROOT))
    from bench_port.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    stamps = [("torch", time.perf_counter())]
    if not torch.cuda.is_available():
        log("no CUDA card: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"the cell asks for {cell.chips} cards; "
            f"{torch.cuda.device_count()} present")
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", t_start, stamps=stamps)
    except Refused as exc:
        log(f"refused: {exc}")
        return 3
    log(f"card: {card_label()}")
    from bench_port.harness import forbidden_modules

    found = forbidden_modules()
    if found:
        log(f"refused: loaded at the end: {', '.join(found)}")
        return 3
    log(f"correct {str(result['correct']).lower()}; the numbers compared:")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
