"""The per-layer metrics' readers. Each takes a ``trace.TraceContext``
and the parameters of its metric's file (``metrics/<name>.json``) and
returns a number, or None where the trace holds nothing to read: the
harness then leaves the metric out of the line.

Per call means per traced call: every reader divides by the number of
``bench.call`` spans and counts a device event in the call in whose
span it starts.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from bench_port.trace import (
    TraceContext, in_calls, is_memory_op, union_length, window)

PEAKS = Path(__file__).resolve().parent / "peaks.json"
COORD_BYTES = 12       # a real point's float32 xyz, read once


def _kernels(ctx: TraceContext):
    return [e for e in in_calls(ctx.record, ctx.record.device)
            if not is_memory_op(e[0])]


def _ms_per_call(ctx: TraceContext, events) -> float:
    return sum(b - a for _, a, b in events) * 1e-3 / len(ctx.record.calls)


def device_idle(ctx: TraceContext):
    """% of the traced window (first call's start to last call's end)
    in which no device activity ran."""
    if not ctx.record.calls or not ctx.record.device:
        return None
    lo, hi = window(ctx.record)
    busy = union_length([(e[1], e[2]) for e in ctx.record.device], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))


def launches_per_call(ctx: TraceContext):
    """Device kernels launched per call (copies and fills left out)."""
    kern = _kernels(ctx)
    return len(kern) / len(ctx.record.calls) if kern else None


def _is_port(name: str, port_kernels) -> bool:
    return any(re.search(rf"(?<![\w]){k}\s*[<(]", name) for k in port_kernels)


def torch_ops_ms(ctx: TraceContext):
    """Device ms per call of the kernels that are not the port's own
    (the port's: the ``__global__`` functions of its CUDA sources)."""
    kern = [e for e in _kernels(ctx) if not _is_port(e[0], ctx.port_kernels)]
    return _ms_per_call(ctx, kern) if kern else None


def kernel_ms(ctx: TraceContext, kernel: str):
    """Device ms per call of the kernels whose name matches ``kernel``."""
    kern = [e for e in _kernels(ctx) if re.search(kernel, e[0])]
    return _ms_per_call(ctx, kern) if kern else None


def roofline(ctx: TraceContext, kernel: str, out_bytes_per_query: int = 0,
             out_bytes_per_neighbour: int = 0):
    """% of the least time the kernel's work could take on the card: each
    real point's coordinates read once and each real query's result
    written once, ``out_bytes_per_query + k * out_bytes_per_neighbour``,
    against the card's published memory bandwidth (``peaks.json``; None
    for a card not in the table)."""
    ms = kernel_ms(ctx, kernel)
    with open(PEAKS) as f:
        peak = json.load(f).get(ctx.card)
    if ms is None or peak is None:
        return None
    per_point = (COORD_BYTES + out_bytes_per_query
                 + ctx.k * out_bytes_per_neighbour)
    least_ms = ctx.points * per_point / peak["hbm_bytes_per_s"] * 1e3
    return 100.0 * least_ms / ms
