"""The traced run: ``torch.profiler`` over a few calls in the middle of
the window, reduced to plain lists of events that the metric readers
and the breakdown read.

The method of the busy time is the repository's trace script's
(``scripts/torch_trace_fast_curvature.py``), copied: the union of the
device's activity intervals. A call is traced between the
``bench.call`` spans this module records around it (the host array to
``from_numpy`` through the synchronise after the entry point), and a
device event belongs to the call in whose span it starts.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

SPAN = "bench.call"
WARM_SPAN = "bench.warm"
SHORT_GAP_US = 10.0
MARKER = "spin_kernel"    # torch.cuda._sleep's kernel


@dataclass
class TraceRecord:
    """Times in microseconds on the profiler's clock."""
    device: list = field(default_factory=list)   # (name, start, end)
    cpu: list = field(default_factory=list)      # (name, start, end)
    calls: list = field(default_factory=list)    # (start, end) of SPAN


@dataclass
class TraceContext:
    """What a reader gets: the record and the cell's sizes."""
    record: TraceRecord
    points: int                 # real points a call
    k: int
    card: str                   # torch.cuda.get_device_name()
    port_kernels: tuple = ()    # __global__ names of the port's sources


def is_memory_op(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps of the union of ``intervals`` inside [lo, hi]."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def window(record: TraceRecord):
    """(start, end) of the traced calls, from the first to the last."""
    return record.calls[0][0], record.calls[-1][1]


def in_calls(record: TraceRecord, events):
    """The events that start inside a traced call's span."""
    starts = np.array([c[0] for c in record.calls])
    ends = np.array([c[1] for c in record.calls])
    out = []
    for ev in events:
        i = np.searchsorted(starts, ev[1], side="right") - 1
        if i >= 0 and ev[1] <= ends[i]:
            out.append(ev)
    return out


class HostTimeline:
    """What the host was doing at a time: the innermost CPU event around
    it, with its parent where the innermost is a runtime call; "python"
    where only the benchmark's own span was open."""

    def __init__(self, cpu):
        self.names = [e[0] for e in cpu]
        self.start = np.array([e[1] for e in cpu])
        self.end = np.array([e[2] for e in cpu])

    def at(self, t: float) -> str:
        idx = np.nonzero((self.start <= t) & (self.end >= t))[0]
        around = [self.names[i] for i in
                  idx[np.argsort(self.end[idx] - self.start[idx])]]
        if not around or around[0] in (SPAN, WARM_SPAN):
            return "python (no op open)"
        if not around[0].startswith("aten::") and len(around) > 1 \
                and around[1] not in (SPAN, WARM_SPAN):
            return f"{around[1]} > {around[0]}"
        return around[0]


def breakdown(record: TraceRecord, host_record: TraceRecord | None = None,
              top: int = 10) -> dict:
    """The device ops that took most time over ``record``'s calls, and
    the device's idle time over ``host_record``'s calls (default: the
    same) by what the host was doing, both in seconds. A gap of the
    device goes whole to what the host was doing at its middle."""
    by_op: dict = {}
    for name, a, b in in_calls(record, record.device):
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
    record = record if host_record is None else host_record
    lo, hi = window(record)
    host = HostTimeline([e for e in record.cpu if e[2] >= lo and e[1] <= hi])
    by_host: dict = {}
    for a, b in idle_gaps([(e[1], e[2]) for e in record.device], lo, hi):
        name = (f"gaps under {SHORT_GAP_US:g} us" if b - a < SHORT_GAP_US
                else host.at(0.5 * (a + b)))
        by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6
    rank = lambda d: [[n[:200], s] for n, s in
                      sorted(d.items(), key=lambda x: -x[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def busy_and_window(record: TraceRecord) -> tuple[float, float]:
    """(device busy seconds, traced window seconds)."""
    lo, hi = window(record)
    busy = union_length([(e[1], e[2]) for e in record.device], lo, hi)
    return busy * 1e-6, (hi - lo) * 1e-6


def port_kernel_names(csrc: Path) -> tuple:
    """The ``__global__`` function names in the port's CUDA sources."""
    import re

    names = set()
    for src in sorted(csrc.glob("*.cu*")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)",
            src.read_text()))
    return tuple(sorted(names))


class Tracer:
    """Two profiles in the window, one after the other.

    - Device profile (CUDA activity only, so the host runs at its
      untraced pace): calls ``first + 1`` .. ``first + calls``, after one
      call that absorbs the profiler's start. A ``MARKER`` kernel is
      queued at each traced call's start and after the last, and a call
      is the device time from its marker to the next. The readers and
      ``busy_s`` / ``window_s`` read this profile.
    - Host profile (CPU and CUDA activity): the next ``host_calls``
      calls, after one more, each in a ``SPAN``; the breakdown names the
      device's idle gaps by what the host was doing here. Recording
      every host op slows these calls, so no metric reads them.

    On the CPU the device profile records host activity and its calls
    are the ``SPAN`` s. ``enabled=False`` records nothing.
    """

    def __init__(self, enabled: bool, first: int = 2, calls: int = 8,
                 host_calls: int = 3):
        self.enabled = enabled
        self.dev_range = (first, first + calls)
        self.host_range = (first + calls + 1, first + calls + 1 + host_calls)
        self.profs = []
        self.done = not enabled

    def _start(self, cuda_only: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA] if cuda else []
        if not (cuda and cuda_only):
            acts.append(ProfilerActivity.CPU)
        self.profs.append(profile(activities=acts))
        self.profs[-1].start()

    def _marker(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda._sleep(1)

    def span(self, i: int):
        if not self.enabled:
            return contextlib.nullcontext()
        (d0, d1), (h0, h1) = self.dev_range, self.host_range
        if i in (d0, h0):
            self._start(cuda_only=i == d0)
        if d0 < i <= d1:
            self._marker()
        if not (d0 <= i <= d1 or h0 <= i <= h1):
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(WARM_SPAN if i in (d0, h0) else SPAN)

    def after(self, i: int):
        if not self.enabled:
            return
        if i == self.dev_range[1]:
            self._marker()
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.profs[0].stop()
        if i == self.host_range[1]:
            self.profs[1].stop()
            self.done = True

    def records(self) -> tuple:
        """(device profile's record, host profile's record)."""
        return tuple(_record(p) for p in self.profs)


def _record(prof) -> TraceRecord:
    from torch.autograd import DeviceType

    rec = TraceRecord()
    markers = []
    for e in prof.events():
        ev = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if MARKER in e.name:
                markers.append(ev[1])
            elif not e.is_user_annotation and not e.name.startswith("bench."):
                rec.device.append(ev)
        elif e.name == SPAN:
            rec.calls.append(ev[1:])
        else:
            rec.cpu.append(ev)
    if markers:
        markers.sort()
        spans = list(zip(markers, markers[1:]))
        # a marker the trace lost would merge two calls into one span
        limit = 1.5 * float(np.median([b - a for a, b in spans]))
        rec.calls = [(a, b) for a, b in spans if b - a <= limit]
    rec.calls.sort()
    rec.device.sort(key=lambda e: e[1])
    return rec
