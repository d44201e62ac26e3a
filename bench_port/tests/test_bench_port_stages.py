"""The stage readers (``stages.py``) on synthetic records whose answer is
known: the launch link, innermost-span attribution of device time,
launches and idle gaps, the synchronising calls, the counters' metrics;
and the existing readers, which read the same numbers whether or not a
trace holds the port's spans."""

import sys
from types import SimpleNamespace

import pytest

from conftest import ROOT
from test_bench_port_readers import CARD, MOMENTS, ROWS, TORCH

CPU, CUDA = "cpu", "cuda"


def stage_record():
    """One call of 1000 us: an entry span with stages inside it, and
    device events launched under each (times in microseconds)."""
    from bench_port.stages import StageRecord

    return StageRecord(
        calls=[(0.0, 1000.0)],
        spans=[("fast_curvature", 10.0, 900.0), ("grid", 20.0, 100.0),
               ("probe", 100.0, 300.0), ("run_table", 150.0, 200.0),
               ("kernel", 400.0, 420.0), ("fit", 500.0, 800.0)],
        device=[("k_grid", 50.0, 60.0, 30.0),
                ("k_runs", 210.0, 260.0, 160.0),
                ("k_probe", 270.0, 280.0, 250.0),
                ("Memcpy DtoH (Device -> Pageable)", 300.0, 310.0, 260.0),
                (MOMENTS, 430.0, 530.0, 410.0),
                ("k_fit", 600.0, 700.0, 550.0),
                ("k_entry", 880.0, 890.0, 850.0),
                ("k_unlinked", 950.0, 960.0, None),
                ("k_next_call", 1100.0, 1200.0, 1050.0)],
        syncs=[("cudaStreamSynchronize", 262.0, 268.0),
               ("cudaDeviceSynchronize", 962.0, 990.0)])


def test_innermost_span_owns_device_time_and_launches():
    from bench_port.stages import read

    got = read(stage_record())
    assert got["stage_ms.grid"] == pytest.approx(0.010)
    assert got["stage_ms.run_table"] == pytest.approx(0.050)
    # a copy adds time to its stage but no launch
    assert got["stage_ms.probe"] == pytest.approx(0.020)
    assert got["stage_launches.probe"] == 1
    assert got["stage_ms.fit"] == pytest.approx(0.100)
    assert "stage_ms.kernel" not in got
    assert got["kernel_ms_in_span"] == pytest.approx(0.100)
    # every device event of the call, the one past its end left out
    assert got["device_ms"] == pytest.approx(0.300)
    assert got["launches"] == 7
    assert got["launch_share_in_stages"] == pytest.approx(5 / 7)
    assert got["unattributed_ms"] == {"fast_curvature": pytest.approx(0.010),
                                      "None": pytest.approx(0.010)}
    assert "stage_ms.repair" not in got and "stage_ms.load" not in got


def test_idle_gap_goes_to_the_span_open_at_its_middle():
    from bench_port.stages import read

    got = read(stage_record())
    # gaps (0,50) mid 25: grid; (60,210) mid 135, (260,270), (280,300):
    # probe; (310,430) mid 370: the entry alone; (530,600), (700,880):
    # fit; (890,950), (960,1000): no span; past the call: not read
    assert got["stage_idle_ms.grid"] == pytest.approx(0.050)
    assert got["stage_idle_ms.probe"] == pytest.approx(0.180)
    assert got["stage_idle_ms.fit"] == pytest.approx(0.250)
    assert got["stage_idle_ms.run_table"] == 0.0
    assert got["unattributed_idle_ms"] == {
        "fast_curvature": pytest.approx(0.120), "None": pytest.approx(0.100)}


def test_host_syncs_count_the_waits_inside_the_port():
    from bench_port.stages import read

    got = read(stage_record())
    assert got["host_syncs"] == 1          # the harness's own is outside
    assert got["syncs_in_calls"] == 2


def test_detail_names_the_outer_stage_the_ops_and_the_waits():
    from bench_port.stages import detail

    got = detail(stage_record())
    assert got["by_path_ms"] == {
        "fast_curvature>probe>run_table": pytest.approx(0.050)}
    assert got["top_ops"]["probe"] == [
        ["k_probe", pytest.approx(0.010)],
        ["Memcpy DtoH (Device -> Pageable)", pytest.approx(0.010)]]
    assert got["syncs"] == {"probe": [1.0, pytest.approx(0.006)],
                            "None": [1.0, pytest.approx(0.028)]}


def test_values_are_per_call():
    from bench_port.stages import StageRecord, read

    one = stage_record()
    shift = lambda ev, d: (ev[0], *(None if x is None else x + d
                                    for x in ev[1:]))
    two = StageRecord(
        calls=one.calls + [(2000.0, 3000.0)],
        spans=one.spans + [shift(s, 2000.0) for s in one.spans],
        device=one.device[:-1] + [shift(e, 2000.0) for e in one.device[:-1]],
        syncs=one.syncs + [shift(s, 2000.0) for s in one.syncs])
    a, b = read(one), read(two)
    for key in ("stage_ms.probe", "stage_launches.fit", "stage_ms.grid",
                "host_syncs", "launches", "kernel_ms_in_span"):
        assert b[key] == pytest.approx(a[key]), key


def test_no_call_reads_nothing():
    from bench_port.stages import StageRecord, read

    assert read(StageRecord()) == {}


def event(eid, name, a, b, device=CPU, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        id=eid, name=name,
        time_range=SimpleNamespace(start=a, end=b),
        device_type=DeviceType.CUDA if device == CUDA else DeviceType.CPU,
        is_user_annotation=annotation)


def test_record_links_a_launch_to_its_runtime_call():
    """A device event's launch is the start of the runtime call with its
    correlation ``id``; an op or a span that happens to share the id is
    never taken for it."""
    from bench_port.stages import record

    events = [
        event(1, "bench.call", 0.0, 1000.0),
        event(900, "pct.kernel", 100.0, 200.0, annotation=True),
        event(900, "cudaLaunchKernel", 150.0, 160.0),
        event(3, "aten::mul", 300.0, 320.0),
        event(901, "cuLaunchKernel", 305.0, 315.0),
        event(4, "aten::nonzero", 400.0, 500.0),
        event(902, "cudaMemcpyAsync", 405.0, 408.0),
        event(903, "cudaStreamSynchronize", 410.0, 490.0),
        event(900, MOMENTS, 170.0, 400.0, device=CUDA),
        event(901, TORCH, 400.0, 420.0, device=CUDA),
        event(902, "Memcpy DtoH (Device -> Pageable)", 420.0, 425.0,
              device=CUDA),
        event(3, "Memset (Device)", 480.0, 485.0, device=CUDA),
        event(8, "pct.kernel", 170.0, 400.0, device=CUDA, annotation=True),
    ]
    rec = record(SimpleNamespace(events=lambda: events))
    assert rec.calls == [(0.0, 1000.0)]
    assert rec.spans == [("kernel", 100.0, 200.0)]
    assert rec.syncs == [("cudaStreamSynchronize", 410.0, 490.0)]
    assert rec.device == [(MOMENTS, 170.0, 400.0, 150.0),
                          (TORCH, 400.0, 420.0, 305.0),
                          ("Memcpy DtoH (Device -> Pageable)", 420.0, 425.0,
                           405.0),
                          ("Memset (Device)", 480.0, 485.0, None)]


def _profile(with_port_spans: bool):
    """Two traced calls as a CPU and CUDA profile, optionally with the
    port's spans on the host and their GPU-side annotations."""
    evs = [
        event(1, "bench.call", 0.0, 100_000.0),
        event(2, "aten::nonzero", 60_000.0, 99_000.0),
        event(3, "cudaStreamSynchronize", 61_000.0, 98_000.0),
        event(4, "bench.call", 150_000.0, 250_000.0),
        event(5, "Memcpy HtoD (Pageable -> Device)", 0.0, 4_000.0, CUDA),
        event(6, MOMENTS, 10_000.0, 20_400.0, CUDA),
        event(7, TORCH, 30_000.0, 60_000.0, CUDA),
        event(8, ROWS, 62_000.0, 63_000.0, CUDA),
        event(9, "Memcpy HtoD (Pageable -> Device)", 150_000.0, 154_000.0,
              CUDA),
        event(10, MOMENTS, 160_000.0, 170_400.0, CUDA),
        event(11, TORCH, 180_000.0, 210_000.0, CUDA),
        event(12, TORCH, 120_000.0, 121_000.0, CUDA),
    ]
    if with_port_spans:
        for base in (0.0, 150_000.0):
            for name, a, b in (("pct.load", 0.0, 5_000.0),
                               ("pct.fast_curvature", 6_000.0, 99_000.0),
                               ("pct.kernel", 9_000.0, 21_000.0),
                               ("pct.scatter", 59_000.0, 99_000.0)):
                evs.append(event(0, name, base + a, base + b,
                                 annotation=True))
                evs.append(event(0, name, base + a + 500.0, base + b,
                                 CUDA, annotation=True))
    return SimpleNamespace(events=lambda: evs)


EXISTING = ("device_idle", "launches_per_call", "torch_ops_ms",
            "kernel_ms.moments", "moments_roofline", "kernel_ms.rows",
            "rows_roofline")


@pytest.mark.parametrize("name", EXISTING)
def test_existing_readers_read_the_same_with_port_spans(name):
    from bench_port.spec import load_reader
    from bench_port.trace import TraceContext, _record, port_kernel_names

    kernels = port_kernel_names(ROOT / "pct_tpu_torch" / "csrc")
    got = []
    for spans in (False, True):
        rec = _record(_profile(spans))
        assert not any(e[0].startswith("pct.") for e in rec.device)
        got.append(load_reader(name)(TraceContext(
            rec, 1_000_000, 100, CARD, kernels)))
    assert got[0] is not None and got[0] == got[1]


def test_breakdown_device_ops_the_same_with_port_spans():
    from bench_port.trace import _record, breakdown

    plain, spans = (breakdown(_record(_profile(s))) for s in (False, True))
    assert plain["device_ops"] == spans["device_ops"]
    # a gap under Python alone is now put down to the port's span
    assert "python (no op open)" in dict(plain["idle_gaps"])
    assert "pct.fast_curvature" in dict(spans["idle_gaps"])


def test_fill_from_the_counters():
    from bench_port.stages import fill

    assert fill({}) == {}
    assert fill({"real_queries": 30, "query_slots": 120,
                 "real_candidates": 5, "candidate_slots": 50}) == {
        "slot_fill": 25.0, "candidate_fill": 10.0}
    assert fill({"rows": 1000, "repair_rows": 0}) == {"repaired_share": 0.0}


@pytest.mark.parametrize("name,want", [("slot_fill", 25.0),
                                       ("candidate_fill", 10.0),
                                       ("repaired_share", 2.0)])
def test_counter_metrics_read_the_ports_counters(monkeypatch, name, want):
    from bench_port.spec import load_reader
    from bench_port.trace import TraceContext, TraceRecord
    from pct_tpu_torch.utils import trace as port_trace

    read = load_reader(name)
    traced = TraceRecord(calls=[(0.0, 10.0)], device=[(TORCH, 1.0, 2.0)])
    ctx = TraceContext(traced, 1000, 100, CARD)
    port_trace.reset()
    assert read(ctx) is None                 # nothing counted yet
    for key, n in (("real_queries", 30), ("query_slots", 120),
                   ("real_candidates", 5), ("candidate_slots", 50),
                   ("rows", 1000), ("repair_rows", 20)):
        port_trace.count(key, n)
    try:
        assert read(ctx) == pytest.approx(want)
        # a run that traced no device activity (the CPU's) reads nothing
        assert read(TraceContext(TraceRecord(calls=[(0.0, 10.0)]), 1000,
                                 100, "cpu")) is None
        # a program without the counters (the parent's) reads nothing
        import pct_tpu_torch.utils

        monkeypatch.delattr(pct_tpu_torch.utils, "trace")
        monkeypatch.setitem(sys.modules, "pct_tpu_torch.utils.trace", None)
        assert read(ctx) is None
    finally:
        port_trace.reset()
