"""Each per-layer metric's reader on a synthetic profiler record whose
answer is known, and the breakdown of the traced run."""

import pytest

from conftest import ROOT

MOMENTS = "void knn_warp::moments_kernel<true>(float const*, float const*, int const*, int const*, int const*, float*, int, int, int)"
ROWS = "void knn_warp::select_kernel<(anonymous namespace)::IdsOut<true>, true, 1>(float const*, float const*, int const*, int const*, int const*, (anonymous namespace)::IdsOut<true>, int, int, int)"
POS = "void knn_warp::select_kernel<(anonymous namespace)::IdsOut<false>, true, 1>(float const*, float const*, int const*, int const*, int const*, (anonymous namespace)::IdsOut<false>, int, int, int)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)"
CARD = "NVIDIA H100 80GB HBM3"


def record():
    """Two traced calls of 100 ms each, 50 ms apart (microseconds)."""
    from bench_port.trace import TraceRecord

    rec = TraceRecord()
    rec.calls = [(0.0, 100_000.0), (150_000.0, 250_000.0)]
    rec.device = [
        ("Memcpy HtoD (Pageable -> Device)", 0.0, 4_000.0),
        (MOMENTS, 10_000.0, 20_400.0),
        (TORCH, 30_000.0, 60_000.0),
        ("Memcpy HtoD (Pageable -> Device)", 150_000.0, 154_000.0),
        (MOMENTS, 160_000.0, 170_400.0),
        (TORCH, 180_000.0, 210_000.0),
        (TORCH, 120_000.0, 121_000.0),   # between the calls: in no call
    ]
    rec.cpu = [
        ("bench.call", 0.0, 100_000.0),
        ("aten::nonzero", 60_000.0, 99_000.0),
        ("cudaStreamSynchronize", 61_000.0, 98_000.0),
        ("bench.call", 150_000.0, 250_000.0),
    ]
    return rec


def ctx(rec=None, card=CARD):
    from bench_port.trace import TraceContext, port_kernel_names

    return TraceContext(rec or record(), 1_000_000, 100, card,
                        port_kernel_names(ROOT / "pct_tpu_torch" / "csrc"))


def reader(name):
    from bench_port.spec import load_reader

    return load_reader(name)


def test_port_kernel_names_come_from_the_sources():
    names = ctx().port_kernels
    for k in ("moments_kernel", "select_kernel", "select_block_kernel",
              "band_select_kernel"):
        assert k in names


def test_device_idle():
    # window 0..250 ms; busy 4 + 10.4 + 30 + 1 + 4 + 10.4 + 30 = 89.8 ms
    assert reader("device_idle")(ctx()) == pytest.approx(
        100 * (1 - 89.8 / 250))


def test_launches_per_call():
    # two kernels a call; the copies and the kernel between calls not
    assert reader("launches_per_call")(ctx()) == pytest.approx(2.0)


def test_torch_ops_ms():
    assert reader("torch_ops_ms")(ctx()) == pytest.approx(30.0)


def test_kernel_ms_and_roofline():
    assert reader("kernel_ms.moments")(ctx()) == pytest.approx(10.4)
    least_ms = 1e6 * (12 + 192) / 3.35e12 * 1e3
    assert reader("moments_roofline")(ctx()) == pytest.approx(
        100 * least_ms / 10.4)


def test_rows_reader_takes_rows_not_positions():
    from bench_port.trace import TraceRecord

    rec = TraceRecord(calls=[(0.0, 1000.0)], device=[
        (ROWS, 10.0, 110.0), (POS, 200.0, 900.0)])
    assert reader("kernel_ms.rows")(ctx(rec)) == pytest.approx(0.1)
    least_ms = 1e6 * (12 + 8 * 100) / 3.35e12 * 1e3
    assert reader("rows_roofline")(ctx(rec)) == pytest.approx(
        100 * least_ms / 0.1)


def test_nothing_to_read_gives_none():
    assert reader("kernel_ms.rows")(ctx()) is None
    assert reader("rows_roofline")(ctx()) is None
    assert reader("moments_roofline")(ctx(card="some other card")) is None


def test_breakdown_and_busy():
    from bench_port.trace import breakdown, busy_and_window

    b = breakdown(record())
    assert b["device_ops"][0] == [TORCH, pytest.approx(0.06)]
    assert b["device_ops"][1] == [MOMENTS, pytest.approx(0.0208)]
    gaps = dict(b["idle_gaps"])
    # a gap goes whole to what the host did at its middle: 60..120 ms
    # (middle 90 ms, a synchronise under nonzero)
    assert gaps["aten::nonzero > cudaStreamSynchronize"] == pytest.approx(0.060)
    assert sum(gaps.values()) == pytest.approx(0.250 - 0.0898)
    busy, win = busy_and_window(record())
    assert (busy, win) == (pytest.approx(0.0898), pytest.approx(0.25))
