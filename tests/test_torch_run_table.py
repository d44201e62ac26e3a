"""The run table's suffix-min (``ops.run_table``): the plain version
against numpy on the CPU, the wrapper's refusals, and on the card the
kernel against the plain version, bit for bit. This file imports no JAX,
so its card tests also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_run_table.py -q
"""

from collections import Counter

import numpy as np
import pytest
import torch

from pct_tpu_torch.ops import build
from pct_tpu_torch.ops.run_table import suffix_min_, suffix_min_plain
from pct_tpu_torch.utils import trace

SIZES = [1, 2, 4095, 4096, 4097, 65537]
KINDS = ["random", "sentinel", "duplicates"]
SYMBOLS = ("pct_run_table_tile_min", "pct_run_table_suffix_min")


def _table(size: int, kind: str, seed: int = 0) -> np.ndarray:
    """random: any int32, INT32_MIN and INT32_MAX among them; sentinel:
    ``_runs_table``'s table, every box the end row but a sparse set of
    increasing start rows; duplicates: few distinct values."""
    rng = np.random.default_rng([seed, size, KINDS.index(kind)])
    info = np.iinfo(np.int32)
    if kind == "random":
        t = rng.integers(info.min, info.max, size, endpoint=True,
                         dtype=np.int64).astype(np.int32)
        t[rng.integers(0, size, max(1, size // 64))] = info.max
        t[rng.integers(0, size, max(1, size // 64))] = info.min
    elif kind == "sentinel":
        t = np.full(size, 10 * size, dtype=np.int32)
        at = np.sort(rng.choice(size, max(1, size // 40), replace=False))
        t[at] = np.cumsum(rng.integers(1, 30, at.size)).astype(np.int32)
    else:
        t = rng.integers(-3, 4, size).astype(np.int32)
    return t


def _want(t: np.ndarray) -> np.ndarray:
    return np.minimum.accumulate(t[::-1])[::-1]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES)
def test_plain_is_numpy_suffix_min(size, kind):
    """``suffix_min_plain`` is numpy's reverse running minimum, and the
    wrapper on a CPU tensor writes it in place."""
    t = _table(size, kind)
    want = _want(t)
    src = torch.from_numpy(t.copy())
    got = suffix_min_plain(src)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(src.numpy(), t)        # input kept
    before = trace.counters()
    out = suffix_min_(src)
    assert out is src and trace.counters() == before     # no launch
    np.testing.assert_array_equal(src.numpy(), want)


@pytest.mark.parametrize("case", ["int64", "2-D", "strided", "meta"])
def test_wrapper_refuses_before_loading(monkeypatch, case):
    """Each refusal raises ``ValueError`` before a library is loaded and
    counts no launch."""
    def no_load(name):
        raise AssertionError(f"{name} loaded before the checks")

    monkeypatch.setattr(build, "load", no_load)
    table, match = {
        "int64": (torch.zeros(8, dtype=torch.int64), "int32"),
        "2-D": (torch.zeros(2, 4, dtype=torch.int32), "1-D"),
        "strided": (torch.zeros(16, dtype=torch.int32)[::2], "contiguous"),
        "meta": (torch.zeros(8, dtype=torch.int32, device="meta"),
                 "no run_table kernel for device meta"),
    }[case]
    before = trace.counters()
    with pytest.raises(ValueError, match=match):
        suffix_min_(table)
    assert trace.counters() == before


# --- on the card ---

def _launches() -> Counter:
    return Counter({s: trace.counters().get("launches." + s, 0)
                    for s in SYMBOLS})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES + [1 << 22, 1 << 23])
def test_kernel_matches_plain(cuda, size, kind):
    """The kernel's table equals the plain version's bit for bit, in two
    launches, one of each pass; a view one int past an aligned address
    takes the scalar loads and leaves the box before it alone."""
    t = torch.from_numpy(_table(size, kind)).to(cuda)
    want = suffix_min_plain(t)
    got = t.clone()
    before = _launches()
    assert suffix_min_(got) is got
    torch.cuda.synchronize()
    assert _launches() - before == Counter({s: 1 for s in SYMBOLS})
    assert torch.equal(got, want)
    buf = torch.cat([torch.tensor([7], dtype=torch.int32, device=cuda), t])
    suffix_min_(buf[1:])
    torch.cuda.synchronize()
    assert int(buf[0]) == 7 and torch.equal(buf[1:], want)


@pytest.mark.cuda
def test_runs_table_kernel_matches_plain_on_1m_torus(cuda, monkeypatch):
    """``_runs_table`` on the 1M torus's grid at k=20 and k=100: the
    same run starts and lengths with the kernel as with the plain path,
    and two launches, one of each pass, a table."""
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.shapes import generate_shape

    pts, _ = generate_shape("torus", 1_000_000, radius=1.0)
    cloud = from_numpy(pts, pad_multiple=1 << 16, device=cuda)
    n = cloud.num_points
    for k in (20, 100):
        grid = build_grid(cloud.points, n,
                          estimate_cell_size(cloud.points, n, k))
        _, mc = cellknn.probe_grid_buckets(grid)
        cells = cellknn.compact_cells(grid, mc)
        before = _launches()
        rs, run_len = cellknn._runs_table(grid, cells)
        torch.cuda.synchronize()
        assert _launches() - before == Counter({s: 1 for s in SYMBOLS})
        with monkeypatch.context() as m:
            m.setattr(cellknn, "suffix_min_",
                      lambda t: t.copy_(suffix_min_plain(t)))
            rs_p, run_len_p = cellknn._runs_table(grid, cells)
        assert torch.equal(rs, rs_p) and torch.equal(run_len, run_len_p)
        assert int(run_len.sum()) > 0
