"""The port's stage spans and counters (``pct_tpu_torch.utils.trace``)
on the CPU: ``fast_curvature`` at k=20 (list engine) and k=100 (moments
engine) and ``curvature_pipeline`` at k=20 under a CPU
``torch.profiler``, each route once on a small perturbed torus.

Every stage span appears where its route runs it, nested as the module
states (``run_table`` inside ``probe`` and inside ``cells``, every other
stage inside the entry point's span); every op inside an entry span lies
inside a stage span; tracing changes no output bit; the fill counters
agree with a recount from the grid; the repair counter counts the rows
the grid leaves uncertified.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.neighbors import knn_cloud_grid
from pct_tpu_torch.neighbors.cellknn import (
    library_capacity_cap,
    probe_grid_buckets,
)
from pct_tpu_torch.neighbors.grid import (
    MAXDIM,
    PAD_ID,
    build_grid,
    estimate_cell_size,
)
from pct_tpu_torch.pipeline import curvature_pipeline, fast_curvature
from pct_tpu_torch.pipeline.fused import SPLIT_TO, plan_engine
from pct_tpu_torch.shapes import generate_shape
from pct_tpu_torch.utils import trace

N = 1500
STAGES = ("load", "grid", "probe", "cells", "run_table", "candidates",
          "kernel", "fit", "scatter")
# route: (entry point, k, the stages it runs)
ROUTES = {
    "fused-k20": (fast_curvature, 20, STAGES),
    "fused-k100": (fast_curvature, 100, STAGES),
    "staged-k20": (curvature_pipeline, 20, STAGES + ("repair",)),
}


@pytest.fixture(scope="module")
def torus():
    return generate_shape("torus", N, perturbation_strength=1e-3, seed=1)[1]


@pytest.fixture(scope="module")
def traced(torus):
    """traced(route): (outputs untraced, outputs traced, the profiler's
    events, the counters of the traced call), each route run once; the
    traced call starts at the host array, as a caller's does."""
    done = {}

    def get(route):
        if route not in done:
            fn, k, _ = ROUTES[route]
            plain = fn(from_numpy(torus, device="cpu"), k, device="cpu")
            trace.reset()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                out = fn(from_numpy(torus, device="cpu"), k, device="cpu")
            done[route] = (plain, out, list(prof.events()), trace.counters())
        return done[route]

    return get


def _entry(route):
    return trace.PREFIX + ROUTES[route][0].__name__


def _spans(events):
    return [e for e in events if e.name.startswith(trace.PREFIX)]


def _innermost_span(e):
    """The innermost port span around event ``e``, or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith(trace.PREFIX):
        p = p.cpu_parent
    return p


def test_span_without_profiler_is_the_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = trace.span("grid"), trace.span("kernel")
    assert a is b
    with a as x:
        assert x is None


def test_span_under_a_profiler_records_the_stage():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("grid"):
            torch.ones(3).sum()
    names = [e.name for e in prof.events()]
    assert "pct.grid" in names
    (s,) = [e for e in prof.events() if e.name == "pct.grid"]
    assert [c.name for c in s.cpu_children] == ["aten::ones", "aten::sum"]


def test_counters_copy_and_reset():
    trace.reset()
    trace.count("x", 2)
    trace.count("x", np.int64(3))
    got = trace.counters()
    assert got == {"x": 5} and type(got["x"]) is int
    got["x"] = 0
    assert trace.counters() == {"x": 5}
    trace.reset()
    assert trace.counters() == {}


@pytest.mark.parametrize("route", ROUTES)
def test_every_stage_span_appears_nested(traced, route):
    _, _, events, _ = traced(route)
    entry = _entry(route)
    spans = _spans(events)
    want = {entry} | {trace.PREFIX + s for s in ROUTES[route][2]}
    assert {s.name for s in spans} == want
    (top,) = [s for s in spans if s.name == entry]
    assert _innermost_span(top) is None
    parents = {}
    for s in spans:
        if s is top:
            continue
        p = _innermost_span(s)
        parents.setdefault(s.name, set()).add(None if p is None else p.name)
    # the cloud's load runs before the entry point, the rest inside it
    assert parents.pop("pct.load") == {None, entry}
    assert parents.pop("pct.run_table") == {"pct.probe", "pct.cells"}
    for name, outer in parents.items():
        # a stage may open its own span again inside itself
        assert outer <= {entry, name} and entry in outer, (name, outer)


@pytest.mark.parametrize("route", ROUTES)
def test_every_op_in_an_entry_span_lies_in_a_stage(traced, route):
    _, _, events, _ = traced(route)
    entry = _entry(route)
    ops = 0
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        p = _innermost_span(e)
        while p is not None and p.name != entry:
            p = _innermost_span(p)
        if p is None:
            continue                  # outside the entry point's span
        ops += 1
        assert _innermost_span(e).name != entry, e.name
    assert ops > 100


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().contiguous()
    if a.is_floating_point():
        a = a.view(torch.int32 if a.element_size() == 4 else torch.int64)
    return a.numpy()


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out for t in _tensors(x)]


@pytest.mark.parametrize("route", ROUTES)
def test_outputs_bit_identical_with_the_profiler(traced, route):
    plain, out, _, _ = traced(route)
    a, b = _tensors(plain), _tensors(out)
    assert len(a) == len(b) >= 6
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


def _recount(torus, k: int, split_to):
    """(real queries, real candidates, grid) of the route's probe,
    recounted from the route's grid: each occupied cell's points, and the
    points of its 3×3×3 window once for each row the cell splits into."""
    pts = from_numpy(torus, device="cpu").points
    grid = build_grid(pts, N, estimate_cell_size(pts, N, k))
    ids = grid.sorted_ids.numpy()
    cells, counts = np.unique(ids[ids != PAD_ID], return_counts=True)
    occupied = dict(zip(cells.tolist(), counts.tolist()))
    cand = 0
    for c, cnt in occupied.items():
        x, y, z = c % MAXDIM, (c // MAXDIM) % MAXDIM, c // MAXDIM ** 2
        window = sum(occupied.get((x + i) + MAXDIM * (y + j)
                                  + MAXDIM ** 2 * (z + m), 0)
                     for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for m in (-1, 0, 1)
                     if 0 <= min(x + i, y + j, z + m)
                     and max(x + i, y + j, z + m) < MAXDIM)
        rows = 1 if split_to is None else -(-cnt // split_to)
        cand += window * rows
    return int(counts.sum()), cand, grid


@pytest.mark.parametrize("route", ROUTES)
def test_fill_counters_match_the_probe(traced, torus, route):
    _, k, _ = ROUTES[route]
    got = traced(route)[3]
    fused = route.startswith("fused")
    split_to = SPLIT_TO if fused and k >= 64 else None
    queries, cand, grid = _recount(torus, k, split_to)
    if fused:
        _, spec, _, _ = plan_engine(grid, k)
    else:
        spec, _ = probe_grid_buckets(grid, library_capacity_cap(k))
    assert got["real_queries"] == queries == N
    assert got["real_candidates"] == cand
    assert got["query_slots"] == sum(s.max_cells * s.capacity for s in spec)
    assert got["candidate_slots"] == sum(s.max_cells * s.cand_cap
                                         for s in spec)
    slot_fill = got["real_queries"] / got["query_slots"]
    cand_fill = got["real_candidates"] / got["candidate_slots"]
    assert 0 < slot_fill < 1 and 0 < cand_fill < 1


def test_no_repair_counted_on_the_fused_routes(traced):
    for route in ("fused-k20", "fused-k100"):
        assert not {"rows", "repair_rows", "repair_whole"} & set(
            traced(route)[3])
    got = traced("staged-k20")[3]
    assert got["rows"] == N and "repair_whole" not in got


@pytest.mark.parametrize("capacity", [4, 8])
def test_repair_rows_count_the_uncertified_rows(torus, capacity):
    """A one-bucket capacity under the fullest cell leaves rows
    uncertified: 4 query slots a cell more than half of them (the whole
    cloud goes to brute force), 8 fewer."""
    cloud = from_numpy(torus, device="cpu")
    res, _ = knn_cloud_grid(cloud, 20, capacity=capacity,
                            exact_fallback=False, device="cpu")
    want = int((~res.exact[:N]).sum())
    assert 0 < want and (want > N // 2) == (capacity == 4)
    trace.reset()
    res, _ = knn_cloud_grid(cloud, 20, capacity=capacity, device="cpu")
    got = trace.counters()
    assert bool(res.exact[:N].all())
    assert got["rows"] == N and got["repair_rows"] == want
    assert got.get("repair_whole", 0) == int(want > N // 2)
