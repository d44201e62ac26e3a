"""The port's list route against the benchmark's plain reference, on the
CPU: ``fast_curvature(k=20)`` on a 20,000-point cloud of the ``torus-1M``
traffic takes the list engine (the coords select's plain version, then
the eager neighbourhood chain) and passes the ``fused-k20.torus-1M``
cell's check (``bench_port.check``) against ``bench_port.reference``;
the reference in TF32, put in the program's place, fails it. The select
takes at most ``cellknn._SELECT_CANDIDATES`` candidate slots at a time,
so the route's working memory is bounded whatever a bucket's size, with
the outputs of one select over each whole bucket; at a budget that cuts
every bucket into several selects, the route holds to the JAX package's
``fast_curvature`` on the same cloud. The cell's kernel pattern
(``metrics/kernel_ms.coords.json``) picks the coords select's kernel in
both of its classes and no other select, moments or epilogue kernel.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import check, harness
from bench_port.calibrate import control_sample
from bench_port.traffic import make_pool
from pct_tpu.core import from_numpy as jax_from_numpy
from pct_tpu.pipeline.fused import fast_curvature as jax_fast_curvature
from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.neighbors import cellknn
from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
from pct_tpu_torch.pipeline import fast_curvature
from pct_tpu_torch.pipeline.fused import plan_engine

BENCH = Path(__file__).resolve().parents[1] / "bench_port"
CELL = "fused-k20.torus-1M"
K = 20
N = 20_000
SEED = 2 ** 31 + 2023
CPU = torch.device("cpu")

# Demangled names as the card's profiler gives them: the coords select in
# the warp class (k <= 1024) and the block class, and the kernels the
# pattern must leave to other metrics.
NAMES = {
    "coords warp": "void knn_warp::select_kernel<(anonymous namespace)::"
    "CoordsOut, true, 1024>(float const*, float const*, int const*, "
    "int const*, int const*, (anonymous namespace)::CoordsOut, int, int, int)",
    "coords block": "void knn_warp::select_block_kernel<(anonymous "
    "namespace)::CoordsOut, true, true>(float const*, float const*, int "
    "const*, int const*, int const*, (anonymous namespace)::CoordsOut, "
    "unsigned long long*, unsigned long, int, int, int)",
    "rows warp": "void knn_warp::select_kernel<(anonymous namespace)::"
    "IdsOut<true>, true, 1024>(float const*, float const*, int const*, "
    "int const*, int const*, (anonymous namespace)::IdsOut<true>, int, int, "
    "int)",
    "rows block": "void knn_warp::select_block_kernel<(anonymous "
    "namespace)::IdsOut<true>, true, true>(float const*, float const*, int "
    "const*, int const*, int const*, (anonymous namespace)::IdsOut<true>, "
    "unsigned long long*, unsigned long, int, int, int)",
    "positions warp": "void knn_warp::select_kernel<(anonymous namespace)::"
    "IdsOut<false>, true, 1024>(float const*, float const*, int const*, "
    "int const*, int const*, (anonymous namespace)::IdsOut<false>, int, int, "
    "int)",
    "positions block": "void knn_warp::select_block_kernel<(anonymous "
    "namespace)::IdsOut<false>, true, true>(float const*, float const*, int "
    "const*, int const*, int const*, (anonymous namespace)::IdsOut<false>, "
    "unsigned long long*, unsigned long, int, int, int)",
    "moments": "void (anonymous namespace)::moments_kernel<true>(float "
    "const*, float const*, int const*, int const*, int const*, float*, int, "
    "int, int)",
    "epilogue": "(anonymous namespace)::epilogue_kernel(float const*, "
    "float*, int)",
}
# the metric whose pattern each sample name belongs to, where one has
OWN_METRIC = {"coords warp": "kernel_ms.coords",
              "coords block": "kernel_ms.coords",
              "rows warp": "kernel_ms.rows", "rows block": "kernel_ms.rows",
              "moments": "kernel_ms.moments", "epilogue": "kernel_ms.epilogue"}


def _pattern(metric: str) -> str:
    return json.loads((BENCH / "metrics" / f"{metric}.json").read_text())[
        "kernel"]


def _limits() -> dict:
    return json.loads((BENCH / "checks" / f"{CELL}.json").read_text())[
        "limits"]


@pytest.fixture(scope="module")
def pool():
    traffic = json.loads((BENCH / "traffic" / "torus-1M.json").read_text())
    traffic.update(points=N, pool=1)
    return make_pool(traffic, SEED)


def test_the_list_engine_is_planned(pool):
    cloud = from_numpy(pool[0], pad_multiple=1024, device=CPU)
    cell = estimate_cell_size(cloud.points, cloud.num_points, K)
    grid = build_grid(cloud.points, cloud.num_points, cell)
    engine, spec, _, factor = plan_engine(grid, K)
    assert engine == "list" and factor == 1
    assert spec and all(sp.capacity <= 256 for sp in spec)


def test_list_route_passes_the_cells_check(pool):
    cloud = from_numpy(pool[0], pad_multiple=1024, device=CPU)
    out = fast_curvature(cloud, K, device=CPU)
    rows = np.arange(N)
    sample = {"call": np.zeros(N, np.int64), "cloud": np.zeros(N, np.int64),
              "row": rows, "exact": out.exact[:N].numpy(),
              "kth": out.kth_dist[:N].numpy(),
              "normals": out.normals[:N].numpy()}
    for key in ("K", "H", "k1", "k2"):
        sample[key] = getattr(out.curv, key)[:N].numpy()
    ref = harness.reference_rows(sample, pool, K, CPU)
    nums = check.numbers(sample, ref, lambda j: pool[j])
    ok, checks = check.judge(nums, _limits())
    assert ok, checks
    assert sample["exact"].all()


def _outputs(res):
    return (*res.curv, res.normals, res.exact, res.kth_dist)


def test_the_select_runs_chunk_by_chunk(pool, monkeypatch):
    cloud = from_numpy(pool[0], pad_multiple=1024, device=CPU)
    grid = build_grid(cloud.points, cloud.num_points,
                      estimate_cell_size(cloud.points, cloud.num_points, K))
    spec = plan_engine(grid, K)[1]
    monkeypatch.setattr(cellknn, "_SELECT_CANDIDATES", 1 << 40)
    whole = fast_curvature(cloud, K, device=CPU)

    # small enough that every bucket's real cells span several selects
    # (a larger budget leaves a 20k cloud's later selects padding alone)
    budget = 1 << 16
    seen = []
    select = cellknn._SELECTS["coords"]

    def spy(qpts, cpts, *rest):
        seen.append(cpts.shape[0] * cpts.shape[1])
        return select(qpts, cpts, *rest)

    monkeypatch.setattr(cellknn, "_SELECT_CANDIDATES", budget)
    monkeypatch.setattr(cellknn, "_FIT_QUERIES", 256)
    monkeypatch.setitem(cellknn._SELECTS, "coords", spy)
    chunked = fast_curvature(cloud, K, device=CPU)
    assert len(seen) == cellknn.list_select_launches(spec) > len(spec)
    assert max(seen) <= budget
    for a, b in zip(_outputs(chunked), _outputs(whole)):
        assert torch.equal(a, b)

    # the chunked route against the JAX package's own (tiled) list route,
    # at test_torch_fused's public-path tolerances
    rj = jax_fast_curvature(jax_from_numpy(pool[0]), k=K)
    e_j = np.asarray(rj.exact)[:N]
    e_t = chunked.exact[:N].numpy()
    assert (e_j == e_t).mean() >= 0.999
    both = e_j & e_t
    K_j = np.asarray(rj.curv.K)[:N]
    K_t = chunked.curv.K[:N].numpy()
    np.testing.assert_allclose(K_t[both], K_j[both], rtol=0,
                               atol=1e-4 * np.abs(K_j[both]).max())


def test_control_fails_the_cells_check(pool):
    rows = np.random.default_rng(0).choice(N, 1000, replace=False)
    sample = {"call": np.zeros_like(rows), "cloud": np.zeros_like(rows),
              "row": rows}
    ref = harness.reference_rows(sample, pool, K, CPU)
    ctrl = harness.reference_rows(sample, pool, K, CPU, torch.float32,
                                  tf32=True, ids=True)
    nums = check.numbers(control_sample(sample, ctrl, False), ref,
                         lambda j: pool[j])
    ok, checks = check.judge(nums, _limits())
    assert not ok, checks


@pytest.mark.parametrize("which", list(NAMES))
def test_the_coords_pattern_picks_the_coords_kernel(which):
    name = NAMES[which]
    coords = re.search(_pattern("kernel_ms.coords"), name) is not None
    assert coords == which.startswith("coords")
    roofline = json.loads((BENCH / "metrics" / "coords_roofline.json")
                          .read_text())["kernel"]
    assert roofline == _pattern("kernel_ms.coords")
    if which in OWN_METRIC:
        assert re.search(_pattern(OWN_METRIC[which]), name)
