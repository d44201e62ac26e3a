"""Whole runs of the harness at a tiny size on the CPU (the port's plain
versions): the sound program comes out correct, the result line has the
contract's keys, a broken timed path and the lower-precision control
come out not correct, and nothing loads JAX or the JAX package."""

import ast
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY_POINTS

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
FORBIDDEN = ("jax", "jaxlib", "flax", "pct_tpu")
# The cyclide's pinch leaves the fused route's uncertified rows with thin
# neighbourhoods on a sparse cloud: at 3,000 points their K reads 4% off
# at the 99th percentile (``K_p99_all``), at 20,000 1%, at the cell's 1M
# 0.2%; 20,000 is the least size at which the cell's limits hold.
POINTS = {"fused-k100.cyclide-1M": 20_000}


def run(cell, trace=False, wrap=None, seconds=0.3):
    from bench_port.run import run_cell

    n = int(cell.traffic["points"])
    return run_cell(cell, 2 ** 31 + 77, seconds, trace, "cpu",
                    time.perf_counter(), wrap=wrap, warmup_passes=1,
                    rows_per_call=n)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    cell = tiny_cell(name, POINTS.get(name, TINY_POINTS))
    res = run(cell)
    assert res["correct"], res["checks"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == set(cell.checks["limits"])


def test_traced_line(tiny_cell):
    res = run(tiny_cell("staged-k100.torus-1M"), trace=True)
    assert res["correct"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert res["attempted"] >= 10          # the traced calls run whole
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no device event is traced, so no device metric reads
    assert res["metrics"] == {}


def _map(out, fn):
    if isinstance(out, torch.Tensor):
        return fn(out)
    return type(out)(*(_map(x, fn) for x in out))


class Stale:
    """A call that hands back the previous call's outputs."""

    def __init__(self):
        self.prev = None

    def __call__(self, out):
        prev, self.prev = self.prev, out
        return out if prev is None else prev


def half(out):
    """Half of the rows left out: zero from the middle of the capacity."""
    def cut(t):
        t = t.clone()
        t[t.shape[0] // 2:] = 0
        return t
    return _map(out, cut)


def altered(out):
    """One answer altered where it is produced: row 0's K."""
    K = out.curv.K.clone()
    K[0] += 0.5
    return out._replace(curv=out.curv._replace(K=K))


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", ["fused-k100.torus-1M",
                                  "staged-k100.torus-1M",
                                  "fused-k100.cyclide-1M"])
def test_broken_timed_path_is_not_correct(tiny_cell, name, fault):
    wrap = {"stale": Stale(), "half": half, "altered": altered}[fault]
    res = run(tiny_cell(name, POINTS.get(name, TINY_POINTS)), wrap=wrap)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["fused-k100.torus-1M",
                                  "staged-k100.torus-1M"])
def test_control_is_not_correct(tiny_cell, name):
    """The reference in TF32 put in the program's place fails the
    check, at a size where its brute force reaches far enough."""
    from bench_port import check, harness
    from bench_port.calibrate import control_sample
    from bench_port.traffic import make_pool

    cell = tiny_cell(name, points=20_000)
    cell.traffic["pool"] = 1
    pool = make_pool(cell.traffic, 5)
    k = int(cell.config["k"])
    rows = np.random.default_rng(0).choice(20_000, 1000, replace=False)
    sample = {"call": np.zeros_like(rows), "cloud": np.zeros_like(rows),
              "row": rows}
    cpu = torch.device("cpu")
    ref = harness.reference_rows(sample, pool, k, cpu)
    ctrl = harness.reference_rows(sample, pool, k, cpu, torch.float32,
                                  tf32=True, ids=True)
    nums = check.numbers(control_sample(sample, ctrl, name.startswith("staged")),
                         ref, lambda j: pool[j])
    ok, checks = check.judge(nums, cell.checks["limits"])
    assert not ok, checks


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_in_the_harness_sources():
    for path in (ROOT / "bench_port").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_no_jax_loaded_by_a_run():
    """A whole run in a fresh interpreter loads no module whose
    top-level name is jax, jaxlib, flax or pct_tpu (pct_tpu_torch is
    another name)."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from bench_port.spec import load_cell\n"
        "from bench_port.run import run_cell\n"
        "from bench_port.harness import forbidden_modules\n"
        "c = load_cell('fused-k100.torus-1M')\n"
        "c.traffic.update(points=1500, pool=1, pad_multiple=1024)\n"
        "r = run_cell(c, 1, 0.1, False, 'cpu', time.perf_counter(),"
        " warmup_passes=1)\n"
        "assert 'pct_tpu_torch' in sys.modules\n"
        "print(forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints nothing on
    standard output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "fused-k100.torus-1M", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    """A short run of each cell at its own size on the card."""
    from bench_port.run import run_cell
    from bench_port.spec import load_cell

    res = run_cell(load_cell(name), 7, 2.0, False, "cuda",
                   time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["attempted"] >= 10
