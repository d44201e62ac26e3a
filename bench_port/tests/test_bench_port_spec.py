"""BENCHMARK.json and the data files it names: every cell finds its
configuration, traffic, check and metric readers by name."""

import json
import re

import numpy as np
import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for group, keys in ENTRY_KEYS.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == keys, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    from bench_port.spec import HERE, load_cell

    cell = load_cell(name)
    assert cell.chips == 1
    assert cell.traffic["name"] == name.split(".", 1)[1]
    assert cell.config["name"] == name.split(".", 1)[0]
    assert {"entry", "k", "method", "source", "assumed"} <= set(cell.config)
    assert cell.checks["rows_per_call"] >= 1 and cell.checks["limits"]
    assert len(cell.end_to_end) == len(BENCH["end_to_end"])
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert ((HERE / "metrics" / f"{m['name']}.json").exists()
                or (HERE / "metrics" / f"{m['name']}.py").exists()), m["name"]


@pytest.mark.parametrize("config", [c["file"] for c in BENCH["configs"]])
def test_roofline_bytes_agree(config):
    """A configuration's recorded bytes a point are what its kernel's
    roofline reader counts."""
    cfg = json.loads((ROOT / config).read_text())
    spec = json.loads((ROOT / "bench_port" / "metrics"
                       / f"{cfg['roofline_kernel']}_roofline.json").read_text())
    from bench_port.readers import COORD_BYTES

    assert cfg["roofline_bytes_per_point"] == (
        COORD_BYTES + spec.get("out_bytes_per_query", 0)
        + cfg["k"] * spec.get("out_bytes_per_neighbour", 0))


@pytest.mark.parametrize("traffic", ["torus-1M", "cyclide-1M"])
def test_the_seed_draws_the_pool(traffic):
    """The same seed gives the same clouds; another seed, other clouds
    of the same shape and size."""
    from bench_port.traffic import make_pool

    spec = json.loads((ROOT / "bench_port" / "traffic" / f"{traffic}.json")
                      .read_text())
    spec.update(points=4096)
    big = 2 ** 31 + 12345
    base = make_pool(spec, big)
    key = lambda pool: [p.tobytes() for p in pool]
    assert key(make_pool(spec, big)) == key(base)
    others = [key(make_pool(spec, big + i)) for i in range(1, 4)]
    assert all(not set(o) & set(key(base)) for o in others)
    assert len(set(key(base))) == len(base) == spec["pool"]
    assert base[0].dtype == np.float32 and base[0].shape == (4096, 3)


def test_torus_noise_is_the_sweeps():
    """At 1000² points the torus is the whole grid and the noise's
    amplitude is 0.001·√area / (1 + |H|): 0.0013–0.0021."""
    from bench_port.traffic import make_cloud, torus

    spec = {"shape": "torus", "points": 1_000_000, "perturbation": 0.001}
    pts = make_cloud(spec, np.random.default_rng(3))
    grid = torus(1_000_000, np.random.default_rng(0))
    amp = np.abs(pts - grid).max(1)
    assert 0.0005 < np.median(amp) < 0.004
    sig = np.std(pts - grid, axis=0)
    assert np.all((sig > 0.0013) & (sig < 0.0021))
