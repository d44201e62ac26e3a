"""Finds a cell's files by name: ``BENCHMARK.json`` at the root of the
checkout names the cells, configurations and metrics; everything else
is a data file under ``bench_port/``."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    checks: dict        # checks/<cell>.json
    end_to_end: list    # BENCHMARK.json entries the cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (default: ``root``/BENCHMARK.json)."""
    if bench is None:
        bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        checks=load_json(HERE / "checks" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )


def load_reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<metric>.py``'s
    ``read(ctx)``, or ``metrics/<metric>.json`` naming a reader of
    ``readers.py`` and its parameters."""
    py = HERE / "metrics" / f"{metric}.py"
    if py.exists():
        spec = importlib.util.spec_from_file_location(
            "bench_port_metric_" + metric.replace(".", "_").replace("-", "_"),
            py)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
    from bench_port import readers

    params = load_json(HERE / "metrics" / f"{metric}.json")
    fn = getattr(readers, params.pop("reader"))
    return lambda ctx: fn(ctx, **params)
