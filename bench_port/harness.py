"""The closed loop of one cell: warm-up, the measured window, the sample
of outputs kept for the check, and the reference at the sampled rows.

One caller runs calls back to back. A call starts at the host array
handed to ``from_numpy(pad_multiple=...)`` and ends when the entry
point's outputs are complete on the device (``torch.cuda.synchronize``);
call i takes cloud i mod pool. The window starts calls until
``seconds`` have passed and closes when the last one ends.
"""

from __future__ import annotations

import importlib
import importlib.util
import math
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from bench_port import reference as ref_mod
from bench_port.traffic import seed_words

TABLE_CALLS = 1024     # sampled-row table: call i reads row i mod this


def resolve(path: str):
    """The function named by a dotted path."""
    mod, _, name = path.rpartition(".")
    return getattr(importlib.import_module(mod), name)


class Sampler:
    """Keeps the outputs of ``rows`` seeded rows of every call: gathered
    on the device after the call's end and copied to the host at once,
    so nothing the harness keeps stays on the device to raise the
    window's peak. With ``rows >= points`` every row is kept."""

    def __init__(self, points: int, rows: int, seed: int, device):
        if rows >= points:
            table = np.broadcast_to(np.arange(points), (TABLE_CALLS, points))
        else:
            rng = np.random.default_rng(seed_words(seed, 1 << 16))
            table = rng.integers(0, points, size=(TABLE_CALLS, rows))
        self.table = np.ascontiguousarray(table, dtype=np.int64)
        self.table_dev = torch.from_numpy(self.table).to(device)
        self.parts = []

    def take(self, i: int, cloud: int, out):
        idx = self.table_dev[i % TABLE_CALLS]
        curv, nrm = out.curv, out.normals
        kth = (out.kth_dist if hasattr(out, "kth_dist")
               else out.neighbor_dists[:, -1])
        cols = (curv.K, curv.H, curv.k1, curv.k2,
                nrm[:, 0], nrm[:, 1], nrm[:, 2], kth)
        part = {"call": i, "cloud": cloud,
                "vals": torch.stack([c[idx].float() for c in cols]).cpu()}
        if hasattr(out, "exact"):
            part["exact"] = out.exact[idx].cpu()
        if hasattr(out, "neighbor_indices"):
            part["ids"] = out.neighbor_indices[idx].cpu()
            part["dists"] = out.neighbor_dists[idx].cpu()
        self.parts.append(part)

    def collect(self) -> dict:
        """The kept outputs as host arrays, one entry a sampled row."""
        p0 = self.parts
        rows = np.concatenate([self.table[p["call"] % TABLE_CALLS] for p in p0])
        vals = torch.cat([p["vals"] for p in p0], 1).numpy()
        out = {
            "call": np.concatenate([np.full(self.table.shape[1], p["call"])
                                    for p in p0]),
            "cloud": np.concatenate([np.full(self.table.shape[1], p["cloud"])
                                     for p in p0]),
            "row": rows,
            "K": vals[0], "H": vals[1], "k1": vals[2], "k2": vals[3],
            "normals": vals[4:7].T.copy(), "kth": vals[7],
        }
        for key in ("exact", "ids", "dists"):
            if key in p0[0]:
                out[key] = torch.cat([p[key] for p in p0]).numpy()
        return out


@dataclass
class Window:
    times: list = field(default_factory=list)   # seconds a call (inf: failed)
    failed: int = 0
    seconds: float = 0.0
    start: float = 0.0                          # perf_counter at the start
    peak_bytes: int = 0


class Runner:
    """The configuration's entry point on one device."""

    def __init__(self, config: dict, traffic: dict, device: str = "cuda",
                 wrap=None):
        self.device = torch.device(device)
        self.entry = resolve(config["entry"])
        self.from_numpy = resolve("pct_tpu_torch.core.cloud.from_numpy")
        self.k = int(config["k"])
        self.kwargs = dict(method=config["method"], **config.get("kwargs", {}))
        self.pad = int(traffic["pad_multiple"])
        self.wrap = wrap

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, pts: np.ndarray):
        cloud = self.from_numpy(pts, pad_multiple=self.pad, device=self.device)
        out = self.entry(cloud, k=self.k, device=self.device, **self.kwargs)
        if self.wrap is not None:
            out = self.wrap(out)
        self.sync()
        return out

    def warm(self, pool, passes: int) -> int:
        """Every cloud of the pool ``passes`` times; returns the calls."""
        for _ in range(passes):
            for pts in pool:
                self.call(pts)
        self.sync()
        return passes * len(pool)

    def window(self, pool, seconds: float, sampler: Sampler, tracer,
               log=print) -> Window:
        cuda = self.device.type == "cuda"
        self.sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        w = Window(start=time.perf_counter())
        i, last = 0, w.start
        while i == 0 or last - w.start < seconds or not tracer.done:
            c0 = time.perf_counter()
            try:
                with tracer.span(i):
                    out = self.call(pool[i % len(pool)])
            except (RuntimeError, ValueError) as exc:
                out = None
                w.failed += 1
                log(f"call {i} failed: {type(exc).__name__}: {exc}")
            last = time.perf_counter()
            tracer.after(i)
            if out is None:
                w.times.append(math.inf)
            else:
                w.times.append(last - c0)
                sampler.take(i, i % len(pool), out)
            del out
            i += 1
        self.sync()
        w.seconds = last - w.start
        if cuda:
            w.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))
        return w


def reference_rows(sample: dict, pool, k: int, device, dtype=torch.float64,
                   tf32: bool = False, ids: bool = False) -> dict:
    """The reference at every sampled row, in the sample's order (each
    distinct row of a cloud computed once); with ``ids`` its neighbours
    too."""
    n = sample["row"].shape[0]
    out = {"d2": np.empty((n, k)), "d2_next": np.empty(n),
           "normals": np.empty((n, 3)),
           "K": np.empty(n), "H": np.empty(n), "k1": np.empty(n),
           "k2": np.empty(n)}
    if ids:
        out["ids"] = np.empty((n, k), dtype=np.int64)
    for j in np.unique(sample["cloud"]):
        m = np.nonzero(sample["cloud"] == j)[0]
        rows, inv = np.unique(sample["row"][m], return_inverse=True)
        r = ref_mod.reference(pool[int(j)], rows, k, device, dtype, tf32)
        out["d2"][m] = r.d2.double().numpy()[inv]
        out["d2_next"][m] = r.d2_next.double().numpy()[inv]
        out["normals"][m] = r.normals.double().numpy()[inv]
        if ids:
            out["ids"][m] = r.ids.numpy()[inv]
        for key in ("K", "H", "k1", "k2"):
            out[key][m] = getattr(r, key).double().numpy()[inv]
    return out


def p95(times) -> float:
    """95th percentile of every call's seconds (numpy's linear rule)."""
    return float(np.percentile(np.asarray(times, dtype=np.float64), 95))


def build_dir() -> Path:
    spec = importlib.util.find_spec("pct_tpu_torch")
    return Path(spec.submodule_search_locations[0]) / "_build"


def build_logs() -> dict:
    """{log path: mtime} of the port's nvcc logs."""
    d = build_dir()
    return {p: p.stat().st_mtime for p in d.glob("*.log")} if d.exists() else {}


def nvcc_seconds(before: dict) -> dict:
    """{source: nvcc seconds} of the libraries built since ``before``."""
    built = {}
    for p, mtime in build_logs().items():
        if before.get(p) == mtime:
            continue
        for m in re.finditer(r"^nvcc (\S+): ([\d.]+) s$", p.read_text(), re.M):
            built[m.group(1)] = float(m.group(2))
    return built


def forbidden_modules(names=("jax", "jaxlib", "flax", "pct_tpu")) -> list:
    """Loaded modules whose top-level name is one of ``names``."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in names)
