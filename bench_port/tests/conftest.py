"""Fixtures of the benchmark's own tests: the cells at a tiny size on
the CPU (the port's plain versions), and the card for the ``cuda`` ones."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_POINTS = 3000


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name)``: the cell ``name`` of BENCHMARK.json with its
    traffic cut to TINY_POINTS points, a pool of 2, padded to 1024."""
    from bench_port.spec import load_cell

    def make(name, points=TINY_POINTS):
        cell = load_cell(name)
        cell.traffic.update(points=points, pool=2, pad_multiple=1024)
        return cell

    return make


@pytest.fixture
def card():
    """Skips unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
