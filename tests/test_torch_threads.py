"""Torch's CPU threads in the port's tests under pytest-xdist.

Each xdist worker's torch starts as many intra-op threads as the machine
has cores, so ``-n W`` workers run W times that many threads on the same
cores, and the plain versions' thousands of small ops then wait on
threads that are not scheduled. ``cap_threads`` caps a worker's threads
at max(1, cores // W) (xdist sets ``PYTEST_XDIST_WORKER_COUNT`` in its
workers); outside xdist torch keeps its default. This module calls it
when it is imported, and an xdist worker collects every file of the run
before it runs a test, so one call caps every worker of a run that
collects this file: ``tests/`` as a whole, or a list of files that names
it. The port itself (``pct_tpu_torch``) sets no threads.
"""

import os

import torch


def worker_threads() -> int | None:
    """The intra-op threads an xdist worker gets, or None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


def cap_threads() -> None:
    """Lower torch's intra-op threads to ``worker_threads()`` under xdist."""
    n = worker_threads()
    if n is not None and torch.get_num_threads() > n:
        torch.set_num_threads(n)


cap_threads()


def test_worker_threads_rule(monkeypatch):
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    assert worker_threads() is None
    cores = os.cpu_count() or 1
    for workers, want in ((1, cores), (cores, 1), (4 * cores, 1),
                          (2, max(1, cores // 2))):
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(workers))
        assert worker_threads() == want


def test_threads_capped_in_this_process():
    n = worker_threads()
    if n is not None:
        assert torch.get_num_threads() <= n
    else:
        assert torch.get_num_threads() >= 1
