"""Benchmark of pct_tpu_torch on one NVIDIA card.

``run.py`` runs one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) as a closed loop of calls for a fixed number of seconds,
checks a seeded sample of the outputs against the plain reference in
``reference.py`` and prints one JSON result line. Everything a cell
needs is data found by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``checks/<cell>.json`` and, for each
per-layer metric, ``metrics/<metric>.json``.

Nothing here imports JAX or the JAX package ``pct_tpu``.
"""
