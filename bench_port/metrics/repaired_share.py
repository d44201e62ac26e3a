"""% of the rows that ``knn_cloud_grid`` re-resolves by brute force
because the grid could not certify them, over every call of the run:
the port's counters ``repair_rows`` / ``rows`` (``stages.fill``)."""

from bench_port.stages import counter_metric


def read(ctx):
    return counter_metric(ctx, "repaired_share")
