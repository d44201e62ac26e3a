"""% of the query slots that the cell loop's buckets launch that hold a
real query, over every call of the run: the port's counters
``real_queries`` / ``query_slots``, taken where the bucket probe cuts
the layout (``stages.fill``)."""

from bench_port.stages import counter_metric


def read(ctx):
    return counter_metric(ctx, "slot_fill")
