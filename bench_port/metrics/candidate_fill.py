"""% of the candidate slots that the cell loop's buckets launch that
hold a real candidate, over every call of the run: the port's counters
``real_candidates`` / ``candidate_slots``, taken where the bucket probe
cuts the layout (``stages.fill``)."""

from bench_port.stages import counter_metric


def read(ctx):
    return counter_metric(ctx, "candidate_fill")
