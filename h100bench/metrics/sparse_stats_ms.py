"""Mean host ms of the `sparse.stats` span (`BM25Index._term_stats`: tf over
the doc block, the per-query df read to the host, which waits for the
device, avg_len and idf) per execute, outside the traced slice."""
from h100bench.harness.program import mean_part_ms


def read(run):
    return mean_part_ms(run, "plan.sparse", "sparse.stats")
