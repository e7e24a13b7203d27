"""Mean host ms of the summed `sparse.score` span (the per-term sum and
mask, then the top-k and its padding; mostly enqueue) per execute,
outside the traced slice."""
from h100bench.harness.program import mean_part_ms


def read(run):
    return mean_part_ms(run, "plan.sparse", "sparse.score")
