"""Mean host ms of the `sparse.select` span (`core/bm25.py`
`BM25Index.topk_batch_dev`: each query's selection mask over the store,
stacked and padded to the capacity) per execute, outside the traced
slice."""
from h100bench.harness.program import mean_part_ms


def read(run):
    return mean_part_ms(run, "plan.sparse", "sparse.select")
