"""Mean host ms of the `plan.sparse` telemetry span (`core/service.py` ->
`BM25Index.topk_batch_dev`) per execute, outside the traced slice."""
from h100bench.harness.readers import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "plan.sparse")
