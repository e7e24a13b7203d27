"""Mean host ms of the `plan.embed` telemetry span (the host embedder of
the batch's queries and their upload) per execute, outside the traced
slice."""
from h100bench.harness.readers import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "plan.embed")
