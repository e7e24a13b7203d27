"""`budget_ms` in the cells where it moves `retrieve_p95_ms` (the
dense-only plan): mean host ms of the `plan.budget` telemetry span per
execute, outside the traced slice."""
from h100bench.harness.readers import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "plan.budget")
