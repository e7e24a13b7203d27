"""Mean host ms of the `plan.budget` telemetry span (`TokenBudgeter.select`
and `render` for every request of the batch) per execute, outside the
traced slice."""
from h100bench.harness.readers import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "plan.budget")
