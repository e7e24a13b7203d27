"""Mean host ms of the summed `budget.select` span (each request's triple
lookups and `TokenBudgeter.select`) per execute, outside the traced
slice."""
from h100bench.harness.program import mean_part_ms


def read(run):
    return mean_part_ms(run, "plan.budget", "budget.select")
