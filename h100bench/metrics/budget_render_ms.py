"""Mean host ms of the summed `budget.render` span (each request's `render`
and the final `tokenizer.count`) per execute, outside the traced slice."""
from h100bench.harness.program import mean_part_ms


def read(run):
    return mean_part_ms(run, "plan.budget", "budget.render")
