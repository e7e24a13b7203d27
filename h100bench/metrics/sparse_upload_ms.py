"""Mean host ms of the `sparse.upload` span (the selection masks' copy
from the host to the device) per execute, outside the traced slice."""
from h100bench.harness.program import mean_part_ms


def read(run):
    return mean_part_ms(run, "plan.sparse", "sparse.upload")
