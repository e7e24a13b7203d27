"""Mean MiB the program copies from the host to the device an execute: the
`h2d_bytes` counts of every span of the execute (`common/utils.py`
`upload`), outside the traced slice."""
from h100bench.harness.program import mean_count


def read(run):
    n = mean_count(run, "h2d_bytes")
    return None if n is None else n / 2**20
