"""`idle_share.mem` in the cells where it moves `retrieve_p95_ms` (the
dense-only plan): share of the traced slice with no kernel, copy or set
running on the device, in %."""
from h100bench.harness.readers import idle_share


def read(run):
    return idle_share(run)
