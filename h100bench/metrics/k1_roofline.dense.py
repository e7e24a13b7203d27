"""`k1_roofline` in the cells where it moves `retrieve_p95_ms` (the
dense-only plan, whose rate is not end to end): K1's share of its roofline
over the traced slice."""
from h100bench.harness.readers import k1_share


def read(run):
    return k1_share(run)
