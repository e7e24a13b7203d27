"""Share of the traced slice of a memory cell's window with no kernel,
copy or set running on the device (the union of their intervals), in %."""
from h100bench.harness.readers import idle_share


def read(run):
    return idle_share(run)
