"""Share of the time inside the `plan.sparse` spans of the executes in the
traced slice with no kernel, copy or set on the device, in %: the spans'
bounds on the profiler's clock against the device trace's busy
intervals."""
from h100bench.harness.program import stage_idle_share


def read(run):
    return stage_idle_share(run, "plan.sparse")
