"""Retrieves answered over the whole window of a traced run, divided by the
window, in the cells whose rate is not an end-to-end metric (the dense-only
plan: its rate spreads across runs by more than half the widest bound, as
the host's speed moves it; PERF.md)."""


def read(run):
    return run.e2e.get("retrieve_per_s")
