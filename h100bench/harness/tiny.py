"""A cell cut to a size a CPU test run can hold: the same drivers, checks
and readers over a store of a few thousand rows, on the port's plain
PyTorch path (`device="cpu"`)."""
from __future__ import annotations

import time

from h100bench.harness.bench import Cell, SetupClock

TINY_STORE = {"rows": 6000, "recorded": 2, "templates": 4}


def tiny_cell(name: str, **mix) -> Cell:
    cell = Cell(name)
    cell.config.update(TINY_STORE)
    cell.traffic.update(profile_at_s=0.2, profile_s=0.2,
                        check_requests=64, **mix)
    cell.limits = dict(cell.limits, min_checked=8)
    return cell


def run_tiny(cell: Cell, seed: int = 7, seconds: float = 1.0,
             trace: bool = False, control: bool = False):
    """One run of `cell` on the CPU -> (correct, Run).  One intra-op thread:
    tiny ops gain nothing from more, and test workers share the cores."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = cell.driver().run(cell, seed, seconds, trace, control,
                                SetupClock(time.perf_counter()),
                                torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    return all(c["ok"] for c in run.compared) and run.failed == 0, run
