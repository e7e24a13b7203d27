"""The device trace of a steady slice of the window (`--trace 1` only).

`torch.profiler` records the card's kernels, copies and sets over a slice;
the device's busy time is the union of their intervals (a copy of the
arithmetic of `chip_smoke.py`'s `device_activity`), its idle share one
minus busy over the slice, and each idle gap is labelled by the
benchmark's host span that was open across it (`bench.<name>`
record_functions; "harness" where none was).  Kernels inside replayed
CUDA graphs are recorded like any other.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

MARK = "bench."


def warm_up(device) -> None:
    """Profile one small copy and kernel, so that the profiler's first-use
    start (several seconds on the card) falls in set-up, not in the slice."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        x = torch.ones(1024, device=device)
        (x * 2).sum().item()


class DeviceTrace:
    def __init__(self, spans):
        self.spans = spans
        self.prof = None
        self.kernels: List[Tuple[float, float, str]] = []   # seconds
        self.marks: List[Tuple[float, float, str]] = []
        self.window_s = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.spans.profiling = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.spans.profiling = False
        self.prof.__exit__(None, None, None)
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            start, end = e.start_ns() / 1e9, (e.start_ns()
                                              + e.duration_ns()) / 1e9
            if str(e.device_type()).endswith("CUDA"):
                if (e.is_user_annotation() or name.startswith(MARK)
                        or name.startswith("ProfilerStep")):
                    continue
                self.kernels.append((start, end, name))
            elif name.startswith(MARK):
                self.marks.append((start, end, name[len(MARK):]))
        self.kernels.sort()
        self.marks.sort()
        self.prof = None

    # -- readings ------------------------------------------------------------
    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for s, e, _ in self.kernels:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def device_s(self, names: Sequence[str]) -> float:
        """Device seconds of the kernels whose name holds any of `names`."""
        return sum(e - s for s, e, n in self.kernels
                   if any(k in n for k in names))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, name in self.kernels:
            key = name[:120]
            by[key] = by.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest gaps between busy intervals, each named by the
        host span open at its middle."""
        iv = self.busy_intervals()
        gaps = [(b[0] - a[1], (a[1] + b[0]) / 2)
                for a, b in zip(iv, iv[1:]) if b[0] > a[1]]
        gaps.sort(reverse=True)
        out = []
        for length, mid in gaps[:n]:
            label = "harness"
            for s, e, name in self.marks:
                if s <= mid <= e:
                    label = name          # the innermost open span wins
            out.append([label, length])
        return out

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}
