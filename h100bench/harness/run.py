"""What a driver hands back, the measured window, and the read-outs the
check takes from the timed path."""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

from h100bench.harness.bench import Spans
from h100bench.harness.trace import DeviceTrace


class Run:
    """One run of one cell: the end-to-end numbers, the compared numbers,
    and, in a traced run, the device trace, the host spans and the facts
    the per-layer readers need."""

    def __init__(self, cell, trace: bool):
        self.cell = cell
        self.trace = trace
        self.spans = Spans(enabled=trace)
        self.device_trace: Optional[DeviceTrace] = None
        self.program_spans: List[tuple] = []   # ({stage: s}, span attrs)
        self.facts: Dict[str, object] = {}
        self.e2e: Dict[str, float] = {}
        self.compared: List[dict] = []
        self.faults: List[str] = []
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.setup_s = 0.0


class Window:
    """The measured window: `open()` is true until `seconds` have passed.
    In a traced run the device trace covers a steady slice of it, from
    `profile_at_s` (at most a third of the window) for `profile_s`."""

    def __init__(self, seconds: float, mix: dict, run: Run):
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + seconds
        self.trace = DeviceTrace(run.spans) if run.trace else None
        run.device_trace = self.trace
        at = min(float(mix["profile_at_s"]), seconds / 3.0)
        self.p0, self.p1 = self.t0 + at, self.t0 + at + float(mix["profile_s"])
        self.state = 0
        self.slice = (float("inf"), float("-inf"))
        self.seconds = 0.0
        self.run = run
        self._gc_t0 = 0.0
        self.gc_pauses: List[tuple] = []      # (generation, seconds)
        gc.callbacks.append(self._gc)

    def _gc(self, phase: str, info: dict) -> None:
        """The interpreter's collections inside the window, for the facts."""
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gc_pauses.append((info["generation"],
                                   time.perf_counter() - self._gc_t0))

    def open(self) -> bool:
        now = time.perf_counter()
        if self.trace is not None:
            if self.state == 0 and now >= self.p0:
                self.trace.start()
                started = time.perf_counter()
                self.p1 = started + (self.p1 - self.p0)
                self.slice = (started, float("inf"))
                self.state = 1
            elif self.state == 1 and now >= self.p1:
                self._stop()
        return now < self.deadline

    def _stop(self) -> None:
        self.trace.stop()
        self.slice = (self.slice[0], time.perf_counter())
        self.state = 2

    def close(self, t_end: float) -> None:
        """The window runs from its start to the end of its last work."""
        if self.state == 1:
            self._stop()
        self.seconds = t_end - self.t0
        gc.callbacks.remove(self._gc)
        self.run.facts["gc_ms"] = [1e3 * s for _, s in self.gc_pauses] or [0.0]
        self.run.facts["gc_full_ms"] = sum(1e3 * s for g, s in self.gc_pauses
                                           if g == 2)

    def in_slice(self, start: float, end: float) -> bool:
        return self.slice[0] <= start and end <= self.slice[1]


def sync(device) -> None:
    """Wait for the device's work (a no-op on the CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    import torch
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def row_of(held, i):
    """Row i of a held (scores, ids) pair of tensors, as host lists (None
    where the timed path made no such row)."""
    if held is None or i >= held[1].shape[0]:
        return None
    return held[0][i].tolist(), held[1][i].tolist()


def spy_rankings(svc) -> dict:
    """Keep the dense (K1's entry, `VectorIndex.search_batch`) and BM25
    (`BM25Index.topk_batch_dev`) rankings of each execute: references to
    the (scores, ids) tensors the timed path made, read only after the
    window."""
    held: dict = {}
    vi, bm = svc.store.vindex, svc.store.bm25
    search, topk = vi.search_batch, bm.topk_batch_dev

    def dense(*a, **kw):
        out = search(*a, **kw)
        held["dense"] = out
        return out

    def sparse(*a, **kw):
        out = topk(*a, **kw)
        held["sparse"] = out
        return out

    vi.search_batch, bm.topk_batch_dev = dense, sparse
    return held
