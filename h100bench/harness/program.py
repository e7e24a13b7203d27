"""The program's own trace of each execute of the window, from its telemetry
ring (`repro_torch.obs.telemetry`), for the readers of the spans and counts
inside the plan stages.  `drivers/retrieve.py` finishes one trace per
execute, in the order it appends `run.program_spans`; the ring keeps the
newest 512.  Each trace is checked against its entry by the durations of
its top-level stages, which also keeps out traces that other runs left in
the process-wide registry.  Readers return None where the program records
no such span or count."""
from __future__ import annotations

from typing import List, Optional, Tuple


def _stage_s(trace: dict) -> dict:
    return {c["name"]: c["duration_s"]
            for c in trace["root"].get("children", [])}


def execute_traces(run) -> Optional[List[Tuple[dict, bool]]]:
    """(trace, profiled) for the last executes of the window the ring still
    holds, or None with none, or where the ring's newest traces are not the
    run's executes."""
    if not run.program_spans:
        return None
    from repro_torch.obs.telemetry import get_telemetry
    ring = [t for t in get_telemetry().recent_traces(len(run.program_spans))
            if t.get("op") == "execute"]
    if not ring:
        return None
    out = []
    for trace, (stages, attrs) in zip(ring, run.program_spans[-len(ring):]):
        if _stage_s(trace) != stages:
            return None
        out.append((trace, bool(attrs.get("profiled"))))
    return out


def stage_spans(trace: dict, stage: str) -> List[dict]:
    return [c for c in trace["root"].get("children", [])
            if c["name"] == stage]


def mean_part_ms(run, stage: str, part: str) -> Optional[float]:
    """Mean ms a part (a child span of `stage`, summed ones as recorded)
    takes an execute, over the executes outside the traced slice."""
    xs = []
    for trace, profiled in execute_traces(run) or ():
        if profiled:
            continue
        ds = [c["duration_s"] for st in stage_spans(trace, stage)
              for c in st.get("children", ()) if c["name"] == part]
        if ds:
            xs.append(sum(ds))
    return 1e3 * sum(xs) / len(xs) if xs else None


def mean_count(run, key: str) -> Optional[float]:
    """Mean of count `key`, summed over every span of an execute, over the
    executes outside the traced slice that carry it."""
    from repro_torch.obs.telemetry import walk_spans
    xs = []
    for trace, profiled in execute_traces(run) or ():
        if profiled:
            continue
        ns = [s["attrs"][key] for s in walk_spans(trace["root"])
              if key in s.get("attrs", {})]
        if ns:
            xs.append(sum(ns))
    return sum(xs) / len(xs) if xs else None


def stage_idle_share(run, stage: str) -> Optional[float]:
    """Share of the time inside `stage`'s spans, over the executes in the
    traced slice, with no kernel, copy or set on the device, in %: the
    spans' bounds on the profiler's clock against the device trace's busy
    intervals."""
    t = run.device_trace
    if t is None or not t.kernels:
        return None
    spans = [(s["start_unix_ns"] / 1e9, s["end_unix_ns"] / 1e9)
             for trace, profiled in execute_traces(run) or () if profiled
             for s in stage_spans(trace, stage)
             if s.get("start_unix_ns") is not None
             and s.get("end_unix_ns") is not None]
    total = sum(b - a for a, b in spans)
    if total <= 0:
        return None
    busy = t.busy_intervals()
    inside = sum(max(0.0, min(b, e) - max(a, s))
                 for a, b in spans for s, e in busy)
    return 100.0 * (1.0 - inside / total)
