"""Arithmetic the per-layer readers share: telemetry stages outside the
traced slice, and shares of a bound and of the slice inside it.  Each reader
returns None where its run holds nothing to read, and the harness then
leaves the metric out of the line."""
from __future__ import annotations

from typing import Optional

# the device kernels of each kernel of the port, by name
K1_KERNELS = ("topk_count_kernel", "topk_compact_kernel", "topk_scan_kernel",
              "topk_merge_lists_kernel")


def mean_stage_ms(run, stage: str) -> Optional[float]:
    """Mean ms of a telemetry stage over the executes outside the slice."""
    xs = [st[stage] for st, attrs in run.program_spans
          if stage in st and not attrs.get("profiled")]
    return 1e3 * sum(xs) / len(xs) if xs else None


def k1_share(run) -> Optional[float]:
    """K1's share of its roofline over the traced slice: the least time of
    every execute's masked top-k there (`bounds.topk_bound_ms` of what its
    inputs need) over the device time of K1's kernels there, in %."""
    from h100bench.harness import bounds
    calls = run.facts.get("k1_calls") or []
    if run.device_trace is None or not calls:
        return None
    bound_s = sum(bounds.topk_bound_ms(**c) for c in calls) / 1e3
    return share(bound_s, run.device_trace.device_s(K1_KERNELS))


def share(bound_s: float, time_s: float) -> Optional[float]:
    """A bound's share of the time taken, in %, or None with no time."""
    if time_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / time_s


def idle_share(run) -> Optional[float]:
    t = run.device_trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * t.idle_share()
