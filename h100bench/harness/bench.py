"""The harness's spine: names to files, the set-up clock, the host spans,
the import guard and the result line.

Everything a cell needs is found by the names in `BENCHMARK.json`: the
configuration's file (`configs[].file`), the traffic mix
`h100bench/traffic/<traffic>.json`, the driver of the mix's `kind`
`h100bench/drivers/<kind>.py`, the limits of the cell's comparison
`h100bench/limits/<workload>.json`, and one reader a per-layer metric,
`h100bench/metrics/<metric>.py`.  A later change adds a configuration, a
mix or a metric by adding files and entries; none of these is edited.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent.parent          # h100bench/
ROOT = HERE.parent                                     # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")         # top-level names


def load_module(path: Path) -> ModuleType:
    """Import one file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "h100bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with everything its name points at."""

    def __init__(self, name: str, bench: Optional[dict] = None,
                 root: Path = ROOT):
        bench = bench if bench is not None else json.loads(
            (root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads(
            (root / configs[self.workload["config"]]["file"]).read_text())
        self.traffic = json.loads(
            (root / "h100bench" / "traffic"
             / f"{self.workload['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.root = root
        limits = root / "h100bench" / "limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text())

    def driver(self) -> ModuleType:
        return load_module(self.root / "h100bench" / "drivers"
                           / f"{self.traffic['kind']}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root / "h100bench" / "metrics"
                           / f"{metric}.py")


class SetupClock:
    """Set-up time by part, from process start (`t_start`) to the window."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.parts: Dict[str, float] = {}

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = (self.parts.get(name, 0.0)
                                + time.perf_counter() - t0)

    def total(self) -> float:
        return time.perf_counter() - self.t_start


class Spans:
    """The benchmark's own host spans around calls into the program's
    layers: (name, start, end, attrs) on the host clock.  While a profile
    slice runs, spans also go to the profiler as `record_function`s so
    that idle gaps can be labelled, and are marked `profiled` (the
    profiler slows the host: readers of host times leave them out)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.items: List[tuple] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        if not self.enabled:
            yield attrs
            return
        rf = contextlib.nullcontext()
        if self.profiling:
            from torch.profiler import record_function
            rf = record_function("bench." + name)
        t0 = time.perf_counter()
        with rf:
            yield attrs
        attrs["profiled"] = self.profiling
        self.items.append((name, t0, time.perf_counter(), attrs))

    def of(self, name: str, profiled: bool = False) -> List[tuple]:
        return [s for s in self.items
                if s[0] == name and s[3].get("profiled", False) == profiled]


def loaded_forbidden() -> List[str]:
    """Top-level module names of `FORBIDDEN` that this process holds."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in FORBIDDEN if t in tops)


def emit_result(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, compared: List[dict],
                breakdown: Optional[dict] = None,
                faults: Sequence[str] = ()) -> None:
    """The first faults the check found, then the compared numbers as the
    last lines on stderr; the result as the last line on stdout (its
    `compared` key last)."""
    for f in faults:
        print(f"wrong: {f}", file=sys.stderr)
    for c in compared:
        print(f"compared {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILS'})", file=sys.stderr)
    sys.stderr.flush()
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                       for c in compared}
    print(json.dumps(out), flush=True)
