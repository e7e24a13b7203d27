"""Run one cell of the benchmark once on this machine's card.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

Prints the set-up's parts and every number the window gave (also those
that are not the cell's end-to-end metrics) on an earlier line, the compared numbers as the
last lines on standard error, and the result as the last line on standard
output.  `--trace 0` reports the cell's end-to-end metrics, `--trace 1`
its per-layer metrics from a device trace of a slice of the window.
`--control 1` puts the plain reference, in the precision below the
configuration's, in the program's place for the comparison (a check of
the check; the benchmark's own runs never pass it).  Exits non-zero, with
no result, without a card, with fewer cards than the cell asks for, or
when the process holds JAX or the JAX package once the window has closed.
"""
from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """perf_counter() at this process's start (Linux), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache of the program inside the checkout, at fixed
# paths; no library may load JAX on its own
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from h100bench.harness.bench import Cell, SetupClock
    cell = Cell(args.workload)
    clock = SetupClock(T_START)
    with clock.part("imports"):
        import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    return measure(cell, args, clock)


def measure(cell, args, clock, device=None) -> int:
    """Set-up, window, comparison and report of one run on `device`."""
    import torch
    from h100bench.harness.bench import emit_result, loaded_forbidden
    device = device or torch.device("cuda", 0)
    # the configuration's float32 is float32: no TF32 in the products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with clock.part("imports"):
        import repro_torch.core  # noqa: F401
    driver = cell.driver()
    if device.type == "cuda":
        from repro_torch.kernels import build
        with clock.part("kernels"):          # built once in a checkout
            for name in driver.KERNELS:
                build.load(name)
        if args.trace:
            from h100bench.harness.trace import warm_up
            with clock.part("profiler"):
                warm_up(device)
    run = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     bool(args.control), clock, device)
    held = loaded_forbidden()
    if held:
        print(f"the process holds {held} after the window", file=sys.stderr)
        return 3
    print(json.dumps({"setup_parts_s": clock.parts, "setup_s": run.setup_s,
                      "window": run.e2e, "facts": summary(run.facts)}))
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in run.e2e}
        metrics["setup_s"] = {"value": run.setup_s, "unit": "s"}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(run.memory_peak)}
    breakdown = None
    if args.trace and run.device_trace is not None:
        dev["busy_s"] = run.device_trace.busy_s()
        dev["window_s"] = run.device_trace.window_s
        breakdown = run.device_trace.breakdown()
    ok = all(c["ok"] for c in run.compared) and run.failed == 0
    emit_result(ok, run.attempted, run.failed, metrics, dev, run.compared,
                breakdown, run.faults)
    return 0


def summary(facts: dict) -> dict:
    """Distributions of the run's facts for the earlier line."""
    out = {}
    for k, v in facts.items():
        if isinstance(v, (int, float)):
            out[k] = v
        elif isinstance(v, list) and v and isinstance(v[0], (int, float)):
            xs = sorted(v)
            out[k] = {"n": len(xs), "min": xs[0], "median": xs[len(xs) // 2],
                      "mean": sum(xs) / len(xs), "max": xs[-1]}
    return out


if __name__ == "__main__":
    sys.exit(main())
