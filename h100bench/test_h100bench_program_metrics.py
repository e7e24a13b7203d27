"""The readers of the program's spans and counts inside the plan stages
(`harness/program.py`): on a synthetic run with a stubbed telemetry ring and
device trace, on an empty run and a ring that is not the run's, and on the
tiny CPU runs of both cells."""
import pytest

from h100bench.harness import memstore
from h100bench.harness.bench import Cell, Spans
from h100bench.harness.run import Run
from h100bench.harness.tiny import run_tiny, tiny_cell
from h100bench.harness.trace import DeviceTrace
from repro_torch.obs import telemetry

HYBRID = ("sparse_select_ms", "sparse_upload_ms", "sparse_stats_ms",
          "sparse_score_ms", "h2d_mib", "sparse_idle_share")
DENSE = ("embed_ms", "budget_select_ms", "budget_render_ms")
NS = 10**9
T0 = 1_800_000_000 * NS                  # an instant on the Unix-epoch clock


class Ring:
    """The telemetry registry as the readers see it: the ring's newest
    finished traces."""

    def __init__(self, traces):
        self.traces = traces

    def recent_traces(self, limit=32):
        return self.traces[-limit:]


def _span(name, start_s, dur_s, children=(), **attrs):
    d = {"name": name, "start_s": start_s, "duration_s": dur_s,
         "start_unix_ns": T0 + round(start_s * NS),
         "end_unix_ns": T0 + round((start_s + dur_s) * NS)}
    if attrs:
        d["attrs"] = attrs
    if children:
        d["children"] = list(children)
    return d


def _execute(at, scale):
    """One execute's trace starting `at` s after T0: the sparse stage
    (0.4 s x scale) with its four parts, then the budget with its two."""
    sparse = _span("plan.sparse", at, 0.4 * scale, [
        _span("sparse.select", at, 0.1 * scale),
        _span("sparse.upload", at + 0.1 * scale, 0.05 * scale,
              h2d_bytes=2**27),
        _span("sparse.stats", at + 0.15 * scale, 0.2 * scale,
              h2d_bytes=2**19),
        _span("sparse.score", at + 0.15 * scale, 0.04 * scale, parts=2,
              summed=True)], h2d_bytes=2**19)
    budget = _span("plan.budget", at + 0.4 * scale, 0.03 * scale, [
        _span("budget.select", at + 0.4 * scale, 0.02 * scale, parts=64,
              summed=True, considered=4096, kept=640),
        _span("budget.render", at + 0.4 * scale, 0.008 * scale, parts=64,
              summed=True)])
    embed = _span("plan.embed", at - 0.005, 0.005 * scale, h2d_bytes=2**16)
    return {"request_id": f"r{at}", "op": "execute",
            "root": {"name": "execute", "start_s": 0.0,
                     "duration_s": 0.5 * scale,
                     "children": [embed, sparse, budget]}}


def _entry(trace, profiled):
    stages = {c["name"]: c["duration_s"] for c in trace["root"]["children"]}
    return stages, ({"profiled": True} if profiled else {})


def _synthetic(monkeypatch, cell="mem-hybrid-b64", junk=()):
    """Three executes, the last in the traced slice, with the device busy
    for 0.1 s of the profiled execute's 0.8-s sparse stage."""
    traces = [_execute(0.0, 1.0), _execute(1.0, 1.0), _execute(2.0, 2.0)]
    monkeypatch.setattr(telemetry, "_GLOBAL", Ring(traces + list(junk)))
    run = Run(Cell(cell), True)
    run.program_spans = [_entry(t, i == 2) for i, t in enumerate(traces)]
    dt = DeviceTrace(Spans(True))
    dt.kernels = [(1800000002.1, 1800000002.15, "index_elementwise_kernel"),
                  (1800000002.7, 1800000002.75, "Memcpy HtoD"),
                  (1800000003.5, 1800000003.6, "after the stage")]
    dt.window_s = 3.0
    run.device_trace = dt
    return run


def test_readers_on_a_synthetic_run(monkeypatch):
    run = _synthetic(monkeypatch)
    hybrid, dense = Cell("mem-hybrid-b64"), Cell("mem-dense-b64")
    want = {"sparse_select_ms": 100.0, "sparse_upload_ms": 50.0,
            "sparse_stats_ms": 200.0, "sparse_score_ms": 40.0,
            "h2d_mib": 128.0 + 0.5 + 0.5 + 1 / 16,
            "sparse_idle_share": 100.0 * (1 - 0.1 / 0.8)}
    for name, value in want.items():
        assert hybrid.reader(name).read(run) == pytest.approx(value), name
    want = {"embed_ms": 5.0, "budget_select_ms": 20.0,
            "budget_render_ms": 8.0}
    for name, value in want.items():
        assert dense.reader(name).read(run) == pytest.approx(value), name


@pytest.mark.parametrize("name", HYBRID + DENSE)
def test_readers_read_none_from_an_empty_run(monkeypatch, name):
    cell = Cell("mem-hybrid-b64" if name in HYBRID else "mem-dense-b64")
    monkeypatch.setattr(telemetry, "_GLOBAL", Ring([_execute(0.0, 1.0)]))
    assert cell.reader(name).read(Run(cell, True)) is None


@pytest.mark.parametrize("name", HYBRID + DENSE[1:])
def test_readers_read_none_from_a_ring_not_the_runs(monkeypatch, name):
    """A trace finished after the run's executes (another run's, a test's)
    breaks the pairing: nothing is read."""
    cell = Cell("mem-hybrid-b64" if name in HYBRID else "mem-dense-b64")
    run = _synthetic(monkeypatch, junk=[_execute(9.0, 3.0)])
    assert cell.reader(name).read(run) is None


def test_a_parents_spans_read_none(monkeypatch):
    """Traces with the stages alone, and no bounds on the shared clock (a
    program before the stage parts): every new reader but the embed's
    reads None, and none raises."""
    run = _synthetic(monkeypatch)
    for t in telemetry._GLOBAL.traces:
        for s in t["root"]["children"]:
            s.pop("children", None)
            s.pop("attrs", None)
            s.pop("start_unix_ns")
            s.pop("end_unix_ns")
    for name in HYBRID + DENSE[1:]:
        cell = Cell("mem-hybrid-b64" if name in HYBRID else "mem-dense-b64")
        assert cell.reader(name).read(run) is None, name


@pytest.mark.parametrize("name", ["mem-hybrid-b64", "mem-dense-b64"])
def test_tiny_runs_read_every_new_program_metric(monkeypatch, name):
    """A registry that already holds other executes' traces (earlier runs
    or tests) reads the same: the run's own are the newest."""
    monkeypatch.setattr(memstore, "FILL_BATCH_ROWS", 2048)
    tel = telemetry.get_telemetry()
    for i in range(3):
        tr = tel.start_trace(op="execute")
        with tel.activate([tr]), tel.span("plan.sparse"):
            pass
        tel.finish_trace(tr)
    cell = tiny_cell(name)
    ok, run = run_tiny(cell, seed=(1 << 31) + 23, trace=True)
    assert ok, run.compared
    new = HYBRID if name == "mem-hybrid-b64" else DENSE
    got = {m["name"]: cell.reader(m["name"]).read(run)
           for m in cell.per_layer if m["name"] in new}
    want = {m["name"] for m in cell.per_layer
            if m["name"] in new and m["source"] != "device_trace"}
    assert want and all(got[n] is not None for n in want), got
    if name == "mem-hybrid-b64":
        parts = sum(got[n] for n in HYBRID[:4])
        assert parts <= cell.reader("sparse_ms").read(run)
        # the masks: (64, capacity) bools, and under a MiB else
        cap = 1 << (cell.config["rows"] - 1).bit_length()
        assert 64 * cap / 2**20 < got["h2d_mib"] < 64 * cap / 2**20 + 1
    else:
        assert got["budget_select_ms"] + got["budget_render_ms"] <= \
            cell.reader("budget_ms.dense").read(run)
