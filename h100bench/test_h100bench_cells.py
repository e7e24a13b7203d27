"""Each cell driven end to end on the port's CPU path at a tiny size: the
run is correct, its end-to-end metrics are there, and a traced run's
per-layer readers that read host spans find them.  The tiny fill commits
in several batches, as the full-size fill does."""
import pytest

from h100bench.harness import memstore
from h100bench.harness.tiny import run_tiny, tiny_cell


@pytest.mark.parametrize("name", ["mem-hybrid-b64", "mem-dense-b64"])
def test_cell_runs_correct_on_the_cpu(monkeypatch, name):
    monkeypatch.setattr(memstore, "FILL_BATCH_ROWS", 2048)
    cell = tiny_cell(name)
    ok, run = run_tiny(cell, seed=(1 << 31) + 11, trace=True)
    assert ok, run.compared
    assert run.attempted > 0 and run.failed == 0
    wanted = {m["name"] for m in cell.end_to_end} - {"setup_s"}
    assert wanted <= set(run.e2e) and run.setup_s > 0
    host = [m["name"] for m in cell.per_layer
            if m["source"] in ("program_span", "host_clock")]
    assert host and all(cell.reader(n).read(run) is not None for n in host)
