"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files; a configuration, a mix and a metric added as new
files and entries only."""
import json
import re
import shutil
from pathlib import Path

import pytest

from h100bench.harness.bench import ROOT, Cell, load_module

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert BENCH["command"] == ["python3", "h100bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_and_cells():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100bench/")
        assert (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_metrics_keys_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m["workloads"]:       # the cell reports what it moves
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    assert all(m["unit"] == "%" for m in BENCH["per_layer"]
               if "_roofline" in m["name"])


@pytest.mark.parametrize("name", CELLS)
def test_every_name_resolves_to_its_files(name):
    cell = Cell(name)
    assert cell.driver().run
    assert {"min_checked"} <= set(cell.limits)
    assert [m["name"] for m in cell.end_to_end if m["name"] != "setup_s"]
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)


def test_a_config_a_mix_and_a_metric_added_as_files_only(tmp_path):
    """A later change copies nothing and edits no file: it adds a config
    file, a traffic file, a limits file, a reader and entries."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "h100bench", root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "h100bench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    (root / "h100bench/configs/fake-store.json").write_text(
        json.dumps(dict(json.loads((ROOT / bench["configs"][0]["file"])
                                   .read_text()), rows=4096)))
    (root / "h100bench/traffic/fake-mix.json").write_text(json.dumps(
        {"kind": "retrieve", "plan": "dense_only", "batch": 8,
         "tenant_zipf": 1.2, "warmup_batches": 1, "profile_at_s": 1,
         "profile_s": 1, "check_requests": 8}))
    (root / "h100bench/limits/fake-cell.json").write_text(
        json.dumps({"dense_err": 1e-5, "min_checked": 8}))
    (root / "h100bench/metrics/fake_rows.py").write_text(
        "def read(run):\n    return float(len(run.facts.get('k1_calls', [])))"
        " or None\n")
    bench["configs"].append({"name": "fake-store", "source": "x",
                             "file": "h100bench/configs/fake-store.json",
                             "reduced": ["rows"], "why": "a test"})
    bench["workloads"].append({"name": "fake-cell", "config": "fake-store",
                               "traffic": "fake-mix", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "retrieve_per_s":
            m["workloads"].append("fake-cell")
    bench["per_layer"].append({"name": "fake_rows", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "retrieve_per_s",
                               "workloads": ["fake-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell("fake-cell", root=root)
    assert cell.config["rows"] == 4096 and cell.traffic["batch"] == 8
    assert [m["name"] for m in cell.per_layer] == ["fake_rows"]

    class FakeRun:
        facts = {"k1_calls": [{}, {}]}
    assert cell.reader("fake_rows").read(FakeRun()) == 2.0
    assert cell.driver().KERNELS == ("topk_mips",)
    after = {p: p.read_bytes() for p in before}
    assert after == before                  # no file was edited
    assert load_module(Path(root / "h100bench/metrics/fake_rows.py"))
