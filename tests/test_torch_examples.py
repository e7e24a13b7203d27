"""The port's two examples (`repro_torch.examples.quickstart` and
`agent_serve`) against the reference's `examples/quickstart.py` and
`examples/agent_serve.py` on the CPU.

Each reference example runs as it is (loaded from its file, through the
JAX package), with `time.time` pinned on both sides, so that the
sessions' timestamps and the triples' dates agree.  agent_serve's LM is
swapped on both sides for one deterministic stub whose reply depends on
the prompt it is given (the reference's `Engine` class is replaced by
one that calls the stub on the prompts the example passes it), so a
prompt that differed would show in the replies.  Every printed line must
be equal except those that hold a timing or a path: the service's stats
(pending counts and the snapshot age depend on the background flusher),
the scheduler's launch count (both must count 2 retrieves in at most 2
launches), the engine's stats and the journal directory.  A second
agent_serve run uses the example's own engine with the reference's
weights (`params_from_numpy`) and must run to its end."""
import importlib.util
import os
import tempfile
import time

import jax
import numpy as np

from repro.configs import get_config as jget_config
from repro.models.model_api import Model as JModel
from repro_torch.configs import get_config
from repro_torch.examples import agent_serve, quickstart
from repro_torch.models.model_api import params_from_numpy

ROOT = os.path.join(os.path.dirname(__file__), "..")
NOW = 1_767_225_600.0          # 2026-01-01 00:00 UTC
VARYING = ("memory stats:", "service after sessions:", "recovered from",
           "memory durable in", "scheduler:", "engine stats:")


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _steady(lines):
    return [ln for ln in lines if not ln.startswith(VARYING)]


def _scheduler_line(lines):
    (line,) = [ln for ln in lines if ln.startswith("scheduler:")]
    words = line.split()
    return int(words[1]), int(words[6])


def _reference_lines(mod, capsys, monkeypatch, data_dir):
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="": str(data_dir))
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.split("\n")


def test_quickstart_matches_the_reference_example(tmp_path, capsys,
                                                  monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    want = _reference_lines(_reference("quickstart"), capsys, monkeypatch,
                            tmp_path / "ref")
    got = quickstart.run("cpu", data_dir=str(tmp_path / "port"))
    capsys.readouterr()
    assert _steady(got) == _steady(want[:len(got)])
    assert got[-1] == want[len(got) - 1] == \
        "recovered answers identical: True"
    retrieved = [ln for ln in got if ln.startswith("  retrieved ")]
    assert len(retrieved) == 3 and all("full-context would be" in ln
                                       for ln in retrieved)


def _stub(prompt: str) -> str:
    """A deterministic reply that moves with the prompt it was given."""
    return f"noted, {sum(map(ord, prompt[-600:])) % 9973} points"


class _StubEngine:
    """Stands in for the reference example's `Engine`: the stub on each
    prompt it is passed."""

    def __init__(self, *args, **kwargs):
        self.stats = {}

    def generate(self, prompts, max_new_tokens):
        return [_stub(p) for p in prompts]


def test_agent_serve_matches_the_reference_example(tmp_path, capsys,
                                                   monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    ref = _reference("agent_serve")
    monkeypatch.setattr(ref, "Engine", _StubEngine)
    want = _reference_lines(ref, capsys, monkeypatch, tmp_path / "ref")
    got = agent_serve.run("cpu", llm=_stub, data_dir=str(tmp_path / "port"))
    capsys.readouterr()
    want = want[:len(want) - 1] if want[-1] == "" else want
    assert _steady(got) == _steady(want)
    assert any(ln.startswith("  agent: noted, ") for ln in got)
    # isolation: each tenant's batch answer holds only its own facts
    text = "\n".join(got)
    assert "biscuit" in text and "olive" in text
    for lines in (got, want):
        retrieves, launches = _scheduler_line(lines)
        assert retrieves == 2 and 1 <= launches <= 2


def test_agent_serve_runs_its_engine_on_the_reference_weights(tmp_path):
    jcfg = jget_config("memori-agent").reduced(layers=2, d_model=128)
    cfg = get_config("memori-agent").reduced(layers=2, d_model=128)
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    lines = agent_serve.run("cpu", params=params, data_dir=str(tmp_path),
                            max_new_tokens=2)
    assert sum(ln.startswith("  agent: ") for ln in lines) == 7
    assert _scheduler_line(lines)[0] == 2
    assert any(ln.startswith("engine stats: {") for ln in lines)
    assert lines[-1].startswith(f"memory durable in {tmp_path}")
