"""The import check compares top-level module names whole; nothing of the
benchmark imports JAX or the JAX package, and the reference imports
nothing of the program; without a card a run exits non-zero and prints no
result."""
import ast
import os
import subprocess
import sys

from h100bench.harness.bench import FORBIDDEN, HERE, ROOT, loaded_forbidden


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "jaxtyping", "flaxen",
                 "reproducible"):
        monkeypatch.setitem(sys.modules, name, sys)
    held = set(loaded_forbidden())
    assert not held & {"repro_torch", "jaxtyping", "flaxen", "reproducible"}
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"repro", "jax"} <= set(loaded_forbidden())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = list(HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not set(_imports(f)) & set(FORBIDDEN), f
    for f in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(f)), f


def test_without_a_card_a_run_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", "mem-dense-b64",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
