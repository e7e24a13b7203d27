"""The PyTorch port stands alone: every module imports with `jax` and
`msgpack` unavailable, and no port file (nor the GPU smoke test) imports
`jax` or the JAX package `repro`."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")


def _port_modules():
    import repro_torch
    return ["repro_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch."))


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_every_port_module_imports_without_jax_or_msgpack():
    mods = _port_modules()
    for m in ("repro_torch.core.service", "repro_torch.core.tiering",
              "repro_torch.kernels.ops", "repro_torch.models.model_api",
              "repro_torch.serving.engine", "repro_torch.core.sdk"):
        assert m in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['msgpack'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'repro' or k.startswith('repro.')\n"
            "               for k in sys.modules)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_names(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_imports_neither_jax_nor_reference(path):
    bad = [n for n in _imported_names(path)
           if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_imports_no_msgpack(path):
    """The port's files are MessagePack through its own codec
    (`checkpoint/packing.py`): the card's machine has no msgpack."""
    bad = [n for n in _imported_names(path) if n.split(".")[0] == "msgpack"]
    assert not bad, f"{path} imports {bad}"


def test_durable_service_runs_with_jax_and_msgpack_blocked(tmp_path):
    """Snapshot, journal, rotate and recover a port service on the CPU in a
    process where importing `jax` or `msgpack` fails."""
    code = r"""
import sys
sys.modules['jax'] = None
sys.modules['msgpack'] = None
from repro_torch.core import HashEmbedder, MemoryService, Message
d, snap = sys.argv[1], sys.argv[2]
emb = HashEmbedder(device="cpu")
svc = MemoryService(emb, device="cpu", data_dir=d)
svc.record("a/c0", "s0", [Message("A", "I live in Tallinn.", 1.7e9)])
svc.snapshot(snap)
svc.rotate()
svc.record("b/c0", "s0", [Message("B", "I adopted a cat named Tom.", 1.7e9)])
svc.store.link("b/c0", "B", "Tom")
q = [("a/c0", "Which city does the user live in?"),
     ("b/c0", "What pet was adopted?")]
want = [c.text for c in svc.retrieve_batch(q)]
got = [c.text for c in MemoryService.recover(d, emb, device="cpu")
       .retrieve_batch(q)]
assert got == want, (got, want)
assert MemoryService.restore(snap, emb, device="cpu").stats()["bank_rows"] \
    == 1
assert not any(k == 'repro' or k.startswith('repro.') for k in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "data"),
         str(tmp_path / "snap.msgpack")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
