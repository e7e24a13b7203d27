"""The port's launcher (`python -m repro_torch.launch.serve`) on the serving
path, on the CPU: with `--http-port 0` it boots the scheduler and the HTTP
frontend, prints the address it listens on, records and retrieves through
`HttpMemory` with api-key tenancy, and on SIGTERM exits 0 with a final
snapshot that `MemoryService.recover` answers the same from; without
`--http-port`, `--tick-interval` mounts the scheduler under the demo
agent's chat, whose first decode step runs beside it."""
import ast
import os
import queue
import signal
import subprocess
import sys
import threading

from repro_torch.core import HashEmbedder, HttpMemory, MemoryService, Message

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
QUERY = "Which city does the user live in?"


def _spawn(*args):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--host-demo",
         "--device", "cpu", *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)


def _address(proc, timeout=120):
    """Read the launcher's stdout until it names its address."""
    lines = queue.Queue()

    def pump():
        for ln in proc.stdout:
            lines.put(ln)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    seen = []
    while True:
        ln = lines.get(timeout=timeout)
        if ln is None:
            raise AssertionError(f"launcher exited: {seen} "
                                 f"{proc.stderr.read()}")
        seen.append(ln)
        if ln.startswith("memory layer serving on "):
            return ln.split()[4], lines


def test_launcher_serves_http_and_recovers_after_sigterm(tmp_path):
    d = str(tmp_path / "memori.d")
    proc = _spawn("--tick-interval", "0.002", "--http-port", "0",
                  "--http-host", "127.0.0.1", "--api-keys", "k1=acme,k2=beta",
                  "--snapshot-path", d)
    try:
        addr, lines = _address(proc)
        assert addr.startswith("http://127.0.0.1:")
        acme = HttpMemory(addr, "k1", namespace="conv0")
        out = acme.record_session("conv0", "s0", [
            Message("U", "I live in Osaka.", 1.0),
            Message("U", "I adopted a cat named Tom.", 2.0)])
        assert out == {"queued": True, "flushed": True, "durable": True}
        ctx = acme.retrieve(QUERY)
        assert any(t.object == "osaka" for t in ctx.triples)
        assert acme.last_timing["batch_size"] == 1
        # the second key uses the same namespace string and sees nothing
        beta = HttpMemory(addr, "k2", namespace="conv0").retrieve(QUERY)
        assert beta.triples == [] and "osaka" not in beta.text
        stats = acme.stats()
        assert stats["tenant"] == "acme"
        assert stats["scheduler"]["retrieves"] == 2
    finally:
        proc.send_signal(signal.SIGTERM)
        rest = []
        try:
            proc.wait(timeout=120)
        finally:
            while True:
                ln = lines.get(timeout=30)
                if ln is None:
                    break
                rest.append(ln)
    assert proc.returncode == 0, proc.stderr.read()
    assert f"final snapshot rotation -> {d}\n" in rest
    back = MemoryService.recover(d, HashEmbedder(device="cpu"), device="cpu",
                                 budget=800)
    got = back.retrieve("acme/conv0", QUERY)
    assert got.text == ctx.text and got.token_count == ctx.token_count
    assert back.retrieve("beta/conv0", QUERY).triples == []


def test_launcher_demo_chat_runs_beside_the_scheduler(tmp_path):
    proc = _spawn("--tick-interval", "0.002", "--qos-rate", "100",
                  "--snapshot-path", str(tmp_path / "d"))
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    line = next(ln for ln in out.splitlines() if ln.startswith("scheduler:"))
    st = ast.literal_eval(line[len("scheduler:"):].strip())
    # the chat's retrieve and the final retrieve_batch went through ticks
    assert st["retrieves"] >= 2 and st["retrieve_launches"] >= 2
    assert st["admission"]["admitted"] >= 2
    assert "retrieved 2 triples" in out
