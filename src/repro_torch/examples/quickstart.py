"""Quickstart on the port: the Memori persistent memory layer in 60 seconds,
step for step as the reference's `examples/quickstart.py`.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda|cpu]

Ingest two chat sessions through Advanced Augmentation, answer questions
from the structured memory (and compare the token bill against stuffing
the full history into the prompt) -- then lose the process and come back:
the service runs on a lifecycle runtime journaling every flush to a
write-ahead log, so a new process recovers the exact same memory with
`MemoryService.recover` and answers identically.  On the card (the
default) every retrieve is one namespace-masked top-k (K1); `--device cpu`
runs the kernels' plain versions.
"""
import argparse
import tempfile
import time

QUESTIONS = ["What does Ana work as now?",
             "What is the name of Ana's parrot?",
             "Where did Ben travel to?"]


def sessions(message, t0: float) -> dict:
    """The example's two sessions (`message` is the package's Message)."""
    return {
        "s0": [
            message("Ana", "Hey! Long time no see.", t0),
            message("Ana", "I work as a data analyst these days.", t0),
            message("Ana", "My favorite food is pad thai.", t0),
            message("Ana", "I adopted a parrot named Mochi.", t0),
            message("Ben", "Nice! I went to Iceland. The glaciers were unreal.", t0),
        ],
        "s1": [
            message("Ana", "Big news since last time we talked!", t0 + 7 * 86400),
            message("Ana", "I used to work as a data analyst, but now I am a chef.",
                    t0 + 7 * 86400),
            message("Ben", "I bought a telescope last week.", t0 + 7 * 86400),
        ],
    }


def run(device="cuda", *, data_dir=None) -> list:
    """Run the quickstart on `device` ("cuda" or "cpu"), journaling to
    `data_dir` (a new temporary directory if None); returns the lines it
    printed."""
    from repro_torch.core import LifecyclePolicy, MemoryService, Message
    from repro_torch.core.baselines import FullContextMemory
    from repro_torch.core.embedder import HashEmbedder

    lines = []

    def say(*parts):
        text = " ".join(str(p) for p in parts)
        print(text, flush=True)
        lines.extend(text.split("\n"))

    data_dir = data_dir or tempfile.mkdtemp(prefix="memori-quickstart-")
    # the runtime owns everything between requests: durable WAL, background
    # flusher (drains the queue in ONE batched embed call), auto-compaction
    # and snapshot rotation
    policy = LifecyclePolicy(flush_interval_s=0.2, max_pending=64,
                             compact_tombstone_ratio=0.3)
    memory = MemoryService(HashEmbedder(device=device), budget=1300,
                           device=device, policy=policy, data_dir=data_dir)
    full = FullContextMemory()

    for sid, msgs in sessions(Message, time.time() - 14 * 86400).items():
        # enqueue is O(1); the background flusher batches the extraction +
        # embedding (reads still see pending sessions)
        memory.enqueue("demo/c0", sid, msgs)
        full.record_session("demo", sid, msgs)

    say("memory stats:", memory.stats(), "\n")
    for q in QUESTIONS:
        ctx = memory.retrieve("demo/c0", q)
        say(f"Q: {q}")
        say(f"  retrieved {len(ctx.triples)} triples, "
            f"{len(ctx.summaries)} summaries, {ctx.token_count} tokens "
            f"(full-context would be {full.retrieve(q).token_count})")
        for t in ctx.triples[:3]:
            say(f"    {t.render()}")
        say()

    prompt, ctx = memory.answer_prompt("demo/c0", "What does Ana work as now?")
    say("--- assembled LLM prompt (truncated) ---")
    say(prompt[:600])

    # persistence: close (final flush + snapshot), then recover in what
    # would normally be a fresh process -- answers are bit-identical
    before = [memory.retrieve("demo/c0", q).text for q in QUESTIONS]
    memory.close()
    recovered = MemoryService.recover(data_dir, HashEmbedder(device=device),
                                      device=device, budget=1300)
    after = [recovered.retrieve("demo/c0", q).text for q in QUESTIONS]
    say("\n--- durability ---")
    say(f"recovered from {data_dir}")
    say("recovered answers identical:", before == after)
    recovered.close()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
