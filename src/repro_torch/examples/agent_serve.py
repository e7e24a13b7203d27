"""Memory-augmented agent serving on the port: the full Memori stack end to
end, step for step as the reference's `examples/agent_serve.py`.

    PYTHONPATH=src python -m repro_torch.examples.agent_serve [--device cuda|cpu]

A small LM is served with continuous batching behind the MemoriClient SDK,
fronted by the multi-tenant MemoryService: every user gets an isolated
namespace in one shared packed bank, chat turns retrieve structured memory
and record the exchange back through Advanced Augmentation, and the
pending queries of all tenants are answered in one batched retrieval (one
embed call + one namespace-masked top-k launch, K1).  The service runs on
a lifecycle runtime (bounded queue, background flusher, write-ahead log,
final snapshot on `close()`).  The LM is memori-agent reduced to 2 layers
of width 128 with random weights from a seeded `torch.Generator`: the demo
shows the system, not a chat model.  On the card (the default) the
engine's prefill runs K6 and its decode K5; `--device cpu` runs the
kernels' plain versions.  At the end the MemoryScheduler fuses two
concurrent clients' single retrieves into batched launches.
"""
import argparse
import tempfile
import threading
import time

USERS = {
    "priya/c0": ("Priya", [
        "Hi there! I am Priya.",
        "I work as a botanist and I live in Tallinn.",
        "My favorite color is indigo.",
        "I adopted a hedgehog named Biscuit.",
    ]),
    "marco/c0": ("Marco", [
        "Hello, Marco here.",
        "I work as a glassblower and I live in Porto.",
        "I adopted a parrot named Olive.",
    ]),
}
BATCH = [("priya/c0", "What is the name of Priya's pet?"),
         ("marco/c0", "What is the name of Marco's pet?")]


def make_engine(device, params=None, seed: int = 0):
    """The example's engine: memori-agent reduced to 2 layers of width 128,
    `params` or random weights from a torch.Generator seeded `seed`."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models.model_api import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SamplerConfig

    cfg = get_config("memori-agent").reduced(layers=2, d_model=128)
    model = Model(cfg)
    if params is None:
        params = model.init_params(
            torch.Generator(device=device).manual_seed(seed))
    return Engine(model, params, max_len=192, slots=2,
                  sampler=SamplerConfig(temperature=0.9, top_k=50),
                  tokenizer=HashTokenizer(cfg.vocab_size))


def run(device="cuda", *, llm=None, params=None, data_dir=None,
        max_new_tokens: int = 16) -> list:
    """Run the demo on `device` ("cuda" or "cpu"); returns the lines it
    printed.  `llm(prompt) -> str` stands in for the engine's generation
    when given (no engine is built); `params` replaces the engine's random
    weights; `data_dir` the temporary journal directory; `max_new_tokens`
    bounds each reply."""
    from repro_torch.common.utils import resolve_device
    from repro_torch.core import LifecyclePolicy, MemoriClient, MemoryService
    from repro_torch.core.embedder import HashEmbedder

    lines = []

    def say(*parts):
        text = " ".join(str(p) for p in parts)
        print(text, flush=True)
        lines.extend(text.split("\n"))

    engine = None
    if llm is None:
        engine = make_engine(resolve_device(device), params)

        def llm(prompt: str) -> str:
            return engine.generate([prompt[-600:]],
                                   max_new_tokens=max_new_tokens)[0]

    data_dir = data_dir or tempfile.mkdtemp(prefix="memori-agent-")
    service = MemoryService(
        HashEmbedder(device=device), budget=800, device=device,
        data_dir=data_dir,
        policy=LifecyclePolicy(flush_interval_s=0.1, max_pending=128,
                               compact_tombstone_ratio=0.3,
                               snapshot_interval_s=10.0))
    for ns, (name, turns) in USERS.items():
        client = MemoriClient(llm, service.namespace(ns), user_name=name)
        for t in turns:
            reply = client.chat(t, timestamp=time.time())
            say(f"{name}: {t}\n  agent: {reply[:60]}")
        # end_session enqueues into the runtime's bounded queue; the
        # background flusher drains it
        client.end_session()

    say("\nservice after sessions:", service.stats())
    # the cross-tenant hot path: both tenants' queries in ONE batched call
    # (reads are read-your-writes while sessions sit in the queue)
    for (ns, q), ctx in zip(BATCH, service.retrieve_batch(BATCH)):
        say(f"\n[{ns}] Q: {q}  ({ctx.token_count} tokens injected)")
        for t in ctx.triples[:3]:
            say(f"   {t.render()}")

    # cross-CLIENT batching: the MemoryScheduler coalesces independent
    # threads' single retrieves into one device launch per tick
    service.start_scheduler(tick_interval_s=0.01, max_batch=16)
    answers = {}

    def client(ns, q):
        # service.retrieve routes through the scheduler
        answers[ns] = service.retrieve(ns, q)

    threads = [threading.Thread(target=client, args=(ns, q))
               for ns, q in BATCH]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = service.scheduler.stats()
    say(f"\nscheduler: {st['retrieves']} concurrent single retrieves in "
        f"{st['retrieve_launches']} batched launch(es)")
    if engine is not None:
        say(f"engine stats: {engine.stats}")
    service.close()          # scheduler drain + final flush + snapshot
    say(f"memory durable in {data_dir} "
        f"(MemoryService.recover picks it up)")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
