"""The 4-rank side of tests/test_torch_distribution.py,
test_torch_distribution_train.py, test_torch_context_parallel.py and
test_torch_mesh_serving.py: spawns 4 gloo ranks on a FileStore (no TCP
port) and runs one part of the port's meshed paths on (2, 2), (1, 4) and
(4, 1) ("data", "model") CPU meshes — "serve" (the meshed `sharded_topk`,
the meshed service, prefill and decode), "train" (each family's loss and
gradients, the whole dense step), "context" (long_500k decode on the
context-parallel rules, cut to LONG_T positions) or "scheduler" (the
meshed MemoryScheduler and MemoryFrontend); rank 0 writes what they
returned to OUT/results.pt (rank r > 0 what it saw to OUT/results-r.pt)
for the tests to hold against the reference and the one-device port.
Each test module spawns its part once (`results`).

    PYTHONPATH=src python tests/torch_mesh_worker.py OUT_DIR PART
"""
import dataclasses
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
CITIES = ["Tallinn", "Porto", "Cusco", "Oslo", "Quito", "Hanoi", "Lagos",
          "Lima"]
# (name, arch, config overrides) of every family the meshed steps cover
FAMILIES = (
    ("dense", "internlm2-1.8b", {}),
    ("moe_global", "phi3.5-moe-42b-a6.6b", {}),
    ("moe_local", "phi3.5-moe-42b-a6.6b", {"dispatch": "local"}),
    ("mla_absorbed", "deepseek-v3-671b", {"mla_absorbed_train": True}),
    ("mla", "deepseek-v3-671b", {}),
    ("mamba2", "mamba2-2.7b", {}),
    ("rglru", "recurrentgemma-9b", {}),
    ("encdec", "whisper-small", {}),
    ("vlm", "paligemma-3b", {}),
    # 2 kv heads on a 4-wide `model` axis (the head fallback): each rank's
    # query head reads the kv head it needs, cut from the whole keys
    ("gqa_model4", "internlm2-1.8b", {"num_kv_heads": 2}),
)
SERVE_FAMILIES = ("dense", "moe_global", "mla", "mamba2", "rglru", "encdec",
                  "vlm", "gqa_model4")
# the (data, model) mesh of each family; (2, 2) when not listed
FAMILY_MESH = {"gqa_model4": (1, 4)}
B, S, MAX_LEN, STEPS = 4, 16, 40, 3


def family_config(arch, overrides):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced(
        layers=3 if "gemma" in arch else 2, d_model=64)
    over = dict(overrides)
    if over.pop("dispatch", None) == "local":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="local", local_shards=2))
    return dataclasses.replace(cfg, **over)


def family_batch(cfg, seed=1, rows=B, seq=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(4, cfg.vocab_size, (rows, seq)).astype(np.int32))}
    if cfg.num_image_tokens:
        batch["images"] = torch.from_numpy(rng.standard_normal(
            (rows, cfg.num_image_tokens, 1152)).astype(np.float32))
    if cfg.is_encoder_decoder:
        batch["audio"] = torch.from_numpy(rng.standard_normal(
            (rows, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    return batch


def family_params(model):
    """Seeded weights with every attention's query and key projections
    rescaled to unit score spread (chip_smoke.py's `unit_scores`): at the
    reference's init a score spread of ~100 makes attention a hard max, and
    rounding alone (even the one-device port on 1 thread against many: 1%
    of paligemma's embedding gradient) parts two correct paths."""
    cfg = model.cfg
    params = model.init_params(torch.Generator().manual_seed(0))
    d, H, K = cfg.d_model, cfg.num_heads, cfg.num_kv_heads

    def attn(p):
        if "wuq" in p:                       # MLA
            m = cfg.mla
            return {**p, "wuq": p["wuq"] * (H / m.q_lora_rank) ** 0.5,
                    "wuk": p["wuk"] * (H / m.kv_lora_rank) ** 0.5}
        return {**p, "wq": p["wq"] * (H / d) ** 0.5,
                "wk": p["wk"] * (K / d) ** 0.5}

    def layers(ls):
        return [{**b, **{n: attn(b[n]) for n in ("attn", "cross_attn")
                         if n in b}} for b in ls]

    out = {**params, "layers": layers(params["layers"])}
    if "encoder" in params:
        out["encoder"] = {**params["encoder"],
                          "layers": layers(params["encoder"]["layers"])}
    if "mtp" in params:
        out["mtp"] = {**params["mtp"],
                      "block": layers([params["mtp"]["block"]])[0]}
    return out


def one_device(name):
    """(config, Model, seeded weights) of family `name` on one device."""
    from repro_torch.models.model_api import Model
    _, arch, over = next(f for f in FAMILIES if f[0] == name)
    cfg = family_config(arch, over)
    model = Model(cfg)
    return cfg, model, family_params(model)


def topk_inputs():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    bank = rng.standard_normal((64, 32)).astype(np.float32)
    bank_ns = (np.arange(64) % 3).astype(np.int32)
    bank_ns[[5, 33]] = 7            # ns 7 owns 2 rows, ns 9 none
    bank_ns[::7] = -1               # tombstones
    q_ns = np.array([0, 1, 2, 7, 9, 0], np.int32)
    return q, bank, q_ns, bank_ns


def fill(svc):
    from repro_torch.core import Message
    for i, c in enumerate(CITIES):
        svc.enqueue(f"u{i}/c0", "s0",
                    [Message("U", f"I live in {c}.", 1700000000.0)])
    svc.flush()
    return svc


QUERIES = [(f"u{i}/c0", "Which city does the user live in?")
           for i in range(8)]


def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def run_topk(mesh, out):
    from torch.distributed.tensor import Shard
    from repro_torch.common import partitioning as pt
    from repro_torch.core.vector_index import sharded_topk
    q, bank, q_ns, bank_ns = map(torch.from_numpy, topk_inputs())
    pl = (Shard(0), Shard(0))
    dbank = pt.shard_local(bank, mesh, pl)
    dns = pt.shard_local(bank_ns, mesh, pl)
    for k in (6, 20):               # 20 > the 16 rows of a rank's slab
        out[f"topk_masked_{k}"] = sharded_topk(q, dbank, k, q_ns=q_ns,
                                               bank_ns=dns, mesh=mesh)
        out[f"topk_masked_whole_{k}"] = sharded_topk(
            q, bank, k, q_ns=q_ns, bank_ns=bank_ns, mesh=mesh)
        out[f"topk_{k}"] = sharded_topk(q, dbank, k, mesh=mesh)


def run_service(mesh, out, root):
    from repro_torch.core import MemoryService
    from repro_torch.core.embedder import HashEmbedder
    emb = HashEmbedder(device="cpu")
    data_dir = os.path.join(root, "meshed-dir")
    svc = fill(MemoryService(emb, device="cpu", budget=800, shards=8,
                             mesh=mesh, data_dir=data_dir))
    out["svc_texts"] = [c.text for c in svc.retrieve_batch(QUERIES)]
    bank = svc.store.sharded.bank_device()
    out["svc_bank"] = (tuple(bank.placements), tuple(bank.shape),
                       tuple(bank.to_local().shape), bank.device_mesh.size())
    out["svc_stats"] = svc.store.sharded.stats()
    out["svc_rotate"] = svc.runtime.rotate()
    svc.close()
    dist.barrier()
    rec = MemoryService.recover(data_dir, emb, device="cpu", budget=800,
                                mesh=mesh)
    out["svc_recovered"] = [c.text for c in rec.retrieve_batch(QUERIES)]
    rec.close()


def run_train(meshes, out):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.common.module import leaves_with_names
    from repro_torch.launch.sharding import build_train_step, place_batch
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import loss_and_grads
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=B,
                                seq_len=S)
    for name, arch, over in FAMILIES:
        mesh = meshes[FAMILY_MESH.get(name, (2, 2))]
        cfg = family_config(arch, over)
        bundle = build_train_step(cfg, shape, mesh)
        params = bundle.model.shard_params(
            family_params(bundle.model), mesh, bundle.rules)
        batch = family_batch(cfg)
        with implicit_replication():
            metrics, grads = loss_and_grads(bundle.model, params,
                                            place_batch(batch, mesh))
        out[f"train_{name}"] = (
            {k: float(full(v)) for k, v in metrics.items()},
            [full(g) for _, g in leaves_with_names(grads)])
        if name == "dense":         # the whole step: AdamW on DTensors
            _, state, m = bundle.fn(params, opt.init(bundle.opt, params),
                                    batch)
            out["train_step_dense"] = (
                {k: float(full(v)) for k, v in m.items()},
                [tuple(x.placements) for _, x in
                 leaves_with_names(state.mu)][:3])


def run_serve(meshes, out):
    from repro_torch.launch.sharding import (build_decode_step,
                                             build_prefill_step)
    from repro_torch.models.config import INPUT_SHAPES
    for name, arch, over in FAMILIES:
        if name not in SERVE_FAMILIES:
            continue
        mesh = meshes[FAMILY_MESH.get(name, (2, 2))]
        cfg = family_config(arch, over)
        P = S + (cfg.num_image_tokens or 0)
        pre = build_prefill_step(cfg, dataclasses.replace(
            INPUT_SHAPES["prefill_32k"], global_batch=B, seq_len=P), mesh)
        dec = build_decode_step(cfg, dataclasses.replace(
            INPUT_SHAPES["decode_32k"], global_batch=B, seq_len=MAX_LEN),
            mesh)
        params = pre.model.shard_params(family_params(pre.model), mesh,
                                        pre.rules)
        logits, caches = pre.fn(params, family_batch(cfg))
        caches = dec.model.prepare_decode_caches(caches, P, MAX_LEN)
        outs = [full(logits)]
        for t in range(STEPS):
            tok = torch.full((B, 1), 5 + t, dtype=torch.int32)
            lg, caches = dec.fn(params, tok, caches,
                                torch.full((B,), P + t, dtype=torch.int32))
            outs.append(full(lg))
        out[f"serve_{name}"] = outs


# long_500k decode (batch 1, the cache's sequence sharded over `data` by
# long_context_rules) cut to LONG_T positions, the windowed archs' ring to
# LONG_WINDOW slots, after a one-device prefill of LONG_S tokens (past the
# ring's first lap), on every family with long context (whisper has none)
LONG_FAMILIES = ("dense", "moe_global", "mla", "mamba2", "rglru", "vlm")
LONG_MESHES = ((4, 1), (2, 2))
LONG_T, LONG_WINDOW, LONG_S, LONG_STEPS = 256, 64, 72, 3


def long_config(name):
    _, arch, over = next(f for f in FAMILIES if f[0] == name)
    return long_window(family_config(arch, over))


def long_window(cfg):
    """`cfg` (either package's) with its long-context ring, or its local
    attention's, at LONG_WINDOW slots."""
    if cfg.long_context_window:
        cfg = dataclasses.replace(cfg, long_context_window=LONG_WINDOW)
    if cfg.hybrid_period:
        cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(
            cfg.rglru, local_window=LONG_WINDOW))
    return cfg


def long_shape():
    from repro_torch.models.config import INPUT_SHAPES
    return dataclasses.replace(INPUT_SHAPES["long_500k"], global_batch=1,
                               seq_len=LONG_T)


def long_prefill(cfg, model, params):
    """(prompt length P, decode caches of LONG_T positions) after a
    one-device prefill of LONG_S tokens (and the image prefix)."""
    window = cfg.long_context_window or None
    with torch.no_grad():
        _, caches = model.prefill(params, family_batch(cfg, rows=1,
                                                       seq=LONG_S),
                                  window_override=window)
    P = LONG_S + (cfg.num_image_tokens or 0)
    return P, model.prepare_decode_caches(caches, P, LONG_T,
                                          window_override=window)


def long_step_inputs(P, t):
    return (torch.full((1, 1), 5 + t, dtype=torch.int32),
            torch.full((1,), P + t, dtype=torch.int32))


def run_context(meshes, out):
    """Each LONG_FAMILIES family's LONG_STEPS decode steps through
    `build_decode_step(long_500k)` on each LONG_MESHES mesh: the logits,
    each step's all-gather bytes (the dry-run's `RankCounter`) and those
    of its attention calls alone (every collective their placements and
    the combine make), this rank's bytes of its shard of the attention
    caches (every layer's) and their placements."""
    from repro_torch.launch.dryrun import RankCounter
    from repro_torch.launch.sharding import build_decode_step
    from repro_torch.models.layers import attention, mla
    attn = {"bytes": 0}

    def counted(fn):
        def run(*a, **kw):
            counter = RankCounter()
            with counter:
                out = fn(*a, **kw)
            attn["bytes"] += counter.coll["all_gather_into_tensor"]
            return out
        return run

    attention.attend_decode = counted(attention.attend_decode)
    mla._context_parallel = counted(mla._context_parallel)
    for name in LONG_FAMILIES:
        cfg = long_config(name)
        for mshape in LONG_MESHES:
            mesh = meshes[mshape]
            dec = build_decode_step(cfg, long_shape(), mesh)
            params = family_params(dec.model)
            P, caches = long_prefill(cfg, dec.model, params)
            dparams = dec.model.shard_params(params, mesh, dec.rules)
            logits, gathered, attn_gathered = [], [], []
            for t in range(LONG_STEPS):
                tok, pos = long_step_inputs(P, t)
                counter = RankCounter()
                attn["bytes"] = 0
                with counter:
                    lg, caches = dec.fn(dparams, tok, caches, pos)
                logits.append(full(lg))
                gathered.append(counter.coll["all_gather_into_tensor"])
                attn_gathered.append(attn["bytes"])
            # the attention caches (k / v, MLA's latent), sequence first
            seq = [c for c in caches if c and ("k" in c or "ckv" in c)]
            shards = [sum(x.to_local().numel() * x.element_size()
                          for x in c.values()) for c in seq]
            placements = sorted({str(tuple(x.placements)) for c in seq
                                 for x in c.values()})
            out[f"long_{name}_{mshape[0]}x{mshape[1]}"] = {
                "logits": logits, "gather_bytes": gathered,
                "attention_gather_bytes": attn_gathered,
                "shard_bytes": sum(shards) if shards else None,
                "placements": placements}


# the meshed scheduler part: SCHED_CLIENTS closed-loop clients on rank 0
# (through the scheduler, and as HttpMemory through the frontend); the
# runtime's policy auto-compacts and rotates snapshots, so rank 0's
# maintenance decisions are shipped to the other ranks with the ticks
SCHED_CLIENTS = 8
HTTP_KEY, HTTP_TENANT = "k-acme", "acme"
PETS = ["Rex", "Tom", "Bella", "Max", "Luna", "Coco", "Milo", "Nala"]


def sched_policy():
    from repro_torch.core.lifecycle import LifecyclePolicy
    return LifecyclePolicy(compact_tombstone_ratio=0.05,
                           compact_min_tombstones=1, compact_idle_s=0.0,
                           snapshot_interval_s=0.5, tick_s=0.02)


def _msg(text, i):
    from repro_torch.core import Message
    return (Message("U", text, 1700000000.0 + i),)


def drive_scheduled(svc, address) -> dict:
    """Records, retrieves, evictions and a compaction from SCHED_CLIENTS
    threads, each request through `svc.scheduler` or over HTTP
    (`HttpMemory` at `address`) and waited for before the client's next;
    returns every answer as JSON text (the envelopes' payloads; the HTTP
    contexts' fields), in request order."""
    import json
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core import HttpMemory
    from repro_torch.core.api import (CompactRequest, EvictRequest,
                                      RecordRequest, RetrieveRequest,
                                      payload_to_json)
    sched = svc.scheduler

    def through(req):
        resp = sched.submit(req).result(timeout=60)
        assert resp.status == "ok", resp.error
        return json.dumps(payload_to_json(resp.payload), sort_keys=True)

    def http(i):
        return HttpMemory(address, HTTP_KEY, namespace=f"h{i}")

    def http_record(i):
        http(i).record_session(f"h{i}", "s0", list(_msg(
            f"My cat is called {PETS[i]}.", i)))
        return i

    def http_retrieve(i):
        ctx = http(i).retrieve("What is the cat called?")
        return json.dumps(dataclasses.asdict(ctx), sort_keys=True)

    users = range(SCHED_CLIENTS)
    out = {}
    with ThreadPoolExecutor(SCHED_CLIENTS) as pool:
        out["record"] = list(pool.map(through, [
            RecordRequest(f"u{i}/c0", "s0", _msg(
                f"I live in {CITIES[i]}. My dog is {PETS[i]}.", i))
            for i in users]))
        out["http_record"] = list(pool.map(http_record, users))
        questions = [RetrieveRequest(f"u{i}/c0", q) for i in users
                     for q in ("Which city does the user live in?",
                               "What is the dog's name?")]
        out["retrieve"] = list(pool.map(through, questions))
        out["http_retrieve"] = list(pool.map(http_retrieve, users))
        out["evict"] = [through(EvictRequest(f"u{i}/c0")) for i in (0, 3)]
        # the policy's auto-compaction (on a mesh: rank 0's decision,
        # shipped with a tick) drops every tombstone first
        deadline = time.monotonic() + 30
        while svc.store.vindex.n_dead:
            assert time.monotonic() < deadline, "no auto-compaction"
            time.sleep(0.01)
        out["compact"] = through(CompactRequest())
        out["after"] = list(pool.map(through, questions))
        out["http_after"] = list(pool.map(http_retrieve, users))
    return out


def bank_digest(svc) -> str:
    """SHA-256 of the store's host state (every snapshot array) and, on a
    mesh, of its whole device bank (a collective: every rank calls it)."""
    import hashlib
    store = svc.store
    h = hashlib.sha256()
    for name, a in sorted(store.snapshot_arrays().items()):
        h.update(name.encode())
        h.update(np.ascontiguousarray(a).tobytes())
    if store.sharded is not None:
        if store.sharded.stale:
            store.sharded.rebuild(store.vindex)
        h.update(full(store.sharded.bank_device()).numpy().tobytes())
    return h.hexdigest()


def run_scheduler(mesh, out, root):
    """The meshed service (shards 8, a durable directory, sched_policy())
    with a MemoryScheduler on every rank; rank 0 also serves it with a
    MemoryFrontend and drives `drive_scheduled`.  Every rank then closes
    its service (rank 0's close stops the others') and records its bank
    digest, its scheduler's mesh counters and its runtime's counters."""
    from repro_torch.core import MemoryService
    from repro_torch.core.api import CompactRequest
    from repro_torch.core.embedder import HashEmbedder
    from repro_torch.serving.frontend import MemoryFrontend
    svc = MemoryService(HashEmbedder(device="cpu"), device="cpu",
                        budget=800, shards=8, mesh=mesh,
                        data_dir=os.path.join(root, "sched-dir"),
                        policy=sched_policy())
    sched = svc.start_scheduler(tick_interval_s=0.002)
    if dist.get_rank() == 0:
        fe = MemoryFrontend(svc, {HTTP_KEY: HTTP_TENANT}).start()
        out["sched_answers"] = drive_scheduled(svc, fe.address)
        fe.close()
    else:
        for what, fn in (("submit", lambda: sched.submit(CompactRequest())),
                         ("frontend", lambda: MemoryFrontend(
                             svc, {HTTP_KEY: HTTP_TENANT}))):
            try:
                fn()
                out[f"sched_{what}"] = "accepted"
            except RuntimeError as e:
                out[f"sched_{what}"] = str(e)
    if dist.get_rank() != 0:
        # serve rank 0's ticks until its close() stops them
        assert sched.join(timeout=90.0), "rank 0's stop never came"
    stats = sched.stats()
    svc.close()
    out["sched_closed"] = True
    out["sched_mesh"] = stats["mesh"]
    out["sched_ticks"] = sched.mesh_ticks.count
    out["sched_lifecycle"] = dict(svc.runtime.counters)
    out["sched_digest"] = bank_digest(svc)


# the bounded queue of the direct meshed path: (enqueue or flush) in order
BLOCK_OPS = 5
BLOCK_PENDING = 2


def block_questions():
    return [(f"u{i}/c0", "Which city does the user live in?")
            for i in range(BLOCK_OPS)]


def run_block(svc) -> dict:
    """BLOCK_OPS enqueues on a service whose policy bounds the queue at
    BLOCK_PENDING in "block" mode, then a flush; the answers to
    `block_questions` as JSON text."""
    import json
    from repro_torch.core.api import payload_to_json
    for i in range(BLOCK_OPS):
        svc.enqueue(f"u{i}/c0", "s0", _msg(f"I live in {CITIES[i]}.", i))
    out = {"pending": svc.store.pending_count,
           "flushes": svc.runtime.counters["flushes"]}
    svc.flush()
    out["answers"] = [json.dumps(payload_to_json(c), sort_keys=True)
                      for c in svc.retrieve_batch(block_questions())]
    return out


def run_faults(mesh, out):
    """The meshed service off the happy path, on every rank: a client op
    on a service whose policy wants a daemon, with no scheduler, raises; a
    bounded queue in "block" mode is flushed by the enqueue itself; an
    evict that fails on rank 1 alone marks the scheduler broken on every
    rank (rank 0's request answered with that error, its next submit
    refused, /v1/readyz 503), and rank 0's close() still ends every
    rank."""
    import json
    import urllib.error
    import urllib.request
    from repro_torch.core import MemoryService
    from repro_torch.core.api import EvictRequest, RecordRequest
    from repro_torch.core.embedder import HashEmbedder
    from repro_torch.core.lifecycle import LifecyclePolicy
    from repro_torch.serving.frontend import MemoryFrontend

    def service(policy):
        return MemoryService(HashEmbedder(device="cpu"), device="cpu",
                             budget=800, shards=8, mesh=mesh, policy=policy)

    svc = service(sched_policy())
    try:
        svc.record("u0/c0", "s0", _msg("I live in Oslo.", 0))
        out["fault_unmaintained"] = "accepted"
    except RuntimeError as e:
        out["fault_unmaintained"] = str(e)
    svc.close()
    svc = service(LifecyclePolicy(max_pending=BLOCK_PENDING,
                                  enqueue_timeout_s=5.0))
    block = run_block(svc)
    block["digest"] = bank_digest(svc)
    out["fault_block"] = block
    svc.close()

    svc = service(None)
    sched = svc.start_scheduler(tick_interval_s=0.002)
    if dist.get_rank() == 1:
        def evict(namespace):
            raise RuntimeError("rank 1's evict fails")
        svc.evict = evict
    if dist.get_rank() == 0:
        ok = sched.submit(RecordRequest("u0/c0", "s0", _msg(
            "I live in Oslo.", 0))).result(timeout=60)
        bad = sched.submit(EvictRequest("u0/c0")).result(timeout=60)
        out["fault_tick"] = [ok.status, bad.status,
                             type(bad.exception).__name__]
        try:
            sched.submit(RecordRequest("u1/c0", "s0", _msg("x", 1)))
            out["fault_submit"] = "accepted"
        except RuntimeError as e:
            out["fault_submit"] = type(e).__name__
        fe = MemoryFrontend(svc, {HTTP_KEY: HTTP_TENANT}).start()
        try:
            urllib.request.urlopen(fe.address + "/v1/readyz", timeout=30)
            out["fault_readyz"] = 200
        except urllib.error.HTTPError as e:
            out["fault_readyz"] = [e.code, json.loads(e.read())]
        fe.close()
    else:
        assert sched.join(timeout=90.0), "rank 0's stop never came"
    out["fault_broken"] = sched.stats()["mesh"]["broken"]
    svc.close()
    out["fault_closed"] = True


PARTS = {"serve": ("topk", "service", "serve"), "train": ("train",),
         "context": ("context",), "scheduler": ("scheduler", "faults")}


def results(root, part: str, timeout: float = 120.0) -> dict:
    """Spawn the 4 ranks on `part` under `root` (a fresh directory) and
    return rank 0's results (with rank 1's under "rank1" when it wrote
    any); raise with the ranks' tracebacks when a rank failed."""
    import pathlib
    import subprocess
    root = pathlib.Path(root)
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here.parent / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(here / "torch_mesh_worker.py"),
                           str(root), part], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=str(root))
    errors = sorted(root.glob("error-*.txt"))
    if proc.returncode != 0 or errors:
        raise AssertionError((errors[0].read_text() if errors else "")
                             + proc.stderr[-3000:])
    out = torch.load(root / "results.pt", weights_only=False)
    for rank in range(1, WORLD):
        if (root / f"results-{rank}.pt").exists():
            out[f"rank{rank}"] = torch.load(root / f"results-{rank}.pt",
                                            weights_only=False)
    out["root"] = root
    return out


def worker(rank, root, store, part):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    out = {}
    try:
        from repro_torch.launch.mesh import make_host_mesh
        meshes = {shape: make_host_mesh(*shape, device_type="cpu")
                  for shape in ((2, 2), (1, 4), (4, 1))}
        mesh = meshes[(2, 2)]
        steps = {"topk": lambda: run_topk(mesh, out),
                 "service": lambda: run_service(mesh, out, root),
                 "train": lambda: run_train(meshes, out),
                 "serve": lambda: run_serve(meshes, out),
                 "context": lambda: run_context(meshes, out),
                 "scheduler": lambda: run_scheduler(mesh, out, root),
                 "faults": lambda: run_faults(mesh, out)}
        for step in PARTS[part]:
            steps[step]()
        if rank == 0:
            torch.save(out, os.path.join(root, "results.pt"))
        elif rank == 1 and "svc_rotate" in out:   # what another rank saw
            torch.save({k: out[k] for k in ("svc_rotate", "svc_recovered")},
                       os.path.join(root, "results-1.pt"))
        elif part == "scheduler":
            torch.save(out, os.path.join(root, f"results-{rank}.pt"))
    except Exception:
        with open(os.path.join(root, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import logging
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    root, part = sys.argv[1], sys.argv[2]
    mp.spawn(worker, args=(root, os.path.join(root, "store"), part),
             nprocs=WORLD)
