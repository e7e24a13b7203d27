"""The 4-rank side of tests/test_torch_distribution.py and
test_torch_distribution_train.py: spawns 4 gloo ranks on a FileStore (no TCP
port) and runs one part of the port's meshed paths on (2, 2) and (1, 4)
("data", "model") CPU meshes — "serve" (the meshed `sharded_topk`, the
meshed service, prefill and decode) or "train" (each family's loss and
gradients, the whole dense step); rank 0 writes what they returned to
OUT/results.pt (rank 1 what it saw of the durable directory to
OUT/results-1.pt) for the tests to hold against the reference and the
one-device port.  Each test module spawns its part once (`results`).

    PYTHONPATH=src python tests/torch_mesh_worker.py OUT_DIR serve|train
"""
import dataclasses
import os
import sys
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


def family_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(4, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.num_image_tokens:
        batch["images"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_image_tokens, 1152)).astype(np.float32))
    if cfg.is_encoder_decoder:
        batch["audio"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
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
    for what, fn in (("scheduler", lambda: rec.start_scheduler()),
                     ("frontend", lambda: _frontend(rec))):
        try:
            fn()
            out[f"svc_{what}"] = "started"
        except NotImplementedError as e:
            out[f"svc_{what}"] = str(e)
    rec.close()


def _frontend(svc):
    from repro_torch.serving.frontend import MemoryFrontend
    return MemoryFrontend(svc, {"k": "acme"})


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


PARTS = {"serve": ("topk", "service", "serve"), "train": ("train",)}


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
    if (root / "results-1.pt").exists():
        out["rank1"] = torch.load(root / "results-1.pt", weights_only=False)
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
                  for shape in ((2, 2), (1, 4))}
        mesh = meshes[(2, 2)]
        steps = {"topk": lambda: run_topk(mesh, out),
                 "service": lambda: run_service(mesh, out, root),
                 "train": lambda: run_train(meshes, out),
                 "serve": lambda: run_serve(meshes, out)}
        for step in PARTS[part]:
            steps[step]()
        if rank == 0:
            torch.save(out, os.path.join(root, "results.pt"))
        elif rank == 1 and "svc_rotate" in out:   # what another rank saw
            torch.save({k: out[k] for k in ("svc_rotate", "svc_recovered")},
                       os.path.join(root, "results-1.pt"))
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
