"""The port's dry-run (`repro_torch.launch.dryrun.run_one`) as the
reference's smoke runs its own: one reduced arch per family (dense, SSM,
MoE) at train_4k and decode_32k cut to batch 8 x 64 positions, on a fake
(4, 2) ("data", "model") mesh — an in-process fake process group, so it
runs in a subprocess of its own (90 s limit).  Each record's per-rank
FLOPs must fall between 1x and 4x the model's FLOPs per rank (the lower
bound counting only the parameters that multiply: an untied input
embedding is a lookup, no product), and its argument bytes must equal the
local shard sizes that the reference's own rules (`repro.common.
partitioning` on its test's FakeMesh) give the reference's parameter,
optimizer, batch and cache shapes.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("internlm2-1.8b", "mamba2-2.7b", "phi3.5-moe-42b-a6.6b")
SHAPES = (("train_4k", 8, 64), ("decode_32k", 8, 64))
MESH = {"data": 4, "model": 2}
RANKS = 8


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "records.json"
    code = textwrap.dedent(f"""
        import dataclasses, json, logging
        logging.getLogger("torch.distributed").setLevel(logging.ERROR)
        from repro_torch.common import partitioning as pt
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun
        from repro_torch.models.config import INPUT_SHAPES
        mesh = pt.MeshShape({MESH!r}, tuple({MESH!r}))
        recs = {{}}
        for arch in {ARCHS!r}:
            for name, b, s in {SHAPES!r}:
                shape = dataclasses.replace(INPUT_SHAPES[name],
                                            global_batch=b, seq_len=s)
                recs[arch + "/" + name] = dryrun.run_one(
                    arch, name, False, probes=False,
                    cfg=get_config(arch).reduced(), mesh_shape=mesh,
                    shape=shape)
        json.dump(recs, open({str(out)!r}, "w"))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=90, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


class FakeMesh:
    shape = MESH
    axis_names = tuple(MESH)


def _local_bytes(spec, shape, nbytes):
    n = math.prod(shape)
    for phys in tuple(spec):
        for a in (phys if isinstance(phys, tuple) else (phys,)):
            if a is not None:
                n //= MESH[a]
    return n * nbytes


def reference_argument_bytes(arch, kind, B, S):
    """The argument bytes of one rank by the reference's rules and
    shapes."""
    import jax
    import numpy as np
    from repro.common import partitioning as jpt
    from repro.common.module import is_spec
    from repro.configs import get_config
    from repro.models.model_api import Model
    cfg = get_config(arch).reduced()
    rules = jpt.standard_rules(FakeMesh())
    model = Model(cfg)
    leaves = [s for s in jax.tree.leaves(model.param_specs(),
                                         is_leaf=is_spec) if is_spec(s)]
    params = sum(_local_bytes(rules.spec_for(s.axes, s.shape), s.shape,
                              np.dtype(s.dtype or cfg.param_dtype).itemsize)
                 for s in leaves)
    data = MESH["data"]
    if kind == "train":        # params, f32 moments, the step, the tokens
        return 3 * params + 4 + B * S * 4 // data
    caches = jax.tree.leaves(
        transformer_cache_specs(cfg, B, S),
        is_leaf=lambda x: isinstance(x, tuple) and len(x) == 3
        and isinstance(x[0], tuple))
    cache = sum(_local_bytes(rules.spec_for(axes, shape), shape,
                             np.dtype(dt).itemsize)
                for shape, axes, dt in caches)
    return params + cache + 2 * (B * 4 // data)      # tokens, positions


def transformer_cache_specs(cfg, B, S):
    from repro.models import transformer
    return transformer.decoder_cache_shape_specs(
        cfg, B, S, cfg.cdtype, cross=cfg.is_encoder_decoder,
        enc_len=cfg.encoder_seq_len)


def multiplying_params(cfg):
    """Parameters that multiply a token: all but an untied input table."""
    n = cfg.param_count(active_only=True)
    return n if cfg.tie_embeddings else n - cfg.vocab_size * cfg.d_model


@pytest.mark.parametrize("shape", [s[0] for s in SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_flops_per_rank_within_bounds(records, arch, shape):
    from repro_torch.configs import get_config
    rec = records[f"{arch}/{shape}"]
    assert rec["status"] == "ok" and rec["chips"] == RANKS
    cfg = get_config(arch).reduced()
    _, B, S = next(s for s in SHAPES if s[0] == shape)
    tokens = B * S if shape.startswith("train") else B
    per_token = 6.0 if shape.startswith("train") else 2.0
    lower = per_token * multiplying_params(cfg) * tokens / RANKS
    assert rec["model_flops"] == per_token * cfg.param_count(
        active_only=True) * tokens
    assert lower <= rec["flops"] <= 4 * rec["model_flops"] / RANKS, rec
    assert rec["collective_bytes"]["total"] > 0
    assert set(rec["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                    "dominant", "bound_s"}


@pytest.mark.parametrize("shape", [s[0] for s in SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_argument_bytes_are_the_rules_local_shards(records, arch,
                                                          shape):
    _, B, S = next(s for s in SHAPES if s[0] == shape)
    kind = "train" if shape.startswith("train") else "decode"
    assert records[f"{arch}/{shape}"]["memory"]["argument_bytes"] == \
        reference_argument_bytes(arch, kind, B, S)


@pytest.mark.parametrize("shape", [s[0] for s in SHAPES])
def test_dryrun_moe_dispatch_bytes_are_a_ranks_block(records, shape):
    """A rank's dispatch buffers: its (E / model, C / data) block of the
    (E, C, d) buffer plus the (T, d) tokens gathered over `data` (global
    dispatch), never the whole buffer."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers.moe import _capacity
    arch = "phi3.5-moe-42b-a6.6b"
    cfg = get_config(arch).reduced()
    _, B, S = next(s for s in SHAPES if s[0] == shape)
    T = B * S if shape.startswith("train") else B
    E, d = cfg.moe.num_experts, cfg.d_model
    C = _capacity(cfg, T)
    item = 2 if cfg.compute_dtype == "bfloat16" else 4
    got = records[f"{arch}/{shape}"]["memory"]["moe_dispatch_bytes"]
    assert got == (E // MESH["model"] * (C // MESH["data"]) + T) * d * item
    assert got < E * C * d * item
    assert records[f"internlm2-1.8b/{shape}"]["memory"][
        "moe_dispatch_bytes"] is None


@pytest.mark.parametrize("shape", [s[0] for s in SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_records_memtrackers_peak(records, arch, shape):
    """temp_bytes (MemTracker's peak of what the step allocates) is
    positive, and a train step, which returns new parameters and moments,
    allocates at least the parameters' local bytes."""
    mem = records[f"{arch}/{shape}"]["memory"]
    assert mem["temp_bytes"] > 0
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    if shape.startswith("train"):
        _, B, S = next(s for s in SHAPES if s[0] == shape)
        params = (mem["argument_bytes"] - 4 - B * S * 4 // MESH["data"]) // 3
        assert mem["temp_bytes"] >= params
