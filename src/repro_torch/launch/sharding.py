"""The steps, as the reference's `repro/launch/sharding.py`: the train,
prefill and decode steps of any (arch, input shape), on one device or on a
`DeviceMesh` with every parameter, optimizer moment, batch and cache placed
by the logical-axis rules.

The reference jit-compiles each step with full sharding specifications;
here a step is eager.  On one device (`mesh=None`) it is the
one-device `training.train_loop` step, unchanged.  On a mesh every rank
runs the same program (one process per device): parameters and moments are
DTensors placed by `standard_rules` (FSDP above `FSDP_PARAM_THRESHOLD`
parameters), the batch is sharded on the `batch` axes, and the model runs
as DTensor ops with its kernels (K5, K6) on each rank's shard under
`local_map` (`models/layers/attention.py`).  Plain tensors that meet
DTensors inside a step (positions, masks, the learning rate) are the same
on every rank and are taken as replicated (`implicit_replication`).  The
dry-run (`launch/dryrun.py`) builds the same steps under a fake process
group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.common import partitioning as pt
from repro_torch.common.utils import resolve_device
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.model_api import Model, cfg_vision_dim
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainConfig, make_train_step

# above this many parameters, f32 optimizer state at pure model-parallel
# sharding cannot fit 256 GPUs: shard the parameters over data too
FSDP_PARAM_THRESHOLD = 5e9
# above this many parameters even f32 moments are untenable: bf16 state
BF16_OPT_THRESHOLD = 100e9


@dataclasses.dataclass
class StepBundle:
    """What a launcher (or the dry-run) needs for one (arch, shape[, mesh]):
    the step, its optimizer config (train), its inputs' {name: (shape,
    dtype)}, the device they go on, the model (`shard_params` lays
    one-device parameters out for the step), and on a mesh the mesh, the
    rules and `meta` (kind, FSDP, moment dtype; the decode window)."""
    fn: Any
    opt: Optional[opt.OptimizerConfig]
    inputs: Dict[str, tuple]
    device: torch.device
    mesh: Any = None
    rules: Optional[pt.MeshRules] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    model: Optional[Model] = None


def opt_config_for(cfg: ModelConfig) -> opt.OptimizerConfig:
    n = cfg.param_count()
    return opt.OptimizerConfig(
        state_dtype="bfloat16" if n > BF16_OPT_THRESHOLD else "float32")


def use_fsdp(cfg: ModelConfig) -> bool:
    return cfg.param_count() > FSDP_PARAM_THRESHOLD


def train_inputs(cfg: ModelConfig, shape: InputShape) -> Dict[str, tuple]:
    """{name: (shape, dtype)} of a train or prefill batch: tokens (B, S -
    image prefix), stub image patches, stub audio frames."""
    B = shape.global_batch
    out = {"tokens": ((B, shape.seq_len - (cfg.num_image_tokens or 0)),
                      torch.int32)}
    if cfg.num_image_tokens:
        out["images"] = ((B, cfg.num_image_tokens, cfg_vision_dim(cfg)),
                         torch.float32)
    if cfg.is_encoder_decoder:
        out["audio"] = ((B, cfg.encoder_seq_len, cfg.d_model),
                        torch.float32)
    return out


def decode_inputs(shape: InputShape) -> Dict[str, tuple]:
    B = shape.global_batch
    return {"tokens": ((B, 1), torch.int32), "pos": ((B,), torch.int32)}


def place_batch(batch: Dict, mesh) -> Dict:
    """A global batch (the same on every rank) sharded on the mesh's batch
    axes over its leading dim, where they divide it."""
    return {k: pt.shard_local(v, mesh, pt.batch_axes_placements(
                mesh, v.shape[0], 0)) if not pt.is_dtensor(v) else v
            for k, v in batch.items()}


def place_caches(caches, placements, mesh):
    """Caches laid out as `placements` (one {name: placements} per layer):
    a DTensor redistributed, a plain (global) tensor sliced."""
    def one(x, p):
        return (pt.with_placements(x, p) if pt.is_dtensor(x)
                else pt.shard_local(x, mesh, p))
    return [None if c is None else {k: one(v, placements[i][k])
                                    for k, v in c.items()}
            for i, c in enumerate(caches)]


def _meshed(fn):
    """`fn` with plain tensors taken as replicated where they meet
    DTensors (they are the same on every rank)."""
    def run(*args, **kw):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return fn(*args, **kw)
    return run


def _device(mesh, device):
    if mesh is None:
        return resolve_device(device)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def build_train_step(cfg: ModelConfig, shape: InputShape, mesh=None, *,
                     fsdp: Optional[bool] = None,
                     device="cuda") -> StepBundle:
    """The train step of `cfg` at `shape`: fn(params, opt_state, batch) ->
    (params, opt_state, metrics).  On a mesh, params and moments are
    DTensors (`bundle.model.shard_params`, `opt.init` of those) and the
    batch may be given whole: it is sharded on the batch axes first."""
    if shape.kind != "train":
        raise ValueError(f"{shape.name} is a {shape.kind} shape: see "
                         "build_prefill_step / build_decode_step")
    model = Model(cfg)
    ocfg = opt_config_for(cfg)
    step = make_train_step(model, TrainConfig(opt=ocfg))
    if mesh is None:
        return StepBundle(fn=step, opt=ocfg, inputs=train_inputs(cfg, shape),
                          device=resolve_device(device), model=model)
    fsdp = use_fsdp(cfg) if fsdp is None else fsdp
    rules = pt.standard_rules(mesh, fsdp=fsdp)
    inner = _meshed(step)

    def train_step(params, opt_state, batch):
        return inner(params, opt_state, place_batch(batch, mesh))

    return StepBundle(fn=train_step, opt=ocfg,
                      inputs=train_inputs(cfg, shape),
                      device=_device(mesh, device), mesh=mesh, rules=rules,
                      model=model,
                      meta={"kind": "train", "fsdp": fsdp,
                            "opt_dtype": ocfg.state_dtype})


def build_prefill_step(cfg: ModelConfig, shape: InputShape, mesh=None, *,
                       device="cuda") -> StepBundle:
    """fn(params, batch) -> (logits of the last position, caches), the
    caches placed by the rules' cache specs on a mesh."""
    model = Model(cfg)
    if mesh is None:
        fn = torch.no_grad()(lambda params, batch: model.prefill(params,
                                                                 batch))
        return StepBundle(fn=fn, opt=None, inputs=train_inputs(cfg, shape),
                          device=resolve_device(device), model=model,
                          meta={"kind": "prefill"})
    rules = pt.standard_rules(mesh)
    S = shape.seq_len

    @torch.no_grad()
    @_meshed
    def prefill_step(params, batch):
        logits, caches = model.prefill(params, place_batch(batch, mesh))
        B = logits.shape[0]
        return logits, place_caches(caches, model.cache_shardings(
            B, S, rules), mesh)

    return StepBundle(fn=prefill_step, opt=None,
                      inputs=train_inputs(cfg, shape),
                      device=_device(mesh, device), mesh=mesh, rules=rules,
                      model=model, meta={"kind": "prefill"})


def decode_rules(cfg: ModelConfig, shape: InputShape, mesh, *,
                 kv_replicated: bool = False,
                 context_parallel: Optional[bool] = None) -> pt.MeshRules:
    """batch=1 long-context decode is context-parallel over the cache
    sequence (`long_context_rules`: long_500k at a batch smaller than
    `data`, or wherever `context_parallel` says so); `kv_replicated`
    disables the head_dim fallback, so indivisible kv heads replicate over
    `model`.  Context-parallel decode disables it too: each rank's K5 reads
    whole heads of its own cache rows, where the reference's XLA contracts
    a head_dim-sharded cache to partial scores (the port would gather the
    cache over `model` every layer instead)."""
    axes = pt.mesh_axes(mesh)
    if context_parallel is None:
        context_parallel = (shape.name == "long_500k"
                            and shape.global_batch < axes.shape["data"])
    rules = (pt.long_context_rules(mesh) if context_parallel
             else pt.standard_rules(mesh))
    if kv_replicated or context_parallel:
        rules = dataclasses.replace(rules, head_dim_fallback=False)
    return rules


def build_decode_step(cfg: ModelConfig, shape: InputShape, mesh=None, *,
                      kv_replicated: bool = False,
                      context_parallel: Optional[bool] = None,
                      device="cuda") -> StepBundle:
    """serve_step: ONE new token against a cache of shape.seq_len.
    fn(params, tokens (B, 1), caches, pos (B,)) -> (logits, caches); on a
    mesh the caches are placed by the rules' cache specs (a whole cache is
    sliced, a DTensor redistributed) and updated in place; with the
    context-parallel rules (`decode_rules`) each attention layer runs K5
    on its rank's rows and combines the ranks' partial outputs by their
    log-sum-exps (`attention._context_parallel_decode`)."""
    model = Model(cfg)
    B, S = shape.global_batch, shape.seq_len
    long_ctx = shape.name == "long_500k"
    window = (cfg.long_context_window or None) if long_ctx else None
    meta = {"kind": "decode", "long_ctx": long_ctx,
            "window_override": window}
    if mesh is None:
        fn = torch.no_grad()(lambda params, tokens, caches, pos:
                             model.decode_step(params, tokens, caches, pos,
                                               window_override=window))
        return StepBundle(fn=fn, opt=None, inputs=decode_inputs(shape),
                          device=resolve_device(device), model=model,
                          meta=meta)
    rules = decode_rules(cfg, shape, mesh, kv_replicated=kv_replicated,
                         context_parallel=context_parallel)
    cache_pl = model.cache_shardings(B, S, rules, window_override=window)

    @torch.no_grad()
    @_meshed
    def decode_step(params, tokens, caches, pos):
        caches = place_caches(caches, cache_pl, mesh)
        tokens = place_batch({"t": tokens}, mesh)["t"]
        return model.decode_step(params, tokens, caches, pos,
                                 window_override=window)

    return StepBundle(fn=decode_step, opt=None, inputs=decode_inputs(shape),
                      device=_device(mesh, device), mesh=mesh, rules=rules,
                      model=model, meta=meta)


def build_step(cfg: ModelConfig, shape: InputShape, mesh=None,
               variant: str = "", *, device="cuda") -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, device=device)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, device=device)
    return build_decode_step(cfg, shape, mesh, device=device,
                             kv_replicated="kv_replicated" in variant)


def supported(cfg: ModelConfig, shape: InputShape) -> tuple:
    """The reference's skip policy."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention enc-dec (whisper): no faithful "
                       "sliding-window variant; skipped as the reference")
    return True, ""
