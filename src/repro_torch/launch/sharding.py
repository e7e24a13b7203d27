"""Step functions, as the reference's `repro/launch/sharding.py`, on one
device: the train step of any (arch, input shape), its optimizer config
and its inputs' shapes.

The reference jit-compiles the step with full sharding specifications for
a mesh; here the step is the eager `training.train_loop` step on one card
(or the CPU when asked).  A mesh (`mesh=`), and the prefill/decode
steps with the mesh rules, come with the distribution slice (M7b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.common.utils import SLICE_M7B, resolve_device
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.model_api import Model, cfg_vision_dim
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainConfig, make_train_step

# above this many parameters even f32 moments are untenable: bf16 state
BF16_OPT_THRESHOLD = 100e9


@dataclasses.dataclass
class StepBundle:
    """What a launcher needs for one (arch, shape): the step, its
    optimizer config, its inputs' {name: (shape, dtype)} and the device
    they go on."""
    fn: Any
    opt: opt.OptimizerConfig
    inputs: Dict[str, tuple]
    device: torch.device


def opt_config_for(cfg: ModelConfig) -> opt.OptimizerConfig:
    n = cfg.param_count()
    return opt.OptimizerConfig(
        state_dtype="bfloat16" if n > BF16_OPT_THRESHOLD else "float32")


def train_inputs(cfg: ModelConfig, shape: InputShape) -> Dict[str, tuple]:
    """{name: (shape, dtype)} of a train batch: tokens (B, S - image
    prefix), stub image patches, stub audio frames."""
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


def build_train_step(cfg: ModelConfig, shape: InputShape, mesh=None, *,
                     device="cuda") -> StepBundle:
    """The train step of `cfg` at `shape` on one device: fn(params,
    opt_state, batch) -> (params, opt_state, metrics)."""
    if mesh is not None:
        raise NotImplementedError(f"mesh= comes with {SLICE_M7B}")
    if shape.kind != "train":
        raise ValueError(f"{shape.name} is a {shape.kind} shape; the "
                         f"prefill/decode steps come with {SLICE_M7B}")
    ocfg = opt_config_for(cfg)
    fn = make_train_step(Model(cfg), TrainConfig(opt=ocfg))
    return StepBundle(fn=fn, opt=ocfg, inputs=train_inputs(cfg, shape),
                      device=resolve_device(device))
