"""Training loop: an eager train step with gradient accumulation and
metrics, as the reference's `repro/training/train_loop.py` (whose step is
`jax.jit`-compiled; here it runs eagerly, the model uncompiled).

The loss and its gradient come from `Model.train_loss` under autograd
(recompute per block, K6 through its autograd Function on the card).
With `grad_accum` > 1 the batch holds that many stacked micro-batches
(M, B, S): their f32 gradients are summed, then divided by M, and the
metrics averaged, before one optimizer update.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.common.module import leaves_with_names, unflatten
from repro_torch.models.model_api import Model
from repro_torch.training import optimizer as opt

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    grad_accum: int = 1
    opt: opt.OptimizerConfig = opt.OptimizerConfig()


def _loss_and_grads(model: Model, params: PyTree, batch: Dict):
    """(metrics, grads): the gradient leaves in `leaves_with_names` order,
    zeros for a leaf the loss does not reach (as `jax.grad` gives), in the
    leaves' dtype."""
    leaves = [p.detach().requires_grad_(True)
              for _, p in leaves_with_names(params)]
    loss, metrics = model.train_loss(unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return {k: v.detach() for k, v in metrics.items()}, grads


def loss_and_grads(model: Model, params: PyTree, batch: Dict):
    """(metrics, grads) of `model.train_loss` at params on one batch;
    grads a tree like params."""
    metrics, grads = _loss_and_grads(model, params, batch)
    return metrics, unflatten(params, grads)


def make_train_step(model: Model, cfg: TrainConfig):
    """step(params, opt_state, batch) -> (params, opt_state, metrics)."""
    def train_step(params, opt_state, batch):
        if cfg.grad_accum > 1:
            grads, metrics = None, {}
            for i in range(cfg.grad_accum):     # batch: stacked micro-batches
                m, g = _loss_and_grads(model, params,
                                       {k: v[i] for k, v in batch.items()})
                g = [x.float() for x in g]
                grads = g if grads is None else torch._foreach_add(grads, g)
                metrics = {k: metrics.get(k, 0.0) + v for k, v in m.items()}
            grads = unflatten(params, torch._foreach_div(
                grads, float(cfg.grad_accum)))
            metrics = {k: v / cfg.grad_accum for k, v in metrics.items()}
        else:
            metrics, grads = loss_and_grads(model, params, batch)
        params2, opt_state2, om = opt.update(cfg.opt, params, grads,
                                             opt_state)
        metrics.update(om)
        return params2, opt_state2, metrics

    return train_step


def train(model: Model, params, data_iter: Iterator[Dict], cfg: TrainConfig,
          log_fn: Optional[Callable[[int, Dict], None]] = None):
    """Single-device training; returns (params, history).  A history entry
    ({metrics as floats, step, wall}) is taken every `log_every` steps and
    at the last step: reading the metrics waits for the device."""
    opt_state = opt.init(cfg.opt, params)
    step_fn = make_train_step(model, cfg)
    history = []
    t0 = time.time()
    for step in range(cfg.steps):
        batch = next(data_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % cfg.log_every == 0 or step == cfg.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall"] = time.time() - t0
            history.append(m)
            if log_fn:
                log_fn(step, m)
    return params, history
