"""AdamW + cosine schedule + global-norm clipping over a parameter tree,
functional, as the reference's `repro/training/optimizer.py`.

`update(cfg, params, grads, state)` returns new parameters and state and
leaves its inputs as they are.  Each leaf follows the reference's f32
expression order: m32, v32, mhat, vhat, delta, decay, newp, the new
parameter cast back to the leaf's dtype and the moments to `state_dtype`
(f32, or bf16 for the largest configs).  The element-wise steps are
`torch._foreach_*` ops over runs of leaves of at most `GROUP_ELEMENTS`
elements, so the f32 temporaries of a 1.9 B-parameter bf16 model never
exist for all leaves at once.  Parameters are kept as leaves of nested dicts,
lists and tuples; `_decay_mask` is the reference's, by the leaf's own
name.
On a mesh the leaves, gradients and moments are DTensors of the same
placements: the foreach steps run on them as they are, and the clipping
norm is a full reduction over the mesh (`global_norm`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.common.module import leaves_with_names, tree_map, unflatten

PyTree = Any

# elements updated by one run of foreach ops: its f32 temporaries (about
# six copies) stay within ~1.5 GB whatever the model's size
GROUP_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: PyTree
    nu: PyTree


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Learning rate at `step` (a tensor or an int), in f32: linear warmup
    to peak_lr, then a cosine down to min_lr at total_steps."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = _f32(cfg.peak_lr) * step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0,
                                        cfg.total_steps - cfg.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * _f32(cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(_f32(math.pi) * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _zeros(p, dt):
    """Zero moments of leaf p: a DTensor's with its placements."""
    if isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=dt)
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def init(cfg: OptimizerConfig, params: PyTree) -> OptState:
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: _zeros(p, dt)
    device = leaves_with_names(params)[0][1].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _sum_squares(x) -> torch.Tensor:
    s = torch.sum(torch.square(x.float()))
    # a DTensor leaf's sum is reduced over the whole mesh: a plain 0-d
    # tensor, the same on every rank
    return s.full_tensor() if isinstance(s, DTensor) else s


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (a
    full reduction on DTensor leaves)."""
    sq = [_sum_squares(x) for _, x in leaves_with_names(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def _decay_mask(path) -> bool:
    """Weight decay applies to matrices, not norms/biases/scalars.  The
    reference's rule, copied as it is: it looks for substrings of the
    leaf's name, so "D" and "b" exclude every name holding a `b` or a `D`
    too (`embed/table` gets no decay)."""
    name = str(path[-1])
    return not any(s in name for s in ("scale", "bias", "norm", "lam",
                                       "A_log", "dt_bias", "D", "b"))


def _groups(sizes, limit: int):
    """Consecutive runs of leaf indices whose sizes sum to at most `limit`
    (a larger leaf alone)."""
    group, total = [], 0
    for i, n in enumerate(sizes):
        if group and total + n > limit:
            yield group
            group, total = [], 0
        group.append(i)
        total += n
    if group:
        yield group


def update(cfg: OptimizerConfig, params: PyTree, grads: PyTree,
           state: OptState):
    """Returns (new_params, new_state, metrics {grad_norm, lr})."""
    named = leaves_with_names(params)
    p = [x for _, x in named]
    g = [x for _, x in leaves_with_names(grads)]
    m = [x for _, x in leaves_with_names(state.mu)]
    v = [x for _, x in leaves_with_names(state.nu)]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1).to(stepf.device), stepf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2).to(stepf.device), stepf)
    sdt = getattr(torch, cfg.state_dtype)
    decay = [_decay_mask(path) for path, _ in named]
    new_p, new_m, new_v = [None] * len(p), [None] * len(p), [None] * len(p)
    for idx in _groups([x.numel() for x in p], GROUP_ELEMENTS):
        g32 = torch._foreach_mul([g[i].float() for i in idx], scale)
        m32 = torch._foreach_mul([m[i].float() for i in idx], cfg.b1)
        torch._foreach_add_(m32, torch._foreach_mul(g32, 1 - cfg.b1))
        gg = torch._foreach_mul(g32, 1 - cfg.b2)
        torch._foreach_mul_(gg, g32)
        del g32
        v32 = torch._foreach_mul([v[i].float() for i in idx], cfg.b2)
        torch._foreach_add_(v32, gg)
        del gg
        delta = torch._foreach_div(m32, b1c)           # mhat
        vhat = torch._foreach_div(v32, b2c)
        torch._foreach_sqrt_(vhat)
        torch._foreach_add_(vhat, cfg.eps)
        torch._foreach_div_(delta, vhat)     # mhat / (sqrt(vhat) + eps)
        del vhat
        p32 = [p[i].float() for i in idx]
        dec = [j for j, i in enumerate(idx) if decay[i]]
        if dec:
            torch._foreach_add_([delta[j] for j in dec], torch._foreach_mul(
                [p32[j] for j in dec], cfg.weight_decay))
        torch._foreach_mul_(delta, lr)
        newp = torch._foreach_sub(p32, delta)
        del delta, p32
        for j, i in enumerate(idx):
            new_p[i] = newp[j].to(p[i].dtype)
            new_m[i] = m32[j].to(sdt)
            new_v[i] = v32[j].to(sdt)
        del newp, m32, v32
    return (unflatten(params, new_p),
            OptState(step, unflatten(params, new_m), unflatten(params, new_v)),
            {"grad_norm": gnorm, "lr": lr})
