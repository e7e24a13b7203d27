"""Dense MLP: gated (SwiGLU/GeGLU) or plain 2-layer."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.module import ParamSpec


def _act(cfg, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def specs(cfg, d_ff: int | None = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    s = {
        "wi": ParamSpec((d, ff), ("embed", "ff"), init="scaled_normal", scale=1.0),
        "wo": ParamSpec((ff, d), ("ff", "embed"), init="scaled_normal", scale=1.0),
    }
    if cfg.mlp_gated:
        s["wg"] = ParamSpec((d, ff), ("embed", "ff"), init="scaled_normal", scale=1.0)
    return s


def apply(params, cfg, x):
    h = torch.matmul(x, params["wi"].to(x.dtype))
    if cfg.mlp_gated:
        g = torch.matmul(x, params["wg"].to(x.dtype))
        h = _act(cfg, g) * h
    else:
        h = _act(cfg, h)
    return torch.matmul(h, params["wo"].to(x.dtype))
