"""RMSNorm / LayerNorm (param specs + apply), computed in f32 and cast back
to the input's dtype, as the reference's `repro/models/layers/norms.py`."""
from __future__ import annotations

import torch

from repro_torch.common.module import ParamSpec


def specs(cfg, dim: int | None = None):
    d = dim or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), init="ones"),
                "bias": ParamSpec((d,), ("embed",), init="zeros")}
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def apply(params, cfg, x):
    xf = x.float()
    if cfg.norm == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        y = (xf - mean) / torch.sqrt(var + cfg.norm_eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf / torch.sqrt(var + cfg.norm_eps)
        y = y * params["scale"].float()
    return y.to(x.dtype)


def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return ((xf / torch.sqrt(var + eps)) * scale.float()).to(x.dtype)
