"""Token embedding + (optionally tied) output head."""
from __future__ import annotations

import torch

from repro_torch.common.module import ParamSpec


def specs(cfg):
    s = {"table": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                            init="normal", scale=0.02)}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                                 init="scaled_normal", scale=1.0)
    return s


def embed(params, cfg, tokens):
    # clip (not NaN-fill) on out-of-range ids, as the reference's
    # `jnp.take(mode="clip")`: tokenizer/vocab mismatches should degrade,
    # not poison the whole forward.
    table = params["table"]
    ids = tokens.long().clamp(0, table.shape[0] - 1)
    return table[ids].to(cfg.cdtype)


def logits(params, cfg, x):
    if cfg.tie_embeddings:
        out = torch.matmul(x, params["table"].to(cfg.cdtype).T)
    else:
        out = torch.matmul(x, params["unembed"].to(cfg.cdtype))
    return out.to(getattr(torch, cfg.logits_dtype))
