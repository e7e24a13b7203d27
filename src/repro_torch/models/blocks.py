"""Residual blocks: (mixer, ffn) pairs from ModelConfig.layer_kinds(), as the
reference's `repro/models/blocks.py`.

mixer ∈ {attn (MHA or MLA), ssm, rglru}, ffn ∈ {mlp, moe, none}; pre-norm
residual wiring, the stablelm-style `parallel_residual` option, and
cross-attention (the whisper decoder: `norm_cross`, `cross_attn` and the
layer's `cross_k`/`cross_v` caches).  A block returns (x, cache, aux): aux
holds the MoE FFN's three auxiliary values, and is None for a block
without one (the stack sums them into `zero_aux()`, with no device work
for the other blocks).  In decode mode a
layer's cache dict is updated in place (every mixer writes its entries
into the tensors it was given) and returned.
"""
from __future__ import annotations

import torch

from repro_torch.common import partitioning as pt
from repro_torch.models.layers import (attention, mla, mlp, moe, norms, rglru,
                                       ssm)

AUX_KEYS = ("moe_load_balance", "moe_router_z", "moe_drop_fraction")
_MIXER_KEYS = {"ssm": ("conv", "state"), "rglru": ("conv", "h")}


def zero_aux(device="cpu"):
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def block_specs(cfg, kind, *, cross: bool = False):
    mixer_kind, ffn_kind = kind
    s = {"norm1": norms.specs(cfg)}
    if mixer_kind == "attn":
        s["attn"] = mla.specs(cfg) if cfg.use_mla else attention.specs(cfg)
    elif mixer_kind == "ssm":
        s["ssm"] = ssm.specs(cfg)
    elif mixer_kind == "rglru":
        s["rglru"] = rglru.specs(cfg)
    else:
        raise ValueError(mixer_kind)
    if cross:
        s["norm_cross"] = norms.specs(cfg)
        s["cross_attn"] = attention.specs(cfg, cross=True)
    if ffn_kind == "mlp":
        s["norm2"] = norms.specs(cfg)
        s["mlp"] = mlp.specs(cfg)
    elif ffn_kind == "moe":
        s["norm2"] = norms.specs(cfg)
        s["moe"] = moe.specs(cfg)
    elif ffn_kind != "none":
        raise ValueError(ffn_kind)
    return s


def block_cache_specs(cfg, kind, batch, max_len, dtype, *, cross: bool = False,
                      enc_len: int = 0, window: int = 0):
    """{name: (shape, logical_axes, dtype)} for this block's caches."""
    mixer_kind, _ = kind
    out = {}
    if mixer_kind == "attn":
        out.update(mla.cache_specs(cfg, batch, max_len, dtype) if cfg.use_mla
                   else attention.cache_specs(cfg, batch, max_len, dtype,
                                              window=window))
    elif mixer_kind == "ssm":
        out.update(ssm.cache_specs(cfg, batch, dtype))
    elif mixer_kind == "rglru":
        out.update(rglru.cache_specs(cfg, batch, dtype))
    if cross:
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        axes = ("batch", None, "kv_heads", "head_dim")
        out["cross_k"] = ((batch, enc_len, kv, hd), axes, dtype)
        out["cross_v"] = ((batch, enc_len, kv, hd), axes, dtype)
    return out


def _sub_cache(cfg, mixer_kind, cache):
    if cache is None:
        return None
    if mixer_kind == "attn":
        keys = (("ckv", "k_rope") if cfg.use_mla
                else ("k", "v", "pos", "k_scale", "v_scale"))
    else:
        keys = _MIXER_KEYS[mixer_kind]
    return {k: cache[k] for k in keys if k in cache} or None


def apply(params, cfg, x, kind, *, mode, positions, cache=None, cache_pos=None,
          mask_kind="causal", window=0, prefix_len=None, enc_out=None,
          enc_positions=None, return_cache=False, use_rope=True,
          positions_offset=None, enc_positions_offset=None):
    """One residual block.  Returns (x, cache, aux).  Train/prefill
    positions (and enc_positions) are their offset + 0..S-1 per row
    (`attention.apply`'s positions_offset; None: read from them)."""
    mixer_kind, ffn_kind = kind
    aux = None
    new_cache = {}
    h = norms.apply(params["norm1"], cfg, x)
    sub_cache = _sub_cache(cfg, mixer_kind, cache)

    if mixer_kind == "attn":
        if cfg.use_mla:
            mixed, c = mla.apply(
                params["attn"], cfg, h, positions=positions, mode=mode,
                cache=sub_cache, cache_pos=cache_pos, window=window,
                return_cache=return_cache, mask_kind=mask_kind,
                prefix_len=prefix_len, positions_offset=positions_offset)
        else:
            mixed, c = attention.apply(
                params["attn"], cfg, h, positions=positions, mode=mode,
                cache=sub_cache, cache_pos=cache_pos, mask_kind=mask_kind,
                window=window, prefix_len=prefix_len, use_rope=use_rope,
                return_cache=return_cache, positions_offset=positions_offset)
    elif mixer_kind == "ssm":
        mixed, c = ssm.apply(params["ssm"], cfg, h, mode=mode,
                             cache=sub_cache, return_cache=return_cache)
    else:
        mixed, c = rglru.apply(params["rglru"], cfg, h, mode=mode,
                               cache=sub_cache, return_cache=return_cache)
    if c:
        new_cache.update(c)
    # a meshed step reduces each sub-layer's output over `model` here (its
    # partial sums over heads, ff or state), so the next sub-layer's
    # products shard their weights, as tensor parallelism runs them
    mixed = pt.batch_only(mixed)

    if cfg.parallel_residual and ffn_kind == "mlp":
        # stablelm-style: x + attn(n(x)) + mlp(n(x)) with a single norm
        ff = mlp.apply(params["mlp"], cfg, norms.apply(params["norm2"], cfg, x))
        x = x + mixed + pt.batch_only(ff)
    else:
        x = x + mixed
        if enc_out is not None or "cross_attn" in params:
            hc = norms.apply(params["norm_cross"], cfg, x)
            if mode == "decode":
                cross_cache = {"k": cache["cross_k"], "v": cache["cross_v"]}
                cross_out, _ = attention.apply(
                    params["cross_attn"], cfg, hc, positions=positions,
                    mode="cross_decode", cache=cross_cache, use_rope=False)
                new_cache["cross_k"] = cache["cross_k"]
                new_cache["cross_v"] = cache["cross_v"]
            else:
                cross_out, cc = attention.apply(
                    params["cross_attn"], cfg, hc, positions=positions,
                    kv_x=enc_out, kv_positions=enc_positions, mode=mode,
                    use_rope=False, return_cache=return_cache,
                    positions_offset=positions_offset,
                    kv_positions_offset=enc_positions_offset)
                if cc:
                    new_cache["cross_k"] = cc["k"]
                    new_cache["cross_v"] = cc["v"]
            x = x + pt.batch_only(cross_out)
        if ffn_kind == "mlp":
            x = x + pt.batch_only(mlp.apply(
                params["mlp"], cfg, norms.apply(params["norm2"], cfg, x)))
        elif ffn_kind == "moe":
            y, aux = moe.apply(params["moe"], cfg,
                               norms.apply(params["norm2"], cfg, x))
            x = x + pt.batch_only(y)

    if mode == "decode" and cache is not None:
        return x, cache, aux         # every entry was written in place
    return x, (new_cache or None), aux
