"""Residual blocks: (mixer, ffn) pairs from ModelConfig.layer_kinds().

This slice of the port carries the dense blocks — ("attn", "mlp") and
("attn", "none") — with pre-norm residual wiring and the stablelm-style
`parallel_residual` option, as the reference's `repro/models/blocks.py`.
Other mixers (ssm, rglru, MLA attention) and the MoE FFN raise
NotImplementedError naming the slice that brings them.
"""
from __future__ import annotations

from repro_torch.models.layers import attention, mlp, norms

SLICE_MIXERS = "the recurrent-mixer (ssm / rglru) slice of the port"
SLICE_MLA = "the MLA slice of the port"
SLICE_MOE = "the mixture-of-experts slice of the port"


def check_kind(cfg, kind) -> None:
    """Raise NotImplementedError for a block this slice does not carry."""
    mixer_kind, ffn_kind = kind
    if mixer_kind in ("ssm", "rglru"):
        raise NotImplementedError(f"{mixer_kind} mixer: {SLICE_MIXERS}")
    if mixer_kind != "attn":
        raise ValueError(mixer_kind)
    if cfg.use_mla:
        raise NotImplementedError(f"MLA attention: {SLICE_MLA}")
    if ffn_kind == "moe":
        raise NotImplementedError(f"MoE FFN: {SLICE_MOE}")
    if ffn_kind not in ("mlp", "none"):
        raise ValueError(ffn_kind)


def block_specs(cfg, kind):
    check_kind(cfg, kind)
    s = {"norm1": norms.specs(cfg), "attn": attention.specs(cfg)}
    if kind[1] == "mlp":
        s["norm2"] = norms.specs(cfg)
        s["mlp"] = mlp.specs(cfg)
    return s


def block_cache_specs(cfg, kind, batch, max_len, dtype, *, window: int = 0):
    """{name: (shape, logical_axes, dtype)} for this block's caches."""
    check_kind(cfg, kind)
    return attention.cache_specs(cfg, batch, max_len, dtype, window=window)


def apply(params, cfg, x, kind, *, mode, positions, cache=None,
          cache_pos=None, mask_kind="causal", window=0, return_cache=False):
    """One residual block.  Returns (x, new_cache)."""
    h = norms.apply(params["norm1"], cfg, x)
    mixed, new_cache = attention.apply(
        params["attn"], cfg, h, positions=positions, mode=mode, cache=cache,
        cache_pos=cache_pos, mask_kind=mask_kind, window=window,
        return_cache=return_cache)
    if cfg.parallel_residual and kind[1] == "mlp":
        # stablelm-style: x + attn(n(x)) + mlp(n(x)) with a single norm
        ff = mlp.apply(params["mlp"], cfg, norms.apply(params["norm2"], cfg, x))
        x = x + mixed + ff
    else:
        x = x + mixed
        if kind[1] == "mlp":
            x = x + mlp.apply(params["mlp"], cfg,
                              norms.apply(params["norm2"], cfg, x))
    return x, new_cache
