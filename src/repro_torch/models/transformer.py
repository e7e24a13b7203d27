"""Decoder stack: the reference's `repro/models/transformer.py` for the
dense blocks of this slice.

The reference groups layers into scanned segments (`plan_segments`, one
`lax.scan` over stacked parameters per segment); here the stack is a Python
loop over a list of per-layer parameter dicts, `params["layers"][i]`.
Caches follow the same list: `caches[i]` is layer i's {"k", "v"}, each a
(B, T, K, D) tensor — the reference's cache layout sliced at that layer.
"""
from __future__ import annotations

import torch

from repro_torch.common.utils import resolve_device
from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import norms


def decoder_specs(cfg: ModelConfig):
    return {"layers": [blocks.block_specs(cfg, kind)
                       for kind in cfg.layer_kinds()],
            "final_norm": norms.specs(cfg)}


def decoder_cache_shape_specs(cfg: ModelConfig, batch: int, max_len: int,
                              dtype):
    """One {name: (shape, axes, dtype)} per layer."""
    return [blocks.block_cache_specs(cfg, kind, batch, max_len, dtype,
                                     window=cfg.sliding_window)
            for kind in cfg.layer_kinds()]


def init_caches(cfg, batch, max_len, dtype, *, device="cuda"):
    device = resolve_device(device)
    return [{name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, _axes, dt) in layer.items()}
            for layer in decoder_cache_shape_specs(cfg, batch, max_len,
                                                   dtype)]


def prepare_decode_caches(cfg, caches, prefill_len: int, max_len: int):
    """Convert prefill caches (seq length = prefill_len) into decode caches:
    each (B, S, K, D) k/v zero-padded to (B, max_len, K, D).  Windowed
    attention's ring-buffer layout raises NotImplementedError."""
    out = []
    for kind, bc in zip(cfg.layer_kinds(), caches):
        # raises for the ring-buffer and int8 layouts
        blocks.block_cache_specs(cfg, kind, 1, max_len, None,
                                 window=cfg.sliding_window)
        padded = {}
        for name, x in bc.items():
            B, S, K, D = x.shape
            if S != prefill_len or S > max_len:
                raise ValueError(f"cache of {S} positions for a prefill of "
                                 f"{prefill_len} into max_len {max_len}")
            full = torch.zeros((B, max_len, K, D), dtype=x.dtype,
                               device=x.device)
            full[:, :S] = x
            padded[name] = full
        out.append(padded)
    return out


def decoder_apply(params, cfg: ModelConfig, x, *, mode: str, positions,
                  caches=None, cache_pos=None, mask_kind: str = "causal",
                  return_cache: bool = False):
    """x: (B,S,d) embeddings -> (hidden (B,S,d), caches).  In decode mode
    the caches are updated in place and returned; in train/prefill mode
    the new caches are returned when `return_cache`, else None."""
    new_caches = []
    for i, (kind, blk) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        x, nc = blocks.apply(
            blk, cfg, x, kind, mode=mode, positions=positions,
            cache=caches[i] if caches is not None else None,
            cache_pos=cache_pos, mask_kind=mask_kind,
            window=cfg.sliding_window, return_cache=return_cache)
        new_caches.append(nc)
    x = norms.apply(params["final_norm"], cfg, x)
    keep = return_cache or mode == "decode"
    return x, (new_caches if keep else None)
