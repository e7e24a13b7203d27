"""Decoder stack: the reference's `repro/models/transformer.py`.

The reference groups layers into scanned segments (`plan_segments`, one
`lax.scan` over stacked parameters per segment); here the stack is a Python
loop over a list of per-layer parameter dicts, `params["layers"][i]`, in
`layer_kinds()` order.  Caches follow the same list: `caches[i]` is layer
i's dict — {"k", "v"} (with "pos" in the ring-buffer layout, "k_scale" /
"v_scale" with int8 codes), {"ckv", "k_rope"} (MLA), {"conv", "state"}
(SSM), {"conv", "h"} (RG-LRU), plus "cross_k" / "cross_v" in an
encoder-decoder — the reference's cache tree sliced at that layer.

Recompute: the reference wraps each scanned segment in `jax.checkpoint`
when `remat` and mode == "train"; here `remat=True` runs each block of a
train-mode stack under `torch.utils.checkpoint` (non-reentrant) while
grad is enabled, so a block's activations are recomputed in the backward
(its attention through K6 again) instead of kept.  Values are unchanged:
the blocks are deterministic (the MoE top-k is a stable sort).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import partitioning as pt
from repro_torch.common.utils import resolve_device
from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import norms
from repro_torch.models.layers.attention import (position_offsets,
                                                 quantize_kv)


def decoder_specs(cfg: ModelConfig, *, cross: bool = False):
    return {"layers": [blocks.block_specs(cfg, kind, cross=cross)
                       for kind in cfg.layer_kinds()],
            "final_norm": norms.specs(cfg)}


def _block_window(cfg, kind, window_override: Optional[int]):
    if kind[0] != "attn":
        return 0
    if cfg.hybrid_period > 0:
        return cfg.rglru.local_window
    if window_override is not None:
        return window_override
    return cfg.sliding_window


def decoder_cache_shape_specs(cfg: ModelConfig, batch: int, max_len: int,
                              dtype, *, cross: bool = False, enc_len: int = 0,
                              window_override=None):
    """One {name: (shape, axes, dtype)} per layer."""
    return [blocks.block_cache_specs(
                cfg, kind, batch, max_len, dtype, cross=cross,
                enc_len=enc_len,
                window=_block_window(cfg, kind, window_override))
            for kind in cfg.layer_kinds()]


def init_caches(cfg, batch, max_len, dtype, *, cross=False, enc_len=0,
                window_override=None, device="cuda"):
    """Zeros, and -1 in every int32 entry (the ring's empty slots)."""
    device = resolve_device(device)
    return [{name: torch.full(shape, -1 if dt == torch.int32 else 0,
                              dtype=dt, device=device)
             for name, (shape, _axes, dt) in layer.items()}
            for layer in decoder_cache_shape_specs(
                cfg, batch, max_len, dtype, cross=cross, enc_len=enc_len,
                window_override=window_override)]


# ---------------------------------------------------------------------------
# Prefill-cache -> decode-cache conversion
# ---------------------------------------------------------------------------

def _pad_seq(x, to_len: int):
    """Zero-pad axis 1 (the sequence) of a (B, S, ...) tensor to to_len."""
    pad = [0, 0] * (x.dim() - 2) + [0, to_len - x.shape[1]]
    return pt.pad(x, pad)


def _ring_slots(S: int, W: int, device="cpu"):
    """Slot j for ring index i after S prefilled tokens (slot i holds the
    token whose position ≡ i (mod W), among the last W positions)."""
    i = torch.arange(W, device=device)
    return S - W + ((i - (S % W)) % W)


def _prep_block_cache(bc, prefill_len: int, max_len: int, window: int,
                      quant: str = ""):
    if bc is None:
        return None
    S = prefill_len
    out = {}
    ring = bool(window) and 0 < window < max_len
    for name, x in bc.items():
        if name in ("k", "v"):
            if x.shape[1] != S or S > max_len:
                raise ValueError(f"cache of {x.shape[1]} positions for a "
                                 f"prefill of {S} into max_len {max_len}")
            if ring:
                W = window
                x = (x[:, _ring_slots(S, W, x.device)] if S >= W
                     else _pad_seq(x, W))
            else:
                x = _pad_seq(x, max_len)
            if quant == "int8":
                out[name], out[name + "_scale"] = quantize_kv(x)
            else:
                out[name] = x
        elif name in ("ckv", "k_rope"):
            out[name] = _pad_seq(x, max_len)
        else:
            out[name] = x
    if ring and "k" in bc:
        W = window
        B = bc["k"].shape[0]
        if S >= W:
            pos1 = _ring_slots(S, W, bc["k"].device)
        else:
            pos1 = torch.cat([torch.arange(S, device=bc["k"].device),
                              torch.full((W - S,), -1, device=bc["k"].device)])
        out["pos"] = pos1.to(torch.int32).expand(B, W).contiguous()
    return out


def prepare_decode_caches(cfg, caches, prefill_len: int, max_len: int, *,
                          window_override=None):
    """Convert prefill caches (seq length = prefill_len) into decode caches:
    full caches zero-padded to max_len; windowed attention converted to the
    ring-buffer layout with true slot positions; k/v quantised to int8
    codes and scales with `kv_cache_quant`; MLA latents padded; recurrent
    states as they are.  DTensor caches (a meshed prefill's) convert as
    DTensors, the slot indices taken as replicated."""
    if any(pt.is_dtensor(x) for c in caches if c for x in c.values()):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return _prepare(cfg, caches, prefill_len, max_len,
                            window_override)
    return _prepare(cfg, caches, prefill_len, max_len, window_override)


def _prepare(cfg, caches, prefill_len, max_len, window_override):
    out = []
    for kind, bc in zip(cfg.layer_kinds(), caches):
        quant = (cfg.kv_cache_quant if kind[0] == "attn" and not cfg.use_mla
                 else "")
        out.append(_prep_block_cache(
            bc, prefill_len, max_len,
            _block_window(cfg, kind, window_override), quant=quant))
    return out


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def decoder_apply(params, cfg: ModelConfig, x, *, mode: str, positions,
                  caches=None, cache_pos=None, mask_kind: str = "causal",
                  prefix_len=None, enc_out=None, enc_positions=None,
                  window_override: Optional[int] = None,
                  return_cache: bool = False, use_rope: bool = True,
                  remat: bool = False, positions_offset=None,
                  enc_positions_offset=None):
    """x: (B,S,d) embeddings -> (hidden (B,S,d), caches, aux).  In decode
    mode the caches are updated in place and returned; in train/prefill
    mode the new caches are returned when `return_cache`, else None.  aux
    sums the MoE layers' auxiliary values.  `remat` recomputes each block
    in the backward (train mode, grad enabled; see the module docstring).
    Train/prefill: `positions_offset` / `enc_positions_offset` say that the
    positions are that offset + 0..S-1 per row (an int or a (B,) tensor);
    None reads it from them once for every layer (`position_offsets`)."""
    if mode in ("train", "prefill"):
        B = x.shape[0]
        if positions_offset is None:
            positions_offset = position_offsets(positions, B,
                                                positions.shape[1])
        if enc_positions_offset is None and enc_positions is not None:
            enc_positions_offset = position_offsets(
                enc_positions, B, enc_positions.shape[1], "key")
    aux_total = blocks.zero_aux(x.device)
    new_caches = []
    recompute = remat and mode == "train" and torch.is_grad_enabled()
    for i, (kind, blk) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        def block(x, blk=blk, kind=kind, cache=(
                caches[i] if caches is not None else None)):
            return blocks.apply(
                blk, cfg, x, kind, mode=mode, positions=positions,
                cache=cache, cache_pos=cache_pos, mask_kind=mask_kind,
                window=_block_window(cfg, kind, window_override),
                prefix_len=prefix_len, enc_out=enc_out,
                enc_positions=enc_positions, return_cache=return_cache,
                use_rope=use_rope, positions_offset=positions_offset,
                enc_positions_offset=enc_positions_offset)
        x = pt.batch_only(x)             # a meshed step's block input
        x, nc, aux = (checkpoint(block, x, use_reentrant=False) if recompute
                      else block(x))
        new_caches.append(nc)
        if aux is not None:
            aux_total = {k: aux_total[k] + aux[k] for k in aux_total}
    x = norms.apply(params["final_norm"], cfg, x)
    keep = return_cache or mode == "decode"
    return x, (new_caches if keep else None), aux_total
