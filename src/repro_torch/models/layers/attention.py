"""Multi-head attention with GQA, partial RoPE, qk-norm and sliding-window
masking — the attention module of the dense LM and of the embedder.

The reference (`repro/models/layers/attention.py`) computes attention with
pure-JAX SDPA (direct, or chunked online-softmax for long sequences) and
says its Pallas kernels "implement the same contract for real TPU
hardware".  Here the attention call IS the kernel's function:

  * train / prefill with a causal or bidirectional mask and positions
    0..S-1 on both sides -> `kernels.flash_attention` (K6);
  * decode against the full (non-ring) cache -> `kernels.decode_attention`
    (K5) with kv_len = cache_pos + 1.

A CPU tensor runs each kernel's plain PyTorch version, a CUDA tensor the
CUDA kernel.  Grouped heads go to the kernels as strided views of the
(B, S, H, D) projections and of the (B, T, K, D) cache, not as copies.
The decode cache is updated in place: `apply(mode="decode")` writes the
new token's k/v into the cache tensors it was given and returns the same
dict.  Prefix-LM masks, the ring-buffer and the int8 KV caches raise
NotImplementedError (later slices of the port); cross-attention (the
encoder-decoder configs) comes with its own slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.module import ParamSpec
from repro_torch.common.utils import resolve_device
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import rope as rope_lib
from repro_torch.models.layers.norms import rms_norm

SLICE_RING = "the ring-buffer KV cache slice of the port"
SLICE_QUANT = "the int8 KV cache slice of the port"
SLICE_PREFIX = "the image-prefix (VLM) slice of the port"


def specs(cfg):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"),
                        init="scaled_normal", scale=1.0),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                        init="scaled_normal", scale=1.0),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                        init="scaled_normal", scale=1.0),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"),
                        init="scaled_normal", scale=1.0),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
        s["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
    return s


# ---------------------------------------------------------------------------
# SDPA through the kernels
# ---------------------------------------------------------------------------

def _grouped_q(q, K: int):
    """(B, S, H, D) -> a (B, K, G, S, D) view (head h = k * G + g)."""
    B, S, H, D = q.shape
    return q.reshape(B, S, K, H // K, D).permute(0, 2, 3, 1, 4)


def attend(q, k, v, *, kind: str = "causal", window: int = 0,
           scale: Optional[float] = None):
    """Self-attention over a whole sequence whose query and key positions
    are both 0..S-1.  q: (B,S,H,D), k/v: (B,S,K,D) -> (B,S,H,D)."""
    if kind not in ("causal", "bidir"):
        raise NotImplementedError(f"mask kind {kind!r}: {SLICE_PREFIX}")
    B, S, H, D = q.shape
    out = flash_attention(_grouped_q(q, k.shape[2]), k.permute(0, 2, 1, 3),
                          v.permute(0, 2, 1, 3), causal=kind == "causal",
                          window=window, scale=scale)
    # the kernel's output is (B, S, K, G, D) in memory: this is a view
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def attend_decode(q, k_cache, v_cache, kv_len, *, window: int = 0,
                  scale: Optional[float] = None):
    """One new token per row against the full cache.  q: (B,1,H,D),
    k/v cache: (B,T,K,D), kv_len: (B,) int32 -> (B,1,H,D)."""
    B, _, H, D = q.shape
    K = k_cache.shape[2]
    out = decode_attention(q.reshape(B, K, H // K, D), k_cache.permute(0, 2, 1, 3),
                           v_cache.permute(0, 2, 1, 3), kv_len, scale=scale,
                           window=window)
    return out.view(B, 1, H, D)


# ---------------------------------------------------------------------------
# Module apply.
# ---------------------------------------------------------------------------

def _project_qkv(params, cfg, x, *, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", x, params["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", x, params["wv"].to(dt))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = rope_lib.apply_rope(q, positions, theta=cfg.rope_theta,
                            pct=cfg.rope_pct)
    k = rope_lib.apply_rope(k, positions, theta=cfg.rope_theta,
                            pct=cfg.rope_pct)
    return q, k, v


def _check_positions(positions, S: int) -> None:
    """The kernels count positions from 0: the train/prefill path takes
    positions equal to arange(S) per row.  Checked where it is cheap (a CPU
    tensor); on the card the check would cost a device sync per layer."""
    if positions.device.type == "cpu" and not torch.equal(
            positions.long(), torch.arange(S).expand_as(positions)):
        raise NotImplementedError(
            "train/prefill positions must be 0..S-1 (an offset query "
            f"window is {SLICE_RING})")


def apply(params, cfg, x, *, positions, mode: str = "train",
          cache=None, cache_pos=None, mask_kind: str = "causal",
          window: int = 0, return_cache: bool = False):
    """Unified self-attention entry point; returns (out (B,S,D),
    cache|None).  In decode mode `cache` is updated in place and
    returned."""
    B = x.shape[0]
    dt = x.dtype
    new_cache = None

    if mode in ("train", "prefill"):
        _check_positions(positions, x.shape[1])
        q, k, v = _project_qkv(params, cfg, x, positions=positions)
        out = attend(q, k, v, kind=mask_kind, window=window)
        if return_cache:
            new_cache = {"k": k, "v": v}
    elif mode == "decode":
        if "pos" in cache:
            raise NotImplementedError(f"ring-buffer cache: {SLICE_RING}")
        if "k_scale" in cache:
            raise NotImplementedError(f"int8 KV cache: {SLICE_QUANT}")
        q, k_new, v_new = _project_qkv(params, cfg, x, positions=positions)
        # per-row cache positions (continuous batching: each slot has its
        # own sequence length); a scalar cache_pos broadcasts
        pos = torch.as_tensor(cache_pos, device=x.device)
        if pos.dim() == 0:
            pos = pos.expand(B)
        pos = pos.long()
        rows = torch.arange(B, device=x.device)
        cache["k"][rows, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos] = v_new[:, 0].to(cache["v"].dtype)
        kv_len = (pos + 1).to(torch.int32)
        out = attend_decode(q, cache["k"].to(dt), cache["v"].to(dt), kv_len,
                            window=window)
        new_cache = cache
    else:
        raise ValueError(mode)

    proj = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
    return proj, new_cache


def cache_specs(cfg, batch: int, max_len: int, dtype, *, window: int = 0):
    """(shape, logical_axes, dtype) per cache entry: the full (B, T, K, D)
    layout.  The reference's ring-buffer layout (0 < window < max_len) and
    int8 cache (cfg.kv_cache_quant) raise NotImplementedError."""
    if window and 0 < window < max_len:
        raise NotImplementedError(f"ring-buffer cache (window {window} < "
                                  f"max_len {max_len}): {SLICE_RING}")
    if cfg.kv_cache_quant == "int8":
        raise NotImplementedError(f"int8 KV cache: {SLICE_QUANT}")
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    axes = ("batch", "seq", "kv_heads", "head_dim")
    return {"k": (shape, axes, dtype), "v": (shape, axes, dtype)}


def init_cache(cfg, batch: int, max_len: int, dtype, *, window: int = 0,
               device="cuda"):
    device = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, _axes, dt) in cache_specs(
                cfg, batch, max_len, dtype, window=window).items()}
