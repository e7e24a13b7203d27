"""Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2412.19437) — the
reference's `repro/models/layers/mla.py` in torch.

Train/prefill use the decompressed form: the per-head K (nope part from the
latent, rope part shared) and V are rebuilt and attention runs through K6.
K6 takes one head width for q, k and v, so v (v_head_dim wide) goes in
zero-padded to the q/k width (qk_nope + qk_rope) and the output is sliced
back: a zero column of v adds nothing to any output column.  Decode uses
the absorbed form against the compressed latent cache:

    score[h,t] = (W_UK[h]^T q_nope[h]) . c_kv[t]  +  q_rope[h] . k_rope[t]

so the per-token cache is only (kv_lora_rank + qk_rope_head_dim) wide.
That decode runs as torch einsums, as the reference computes it outside
any kernel: its latent (576 wide at full size, all 128 heads on one shared
kv head) is beyond K5's head width and grouped-query limits.  The latent
cache is written in place.  On a mesh whose rules shard the latent cache's
sequence (long_500k's `long_context_rules`), each rank scores its own
rows by absolute position, takes its local softmax with its log-sum-exp,
and `attention.combine_shards` merges the ranks' latent outputs: the
(B, H, 1, T) scores and the cache are never gathered.  The absorbed form
in train/prefill (`mla_absorbed_train`, the reference's dry-run variant)
folds W_UK into q and runs K6 against the latent itself: one kv head, q/k
width kv_lora_rank + qk_rope_head_dim (576 at full size, K6's widest
instance), v the latent zero-padded to that width, G = all query heads;
then W_UV.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.common import partitioning as pt
from repro_torch.common.module import ParamSpec
from repro_torch.common.utils import resolve_device
from repro_torch.models.layers import rope as rope_lib
from repro_torch.models.layers.attention import (attend, combine_shards,
                                                 position_offsets)
from repro_torch.models.layers.norms import rms_norm


def specs(cfg):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": ParamSpec((d, m.q_lora_rank), ("embed", None), init="scaled_normal", scale=1.0),
        "q_norm": ParamSpec((m.q_lora_rank,), (None,), init="ones"),
        "wuq": ParamSpec((m.q_lora_rank, h, qk_hd), (None, "heads", "head_dim"),
                         init="scaled_normal", scale=1.0),
        "wdkv": ParamSpec((d, m.kv_lora_rank), ("embed", None), init="scaled_normal", scale=1.0),
        "kv_norm": ParamSpec((m.kv_lora_rank,), (None,), init="ones"),
        "wkr": ParamSpec((d, m.qk_rope_head_dim), ("embed", "head_dim"),
                         init="scaled_normal", scale=1.0),
        "wuk": ParamSpec((m.kv_lora_rank, h, m.qk_nope_head_dim), (None, "heads", "head_dim"),
                         init="scaled_normal", scale=1.0),
        "wuv": ParamSpec((m.kv_lora_rank, h, m.v_head_dim), (None, "heads", "head_dim"),
                         init="scaled_normal", scale=1.0),
        "wo": ParamSpec((h, m.v_head_dim, d), ("heads", "head_dim", "embed"),
                        init="scaled_normal", scale=1.0),
    }


def _q_proj(params, cfg, x, positions):
    m = cfg.mla
    dt = x.dtype
    cq = torch.einsum("bsd,dr->bsr", x, params["wdq"].to(dt))
    cq = rms_norm(cq, params["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["wuq"].to(dt))
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = rope_lib.apply_rope(q[..., m.qk_nope_head_dim:], positions,
                                 theta=cfg.rope_theta, pct=1.0)
    return q_nope, q_rope


def _latent_proj(params, cfg, x, positions):
    dt = x.dtype
    ckv = torch.einsum("bsd,dr->bsr", x, params["wdkv"].to(dt))
    ckv = rms_norm(ckv, params["kv_norm"], cfg.norm_eps)
    k_rope = torch.einsum("bsd,dk->bsk", x, params["wkr"].to(dt))
    k_rope = rope_lib.apply_rope(k_rope, positions, theta=cfg.rope_theta,
                                 pct=1.0)
    return ckv, k_rope


def apply(params, cfg, x, *, positions, mode: str = "train", cache=None,
          cache_pos=None, window: int = 0, return_cache: bool = False,
          mask_kind: str = "causal", prefix_len=None, positions_offset=None):
    """MLA's entry point; returns (out (B,S,D), cache|None).  Train/prefill
    positions are `positions_offset` + 0..S-1 per row (an int or a (B,)
    tensor; None: read from the positions), as `attention.apply`."""
    m = cfg.mla
    dt = x.dtype
    B = x.shape[0]
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    scale = qk_hd ** -0.5
    new_cache = None

    if mode in ("train", "prefill"):
        # per-row offsets of the positions (a window past 0 is served)
        off = (positions_offset if positions_offset is not None
               else position_offsets(positions, B, x.shape[1]))
    if mode in ("train", "prefill") and cfg.mla_absorbed_train:
        q_nope, q_rope = _q_proj(params, cfg, x, positions)
        ckv, k_rope = _latent_proj(params, cfg, x, positions)
        # absorbed: W_UK folds into q and attention runs against the latent
        # (one kv head shared by every query head): q/k width r + rope, v
        # the latent zero-padded to that width, the output sliced back to r
        r = m.kv_lora_rank
        q_eff = torch.einsum("bshk,rhk->bshr", q_nope, params["wuk"].to(dt))
        q2 = torch.cat([q_eff, q_rope], dim=-1)            # (B,S,H,r+rope)
        k2 = torch.cat([ckv, k_rope], dim=-1)[:, :, None]  # (B,T,1,r+rope)
        v2 = pt.pad(ckv, (0, m.qk_rope_head_dim))[:, :, None]
        o_lat = attend(q2, k2, v2, kind=mask_kind, window=window,
                       prefix_len=prefix_len, scale=scale, q_offset=off,
                       kv_offset=off)[..., :r]
        out = torch.einsum("bshr,rhk->bshk", o_lat, params["wuv"].to(dt))
        if return_cache:
            new_cache = {"ckv": ckv, "k_rope": k_rope}
    elif mode in ("train", "prefill"):
        q_nope, q_rope = _q_proj(params, cfg, x, positions)
        ckv, k_rope = _latent_proj(params, cfg, x, positions)
        # decompressed K/V: (B,S,H,*)
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, params["wuk"].to(dt))
        v = torch.einsum("bsr,rhk->bshk", ckv, params["wuv"].to(dt))
        H = k_nope.shape[2]
        k = torch.cat([k_nope, k_rope[:, :, None].expand(
            *k_rope.shape[:2], H, k_rope.shape[-1])], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        v_pad = pt.pad(v, (0, qk_hd - m.v_head_dim))
        out = attend(q, k, v_pad, kind=mask_kind, window=window,
                     prefix_len=prefix_len, scale=scale, q_offset=off,
                     kv_offset=off)[..., : m.v_head_dim]
        if return_cache:
            new_cache = {"ckv": ckv, "k_rope": k_rope}
    elif mode == "decode":
        # absorbed decode against the latent cache, written in place
        q_nope, q_rope = _q_proj(params, cfg, x, positions)        # (B,1,H,*)
        ckv_new, kr_new = _latent_proj(params, cfg, x, positions)  # (B,1,r)
        pos = torch.as_tensor(cache_pos, device=x.device)
        if pos.dim() == 0:
            pos = pos.expand(B)
        pos = pos.long()
        pt.write_rows(cache["ckv"], pos, ckv_new[:, 0])
        pt.write_rows(cache["k_rope"], pos, kr_new[:, 0])
        ckv, k_rope = cache["ckv"].to(dt), cache["k_rope"].to(dt)
        q_eff = torch.einsum("bshk,rhk->bshr", q_nope, params["wuk"].to(dt))
        if pt.seq_mesh_dims(ckv):
            o_lat = _context_parallel(q_eff, q_rope, ckv, k_rope, pos,
                                      window=window, scale=scale)
        else:                                    # the whole cache: one shard
            o_lat = _latent_shard(q_eff, q_rope, ckv, k_rope, pos, start=0,
                                  window=window, scale=scale)[0]
        out = torch.einsum("bshr,rhk->bshk", o_lat, params["wuv"].to(dt))
        new_cache = cache
    else:
        raise ValueError(mode)

    proj = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
    return proj, new_cache


def _context_parallel(q_eff, q_rope, ckv, k_rope, pos, *, window, scale):
    """The absorbed decode's latent output (B, 1, H, r) over a latent
    cache whose sequence is sharded on some mesh dims: `_latent_shard` on
    each rank's rows, then `combine_shards`.  The queries keep their head
    sharding where the cache is whole, and the batch's where it shards the
    batch."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = ckv.device_mesh
    seq = pt.seq_mesh_dims(ckv)
    cp = tuple(Shard(1) if i in seq else p
               for i, p in enumerate(ckv.placements))
    qp = tuple(Replicate() if i in seq
               else Shard(0) if isinstance(c, Shard) and c.dim == 0
               else p if isinstance(p, Shard) and p.dim == 2
               else Replicate()
               for i, (p, c) in enumerate(zip(q_eff.placements, cp)))
    rows = pt.batch_placements(qp)
    start = pt.local_shape_and_offset(tuple(ckv.shape), mesh, cp)[1][1]
    args = [pt.with_placements(q_eff, qp),
            pt.with_placements(pt.replicated(q_rope, mesh), qp),
            pt.with_placements(ckv, cp),
            pt.with_placements(pt.replicated(k_rope, mesh), cp),
            pt.with_placements(pt.replicated(pos, mesh), rows)]
    run = functools.partial(_latent_shard, start=start, window=window,
                            scale=scale)
    return combine_shards(run, args, [qp, qp, cp, cp, rows], qp, seq, mesh)


def _latent_shard(q_eff, q_rope, ckv, k_rope, pos, *, start, window, scale):
    """This rank's rows [start, start + T) of the latent cache: scores by
    absolute position, the local softmax and its log-sum-exp (-inf where
    no row is allowed) -> (o_lat (B, 1, H, r), lse (B, 1, H))."""
    T = ckv.shape[1]
    s = (torch.einsum("bshr,btr->bhst", q_eff, ckv)
         + torch.einsum("bshk,btk->bhst", q_rope, k_rope)).float() * scale
    t_idx = start + torch.arange(T, device=ckv.device)[None, None, None, :]
    posb = pos[:, None, None, None]
    ok = t_idx <= posb
    if window and window > 0:
        ok = ok & (t_idx > posb - window)
    s = torch.where(ok, s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                           # (B,H,1)
    probs = torch.exp(s - torch.where(torch.isfinite(lse), lse,
                                      torch.zeros_like(lse))[..., None])
    o_lat = torch.einsum("bhst,btr->bshr", probs.to(ckv.dtype), ckv)
    return o_lat, lse.transpose(1, 2)


def cache_specs(cfg, batch: int, max_len: int, dtype):
    m = cfg.mla
    return {
        "ckv": ((batch, max_len, m.kv_lora_rank), ("batch", "seq", None), dtype),
        "k_rope": ((batch, max_len, m.qk_rope_head_dim), ("batch", "seq", None), dtype),
    }


def init_cache(cfg, batch: int, max_len: int, dtype, *, device="cuda"):
    device = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, _axes, dt) in cache_specs(
                cfg, batch, max_len, dtype).items()}
