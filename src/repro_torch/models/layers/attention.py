"""Multi-head attention with GQA, partial RoPE, qk-norm, sliding-window,
prefix-LM and cross-attention — the one attention module of every
attention-bearing architecture of the zoo, as the reference's
`repro/models/layers/attention.py`.

The reference computes attention with pure-JAX SDPA (direct, or chunked
online-softmax for long sequences) and says its Pallas kernels "implement
the same contract for real TPU hardware".  Here the attention call IS the
kernel's function:

  * train / prefill (causal, bidirectional or prefix-LM self-attention;
    cross-attention over an encoder's output, bidirectional with S != T),
    with query and key positions o + 0..S-1 and o' + 0..T-1 per row (an
    offset window of a sequence; `position_offsets`) ->
    `kernels.flash_attention` (K6) with those per-row offsets;
  * decode against the full cache -> `kernels.decode_attention` (K5) with
    kv_len = cache_pos + 1; against the ring-buffer cache of a sliding
    window -> K5 with the cache's slot positions; against the int8 cache
    -> K5 on the codes and their scales; cross decode -> K5 over the whole
    encoder cache.

A CPU tensor runs each kernel's plain PyTorch version, a CUDA tensor the
CUDA kernel.  Grouped heads go to the kernels as strided views of the
(B, S, H, D) projections and of the (B, T, K, D) cache, not as copies.
The decode cache is updated in place: `apply(mode="decode")` writes the
new token's k/v (codes and scales; its slot position) into the cache
tensors it was given, then attends, and returns the same dict.  So no
query row of a decode is ever without an allowed key: its own token is
in the cache.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.common import partitioning as pt
from repro_torch.common.module import ParamSpec
from repro_torch.common.utils import resolve_device
from repro_torch.kernels.decode_attention import (combine_partials,
                                                  decode_attention)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import rope as rope_lib
from repro_torch.models.layers.norms import rms_norm


def specs(cfg, *, cross: bool = False):
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
    if cfg.qkv_bias and not cross:
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
           prefix_len=None, scale: Optional[float] = None, q_offset=None,
           kv_offset=None):
    """Attention over whole sequences whose query and key positions are
    q_offset + 0..S-1 and kv_offset + 0..T-1 (per-row (B,) offsets, None:
    0).  q: (B,S,H,D), k/v: (B,T,K,D) -> (B,S,H,D).  kind "causal", "bidir"
    or "prefix" (causal, and keys at positions < prefix_len seen by every
    query; no prefix_len is plain causal, as the reference).  On DTensors
    (a meshed step) K6 runs on each rank's shard (`_meshed`)."""
    if kind not in ("causal", "bidir", "prefix"):
        raise ValueError(f"mask kind {kind!r}")
    if pt.is_dtensor(q):
        # a per-row prefix (B,) and per-row offsets are sharded with the rows
        tensor_prefix = isinstance(prefix_len, torch.Tensor)
        rows = [prefix_len if tensor_prefix else None]
        kw = {} if tensor_prefix else {"prefix_len": prefix_len}
        offs = (q_offset, kv_offset)
        row = next((o for o in offs if isinstance(o, torch.Tensor)), None)
        if row is not None:
            rows += [o if isinstance(o, torch.Tensor)
                     else torch.full_like(row, int(o or 0)) for o in offs]
        else:
            kw.update(q_offset=q_offset, kv_offset=kv_offset)
        rows = [] if rows == [None] else rows
        return _meshed(_attend_local, q, k, v, *rows, kind=kind,
                       window=window, scale=scale, **kw)
    return _attend_local(q, k, v, None, q_offset, kv_offset, kind=kind,
                         window=window, prefix_len=prefix_len, scale=scale)


def _attend_local(q, k, v, prefix_rows=None, q_offset=None, kv_offset=None,
                  *, kind, window, scale, prefix_len=None):
    B, S, H, D = q.shape
    prefix = prefix_rows if prefix_rows is not None else prefix_len
    out = flash_attention(_grouped_q(q, k.shape[2]), k.permute(0, 2, 1, 3),
                          v.permute(0, 2, 1, 3), causal=kind != "bidir",
                          window=window, scale=scale,
                          prefix_len=prefix if kind == "prefix" else None,
                          q_offset=q_offset, kv_offset=kv_offset)
    # the kernel's output is (B, S, K, G, D) in memory: this is a view
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def _meshed(local_fn, q, k, v, *row_args, **kw):
    """`local_fn` (K6's or K5's call) under `local_map` on each rank's
    shard of DTensor q (B, S, H, D) and k/v (B, T, K, D): batch sharded on
    the batch axes, heads on `model` where q and k/v both shard them, or
    q's heads with the kv heads they read cut from keys every rank holds
    (`_kv_heads`; see `partitioning.attention_placements`: a
    head_dim-sharded operand is gathered first, where the reference's XLA
    computes partial sums).
    Attention is independent across batch rows and kv-head groups, so
    every rank launches its kernel on its own shard and no collective runs
    inside.  `row_args` are per-row (B, ...) tensors (kv_len, slot
    positions, int8 scales (B, T, K), a per-row prefix) or None.  Decode
    over a key sequence sharded on a mesh axis goes to
    `_context_parallel_decode` instead; anything else that meets such
    keys (a prefill) gathers them first."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    k, v = pt.replicated(k, mesh), pt.replicated(v, mesh)
    qp, kp, kv_slice = pt.attention_placements(q, k)
    q = pt.with_placements(q, qp)
    k, v = pt.with_placements(k, kp), pt.with_placements(v, kp)
    rows = pt.batch_placements(qp)
    args, places = [q, k, v], [qp, kp, kp]
    for a in row_args:
        if a is None:
            args.append(None)
            places.append(None)
            continue
        a = pt.replicated(a, mesh)
        # (B, T, K) scales follow the cache's heads on dim 2
        want = kp if a.dim() == 3 else rows
        args.append(pt.with_placements(a, want))
        places.append(want)
    # one kv head read by every rank's query heads: each rank's gradient
    # of it covers its own heads only, Partial over `model`
    kg = tuple(Partial() if isinstance(a, Shard) and not isinstance(b, Shard)
               else b for a, b in zip(qp, kp))
    grads = [qp, kg, kg] + places[3:]
    run = functools.partial(local_fn, **kw)
    if kv_slice is not None:
        run = functools.partial(_kv_heads, run, *kv_slice)
    fn = local_map(run, out_placements=list(qp),
                   in_placements=tuple(places),
                   in_grad_placements=tuple(grads), device_mesh=mesh)
    return fn(*args)


def _kv_heads(local_fn, first: int, count: int, q, k, v, *rows):
    """`local_fn` on this rank's query heads and the kv heads they read:
    k/v (B, T, K, D) and (B, T, K) scales sliced to [first, first + count)
    on dim 2."""
    cut = slice(first, first + count)
    rows = [r[:, :, cut] if r is not None and r.dim() == 3 else r
            for r in rows]
    return local_fn(q, k[:, :, cut], v[:, :, cut], *rows)


def attend_decode(q, k_cache, v_cache, kv_len, *, window: int = 0,
                  scale: Optional[float] = None, slot_pos=None,
                  k_scale=None, v_scale=None):
    """One new token per row against a cache.  q: (B,1,H,D), k/v cache:
    (B,T,K,D) (int8 codes with k/v_scale (B,T,K)), kv_len: (B,) int32,
    slot_pos (B,T) int32 or None -> (B,1,H,D).  On DTensors K5 runs on
    each rank's shard (`_meshed`); a cache whose sequence is sharded (the
    context-parallel cache of `long_context_rules`) goes through
    `_context_parallel_decode`."""
    if pt.is_dtensor(q):
        if pt.seq_mesh_dims(k_cache):
            return _context_parallel_decode(
                q, k_cache, v_cache, kv_len, slot_pos, k_scale, v_scale,
                window=window, scale=scale)
        return _meshed(_decode_local, q, k_cache, v_cache, kv_len, slot_pos,
                       k_scale, v_scale, window=window, scale=scale)
    return _decode_local(q, k_cache, v_cache, kv_len, slot_pos, k_scale,
                         v_scale, window=window, scale=scale)


def _decode_local(q, k_cache, v_cache, kv_len, slot_pos, k_scale, v_scale,
                  *, window, scale, return_lse: bool = False):
    B, _, H, D = q.shape
    K = k_cache.shape[2]
    scales = {}
    if k_scale is not None:
        scales = {"k_scale": k_scale.permute(0, 2, 1),
                  "v_scale": v_scale.permute(0, 2, 1)}
    out = decode_attention(q.reshape(B, K, H // K, D),
                           k_cache.permute(0, 2, 1, 3),
                           v_cache.permute(0, 2, 1, 3), kv_len, scale=scale,
                           window=window, slot_pos=slot_pos,
                           return_lse=return_lse, **scales)
    if return_lse:
        return out[0].view(B, 1, H, D), out[1].reshape(B, 1, H)
    return out.view(B, 1, H, D)


def _context_parallel_decode(q, k, v, kv_len, slot_pos, k_scale, v_scale,
                             *, window, scale):
    """Decode over a cache whose sequence (dim 1) is sharded on some mesh
    axes, as the reference's `long_context_rules` lay it out: each rank
    runs K5 with `return_lse` on its own rows (a full cache's shard at
    kv_len - its first position; a ring's slots carry absolute
    positions), the ranks all-gather the (B, 1, H, D) outputs and
    (B, 1, H) log-sum-exps over those axes, and `combine_partials` merges
    them — the cache itself is never gathered.  Heads and batch keep
    `attention_placements`' layout on the other axes."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    k, v = pt.replicated(k, mesh), pt.replicated(v, mesh)
    seq = pt.seq_mesh_dims(k)
    qp, kp, kv_slice = pt.attention_placements(q, k)
    qp = tuple(Replicate() if i in seq else p for i, p in enumerate(qp))
    kp = tuple(Shard(1) if i in seq else p for i, p in enumerate(kp))
    rows = pt.batch_placements(qp)
    start = pt.local_shape_and_offset(tuple(k.shape), mesh, kp)[1][1]
    args = [pt.with_placements(q, qp), pt.with_placements(k, kp),
            pt.with_placements(v, kp)]
    places = [qp, kp, kp]
    slot_pl = tuple(Shard(1) if i in seq else p for i, p in enumerate(rows))
    for a, want in ((kv_len, rows), (slot_pos, slot_pl), (k_scale, kp),
                    (v_scale, kp)):
        args.append(None if a is None else
                    pt.with_placements(pt.replicated(a, mesh), want))
        places.append(None if a is None else want)
    run = functools.partial(_decode_shard, start=start, window=window,
                            scale=scale)
    if kv_slice is not None:
        run = functools.partial(_kv_heads, run, *kv_slice)
    return combine_shards(run, args, places, qp, seq, mesh)


def _decode_shard(q, k, v, kv_len, slot_pos, k_scale, v_scale, *, start,
                  window, scale):
    """K5 with its log-sum-exp on this rank's rows of a sequence-sharded
    cache whose first row sits at absolute position `start`."""
    if slot_pos is None:
        kv_len = kv_len - start
    return _decode_local(q, k, v, kv_len, slot_pos, k_scale, v_scale,
                         window=window, scale=scale, return_lse=True)


def combine_shards(local_fn, args, places, qp, seq, mesh):
    """`local_fn(*local args) -> (out (B, 1, H, X), lse (B, 1, H))` on each
    rank's shard of a sequence-sharded cache under `local_map`, then the
    combine: the outputs and log-sum-exps, stacked on a new leading dim
    sharded over the `seq` mesh dims, are all-gathered there and merged by
    `combine_partials`.  -> out, a DTensor laid out as `qp` (q's
    placements: batch, heads, or replicated on each mesh dim)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    # the stacks' placements: shard r of the sequence on seq dims, q's
    # batch / head sharding (one dim further right) elsewhere
    pl = tuple(Shard(0) if i in seq else Shard(p.dim + 1)
               if isinstance(p, Shard) else Replicate()
               for i, p in enumerate(qp))

    def stack(*a):
        o, lse = local_fn(*a)
        return o[None], lse[None]

    outs, lses = local_map(stack, out_placements=(pl, pl),
                           in_placements=tuple(places),
                           device_mesh=mesh)(*args)
    whole = tuple(Replicate() if i in seq else p for i, p in enumerate(pl))
    outs = pt.with_placements(outs, whole)       # the combine's all-gather
    lses = pt.with_placements(lses, whole)
    return local_map(lambda o, lse: combine_partials(o, lse)[0],
                     out_placements=list(qp), in_placements=(whole, whole),
                     device_mesh=mesh)(outs, lses)


# ---------------------------------------------------------------------------
# Module apply.
# ---------------------------------------------------------------------------

# the head_dim axis of each attention parameter
_HEAD_DIM_AXIS = {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "bq": 1, "bk": 1,
                  "bv": 1, "q_norm": 0, "k_norm": 0}


def _whole_head_dim(params):
    """Meshed parameters with head_dim whole: where the rules shard it (the
    head fallback: heads that do not divide `model`), DTensor gathers the
    weight once a call, and the heads stay replicated; the reference's XLA
    contracts the sharded head_dim to partial sums instead."""
    return {k: pt.gather_dims(v, _HEAD_DIM_AXIS[k]) if k in _HEAD_DIM_AXIS
            else v for k, v in params.items()}


def _project_q(params, cfg, x):
    """The query of cross decode (cross-attention has no biases)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
    return q


def _project_qkv(params, cfg, x, kv_x=None, *, use_rope=True, positions=None,
                 kv_positions=None, theta=None):
    kv_x = x if kv_x is None else kv_x
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", kv_x, params["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", kv_x, params["wv"].to(dt))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if use_rope:
        th = theta if theta is not None else cfg.rope_theta
        q = rope_lib.apply_rope(q, positions, theta=th, pct=cfg.rope_pct)
        k = rope_lib.apply_rope(k, kv_positions, theta=th, pct=cfg.rope_pct)
    return q, k, v


def position_offsets(positions, B: int, S: int, what: str = "query"):
    """The per-row offsets (B,) int32 of train/prefill positions (B, S) (or
    (1, S), for every row): each row must be its first position + 0..S-1 (a
    prompt, a window of one, an image prefix and its text, an encoder's
    frames).  Other positions raise NotImplementedError on the CPU and
    fail `torch._assert_async` on the card (no read back).  The dry-run's
    fake tensors are not checked.  A model derives them once a pass
    (`transformer.decoder_apply`) or knows them where it makes the
    positions, and hands them to each layer as `positions_offset`."""
    off = positions[:, 0].to(torch.int32)
    off = off.expand(B) if off.shape[0] == 1 and B > 1 else off
    if not is_fake(positions):
        rel = positions - positions[:, :1]
        want = torch.arange(S, device=positions.device)
        if positions.device.type == "cpu":
            if not torch.equal(rel.long(), want.expand_as(rel)):
                raise NotImplementedError(
                    f"train/prefill {what} positions must be a row offset + "
                    "0..S-1: the kernel masks a window of positions, not "
                    "arbitrary ones")
        else:
            torch._assert_async((rel == want).all(),
                                 f"train/prefill {what} positions must be a "
                                 "row offset + 0..S-1")
    return off


def apply(params, cfg, x, *, positions, mode: str = "train",
          cache=None, cache_pos=None, mask_kind: str = "causal",
          window: int = 0, prefix_len=None, kv_x=None, kv_positions=None,
          use_rope: bool = True, theta=None, return_cache: bool = False,
          positions_offset=None, kv_positions_offset=None):
    """Unified attention entry point; returns (out (B,S,D), cache|None).
    In decode mode `cache` is updated in place and returned; cross decode
    returns its cache untouched.  Train/prefill: `positions_offset` (and
    `kv_positions_offset` for `kv_positions`), an int or a (B,) tensor,
    says that the positions are that offset + 0..S-1 per row, as the
    caller that made them knows; None reads it from the positions
    (`position_offsets`).  An int offset of 0 runs K6 without offsets."""
    B = x.shape[0]
    dt = x.dtype
    new_cache = None
    if pt.is_dtensor(params["wq"]):
        params = _whole_head_dim(params)

    if mode in ("train", "prefill"):
        kv_pos = kv_positions if kv_positions is not None else positions
        q_off = (positions_offset if positions_offset is not None
                 else position_offsets(positions, B, x.shape[1]))
        if kv_positions is None:
            kv_off = q_off
        elif kv_positions_offset is not None:
            kv_off = kv_positions_offset
        else:
            kv_off = position_offsets(
                kv_pos, B, (x if kv_x is None else kv_x).shape[1], "key")
        q, k, v = _project_qkv(params, cfg, x, kv_x, use_rope=use_rope,
                               positions=positions, kv_positions=kv_pos,
                               theta=theta)
        out = attend(q, k, v, kind="bidir" if kv_x is not None else mask_kind,
                     window=window, prefix_len=prefix_len,
                     q_offset=q_off, kv_offset=kv_off)
        if return_cache:
            new_cache = {"k": k, "v": v}
    elif mode == "decode":
        T = cache["k"].shape[1]
        q, k_new, v_new = _project_qkv(
            params, cfg, x, None, use_rope=use_rope, positions=positions,
            kv_positions=positions, theta=theta)
        # per-row cache positions (continuous batching: each slot has its
        # own sequence length); a scalar cache_pos broadcasts
        pos = torch.as_tensor(cache_pos, device=x.device)
        if pos.dim() == 0:
            pos = pos.expand(B)
        pos = pos.long()
        ring = "pos" in cache                  # ring-buffer sliding window
        idx = pos % T if ring else pos
        scales = {}
        if "k_scale" in cache:                 # int8 codes + per-row scales
            for name, new in (("k", k_new), ("v", v_new)):
                codes, sc = quantize_kv(new[:, 0])
                pt.write_rows(cache[name], idx, codes)
                pt.write_rows(cache[name + "_scale"], idx, sc)
            scales = {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
            k_use, v_use = cache["k"], cache["v"]
        else:
            pt.write_rows(cache["k"], idx, k_new[:, 0])
            pt.write_rows(cache["v"], idx, v_new[:, 0])
            k_use, v_use = cache["k"].to(dt), cache["v"].to(dt)
        slot_pos = None
        if ring:
            # fixed window-sized cache, write slot = pos % W; each slot's
            # true position is kept so the mask stays exact
            pt.write_rows(cache["pos"], idx, pos.to(torch.int32))
            slot_pos = cache["pos"]
        kv_len = (pos + 1).to(torch.int32)
        out = attend_decode(q, k_use, v_use, kv_len, window=window,
                            slot_pos=slot_pos, **scales)
        new_cache = cache
    elif mode == "cross_decode":
        q = _project_q(params, cfg, x)
        k, v = cache["k"].to(dt), cache["v"].to(dt)
        kv_len = torch.full((B,), k.shape[1], dtype=torch.int32,
                            device=x.device)
        out = attend_decode(q, k, v, kv_len)
        new_cache = cache
    else:
        raise ValueError(mode)

    proj = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
    return proj, new_cache


def quantize_kv(x):
    """Symmetric per-(token, head) int8 quantisation.  x: (..., D) ->
    (int8 codes, f32 scales (...,)); rounds half to even, as `jnp.round`."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def cache_specs(cfg, batch: int, max_len: int, dtype, *, window: int = 0):
    """(shape, logical_axes, dtype) per cache entry.  window > 0 and
    < max_len selects the ring-buffer layout (a window-sized cache and the
    slot positions "pos"); cfg.kv_cache_quant == "int8" stores int8 codes
    and per-(token, head) f32 scales."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    ring = bool(window) and 0 < window < max_len
    quant = cfg.kv_cache_quant == "int8"
    T = window if ring else max_len
    shape = (batch, T, kv, hd)
    axes = ("batch", "seq", "kv_heads", "head_dim")
    kv_dtype = torch.int8 if quant else dtype
    out = {"k": (shape, axes, kv_dtype), "v": (shape, axes, kv_dtype)}
    if quant:
        out["k_scale"] = ((batch, T, kv), ("batch", "seq", "kv_heads"),
                          torch.float32)
        out["v_scale"] = ((batch, T, kv), ("batch", "seq", "kv_heads"),
                          torch.float32)
    if ring:
        out["pos"] = ((batch, T), ("batch", "seq"), torch.int32)
    return out


def init_cache(cfg, batch: int, max_len: int, dtype, *, window: int = 0,
               device="cuda"):
    device = resolve_device(device)
    return {name: torch.full(shape, -1 if name == "pos" else 0, dtype=dt,
                             device=device)
            for name, (shape, _axes, dt) in cache_specs(
                cfg, batch, max_len, dtype, window=window).items()}
