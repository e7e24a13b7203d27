"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) — the
reference's `repro/models/layers/rglru.py` in torch.

Block layout (Griffin "recurrent block"):
    x ── linear ─ conv1d ─ RG-LRU ──┐
    x ── linear ─ GeLU ─────────────┴─ ⊙ ── linear out

RG-LRU:  r_t = σ(W_a x_t + b_a),  i_t = σ(W_x x_t + b_x)
         a_t = exp(-c · softplus(Λ) · r_t)
         h_t = a_t h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t)

The reference runs the prefill recurrence as an associative scan (within
1024-step chunks, a sequential scan across them).  torch has none, so
`linear_scan` runs it in two sequential levels over f32: the recurrence
inside every `SCAN_CHUNK`-step chunk at once from a zero state (one
elementwise step per chunk position), then a carry across the chunks,
h_t = (prod of a over the chunk up to t) * h_in + local_t — the
reference's own chunk-carry formula.  The sums are the same; only their
association differs from the reference's tree, which the tests hold to
1e-4 on the logits.  Decode is the O(1) step, written into the cache
{"conv", "h"} in place.  Plain torch arithmetic: the reference has no
Pallas kernel here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import partitioning as pt
from repro_torch.common.module import ParamSpec
from repro_torch.models.layers.ssm import causal_conv, conv_state

SCAN_CHUNK = 64


def width(cfg):
    return cfg.rglru.width or cfg.d_model


def specs(cfg):
    d = cfg.d_model
    w = width(cfg)
    W = cfg.rglru.conv_width
    return {
        "in_proj_x": ParamSpec((d, w), ("embed", "state"), init="scaled_normal", scale=1.0),
        "in_proj_gate": ParamSpec((d, w), ("embed", "state"), init="scaled_normal", scale=1.0),
        "conv_w": ParamSpec((W, w), (None, "state"), init="scaled_normal", scale=1.0),
        "conv_b": ParamSpec((w,), ("state",), init="zeros"),
        "wa": ParamSpec((w, w), ("state", None), init="scaled_normal", scale=1.0),
        "ba": ParamSpec((w,), ("state",), init="zeros"),
        "wx": ParamSpec((w, w), ("state", None), init="scaled_normal", scale=1.0),
        "bx": ParamSpec((w,), ("state",), init="zeros"),
        "lam": ParamSpec((w,), ("state",), init="rglru_lambda"),
        "out_proj": ParamSpec((w, d), ("state", "embed"), init="scaled_normal", scale=1.0),
    }


def _affine(x, w, b):
    """x @ w + b.  On a mesh the product's partial sums over `state` are
    reduced before the bias is added: torch 2.11's DTensor cannot add a
    sharded bias to a partial sum."""
    y = torch.matmul(x, w)
    if pt.is_dtensor(y):
        from torch.distributed.tensor import Partial, Replicate
        y = pt.with_placements(y, [Replicate() if isinstance(p, Partial)
                                   else p for p in y.placements])
    return y + b


def _gates(params, cfg, xb):
    xf = xb.float()
    r = torch.sigmoid(_affine(xf, params["wa"].float(), params["ba"].float()))
    i = torch.sigmoid(_affine(xf, params["wx"].float(), params["bx"].float()))
    log_a = -cfg.rglru.c_exponent * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, b


def linear_scan(a, b, chunk: int = SCAN_CHUNK):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, over axis 1 of (B, L, w)
    f32 tensors -> h (B, L, w)."""
    if pt.is_dtensor(a):
        return _scan_meshed(a, b, chunk)
    B, L, w = a.shape
    c = min(chunk, L)
    pad = (c - L % c) % c
    if pad:       # a = 1, b = 0 past the end carry the state unchanged
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    nc = a.shape[1] // c
    ac = a.reshape(B, nc, c, w)
    bc = b.reshape(B, nc, c, w)
    local = [bc[:, :, 0]]
    for i in range(1, c):            # every chunk at once, from a zero state
        local.append(ac[:, :, i] * local[-1] + bc[:, :, i])
    local = torch.stack(local, dim=2)                      # (B, nc, c, w)
    a_pre = torch.cumprod(ac, dim=2)
    out, h = [], torch.zeros((B, w), dtype=a.dtype, device=a.device)
    for j in range(nc):              # the carry across chunks
        blk = a_pre[:, j] * h[:, None] + local[:, j]
        out.append(blk)
        h = blk[:, -1]
    return torch.cat(out, dim=1)[:, :L]


def _scan_meshed(a, b, chunk: int):
    """`linear_scan` on DTensors under `local_map`: the scan is independent
    across batch rows and channels, so each rank scans its batch shard of
    its `model` shard of the channels (torch 2.11's DTensor has no
    strategy for the scan's cumprod)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = a.device_mesh
    rows = pt.batch_axes_placements(mesh, a.shape[0], 0)
    pl = [Shard(2) if name == "model" and a.shape[2] % mesh.size(i) == 0
          else rows[i] for i, name in enumerate(mesh.mesh_dim_names)]
    return local_map(lambda a, b: linear_scan(a, b, chunk),
                     out_placements=pl, in_placements=(pl, pl),
                     device_mesh=mesh)(pt.with_placements(a, pl),
                                       pt.with_placements(b, pl))


def apply(params, cfg, x, *, mode: str = "train", cache=None,
          return_cache: bool = False):
    """x: (B,L,d); cache = {"conv": (B,W-1,w), "h": (B,w)}, updated in
    place in decode mode."""
    dt_ = x.dtype
    B_, L, d = x.shape
    W = cfg.rglru.conv_width

    xb = torch.matmul(x, params["in_proj_x"].to(dt_))
    gate = torch.matmul(x, params["in_proj_gate"].to(dt_))

    if mode == "decode":
        window = torch.cat([cache["conv"].to(dt_), xb], dim=1)
        conv_out = (window * params["conv_w"].to(dt_)).sum(1, keepdim=True)
        conv_out = conv_out + params["conv_b"].to(dt_)
        a, b = _gates(params, cfg, conv_out)
        h = a[:, 0] * cache["h"].float() + b[:, 0]
        y = h[:, None]
        cache["conv"].copy_(window[:, 1:])
        cache["h"].copy_(h)
        new_cache = cache
    else:
        conv_out = causal_conv(xb, params["conv_w"].to(dt_),
                               params["conv_b"].to(dt_))
        a, b = _gates(params, cfg, conv_out)
        if mode == "prefill" and cache is not None:
            # fold the incoming state into the first step
            b = torch.cat([b[:, :1] + a[:, :1] * cache["h"].float()[:, None],
                           b[:, 1:]], dim=1)
        h_seq = linear_scan(a, b)
        y = h_seq
        new_cache = None
        if return_cache:
            new_cache = {"conv": conv_state(xb, W).to(dt_),
                         "h": h_seq[:, -1].to(dt_)}

    y = y.to(dt_) * F.gelu(gate, approximate="tanh")   # jax.nn.gelu's
    out = torch.matmul(y, params["out_proj"].to(dt_))
    return out, new_cache


def cache_specs(cfg, batch: int, dtype):
    w = width(cfg)
    return {"conv": ((batch, cfg.rglru.conv_width - 1, w), ("batch", None, "state"), dtype),
            "h": ((batch, w), ("batch", "state"), dtype)}
