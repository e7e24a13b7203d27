"""Mixture-of-Experts FFN with capacity-bounded, sort-free dispatch — the
reference's `repro/models/layers/moe.py` in torch.

Dispatch is gather/scatter based: each routed (token, expert) pair takes
its rank within its expert from a one-hot cumsum over the tokens, pairs
ranked at or past the expert's capacity C are dropped, and the kept ones
are scattered into an (E, C, d) buffer that one batched product per
weight runs through the experts.  The capacity comes from the static token
count, so a step reads nothing back to the host (no `.item()`, `nonzero`
or boolean indexing) and the decode step stays one CUDA graph.  Shared
experts (DeepSeek: one always-on), top-k routing on the f32 router with
gates normalised over the k chosen, the switch load-balance and router-z
auxiliary values, and the "local" dispatch (ranking and capacity within
each of `local_shards` token shards) as the reference.  The expert
products are plain torch matmuls: the reference leaves them to XLA and
has no Pallas kernel for them.
"""
from __future__ import annotations

import torch

from repro_torch.common.module import ParamSpec
from repro_torch.common.utils import round_up
from repro_torch.models.layers import mlp


def specs(cfg):
    m = cfg.moe
    d = cfg.d_model
    ff = m.d_ff_expert or cfg.d_ff
    s = {
        "router": ParamSpec((d, m.num_experts), ("embed", None),
                            init="scaled_normal", scale=1.0),
        "wi": ParamSpec((m.num_experts, d, ff), ("experts", "embed", "ff"),
                        init="scaled_normal", scale=1.0),
        "wo": ParamSpec((m.num_experts, ff, d), ("experts", "ff", "embed"),
                        init="scaled_normal", scale=1.0),
    }
    if cfg.mlp_gated:
        s["wg"] = ParamSpec((m.num_experts, d, ff), ("experts", "embed", "ff"),
                            init="scaled_normal", scale=1.0)
    if m.num_shared_experts:
        s["shared"] = mlp.specs(cfg, d_ff=ff * m.num_shared_experts)
    return s


def _capacity(cfg, tokens: int) -> int:
    m = cfg.moe
    cap = int(m.capacity_factor * tokens * m.experts_per_token / m.num_experts)
    return max(8, round_up(cap, 8))


def _expert_ffn(params, cfg, buf):
    """buf (E, C, d) -> (E, C, d) through each expert's MLP."""
    dt = buf.dtype
    h = torch.bmm(buf, params["wi"].to(dt))
    if cfg.mlp_gated:
        h = mlp._act(cfg, torch.bmm(buf, params["wg"].to(dt))) * h
    else:
        h = mlp._act(cfg, h)
    return torch.bmm(h, params["wo"].to(dt))


def route(logits, k: int):
    """Top-k experts of each token by (prob desc, expert asc) — the order
    `jax.lax.top_k` keeps on ties, made explicit (`torch.topk` promises
    none): probs (T, E) f32, gate values (T, k) normalised over the k,
    expert ids (T, k)."""
    probs = torch.softmax(logits, dim=-1)
    vals, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, sel = vals[:, :k], sel[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, sel


def _rank_in_expert(flat_sel, E: int):
    """Rank of each routed slot within its expert, in token order (one-hot
    cumsum over the leading token axis).  flat_sel (..., N) -> (..., N)."""
    oh = (flat_sel[..., None] == torch.arange(E, device=flat_sel.device)
          ).to(torch.int32)
    ranks = torch.cumsum(oh, dim=-2)
    return torch.gather(ranks, -1, flat_sel[..., None])[..., 0] - 1


def _dispatch(params, cfg, xs, gates, sel, C: int):
    """Capacity-bounded dispatch within each of n shards.  xs (n, T_loc,
    d), gates and sel (n, T_loc * K) -> (y (n, T_loc, d), keep (n, T_loc *
    K)).  The (n, E, C, d) buffers go to the experts as one (E, n * C, d)
    batch, as the reference's data-major -> expert-major exchange."""
    m = cfg.moe
    n, T_loc, d = xs.shape
    E, K = m.num_experts, m.experts_per_token
    dt = xs.dtype
    pos = _rank_in_expert(sel, E)                             # (n, T_loc*K)
    keep = pos < C
    slot = sel * C + torch.where(keep, pos, torch.zeros_like(pos))
    xk = xs.repeat_interleave(K, dim=1)                       # (n, T_loc*K, d)
    contrib = torch.where(keep[..., None], xk, torch.zeros_like(xk)).to(dt)
    base = torch.arange(n, device=xs.device)[:, None] * (E * C)
    flat = (slot + base).reshape(-1)
    buf = torch.zeros((n * E * C, d), dtype=dt, device=xs.device)
    buf.index_add_(0, flat, contrib.reshape(-1, d))
    buf_e = buf.reshape(n, E, C, d).transpose(0, 1).reshape(E, n * C, d)
    out_e = _expert_ffn(params, cfg, buf_e)
    out = out_e.reshape(E, n, C, d).transpose(0, 1).reshape(n * E * C, d)
    yk = out[flat].reshape(n, T_loc * K, d)
    yk = yk * (gates[..., None] * keep[..., None]).to(dt)
    return yk.reshape(n, T_loc, K, d).sum(2), keep


def apply(params, cfg, x):
    """x: (B,S,d) -> (y (B,S,d), aux values dict)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.num_experts, m.experts_per_token
    xt = x.reshape(T, d)

    # router in f32 for a stable softmax
    logits = torch.matmul(xt.float(), params["router"].float())
    probs, gate_vals, sel = route(logits, K)

    # aux values: switch-transformer load balance + router z-loss
    me = probs.mean(0)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, sel.reshape(-1), torch.ones((T * K,), device=x.device)) / (T * K)
    lb_loss = E * torch.sum(me * ce) * m.load_balance_coef
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_coef

    if m.dispatch == "local":
        n = max(1, m.local_shards)
        if T % n:
            raise ValueError(f"{T} tokens do not split into {n} shards")
        C = max(8, _capacity(cfg, T // n))
    else:
        n, C = 1, _capacity(cfg, T)
    y, keep = _dispatch(params, cfg, xt.reshape(n, T // n, d),
                        gate_vals.reshape(n, -1), sel.reshape(n, -1), C)
    y = y.reshape(T, d)
    if m.num_shared_experts:
        y = y + mlp.apply(params["shared"], cfg, xt)

    aux = {"moe_load_balance": lb_loss, "moe_router_z": z_loss,
           "moe_drop_fraction": 1.0 - keep.float().mean()}
    return y.reshape(B, S, d), aux
