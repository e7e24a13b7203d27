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

from repro_torch.common import partitioning as pt
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


def _shards_and_capacity(cfg, T: int):
    """(n, C): the token shards the dispatch ranks T tokens within, and
    each shard's capacity per expert."""
    m = cfg.moe
    if m.dispatch == "local":
        n = max(1, m.local_shards)
        if T % n:
            raise ValueError(f"{T} tokens do not split into {n} shards")
        return n, max(8, _capacity(cfg, T // n))
    return 1, _capacity(cfg, T)


def _block_layout(axes, E: int, n: int, C: int):
    """(El, Cl, own) of the meshed dispatch on a mesh of `axes` (a
    `pt.MeshShape`): the shape of a rank's block of the (E, n * C) expert
    buffer — the experts split over `model` where it divides them, the
    capacity over the batch axes where they divide it — and whether a
    rank's own tokens fill its capacity slice alone (n a multiple of the
    batch ranks)."""
    batch = 1
    for a in axes.axis_names:
        if a in pt.BATCH_AXES:
            batch *= axes.shape[a]
    model = axes.shape.get("model", 1)
    El = E // model if E % model == 0 else E
    Cl = n * C // batch if n * C % batch == 0 else n * C
    return El, Cl, n % batch == 0


def dispatch_rank_bytes(cfg, tokens: int, axes) -> int:
    """Bytes one rank holds for one MoE layer's meshed dispatch of `tokens`
    tokens on a mesh of `axes`: its block of the expert buffer and, where
    its own tokens do not fill the block, the (tokens, d) tokens gathered
    over the batch axes; in the compute dtype."""
    n, C = _shards_and_capacity(cfg, tokens)
    El, Cl, own = _block_layout(axes, cfg.moe.num_experts, n, C)
    rows = El * Cl + (0 if own else tokens)
    return rows * cfg.d_model * torch.empty((), dtype=cfg.cdtype
                                            ).element_size()


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


def _plan(sel, E: int, C: int):
    """(keep, flat) of every routed slot: sel (n, T_loc * K) expert ids ->
    keep (n, T_loc * K), the slots ranked below the capacity C within
    their expert and shard, and flat (n, T_loc * K), each slot's row in
    the (n * E * C, d) buffer (a dropped slot points at its expert's row
    0 and adds nothing)."""
    n = sel.shape[0]
    pos = _rank_in_expert(sel, E)
    keep = pos < C
    slot = sel * C + torch.where(keep, pos, torch.zeros_like(pos))
    base = torch.arange(n, device=sel.device)[:, None] * (E * C)
    return keep, slot + base


def _scatter(xs, keep, flat, *, K: int, E: int, C: int, n: int):
    """The (E, n * C, d) expert-major buffer of the tokens xs (..., d)
    whose K routed slots are keep/flat (..., with K per token, token-major)
    — all n shards' rows, zero where no kept slot lands."""
    d = xs.shape[-1]
    xk = xs.reshape(-1, d).repeat_interleave(K, dim=0)        # (T_l*K, d)
    keep = keep.reshape(-1, 1)
    contrib = torch.where(keep, xk, torch.zeros_like(xk))
    buf = torch.zeros((n * E * C, d), dtype=xs.dtype, device=xs.device)
    buf.index_add_(0, flat.reshape(-1), contrib)
    return buf.reshape(n, E, C, d).transpose(0, 1).reshape(E, n * C, d)


def _combine(out_e, flat, gates, keep, *, K: int, n: int):
    """Each routed slot's expert output, gate-weighted and summed over the
    token's K slots: out_e (E, n * C, d), flat/gates/keep (..., K per
    token, token-major) -> (T_l, d)."""
    E, nC, d = out_e.shape
    out = out_e.reshape(E, n, nC // n, d).transpose(0, 1).reshape(-1, d)
    yk = out[flat.reshape(-1)]
    yk = yk * (gates.reshape(-1, 1) * keep.reshape(-1, 1)).to(out.dtype)
    return yk.reshape(-1, K, d).sum(1)


def _dispatch(params, cfg, xt, gates, sel, n: int, C: int):
    """Capacity-bounded dispatch within each of n token shards.  xt (T,
    d), gates and sel (T, K) -> (y (T, d), keep (n, T / n * K)).  The (n,
    E, C, d) buffers go to the experts as one (E, n * C, d) batch, as the
    reference's data-major -> expert-major exchange."""
    if pt.is_dtensor(xt):
        return _dispatch_meshed(params, cfg, xt, gates, sel, n, C)
    m = cfg.moe
    E, K = m.num_experts, m.experts_per_token
    keep, flat = _plan(sel.reshape(n, -1), E, C)
    buf_e = _scatter(xt, keep, flat, K=K, E=E, C=C, n=n)
    out_e = _expert_ffn(params, cfg, buf_e)
    return _combine(out_e, flat, gates, keep, K=K, n=n), keep


def _block_slots(keep, flat, *, E: int, C: int, e0: int, El: int,
                 c0: int, Cl: int):
    """The routed slot of each row of one block of the (E, n * C)
    expert-major buffer — experts [e0, e0 + El), rows [c0, c0 + Cl) — as
    an index into the flattened (T, K) slots of keep/flat (flat's rows
    counted from the block's first shard); T * K where no kept slot lands.
    (El * Cl,) int64.  Every kept slot has a row of its own, so only the
    spare last entry, which is cut, is written more than once."""
    f = flat.reshape(-1)
    slots = f.numel()
    shard, rem = f // (E * C), f % (E * C)
    e, q = rem // C - e0, shard * C + rem % C - c0
    mine = keep.reshape(-1) & (e >= 0) & (e < El) & (q >= 0) & (q < Cl)
    row = torch.where(mine, e * Cl + q, torch.full_like(e, El * Cl))
    inv = torch.full((El * Cl + 1,), slots, dtype=torch.long,
                     device=f.device)
    inv.scatter_(0, row, torch.arange(slots, device=f.device))
    return inv[:-1]


def _gather_block(xs, inv, *, K: int, El: int, Cl: int):
    """The (El, Cl, d) block of the expert buffer: each row the token
    (xs (T, d), K slots a token) of its slot, zero where none lands."""
    d = xs.shape[-1]
    src = torch.cat([xs.reshape(-1, d), xs.new_zeros((1, d))])
    return src[inv // K].reshape(El, Cl, d)


def _combine_block(out_b, inv, gates, *, K: int, T: int):
    """One block's share of y (T, d): each row's expert output (out_b
    (El, Cl, d)) gate-weighted and added to its token."""
    d = out_b.shape[-1]
    g = torch.cat([gates.reshape(-1), gates.new_zeros((1,))])[inv]
    yk = out_b.reshape(-1, d) * g[:, None].to(out_b.dtype)
    y = out_b.new_zeros((T + 1, d)).index_add_(0, inv // K, yk)
    return y[:T]


def _dispatch_meshed(params, cfg, xt, gates, sel, n: int, C: int):
    """`_dispatch` on DTensors (a meshed step).  The reference's
    shard_constraints become redistributes: the tokens on the batch axes,
    and the (E, n * C, d) expert buffer with `experts` on `model` and
    `expert_cap` on the batch axes (`want`), before and after the expert
    products (which run as DTensor ops).  No rank holds the whole buffer:
    each fills and reads only its own (El, Cl, d) block of it.  DTensor has
    no sharding strategy for the dispatch's one-hot cumsum ranks, the row
    gather and the `index_add_`, so three regions run under `local_map`:

      plan     the slots' ranks within their expert and shard;
      gather   a rank's block, each row gathered from its slot's token;
      combine  a rank's share of y: its block's rows, gate-weighted and
               added to their tokens, Partial over the mesh dims that
               split the buffer, then reduced into the tokens' layout.

    Two layouts, fixed by the shapes.  Local dispatch with the n shards a
    multiple of the batch ranks: a rank's slice of `expert_cap` is the
    capacity of its own shards, so plan and gather read only its own tokens
    and y is Partial over `model` alone.  Otherwise (the global dispatch):
    a slot's capacity row depends on every earlier token, so every rank
    ranks every slot (the (T, K) expert ids gathered; the (T * K, E)
    one-hot as on one device) and gathers its block from the tokens
    gathered over the batch axes, (T, d) on every rank; y's shares are
    reduce-scattered.  A rank holds its block, the E * n * C * d buffer
    divided over the ranks that split it (the reference's layout), and in
    the global dispatch the (T, d) tokens too, where the reference's XLA
    exchanges all-to-all (`dispatch_rank_bytes`).

    The token dim stays whole (T, ...) outside the regions: each region
    reshapes its local rows, so no DTensor view splits a sharded dim.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    m = cfg.moe
    mesh = xt.device_mesh
    T, K = sel.shape
    E, d = m.num_experts, xt.shape[-1]
    rep = [Replicate()] * mesh.ndim
    tok = pt.batch_axes_placements(mesh, T, 0)
    cap = pt.batch_axes_placements(mesh, n * C, 1)
    want = [Shard(0) if name == "model" and E % mesh.size(i) == 0
            else cap[i] for i, name in enumerate(mesh.mesh_dim_names)]
    (El, Cl, _), (e0, c0, _) = pt.local_shape_and_offset((E, n * C, d),
                                                         mesh, want)
    own = _block_layout(pt.mesh_axes(mesh), E, n, C)[2]
    # the mesh dims whose ranks hold different blocks: their shares sum
    split = [Partial() if isinstance(w, Shard) else Replicate()
             for w in want]

    if own:         # a rank's tokens fill its slice of expert_cap alone
        src_pl, n_loc, c0 = tok, Cl // C, 0
        grad_pl = [t if isinstance(t, Shard) else s
                   for t, s in zip(tok, split)]
    else:
        src_pl, grad_pl, n_loc = rep, split, n

    def plan(sel):
        keep, flat = _plan(sel.reshape(n_loc, -1), E, C)
        return keep.reshape(-1, K), flat.reshape(-1, K)

    keep, flat = local_map(plan, out_placements=(src_pl, src_pl),
                           in_placements=(src_pl,), device_mesh=mesh)(
        pt.with_placements(sel, src_pl))
    xs, gs = (pt.with_placements(t, src_pl) for t in (xt, gates))
    blk = dict(E=E, C=C, e0=e0, El=El, c0=c0, Cl=Cl)

    def gather(xs, keep, flat):
        return _gather_block(xs, _block_slots(keep, flat, **blk), K=K,
                             El=El, Cl=Cl)

    buf_e = local_map(gather, out_placements=want,
                      in_placements=(src_pl, src_pl, src_pl),
                      in_grad_placements=(grad_pl, src_pl, src_pl),
                      device_mesh=mesh)(xs, keep, flat)
    out_e = pt.with_placements(_expert_ffn(params, cfg, buf_e), want)

    def combine(out_b, keep, flat, gates):
        return _combine_block(out_b, _block_slots(keep, flat, **blk), gates,
                              K=K, T=keep.shape[0])

    y = local_map(combine, out_placements=grad_pl,
                  in_placements=(want, src_pl, src_pl, src_pl),
                  in_grad_placements=(want, src_pl, src_pl, grad_pl),
                  device_mesh=mesh)(out_e, keep, flat, gs)
    return pt.with_placements(y, tok), keep


def apply(params, cfg, x):
    """x: (B,S,d) -> (y (B,S,d), aux values dict)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.num_experts, m.experts_per_token
    if pt.is_dtensor(x):        # the tokens on the batch axes, as the
        x = pt.with_placements(  # reference's constraint of xs
            x, pt.batch_axes_placements(x.device_mesh, B, 0))
    xt = x.reshape(T, d)

    # router in f32 for a stable softmax
    logits = torch.matmul(xt.float(), params["router"].float())
    probs, gate_vals, sel = route(logits, K)

    # aux values: switch-transformer load balance + router z-loss
    me = probs.mean(0)
    if pt.is_dtensor(sel):      # counts of a one-hot (no index_add_ strategy)
        ce = (sel.reshape(-1)[:, None] == torch.arange(E, device=x.device)
              ).float().sum(0) / (T * K)
    else:
        ce = torch.zeros((E,), dtype=torch.float32,
                         device=x.device).index_add_(
            0, sel.reshape(-1), torch.ones((T * K,), device=x.device)) \
            / (T * K)
    lb_loss = E * torch.sum(me * ce) * m.load_balance_coef
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_coef

    n, C = _shards_and_capacity(cfg, T)
    y, keep = _dispatch(params, cfg, xt, gate_vals, sel, n, C)
    if m.num_shared_experts:
        y = y + mlp.apply(params["shared"], cfg, xt)

    aux = {"moe_load_balance": lb_loss, "moe_router_z": z_loss,
           "moe_drop_fraction": 1.0 - keep.float().mean()}
    return y.reshape(B, S, d), aux
