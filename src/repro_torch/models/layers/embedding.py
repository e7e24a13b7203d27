"""Token embedding + (optionally tied) output head."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import partitioning as pt
from repro_torch.common.module import ParamSpec


def specs(cfg):
    s = {"table": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                            init="normal", scale=0.02)}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                                 init="scaled_normal", scale=1.0)
    return s


def embed(params, cfg, tokens):
    # clip (not NaN-fill) on out-of-range ids, as the reference's
    # `jnp.take(mode="clip")`: tokenizer/vocab mismatches should degrade,
    # not poison the whole forward.
    table = params["table"]
    ids = tokens.long().clamp(0, table.shape[0] - 1)
    if pt.is_dtensor(table):
        return _embed_meshed(table, ids).to(cfg.cdtype)
    return table[ids].to(cfg.cdtype)


def _embed_meshed(table, ids):
    """The lookup on a meshed step, as tensor parallelism runs it: each
    rank looks its batch rows up in its vocab shard (zeros for ids outside
    it) under `local_map`, and the ranks' rows are summed over the vocab's
    mesh dims (a new leading dim, summed as a DTensor op).  The table's
    `embed` dim (FSDP) is gathered first.  DTensor's own strategies are
    not relied on here: torch 2.11's `index_put` propagation (the index
    lookup's backward) fails on a sharded table, and `embedding`'s masked
    partial output does not mix with plain partial sums."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    table = pt.gather_dims(table, 1)
    rows = pt.batch_axes_placements(mesh, ids.shape[0], 0)
    ids = pt.with_placements(pt.replicated(ids, mesh), rows)
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    lo = pt.local_shape_and_offset(tuple(table.shape), mesh,
                                   table.placements)[1][0]

    def lookup(ids_l, table_l):
        n = table_l.shape[0]
        rel = ids_l - lo
        ok = (rel >= 0) & (rel < n)
        out = F.embedding(rel.clamp(0, n - 1), table_l)
        return (out * ok[..., None].to(out.dtype))[None]

    out_pl = [Shard(0) if v else Shard(1) if isinstance(r, Shard)
              else Replicate() for v, r in zip(vocab, rows)]
    # a rank's table gradient covers its own batch rows: Partial over them
    grad_pl = [p if v else Partial() if isinstance(r, Shard) else p
               for v, r, p in zip(vocab, rows, table.placements)]
    return local_map(lookup, out_placements=out_pl,
                     in_placements=(rows, table.placements),
                     in_grad_placements=(rows, grad_pl),
                     device_mesh=mesh)(ids, table).sum(0)


def logits(params, cfg, x):
    if cfg.tie_embeddings:
        out = torch.matmul(x, params["table"].to(cfg.cdtype).T)
    else:
        out = torch.matmul(x, params["unembed"].to(cfg.cdtype))
    return out.to(getattr(torch, cfg.logits_dtype))
