"""Hybrid retrieval: cosine similarity over triple embeddings + BM25 keyword
matching (paper §3.3), fused by weighted reciprocal-rank fusion.

Two implementations of the same contract:

* `rrf_fuse` — the scalar oracle: one query, Python lists, a dict loop.
  Accumulates in float32 so the batched path can match it bit-for-bit.
* `rrf_fuse_batch` — the production path: a whole batch of queries' dense
  and sparse id matrices fused in one pass of tensor ops on the rankings'
  device (rank-position scores, a masked segment-sum over an O(P²)
  id-equality mask, and a lexicographic sort on (-score, id)).  Ordering
  (duplicate-id suppression, -1 padding, score ties broken by lower doc
  id) and float32 scores match `rrf_fuse` exactly.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_INT32_MAX = 2**31 - 1


def rrf_fuse(rankings: Sequence[Sequence[int]], weights: Sequence[float] = None,
             c: float = 60.0) -> List[Tuple[int, float]]:
    """Weighted reciprocal-rank fusion.  rankings: lists of doc ids, best
    first (ids < 0 are padding and ignored).  Returns (doc_id, fused_score)
    sorted descending, ties broken by lower doc id.  Within one ranking only
    a doc's best (first) rank counts.  Scores accumulate in float32: this
    function is the oracle for `rrf_fuse_batch`, which must match it
    exactly."""
    weights = weights or [1.0] * len(rankings)
    scores: Dict[int, np.float32] = {}
    zero = np.float32(0.0)
    for ranking, w in zip(rankings, weights):
        w32 = np.float32(w)
        seen = set()
        for rank, doc in enumerate(ranking):
            doc = int(doc)
            if doc < 0 or doc in seen:
                continue
            seen.add(doc)
            scores[doc] = np.float32(
                scores.get(doc, zero) + w32 / np.float32(c + rank + 1.0))
    return sorted(((d, float(s)) for d, s in scores.items()),
                  key=lambda kv: (-kv[1], kv[0]))


def _rrf_fuse_device(ids, pos, ranking_id, weights, *, k: int, c: float):
    """ids (B, P) i32 concatenated rankings (-1 padding); pos (P,) i32 rank
    within the owning ranking; ranking_id (P,) i64 column -> ranking;
    weights (B, R) f32 per-row ranking weights.  Returns (fused_ids (B, k)
    i32, scores (B, k) f32)."""
    B, P = ids.shape
    dev = ids.device
    valid = ids >= 0                                            # (B, P)
    eq = ids[:, :, None] == ids[:, None, :]                     # (B, P, P)
    earlier = torch.tril(torch.ones((P, P), dtype=torch.bool, device=dev),
                         diagonal=-1)                           # l < j
    same_ranking = ranking_id[:, None] == ranking_id[None, :]
    # within one ranking only the first occurrence of an id scores
    dup = (eq & (earlier & same_ranking)[None]).any(dim=2)
    denom = (torch.tensor(c, dtype=torch.float32, device=dev)
             + pos.to(torch.float32)[None, :] + 1.0)
    contrib = torch.where(valid & ~dup, weights[:, ranking_id] / denom,
                          torch.zeros((), device=dev))          # (B, P)
    # fused[b, j] = sum of contribs at every column holding the same id, a
    # left-fold over the rankings in ranking order.  Each per-ranking term
    # has at most one nonzero per (b, j) and adding exact zeros is the
    # identity, so the float32 rounding sequence is the scalar oracle's.
    eq_f = eq.to(torch.float32)
    fused = torch.zeros((B, P), dtype=torch.float32, device=dev)
    for r in range(weights.shape[1]):
        in_r = (ranking_id == r).to(torch.float32)              # (P,)
        fused = fused + ((contrib * in_r[None, :])[:, None, :] * eq_f).sum(
            dim=2)
    # first concatenated occurrence of each id represents it in the output
    keep = valid & ~(eq & earlier[None]).any(dim=2)
    neg = torch.where(keep, -fused, torch.full_like(fused, float("inf")))
    sort_ids = torch.where(keep, ids, torch.full_like(ids, _INT32_MAX))
    # lexicographic (-score, id): stable sort by the minor key, then by the
    # major key
    o1 = torch.sort(sort_ids, dim=1, stable=True).indices
    o2 = torch.sort(neg.gather(1, o1), dim=1, stable=True).indices
    order = o1.gather(1, o2)
    neg_s = neg.gather(1, order)
    ids_s = torch.where(keep, ids, torch.full_like(ids, -1)).gather(1, order)
    kk = min(k, P)
    live = neg_s[:, :kk] < float("inf")
    return (torch.where(live, ids_s[:, :kk], torch.full_like(ids_s[:, :kk], -1)),
            torch.where(live, -neg_s[:, :kk], torch.zeros((), device=dev)))


def rrf_fuse_batch(rankings, weights=None, c: float = 60.0, k: int = 10):
    """Batched RRF on the rankings' device: `rankings` is a sequence of
    (B, P_i) id matrices (tensors or arrays), best-first along axis 1 with
    -1 padding.  `weights` is one weight per ranking or a (B, R) array
    giving every batch row its own per-ranking weights.  Returns tensors
    (fused_ids (B, k) i32, fused_scores (B, k) f32), -1/0 beyond each row's
    fused pool.  Row b equals `rrf_fuse([rankings[0][b], ...], weights_b,
    c)[:k]` exactly."""
    dev = next((r.device for r in rankings if isinstance(r, torch.Tensor)),
               torch.device("cpu"))
    rankings = [torch.as_tensor(r).to(dev, torch.int32) for r in rankings]
    B = rankings[0].shape[0] if rankings else 0
    P_sizes = [int(r.shape[1]) for r in rankings]
    if not rankings or B == 0 or sum(P_sizes) == 0:
        return (torch.full((B, k), -1, dtype=torch.int32, device=dev),
                torch.zeros((B, k), dtype=torch.float32, device=dev))
    R = len(rankings)
    w = np.asarray([1.0] * R if weights is None else weights, np.float32)
    if w.ndim == 1:
        if w.shape != (R,):
            raise ValueError(f"{w.shape[0]} weights for {R} rankings")
        w = np.broadcast_to(w, (B, R))
    elif w.shape != (B, R):
        raise ValueError(f"weights shape {w.shape} != ({B}, {R})")
    pos = np.concatenate([np.arange(p, dtype=np.int32) for p in P_sizes])
    ranking_id = np.concatenate(
        [np.full((p,), i, np.int64) for i, p in enumerate(P_sizes)])
    fused_ids, fused_scores = _rrf_fuse_device(
        torch.cat(rankings, dim=1), torch.from_numpy(pos).to(dev),
        torch.from_numpy(ranking_id).to(dev),
        torch.from_numpy(np.ascontiguousarray(w)).to(dev), k=k, c=float(c))
    P = sum(P_sizes)
    if P < k:
        fused_ids = torch.nn.functional.pad(fused_ids, (0, k - P), value=-1)
        fused_scores = torch.nn.functional.pad(fused_scores, (0, k - P))
    return fused_ids, fused_scores
