"""BM25 keyword index over fixed-width hashed-term rows (DESIGN.md §3).

Terms hash into a fixed id space and documents are fixed-width padded id
rows, so scoring a query against the whole corpus is a dense vectorised
comparison — tf(t, d) = #{j : doc_ids[d, j] == t} — with no inverted lists
to chase.  Ranking semantics match textbook BM25 up to hash collisions.

Storage is a preallocated capacity-doubling row block (like VectorIndex).
The device copies of the doc block and lengths are capacity-padded tensors
updated in place on append and compaction; they are re-uploaded only when
the capacity doubles or a snapshot is loaded.

Multi-tenant: documents carry a namespace tag, and scoring can be scoped
to one namespace — df, N and avg_len then come from that namespace's live
documents only, so a scoped query ranks exactly as it would against an
isolated per-tenant index.  `topk_batch_dev` scores a whole batch of
scoped queries against the corpus in one pass with a per-query selection
mask.  Ties rank the lower doc id first, as the reference's `lax.top_k`
does (`torch.topk` promises no tie order, so `topk_lowest_index` fixes it).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.common.utils import (next_pow2, resolve_device, to_device,
                                      upload)
from repro_torch.data.tokenizer import HashTokenizer, default_tokenizer
from repro_torch.obs.telemetry import NULL_SUMMED, get_telemetry


def topk_lowest_index(x: torch.Tensor, k: int):
    """Row-wise top-k of `x` (B, N) ranked by (value desc, index asc), the
    tie order of `lax.top_k`.  Returns (values (B, k), indices (B, k)
    int64).  `torch.topk` finds the k-th value v; every entry above v is
    taken, then the lowest-index entries equal to v fill the rest."""
    B, N = x.shape
    v = torch.topk(x, k, dim=1, sorted=True).values[:, -1:]
    above = x > v
    tied = x == v
    need = k - above.sum(dim=1, keepdim=True)
    take = above | (tied & (torch.cumsum(tied, dim=1) <= need))
    # ascending-index compaction of the k taken entries per row
    slot = torch.where(take, torch.cumsum(take, dim=1) - 1, k)
    idx = torch.zeros((B, k + 1), dtype=torch.int64, device=x.device)
    idx.scatter_(1, slot, torch.arange(N, device=x.device).expand(B, N))
    idx = idx[:, :k]
    vals = x.gather(1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


class BM25Index:
    def __init__(self, k1: float = 1.5, b: float = 0.75, max_doc_len: int = 32,
                 tokenizer: HashTokenizer | None = None, capacity: int = 256,
                 device="cuda"):
        self.k1 = k1
        self.b = b
        self.max_doc_len = max_doc_len
        self.tokenizer = tokenizer or default_tokenizer()
        self.device = resolve_device(device)
        self.n = 0
        self._docs = np.full((capacity, max_doc_len), -1, np.int32)
        self._lens = np.ones((capacity,), np.float32)
        self._ns = np.full((capacity,), -1, np.int32)   # -1 == untagged
        self._alive = np.zeros((capacity,), bool)
        # capacity-padded device copies (uploaded once per capacity, then
        # updated in place)
        self._docs_dev = None
        self._lens_dev = None

    # -- storage -----------------------------------------------------------
    def _grow(self, m: int) -> None:
        need = self.n + m
        cap = self._docs.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        docs = np.full((cap, self.max_doc_len), -1, np.int32)
        docs[: self.n] = self._docs[: self.n]
        lens = np.ones((cap,), np.float32)
        lens[: self.n] = self._lens[: self.n]
        ns = np.full((cap,), -1, np.int32)
        ns[: self.n] = self._ns[: self.n]
        alive = np.zeros((cap,), bool)
        alive[: self.n] = self._alive[: self.n]
        self._docs, self._lens, self._ns, self._alive = docs, lens, ns, alive
        self._invalidate_device()         # re-upload once per doubling

    def _invalidate_device(self) -> None:
        self._docs_dev = None
        self._lens_dev = None

    def add(self, texts: Sequence[str],
            namespace: Union[int, Sequence[int], None] = None) -> List[int]:
        """Append documents; `namespace` is one tag for the whole call or a
        per-document sequence (the batched multi-tenant ingest path)."""
        m = len(texts)
        if np.ndim(namespace) == 0:
            ns_per_doc = [(-1 if namespace is None else int(namespace))] * m
        else:
            ns_per_doc = [int(x) for x in namespace]
            if len(ns_per_doc) != m:
                raise ValueError(
                    f"{len(ns_per_doc)} namespace tags for {m} documents")
        self._grow(m)
        n0 = self.n
        for t, ns in zip(texts, ns_per_doc):
            tok = self.tokenizer.encode(t)[: self.max_doc_len]
            i = self.n
            self._docs[i] = -1
            self._docs[i, : len(tok)] = tok
            self._lens[i] = max(1, len(tok))
            self._ns[i] = ns
            self._alive[i] = True
            self.n += 1
        if m and self._docs_dev is not None:
            self._docs_dev[n0: n0 + m] = torch.from_numpy(
                self._docs[n0: n0 + m]).to(self.device)
            self._lens_dev[n0: n0 + m] = torch.from_numpy(
                self._lens[n0: n0 + m]).to(self.device)
        return list(range(n0, self.n))

    def remove(self, ids: Sequence[int]) -> int:
        """Tombstone documents by id.  Returns #newly removed."""
        removed = 0
        for i in ids:
            i = int(i)
            if 0 <= i < self.n and self._alive[i]:
                self._alive[i] = False
                removed += 1
        return removed

    def compact(self) -> np.ndarray:
        """Physically drop tombstoned documents.  Returns the old→new id
        mapping as an (n_old,) int64 array (-1 for dropped docs); the kept
        docs keep their relative order.  Capacity is sticky and the device
        copies are repacked in place."""
        n_old = self.n
        alive = self._alive[:n_old]
        old_to_new = np.full((n_old,), -1, np.int64)
        keep = np.where(alive)[0]
        old_to_new[keep] = np.arange(keep.size)
        n_new = int(keep.size)
        cap = self._docs.shape[0]
        docs = np.full((cap, self.max_doc_len), -1, np.int32)
        docs[:n_new] = self._docs[keep]
        lens = np.ones((cap,), np.float32)
        lens[:n_new] = self._lens[keep]
        ns = np.full((cap,), -1, np.int32)
        ns[:n_new] = self._ns[keep]
        alive_new = np.zeros((cap,), bool)
        alive_new[:n_new] = True
        self._docs, self._lens, self._ns, self._alive = \
            docs, lens, ns, alive_new
        self.n = n_new
        if self._docs_dev is not None:
            gather = torch.from_numpy(keep).to(self.device)
            self._docs_dev[:n_new] = self._docs_dev.index_select(0, gather)
            self._lens_dev[:n_new] = self._lens_dev.index_select(0, gather)
            self._docs_dev[n_new:] = -1
            self._lens_dev[n_new:] = 1.0
        return old_to_new

    # -- snapshot surface (see core/store.py) ------------------------------
    def doc_array(self) -> np.ndarray:
        return self._docs[: self.n].copy()

    def len_array(self) -> np.ndarray:
        return self._lens[: self.n].copy()

    def ns_array(self) -> np.ndarray:
        return self._ns[: self.n].copy()

    def alive_array(self) -> np.ndarray:
        return self._alive[: self.n].copy()

    def load_rows(self, docs, lens, ns, alive) -> None:
        """Bulk-load a snapshot's rows (replaces any current content)."""
        docs = np.asarray(docs, np.int32)
        n = docs.shape[0]
        if docs.shape[1] != self.max_doc_len:
            raise ValueError(f"doc width {docs.shape[1]} != "
                             f"max_doc_len {self.max_doc_len}")
        cap = max(64, next_pow2(n))
        self._docs = np.full((cap, self.max_doc_len), -1, np.int32)
        self._lens = np.ones((cap,), np.float32)
        self._ns = np.full((cap,), -1, np.int32)
        self._alive = np.zeros((cap,), bool)
        self._docs[:n] = docs
        self._lens[:n] = np.asarray(lens, np.float32)
        self._ns[:n] = np.asarray(ns, np.int32)
        self._alive[:n] = np.asarray(alive, bool)
        self.n = n
        self._invalidate_device()

    def __len__(self):
        return self.n

    @property
    def alive_count(self) -> int:
        return int(self._alive[: self.n].sum())

    def _arrays(self):
        """Capacity-padded device tensors — uploaded once per capacity
        (first query, or after grow/load), then updated in place."""
        if self._docs_dev is None:
            self._docs_dev = to_device(self._docs, self.device)
            self._lens_dev = to_device(self._lens, self.device)
        return self._docs_dev, self._lens_dev

    def _selection(self, namespace: Optional[int]) -> np.ndarray:
        """(N,) bool: live docs, restricted to `namespace` when given."""
        sel = self._alive[: self.n].copy()
        if namespace is not None:
            sel &= self._ns[: self.n] == int(namespace)
        return sel

    # -- scoring -----------------------------------------------------------
    def scores(self, query: str, namespace: Optional[int] = None
               ) -> torch.Tensor:
        """BM25 scores over all docs -> (N,) f32 (empty -> (0,)).  Docs
        outside the selection score 0; corpus statistics (N, df, avg_len)
        come from the selection only."""
        if self.n == 0:
            return torch.zeros((0,), device=self.device)
        sel = self._selection(namespace)
        return self._scores_batch([self._terms(query)],
                                  sel[None])[0][: self.n]

    def _terms(self, query: str) -> List[int]:
        return list(dict.fromkeys(self.tokenizer.encode(query)))

    def _scores_batch(self, term_lists: Sequence[List[int]],
                      sels: np.ndarray, sel_dev=None,
                      score=NULL_SUMMED) -> torch.Tensor:
        """Stacked scoring: B scoped queries against the whole corpus ->
        (B, capacity) f32 (unfilled/unselected slots score 0).  `sels` is
        the (B, n) per-query selection over the filled prefix; `sel_dev`
        optionally passes its capacity-padded device copy.  Term
        frequencies are counted once over the union of all query terms (one
        scatter over the doc block); df/idf/avg_len stay per query, over
        each query's own selection.  The f32 arithmetic follows the
        reference expression by expression; the per-term sum runs in term
        order.  The term statistics are the `sparse.stats` span, the sum a
        part of `score` (`topk_batch_dev`'s `sparse.score`)."""
        B = len(term_lists)
        N = self.n
        if N == 0:
            return torch.zeros((B, 0), device=self.device)
        cap = self._docs.shape[0]
        with get_telemetry().span("sparse.stats"):
            stats = self._term_stats(term_lists, sels, sel_dev)
        if stats is None:
            return torch.zeros((B, cap), device=self.device)
        tf_u, idx_dev, idf_dev, norm, sel_dev, n_sel = stats
        with score.part():
            out = torch.zeros((B, cap), device=self.device)
            for t in range(idx_dev.shape[1]):
                G = tf_u[idx_dev[:, t]]
                out = out + (idf_dev[:, t, None] * G * (self.k1 + 1.0)
                             / (G + norm))
            # a copy from pageable memory waits for the stream: the sum's
            # kernels finish inside this part
            row_live = upload(np.asarray(
                [bool(term_lists[b]) and bool(n_sel[b]) for b in range(B)]),
                self.device)[:, None]
            return torch.where(sel_dev & row_live, out, torch.zeros_like(out))

    def _term_stats(self, term_lists, sels, sel_dev):
        """The batch's term statistics: tf over the union of its terms
        (one scatter over the doc block), each query's df over its own
        selection (read to the host: the batch's one device sync), avg_len
        and idf -> (tf_u, idx_dev, idf_dev, norm, sel_dev, n_sel), or None
        when no query has both terms and a selection."""
        B = len(term_lists)
        N = self.n
        docs, lens = self._arrays()                        # (cap, L), (cap,)
        cap = self._docs.shape[0]
        if sel_dev is None:
            sel_pad = np.zeros((B, cap), bool)
            sel_pad[:, :N] = sels
            sel_dev = upload(sel_pad, self.device)
        n_sel = sels.sum(axis=1)                                  # (B,)
        union = list(dict.fromkeys(t for ts in term_lists for t in ts))
        live = [b for b in range(B) if term_lists[b] and n_sel[b]]
        if not union or not live:
            return None
        uidx = {t: i for i, t in enumerate(union)}
        U = len(union)
        T = max(len(ts) for ts in term_lists)
        idx = np.zeros((B, T), np.int64)
        valid = np.zeros((B, T), np.float32)
        for b, ts in enumerate(term_lists):
            idx[b, : len(ts)] = [uidx[t] for t in ts]
            valid[b, : len(ts)] = 1.0
        # tf over the union, once for the whole batch: (U + 1, cap), the
        # last row collecting padding and non-query terms
        V = self.tokenizer.vocab_size
        lut = torch.full((V + 1,), U, dtype=torch.int64, device=self.device)
        lut[upload(union, self.device, torch.int64)] = \
            torch.arange(U, device=self.device)
        col = lut[torch.where((docs >= 0) & (docs < V), docs, V).long()].T
        tf_u = torch.zeros((U + 1, cap), device=self.device)
        tf_u.scatter_add_(0, col, torch.ones_like(col, dtype=torch.float32))
        idx_dev = upload(idx, self.device)
        # tf_u[idx_dev[:, t]] (B, cap) is query b's t-th term frequency in
        # every doc; per-query df over its selection is the one device
        # sync per batch
        df = torch.stack([((tf_u[idx_dev[:, t]] > 0) & sel_dev).sum(dim=1)
                          for t in range(T)], dim=1)
        df = df.float().cpu().numpy() * valid                    # (B, T)
        lens_np = self._lens[: N]
        avg = np.asarray([float(lens_np[sels[b]].mean()) if n_sel[b] else 1.0
                          for b in range(B)], np.float32)
        n_sel_f = n_sel.astype(np.float32)[:, None]
        idf = np.where(df > 0,
                       np.log(1.0 + (n_sel_f - df + 0.5) / (df + 0.5)),
                       0.0).astype(np.float32) * valid
        norm = self.k1 * (1.0 - self.b + self.b * lens[None, :]
                          / upload(avg, self.device)[:, None])
        idf_dev = upload(idf, self.device)
        return tf_u, idx_dev, idf_dev, norm, sel_dev, n_sel

    def topk(self, query: str, k: int, namespace: Optional[int] = None):
        """Top-k (scores, global doc ids), restricted to the selection.
        Variable-length output (<= min(k, selection size))."""
        if self.n == 0:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
        s, ids = self.topk_batch([query], k, namespaces=[namespace])
        m = ids[0] >= 0
        return s[0][m], ids[0][m]

    def topk_batch_dev(self, queries: Sequence[str], k: int,
                       namespaces: Optional[Sequence[Optional[int]]] = None):
        """Batched scoped top-k on the device: one stacked scoring pass and
        one tie-ordered top-k over the selection-masked scores.  Returns
        DEVICE tensors (scores (B, k) f32, ids (B, k) i32); slots beyond a
        query's selection size hold (0, -1).  Ties rank the lower doc id
        first."""
        B = len(queries)
        if B == 0 or self.n == 0:
            return (torch.zeros((B, k), device=self.device),
                    torch.full((B, k), -1, dtype=torch.int32,
                               device=self.device))
        if namespaces is None:
            namespaces = [None] * B
        tel = get_telemetry()
        with tel.summed("sparse.score") as score:
            with tel.span("sparse.select"):
                sels = np.stack([self._selection(ns) for ns in namespaces])
                sel_pad = np.zeros((B, self._docs.shape[0]), bool)
                sel_pad[:, : self.n] = sels
            with tel.span("sparse.upload"):
                sel_dev = upload(sel_pad, self.device)
            S = self._scores_batch([self._terms(q) for q in queries], sels,
                                   sel_dev=sel_dev, score=score)
            with score.part():
                key = torch.where(sel_dev, S,
                                  torch.full_like(S, -float("inf")))
                # k clamps to the capacity, not the doc count: unfilled
                # slots are -inf-masked into (0, -1) anyway
                kk = min(k, self._docs.shape[0])
                s, idx = topk_lowest_index(key, kk)
                live = s > -float("inf")
                s = torch.where(live, s, torch.zeros_like(s))
                idx = torch.where(live, idx, -1).to(torch.int32)
                if kk < k:
                    s = torch.nn.functional.pad(s, (0, k - kk))
                    idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
        return s, idx

    def topk_batch(self, queries: Sequence[str], k: int,
                   namespaces: Optional[Sequence[Optional[int]]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-array wrapper over `topk_batch_dev`."""
        s, idx = self.topk_batch_dev(queries, k, namespaces=namespaces)
        return s.cpu().numpy(), idx.cpu().numpy().astype(np.int64)
