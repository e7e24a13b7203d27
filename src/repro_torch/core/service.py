"""MemoryService — the multi-tenant memory layer on one device.

A deployment serves many (user, conversation) namespaces, and what makes
that affordable is batching: pending queries across tenants are embedded
in one `embed_texts` call and scored in one namespace-masked top-k launch
(kernels/topk_mips.py) against a packed multi-tenant bank, the sparse side
is one stacked (B, N) BM25 scoring pass with per-query namespace masks,
and the dense/sparse rankings fuse in one `rrf_fuse_batch` on the device
(core/hybrid.py).  The bank, its namespace labels and the row count live
on the device (core/vector_index.py), so a steady-state `retrieve_batch`
moves no bank bytes host->device.  Writes batch the same way: `enqueue()`
queues sessions for free and `flush()` ingests everything pending through
one `embed_texts` call and one in-place bank append (`record()` is the
synchronous enqueue-then-flush).

`device="cuda"` (the default) keeps every index on the card and runs the
CUDA top-k kernel; `device="cpu"` runs the same code with the kernel's
plain PyTorch version.  Without a card the default raises.

Ragged batches are padded to the next power-of-two Q bucket (padded
queries carry a never-assigned namespace id and match nothing), and fusion
runs at the pow2 ceiling of the largest requested k; each request is then
sliced to its own k.

Isolation invariants:
  * a triple recorded under namespace A never surfaces for namespace B
    (dense path: kernel mask; sparse path: BM25 per-namespace scoping);
  * `retrieve_batch([(ns, q), ...])` returns results identical to the same
    retrieves issued one by one;
  * tombstoned rows (evict / evict_superseded) never surface again.

The typed surface is core/api.py: `execute()` runs RetrieveRequests
through a `RetrievalPlan` — embed → dense → sparse → fuse → budget, with
dense-only / sparse-only / raw (no-budget) variants.  The graph stage,
durability (policy / data_dir / runtime), the int8 bank, sharding and the
request scheduler arrive with later slices of the port and raise
NotImplementedError here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.utils import next_pow2
from repro_torch.core.api import (RawRetrieval, RetrievalPlan,
                                  RetrieveRequest, as_retrieve_request)
from repro_torch.core.budget import TokenBudgeter
from repro_torch.core.extraction import Extractor, Message
from repro_torch.core.hybrid import rrf_fuse_batch
from repro_torch.core.memory import ANSWER_PROMPT, RetrievedContext, render
from repro_torch.core.store import MemoryStore
from repro_torch.core.summaries import Summary
from repro_torch.core.triples import Triple
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.obs.telemetry import (RECORD_LATENCY, RETRIEVE_LATENCY,
                                       get_telemetry)

_SLICE_GRAPH = "the graph-stage slice (slice 2) of the port"
_SLICE_INT8 = "the int8-bank and tiering slice (slice 3) of the port"
_SLICE_DURABILITY = "the durability slice (slice 4) of the port"
_SLICE_SERVING = "the serving slice (slice 5) of the port"
_SLICE_SHARDING = "the sharding slice (slice 6) of the port"


@dataclasses.dataclass(frozen=True)
class _Resolved:
    """One request's options after plan/service defaults are folded in."""
    k: int
    dense_weight: float
    sparse_weight: float
    dense: bool
    sparse: bool
    budget: bool


class MemoryService:
    def __init__(self, embedder=None, extractor: Optional[Extractor] = None,
                 dim: int = 256, budget: int = 1300, top_k: int = 10,
                 tokenizer: HashTokenizer | None = None,
                 dense_weight: float = 1.0, sparse_weight: float = 0.7,
                 pool: int = 64, flush_every: Optional[int] = None,
                 store: Optional[MemoryStore] = None,
                 plan: Optional[RetrievalPlan] = None, device="cuda",
                 policy=None, data_dir: Optional[str] = None, runtime=None,
                 quantize: str = "none", shards: int = 1, mesh=None):
        if policy is not None or data_dir is not None or runtime is not None:
            raise NotImplementedError(
                f"policy= / data_dir= / runtime= come with {_SLICE_DURABILITY}")
        if quantize != "none":
            raise NotImplementedError(
                f"quantize={quantize!r} comes with {_SLICE_INT8}")
        if shards != 1 or mesh is not None:
            raise NotImplementedError(
                f"shards= / mesh= come with {_SLICE_SHARDING}")
        if store is None:
            if embedder is None:
                raise ValueError("MemoryService needs an embedder or a store")
            store = MemoryStore(embedder, extractor, dim=dim,
                                tokenizer=tokenizer, device=device)
        self.store = store
        self.embedder = store.embedder
        self.extractor = store.extractor
        self.tokenizer = store.tokenizer
        self.budgeter = TokenBudgeter(budget=budget, tokenizer=self.tokenizer)
        self.top_k = top_k
        self.dense_weight = dense_weight
        self.sparse_weight = sparse_weight
        self.pool = pool
        self.flush_every = flush_every
        self.plan = plan or RetrievalPlan()

    # the underlying indices, exposed for tests and benchmarks
    @property
    def vindex(self):
        return self.store.vindex

    @property
    def bm25(self):
        return self.store.bm25

    # -- persistence -------------------------------------------------------
    @classmethod
    def restore(cls, path: str, embedder,
                extractor: Optional[Extractor] = None,
                tokenizer: HashTokenizer | None = None, device="cuda",
                **service_kwargs) -> "MemoryService":
        """Rebuild a service from a version-2 snapshot written by either
        package: the restored service answers `retrieve_batch` identically
        to the one that wrote it."""
        store = MemoryStore.restore(path, embedder, extractor=extractor,
                                    tokenizer=tokenizer, device=device)
        return cls(store=store, **service_kwargs)

    def snapshot(self, path: str) -> int:
        """Flush pending writes, then persist the whole store.  Returns
        bytes written."""
        return self.store.snapshot(path)

    def start_scheduler(self, **kwargs):
        raise NotImplementedError(
            f"the request scheduler comes with {_SLICE_SERVING}")

    # -- tenancy -----------------------------------------------------------
    def namespaces(self) -> List[str]:
        return self.store.namespaces()

    def namespace(self, name: str) -> "NamespaceView":
        return NamespaceView(self, name)

    # -- write path ----------------------------------------------------------
    def record(self, namespace: str, session_id: str,
               messages: Sequence[Message]) -> Tuple[List[Triple], Summary]:
        """Synchronous ingest of one session: enqueue + flush (anything
        else pending is drained in the same batch)."""
        t0 = time.perf_counter()
        out = self.store.ingest(namespace, session_id, messages)
        get_telemetry().observe(
            RECORD_LATENCY, time.perf_counter() - t0,
            help="synchronous record (enqueue + flush) latency")
        return out

    def enqueue(self, namespace: str, session_id: str,
                messages: Sequence[Message],
                conversation_id: Optional[str] = None) -> None:
        """Async ingest: queue the session for the next `flush()`; with
        `flush_every` a count-based flush follows."""
        self.store.enqueue(namespace, session_id, messages,
                           conversation_id=conversation_id)
        if self.flush_every and self.store.pending_count >= self.flush_every:
            self.flush()

    def flush(self) -> int:
        """Drain all pending sessions (all tenants) through one embed call
        and one bank append.  Returns the number of sessions ingested."""
        return len(self.store.flush())

    def compact(self) -> dict:
        """Reclaim tombstoned rows (see MemoryStore.compact)."""
        return self.store.compact()

    # -- read path -------------------------------------------------------------
    def retrieve(self, namespace: str, query: str,
                 top_k: Optional[int] = None, **options) -> RetrievedContext:
        """Single-tenant retrieve.  Extra keyword options (`dense_weight`,
        `sparse_weight`, `stages`) become RetrieveRequest fields."""
        req = RetrieveRequest(namespace=namespace, query=query, top_k=top_k,
                              **options)
        return self.retrieve_batch([req])[0]

    def retrieve_batch(self, requests: Sequence, top_k: Optional[int] = None,
                       plan: Optional[RetrievalPlan] = None) -> List[Any]:
        """Requests -> per-request payloads (RetrievedContext, or
        RawRetrieval for no-budget plans).  Each request is a (namespace,
        query) tuple or a `RetrieveRequest`; `top_k` is the per-request
        default.  Results equal sequential retrieve() calls."""
        reqs = [as_retrieve_request(r, top_k) for r in requests]
        if not reqs:
            return []
        return self.execute(reqs, plan=plan)

    def execute(self, requests: Sequence[RetrieveRequest],
                plan: Optional[RetrievalPlan] = None) -> List[Any]:
        """The retrieval engine: a batch of typed requests through the
        plan's stages in one set of device launches — one embed_texts call,
        one masked top-k launch against the device bank (cached row
        labels), one stacked BM25 scoring pass and one `rrf_fuse_batch`;
        the (B, k) fused ranking crosses to the host in one transfer.
        Reads are read-your-writes: pending sessions are flushed first.
        Per-request options ride inside the shared launches: fusion runs at
        max(top_k) and each row is sliced to its own k; weights form a
        (B, R) matrix; a request excluded from a stage has that ranking's
        ids masked to -1.  Stages a whole batch skips are never launched.
        The batch is padded to the next power-of-two size (padded queries
        carry a never-assigned namespace id and fuse to all -1)."""
        if not requests:
            return []
        tel = get_telemetry()
        t_exec = time.perf_counter()
        plan = plan or self.plan
        reqs = list(requests)
        res = [self._resolve(r, plan) for r in reqs]
        # only the dense search consumes query vectors, so only requests
        # whose stage set includes it are embedded
        dense_rows = [i for i, rr in enumerate(res) if rr.dense]
        with tel.span("plan.embed", batch=len(dense_rows), launches=1):
            qvecs = (self.embedder.embed_texts([reqs[i].query
                                                for i in dense_rows])
                     if dense_rows else None)
        if self.store.pending_count:
            self.flush()
        # reads never allocate tenant state: unknown namespaces stay unknown
        tenants = [self.store.get(r.namespace) for r in reqs]
        vindex = self.store.vindex
        device = vindex.device
        B = len(reqs)
        # fuse at the pow2 ceiling of the largest requested k; each row is
        # then sliced to its own k (the prefix of a wider fusion is the
        # narrower fusion)
        k_fuse = next_pow2(max(r.k for r in res))
        if vindex.n:
            # unknown tenants (and padded queries) get a never-assigned ns
            # id >= 0: they match no bank row and select no document
            unused = self.store.namespace_id_count()
            ns_ids = [t.ns_id if t else unused for t in tenants]
            Bp = next_pow2(B)
            ns_pad = ns_ids + [unused] * (Bp - B)
            q_ns = np.asarray(ns_pad, np.int32)
            rankings, weight_cols = [], []
            if dense_rows:
                with tel.span("plan.dense", batch=Bp, pool=self.pool,
                              launches=1):
                    qv = torch.as_tensor(qvecs, dtype=torch.float32).to(
                        device)
                    qmat = torch.zeros((Bp, qv.shape[1]), dtype=torch.float32,
                                       device=device)
                    qmat[dense_rows] = qv
                    _, dense_ids = vindex.search_batch(qmat, q_ns,
                                                       k=self.pool)
                    dense_ids = self._mask_ranking(
                        dense_ids, [r.dense for r in res], Bp)
                rankings.append(dense_ids)
                weight_cols.append(
                    [r.dense_weight for r in res]
                    + [self.dense_weight] * (Bp - B))
            if any(r.sparse for r in res):
                with tel.span("plan.sparse", batch=Bp, pool=self.pool,
                              launches=1):
                    _, sparse_ids = self.store.bm25.topk_batch_dev(
                        [r.query for r in reqs] + [""] * (Bp - B),
                        k=self.pool, namespaces=ns_pad)
                    sparse_ids = self._mask_ranking(
                        sparse_ids, [r.sparse for r in res], Bp)
                rankings.append(sparse_ids)
                weight_cols.append(
                    [r.sparse_weight for r in res]
                    + [self.sparse_weight] * (Bp - B))
            with tel.span("plan.fuse", batch=Bp, k=k_fuse,
                          rankings=len(rankings), launches=1):
                fused_ids, fused_scores = rrf_fuse_batch(
                    rankings,
                    weights=np.stack(
                        [np.asarray(c, np.float32) for c in weight_cols],
                        axis=1),
                    k=k_fuse)
                fused_ids = fused_ids.cpu().numpy()[:B]
                fused_scores = fused_scores.cpu().numpy()[:B]
        else:
            fused_ids = np.full((B, k_fuse), -1, np.int32)
            fused_scores = np.zeros((B, k_fuse), np.float32)
        out: List[Any] = []
        with tel.span("plan.budget", batch=B):
            for r, (rr, t) in enumerate(zip(res, tenants)):
                # the fused ranking is sorted best-first, so its k_r prefix
                # is the k=k_r fusion of the same inputs
                ids = fused_ids[r][: rr.k]
                scs = fused_scores[r][: rr.k]
                if t is None:
                    if rr.budget:
                        text = render([], [])
                        out.append(RetrievedContext(
                            [], [], text, self.tokenizer.count(text)))
                    else:
                        out.append(RawRetrieval([], [], []))
                    continue
                if rr.budget:
                    scored = [(t.triples.get(self.store.row_tid(int(g))),
                               float(s))
                              for g, s in zip(ids, scs) if g >= 0]
                    ctx = self.budgeter.select(scored, t.summaries)
                    text = render(ctx.triples, ctx.summaries)
                    out.append(RetrievedContext(
                        ctx.triples, ctx.summaries, text,
                        self.tokenizer.count(text)))
                else:
                    rows = [int(g) for g in ids if g >= 0]
                    out.append(RawRetrieval(
                        rows, [self.store.row_tid(g) for g in rows],
                        [float(s) for g, s in zip(ids, scs) if g >= 0]))
        tel.observe(RETRIEVE_LATENCY, time.perf_counter() - t_exec,
                    n=B, help="end-to-end execute() latency per request")
        return out

    def _resolve(self, req: RetrieveRequest, plan: RetrievalPlan) -> _Resolved:
        """Fold request -> plan -> service option defaults."""
        stages = req.stages if req.stages is not None else plan.stages
        if "graph" in stages:
            raise NotImplementedError(
                f"the graph retrieval stage comes with {_SLICE_GRAPH}")
        dw = (req.dense_weight if req.dense_weight is not None
              else plan.dense_weight if plan.dense_weight is not None
              else self.dense_weight)
        sw = (req.sparse_weight if req.sparse_weight is not None
              else plan.sparse_weight if plan.sparse_weight is not None
              else self.sparse_weight)
        return _Resolved(
            k=req.top_k or plan.top_k or self.top_k,
            dense_weight=float(dw), sparse_weight=float(sw),
            dense="dense" in stages, sparse="sparse" in stages,
            budget="budget" in stages)

    @staticmethod
    def _mask_ranking(ids: torch.Tensor, wants: List[bool], Bp: int):
        """Drop a ranking for the requests that excluded its stage: their
        rows become all -1 (fusion padding).  The all-True common case
        launches nothing."""
        if all(wants):
            return ids
        mask = np.ones((Bp,), bool)
        mask[: len(wants)] = wants
        mask = torch.from_numpy(mask).to(ids.device)
        return torch.where(mask[:, None], ids, torch.full_like(ids, -1))

    def answer_prompt(self, namespace: str, question: str
                      ) -> Tuple[str, RetrievedContext]:
        ctx = self.retrieve(namespace, question)
        return ANSWER_PROMPT.format(memories=ctx.text,
                                    question=question), ctx

    # -- eviction ----------------------------------------------------------------
    def evict(self, namespace: str) -> int:
        """Drop a whole tenant: tombstone its bank rows + BM25 docs, free
        its stores.  Returns the number of rows evicted."""
        return self.store.evict_namespace(namespace)

    def evict_superseded(self, namespace: str) -> int:
        """Physically evict triples superseded under conflict resolution."""
        return self.store.evict_superseded(namespace)

    # -- stats ----------------------------------------------------------------------
    def stats(self) -> dict:
        """Store counters plus `pending_depth` (buffered sessions)."""
        st = self.store.stats()
        st["pending_depth"] = st["pending"]
        return st

    def namespace_stats(self, namespace: str) -> dict:
        """Public per-namespace counters."""
        t = self.store.get(namespace)
        if t is None:
            return {"triples": 0, "summaries": 0, "evicted": 0}
        return {"triples": len(t.triples),
                "summaries": len(t.summaries),
                "evicted": len(t.evicted)}


class NamespaceView:
    """A single-namespace facade over a MemoryService: anything written
    against the single-tenant memory surface (record_session / retrieve /
    answer_prompt) runs on the shared service unchanged.  The namespace key
    is the conversation scope, so record_session's conversation_id is
    subsumed by it."""

    def __init__(self, service: MemoryService, namespace: str):
        self.service = service
        self.namespace = namespace

    def record_session(self, conversation_id: str, session_id: str,
                       messages: Sequence[Message]):
        if self.service.flush_every:
            # batched ingestion: buffered until the count-based flush (reads
            # still see it — retrieve flushes first)
            return self.service.enqueue(self.namespace, session_id, messages)
        return self.service.record(self.namespace, session_id, messages)

    def retrieve(self, query: str,
                 top_k: Optional[int] = None) -> RetrievedContext:
        return self.service.retrieve(self.namespace, query, top_k=top_k)

    def answer_prompt(self, question: str) -> Tuple[str, RetrievedContext]:
        return self.service.answer_prompt(self.namespace, question)

    def stats(self) -> dict:
        return self.service.namespace_stats(self.namespace)
