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
CUDA top-k kernels; `device="cpu"` runs the same code with the kernels'
plain PyTorch versions.  Without a card the default raises.
`quantize="int8"` holds the device bank as int8 codes with per-row scales
(core/vector_index.py): the dense search runs the quantized kernel K2 over
a `rescore`x over-fetch and re-ranks the candidates by exact f32 score.
With a TierManager attached (`store.attach_tiers`), a request whose
namespace is demoted to the warm tier is answered from the host mirror
(`VectorIndex.search_host`) and marked for promotion on the next tick.

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
through a `RetrievalPlan` — embed → dense → sparse → graph → fuse →
budget, with dense-only / sparse-only / raw (no-budget) / graph-expanded
variants.

Everything that happens between requests — WAL-backed incremental
persistence, the background flusher with backpressure, auto-compaction
and snapshot rotation — lives in `core/lifecycle.py`'s LifecycleRuntime;
pass `policy=`/`data_dir=` to mount one (or `MemoryService.recover(
data_dir, ...)` to come back after a crash), and the service routes
writes, maintenance and the read path through its lock.

Concurrent clients are served through a `MemoryScheduler`
(`start_scheduler()`, core/scheduler.py) and the sync read wrappers
(`retrieve`, `retrieve_batch`): every client's single request coalesces
with its concurrent peers into one `execute` — one masked top-k launch —
per scheduler tick.

`shards=N` places the bank shard-major (core/shards.py): the dense stage
is one K1 launch over the slab bank (`store.sharded_search`), and a shard
marked down (`set_shard_down`) answers its tenants' requests empty with
`degraded=True` while the rest of the batch answers as if they were not
in it.  `attach_follower` streams the journal's sealed segments to a
follower (checkpoint/replication.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.utils import next_pow2, upload
from repro_torch.core.admission import AdmissionError
from repro_torch.core.api import (RawRetrieval, RetrievalPlan,
                                  RetrieveRequest, as_retrieve_request)
from repro_torch.core.budget import TokenBudgeter
from repro_torch.core.extraction import Extractor, Message
from repro_torch.core.hybrid import rrf_fuse_batch
from repro_torch.core.lifecycle import LifecyclePolicy, LifecycleRuntime
from repro_torch.core.memory import ANSWER_PROMPT, RetrievedContext, render
from repro_torch.core.store import MemoryStore
from repro_torch.core.summaries import Summary
from repro_torch.core.triples import Triple
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.obs.telemetry import (GRAPH_EXPAND_LATENCY, RECORD_LATENCY,
                                       RETRIEVE_LATENCY, get_telemetry)

# graph-stage fallbacks when neither the request nor the plan sets them:
# 2 hops reaches friend-of-a-fact chains, causal/temporal edges slightly
# discounted against direct co-occurrence, and the expanded ranking fuses
# below the dense column's weight (it corroborates, it does not dominate)
_GRAPH_HOPS = 2
_GRAPH_EDGE_WEIGHTS = (1.0, 0.9, 0.9)
_GRAPH_WEIGHT = 0.6


@dataclasses.dataclass(frozen=True)
class _Resolved:
    """One request's options after plan/service defaults are folded in."""
    k: int
    dense_weight: float
    sparse_weight: float
    dense: bool
    sparse: bool
    graph: bool
    budget: bool
    hops: int = _GRAPH_HOPS
    edge_weights: Tuple[float, float, float] = _GRAPH_EDGE_WEIGHTS
    graph_weight: float = _GRAPH_WEIGHT


class MemoryService:
    def __init__(self, embedder=None, extractor: Optional[Extractor] = None,
                 dim: int = 256, budget: int = 1300, top_k: int = 10,
                 tokenizer: HashTokenizer | None = None,
                 dense_weight: float = 1.0, sparse_weight: float = 0.7,
                 pool: int = 64, flush_every: Optional[int] = None,
                 store: Optional[MemoryStore] = None,
                 plan: Optional[RetrievalPlan] = None, device="cuda",
                 policy: Optional[LifecyclePolicy] = None,
                 data_dir: Optional[str] = None,
                 runtime: Optional[LifecycleRuntime] = None,
                 quantize: str = "none", rescore: int = 4, shards: int = 1,
                 mesh=None):
        if store is None and runtime is not None:
            store = runtime.store
        if store is None:
            if embedder is None:
                raise ValueError("MemoryService needs an embedder or a store")
            store = MemoryStore(embedder, extractor, dim=dim,
                                tokenizer=tokenizer, quantize=quantize,
                                rescore=rescore, device=device,
                                shards=shards, mesh=mesh)
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
        # a mounted MemoryScheduler (core/scheduler.py) re-routes the sync
        # read wrappers through its cross-client micro-batching ticks
        self.scheduler = None
        if runtime is not None:
            if runtime.store is not self.store:
                raise ValueError("runtime is mounted on a different store")
        elif policy is not None or data_dir is not None:
            runtime = LifecycleRuntime(self.store, data_dir=data_dir,
                                       policy=policy)
        self.runtime = runtime

    def _guard(self):
        """The runtime's lock when one is mounted (serializes requests
        against background flush/compaction/rotation), else a no-op."""
        return self.runtime.lock if self.runtime else contextlib.nullcontext()

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
        to the one that wrote it.  `quantize=`/`rescore=`/`shards=` in
        service_kwargs pick the restored index's device bank mode and
        placement (snapshots are f32 and placement-agnostic)."""
        store = MemoryStore.restore(
            path, embedder, extractor=extractor, tokenizer=tokenizer,
            quantize=service_kwargs.pop("quantize", "none"),
            rescore=service_kwargs.pop("rescore", 4), device=device,
            shards=service_kwargs.pop("shards", 1),
            mesh=service_kwargs.pop("mesh", None))
        return cls(store=store, **service_kwargs)

    @classmethod
    def recover(cls, data_dir: str, embedder,
                extractor: Optional[Extractor] = None,
                policy: Optional[LifecyclePolicy] = None, device="cuda",
                dim: int = 256, tokenizer: HashTokenizer | None = None,
                shards: Optional[int] = None, mesh=None,
                **service_kwargs) -> "MemoryService":
        """Rebuild a service from a lifecycle runtime's durable directory
        (written by either package): newest restorable snapshot + ordered
        WAL replay on `device`.  The recovered service answers
        `retrieve_batch` identically to the pre-crash one up to the last
        durable flush, and keeps journaling to the same directory.  `dim`
        matters only when the directory holds no snapshot yet.
        `shards=None` autodetects the sharded WAL layout on disk."""
        rt = LifecycleRuntime.recover(data_dir, embedder,
                                      extractor=extractor, policy=policy,
                                      device=device, dim=dim,
                                      tokenizer=tokenizer, shards=shards,
                                      mesh=mesh)
        return cls(runtime=rt, **service_kwargs)

    def snapshot(self, path: str) -> int:
        """Flush pending writes, then persist the whole store to an
        explicit path (a mounted runtime's rotation is `rotate()`).
        Returns bytes written."""
        with self._guard():
            return self.store.snapshot(path)

    def rotate(self) -> dict:
        """Snapshot rotation through the mounted runtime: full snapshot,
        retention pruning, WAL truncation."""
        if self.runtime is None:
            raise RuntimeError("rotate() needs a mounted LifecycleRuntime")
        return self.runtime.rotate()

    def close(self, *, final_snapshot: bool = True) -> None:
        """Stop the mounted scheduler (drains queued requests) and the
        background runtime (final flush + snapshot when durable).  Safe to
        call on a scheduler-less / runtime-less service.  Idempotent."""
        if self.scheduler is not None:
            self.scheduler.close()
        if self.runtime is not None:
            self.runtime.close(final_snapshot=final_snapshot)

    def start_scheduler(self, **kwargs):
        """Mount a MemoryScheduler: from here on the sync read wrappers
        (`retrieve`, `retrieve_batch`) coalesce with every other client's
        concurrent requests into one device launch per tick.  Returns the
        scheduler (also available as `self.scheduler`; the constructor
        refuses to mount over a live one).  Build it on the thread whose
        CUDA stream the read path uses: its ticks run there."""
        from repro_torch.core.scheduler import MemoryScheduler
        return MemoryScheduler(self, **kwargs)

    def __enter__(self) -> "MemoryService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- tenancy -----------------------------------------------------------
    def namespaces(self) -> List[str]:
        with self._guard():
            return self.store.namespaces()

    def namespace(self, name: str) -> "NamespaceView":
        return NamespaceView(self, name)

    # -- write path ----------------------------------------------------------
    def record(self, namespace: str, session_id: str,
               messages: Sequence[Message]) -> Tuple[List[Triple], Summary]:
        """Synchronous ingest of one session: enqueue + flush (anything
        else pending is drained in the same batch)."""
        t0 = time.perf_counter()
        with self._guard():
            if self.runtime is not None:
                if self.runtime.closed:
                    raise RuntimeError(
                        "service is closed: writes would bypass the "
                        "journal (recover/remount before writing again)")
                self.runtime.note_activity()
            out = self.store.ingest(namespace, session_id, messages)
        get_telemetry().observe(
            RECORD_LATENCY, time.perf_counter() - t0,
            help="synchronous record (enqueue + flush) latency")
        return out

    def enqueue(self, namespace: str, session_id: str,
                messages: Sequence[Message],
                conversation_id: Optional[str] = None) -> None:
        """Async ingest: queue the session for the next `flush()`.  With a
        mounted runtime the queue is bounded and backpressured per policy
        (the background flusher drains it); `flush_every` additionally
        triggers a count-based flush."""
        if self.runtime is not None:
            self.runtime.enqueue(namespace, session_id, messages,
                                 conversation_id=conversation_id)
        else:
            self.store.enqueue(namespace, session_id, messages,
                               conversation_id=conversation_id)
        if self.flush_every and self.store.pending_count >= self.flush_every:
            self.flush()

    def flush(self) -> int:
        """Drain all pending sessions (all tenants) through one embed call
        and one bank append.  Returns the number of sessions ingested."""
        if self.runtime is not None:
            return self.runtime.flush()
        return len(self.store.flush())

    def compact(self) -> dict:
        """Reclaim tombstoned rows (see MemoryStore.compact)."""
        with self._guard():
            return self.store.compact()

    # -- read path -------------------------------------------------------------
    def retrieve(self, namespace: str, query: str,
                 top_k: Optional[int] = None, **options) -> RetrievedContext:
        """Single-tenant retrieve.  Extra keyword options (`dense_weight`,
        `sparse_weight`, `stages`) become RetrieveRequest fields.  With a
        mounted scheduler this coalesces with every other client's
        concurrent request into one device launch."""
        req = RetrieveRequest(namespace=namespace, query=query, top_k=top_k,
                              **options)
        return self.retrieve_batch([req])[0]

    def retrieve_batch(self, requests: Sequence, top_k: Optional[int] = None,
                       plan: Optional[RetrievalPlan] = None) -> List[Any]:
        """Requests -> per-request payloads (RetrievedContext, or
        RawRetrieval for no-budget plans).  Each request is a (namespace,
        query) tuple or a `RetrieveRequest`; `top_k` is the per-request
        default.

        With a mounted MemoryScheduler the batch is submitted to it, so it
        fuses with whatever other clients queued in the same tick;
        otherwise (or with an explicit `plan`) it executes directly.  Either
        way the results equal sequential retrieve() calls."""
        reqs = [as_retrieve_request(r, top_k) for r in requests]
        if not reqs:
            return []
        sched = self.scheduler
        if plan is None and sched is not None and sched.can_submit():
            try:
                futures = sched.submit_many(reqs)
            except AdmissionError:
                # a QoS rejection (rate limit / shed) must surface, not
                # sneak through the direct engine — falling back would let
                # every rate-limited caller bypass admission control
                raise
            except RuntimeError:
                # the scheduler closed between can_submit() and the
                # submission (service shutdown racing a reader) — the
                # direct engine still answers
                pass
            else:
                return [f.result().result() for f in futures]
        return self.execute(reqs, plan=plan)

    def execute(self, requests: Sequence[RetrieveRequest],
                plan: Optional[RetrievalPlan] = None) -> List[Any]:
        """The retrieval engine: a batch of typed requests through the
        plan's stages in one set of device launches — one embed_texts call,
        one masked top-k launch against the device bank (cached row
        labels), one stacked BM25 scoring pass, one batched graph expansion
        and one `rrf_fuse_batch`;
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
        with tel.span("plan.embed", batch=len(dense_rows)):
            qvecs = (self.embedder.embed_texts([reqs[i].query
                                                for i in dense_rows])
                     if dense_rows else None)
        with self._guard():
            if self.runtime is not None:
                self.runtime.note_activity()
            if self.store.pending_count:
                # through the runtime when mounted: the read-your-writes
                # drain counts as a flush and wakes blocked enqueuers
                self.flush()
            # reads never allocate tenant state: unknown namespaces stay
            # unknown
            tenants = [self.store.get(r.namespace) for r in reqs]
            vindex = self.store.vindex
            device = vindex.device
            tiers = self.store.tiers
            if tiers is not None:
                for t in tenants:
                    if t is not None:
                        tiers.note_retrieve(t.ns_id)
            # graceful degradation: a request whose placement shard is down
            # answers empty with degraded=True — all its rankings are
            # masked below, so the surviving requests in the batch are
            # bit-identical to a batch that never contained it.  `down` is
            # read before the dense launch and again after it (`_downed`):
            # a shard taken down or brought back by another thread
            # meanwhile counts as down, so a request whose launch may have
            # read the shard's -1 label slab is always flagged.
            sharded = self.store.sharded
            down_before = sharded.down if sharded is not None else frozenset()
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
                    with tel.span("plan.dense", batch=Bp,
                                  pool=self.pool) as sp:
                        qv = torch.as_tensor(qvecs, dtype=torch.float32).to(
                            device)
                        qmat = torch.zeros((Bp, qv.shape[1]),
                                           dtype=torch.float32, device=device)
                        qmat[upload(dense_rows, device, torch.int64)] = qv
                        if sharded is not None:
                            # shard-wise placement: one K1 launch over the
                            # slab bank; ids come back in global-row space
                            _, dense_ids = self.store.sharded_search(
                                qmat, q_ns, k=self.pool)
                        else:
                            _, dense_ids = vindex.search_batch(qmat, q_ns,
                                                               k=self.pool)
                        if tiers is not None:
                            # a demoted namespace's rows are absent from the
                            # device bank: answer those requests from the
                            # host-mirror masked search (exact, not
                            # accelerated) and mark them for promotion on the
                            # next tick
                            fb = [i for i in dense_rows
                                  if tenants[i] is not None
                                  and tiers.is_demoted(tenants[i].ns_id)]
                            if fb:
                                sp.set(host_fallbacks=len(fb))
                                _, hi = vindex.search_host(qmat[fb], q_ns[fb],
                                                           k=self.pool)
                                dense_ids = dense_ids.clone()
                                dense_ids[fb] = upload(hi.astype(np.int32),
                                                       device)
                                for i in fb:
                                    tiers.note_host_fallback(tenants[i].ns_id)
                        downed = self._downed(tenants, down_before)
                        dense_ids = self._mask_ranking(
                            dense_ids,
                            [r.dense and not d for r, d in zip(res, downed)],
                            Bp)
                    rankings.append(dense_ids)
                    weight_cols.append(
                        [r.dense_weight for r in res]
                        + [self.dense_weight] * (Bp - B))
                if not dense_rows:
                    downed = self._downed(tenants, down_before)
                if any(r.sparse for r in res):
                    with tel.span("plan.sparse", batch=Bp, pool=self.pool):
                        _, sparse_ids = self.store.bm25.topk_batch_dev(
                            [r.query for r in reqs] + [""] * (Bp - B),
                            k=self.pool, namespaces=ns_pad)
                        sparse_ids = self._mask_ranking(
                            sparse_ids,
                            [r.sparse and not d for r, d in zip(res, downed)],
                            Bp)
                    rankings.append(sparse_ids)
                    weight_cols.append(
                        [r.sparse_weight for r in res]
                        + [self.sparse_weight] * (Bp - B))
                # graph expansion: the dense/sparse rankings' top rows seed a
                # batched k-hop walk over the store's entity graph; the
                # expanded rows join the fusion as a third ranking with their
                # own weight column.  Requests that skip the stage get it
                # masked to -1, so they fuse exactly like a graph-less batch.
                # Hop depth is per request; the loop runs to the pow2 bucket
                # of the batch max.  A request whose shard is down skips it.
                graph_wants = [r.graph and not d
                               for r, d in zip(res, downed)]
                if any(graph_wants) and rankings:
                    g = self.store.graph
                    t_g = time.perf_counter()
                    hops_arr = np.zeros((Bp,), np.int32)
                    hops_arr[:B] = [rr.hops if w else 0
                                    for rr, w in zip(res, graph_wants)]
                    tw = np.zeros((Bp, 3), np.float32)
                    tw[:B] = [rr.edge_weights for rr in res]
                    max_hops = next_pow2(max(1, int(hops_arr.max())))
                    with tel.span("plan.graph", batch=Bp, pool=self.pool,
                                  max_hops=max_hops) as sp:
                        graph_ids, _, fsz, etc = g.expand(
                            rankings, q_ns, self.store.row_namespaces_device(),
                            tw, hops_arr, k=self.pool, max_hops=max_hops,
                            seed_k=plan.graph_seed_k, decay=plan.graph_decay)
                        graph_ids = self._mask_ranking(graph_ids, graph_wants,
                                                       Bp)
                        sp.set(frontier_sizes=fsz, edges_touched=etc,
                               nodes=g.n_nodes, edges=g.n_edges)
                    rankings.append(graph_ids)
                    weight_cols.append(
                        [r.graph_weight for r in res] + [0.0] * (Bp - B))
                    tel.inc("memori_graph_expansions", 1,
                            help="batched k-hop expansion launches")
                    tel.inc("memori_graph_requests", sum(graph_wants),
                            help="requests whose plan ran the graph stage")
                    tel.observe(GRAPH_EXPAND_LATENCY,
                                time.perf_counter() - t_g,
                                help="graph k-hop expansion stage latency")
                with tel.span("plan.fuse", batch=Bp, k=k_fuse,
                              rankings=len(rankings)):
                    fused_ids, fused_scores = rrf_fuse_batch(
                        rankings,
                        weights=np.stack(
                            [np.asarray(c, np.float32) for c in weight_cols],
                            axis=1),
                        k=k_fuse)
                    fused_ids = fused_ids.cpu().numpy()[:B]
                    fused_scores = fused_scores.cpu().numpy()[:B]
            else:
                downed = self._downed(tenants, down_before)
                fused_ids = np.full((B, k_fuse), -1, np.int32)
                fused_scores = np.zeros((B, k_fuse), np.float32)
            out: List[Any] = []
            # the summed spans join plan.budget as they close: select first
            with tel.span("plan.budget", batch=B), \
                    tel.summed("budget.render") as show, \
                    tel.summed("budget.select") as pick:
                for r, (rr, t) in enumerate(zip(res, tenants)):
                    # the fused ranking is sorted best-first, so its k_r prefix
                    # is the k=k_r fusion of the same inputs
                    ids = fused_ids[r][: rr.k]
                    scs = fused_scores[r][: rr.k]
                    if t is None:
                        if rr.budget:
                            with show.part():
                                text = render([], [])
                                n_tok = self.tokenizer.count(text)
                            out.append(RetrievedContext([], [], text, n_tok))
                        else:
                            out.append(RawRetrieval([], [], []))
                        continue
                    if rr.budget:
                        with pick.part():
                            scored = [(t.triples.get(
                                self.store.row_tid(int(g))), float(s))
                                for g, s in zip(ids, scs) if g >= 0]
                            ctx = self.budgeter.select(scored, t.summaries)
                        pick.add("considered", len(scored))
                        pick.add("kept", len(ctx.triples))
                        with show.part():
                            text = render(ctx.triples, ctx.summaries)
                            n_tok = self.tokenizer.count(text)
                        out.append(RetrievedContext(
                            ctx.triples, ctx.summaries, text, n_tok,
                            degraded=downed[r]))
                    else:
                        rows = [int(g) for g in ids if g >= 0]
                        out.append(RawRetrieval(
                            rows, [self.store.row_tid(g) for g in rows],
                            [float(s) for g, s in zip(ids, scs) if g >= 0],
                            degraded=downed[r]))
            n_down = sum(downed)
            if n_down:
                tel.inc("memori_degraded_responses", n_down,
                        help="requests answered empty because their "
                             "placement shard was down")
                tel.event("degraded_response", count=n_down,
                          shards=sorted(down_before | sharded.down))
            tel.observe(RETRIEVE_LATENCY, time.perf_counter() - t_exec,
                        n=B, help="end-to-end execute() latency per request")
            return out

    def _resolve(self, req: RetrieveRequest, plan: RetrievalPlan) -> _Resolved:
        """Fold request -> plan -> service option defaults."""
        stages = req.stages if req.stages is not None else plan.stages
        dw = (req.dense_weight if req.dense_weight is not None
              else plan.dense_weight if plan.dense_weight is not None
              else self.dense_weight)
        sw = (req.sparse_weight if req.sparse_weight is not None
              else plan.sparse_weight if plan.sparse_weight is not None
              else self.sparse_weight)
        ew = (req.edge_weights if req.edge_weights is not None
              else plan.edge_weights if plan.edge_weights is not None
              else _GRAPH_EDGE_WEIGHTS)
        gw = (req.graph_weight if req.graph_weight is not None
              else plan.graph_weight if plan.graph_weight is not None
              else _GRAPH_WEIGHT)
        return _Resolved(
            k=req.top_k or plan.top_k or self.top_k,
            dense_weight=float(dw), sparse_weight=float(sw),
            dense="dense" in stages, sparse="sparse" in stages,
            graph="graph" in stages,
            budget="budget" in stages,
            hops=int(req.hops or plan.hops or _GRAPH_HOPS),
            edge_weights=tuple(float(w) for w in ew),
            graph_weight=float(gw))

    def _downed(self, tenants, down_before) -> List[bool]:
        """Per request: is its tenant's placement shard down — in the set
        read before the dense launch or in the one read now."""
        sharded = self.store.sharded
        down = down_before | sharded.down if sharded is not None else ()
        if not down:
            return [False] * len(tenants)
        return [t is not None and sharded.shard_of(t.ns_id) in down
                for t in tenants]

    @staticmethod
    def _mask_ranking(ids: torch.Tensor, wants: List[bool], Bp: int):
        """Drop a ranking for the requests that excluded its stage: their
        rows become all -1 (fusion padding).  The all-True common case
        launches nothing."""
        if all(wants):
            return ids
        mask = np.ones((Bp,), bool)
        mask[: len(wants)] = wants
        mask = upload(mask, ids.device)
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
        with self._guard():
            return self.store.evict_namespace(namespace)

    def evict_superseded(self, namespace: str) -> int:
        """Physically evict triples superseded under conflict resolution."""
        with self._guard():
            return self.store.evict_superseded(namespace)

    # -- shard lifecycle ---------------------------------------------------
    def set_shard_down(self, shard: int) -> None:
        """Mark one placement shard unavailable: its device label slab goes
        to -1 (its rows stop matching any query) and requests owned by it
        answer empty with `degraded=True` while the rest of the batch
        answers normally — the batch never fails wholesale."""
        with self._guard():
            self.store.shard_down(shard)
        get_telemetry().event("shard_down", shard=int(shard))

    def set_shard_up(self, shard: int) -> None:
        """Bring a recovered shard back: restore its device labels from the
        host mirror and stop degrading its tenants' responses."""
        with self._guard():
            self.store.shard_up(shard)
        get_telemetry().event("shard_up", shard=int(shard))

    def attach_follower(self, sink, mode: str = "sync"):
        """Stream every sealed WAL segment to `sink` (a directory path or
        any object with put/has/list — see checkpoint/replication.py), so
        recovery survives losing this host's disk.  Returns the shipper."""
        if self.runtime is None:
            raise RuntimeError("attach_follower needs a lifecycle runtime "
                               "(construct the service with data_dir/runtime)")
        return self.runtime.attach_follower(sink, mode=mode)

    # -- stats -----------------------------------------------------------------
    def stats(self) -> dict:
        """Store counters plus the operator's runtime view: `pending_depth`
        (buffered sessions), `wal_segments` (un-truncated log segments on
        disk) and `last_snapshot_age_s` (None until a snapshot exists)."""
        with self._guard():
            st = self.store.stats()
            if self.runtime is not None:
                st.update(self.runtime.stats())
            else:
                st.update({"pending_depth": st["pending"],
                           "wal_segments": 0,
                           "last_snapshot_age_s": None})
            return st

    def namespace_stats(self, namespace: str) -> dict:
        """Public per-namespace counters."""
        with self._guard():
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
        runtime = self.service.runtime
        if self.service.flush_every or (
                runtime is not None
                and runtime.policy.flush_interval_s is not None):
            # batched ingestion: buffered until the count-based or
            # time-based flusher drains the queue (reads still see it —
            # retrieve flushes first)
            return self.service.enqueue(self.namespace, session_id, messages)
        return self.service.record(self.namespace, session_id, messages)

    def retrieve(self, query: str,
                 top_k: Optional[int] = None) -> RetrievedContext:
        return self.service.retrieve(self.namespace, query, top_k=top_k)

    def answer_prompt(self, question: str) -> Tuple[str, RetrievedContext]:
        return self.service.answer_prompt(self.namespace, question)

    def stats(self) -> dict:
        return self.service.namespace_stats(self.namespace)

    def close(self) -> None:
        """Shut the backing service's lifecycle runtime down (final flush +
        snapshot).  Idempotent and shared: the first closing view wins, so
        any client of a shared service may call it on exit."""
        self.service.close()
