"""MemoryStore — the unified storage engine under the memory layer.

MemoryStore owns the packed vector bank, the BM25 corpus, the per-tenant
triple/summary stores, the entity graph and the row↔namespace↔triple
mapping as one consistent unit:

* **batched ingestion** — `enqueue()` is cheap (no extraction, no
  embedding); `flush()` drains every pending session across all tenants
  through one `embed_texts` call and one in-place bank append.  `ingest()`
  is the synchronous path (enqueue + flush).
* **compaction** — `compact()` drops tombstoned rows and remaps global row
  ids in the row tables, the BM25 corpus, the graph's row lanes and every
  tenant's `rows` list.
* **snapshot/restore** — `snapshot(path)` writes the reference package's
  snapshot layout (version 2) through `checkpoint/io.py`, so either
  package restores what the other wrote.  `from_arrays` builds a store from
  the flat array dict such a snapshot loads to; `restore(path)` is
  `load_raw` + `from_arrays`.  Snapshots are always f32, whatever the
  device bank's `quantize` mode.
* **tiering** — `attach_tiers()` mounts a hot/warm TierManager
  (core/tiering.py) on the vector index; flushes note record activity.
* **incremental persistence hooks** — when `wal_sink` is attached (by
  `core/lifecycle.py`'s LifecycleRuntime), every durable mutation emits a
  self-describing record *before* it is applied: `flush` logs the
  extracted sessions plus the raw embedding vectors (the only input a
  replay could not recompute bit-exactly), `link` its edge, and
  `evict`/`evict_superseded`/`compact` their operation (deterministic
  functions of store state).  `apply_wal(record)` replays a record through
  the same commit code the live mutation used, so snapshot + ordered
  replay rebuilds a store whose bank bytes and retrieval answers equal the
  writer's up to the last durable record.  The records are the reference
  package's, byte for byte.

**sharding** — `shards > 1` mounts a shard-major device bank
(core/shards.py): namespace-affine placement, searched by one masked top-k
over the slab bank (`sharded_search`), with shards taken down and brought
back (`shard_down`/`shard_up`).  A flush groups its sessions by shard and
journals one `sharded_flush` record of per-shard parts, the reference
package's record byte for byte.

Layout invariant (checked, raising StoreInvariantError): global row id ==
BM25 doc id == position in the row tables; tenant-local `rows[tid]` maps a
triple id back to its global row (-1 once compacted away).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.checkpoint import packing
from repro_torch.common.utils import resolve_device
from repro_torch.core.bm25 import BM25Index
from repro_torch.core.extraction import Extractor, Message, RuleExtractor
from repro_torch.core.graph import (EDGE_TYPE_IDS, GraphInvariantError,
                                    MemoryGraph)
from repro_torch.core.shards import ShardedBank
from repro_torch.core.summaries import Summary, SummaryStore
from repro_torch.core.triples import Triple, TripleStore
from repro_torch.core.vector_index import VectorIndex
from repro_torch.data.tokenizer import HashTokenizer, default_tokenizer
from repro_torch.obs.telemetry import FLUSH_LATENCY, get_telemetry

# the reference package's snapshot layout version (graph_* arrays +
# meta["graph"]); other versions are refused rather than half-read
SNAPSHOT_VERSION = 2


def _as_record(obj, names) -> dict:
    """`dataclasses.asdict` of a flat dataclass of scalars (Triple,
    Summary) whose field `names` are given — the same dict, several times
    faster: a snapshot of the serve store converts a million triples."""
    return {n: getattr(obj, n) for n in names}


class StoreInvariantError(RuntimeError):
    """A storage-layer alignment invariant was violated (row id / doc id /
    row-table drift)."""


@dataclasses.dataclass
class TenantState:
    """Per-namespace state.  Bank rows and BM25 doc ids share one global id
    space (row == doc id); `rows[local_tid] -> global row` maps back (-1
    after the row was tombstoned and compacted away)."""
    ns_id: int
    triples: TripleStore = dataclasses.field(default_factory=TripleStore)
    summaries: SummaryStore = dataclasses.field(default_factory=SummaryStore)
    rows: List[int] = dataclasses.field(default_factory=list)
    evicted: Set[int] = dataclasses.field(default_factory=set)  # local tids


@dataclasses.dataclass
class PendingSession:
    namespace: str
    conversation_id: str
    session_id: str
    messages: List[Message]


class MemoryStore:
    def __init__(self, embedder, extractor: Optional[Extractor] = None,
                 dim: int = 256, tokenizer: HashTokenizer | None = None,
                 quantize: str = "none", rescore: int = 4, device="cuda",
                 shards: int = 1, mesh=None):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if shards > 1 and quantize != "none":
            raise ValueError(
                "sharded placement and the quantized device bank are "
                "mutually exclusive (the shard slabs hold f32 rows)")
        self.shards = int(shards)
        # a DeviceMesh places the shard slabs over its devices (one process
        # a device; core/shards.py); the unsharded index stays on `device`,
        # as the reference keeps its VectorIndex off the mesh
        self.mesh = mesh
        self.embedder = embedder
        self.extractor = extractor or RuleExtractor()
        self.tokenizer = tokenizer or default_tokenizer()
        self.dim = dim
        self.device = resolve_device(device)
        # quantize="int8" keeps the f32 host mirror as ground truth but
        # holds the device bank as int8 codes + per-row scales, searched by
        # K2 with an exact f32 rescore of the top rescore*k candidates
        self.vindex = VectorIndex(dim=dim, device=self.device,
                                  quantize=quantize, rescore=rescore)
        # shards > 1 mounts a shard-major device bank (core/shards.py); the
        # VectorIndex host mirror stays the ground truth for WAL, snapshot
        # and compaction either way
        self.sharded: Optional[ShardedBank] = (
            ShardedBank(dim, self.shards, mesh=mesh, device=self.device)
            if self.shards > 1 else None)
        self.bm25 = BM25Index(tokenizer=self.tokenizer, device=self.device)
        self.graph = MemoryGraph(device=self.device)
        # hot/warm tier manager (core/tiering.py) — attach_tiers() mounts
        # one; when None every row stays device-resident
        self.tiers = None
        self._tenants: Dict[str, TenantState] = {}
        self._ns_ids: Dict[str, int] = {}      # survives evict(): tombstoned
        #                                        rows keep a retired ns id
        self._row_tid: List[int] = []          # global row -> local tid
        self._pending: List[PendingSession] = []
        # incremental-persistence hook: called with a self-describing record
        # BEFORE each durable mutation is applied (WAL-before-apply); a sink
        # that raises aborts the mutation.  Attached by LifecycleRuntime;
        # must be None while apply_wal() replays (replay must not re-log).
        self.wal_sink: Optional[Callable[[dict], object]] = None
        # called with the session count AFTER each non-empty flush commits,
        # whoever triggered it (runtime, service read path, direct caller);
        # the runtime uses it to track flush times and wake blocked
        # enqueuers waiting on queue space
        self.on_flush_commit: Optional[Callable[[int], None]] = None

    # -- tenancy -----------------------------------------------------------
    def tenant(self, namespace: str) -> TenantState:
        """Create-or-get a tenant (the write path)."""
        t = self._tenants.get(namespace)
        if t is None:
            ns_id = self._ns_ids.setdefault(namespace, len(self._ns_ids))
            t = self._tenants[namespace] = TenantState(ns_id=ns_id)
        return t

    def get(self, namespace: str) -> Optional[TenantState]:
        """Get without creating (the read path: unknown stays unknown)."""
        return self._tenants.get(namespace)

    def namespaces(self) -> List[str]:
        return list(self._tenants)

    def namespace_id_count(self) -> int:
        """Number of namespace ids ever assigned (a fresh id >= this count
        can never collide with any bank row's label)."""
        return len(self._ns_ids)

    def row_namespaces(self) -> np.ndarray:
        """(n,) int32: every bank row's namespace id (host array)."""
        return self.vindex.row_namespaces()

    def row_namespaces_device(self):
        """(capacity,) i32 device tensor of effective row labels (live row
        -> ns id, tombstone/unfilled -> -1), cached in the vector index."""
        return self.vindex.row_labels_device()

    def row_tid(self, row: int) -> int:
        return self._row_tid[row]

    # -- tiering -----------------------------------------------------------
    def attach_tiers(self, policy=None, clock=None):
        """Mount a hot/warm TierManager (core/tiering.py) on the vector
        index.  Activity notes flow from the write path (`_apply_flush`)
        and the service's read path; `tiers.tick()` demotes and promotes.
        Returns the manager (also at `self.tiers`)."""
        from repro_torch.core.tiering import TierManager
        if self.tiers is not None:
            raise ValueError("a TierManager is already attached")
        if self.sharded is not None:
            raise ValueError(
                "hot/warm tiering is not supported on a sharded bank")
        kwargs = {} if clock is None else {"clock": clock}
        self.tiers = TierManager(self.vindex, policy=policy, **kwargs)
        return self.tiers

    # -- write path: batched ingestion -------------------------------------
    def enqueue(self, namespace: str, session_id: str,
                messages: Sequence[Message],
                conversation_id: Optional[str] = None) -> None:
        """Cheap: no extraction, no embedding — just queue the session.
        `conversation_id` defaults to the namespace."""
        self._pending.append(PendingSession(
            namespace=namespace,
            conversation_id=conversation_id if conversation_id is not None
            else namespace,
            session_id=session_id, messages=list(messages)))

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    def flush(self) -> List[Tuple[str, List[Triple], Summary]]:
        """Drain every pending session across all tenants: extraction runs
        per session, but all new triples go through one `embed_texts` call,
        one bank append and one BM25 append.  Returns per-session
        (namespace, triples, summary) in enqueue order.

        All-or-nothing: extraction, embedding and the WAL append touch no
        store state — if any of them raises, the queue is restored intact
        and nothing is committed (no applied flush without its WAL record,
        since the sink runs first).  With a sink attached the vectors come
        to the host once (the record needs their bytes) and the commit
        appends that host copy, as a replay of the record does."""
        if not self._pending:
            return []
        tel = get_telemetry()
        t_flush = time.perf_counter()
        pending, self._pending = self._pending, []
        with tel.span("store.flush", sessions=len(pending)):
            try:
                batch = []                   # (session, triples, summary)
                for p in pending:
                    triples, summary = self.extractor.extract(
                        p.conversation_id, p.session_id, p.messages)
                    batch.append((p, triples, summary))
                if self.sharded is not None:
                    # pin namespace ids in enqueue order before grouping —
                    # replay sees sessions grouped by shard, so the record
                    # carries the live assignment or recovered ids would
                    # drift
                    for p, _, _ in batch:
                        self._ns_ids.setdefault(p.namespace,
                                                len(self._ns_ids))
                    # stable sort: shard-contiguous parts, enqueue order
                    # within
                    batch = sorted(
                        batch, key=lambda b:
                        self._ns_ids[b[0].namespace] % self.shards)
                flat = [tr for _, triples, _ in batch for tr in triples]
                vecs = self.embedder.embed_texts(            # one embed call
                    [tr.text() for tr in flat]) if flat else None
                sessions = [(p.namespace, summary, triples)
                            for p, triples, summary in batch]
                if self.wal_sink is not None:  # durability point: WAL first
                    if isinstance(vecs, torch.Tensor):
                        vecs = vecs.to(torch.float32).cpu().numpy()
                    self.wal_sink(self._sharded_flush_record(sessions, vecs)
                                  if self.sharded is not None
                                  else self._flush_record(sessions, vecs))
            except BaseException:
                # restore the queue (ahead of anything enqueued since)
                self._pending = pending + self._pending
                raise
            self._apply_flush(sessions, vecs)
            if self.on_flush_commit is not None:
                self.on_flush_commit(len(batch))
        tel.observe(FLUSH_LATENCY, time.perf_counter() - t_flush,
                    help="flush latency (extract + embed + WAL + commit)")
        return [(p.namespace, triples, summary)
                for p, triples, summary in batch]

    def _apply_flush(self, sessions, vecs) -> None:
        """Commit one flush batch: `sessions` is [(namespace, Summary,
        [Triple, ...]), ...] and `vecs` the (M, dim) f32 embeddings of the
        flattened triples in order (host array or tensor).  The only code
        path that writes rows."""
        for ns, summary, _ in sessions:
            t = self.tenant(ns)
            t.summaries.add(summary)
            if self.tiers is not None:
                self.tiers.note_record(t.ns_id)
        flat = [(ns, tr) for ns, _, triples in sessions for tr in triples]
        if not flat:
            return
        tenants = [self.tenant(ns) for ns, _ in flat]
        rows = self.vindex.add(                              # one bank append
            vecs, ns=[t.ns_id for t in tenants])
        bids = self.bm25.add([tr.text() for _, tr in flat],
                             namespace=[t.ns_id for t in tenants])
        for t, (_, tr), row, bid in zip(tenants, flat, rows, bids):
            if not (int(row) == int(bid) == len(self._row_tid)):
                raise StoreInvariantError(
                    f"write-path alignment drift: bank row {int(row)}, "
                    f"BM25 doc {int(bid)}, row table size "
                    f"{len(self._row_tid)} must all be equal")
            tid = t.triples.add(tr)
            t.rows.append(int(row))
            self._row_tid.append(tid)
        # grow the entity graph in step: one ingest per session (temporal
        # edges follow each session's extraction order), one device sync
        # for the whole batch
        cursor = 0
        try:
            for ns, _, triples in sessions:
                if triples:
                    self.graph.ingest_session(
                        self.tenant(ns).ns_id, triples,
                        [int(r) for r in rows[cursor: cursor + len(triples)]])
                cursor += len(triples)
        except GraphInvariantError as e:
            raise StoreInvariantError(str(e)) from e
        self.graph.sync_device()
        if self.graph.n_rows != len(self._row_tid):
            raise StoreInvariantError(
                f"graph row-incidence lanes ({self.graph.n_rows}) out of "
                f"sync with the row tables ({len(self._row_tid)})")
        if self.sharded is not None:     # mirror into the shard layout
            # the rows just appended, from the host mirror (one copy of
            # the vectors whatever device they came from)
            self.sharded.append(
                rows, self.vindex.bank[int(rows[0]): int(rows[-1]) + 1],
                [t.ns_id for t in tenants])

    # -- incremental persistence (WAL records) ------------------------------
    def _flush_record(self, sessions, vecs) -> dict:
        """Self-describing WAL record of one flush batch.  Everything a
        replay cannot recompute rides along: the extracted sessions (the
        extractor may be an LLM) and the raw embedding vectors (the
        embedder may be one too), as little-endian f32 bytes of the host
        copy.  BM25 doc rows are not logged — they are a deterministic
        function of triple text and the tokenizer."""
        n_rows = sum(len(triples) for _, _, triples in sessions)
        return {
            "op": "flush",
            "sessions": [{
                "namespace": ns,
                "summary": dataclasses.asdict(summary),
                "triples": [dataclasses.asdict(tr) for tr in triples],
            } for ns, summary, triples in sessions],
            "n_rows": n_rows,
            "dim": self.dim,
            "vecs": (np.asarray(vecs, "<f4").tobytes()
                     if n_rows else b""),
        }

    def _sharded_flush_record(self, sessions, vecs) -> dict:
        """Sharded flush record: the (shard-grouped) sessions split into
        per-shard parts — each part a plain flush record of that shard's
        contiguous session run — plus the namespace-id table.  The WAL
        layer (`checkpoint/replication.ShardedWal`) lands each part in its
        shard's own log and journals one cross-shard commit record; the
        ns_ids table rides along because ids were assigned in enqueue
        order, which the grouped parts alone cannot reconstruct."""
        parts = []
        cursor = 0
        by_shard: Dict[int, list] = {}
        for ns, summary, triples in sessions:
            s = self._ns_ids[ns] % self.shards
            by_shard.setdefault(s, []).append((ns, summary, triples))
        for s in sorted(by_shard):       # ascending shard == grouped order
            group = by_shard[s]
            cnt = sum(len(triples) for _, _, triples in group)
            part_vecs = (np.asarray(vecs, np.float32)[cursor: cursor + cnt]
                         if cnt else None)
            cursor += cnt
            parts.append([s, self._flush_record(group, part_vecs)])
        return {"op": "sharded_flush",
                "ns_ids": {ns: int(i) for ns, i in self._ns_ids.items()},
                "parts": parts}

    def _apply_flush_record(self, record: dict) -> None:
        sessions = [
            (s["namespace"], Summary(**s["summary"]),
             [Triple(**td) for td in s["triples"]])
            for s in record["sessions"]]
        n, dim = int(record["n_rows"]), int(record["dim"])
        if dim != self.dim:
            raise StoreInvariantError(
                f"WAL flush record dim {dim} != store dim {self.dim}")
        vecs = (np.frombuffer(record["vecs"], "<f4").reshape(n, dim)
                if n else None)
        self._apply_flush(sessions, vecs)

    def apply_wal(self, record: dict) -> None:
        """Replay one WAL record through the same commit code the live
        mutation used.  Only valid on a store whose `wal_sink` is detached
        (replay must not append to the log it is reading)."""
        if self.wal_sink is not None:
            raise StoreInvariantError(
                "apply_wal with an attached wal_sink would re-log the "
                "records being replayed")
        op = record["op"]
        if op == "flush":
            self._apply_flush_record(record)
        elif op == "sharded_flush":
            # pin the live run's namespace-id assignment first: ids were
            # handed out in enqueue order, the parts arrive shard-grouped
            for ns, nid in record.get("ns_ids", {}).items():
                got = self._ns_ids.setdefault(str(ns), int(nid))
                if got != int(nid):
                    raise StoreInvariantError(
                        f"replayed namespace id for {ns!r} is {nid}, "
                        f"store already assigned {got}")
            for _shard, part in record["parts"]:
                self._apply_flush_record(part)
        elif op == "graph_edge":
            self._apply_link(record["namespace"], record["subject"],
                             record["object"], record["etype"],
                             float(record["weight"]))
        elif op == "evict_ns":
            self.evict_namespace(record["namespace"])
        elif op == "evict_superseded":
            self.evict_superseded(record["namespace"])
        elif op == "compact":
            self.compact()
        else:
            raise StoreInvariantError(f"unknown WAL record op {op!r}")

    def ingest(self, namespace: str, session_id: str,
               messages: Sequence[Message],
               conversation_id: Optional[str] = None
               ) -> Tuple[List[Triple], Summary]:
        """Synchronous write: enqueue + flush (drains anything else pending
        too).  Returns this session's extraction result."""
        self.enqueue(namespace, session_id, messages,
                     conversation_id=conversation_id)
        _, triples, summary = self.flush()[-1]
        return triples, summary

    # -- explicit graph edges ----------------------------------------------
    def link(self, namespace: str, subject: str, obj: str,
             etype: str = "entity", weight: float = 1.0) -> None:
        """Upsert one explicit graph edge between two entities of a tenant
        (both directions; entities intern through the same normalization as
        extraction, so linking "Caroline" reaches the node her triples
        built).  Durable: a `graph_edge` WAL record lands before the apply,
        and replay goes through the same `_apply_link`."""
        if etype not in EDGE_TYPE_IDS:
            raise ValueError(
                f"unknown edge type {etype!r}; expected one of "
                f"{sorted(EDGE_TYPE_IDS)}")
        if self.wal_sink is not None:    # durability point: WAL first
            self.wal_sink({"op": "graph_edge", "namespace": namespace,
                           "subject": subject, "object": obj,
                           "etype": etype, "weight": float(weight)})
        self._apply_link(namespace, subject, obj, etype, float(weight))

    def _apply_link(self, namespace: str, subject: str, obj: str,
                    etype: str, weight: float) -> None:
        ns_id = self.tenant(namespace).ns_id
        src = self.graph.intern(ns_id, subject)
        dst = self.graph.intern(ns_id, obj)
        self.graph.link_nodes(src, dst, EDGE_TYPE_IDS[etype], weight)
        self.graph.sync_device()

    # -- eviction ----------------------------------------------------------
    def evict_namespace(self, namespace: str) -> int:
        """Drop a whole tenant: tombstone its bank rows + BM25 docs, free
        its stores.  Returns the number of rows evicted."""
        self._pending = [p for p in self._pending
                         if p.namespace != namespace]
        if namespace not in self._tenants:
            return 0
        if self.wal_sink is not None:    # deterministic given store state
            self.wal_sink({"op": "evict_ns", "namespace": namespace})
        t = self._tenants.pop(namespace)
        live = [row for tid, row in enumerate(t.rows)
                if tid not in t.evicted and row >= 0]
        self.vindex.delete(live)
        self.bm25.remove(live)
        if self.sharded is not None:
            self.sharded.delete(live)
        return len(live)

    def evict_superseded(self, namespace: str) -> int:
        """Physically evict triples superseded under conflict resolution
        (the newest version of every (subject, predicate) key stays)."""
        t = self._tenants.get(namespace)
        if t is None:
            return 0
        fresh = [tid for tid in t.triples.superseded_ids()
                 if tid not in t.evicted]
        if fresh and self.wal_sink is not None:
            self.wal_sink({"op": "evict_superseded", "namespace": namespace})
        rows = [t.rows[tid] for tid in fresh]
        self.vindex.delete([r for r in rows if r >= 0])
        self.bm25.remove([r for r in rows if r >= 0])
        if self.sharded is not None:
            self.sharded.delete([r for r in rows if r >= 0])
        t.evicted.update(fresh)
        return len(fresh)

    # -- compaction --------------------------------------------------------
    def compact(self) -> dict:
        """Drop tombstoned rows and remap every global row id: the row
        tables, the BM25 corpus, the graph's row lanes and each tenant's
        `rows` list move together.  Pending sessions are flushed first."""
        self.flush()
        if self.wal_sink is not None:    # deterministic given store state
            self.wal_sink({"op": "compact"})
        before = self.vindex.n
        old_to_new = self.vindex.compact()
        bm_map = self.bm25.compact()
        if not np.array_equal(old_to_new, bm_map):
            raise StoreInvariantError(
                "compaction drift: the vector bank and the BM25 corpus "
                "disagree on which rows are tombstoned")
        keep = old_to_new >= 0
        self._row_tid = [tid for tid, k in zip(self._row_tid, keep) if k]
        for t in self._tenants.values():
            t.rows = [int(old_to_new[r]) if r >= 0 else -1 for r in t.rows]
        try:
            self.graph.compact_rows(old_to_new)
        except GraphInvariantError as e:
            raise StoreInvariantError(str(e)) from e
        if self.sharded is not None:     # global row ids moved wholesale
            self.sharded.invalidate()
        return {"rows_before": int(before), "rows_after": int(self.vindex.n),
                "dropped": int(before - self.vindex.n)}

    # -- persistence -------------------------------------------------------
    def snapshot(self, path: str, *, atomic: bool = False,
                 fsync: bool = False) -> int:
        """Write the full store state in the reference snapshot layout.
        Pending sessions are flushed first.  `atomic`/`fsync` forward to
        `io.save` — the lifecycle runtime's rotation uses both, so a crash
        mid-snapshot never clobbers the previous generation.  Returns bytes
        written."""
        if not self.durable_writer:      # rank 0 of the mesh writes it
            self.flush()
            return 0
        return ckpt_io.save(path, self.snapshot_arrays(), atomic=atomic,
                            fsync=fsync)

    @property
    def durable_writer(self) -> bool:
        """Whether this process writes the store's durable files: always
        with no mesh; on a mesh only its rank 0 (every rank holds the same
        host state, so one copy is written and every rank reads it)."""
        return self.mesh is None or not any(self.mesh.get_coordinate())

    def snapshot_arrays(self) -> Dict[str, np.ndarray]:
        """The flat {name: ndarray} dict `snapshot` writes (and `from_arrays`
        reads back), pending sessions flushed first."""
        self.flush()
        n = self.vindex.n
        triple_fields = [f.name for f in dataclasses.fields(Triple)]
        summary_fields = [f.name for f in dataclasses.fields(Summary)]
        meta = {
            "version": SNAPSHOT_VERSION,
            "dim": self.dim,
            "bm25": {"k1": self.bm25.k1, "b": self.bm25.b,
                     "max_doc_len": self.bm25.max_doc_len},
            "ns_ids": dict(self._ns_ids),
            "tenants": {
                ns: {
                    "ns_id": t.ns_id,
                    "rows": [int(r) for r in t.rows],
                    "evicted": sorted(t.evicted),
                    "triples": [_as_record(tr, triple_fields)
                                for tr in t.triples.all()],
                    "summaries": [_as_record(s, summary_fields)
                                  for s in t.summaries.all()],
                } for ns, t in self._tenants.items()
            },
            "graph": self.graph.snapshot_meta(),
        }
        blob = np.frombuffer(packing.packb(meta), np.uint8)
        arrays = {
            "bank": self.vindex.bank.copy(),
            "bank_alive": self.vindex.alive(),
            "row_ns": self.vindex.row_namespaces(),
            "row_tid": np.asarray(self._row_tid, np.int32),
            "bm25_docs": self.bm25.doc_array(),
            "bm25_lens": self.bm25.len_array(),
            "bm25_ns": self.bm25.ns_array(),
            "bm25_alive": self.bm25.alive_array(),
            **self.graph.snapshot_arrays(),
            "meta": blob,
        }
        if self.graph.n_rows != n or arrays["row_tid"].shape != (n,):
            raise StoreInvariantError(
                f"snapshot: row tables ({arrays['row_tid'].shape[0]}) or "
                f"graph lanes ({self.graph.n_rows}) out of sync with the "
                f"bank ({n})")
        return arrays

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray], embedder, *,
                    extractor: Optional[Extractor] = None,
                    tokenizer: HashTokenizer | None = None,
                    quantize: str = "none", rescore: int = 4,
                    device="cuda", shards: int = 1,
                    mesh=None) -> "MemoryStore":
        """Build a store from the flat {name: ndarray} dict a version-2
        snapshot loads to (either package's `checkpoint.io.load_raw`).  The
        result answers retrieval identically to the store that wrote it.
        `quantize`/`rescore`/`shards` pick the restored index's device bank
        mode and placement; the snapshot itself is always f32 and
        placement-agnostic (a sharded store lays its slabs out on the first
        search)."""
        meta = packing.unpackb(np.asarray(arrays["meta"]).tobytes())
        if meta["version"] != SNAPSHOT_VERSION:
            raise StoreInvariantError(
                f"snapshot version {meta['version']} != {SNAPSHOT_VERSION}")
        store = cls(embedder, extractor, dim=int(meta["dim"]),
                    tokenizer=tokenizer, quantize=quantize, rescore=rescore,
                    device=device, shards=shards, mesh=mesh)
        store.vindex.load_rows(arrays["bank"], arrays["bank_alive"],
                               ns=arrays["row_ns"])
        bm = meta["bm25"]
        store.bm25.k1, store.bm25.b = float(bm["k1"]), float(bm["b"])
        store.bm25.max_doc_len = int(bm["max_doc_len"])
        store.bm25.load_rows(arrays["bm25_docs"], arrays["bm25_lens"],
                             arrays["bm25_ns"], arrays["bm25_alive"])
        store._row_tid = [int(x) for x in arrays["row_tid"]]
        store._ns_ids = {str(k): int(v) for k, v in meta["ns_ids"].items()}
        for ns, td in meta["tenants"].items():
            t = TenantState(ns_id=int(td["ns_id"]))
            for trd in td["triples"]:
                t.triples.add(Triple(**trd))
            for sd in td["summaries"]:
                t.summaries.add(Summary(**sd))
            t.rows = [int(r) for r in td["rows"]]
            t.evicted = set(int(i) for i in td["evicted"])
            store._tenants[str(ns)] = t
        try:
            store.graph = MemoryGraph.from_snapshot(arrays, meta["graph"],
                                                    device=store.device)
        except GraphInvariantError as e:
            raise StoreInvariantError(str(e)) from e
        if len(store._row_tid) != store.vindex.n or \
                store.vindex.n != len(store.bm25) or \
                store.graph.n_rows != store.vindex.n:
            raise StoreInvariantError(
                f"restore: bank ({store.vindex.n}), BM25 "
                f"({len(store.bm25)}), row tables "
                f"({len(store._row_tid)}) and graph lanes "
                f"({store.graph.n_rows}) disagree")
        return store

    @classmethod
    def restore(cls, path: str, embedder, **kwargs) -> "MemoryStore":
        """Reconstruct a store from a version-2 snapshot file (written by
        either package).  Keyword arguments go to `from_arrays`."""
        return cls.from_arrays(ckpt_io.load_raw(path), embedder, **kwargs)

    # -- sharded retrieval --------------------------------------------------
    def sharded_search(self, queries, q_ns, k: int):
        """Namespace-masked top-k over the shard-major device bank: one K1
        launch, returns device (scores (Q, k) f32, rows (Q, k) i32 global
        ids).  Rebuilds the shard layout lazily when stale (first search,
        after compaction or restore)."""
        if self.sharded is None:
            raise StoreInvariantError("store was built with shards=1")
        if self.sharded.stale:
            self.sharded.rebuild(self.vindex)
        return self.sharded.search(queries, q_ns, k)

    def shard_of_namespace(self, namespace: str) -> Optional[int]:
        """Which shard owns a namespace's rows (None if unknown tenant or
        unsharded)."""
        if self.sharded is None:
            return None
        t = self._tenants.get(namespace)
        return None if t is None else t.ns_id % self.shards

    def shard_down(self, shard: int) -> None:
        """Take one shard out of retrieval (graceful degradation: surviving
        shards keep answering, the service stamps affected responses
        `degraded`)."""
        if self.sharded is None:
            raise StoreInvariantError("store was built with shards=1")
        self.sharded.mark_down(shard)

    def shard_up(self, shard: int) -> None:
        if self.sharded is None:
            raise StoreInvariantError("store was built with shards=1")
        self.sharded.mark_up(shard)

    def down_shards(self) -> List[int]:
        return sorted(self.sharded.down) if self.sharded is not None else []

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        per_ns = {
            ns: {
                "triples": len(t.triples),
                "summaries": len(t.summaries),
                "evicted": len(t.evicted),
            } for ns, t in self._tenants.items()
        }
        vi = self.vindex
        out = {
            "namespaces": len(self._tenants),
            "bank_rows": vi.n,
            "alive_rows": vi.n_alive,
            "tombstones": vi.n_dead,
            "bm25_docs": len(self.bm25),
            "pending": len(self._pending),
            "bank": {
                "quantize": vi.quantize,
                "quantized": vi.quantize != "none",
                "rescore": vi.rescore,
                "hot_rows": vi.n_resident,
                "warm_rows": vi.n_warm,
                "rescore_hit_rate": (
                    vi.counters["rescore_hits"] / vi.counters["rescore_rows"]
                    if vi.counters["rescore_rows"] else None),
                **vi.counters,
            },
            "per_namespace": per_ns,
            "graph": self.graph.stats(),
        }
        if self.tiers is not None:
            out["tiering"] = self.tiers.stats()
        if self.sharded is not None:
            out["shards"] = self.sharded.stats()
        return out
