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
  `load_raw` + `from_arrays`.

This slice of the port is unsharded, keeps every row on the device, and
has no write-ahead-log sink.

Layout invariant (checked, raising StoreInvariantError): global row id ==
BM25 doc id == position in the row tables; tenant-local `rows[tid]` maps a
triple id back to its global row (-1 once compacted away).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.common.utils import resolve_device
from repro_torch.core.bm25 import BM25Index
from repro_torch.core.extraction import Extractor, Message, RuleExtractor
from repro_torch.core.graph import GraphInvariantError, MemoryGraph
from repro_torch.core.summaries import Summary, SummaryStore
from repro_torch.core.triples import Triple, TripleStore
from repro_torch.core.vector_index import VectorIndex
from repro_torch.data.tokenizer import HashTokenizer, default_tokenizer
from repro_torch.obs.telemetry import FLUSH_LATENCY, get_telemetry

# the reference package's snapshot layout version (graph_* arrays +
# meta["graph"]); other versions are refused rather than half-read
SNAPSHOT_VERSION = 2


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
                 device="cuda"):
        self.embedder = embedder
        self.extractor = extractor or RuleExtractor()
        self.tokenizer = tokenizer or default_tokenizer()
        self.dim = dim
        self.device = resolve_device(device)
        self.vindex = VectorIndex(dim=dim, device=self.device)
        self.bm25 = BM25Index(tokenizer=self.tokenizer, device=self.device)
        self.graph = MemoryGraph(device=self.device)
        self._tenants: Dict[str, TenantState] = {}
        self._ns_ids: Dict[str, int] = {}      # survives evict(): tombstoned
        #                                        rows keep a retired ns id
        self._row_tid: List[int] = []          # global row -> local tid
        self._pending: List[PendingSession] = []

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
        (namespace, triples, summary) in enqueue order.  All-or-nothing:
        if extraction or embedding raises, the queue is restored intact
        and nothing is committed."""
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
                flat = [tr for _, triples, _ in batch for tr in triples]
                vecs = self.embedder.embed_texts(            # one embed call
                    [tr.text() for tr in flat]) if flat else None
                sessions = [(p.namespace, summary, triples)
                            for p, triples, summary in batch]
            except BaseException:
                # restore the queue (ahead of anything enqueued since)
                self._pending = pending + self._pending
                raise
            self._apply_flush(sessions, vecs)
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
            self.tenant(ns).summaries.add(summary)
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

    # -- eviction ----------------------------------------------------------
    def evict_namespace(self, namespace: str) -> int:
        """Drop a whole tenant: tombstone its bank rows + BM25 docs, free
        its stores.  Returns the number of rows evicted."""
        self._pending = [p for p in self._pending
                         if p.namespace != namespace]
        if namespace not in self._tenants:
            return 0
        t = self._tenants.pop(namespace)
        live = [row for tid, row in enumerate(t.rows)
                if tid not in t.evicted and row >= 0]
        self.vindex.delete(live)
        self.bm25.remove(live)
        return len(live)

    def evict_superseded(self, namespace: str) -> int:
        """Physically evict triples superseded under conflict resolution
        (the newest version of every (subject, predicate) key stays)."""
        t = self._tenants.get(namespace)
        if t is None:
            return 0
        fresh = [tid for tid in t.triples.superseded_ids()
                 if tid not in t.evicted]
        rows = [t.rows[tid] for tid in fresh]
        self.vindex.delete([r for r in rows if r >= 0])
        self.bm25.remove([r for r in rows if r >= 0])
        t.evicted.update(fresh)
        return len(fresh)

    # -- compaction --------------------------------------------------------
    def compact(self) -> dict:
        """Drop tombstoned rows and remap every global row id: the row
        tables, the BM25 corpus, the graph's row lanes and each tenant's
        `rows` list move together.  Pending sessions are flushed first."""
        self.flush()
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
        return {"rows_before": int(before), "rows_after": int(self.vindex.n),
                "dropped": int(before - self.vindex.n)}

    # -- persistence -------------------------------------------------------
    def snapshot(self, path: str, *, fsync: bool = False) -> int:
        """Write the full store state in the reference snapshot layout.
        Pending sessions are flushed first.  Returns bytes written."""
        import msgpack
        self.flush()
        n = self.vindex.n
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
                    "triples": [dataclasses.asdict(tr)
                                for tr in t.triples.all()],
                    "summaries": [dataclasses.asdict(s)
                                  for s in t.summaries.all()],
                } for ns, t in self._tenants.items()
            },
            "graph": self.graph.snapshot_meta(),
        }
        blob = np.frombuffer(msgpack.packb(meta, use_bin_type=True),
                             np.uint8)
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
        return ckpt_io.save(path, arrays, fsync=fsync)

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray], embedder, *,
                    extractor: Optional[Extractor] = None,
                    tokenizer: HashTokenizer | None = None,
                    device="cuda") -> "MemoryStore":
        """Build a store from the flat {name: ndarray} dict a version-2
        snapshot loads to (either package's `checkpoint.io.load_raw`).  The
        result answers retrieval identically to the store that wrote it."""
        import msgpack
        meta = msgpack.unpackb(np.asarray(arrays["meta"]).tobytes(),
                               raw=False)
        if meta["version"] != SNAPSHOT_VERSION:
            raise StoreInvariantError(
                f"snapshot version {meta['version']} != {SNAPSHOT_VERSION}")
        store = cls(embedder, extractor, dim=int(meta["dim"]),
                    tokenizer=tokenizer, device=device)
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

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        per_ns = {
            ns: {
                "triples": len(t.triples),
                "summaries": len(t.summaries),
                "evicted": len(t.evicted),
            } for ns, t in self._tenants.items()
        }
        return {
            "namespaces": len(self._tenants),
            "bank_rows": self.vindex.n,
            "alive_rows": self.vindex.n_alive,
            "tombstones": self.vindex.n_dead,
            "bm25_docs": len(self.bm25),
            "pending": len(self._pending),
            "per_namespace": per_ns,
            "graph": self.graph.stats(),
        }
