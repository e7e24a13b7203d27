"""Typed request API for the memory service — the public frontend surface.

The paper's economics come from batching every tenant through one embed
call and one masked kernel launch, but a positional
`retrieve_batch([(ns, q), ...])` only delivers that when a single caller
hand-assembles the batch.  Production deployments are many independent
clients issuing one operation at a time, each with its own options — so the
public surface is *requests*, not method arguments:

* `RetrieveRequest` / `RecordRequest` / `EvictRequest` / `CompactRequest`
  are immutable, validated descriptions of one operation, carrying every
  per-request option (`top_k`, dense/sparse `weights`, plan `stages`).
* `MemoryResponse` is the uniform envelope every operation resolves to:
  payload, status, error, queue/service timing, token counts, and the size
  of the device batch the request shared.
* `RetrievalPlan` names the stage pipeline a retrieve runs —
  embed → dense → sparse → fuse → budget — with variants that drop stages
  (`dense_only`, `sparse_only`, `raw` = no token budgeting, fused ids out).

Requests are what `core/scheduler.py`'s MemoryScheduler collects from many
threads and fuses into one device launch per tick; `MemoryService.execute`
is the engine that runs a homogeneous batch of RetrieveRequests through one
embed + one masked top-k + one stacked BM25 + one fused RRF launch,
honoring per-request options by fusing at max(top_k) on device and slicing
per request.  The legacy tuple/kwargs surface remains as thin wrappers that
build requests (see docs/API.md for the migration map).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple, Union

from repro_torch.core.extraction import Message

STAGE_DENSE = "dense"
STAGE_SPARSE = "sparse"
STAGE_GRAPH = "graph"
STAGE_FUSE = "fuse"
STAGE_BUDGET = "budget"
KNOWN_STAGES = (STAGE_DENSE, STAGE_SPARSE, STAGE_GRAPH, STAGE_FUSE,
                STAGE_BUDGET)
# what a plain RetrievalPlan() runs: graph expansion is opt-in (the
# graph_expanded variant / per-request stages), so existing flat-retrieval
# callers keep their exact rankings
DEFAULT_STAGES = (STAGE_DENSE, STAGE_SPARSE, STAGE_FUSE, STAGE_BUDGET)


def _check_stages(stages: Sequence[str]) -> Tuple[str, ...]:
    stages = tuple(dict.fromkeys(stages))
    unknown = [s for s in stages if s not in KNOWN_STAGES]
    if unknown:
        raise ValueError(f"unknown retrieval stages {unknown}; "
                         f"known: {KNOWN_STAGES}")
    if STAGE_DENSE not in stages and STAGE_SPARSE not in stages:
        raise ValueError("a retrieval plan needs at least one of "
                         "'dense' / 'sparse'"
                         + (" ('graph' expands their seed rows, it cannot "
                            "seed itself)" if STAGE_GRAPH in stages else ""))
    # fuse is how rankings become one result — it is always implied, even
    # for a single ranking (the B=1-ranking fuse is what keeps dense-only
    # ordering identical to hybrid ordering restricted to dense hits)
    if STAGE_FUSE not in stages:
        stages = stages + (STAGE_FUSE,)
    return stages


MAX_HOPS = 8          # the deepest unrolled expansion the service compiles


def _check_graph_opts(hops, edge_weights) -> None:
    if hops is not None and not (1 <= hops <= MAX_HOPS):
        raise ValueError(f"hops must be in [1, {MAX_HOPS}], got {hops}")
    if edge_weights is not None:
        if len(edge_weights) != 3:
            raise ValueError(
                "edge_weights must be (entity, temporal, causal) — "
                f"3 floats, got {len(edge_weights)}")
        if any(w < 0 for w in edge_weights):
            raise ValueError("edge_weights must be >= 0")


@dataclasses.dataclass(frozen=True)
class RetrievalPlan:
    """The stage pipeline a retrieve runs, plus its default knobs.

    `stages` ⊆ {dense, sparse, graph, fuse, budget}; at least one of
    dense/sparse; fuse is implied.  Dropping `budget` returns a
    `RawRetrieval` (fused global row ids + scores, no token budgeting, no
    rendering) instead of a `RetrievedContext`.  Every knob here is a
    *default*: a RetrieveRequest may override any of them per request, and
    mixed-option requests still share one device launch.

    The `graph` stage (docs/API.md) expands the dense/sparse seed rows
    through the store's entity graph — `hops` k-hop depth, `edge_weights`
    per edge type (entity, temporal, causal), `graph_weight` the expanded
    ranking's RRF weight column.  `graph_seed_k` (how many top rows of each
    upstream ranking seed the frontier) and `graph_decay` (per-hop score
    decay) are plan-level: they are compiled into the expansion executable,
    so they cannot vary per request within a batch."""
    stages: Tuple[str, ...] = DEFAULT_STAGES
    top_k: Optional[int] = None
    dense_weight: Optional[float] = None
    sparse_weight: Optional[float] = None
    hops: Optional[int] = None                      # default 2
    edge_weights: Optional[Tuple[float, float, float]] = None
    graph_weight: Optional[float] = None            # default 0.6
    graph_seed_k: int = 8
    graph_decay: float = 0.5

    def __post_init__(self):
        object.__setattr__(self, "stages", _check_stages(self.stages))
        if self.top_k is not None and self.top_k < 1:
            raise ValueError("top_k must be >= 1")
        _check_graph_opts(self.hops, self.edge_weights)
        if self.graph_seed_k < 1:
            raise ValueError("graph_seed_k must be >= 1")
        if not (0.0 < self.graph_decay <= 1.0):
            raise ValueError("graph_decay must be in (0, 1]")
        if self.edge_weights is not None:
            object.__setattr__(self, "edge_weights",
                               tuple(float(w) for w in self.edge_weights))

    # -- variants ----------------------------------------------------------
    @classmethod
    def hybrid(cls, **kw) -> "RetrievalPlan":
        return cls(**kw)

    @classmethod
    def dense_only(cls, budget: bool = True, **kw) -> "RetrievalPlan":
        st = (STAGE_DENSE, STAGE_FUSE) + ((STAGE_BUDGET,) if budget else ())
        return cls(stages=st, **kw)

    @classmethod
    def sparse_only(cls, budget: bool = True, **kw) -> "RetrievalPlan":
        st = (STAGE_SPARSE, STAGE_FUSE) + ((STAGE_BUDGET,) if budget else ())
        return cls(stages=st, **kw)

    @classmethod
    def raw(cls, **kw) -> "RetrievalPlan":
        """Hybrid retrieval, fused ids out: no budgeting, no rendering."""
        return cls(stages=(STAGE_DENSE, STAGE_SPARSE, STAGE_FUSE), **kw)

    @classmethod
    def graph_expanded(cls, budget: bool = True, **kw) -> "RetrievalPlan":
        """Hybrid + k-hop graph expansion of the seed rows
        (embed → dense → sparse → graph → fuse [→ budget])."""
        st = (STAGE_DENSE, STAGE_SPARSE, STAGE_GRAPH, STAGE_FUSE) + \
            ((STAGE_BUDGET,) if budget else ())
        return cls(stages=st, **kw)

    @property
    def wants_dense(self) -> bool:
        return STAGE_DENSE in self.stages

    @property
    def wants_sparse(self) -> bool:
        return STAGE_SPARSE in self.stages

    @property
    def wants_graph(self) -> bool:
        return STAGE_GRAPH in self.stages

    @property
    def wants_budget(self) -> bool:
        return STAGE_BUDGET in self.stages


@dataclasses.dataclass(frozen=True)
class RetrieveRequest:
    """One tenant's retrieval with its own options.  `None` options fall
    back to the plan's defaults, then the service's."""
    namespace: str
    query: str
    top_k: Optional[int] = None
    dense_weight: Optional[float] = None
    sparse_weight: Optional[float] = None
    stages: Optional[Tuple[str, ...]] = None
    # graph-stage options (only read when the resolved stages include
    # 'graph'); requests with different hops/edge_weights still share one
    # expansion launch — hop depth rides in as a traced per-request vector
    hops: Optional[int] = None
    edge_weights: Optional[Tuple[float, float, float]] = None
    graph_weight: Optional[float] = None

    def __post_init__(self):
        if not isinstance(self.namespace, str):
            raise TypeError(f"namespace must be str, got "
                            f"{type(self.namespace).__name__}")
        if not isinstance(self.query, str):
            raise TypeError(f"query must be str, got "
                            f"{type(self.query).__name__}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError("top_k must be >= 1")
        if self.stages is not None:
            object.__setattr__(self, "stages", _check_stages(self.stages))
        _check_graph_opts(self.hops, self.edge_weights)
        if self.edge_weights is not None:
            object.__setattr__(self, "edge_weights",
                               tuple(float(w) for w in self.edge_weights))


@dataclasses.dataclass(frozen=True)
class RecordRequest:
    """Async ingest of one session.  Resolves once the session is accepted
    into the (backpressured) write queue — and, when the scheduler flushes
    per tick, once the tick's batched flush has committed and its WAL
    record is durable."""
    namespace: str
    session_id: str
    messages: Tuple[Message, ...]
    conversation_id: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "messages", tuple(self.messages))
        if not self.messages:
            raise ValueError("RecordRequest needs at least one message")


@dataclasses.dataclass(frozen=True)
class EvictRequest:
    """Evict a whole namespace, or (superseded_only) just the triples
    superseded under conflict resolution."""
    namespace: str
    superseded_only: bool = False


@dataclasses.dataclass(frozen=True)
class CompactRequest:
    """Reclaim tombstoned rows across the whole store."""


MemoryRequest = Union[RetrieveRequest, RecordRequest, EvictRequest,
                      CompactRequest]


@dataclasses.dataclass
class RawRetrieval:
    """The no-budget payload: the fused ranking itself.  `row_ids` are
    global bank rows (valid until the next compaction remaps them),
    `triple_ids` the tenant-local triple ids behind them."""
    row_ids: List[int]
    triple_ids: List[int]
    scores: List[float]
    # True when the owning shard was down at retrieval time (empty by
    # design — the batch's surviving requests answered normally)
    degraded: bool = False


@dataclasses.dataclass
class MemoryResponse:
    """The uniform envelope every submitted request resolves to."""
    payload: Any                      # RetrievedContext | RawRetrieval |
    #                                   int (evict) | dict (record/compact)
    op: str = ""                      # retrieve | record | evict | compact
    status: str = "ok"                # "ok" | "error"
    error: Optional[str] = None
    exception: Optional[BaseException] = None   # in-process detail
    queued_s: float = 0.0             # submit -> tick pickup
    service_s: float = 0.0            # execution time inside the tick
    batch_size: int = 1               # requests sharing the device launch
    token_count: Optional[int] = None  # retrieves with a budget stage
    degraded: bool = False            # served with the owning shard down

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def result(self) -> Any:
        """Payload, or re-raise the request's failure."""
        if self.status != "ok":
            if self.exception is not None:
                raise self.exception
            raise RuntimeError(self.error or "memory request failed")
        return self.payload


# -- wire mapping (serving/frontend.py + the SDK's HTTP mode) ----------------
#
# The HTTP surface speaks exactly these types: a JSON body maps onto one
# typed request (validated by the same __post_init__ checks a direct caller
# gets), and every response is the MemoryResponse envelope rendered to
# JSON.  Keeping the codec here — next to the types — means the wire format
# can never drift from the in-process API.

def message_from_json(obj: dict) -> Message:
    if not isinstance(obj, dict) or "text" not in obj:
        raise ValueError("message must be an object with at least 'text'")
    return Message(speaker=str(obj.get("speaker", "user")),
                   text=str(obj["text"]),
                   timestamp=float(obj.get("timestamp", 0.0)))


def retrieve_request_from_json(obj: dict, namespace: str) -> RetrieveRequest:
    """One JSON query object -> RetrieveRequest.  `namespace` is the
    tenancy-scoped namespace the frontend already resolved (api key ->
    tenant -> `tenant/<client namespace>`); the body never names a raw
    service namespace."""
    stages = obj.get("stages")
    return RetrieveRequest(
        namespace=namespace, query=str(obj.get("query", "")),
        top_k=None if obj.get("top_k") is None else int(obj["top_k"]),
        dense_weight=(None if obj.get("dense_weight") is None
                      else float(obj["dense_weight"])),
        sparse_weight=(None if obj.get("sparse_weight") is None
                       else float(obj["sparse_weight"])),
        stages=None if stages is None else tuple(stages),
        hops=None if obj.get("hops") is None else int(obj["hops"]),
        edge_weights=(None if obj.get("edge_weights") is None
                      else tuple(float(w) for w in obj["edge_weights"])),
        graph_weight=(None if obj.get("graph_weight") is None
                      else float(obj["graph_weight"])))


def record_request_from_json(obj: dict, namespace: str) -> RecordRequest:
    msgs = obj.get("messages")
    if not isinstance(msgs, list):
        raise ValueError("record body needs a 'messages' list")
    return RecordRequest(
        namespace=namespace,
        session_id=str(obj.get("session_id", "s0")),
        messages=tuple(message_from_json(m) for m in msgs),
        conversation_id=obj.get("conversation_id"))


def payload_to_json(payload: Any) -> Any:
    """Render a response payload for the wire.  RetrievedContext and
    RawRetrieval become typed objects (`kind` discriminates); ints/dicts
    (evict counts, record/compact summaries) pass through."""
    if payload is None or isinstance(payload, (int, float, str, dict)):
        return payload
    if isinstance(payload, RawRetrieval):
        return {"kind": "raw_retrieval", "row_ids": list(payload.row_ids),
                "triple_ids": list(payload.triple_ids),
                "scores": list(payload.scores),
                "degraded": bool(payload.degraded)}
    # RetrievedContext (duck-typed: core.memory imports this module's
    # sibling types, so importing it here would cycle)
    if hasattr(payload, "triples") and hasattr(payload, "text"):
        return {
            "kind": "retrieved_context",
            "text": payload.text,
            "token_count": payload.token_count,
            "degraded": bool(getattr(payload, "degraded", False)),
            "triples": [dataclasses.asdict(t) for t in payload.triples],
            "summaries": [dataclasses.asdict(s) for s in payload.summaries],
        }
    return repr(payload)


def response_to_json(resp: "MemoryResponse") -> dict:
    """The uniform wire envelope: every field of MemoryResponse except the
    in-process `exception` object."""
    return {
        "status": resp.status,
        "op": resp.op,
        "error": resp.error,
        "payload": payload_to_json(resp.payload),
        "queued_s": resp.queued_s,
        "service_s": resp.service_s,
        "batch_size": resp.batch_size,
        "token_count": resp.token_count,
        "degraded": resp.degraded,
    }


def as_retrieve_request(req, top_k: Optional[int] = None) -> RetrieveRequest:
    """Coerce the legacy positional shape — an (namespace, query) tuple —
    into a RetrieveRequest.  A batch-global `top_k` kwarg becomes the
    per-request default (an explicit per-request top_k wins: that is the
    fix for the old silently-shared batch-global k)."""
    if isinstance(req, RetrieveRequest):
        if top_k is not None and req.top_k is None:
            return dataclasses.replace(req, top_k=top_k)
        return req
    ns, q = req
    return RetrieveRequest(namespace=ns, query=q, top_k=top_k)
