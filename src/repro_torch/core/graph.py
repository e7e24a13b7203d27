"""MemoryGraph — the device-resident entity graph over the triple store.

Triples name entities and version chains, and sessions order facts in time.
This module packs that structure into adjacency lanes next to the bank and
turns retrieval's seed rows into a batched k-hop expansion — the `graph`
stage of RetrievalPlan.

**Nodes** are interned entities: one node per (namespace id, normalized
entity text), normalized by `triples.normalize_entity` (the same
canonicalization `Triple.key` uses).  Interning is per namespace, so no
edge ever connects two tenants (the expansion masks by node and row
namespace anyway).

**Edges** are typed and directed (every upsert inserts both directions):

* ``entity`` (0)   — subject ↔ object of every triple (co-occurrence),
* ``temporal`` (1) — consecutive triples' object nodes within one session's
  extraction order,
* ``causal`` (2)   — version chains: when a triple supersedes an earlier
  value of the same `Triple.key`, the old object links to the new one.

**Row incidence lanes** map every global bank row to its subject/object
node ids (-1 when none), remapped through `compact_rows` like row ids
everywhere else in the store; node and edge lanes are append-only.

**Device residency** follows `core/vector_index.py`: host mirrors are the
source of truth (snapshot, compaction), and the device lanes are
capacity-doubling tensors that `sync_device` extends in place (slice
assignment) with the delta since the last sync; a lane is re-uploaded only
when its host capacity doubles (`counters["lane_uploads"]` counts those).

**Expansion semantics** (`expand`): seed rows activate their incident
nodes at 1.0; each hop relaxes every edge once —

    contribution(dst) = ((F[src] * (type_w[b, type] * edge_w)) * decay)
                        / out_degree(src)

— combined by max (a scatter-max, independent of order), so it matches
the reference package's expansion and its scalar oracle bit for bit in
float32.  Each product and the division is its own elementwise op, so no
multiply is ever contracted into an FMA.  Seed nodes never score rows.  A
row's score is the max over its incident nodes' activations, masked to the
request's namespace; rows rank by (-score, row id).  Hop counts are per
request; the loop runs to the batch's (pow2-bucketed) maximum.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.utils import (next_pow2, resolve_device, to_device,
                                      upload)
from repro_torch.core.triples import normalize_entity

EDGE_ENTITY = 0
EDGE_TEMPORAL = 1
EDGE_CAUSAL = 2
N_EDGE_TYPES = 3
EDGE_TYPE_NAMES = ("entity", "temporal", "causal")
EDGE_TYPE_IDS = {n: i for i, n in enumerate(EDGE_TYPE_NAMES)}

_LANES = ("node_ns", "edge_src", "edge_dst", "edge_type", "edge_w",
          "row_sub", "row_obj")


def _next_capacity(n: int, floor: int = 64) -> int:
    return max(floor, next_pow2(max(1, n)))


def _expand_device(edge_src, edge_dst, edge_type, edge_w, node_ns,
                   row_sub, row_obj, row_labels, rankings, q_ns, type_w,
                   hops_b, n_edges: int, n_rows: int, *, hops: int, k: int,
                   seed_k: int, decay: float):
    """Batched k-hop expansion over the lanes, the whole batch at once:
    per hop one gather and one scatter-max over the live edges.  Tensors
    on one device: the (capacity,) lanes, `rankings` a sequence of (B, P_i)
    int id matrices (-1-padded, best-first), `q_ns` (B,) int, `type_w`
    (B, 3) f32, `hops_b` (B,) int.  Only the first `n_edges` edges and
    `n_rows` rows are live.  Returns (row ids (B, k) i32 best-first
    -1-padded, scores (B, k) f32 0-padded, and one (2, hops) i32 tensor:
    frontier sizes, then edges touched, per hop; hops >= 1)."""
    dev = q_ns.device
    B = q_ns.shape[0]
    Ncap = node_ns.shape[0]
    Rcap = row_sub.shape[0]
    Lcap = row_labels.shape[0]
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    decay32 = torch.tensor(np.float32(decay), device=dev)
    q_ns = q_ns.long()
    # -- seeds: top seed_k of every upstream ranking -> incident nodes ------
    seeds = torch.cat([r[:, : min(seed_k, r.shape[1])].long()
                       for r in rankings], dim=1)
    ok = (seeds >= 0) & (seeds < n_rows)
    srow = torch.where(ok, seeds, 0)
    ok = ok & (row_labels.long()[srow.clamp(0, Lcap - 1)] == q_ns[:, None])
    F = torch.zeros((B, Ncap), dtype=f32, device=dev)
    for lane in (row_sub, row_obj):
        nodes = torch.where(ok, lane.long()[srow.clamp(0, Rcap - 1)], -1)
        F.scatter_reduce_(1, nodes.clamp(0, Ncap - 1),
                          (nodes >= 0).to(f32), "amax")
    ns_ok = node_ns.long()[None, :] == q_ns[:, None]      # (B, Ncap)
    F = torch.where(ns_ok, F, zero)
    # seed nodes never score rows — not their hop-0 activation and not a
    # later re-activation (a hub seed round-trips at full strength and would
    # tie every row it touches); seed rows are the upstream rankings' job
    seed_mask = F > 0
    acc = torch.zeros_like(F)
    # -- per-expansion edge terms over the live edges -------------------------
    src_c = edge_src[:n_edges].long().clamp(0, Ncap - 1)
    dst_c = edge_dst[:n_edges].long().clamp(0, Ncap - 1)
    deg_f = torch.bincount(src_c, minlength=Ncap).clamp(min=1).to(f32)
    we = type_w[:, edge_type[:n_edges].long().clamp(0, N_EDGE_TYPES - 1)] \
        * edge_w[None, :n_edges]                            # (B, E)
    deg_src = deg_f[src_c][None, :]
    dst_b = dst_c[None, :].expand(B, -1)
    hops_b = hops_b.long()
    stats = []
    for h in range(1, hops + 1):
        c = F[:, src_c] * we          # float32 op order: the oracle contract
        c = c * decay32
        c = c / deg_src
        newF = torch.zeros((B, Ncap), dtype=f32, device=dev)
        newF.scatter_reduce_(1, dst_b, c, "amax")
        newF = torch.where(ns_ok & (hops_b >= h)[:, None], newF, zero)
        acc = torch.maximum(acc, newF)
        F = newF
        stats.append(torch.stack([(newF > 0).sum(), (c > 0).sum()]))
    # -- node activations -> row ranking ------------------------------------
    acc = torch.where(seed_mask, zero, acc)
    r_idx = torch.arange(n_rows, device=dev)
    rl = row_labels.long()[r_idx.clamp(max=Lcap - 1)]
    r_ok = rl[None, :] == q_ns[:, None]
    rs, ro = (torch.where(lane[None, :n_rows] >= 0,
                          acc[:, lane[:n_rows].long().clamp(0, Ncap - 1)],
                          zero)
              for lane in (row_sub, row_obj))
    score = torch.where(r_ok, torch.maximum(rs, ro), zero)  # (B, n_rows)
    hit = score > 0
    # (-score, row id): the columns are already in row order, so a stable
    # sort on -score alone breaks ties to the lower row
    neg = torch.where(hit, -score, torch.full_like(score, float("inf")))
    neg_s, order = torch.sort(neg, dim=1, stable=True)
    kk = min(k, n_rows)
    alive = neg_s[:, :kk] < float("inf")
    ids = torch.where(alive, order[:, :kk], -1).to(torch.int32)
    scores = torch.where(alive, -neg_s[:, :kk], zero)
    if kk < k:
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
        scores = torch.nn.functional.pad(scores, (0, k - kk))
    return ids, scores, torch.stack(stats, dim=1).to(torch.int32)


class GraphInvariantError(RuntimeError):
    """A graph-internal alignment invariant was violated (lane drift).
    The store wraps this into StoreInvariantError at its boundary."""


class MemoryGraph:
    """Entity/temporal/causal graph with host-mirror truth and in-place
    device lanes.  All writes land host-side immediately; `sync_device()`
    pushes the accumulated delta to the device lanes (the store calls it
    once per flush)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        # host truth: nodes
        self._node_text: List[str] = []
        self._node_ns = np.full((64,), -1, np.int32)
        self._intern: Dict[Tuple[int, str], int] = {}
        # host truth: directed COO edge lanes
        self._edge_src = np.zeros((64,), np.int32)
        self._edge_dst = np.zeros((64,), np.int32)
        self._edge_type = np.zeros((64,), np.int32)
        self._edge_w = np.zeros((64,), np.float32)
        self._n_edges = 0
        self._edge_idx: Dict[Tuple[int, int, int], int] = {}
        # host truth: row incidence
        self._row_sub = np.full((64,), -1, np.int32)
        self._row_obj = np.full((64,), -1, np.int32)
        self._n_rows = 0
        # per-(ns, triple-key) version-chain tail: last object node
        self._tail: Dict[Tuple[int, str], int] = {}
        # device lanes (materialized by the first sync, then updated in
        # place)
        self._dev = None                     # dict of lane tensors
        self._synced = (0, 0, 0)             # (nodes, edges, rows) on device
        self._pending_w: List[int] = []      # edge ids with re-set weights
        # lane_uploads: whole-lane uploads (the first sync and one after
        # each capacity doubling); steady-state syncs write deltas in place
        self.counters = {"expansions": 0, "edges_upserted": 0,
                         "lane_uploads": 0}

    # -- sizes --------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self._node_text)

    @property
    def n_edges(self) -> int:
        return self._n_edges

    @property
    def n_rows(self) -> int:
        return self._n_rows

    def edge_type_counts(self) -> Dict[str, int]:
        et = self._edge_type[: self._n_edges]
        return {name: int((et == i).sum())
                for i, name in enumerate(EDGE_TYPE_NAMES)}

    # -- host mirrors -------------------------------------------------------
    def node_ns(self) -> np.ndarray:
        return self._node_ns[: self.n_nodes].copy()

    def edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        m = self._n_edges
        return (self._edge_src[:m].copy(), self._edge_dst[:m].copy(),
                self._edge_type[:m].copy(), self._edge_w[:m].copy())

    def row_incidence(self) -> Tuple[np.ndarray, np.ndarray]:
        return (self._row_sub[: self._n_rows].copy(),
                self._row_obj[: self._n_rows].copy())

    # -- writes (host first, device delta on sync) --------------------------
    def intern(self, ns_id: int, text: str) -> int:
        """Create-or-get the node for (namespace, normalized entity)."""
        key = (int(ns_id), normalize_entity(text))
        node = self._intern.get(key)
        if node is not None:
            return node
        node = self.n_nodes
        if node >= self._node_ns.shape[0]:
            cap = _next_capacity(node + 1, floor=2 * self._node_ns.shape[0])
            grown = np.full((cap,), -1, np.int32)
            grown[:node] = self._node_ns[:node]
            self._node_ns = grown
            self._invalidate_device()
        self._node_text.append(key[1])
        self._node_ns[node] = key[0]
        self._intern[key] = node
        return node

    def _grow_edges(self, need: int) -> None:
        cap = self._edge_src.shape[0]
        if need <= cap:
            return
        cap = _next_capacity(need, floor=2 * cap)
        for name in ("_edge_src", "_edge_dst", "_edge_type"):
            grown = np.zeros((cap,), np.int32)
            grown[: self._n_edges] = getattr(self, name)[: self._n_edges]
            setattr(self, name, grown)
        w = np.zeros((cap,), np.float32)
        w[: self._n_edges] = self._edge_w[: self._n_edges]
        self._edge_w = w
        self._invalidate_device()

    def add_edge(self, src: int, dst: int, etype: int,
                 weight: float = 1.0) -> None:
        """Upsert one directed edge.  A new (src, dst, type) appends; an
        existing one keeps its lane slot and re-sets its weight."""
        if src == dst:
            return
        key = (int(src), int(dst), int(etype))
        eid = self._edge_idx.get(key)
        w32 = np.float32(weight)
        if eid is not None:
            if self._edge_w[eid] != w32:
                self._edge_w[eid] = w32
                self._pending_w.append(eid)
            return
        self._grow_edges(self._n_edges + 1)
        eid = self._n_edges
        self._edge_src[eid], self._edge_dst[eid] = key[0], key[1]
        self._edge_type[eid], self._edge_w[eid] = key[2], w32
        self._edge_idx[key] = eid
        self._n_edges += 1
        self.counters["edges_upserted"] += 1

    def link_nodes(self, src: int, dst: int, etype: int,
                   weight: float = 1.0) -> None:
        """Symmetric upsert: both directions."""
        self.add_edge(src, dst, etype, weight)
        self.add_edge(dst, src, etype, weight)

    def append_row(self, row: int, sub_node: int, obj_node: int) -> None:
        """Record row `row`'s incidence.  Rows must arrive in global-row
        order — the lane position is the row id."""
        if row != self._n_rows:
            raise GraphInvariantError(
                f"row-incidence drift: appending row {row}, lane holds "
                f"{self._n_rows}")
        cap = self._row_sub.shape[0]
        if row >= cap:
            cap = _next_capacity(row + 1, floor=2 * cap)
            for name in ("_row_sub", "_row_obj"):
                grown = np.full((cap,), -1, np.int32)
                grown[: self._n_rows] = getattr(self, name)[: self._n_rows]
                setattr(self, name, grown)
            self._invalidate_device()
        self._row_sub[row] = int(sub_node)
        self._row_obj[row] = int(obj_node)
        self._n_rows += 1

    def ingest_session(self, ns_id: int, triples: Sequence,
                       rows: Sequence[int]) -> None:
        """Ingest one flushed session's triples with their freshly assigned
        global rows, in order: intern entities, append row incidence, and
        upsert the three edge families.  Deterministic given prior graph
        state."""
        prev_obj = None
        for tr, row in zip(triples, rows):
            sub = self.intern(ns_id, tr.subject)
            obj = self.intern(ns_id, tr.object)
            self.append_row(int(row), sub, obj)
            self.link_nodes(sub, obj, EDGE_ENTITY)
            if prev_obj is not None:
                self.link_nodes(prev_obj, obj, EDGE_TEMPORAL)
            prev_obj = obj
            tail_key = (int(ns_id), tr.key())
            last = self._tail.get(tail_key)
            if last is not None and last != obj:
                self.link_nodes(last, obj, EDGE_CAUSAL)
            self._tail[tail_key] = obj

    # -- device residency ---------------------------------------------------
    def _invalidate_device(self) -> None:
        self._dev = None

    def _host_lanes(self) -> Dict[str, np.ndarray]:
        return {name: getattr(self, "_" + name) for name in _LANES}

    def sync_device(self) -> None:
        """Bring the device lanes up to date: upload them whole after a
        capacity change (or the first time), else write the host delta
        since the last sync into them in place."""
        if self._dev is None:
            self._dev = {name: to_device(lane, self.device)
                         for name, lane in self._host_lanes().items()}
            self.counters["lane_uploads"] += 1
            self._synced = (self.n_nodes, self._n_edges, self._n_rows)
            self._pending_w = []
            return
        d, host = self._dev, self._host_lanes()
        sn, se, sr = self._synced
        spans = {"node_ns": (sn, self.n_nodes),
                 "edge_src": (se, self._n_edges),
                 "edge_dst": (se, self._n_edges),
                 "edge_type": (se, self._n_edges),
                 "edge_w": (se, self._n_edges),
                 "row_sub": (sr, self._n_rows),
                 "row_obj": (sr, self._n_rows)}
        for name, (lo, hi) in spans.items():
            if hi > lo:
                d[name][lo:hi] = to_device(host[name][lo:hi], self.device)
        # re-weighted edges that were already on the device (fresh appends
        # above carried their final weight)
        idx = sorted({e for e in self._pending_w if e < se})
        if idx:
            ids = np.asarray(idx, np.int64)
            d["edge_w"].index_copy_(0, to_device(ids, self.device),
                                    to_device(self._edge_w[ids], self.device))
        self._synced = (self.n_nodes, self._n_edges, self._n_rows)
        self._pending_w = []

    # -- the read path ------------------------------------------------------
    def expand(self, rankings: Sequence, q_ns, row_labels, type_w, hops_b,
               *, k: int, max_hops: int, seed_k: int = 8,
               decay: float = 0.5):
        """Batched expansion over the device lanes.  `rankings` are the
        upstream (B, P_i) id matrices (dense/sparse, -1-padded, best-first);
        their first `seed_k` columns seed the frontier.  `row_labels` is the
        bank's cached (capacity,) effective-label device tensor (tombstones
        and demoted rows -1: they neither seed nor surface).  `type_w`
        (B, 3) per-request edge-type weights, `hops_b` (B,) per-request hop
        counts (0 = seeds only), `max_hops` the loop depth (the caller
        buckets it to a power of two), `k` the ranking width.  Returns (ids
        (B, k) i32 device, scores (B, k) f32 device, per-hop frontier
        sizes, per-hop edges touched — both host lists, read back in one
        copy after the loop)."""
        self.sync_device()
        d, dev = self._dev, self.device
        hops = max(1, int(max_hops))
        ids, scores, per_hop = _expand_device(
            d["edge_src"], d["edge_dst"], d["edge_type"], d["edge_w"],
            d["node_ns"], d["row_sub"], d["row_obj"], row_labels.to(dev),
            [upload(r, dev) for r in rankings],
            upload(np.asarray(q_ns, np.int64), dev),
            upload(np.asarray(type_w, np.float32), dev),
            upload(np.asarray(hops_b, np.int64), dev),
            self._n_edges, self._n_rows, hops=hops, k=int(k),
            seed_k=int(seed_k), decay=float(decay))
        self.counters["expansions"] += 1
        fsz, etc = per_hop.cpu().tolist()
        return ids, scores, fsz, etc

    # -- compaction / persistence -------------------------------------------
    def compact_rows(self, old_to_new: np.ndarray) -> None:
        """Remap the row-incidence lanes through a store compaction's
        old->new row map ((n_old,) with -1 for dropped rows).  Sticky
        capacity; the device lanes repack in place."""
        old_to_new = np.asarray(old_to_new, np.int64)
        n_old = old_to_new.shape[0]
        if n_old != self._n_rows:
            raise GraphInvariantError(
                f"compaction drift: map covers {n_old} rows, lanes hold "
                f"{self._n_rows}")
        keep = np.where(old_to_new >= 0)[0]
        n_new = int(keep.size)
        cap = self._row_sub.shape[0]
        new_sub = np.full((cap,), -1, np.int32)
        new_obj = np.full((cap,), -1, np.int32)
        new_sub[:n_new] = self._row_sub[keep]
        new_obj[:n_new] = self._row_obj[keep]
        self._row_sub, self._row_obj = new_sub, new_obj
        self._n_rows = n_new
        if self._dev is not None and self._synced[2] == n_old:
            gather = to_device(keep, self.device)
            for name in ("row_sub", "row_obj"):
                lane = self._dev[name]
                lane[:n_new] = lane.index_select(0, gather)
                lane[n_new:] = -1
            self._synced = (self._synced[0], self._synced[1], n_new)
        else:
            self._invalidate_device()

    def snapshot_arrays(self) -> Dict[str, np.ndarray]:
        """Numeric lanes for checkpoint/io.py (tight, not capacity-padded)."""
        m, r = self._n_edges, self._n_rows
        return {
            "graph_node_ns": self._node_ns[: self.n_nodes].copy(),
            "graph_edge_src": self._edge_src[:m].copy(),
            "graph_edge_dst": self._edge_dst[:m].copy(),
            "graph_edge_type": self._edge_type[:m].copy(),
            "graph_edge_w": self._edge_w[:m].copy(),
            "graph_row_sub": self._row_sub[:r].copy(),
            "graph_row_obj": self._row_obj[:r].copy(),
        }

    def snapshot_meta(self) -> dict:
        """Non-numeric state: node texts (interning rebuilds from them) and
        the version-chain tails."""
        return {
            "nodes": list(self._node_text),
            "tail": [[int(ns), key, int(node)]
                     for (ns, key), node in sorted(self._tail.items())],
        }

    @classmethod
    def from_snapshot(cls, arrays: Dict[str, np.ndarray], meta: dict,
                      device="cuda") -> "MemoryGraph":
        g = cls(device=device)
        node_ns = np.asarray(arrays["graph_node_ns"], np.int32)
        texts = [str(t) for t in meta["nodes"]]
        if len(texts) != node_ns.shape[0]:
            raise GraphInvariantError(
                f"restore: {len(texts)} node texts vs "
                f"{node_ns.shape[0]} node labels")
        g._node_ns = np.full((_next_capacity(len(texts)),), -1, np.int32)
        g._node_ns[: len(texts)] = node_ns
        g._node_text = texts
        g._intern = {(int(ns), t): i
                     for i, (ns, t) in enumerate(zip(node_ns, texts))}
        src = np.asarray(arrays["graph_edge_src"], np.int32)
        m = src.shape[0]
        ecap = _next_capacity(m)
        g._edge_src = np.zeros((ecap,), np.int32)
        g._edge_dst = np.zeros((ecap,), np.int32)
        g._edge_type = np.zeros((ecap,), np.int32)
        g._edge_w = np.zeros((ecap,), np.float32)
        g._edge_src[:m] = src
        g._edge_dst[:m] = np.asarray(arrays["graph_edge_dst"], np.int32)
        g._edge_type[:m] = np.asarray(arrays["graph_edge_type"], np.int32)
        g._edge_w[:m] = np.asarray(arrays["graph_edge_w"], np.float32)
        g._n_edges = m
        g._edge_idx = {(int(g._edge_src[i]), int(g._edge_dst[i]),
                        int(g._edge_type[i])): i for i in range(m)}
        sub = np.asarray(arrays["graph_row_sub"], np.int32)
        r = sub.shape[0]
        rcap = _next_capacity(r)
        g._row_sub = np.full((rcap,), -1, np.int32)
        g._row_obj = np.full((rcap,), -1, np.int32)
        g._row_sub[:r] = sub
        g._row_obj[:r] = np.asarray(arrays["graph_row_obj"], np.int32)
        g._n_rows = r
        g._tail = {(int(ns), str(key)): int(node)
                   for ns, key, node in meta.get("tail", [])}
        return g

    def stats(self) -> dict:
        """Durable-state gauges only (snapshot-identical across restore)."""
        return {
            "nodes": self.n_nodes,
            "edges": self._n_edges,
            "rows_with_incidence": int(
                (self._row_sub[: self._n_rows] >= 0).sum()),
            **{f"edges_{n}": c for n, c in self.edge_type_counts().items()},
        }
