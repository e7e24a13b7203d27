"""The graph stage on the port: `core/graph._expand_device` and
`MemoryGraph.expand` (device="cpu") against the JAX package's
`_expand_device` and the scalar oracle `graph_expand_ref` — equal ids and
bit-equal float32 scores — on random lanes and on stores built, evicted,
compacted, restored and linked the same way in both packages; the
service's graph stage against the JAX service; namespace isolation; and
`eval.graph_recall` against BENCH_graph.json."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core.api import RetrievalPlan as JPlan
from repro.core.api import RetrieveRequest as JReq
from repro.core.embedder import HashEmbedder as JHashEmbedder
from repro.core.extraction import Message as JMessage
from repro.core.service import MemoryService as JMemoryService
from repro.core.store import MemoryStore as JMemoryStore
from repro.kernels.ref import graph_expand_ref
from repro_torch.core import HashEmbedder, MemoryService, MemoryStore
from repro_torch.core import graph as tgraph
from repro_torch.core.api import RetrievalPlan, RetrieveRequest
from repro_torch.core.extraction import Message
from repro_torch.eval import graph_recall
from repro_torch.obs.telemetry import Telemetry, set_telemetry, walk_spans

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PEOPLE = ["Caroline", "Dave", "Mel"]
TEXTS = [
    "I adopted a cat named Muffin.",
    "Muffin is allergic to peanuts.",
    "I work as a teacher.",
    "I work as a nurse.",
    "I went to Banff. I started aikido classes.",
    "My favorite color is teal.",
    "I live in Lisbon.",
    "I bought a camera.",
    "I am learning the cello.",
]
TW = (1.0, 0.9, 0.9)


# -- random lanes --------------------------------------------------------------

def _random_lanes(rng, n_nodes=40, n_edges=150, n_rows=60, n_ns=3):
    """Capacity-padded lanes like the store's: node, edge and row lanes of
    pow2 capacity (live prefix, then fill), row labels longer than the row
    lanes, -1 labels (tombstoned rows) and -1 incidences mixed in."""
    node_ns = np.full(64, -1, np.int32)
    node_ns[:n_nodes] = rng.integers(0, n_ns, n_nodes)
    es, ed, et = (np.zeros(256, np.int32) for _ in range(3))
    ew = np.zeros(256, np.float32)
    es[:n_edges] = rng.integers(0, n_nodes, n_edges)
    ed[:n_edges] = rng.integers(0, n_nodes, n_edges)
    et[:n_edges] = rng.integers(0, 3, n_edges)
    ew[:n_edges] = rng.random(n_edges, np.float32) * 2
    rs, ro = np.full(64, -1, np.int32), np.full(64, -1, np.int32)
    rs[:n_rows] = rng.integers(-1, n_nodes, n_rows)
    ro[:n_rows] = rng.integers(-1, n_nodes, n_rows)
    labels = np.full(128, -1, np.int32)
    labels[:n_rows] = rng.integers(-1, n_ns, n_rows)
    return (es, ed, et, ew, node_ns, rs, ro, labels), n_edges, n_rows, n_nodes


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("hops", [1, 2, 3, 4])
@pytest.mark.parametrize("seed_k,decay", [(1, 0.5), (8, 0.25), (64, 1.0)])
def test_expand_device_matches_the_reference_and_the_oracle(hops, seed_k,
                                                            decay):
    """Mixed per-request hop counts (0..hops) in one batch; rankings with
    -1 padding and out-of-range rows; 12 random graphs per case."""
    rng = np.random.default_rng(100 * hops + seed_k)
    B, k = 5, 16
    for _ in range(12):
        lanes, n_edges, n_rows, n_nodes = _random_lanes(rng)
        rankings = [rng.integers(-1, n_rows + 3, (B, 12)).astype(np.int32)
                    for _ in range(2)]
        q_ns = rng.integers(0, 3, B).astype(np.int32)
        tw = rng.random((B, 3), np.float32)
        hops_b = rng.integers(0, hops + 1, B).astype(np.int32)
        ji, js, jf, je = jgraph._expand_device(
            *map(jnp.asarray, lanes), tuple(map(jnp.asarray, rankings)),
            jnp.asarray(q_ns), jnp.asarray(tw), jnp.asarray(hops_b),
            jnp.int32(n_edges), jnp.int32(n_rows), hops=hops, k=k,
            seed_k=seed_k, decay=decay)
        ti, ts, per_hop = tgraph._expand_device(
            *map(_t, lanes), [_t(r) for r in rankings], _t(q_ns), _t(tw),
            _t(hops_b), n_edges, n_rows, hops=hops, k=k, seed_k=seed_k,
            decay=decay)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert ts.dtype == torch.float32 and ti.dtype == torch.int32
        np.testing.assert_array_equal(
            per_hop.numpy(), np.stack([np.asarray(jf), np.asarray(je)]))
        es, ed, et, ew, node_ns, rs, ro, labels = lanes
        oi, osc = graph_expand_ref(
            es[:n_edges], ed[:n_edges], et[:n_edges], ew[:n_edges],
            node_ns[:n_nodes], rs[:n_rows], ro[:n_rows], labels, rankings,
            q_ns, tw, hops_b, hops=hops, k=k, seed_k=seed_k, decay=decay)
        np.testing.assert_array_equal(ti.numpy(), oi)
        np.testing.assert_array_equal(ts.numpy(), osc)


# -- stores built the same way in both packages --------------------------------

def _fill(store, message_cls, namespaces=("u1", "u2"), sessions=3):
    rng = np.random.default_rng(0)
    for ns in namespaces:
        for s in range(sessions):
            store.ingest(ns, f"s{s}", [
                message_cls(str(rng.choice(PEOPLE)), str(rng.choice(TEXTS)))
                for _ in range(3)])
    return store


def _stores():
    js = _fill(JMemoryStore(JHashEmbedder(), use_kernel=False), JMessage)
    ts = _fill(MemoryStore(HashEmbedder(device="cpu"), device="cpu"),
               Message)
    return js, ts


def _expand(store, queries, namespaces, hops_b, jax_side, k=16, max_hops=2,
            seed_k=8, decay=0.5):
    """`MemoryGraph.expand` seeded by the store's own dense and sparse
    rankings, as the service stage does; returns host (ids, scores) and the
    oracle's on the same inputs."""
    q_ns = np.asarray([store.tenant(ns).ns_id for ns in namespaces],
                      np.int32)
    tw = np.tile(np.asarray([TW], np.float32), (len(queries), 1))
    hops_b = np.asarray(hops_b, np.int32)
    _, dense = store.vindex.search_batch(
        np.asarray(store.embedder.embed_texts(list(queries)), np.float32),
        q_ns, k=8)
    _, sparse = store.bm25.topk_batch_dev(list(queries), k=8,
                                          namespaces=list(q_ns))
    rankings = [np.asarray(dense), np.asarray(sparse)]
    if not jax_side:
        rankings = [_t(r) for r in rankings]
    ids, scores, fsz, etc = store.graph.expand(
        rankings, q_ns, store.row_namespaces_device(), tw, hops_b, k=k,
        max_hops=max_hops, seed_k=seed_k, decay=decay)
    labels = np.asarray(store.row_namespaces_device())
    g = store.graph
    oids, oscores = graph_expand_ref(
        *g.edges(), g.node_ns(), *g.row_incidence(), labels,
        [np.asarray(r) for r in rankings], q_ns, tw, hops_b, hops=max_hops,
        k=k, seed_k=seed_k, decay=decay)
    assert len(fsz) == len(etc) == max_hops
    return (np.asarray(ids), np.asarray(scores)), (oids, oscores), \
        (list(fsz), list(etc))


def _assert_same(js, ts, queries, namespaces, hops_b, **kw):
    (ji, jsc), _, jstats = _expand(js, queries, namespaces, hops_b, True,
                                   **kw)
    (ti, tsc), (oi, osc), tstats = _expand(ts, queries, namespaces, hops_b,
                                           False, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tsc, jsc)          # exact f32
    np.testing.assert_array_equal(ti, oi)
    np.testing.assert_array_equal(tsc, osc)
    assert tstats == jstats
    return ti, tsc


@pytest.mark.parametrize("history", ["fresh", "evict_compact", "restore"])
def test_store_expansion_matches_the_reference(history, tmp_path):
    js, ts = _stores()
    queries, namespaces = ["allergic", "camera", "nurse"], ["u1", "u2", "u1"]
    if history == "evict_compact":
        for s in (js, ts):
            s.evict_superseded("u1")
        _assert_same(js, ts, queries, namespaces, [2, 1, 2])
        for s in (js, ts):
            s.evict_namespace("u2")
        _assert_same(js, ts, queries, namespaces, [2, 2, 2])
        for s in (js, ts):
            s.compact()
        namespaces = ["u1", "u1", "u1"]
    elif history == "restore":
        pj, pt = str(tmp_path / "jax.snap"), str(tmp_path / "torch.snap")
        js.snapshot(pj)
        ts.snapshot(pt)
        # each package restores the other's snapshot
        js = JMemoryStore.restore(pt, JHashEmbedder(), use_kernel=False)
        ts = MemoryStore.restore(pj, HashEmbedder(device="cpu"),
                                 device="cpu")
    _assert_same(js, ts, queries, namespaces, [2, 1, 2])
    ids, _ = _assert_same(js, ts, queries, namespaces, [3, 0, 1],
                          max_hops=4, seed_k=1, decay=0.9)
    assert (ids >= 0).any()                          # not vacuous


def test_link_validates_its_edge_type_and_changes_the_expansion():
    js, ts = _stores()
    for s in (js, ts):
        with pytest.raises(ValueError):
            s.link("u1", "a", "b", "telepathic")
    before = _assert_same(js, ts, ["allergic"], ["u1"], [1])
    for s in (js, ts):
        s.link("u1", "Lisbon", "camera", "causal", weight=3.0)
        s.link("u1", "Muffin", "teal", "entity")
        s.link("u1", "Muffin", "teal", "entity", weight=0.5)  # re-weight
    after = _assert_same(js, ts, ["allergic"], ["u1"], [1])
    # the causal link lifts the discovered row's score: 0.25 -> 0.3375
    assert before[1][0, 0] == np.float32(0.25)
    assert after[1][0, 0] == np.float32(0.33749998)
    g, jg = ts.graph, js.graph
    assert g.stats() == jg.stats()
    for x, y in zip(g.edges(), jg.edges()):
        np.testing.assert_array_equal(x, y)
    for name, lane in g._host_lanes().items():      # device follows host
        np.testing.assert_array_equal(g._dev[name].numpy(), lane)


def test_lanes_upload_whole_only_when_their_capacity_doubles():
    ts = _stores()[1]
    g = ts.graph
    uploads = g.counters["lane_uploads"]
    assert uploads >= 1
    cap = g._edge_src.shape[0]
    i = 0
    while g.n_edges + 2 <= cap:                    # grow within the bucket
        ts.link("u1", f"probe {i}", "Muffin", "temporal")
        i += 1
    _expand(ts, ["allergic"], ["u1"], [2], False)
    assert g.counters["lane_uploads"] == uploads
    ts.link("u1", "probe past", "Muffin", "temporal")   # the doubling
    _expand(ts, ["allergic"], ["u1"], [2], False)
    assert g.counters["lane_uploads"] == uploads + 1
    for name, lane in g._host_lanes().items():
        np.testing.assert_array_equal(g._dev[name].numpy(), lane)


def test_expansion_never_crosses_namespaces():
    ts = MemoryStore(HashEmbedder(device="cpu"), device="cpu")
    for ns in ("u1", "u2"):
        ts.ingest(ns, "s0", [
            Message("Caroline", "I adopted a cat named Muffin."),
            Message("Caroline", "Muffin is allergic to peanuts.")])
    u1, u2 = ts.tenant("u1"), ts.tenant("u2")
    # seed_k=1: only the best seed row seeds the walk, so the rest of the
    # chain must be discovered (seed nodes never score rows)
    (ids, _), _, _ = _expand(ts, ["Muffin allergic"], ["u1"], [3], False,
                             max_hops=4, seed_k=1)
    hit = {int(r) for r in ids[0] if r >= 0}
    assert hit and not hit & set(u2.rows)
    assert all(ts.vindex.row_namespaces()[r] == u1.ns_id for r in hit)
    # u1's rows seeding a u2 query find nothing
    rows_u1 = _t(np.asarray([u1.rows], np.int32))
    gids, _, _, _ = ts.graph.expand(
        [rows_u1], [u2.ns_id], ts.row_namespaces_device(), [TW], [4], k=8,
        max_hops=4)
    assert (gids.numpy() == -1).all()
    svc = MemoryService(store=ts)
    ctx = svc.retrieve("u1", "what is Muffin allergic to",
                       stages=("dense", "sparse", "graph", "budget"))
    assert ctx.triples
    assert all(tr.conversation_id == "u1" for tr in ctx.triples)


# -- the service stage ---------------------------------------------------------

def _raw(payloads):
    return [(p.row_ids, p.triple_ids, p.scores) for p in payloads]


def test_graph_stage_mixed_batch_matches_solo_and_the_reference():
    """Only some requests of the batch run the graph stage: each answers
    like the same request alone, and like the JAX service."""
    js, ts = _stores()
    jsvc, tsvc = JMemoryService(store=js), MemoryService(store=ts)
    specs = [dict(namespace="u1", query="allergic",
                  stages=("dense", "sparse", "graph"), hops=2),
             dict(namespace="u2", query="camera"),
             dict(namespace="u1", query="nurse",
                  stages=("dense", "sparse", "graph"), hops=1,
                  edge_weights=(1.0, 0.5, 2.0), graph_weight=1.5),
             dict(namespace="nobody", query="allergic",
                  stages=("dense", "sparse", "graph"), hops=4)]
    t_reqs = [RetrieveRequest(**s) for s in specs]
    batched = _raw(tsvc.execute(t_reqs, plan=RetrievalPlan.raw()))
    assert batched == _raw(jsvc.execute([JReq(**s) for s in specs],
                                        plan=JPlan.raw()))
    for req, got in zip(t_reqs, batched):
        assert _raw(tsvc.execute([req], plan=RetrievalPlan.raw())) == [got]
    # the stage is not vacuous: without it the first request answers
    # otherwise
    assert batched[0] != _raw(tsvc.execute(
        [RetrieveRequest("u1", "allergic")], plan=RetrievalPlan.raw()))[0]


def test_graph_span_and_metrics():
    tel = Telemetry()
    set_telemetry(tel)
    try:
        svc = MemoryService(store=_stores()[1])
        tr = tel.start_trace(op="retrieve")
        with tel.activate([tr]):
            svc.execute([RetrieveRequest("u1", "allergic", hops=3)],
                        plan=RetrievalPlan.graph_expanded(budget=False))
        tel.finish_trace(tr)
        spans = {s["name"]: s for s in walk_spans(tr.to_dict()["root"])}
        g = spans["plan.graph"]["attrs"]
        assert "launches" not in g and g["max_hops"] == 4
        assert len(g["frontier_sizes"]) == len(g["edges_touched"]) == 4
        assert g["edges"] == svc.store.graph.n_edges
        assert g["nodes"] == svc.store.graph.n_nodes
        assert svc.store.graph.counters["expansions"] == 1
        text = tel.render()
        assert "# TYPE memori_graph_expand_latency_seconds histogram" in text
        assert "memori_graph_expansions_total 1" in text
        assert "memori_graph_requests_total 1" in text
    finally:
        set_telemetry(Telemetry())


# -- the graph bench -------------------------------------------------------------

def test_graph_recall_reproduces_the_bench():
    """eval.graph_recall on the CPU gives BENCH_graph.json's questions,
    graph size and recall (the reference's graph_bench), and no lane
    re-upload in the steady state."""
    with open(os.path.join(ROOT, "BENCH_graph.json")) as f:
        bench = json.load(f)
    got = graph_recall.run(device="cpu", repeats=1)
    assert got["questions"] == bench["questions"] == 18
    assert got["graph"] == bench["graph"]
    assert got["graph_before_probes"] == {"nodes": 95, "edges": 398}
    assert got["recall"] == bench["recall"]
    assert got["uplift"] == bench["uplift"]
    assert got["lane_reuploads_steady_state"] == 0
