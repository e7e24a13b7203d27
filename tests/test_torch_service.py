"""The slice gate of the port: the same synthetic LoCoMo conversations
recorded into the JAX package's MemoryService (jnp search, no Pallas) and
the port's MemoryService(device="cpu") answer every plan identically —
the same fused ids and scores, byte-identical rendered contexts, the same
token counts — with the f32 and the int8 device bank, through a hot/warm
tier cycle, and snapshots written by either package restore in the
other."""
import dataclasses

import numpy as np
import pytest

from repro.checkpoint import io as jio
from repro.core import embedder as jemb
from repro.core import service as jsvc
from repro.core.api import RetrievalPlan as JPlan
from repro.core.api import RetrieveRequest as JReq
from repro.core.extraction import Message as JMessage
from repro.core.tiering import TierPolicy as JTierPolicy
from repro.data.locomo_synth import generate_conversation
from repro_torch.checkpoint import io as tio
from repro_torch.core import HashEmbedder, MemoryService, MemoryStore
from repro_torch.core.api import RetrievalPlan, RetrieveRequest
from repro_torch.core.extraction import Message
from repro_torch.core.tiering import TierPolicy
from repro_torch.obs.telemetry import get_telemetry, walk_spans

NAMESPACES = ("alice/c0", "bob/c0", "carol/c0")
PLANS = {
    "hybrid": {},
    "dense_only": {"stages": ("dense", "fuse", "budget")},
    "sparse_only": {"stages": ("sparse", "fuse", "budget")},
    "raw": {"stages": ("dense", "sparse", "fuse")},
    "dense_raw": {"stages": ("dense", "fuse")},
    "graph_expanded": {"stages": ("dense", "sparse", "graph", "fuse",
                                  "budget")},
}
EXTRA = "I work as a chef and I live in Cusco."


def _record(svc, message_cls):
    convs = [generate_conversation(seed=s) for s in range(3)]
    for conv, ns in zip(convs, NAMESPACES):
        for sid, msgs in conv.sessions:
            svc.enqueue(ns, sid, [message_cls(m.speaker, m.text, m.timestamp)
                                  for m in msgs])
    svc.flush()
    svc.record("alice/c0", "s-extra",
               [message_cls("Alice", EXTRA, 1.7e9)])
    return convs


def _requests(convs):
    reqs = []
    for conv, ns in zip(convs, NAMESPACES):
        reqs += [(ns, q.question) for q in conv.questions]
    reqs += [("alice/c0", "Where does Alice live?"),
             ("bob/c0", "Where does Alice live?"),      # another tenant
             ("nobody", "Where does Alice live?"),      # unknown tenant
             ("carol/c0", "")]
    return reqs


@pytest.fixture(scope="module")
def pair():
    js = jsvc.MemoryService(jemb.HashEmbedder(), use_kernel=False)
    ts = MemoryService(HashEmbedder(device="cpu"), device="cpu")
    convs = _record(js, JMessage)
    assert _record(ts, Message)[0].questions == convs[0].questions
    return js, ts, _requests(convs)


def _as_plain(payload):
    """A payload as plain data, comparable across the two packages."""
    if hasattr(payload, "text"):
        return ("ctx", payload.text, payload.token_count,
                [dataclasses.asdict(t) for t in payload.triples],
                [dataclasses.asdict(s) for s in payload.summaries])
    return ("raw", payload.row_ids, payload.triple_ids, payload.scores)


def _answers(svc, reqs, plan_kw, jax_side):
    plan = (JPlan if jax_side else RetrievalPlan)(**plan_kw)
    return [_as_plain(p) for p in svc.retrieve_batch(reqs, plan=plan)]


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_every_plan_answers_like_the_reference(pair, plan):
    js, ts, reqs = pair
    want = _answers(js, reqs, PLANS[plan], True)
    got = _answers(ts, reqs, PLANS[plan], False)
    assert got == want
    assert any(w[1] for w in want)                    # not vacuous
    if plan in ("hybrid", "dense_only"):
        assert "(Alice; lives in; cusco)" in got[len(reqs) - 4][1]
        assert "(Alice;" not in got[len(reqs) - 3][1]   # bob's namespace


def test_mixed_per_request_options_in_one_batch(pair):
    js, ts, reqs = pair
    opts = [dict(top_k=3), dict(dense_weight=0.2, sparse_weight=2.0),
            dict(stages=("sparse", "fuse", "budget")),
            dict(stages=("dense", "fuse")), dict(top_k=17), {}]
    picks = [reqs[i] for i in range(0, len(reqs), 4)]
    j_reqs = [JReq(namespace=ns, query=q, **opts[i % len(opts)])
              for i, (ns, q) in enumerate(picks)]
    t_reqs = [RetrieveRequest(namespace=ns, query=q, **opts[i % len(opts)])
              for i, (ns, q) in enumerate(picks)]
    want = [_as_plain(p) for p in js.execute(j_reqs)]
    got = [_as_plain(p) for p in ts.execute(t_reqs)]
    assert got == want
    # batched == sequential on the port
    for r, g in zip(t_reqs[:5], got[:5]):
        assert _as_plain(ts.execute([r])[0]) == g


def test_snapshots_restore_across_packages(pair, tmp_path):
    js, ts, reqs = pair
    pj, pt = str(tmp_path / "jax.snap"), str(tmp_path / "torch.snap")
    js.snapshot(pj)
    ts.snapshot(pt)
    aj, at = jio.load_raw(pj), tio.load_raw(pt)
    assert sorted(aj) == sorted(at)
    for name in aj:
        np.testing.assert_array_equal(at[name], aj[name], err_msg=name)
        assert at[name].dtype == aj[name].dtype, name
    want = _answers(js, reqs, {}, True)
    # the JAX package's snapshot, into the port (by path and by arrays)
    from_path = MemoryService.restore(pj, HashEmbedder(device="cpu"),
                                      device="cpu")
    from_arrays = MemoryService(store=MemoryStore.from_arrays(
        aj, HashEmbedder(device="cpu"), device="cpu"))
    assert _answers(from_path, reqs, {}, False) == want
    assert _answers(from_arrays, reqs, {}, False) == want
    # the port's snapshot, into the JAX package
    back = jsvc.MemoryService.restore(pt, jemb.HashEmbedder(),
                                      use_kernel=False)
    assert _answers(back, reqs, {}, True) == want


def test_evict_and_compact_keep_parity():
    js = jsvc.MemoryService(jemb.HashEmbedder(), use_kernel=False)
    ts = MemoryService(HashEmbedder(device="cpu"), device="cpu")
    convs = _record(js, JMessage)
    _record(ts, Message)
    for svc, msg in ((js, JMessage), (ts, Message)):
        svc.record("alice/c0", "s-move",
                   [msg("Alice", "I live in Osaka.", 1.8e9)])
        assert svc.evict("bob/c0") > 0
        assert svc.evict_superseded("alice/c0") > 0
    reqs = _requests(convs)
    for plan in ("hybrid", "raw"):
        assert _answers(ts, reqs, PLANS[plan], False) == \
            _answers(js, reqs, PLANS[plan], True)
    assert ts.compact() == js.compact()
    for plan in ("hybrid", "raw"):
        assert _answers(ts, reqs, PLANS[plan], False) == \
            _answers(js, reqs, PLANS[plan], True)
    # the graph's device lanes follow its host lanes through it all
    graph = ts.store.graph
    for name, lane in graph._host_lanes().items():
        np.testing.assert_array_equal(graph._dev[name].numpy(), lane,
                                      err_msg=name)
    st_t, st_j = ts.stats(), js.stats()
    for key in ("namespaces", "bank_rows", "alive_rows", "tombstones",
                "bm25_docs", "per_namespace", "graph"):
        assert st_t[key] == st_j[key], key


def test_slices_to_come_raise_not_implemented():
    # durability (data_dir= / runtime=) came with its slice: see
    # tests/test_torch_durability.py
    emb = HashEmbedder(device="cpu")
    for kw in (dict(shards=2), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="sharding slice"):
            MemoryService(emb, device="cpu", **kw)
    # the request scheduler came with the serving slice: it mounts, routes
    # retrieve_batch, and closes with the service
    svc = MemoryService(emb, device="cpu")
    sched = svc.start_scheduler(tick_interval_s=0.001)
    assert svc.scheduler is sched and sched.can_submit()
    assert svc.retrieve_batch([("a/c0", "q")])[0].triples == []
    assert sched.stats()["retrieves"] == 1
    svc.close()
    assert sched.closed and svc.scheduler is None


# -- the int8 device bank --------------------------------------------------

@pytest.fixture(scope="module")
def int8_pair():
    js = jsvc.MemoryService(jemb.HashEmbedder(), use_kernel=False,
                            quantize="int8")
    ts = MemoryService(HashEmbedder(device="cpu"), device="cpu",
                       quantize="int8")
    convs = _record(js, JMessage)
    _record(ts, Message)
    return js, ts, _requests(convs)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_int8_service_answers_like_the_reference(int8_pair, plan):
    """K2's plain version plus the exact rescore, through every plan: the
    same fused ids, contexts and token counts as the JAX int8 service, and
    the same rescore counters (hence the same rescore hit rate)."""
    js, ts, reqs = int8_pair
    want = _answers(js, reqs, PLANS[plan], True)
    got = _answers(ts, reqs, PLANS[plan], False)
    assert got == want
    assert any(w[1] for w in want)
    st_t, st_j = ts.stats()["bank"], js.stats()["bank"]
    assert st_t == st_j
    assert st_t["quantize"] == "int8" and st_t["quant_searches"] > 0
    if plan in ("hybrid", "dense_only"):
        assert "(Alice; lives in; cusco)" in got[len(reqs) - 4][1]
        assert "(Alice;" not in got[len(reqs) - 3][1]


def test_int8_snapshot_restores_f32_in_both_packages(int8_pair, tmp_path):
    """Snapshots stay f32 whatever the device bank: the port's int8
    service writes the reference's layout, and each package restores it as
    an int8 service answering like the writer."""
    js, ts, reqs = int8_pair
    pj, pt = str(tmp_path / "jax.snap"), str(tmp_path / "torch.snap")
    js.snapshot(pj)
    ts.snapshot(pt)
    aj, at = jio.load_raw(pj), tio.load_raw(pt)
    for name in aj:
        np.testing.assert_array_equal(at[name], aj[name], err_msg=name)
    assert at["bank"].dtype == np.float32
    want = _answers(js, reqs, {}, True)
    back = MemoryService.restore(pj, HashEmbedder(device="cpu"),
                                 device="cpu", quantize="int8", rescore=4)
    assert back.vindex.quantize == "int8"
    np.testing.assert_array_equal(back.vindex.bank, ts.vindex.bank)
    assert _answers(back, reqs, {}, False) == want
    jback = jsvc.MemoryService.restore(pt, jemb.HashEmbedder(),
                                       use_kernel=False, quantize="int8")
    assert _answers(jback, reqs, {}, True) == want


# -- hot/warm tiering --------------------------------------------------------

@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_tier_cycle_answers_like_the_reference(quantize):
    """test_service_host_fallback_and_promotion_cycle on both packages, with
    the tier manager attached to the store and ticked by hand on one fake
    clock: a demoted namespace is answered from the host mirror exactly as
    when hot (reported as a host fallback), the next tick promotes it, and
    every answer, tick and counter matches the JAX service's."""
    now = [0.0]
    svcs = []
    for mod, emb, msg, policy, kw in (
            (jsvc, jemb.HashEmbedder(), JMessage, JTierPolicy,
             dict(use_kernel=False)),
            (None, HashEmbedder(device="cpu"), Message, TierPolicy,
             dict(device="cpu"))):
        cls = mod.MemoryService if mod else MemoryService
        svc = cls(emb, quantize=quantize, budget=800, **kw)
        for u, city in enumerate(["Tallinn", "Porto", "Cusco"]):
            svc.record(f"u{u}/c0", "s0", [
                msg(f"U{u}", f"I live in {city}.", 1.0),
                msg(f"U{u}", "I work as a welder.", 2.0)])
        svc.store.attach_tiers(policy(max_hot_rows=4, halflife_s=60.0),
                               clock=lambda: now[0])
        svcs.append(svc)
    js, ts = svcs
    q = "Which city does the user live in?"
    names = [f"u{u}/c0" for u in range(3)]

    def answers(svc, jax_side):
        return _answers(svc, [(n, q) for n in names], {}, jax_side)

    def ticks():
        now[0] += 1.0
        did = [svc.store.tiers.tick() for svc in svcs]
        assert did[1] == did[0]
        return did[1]

    hot = answers(ts, False)
    assert hot == answers(js, True)
    now[0] += 1.0
    assert answers(ts, False) == answers(js, True)  # activity: all once
    ts.retrieve("u2/c0", q)
    js.retrieve("u2/c0", q)                         # u2 is the hottest
    did = ticks()
    assert did["demoted_ns"] >= 1
    tiers = ts.store.tiers
    demoted = tiers.demoted_namespaces()
    assert demoted == js.store.tiers.demoted_namespaces()
    assert ts.store.get("u2/c0").ns_id not in demoted
    tel = get_telemetry()
    trace = tel.start_trace(op="execute")
    with tel.activate([trace]):
        got = answers(ts, False)
    tel.finish_trace(trace)
    dense = [sp for sp in walk_spans(trace.to_dict()["root"])
             if sp["name"] == "plan.dense"]
    assert dense[0]["attrs"]["host_fallbacks"] == len(demoted)
    assert got == answers(js, True) == hot, "host fallback changed answers"
    assert tiers.counters["host_fallbacks"] == len(demoted)
    assert ticks()["promoted_ns"] == len(demoted)
    assert not any(tiers.is_demoted(n) for n in demoted)
    assert answers(ts, False) == answers(js, True) == hot
    assert tiers.stats() == js.store.tiers.stats()
    assert ts.stats()["tiering"] == js.stats()["tiering"]
    assert ts.stats()["bank"] == js.stats()["bank"]
