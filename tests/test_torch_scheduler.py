"""The port's request scheduler (`repro_torch/core/scheduler.py`) and the
typed API under it, on `device="cpu"`: the cases of the reference's
tests/test_scheduler.py run on the port.  N concurrent single-request
clients resolve to the same contexts as sequential retrieve() calls
through ONE batched dense / sparse / fuse launch per tick, and to the
same contexts as the JAX package's scheduler on the same submissions;
per-request options (top_k / weights / stages) are honored inside the
shared launches; writes keep read-your-writes and WAL ordering through
the lifecycle runtime; and multi-writer ticks group-commit into one
fsync'd segment."""
import threading

import numpy as np
import pytest

from repro.core import MemoryScheduler as JScheduler
from repro.core import MemoryService as JService
from repro.core.api import RetrieveRequest as JRetrieve
from repro.core.embedder import HashEmbedder as JEmb
from repro.core.extraction import Message as JMessage
from repro.core.hybrid import rrf_fuse_batch as j_rrf_fuse_batch
from repro_torch.core import (CompactRequest, EvictRequest, HashEmbedder,
                              MemoryResponse, MemoryScheduler, MemoryService,
                              Message, RawRetrieval, RecordRequest,
                              RetrievalPlan, RetrieveRequest)
from repro_torch.core import service as svc_mod
from repro_torch.core.bm25 import BM25Index
from repro_torch.core.hybrid import rrf_fuse, rrf_fuse_batch
from repro_torch.core.vector_index import VectorIndex

EMB = HashEmbedder(device="cpu")


def _svc(**kw):
    kw.setdefault("budget", 800)
    return MemoryService(EMB, device="cpu", **kw)


def _session(texts, speaker="U", ts=1700000000.0, cls=Message):
    return [cls(speaker, t, ts) for t in texts]


def _fill(svc, users=4, cls=Message):
    for u in range(users):
        svc.record(f"u{u}/c0", "s0", _session(
            [f"I live in City{u}.", "I work as a welder.",
             f"I adopted a pet named P{u}."], cls=cls))
    return svc


def _ctx_equal(got, want):
    assert got.text == want.text
    assert [t.text() for t in got.triples] == [t.text() for t in want.triples]
    assert got.token_count == want.token_count


QUERY = "Which city does the user live in?"


# -- typed requests: validation ------------------------------------------------

def test_request_and_plan_validation():
    with pytest.raises(ValueError, match="top_k"):
        RetrieveRequest("a/c0", "q", top_k=0)
    with pytest.raises(TypeError, match="query"):
        RetrieveRequest("a/c0", None)
    with pytest.raises(ValueError, match="unknown retrieval stages"):
        RetrieveRequest("a/c0", "q", stages=("dense", "bm42"))
    with pytest.raises(ValueError, match="at least one"):
        RetrievalPlan(stages=("fuse", "budget"))
    with pytest.raises(ValueError, match="message"):
        RecordRequest("a/c0", "s0", [])
    # fuse is implied, stages dedupe
    p = RetrievalPlan(stages=("dense", "dense", "budget"))
    assert p.stages == ("dense", "budget", "fuse")
    assert p.wants_dense and not p.wants_sparse and p.wants_budget
    assert RetrievalPlan.raw().wants_budget is False


def test_scheduler_rejects_untyped_submissions():
    svc = _fill(_svc())
    sched = MemoryScheduler(svc, start=False)
    with pytest.raises(TypeError, match="typed requests"):
        sched.submit(("u0/c0", QUERY))
    sched.close()


# -- the acceptance contract: N clients == sequential, one launch per tick -----

def test_concurrent_single_clients_match_sequential_with_one_launch_per_tick(
        monkeypatch):
    """8 threads each submit ONE RetrieveRequest; the tick answers all of
    them like sequential retrieve() calls through exactly one batched
    masked search + one stacked BM25 + one fused RRF launch, and like the
    JAX package's scheduler given the same submissions."""
    svc = _fill(_svc())
    queries = [(f"u{i % 4}/c0",
                QUERY if i % 2 == 0 else "What pet was adopted?")
               for i in range(8)]
    want = [svc.retrieve(ns, q) for ns, q in queries]   # before mounting

    calls = {"dense": 0, "sparse": 0, "fuse": 0}
    real_dense = VectorIndex.search_batch
    real_sparse = BM25Index.topk_batch_dev
    real_fuse = svc_mod.rrf_fuse_batch

    def spy_dense(self, *a, **kw):
        calls["dense"] += 1
        return real_dense(self, *a, **kw)

    def spy_sparse(self, *a, **kw):
        calls["sparse"] += 1
        return real_sparse(self, *a, **kw)

    def spy_fuse(*a, **kw):
        calls["fuse"] += 1
        return real_fuse(*a, **kw)

    monkeypatch.setattr(VectorIndex, "search_batch", spy_dense)
    monkeypatch.setattr(BM25Index, "topk_batch_dev", spy_sparse)
    monkeypatch.setattr(svc_mod, "rrf_fuse_batch", spy_fuse)

    sched = MemoryScheduler(svc, start=False)   # manual ticks: deterministic
    futs = [None] * len(queries)
    barrier = threading.Barrier(len(queries))

    def client(i, ns, q):
        barrier.wait()
        futs[i] = sched.submit(RetrieveRequest(ns, q))

    threads = [threading.Thread(target=client, args=(i, ns, q))
               for i, (ns, q) in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tick = sched.run_tick_once()
    assert tick == {"requests": 8, "retrieve_launches": 1}
    assert calls == {"dense": 1, "sparse": 1, "fuse": 1}, \
        "a tick of single-request clients must share ONE launch per stage"
    # futures resolved in submission order with the envelope filled in
    for i, fut in enumerate(futs):
        resp = fut.result(timeout=5)
        assert isinstance(resp, MemoryResponse) and resp.ok
        assert resp.op == "retrieve" and resp.batch_size == 8
        assert resp.queued_s >= 0.0 and resp.service_s > 0.0
        assert resp.token_count == resp.payload.token_count
    for f, w in zip(futs, want):
        _ctx_equal(f.result().payload, w)
    sched.close()

    # the reference's scheduler given the same submissions: one tick, the
    # same contexts request by request
    jsvc = _fill(JService(JEmb(), use_kernel=False, budget=800),
                 cls=JMessage)
    jsched = JScheduler(jsvc, start=False)
    jfuts = [jsched.submit(JRetrieve(ns, q)) for ns, q in queries]
    assert jsched.run_tick_once() == tick
    for i, f in enumerate(futs):
        jr = jfuts[i].result(timeout=5)
        assert jr.ok and jr.batch_size == f.result().batch_size
        _ctx_equal(f.result().payload, jr.payload)
    jsched.close()


def test_daemon_scheduler_threads_resolve_identically():
    """The same contract through the real daemon: clients block on
    .result() while the tick window collects them."""
    svc = _fill(_svc())
    queries = [(f"u{i % 4}/c0", QUERY) for i in range(6)]
    want = [svc.retrieve(ns, q) for ns, q in queries]
    sched = MemoryScheduler(svc, tick_interval_s=0.02, max_batch=8)
    got = [None] * len(queries)

    def client(i, ns, q):
        # the mounted scheduler re-routes the sync wrapper itself
        got[i] = svc.retrieve(ns, q)

    threads = [threading.Thread(target=client, args=(i, ns, q))
               for i, (ns, q) in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        _ctx_equal(g, w)
    st = sched.stats()
    assert st["retrieves"] == 6
    assert st["retrieve_launches"] >= 1
    sched.close()
    # unmounted after close: the wrapper goes back to the direct path
    assert svc.scheduler is None
    _ctx_equal(svc.retrieve(*queries[0]), want[0])


# -- per-request options in one shared launch ----------------------------------

def test_per_request_top_k_is_per_request():
    """A batch-global k would share one k across mixed-k clients; the
    typed API slices each request to its own k from the max-k fusion."""
    svc = _fill(_svc())
    reqs = [RetrieveRequest("u0/c0", QUERY, top_k=1),
            RetrieveRequest("u1/c0", QUERY, top_k=3),
            RetrieveRequest("u2/c0", QUERY)]           # service default (10)
    batched = svc.retrieve_batch(reqs)
    for req, got in zip(reqs, batched):
        want = svc.execute([req])[0]
        _ctx_equal(got, want)
    # and the legacy kwarg still works as the per-request default
    legacy = svc.retrieve_batch([("u0/c0", QUERY), ("u1/c0", QUERY)], top_k=2)
    for got, ns in zip(legacy, ["u0/c0", "u1/c0"]):
        _ctx_equal(got, svc.retrieve(ns, QUERY, top_k=2))
    # explicit per-request top_k beats the batch-global kwarg
    mixed = svc.retrieve_batch([RetrieveRequest("u0/c0", QUERY, top_k=1)],
                               top_k=7)
    _ctx_equal(mixed[0], svc.retrieve("u0/c0", QUERY, top_k=1))


def test_mixed_top_k_reuses_bounded_fusion_executables(monkeypatch):
    """The fusion's k buckets to pow2 like the Q shape (the reference's
    jit-static k, where a new k would mint an executable): once the k
    buckets are warm, mixed-k traffic (the scheduler's max-over-a-tick)
    fuses at no new k, and each answer is its own k's."""
    svc = _fill(_svc())
    reqs = [("u0/c0", QUERY), ("u1/c0", QUERY)]
    ks = []
    real_fuse = svc_mod.rrf_fuse_batch

    def spy_fuse(*a, **kw):
        ks.append(kw["k"])
        return real_fuse(*a, **kw)

    monkeypatch.setattr(svc_mod, "rrf_fuse_batch", spy_fuse)
    for k in (4, 8, 16):                       # warm the pow2 k buckets
        svc.retrieve_batch(reqs, top_k=k)
    warm = set(ks)
    assert warm == {4, 8, 16}
    for k in (3, 5, 6, 8, 10, 12, 16):
        got = svc.retrieve_batch(reqs, top_k=k)
        assert len(got) == 2
        for g, (ns, q) in zip(got, reqs):
            assert len(g.triples) <= k
    assert set(ks) == warm, f"mixed top_k fused at new k: {sorted(set(ks))}"


def test_per_request_weights_and_stage_variants_in_mixed_batch():
    """dense-only / sparse-only / custom-weight requests inside one batch
    answer exactly like the same request executed alone."""
    svc = _fill(_svc())
    reqs = [RetrieveRequest("u0/c0", QUERY, stages=("dense", "budget")),
            RetrieveRequest("u1/c0", QUERY, stages=("sparse", "budget")),
            RetrieveRequest("u2/c0", QUERY, dense_weight=0.2,
                            sparse_weight=1.5),
            RetrieveRequest("u3/c0", QUERY)]
    batched = svc.retrieve_batch(reqs)
    for req, got in zip(reqs, batched):
        _ctx_equal(got, svc.execute([req])[0])
    # plan-level variants drive whole batches too
    dense_batch = svc.retrieve_batch([("u0/c0", QUERY), ("u1/c0", QUERY)],
                                     plan=RetrievalPlan.dense_only())
    for got, ns in zip(dense_batch, ["u0/c0", "u1/c0"]):
        _ctx_equal(got, svc.execute(
            [RetrieveRequest(ns, QUERY, stages=("dense", "budget"))])[0])


def test_raw_plan_returns_fused_ids_consistent_with_budget_path():
    svc = _fill(_svc())
    [raw] = svc.retrieve_batch([("u0/c0", QUERY)], plan=RetrievalPlan.raw())
    assert isinstance(raw, RawRetrieval)
    assert raw.row_ids and len(raw.row_ids) == len(raw.scores) \
        == len(raw.triple_ids)
    assert raw.scores == sorted(raw.scores, reverse=True)
    # the budget path ranks the same triples in the same order (before
    # token budgeting truncates)
    ctx = svc.retrieve("u0/c0", QUERY)
    t = svc.store.get("u0/c0")
    raw_texts = [t.triples.get(tid).text() for tid in raw.triple_ids]
    ctx_texts = [tr.text() for tr in ctx.triples]
    assert raw_texts[: len(ctx_texts)] == ctx_texts
    # unknown namespace -> empty raw payload, no tenant allocated
    [ghost] = svc.retrieve_batch([("ghost/c0", QUERY)],
                                 plan=RetrievalPlan.raw())
    assert ghost.row_ids == [] and "ghost/c0" not in svc.namespaces()


def test_rrf_fuse_batch_per_row_weights_match_scalar_oracle():
    rng = np.random.default_rng(3)
    for _ in range(40):
        B = int(rng.integers(1, 5))
        d = rng.integers(-1, 10, size=(B, 6)).astype(np.int32)
        s = rng.integers(-1, 10, size=(B, 5)).astype(np.int32)
        w = rng.uniform(0.1, 2.0, size=(B, 2)).astype(np.float32)
        fi, fs = rrf_fuse_batch([d, s], weights=w, k=8)
        fi, fs = fi.numpy(), fs.numpy()
        for b in range(B):
            want = rrf_fuse([d[b].tolist(), s[b].tolist()],
                            weights=[float(w[b, 0]), float(w[b, 1])])[:8]
            got = [(int(i), float(x)) for i, x in zip(fi[b], fs[b])
                   if i >= 0]
            assert got == want
        # and the reference's batched fusion on the same rankings
        ji, js = j_rrf_fuse_batch([d, s], weights=w, k=8)
        np.testing.assert_array_equal(fi, np.asarray(ji))
        np.testing.assert_array_equal(fs, np.asarray(js))
    with pytest.raises(ValueError, match="weights shape"):
        rrf_fuse_batch([d, s], weights=np.ones((B + 1, 2), np.float32))


# -- writes through the scheduler ----------------------------------------------

def test_write_then_read_in_one_tick_is_read_your_writes():
    svc = _svc()
    sched = MemoryScheduler(svc, start=False)
    f_rec = sched.submit(RecordRequest("w/c0", "s0",
                                       _session(["I live in Quito."])))
    f_ret = sched.submit(RetrieveRequest("w/c0", QUERY))
    sched.run_tick_once()
    rec = f_rec.result(timeout=5)
    assert rec.ok and rec.payload["queued"]
    ctx = f_ret.result(timeout=5).result()
    assert any(t.object == "quito" for t in ctx.triples), \
        "a write submitted before a read must be visible to it"
    # the tick's flush drained everything: nothing pending afterwards
    assert svc.stats()["pending_depth"] == 0
    sched.close()


def test_scheduler_writes_preserve_backpressure_and_evict_compact(tmp_path):
    from repro_torch.core import LifecyclePolicy
    policy = LifecyclePolicy(max_pending=1, backpressure="block")
    svc = _svc(policy=policy, data_dir=str(tmp_path / "d"))
    sched = MemoryScheduler(svc, start=False)
    futs = [sched.submit(RecordRequest(f"t{i}/c0", "s0",
                                       _session([f"I live in City{i}."])))
            for i in range(3)]
    futs.append(sched.submit(EvictRequest("t0/c0")))
    futs.append(sched.submit(CompactRequest()))
    sched.run_tick_once()
    resps = [f.result(timeout=5) for f in futs]
    assert all(r.ok for r in resps), [r.error for r in resps]
    assert resps[0].payload["durable"] is True
    assert resps[3].op == "evict" and resps[3].payload == 1
    assert resps[4].op == "compact" and resps[4].payload["dropped"] == 1
    assert svc.retrieve("t1/c0", QUERY).triples
    svc.close()


def test_scheduler_honors_reject_backpressure(tmp_path):
    """`backpressure="reject"` must shed scheduler-routed writes exactly
    like direct callers' — the future carries the BackpressureError, the
    queue is not silently drained."""
    from repro_torch.core import BackpressureError, LifecyclePolicy
    policy = LifecyclePolicy(max_pending=1, backpressure="reject")
    svc = _svc(policy=policy, data_dir=str(tmp_path / "d"))
    svc.enqueue("a/c0", "s0", _session(["I live in Oslo."]))  # queue full
    sched = MemoryScheduler(svc, start=False)
    fut = sched.submit(RecordRequest("b/c0", "s0",
                                     _session(["I live in Quito."])))
    sched.run_tick_once()
    resp = fut.result(timeout=5)
    assert resp.status == "error"
    with pytest.raises(BackpressureError):
        resp.result()
    assert svc.stats()["pending_depth"] == 1, \
        "reject mode must not drain the queue behind the policy's back"
    sched.close()
    svc.close(final_snapshot=False)


def test_multi_writer_tick_group_commits_one_segment_and_recovers(tmp_path):
    svc = _svc(data_dir=str(tmp_path / "d"))
    svc.record("a/c0", "s0", _session(["I live in Oslo."]))
    segs0 = svc.stats()["wal_segments"]
    sched = MemoryScheduler(svc, start=False)
    sched.submit(RecordRequest("b/c0", "s0", _session(["I live in Quito."])))
    sched.submit(RecordRequest("c/c0", "s0", _session(["I live in Hanoi."])))
    sched.submit(EvictRequest("a/c0"))
    sched.run_tick_once()
    assert svc.stats()["wal_segments"] == segs0 + 1, \
        "a multi-writer tick must coalesce into ONE fsync'd segment"
    assert sched.counters["group_commits"] == 1
    queries = [("a/c0", QUERY), ("b/c0", QUERY), ("c/c0", QUERY)]
    want = [c.text for c in svc.retrieve_batch(queries)]
    sched.close()
    svc.close(final_snapshot=False)
    restored = MemoryService.recover(str(tmp_path / "d"),
                                     HashEmbedder(device="cpu"),
                                     device="cpu", budget=800)
    assert [c.text for c in restored.retrieve_batch(queries)] == want
    # the JAX package recovers the port's group-committed directory too
    jrestored = JService.recover(str(tmp_path / "d"), JEmb(),
                                 use_kernel=False, budget=800)
    assert [c.text for c in jrestored.retrieve_batch(queries)] == want


def test_errors_resolve_futures_instead_of_killing_the_tick(monkeypatch):
    svc = _fill(_svc())
    sched = MemoryScheduler(svc, start=False)

    def boom(texts):
        raise RuntimeError("embedder down")

    f_bad = sched.submit(RetrieveRequest("u0/c0", QUERY))
    monkeypatch.setattr(svc.embedder, "embed_texts", boom, raising=False)
    sched.run_tick_once()
    monkeypatch.undo()
    resp = f_bad.result(timeout=5)
    assert resp.status == "error" and "embedder down" in resp.error
    with pytest.raises(RuntimeError, match="embedder down"):
        resp.result()
    # the scheduler survives: the next tick answers fine
    f_ok = sched.submit(RetrieveRequest("u0/c0", QUERY))
    sched.run_tick_once()
    assert f_ok.result(timeout=5).ok
    sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(RetrieveRequest("u0/c0", QUERY))


def test_sparse_only_batch_never_embeds(monkeypatch):
    """A batch with no dense stage must skip the embed call entirely (it
    would be pure waste — only the dense search consumes query vectors)."""
    svc = _fill(_svc())
    calls = []
    real = svc.embedder.embed_texts
    monkeypatch.setattr(svc.embedder, "embed_texts",
                        lambda texts: (calls.append(len(texts)),
                                       real(texts))[1], raising=False)
    got = svc.retrieve_batch([("u0/c0", QUERY), ("u1/c0", QUERY)],
                             plan=RetrievalPlan.sparse_only())
    assert calls == [], "sparse-only retrieval must not embed queries"
    assert got[0].triples
    # in a mixed batch, only the dense-stage queries embed (one call)
    svc.retrieve_batch([RetrieveRequest("u0/c0", QUERY),
                        RetrieveRequest("u1/c0", QUERY,
                                        stages=("sparse", "budget"))])
    assert calls == [1]


def test_closed_scheduler_race_falls_back_to_direct(monkeypatch):
    """If the scheduler closes between can_submit() and the submission
    (shutdown racing a reader), the sync wrapper falls back to the direct
    engine instead of surfacing the closed-scheduler error."""
    svc = _fill(_svc())
    want = svc.retrieve("u0/c0", QUERY)
    sched = MemoryScheduler(svc, start=True)
    sched.close()
    svc.scheduler = sched                          # re-create the race
    monkeypatch.setattr(sched, "can_submit", lambda: True)
    try:
        _ctx_equal(svc.retrieve("u0/c0", QUERY), want)
    finally:
        svc.scheduler = None


def test_close_drains_queued_requests():
    svc = _fill(_svc())
    sched = MemoryScheduler(svc, start=False)
    futs = [sched.submit(RetrieveRequest("u0/c0", QUERY)) for _ in range(3)]
    sched.close()                        # no tick ever ran
    for f in futs:
        assert f.result(timeout=5).ok, "close() must not strand futures"


def test_engine_capture_inside_record_beside_a_waiting_tick(tmp_path):
    """A durable, scheduled service whose `LMExtractor` engine takes its
    first decode step (a CUDA engine's graph capture; a stand-in capture
    here) inside record(), under the runtime's lock, while a tick waits on
    that lock: the capture takes no lock a tick holds, so record() returns
    and the waiting retrieve answers after it."""
    import contextlib

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import LMExtractor
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models.model_api import Model
    from repro_torch.serving.engine import CountedGraph, Engine

    class _Graph:
        def replay(self):
            pass

    at_step, tick_in = threading.Event(), threading.Event()
    captured = []

    class FirstStepCaptures(Engine):
        def step(self):
            if not captured and self.slot_active.any():
                at_step.set()
                assert tick_in.wait(10), "no tick reached execute"
                captured.append(CountedGraph(
                    self.decode, graph=_Graph(),
                    capture=lambda g: contextlib.nullcontext(g)))
            return super().step()          # on the CPU: eager

    cfg = get_config("memori-agent").reduced(layers=2, d_model=64)
    model = Model(cfg)
    engine = FirstStepCaptures(
        model, model.init_params(torch.Generator().manual_seed(0)),
        max_len=64, slots=1, tokenizer=HashTokenizer(512))
    extractor = LMExtractor(
        lambda prompt: engine.generate([prompt], max_new_tokens=4)[0])
    svc = _svc(extractor=extractor, data_dir=str(tmp_path / "d"))
    execute = svc.execute

    def spy(reqs, plan=None):
        tick_in.set()
        return execute(reqs, plan=plan)

    svc.execute = spy
    sched = svc.start_scheduler(tick_interval_s=0.001)
    errors = []

    def record():
        try:
            svc.record("u0/c0", "s0", _session(["I live in Lima."]))
        except Exception as e:                    # surfaced below
            errors.append(e)

    writer = threading.Thread(target=record, daemon=True)
    try:
        writer.start()
        assert at_step.wait(30)
        fut = sched.submit(RetrieveRequest("u1/c0", QUERY))
        writer.join(30)
        assert not writer.is_alive(), "record() and the tick deadlocked"
        assert not errors and len(captured) == 1
        assert fut.result(timeout=30).ok
    finally:
        if not writer.is_alive():      # a deadlock leaves both threads hung
            sched.close()
            svc.close()
