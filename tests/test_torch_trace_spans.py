"""The port's span contract inside the plan stages: BM25's sparse stage and
the budgeter split into their parts, `h2d_bytes` counted where host data
goes to the device, every span on the profiler's clock with a
`memori.<name>` range while a profiler runs, and nothing recorded or
opened with no trace active."""
import pytest
import torch

from repro_torch.core import (HashEmbedder, MemoryService, Message,
                              RetrievalPlan, RetrieveRequest)
from repro_torch.obs import telemetry as telemetry_mod
from repro_torch.obs.telemetry import (STAGE_PART_SPANS, Telemetry,
                                       get_telemetry, set_telemetry,
                                       walk_spans)

FACTS = ["I live in Madrid.", "My sister Ana works at a bakery.",
         "I adopted a cat named Miso.", "We went hiking in Gredos."]


@pytest.fixture(scope="module")
def svc():
    s = MemoryService(HashEmbedder(device="cpu"), device="cpu", budget=800)
    for i, fact in enumerate(FACTS):
        s.record(f"acme/c{i}", "s0", [Message("U", fact, 1.0)])
    return s


@pytest.fixture()
def tel():
    prev = get_telemetry()
    t = set_telemetry(Telemetry(slow_query_s=None))
    yield t
    set_telemetry(prev)
    t.close()


def _reqs(n=3):
    return [RetrieveRequest(namespace=f"acme/c{i}", query="Where do I live?")
            for i in range(n)]


def _traced(tel, svc, plan, reqs):
    tr = tel.start_trace(op="execute")
    with tel.activate([tr]):
        out = svc.retrieve_batch(reqs, plan=plan)
    tel.finish_trace(tr)
    assert len(out) == len(reqs)
    return tr.to_dict()


def _stage(trace, name):
    (st,) = [c for c in trace["root"]["children"] if c["name"] == name]
    return st


def test_sparse_and_budget_parts_under_their_stages(tel, svc):
    reqs = _reqs(3)
    trace = _traced(tel, svc, RetrievalPlan.hybrid(), reqs)
    sparse = _stage(trace, "plan.sparse")
    parts = {c["name"]: c for c in sparse["children"]}
    assert list(parts) == ["sparse.select", "sparse.upload", "sparse.stats",
                           "sparse.score"]
    score = parts["sparse.score"]
    assert score["attrs"]["summed"] is True and score["attrs"]["parts"] == 2
    assert sum(c["duration_s"] for c in parts.values()) \
        <= sparse["duration_s"]
    # the masks' upload: (Bp, capacity) bools, padded to the pow2 batch
    cap = svc.store.bm25._docs.shape[0]
    assert parts["sparse.upload"]["attrs"]["h2d_bytes"] == 4 * cap
    budget = _stage(trace, "plan.budget")
    kids = {c["name"]: c for c in budget["children"]}
    assert list(kids) == ["budget.select", "budget.render"]
    for c in kids.values():
        assert c["attrs"]["summed"] is True
        assert c["attrs"]["parts"] == len(reqs)
    sel = kids["budget.select"]["attrs"]
    assert sel["considered"] >= sel["kept"] >= 1
    assert set(STAGE_PART_SPANS) == set(parts) | set(kids)


def test_summed_bounds_span_the_first_part_to_the_last(tel, svc):
    trace = _traced(tel, svc, RetrievalPlan.hybrid(), _reqs(2))
    for s in walk_spans(trace["root"]):
        if s["name"] == "root" or s.get("duration_s") is None:
            continue
        assert s["end_unix_ns"] >= s["start_unix_ns"]
        if s.get("attrs", {}).get("summed"):
            # the parts' sum fits inside the interval they ran in
            assert s["duration_s"] * 1e9 <= \
                s["end_unix_ns"] - s["start_unix_ns"] + 1e3


def test_h2d_bytes_count_what_execute_uploads(tel, svc):
    reqs = _reqs(3)
    trace = _traced(tel, svc, RetrievalPlan.hybrid(), reqs)
    by = {}
    for s in walk_spans(trace["root"]):
        n = s.get("attrs", {}).get("h2d_bytes")
        if n:
            by[s["name"]] = n
    # query vectors under the embed, the query namespaces under the dense
    # stage, the masks and the term statistics under BM25's parts, the
    # fusion's positions and weights under the fuse
    assert {"plan.embed", "plan.dense", "sparse.upload", "sparse.stats",
            "plan.fuse"} <= set(by)
    assert by["plan.embed"] == 3 * svc.embedder.dim * 4
    cap = svc.store.bm25._docs.shape[0]
    assert sum(by.values()) > 4 * cap


def test_stage_spans_carry_no_launch_count(tel, svc):
    trace = _traced(tel, svc, RetrievalPlan.hybrid(), _reqs(2))
    stages = [s for s in walk_spans(trace["root"])
              if s["name"].startswith("plan.")]
    assert {s["name"] for s in stages} >= {"plan.embed", "plan.dense",
                                           "plan.sparse", "plan.fuse",
                                           "plan.budget"}
    assert all("launches" not in s.get("attrs", {}) for s in stages)


def test_no_active_trace_creates_no_span_and_opens_no_range(monkeypatch,
                                                            tel, svc):
    def refuse(*a, **kw):
        raise AssertionError("recorded with no trace active")
    monkeypatch.setattr(telemetry_mod, "Span", refuse)
    monkeypatch.setattr(telemetry_mod.Trace, "push", refuse)
    monkeypatch.setattr(telemetry_mod, "_profiler_range", refuse)
    out = svc.retrieve_batch(_reqs(3), plan=RetrievalPlan.hybrid())
    assert len(out) == 3
    assert tel.recent_traces() == []


def test_without_a_profiler_no_range_is_opened(monkeypatch, tel, svc):
    def refuse(*a, **kw):
        raise AssertionError("a profiler range with no profiler active")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    trace = _traced(tel, svc, RetrievalPlan.hybrid(), _reqs(2))
    assert _stage(trace, "plan.sparse")["children"]


def test_profiler_ranges_match_the_spans_on_the_shared_clock(tel, svc):
    from torch.profiler import ProfilerActivity, profile, record_function
    # a process's first range resolves the profiler's operators (~1 ms,
    # once): take it before the measured execute
    with profile(activities=[ProfilerActivity.CPU]):
        with record_function("memori.warm-up"):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace = _traced(tel, svc, RetrievalPlan.hybrid(), _reqs(3))
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("memori."):
            s, d = e.start_ns(), e.duration_ns()
            lo, hi = ranges.get(name, (s, s + d))
            ranges[name] = (min(lo, s), max(hi, s + d))
    spans = [s for s in walk_spans(trace["root"])
             if s["name"] != trace["root"]["name"]]
    assert {"memori." + s["name"] for s in spans} == set(ranges)
    for s in spans:
        lo, hi = ranges["memori." + s["name"]]
        assert abs(lo - s["start_unix_ns"]) < 1e6, s["name"]
        assert abs(hi - s["end_unix_ns"]) < 1e6, s["name"]
