"""Telemetry through the port's serving path, on `device="cpu"`: the
reference's full-stack span-tree case (tests/test_telemetry.py) — a traced
retrieve submitted through the port's scheduler carries its queue wait,
the shared tick and every executed plan stage in ONE tree, with the same
span names as the JAX package's scheduler gives the same request (the
port's parts of a stage, `STAGE_PART_SPANS`, aside)."""
import pytest

from repro_torch.core import (HashEmbedder, MemoryScheduler, MemoryService,
                              Message, RetrieveRequest)
from repro_torch.obs.telemetry import (STAGE_PART_SPANS, Telemetry,
                                       get_telemetry, set_telemetry,
                                       span_names, walk_spans)


@pytest.fixture()
def tel():
    """A fresh registry swapped in as the process-wide one (restored on
    exit so the remaining suite keeps its accumulated metrics)."""
    prev = get_telemetry()
    t = set_telemetry(Telemetry(slow_query_s=None))
    yield t
    set_telemetry(prev)
    t.close()


def test_full_stack_span_tree_scheduler_to_plan(tel):
    """The acceptance path without HTTP: a traced retrieve submitted
    through the scheduler carries queue wait, the shared tick, and every
    executed plan stage in ONE tree."""
    svc = MemoryService(HashEmbedder(device="cpu"), device="cpu", budget=800)
    sched = MemoryScheduler(svc, tick_interval_s=0.002, max_batch=16)
    try:
        svc.record("acme/c0", "s0",
                   [Message("U", "I live in Madrid.", 1.0)])
        tr = tel.start_trace("full-1", op="retrieve")
        fut = sched.submit_many(
            [RetrieveRequest(namespace="acme/c0", query="Which city?")],
            traces=[tr])[0]
        assert fut.result(timeout=30).status == "ok"
        tel.finish_trace(tr)
        names = span_names(tel.get_trace("full-1"))
        for want in ("queued", "scheduler.tick", "plan.embed", "plan.dense",
                     "plan.sparse", "plan.fuse", "plan.budget"):
            assert want in names, f"{want} missing from {names}"
        # the tick span closed before the future resolved: every span in
        # the serialized tree has a duration
        for s in walk_spans(tel.get_trace("full-1")["root"]):
            assert s["duration_s"] is not None
        # the plan stages carry the batch size the launch amortized
        spans = {s["name"]: s for s in walk_spans(
            tel.get_trace("full-1")["root"])}
        assert spans["plan.dense"]["attrs"]["batch"] >= 1
        assert spans["scheduler.tick"]["attrs"]["batch_size"] >= 1
    finally:
        sched.close()

    # the JAX package's scheduler records the same tree for the request
    from repro.core import MemoryScheduler as JScheduler
    from repro.core import MemoryService as JService
    from repro.core.api import RetrieveRequest as JRetrieve
    from repro.core.embedder import HashEmbedder as JEmb
    from repro.core.extraction import Message as JMessage
    from repro.obs import telemetry as jtel
    prev = jtel.get_telemetry()
    jt = jtel.set_telemetry(jtel.Telemetry(slow_query_s=None))
    jsvc = JService(JEmb(), use_kernel=False, budget=800)
    jsched = JScheduler(jsvc, tick_interval_s=0.002, max_batch=16)
    try:
        jsvc.record("acme/c0", "s0",
                    [JMessage("U", "I live in Madrid.", 1.0)])
        jtr = jt.start_trace("full-1", op="retrieve")
        jfut = jsched.submit_many(
            [JRetrieve(namespace="acme/c0", query="Which city?")],
            traces=[jtr])[0]
        assert jfut.result(timeout=60).status == "ok"
        jt.finish_trace(jtr)
        # the port's own parts of a stage aside, every span the JAX
        # package records appears, in the same order
        port = [n for n in span_names(tel.get_trace("full-1"))
                if n not in STAGE_PART_SPANS]
        assert port == jtel.span_names(jt.get_trace("full-1"))
    finally:
        jsched.close()
        jtel.set_telemetry(prev)
        jt.close()
