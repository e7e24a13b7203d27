"""The port's HTTP serving surface (`repro_torch/serving/frontend.py`) end
to end on `device="cpu"`: the cases of the reference's
tests/test_frontend.py on the port — a real ThreadingHTTPServer over a
real service + scheduler, driven through urllib: record -> retrieve ->
stream round trips, api-key tenancy isolation, the error contract (401 /
400 / 404 / 429 + Retry-After), metrics, health, request ids, traces, and
the SDK's HttpMemory client speaking the same wire format.  The
reference's shard-down readiness case waits for the port's sharding
slice (one placement here: `shards_down` is always empty).  The last case
drives one sequence through a JAX-package frontend and a port frontend
and requires equal envelopes (timings and request ids aside) and equal
`/v1/metrics` metric names."""
import json
import threading
import urllib.error
import urllib.request

import pytest

from repro_torch.core import (AdmissionPolicy, HashEmbedder, MemoriClient,
                              MemoryScheduler, MemoryService, TenantPolicy)
from repro_torch.core.sdk import AdmissionError, HttpMemory
from repro_torch.serving.frontend import MemoryFrontend

EMB = HashEmbedder(device="cpu")
KEYS = {"key-acme": "acme", "key-beta": "beta"}


def _service(**kw):
    return MemoryService(EMB, device="cpu", budget=800, **kw)


@pytest.fixture()
def frontend():
    svc = _service()
    sched = MemoryScheduler(svc, tick_interval_s=0.002, max_batch=16)
    fe = MemoryFrontend(svc, KEYS).start()
    yield fe
    fe.close()
    sched.close()


def _call(fe, path, body=None, key="key-acme", method=None):
    req = urllib.request.Request(
        fe.address + path,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Authorization": f"Bearer {key}"},
        method=method or ("GET" if body is None else "POST"))
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), e.headers


def _record_body(city="Lisbon"):
    return {"namespace": "conv0", "session_id": "s0",
            "messages": [{"speaker": "U", "text": f"I live in {city}.",
                          "timestamp": 1.0},
                         {"speaker": "U", "text": "I work as a welder.",
                          "timestamp": 2.0}]}


# -- the acceptance path: record -> retrieve -> stream through real HTTP ------

def test_record_then_retrieve_round_trip(frontend):
    st, env, _ = _call(frontend, "/v1/record", _record_body())
    assert st == 200 and env["status"] == "ok"
    assert env["op"] == "record" and env["payload"]["flushed"]

    st, env, _ = _call(frontend, "/v1/retrieve",
                       {"namespace": "conv0",
                        "query": "Which city does the user live in?"})
    assert st == 200 and env["status"] == "ok"
    pay = env["payload"]
    assert pay["kind"] == "retrieved_context"
    assert any("lisbon" in t["object"] for t in pay["triples"])
    assert pay["token_count"] == env["token_count"] > 0
    assert env["batch_size"] >= 1


def test_streaming_retrieve_ndjson(frontend):
    _call(frontend, "/v1/record", _record_body())
    req = urllib.request.Request(
        frontend.address + "/v1/retrieve",
        data=json.dumps({"namespace": "conv0", "stream": True,
                         "queries": [{"query": "Which city?"},
                                     {"query": "What job?"},
                                     {"query": "Any pets?"}]}).encode(),
        headers={"Authorization": "Bearer key-acme"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        events = [json.loads(line) for line in r.read().decode().splitlines()
                  if line.strip()]
    assert events[0] == {"event": "accepted", "count": 3}
    results = [e for e in events if e["event"] == "result"]
    assert sorted(e["index"] for e in results) == [0, 1, 2]
    assert all(e["response"]["status"] == "ok" for e in results)
    assert events[-1]["event"] == "done" and events[-1]["errors"] == 0


def test_batch_retrieve_preserves_submission_order(frontend):
    _call(frontend, "/v1/record", _record_body())
    st, env, _ = _call(frontend, "/v1/retrieve",
                       {"namespace": "conv0",
                        "queries": [{"query": "city", "top_k": 1},
                                    {"query": "job"}]})
    assert st == 200 and len(env["responses"]) == 2
    assert all(r["status"] == "ok" for r in env["responses"])


# -- tenancy ------------------------------------------------------------------

def test_api_keys_isolate_tenants(frontend):
    _call(frontend, "/v1/record", _record_body("Quito"), key="key-acme")
    # beta uses the SAME namespace string but sees nothing of acme's
    st, env, _ = _call(frontend, "/v1/retrieve",
                       {"namespace": "conv0", "query": "Which city?"},
                       key="key-beta")
    assert st == 200
    assert env["payload"]["triples"] == []
    # and beta's evict of "conv0" cannot touch acme's rows
    st, env, _ = _call(frontend, "/v1/evict", {"namespace": "conv0"},
                       key="key-beta")
    assert st == 200 and env["payload"] == 0
    st, env, _ = _call(frontend, "/v1/retrieve",
                       {"namespace": "conv0", "query": "Which city?"},
                       key="key-acme")
    assert any("quito" in t["object"] for t in env["payload"]["triples"])


def test_unknown_key_is_401(frontend):
    st, env, _ = _call(frontend, "/v1/stats", key="nope")
    assert st == 401 and env["status"] == "error"


# -- error contract -----------------------------------------------------------

def test_bad_bodies_are_400(frontend):
    st, env, _ = _call(frontend, "/v1/record", {"namespace": "c"})
    assert st == 400 and "messages" in env["error"]
    st, env, _ = _call(frontend, "/v1/retrieve",
                       {"query": "q", "stages": ["bm42"]})
    assert st == 400 and "unknown retrieval stages" in env["error"]


def test_unknown_route_is_404(frontend):
    st, env, _ = _call(frontend, "/v1/nope", {})
    assert st == 404


def test_rate_limited_tenant_gets_429_with_retry_after():
    svc = _service()
    sched = MemoryScheduler(
        svc, tick_interval_s=0.002,
        admission=AdmissionPolicy(
            tenants={"acme": TenantPolicy(rate=0.001, burst=2)}))
    fe = MemoryFrontend(svc, KEYS).start()
    try:
        for _ in range(2):
            st, _, _ = _call(fe, "/v1/retrieve",
                             {"namespace": "c", "query": "q"})
            assert st == 200
        st, env, headers = _call(fe, "/v1/retrieve",
                                 {"namespace": "c", "query": "q"})
        assert st == 429
        assert env["reason"] == "rate_limited"
        assert int(headers["Retry-After"]) >= 1
        assert env["retry_after_s"] > 0
        # beta is untouched by acme's limit
        st, _, _ = _call(fe, "/v1/retrieve",
                         {"namespace": "c", "query": "q"}, key="key-beta")
        assert st == 200
    finally:
        fe.close()
        sched.close()


# -- stats --------------------------------------------------------------------

def test_stats_reports_all_layers(frontend):
    _call(frontend, "/v1/record", _record_body())
    st, stats, _ = _call(frontend, "/v1/stats")
    assert st == 200
    assert stats["tenant"] == "acme"
    assert stats["service"]["bank_rows"] >= 1
    assert stats["scheduler"]["ticks"] >= 1
    assert "acme" in stats["scheduler"]["admission"]["tenants"]
    assert stats["frontend"]["requests"] >= 2


# -- SDK client over the wire -------------------------------------------------

def test_http_memory_client_round_trip(frontend):
    mem = HttpMemory(frontend.address, "key-acme", namespace="conv9")
    out = mem.record_session("conv9", "s0", [
        type("M", (), {"speaker": "U", "text": "I live in Osaka.",
                       "timestamp": 1.0})(),
        type("M", (), {"speaker": "U", "text": "I adopted a cat.",
                       "timestamp": 2.0})()])
    assert out["flushed"]
    ctx = mem.retrieve("Which city does the user live in?")
    assert any("osaka" in t.object for t in ctx.triples)
    assert ctx.token_count > 0
    prompt, ctx2 = mem.answer_prompt("Which city?")
    assert ctx2.text in prompt and "Which city?" in prompt
    # the full SDK wrapper composes over the HTTP transport unchanged
    client = MemoriClient(lambda p: "a reply", mem)
    assert client.chat("What pets do I have?") == "a reply"
    client.end_session()


def test_http_memory_raises_admission_error_on_429():
    svc = _service()
    sched = MemoryScheduler(
        svc, tick_interval_s=0.002,
        admission=AdmissionPolicy(
            tenants={"acme": TenantPolicy(rate=0.001, burst=1)}))
    fe = MemoryFrontend(svc, KEYS).start()
    try:
        mem = HttpMemory(fe.address, "key-acme")
        mem.retrieve("q")
        with pytest.raises(AdmissionError) as ei:
            mem.retrieve("q")
        assert ei.value.reason == "rate_limited"
        assert ei.value.retry_after_s > 0
    finally:
        fe.close()
        sched.close()


# -- concurrency: many handler threads funnel into shared ticks ---------------

def test_concurrent_http_clients_share_scheduler_ticks(frontend):
    _call(frontend, "/v1/record", _record_body())
    n, errs = 24, []
    barrier = threading.Barrier(n)

    def worker():
        barrier.wait()
        st, env, _ = _call(frontend, "/v1/retrieve",
                           {"namespace": "conv0", "query": "Which city?"})
        if st != 200 or env["status"] != "ok":
            errs.append(env)

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    st, stats, _ = _call(frontend, "/v1/stats")
    # batching happened: fewer launches than retrieves
    assert stats["scheduler"]["retrieve_launches"] \
        < stats["scheduler"]["retrieves"]


def _scrape(fe, key="key-acme"):
    req = urllib.request.Request(
        fe.address + "/v1/metrics",
        headers={"Authorization": f"Bearer {key}"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.read().decode(), r.headers


def _parse_exposition(text):
    """Strict parse of a Prometheus text exposition: returns
    (types, helps, samples) where types/helps are keyed by the declared
    metric family name and samples by the full sample name (including any
    `{le="..."}` label)."""
    types, helps, samples = {}, {}, {}
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# HELP "):
            name, _, rest = ln[len("# HELP "):].partition(" ")
            helps[name] = rest
        elif ln.startswith("# TYPE "):
            name, _, kind = ln[len("# TYPE "):].partition(" ")
            assert name not in types, f"duplicate TYPE for {name}"
            types[name] = kind
        else:
            assert not ln.startswith("#"), f"unknown comment line: {ln!r}"
            name, _, val = ln.partition(" ")
            float(val)                   # every sample parses as a number
            assert name not in samples, f"duplicate sample {name}"
            samples[name] = val
    return types, helps, samples


def _check_histogram_family(name, samples):
    """Cumulative nondecreasing buckets ending at +Inf == _count, plus a
    _sum — the exact shape promtool requires."""
    buckets = [(k, int(v)) for k, v in samples.items()
               if k.startswith(name + "_bucket{")]
    assert buckets, f"histogram {name} exported no buckets"
    counts = [c for _, c in buckets]
    assert counts == sorted(counts), f"{name} buckets not cumulative"
    assert buckets[-1][0] == name + '_bucket{le="+Inf"}'
    assert int(samples[name + "_count"]) == counts[-1]
    float(samples[name + "_sum"])


def test_metrics_prometheus_exposition(frontend):
    _call(frontend, "/v1/record", _record_body())
    _call(frontend, "/v1/retrieve",
          {"namespace": "conv0", "query": "Which city?"})
    st, text, headers = _scrape(frontend)
    assert st == 200
    assert headers["Content-Type"].startswith("text/plain")
    types, helps, samples = _parse_exposition(text)
    # every family declares a legal type AND a help string
    for name, kind in types.items():
        assert name.startswith("memori_")
        assert kind in ("gauge", "counter", "histogram"), (name, kind)
        assert helps.get(name), f"{name} has no HELP line"
        if kind == "gauge":
            assert name in samples, f"gauge {name} has no sample"
        elif kind == "counter":
            # counters carry the _total suffix on the wire, never bare
            assert name.endswith("_total"), name
            assert name in samples and name[:-len("_total")] not in samples
            assert float(samples[name]) >= 0
        else:
            _check_histogram_family(name, samples)
    # every sample line belongs to a declared family
    for full in samples:
        base = full.split("{", 1)[0]
        for suf in ("_bucket", "_sum", "_count"):
            if base.endswith(suf) and base[:-len(suf)] in types:
                base = base[:-len(suf)]
                break
        assert base in types, f"sample {full} missing TYPE declaration"
    # the layers the dashboard needs are all present
    for want in ("memori_namespaces", "memori_bank_hot_rows",
                 "memori_bank_quant_searches",
                 "memori_scheduler_retrieves",
                 "memori_frontend_requests"):
        assert want in samples, f"missing {want}\n{sorted(samples)[:40]}"
    assert samples["memori_scheduler_retrieves"] == "1"
    assert int(samples["memori_frontend_requests"]) >= 2
    # quantization off in this fixture: the knob is still visible as 0
    assert samples["memori_bank_quantized"] == "0"
    # the request-latency histograms ride along on the same scrape
    for hist in ("memori_retrieve_latency_seconds",
                 "memori_record_latency_seconds"):
        assert types.get(hist) == "histogram", f"{hist} not exported"
        assert int(samples[hist + "_count"]) >= 1


def test_metrics_requires_auth(frontend):
    req = urllib.request.Request(frontend.address + "/v1/metrics")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 401


def test_metrics_reports_tier_counters():
    """With quantization + tiering mounted the scrape carries the tier
    gauges a capacity dashboard alerts on."""
    from repro_torch.core.lifecycle import LifecyclePolicy
    from repro_torch.core.tiering import TierPolicy
    svc = _service(quantize="int8",
                   policy=LifecyclePolicy(tier=TierPolicy(max_hot_rows=4)))
    svc.runtime._stop.set()
    fe = MemoryFrontend(svc, KEYS).start()
    try:
        _call(fe, "/v1/record", _record_body())
        svc.runtime.run_maintenance_once()
        _, text, _ = _scrape(fe)
        samples = dict(ln.split(" ") for ln in text.splitlines()
                       if not ln.startswith("#"))
        assert samples["memori_bank_quantized"] == "1"
        assert "memori_tiering_demotions" in samples
        assert "memori_tiering_hot_rows" in samples
        assert int(samples["memori_tiering_max_hot_rows"]) == 4
    finally:
        fe.close()
        svc.close(final_snapshot=False)


# -- health, readiness, request ids, traces -----------------------------------

def _call_raw(fe, path, body=None, headers=None, method=None):
    """Like _call but with caller-controlled headers (no implicit auth)."""
    req = urllib.request.Request(
        fe.address + path,
        data=None if body is None else json.dumps(body).encode(),
        headers=headers or {},
        method=method or ("GET" if body is None else "POST"))
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), e.headers


def _tree_names(trace):
    """Flatten a serialized span tree into the set of span names."""
    out = []

    def walk(sp):
        out.append(sp["name"])
        for c in sp.get("children", ()):
            walk(c)
    walk(trace["root"])
    return out


def test_healthz_and_readyz_unauthenticated(frontend):
    st, body, _ = _call_raw(frontend, "/v1/healthz")
    assert st == 200 and body["status"] == "ok"
    st, body, _ = _call_raw(frontend, "/v1/readyz")
    assert st == 200 and body["status"] == "ok"


def test_readyz_503_under_reject_backpressure():
    from repro_torch.core.extraction import Message
    from repro_torch.core.lifecycle import LifecyclePolicy
    svc = _service(policy=LifecyclePolicy(max_pending=1,
                                          backpressure="reject"))
    svc.runtime._stop.set()              # no background flusher interference
    fe = MemoryFrontend(svc, KEYS).start()
    try:
        svc.enqueue("a/c0", "s0",
                    [Message("U", "I live in Oslo.", 1.0)])
        st, body, _ = _call_raw(fe, "/v1/readyz")
        assert st == 503 and body["backpressure_reject"] is True
        svc.flush()                      # queue drains -> ready again
        st, _, _ = _call_raw(fe, "/v1/readyz")
        assert st == 200
    finally:
        fe.close()
        svc.close(final_snapshot=False)


def test_request_id_honored_and_minted(frontend):
    _call(frontend, "/v1/record", _record_body())
    # caller-supplied X-Request-Id flows into envelope + response header
    st, env, headers = _call_raw(
        frontend, "/v1/retrieve",
        {"namespace": "conv0", "query": "Which city?"},
        headers={"Authorization": "Bearer key-acme",
                 "X-Request-Id": "req-abc.123"})
    assert st == 200
    assert env["request_id"] == "req-abc.123"
    assert headers["X-Request-Id"] == "req-abc.123"
    # absent (or junk) -> the frontend mints one
    st, env, headers = _call(frontend, "/v1/retrieve",
                             {"namespace": "conv0", "query": "Which city?"})
    assert st == 200
    minted = env["request_id"]
    assert minted and headers["X-Request-Id"] == minted
    st, env, _ = _call_raw(
        frontend, "/v1/retrieve",
        {"namespace": "conv0", "query": "Which city?"},
        headers={"Authorization": "Bearer key-acme",
                 "X-Request-Id": "ill egal;header" + "x" * 80})
    assert st == 200 and env["request_id"] != ""


def test_debug_retrieve_returns_complete_span_tree(frontend):
    _call(frontend, "/v1/record", _record_body())
    st, env, _ = _call(frontend, "/v1/retrieve",
                       {"namespace": "conv0", "query": "Which city?",
                        "debug": True})
    assert st == 200
    trace = env["trace"]
    assert trace["request_id"] == env["request_id"]
    assert trace["op"] == "retrieve" and trace["duration_s"] > 0
    names = _tree_names(trace)
    # the full path: frontend -> admission -> queue wait -> shared tick ->
    # every executed plan stage
    for want in ("frontend", "admission", "queued", "scheduler.tick",
                 "plan.embed", "plan.dense", "plan.sparse", "plan.fuse",
                 "plan.budget"):
        assert want in names, f"span {want} missing from {names}"
    # without debug the envelope stays lean
    st, env, _ = _call(frontend, "/v1/retrieve",
                       {"namespace": "conv0", "query": "Which city?"})
    assert st == 200 and "trace" not in env


def test_admin_trace_endpoint():
    svc = _service()
    sched = MemoryScheduler(svc, tick_interval_s=0.002, max_batch=16)
    fe = MemoryFrontend(svc, KEYS,
                        admin_keys={"admin-key": "ops"}).start()
    try:
        _call(fe, "/v1/record", _record_body())
        st, _, _ = _call_raw(
            fe, "/v1/retrieve", {"namespace": "conv0", "query": "city?"},
            headers={"Authorization": "Bearer key-acme",
                     "X-Request-Id": "trace-me-1"})
        assert st == 200
        st, body, _ = _call_raw(
            fe, "/v1/admin/trace/trace-me-1",
            headers={"Authorization": "Bearer admin-key"})
        assert st == 200 and body["operator"] == "ops"
        tr = body["trace"]
        assert tr["request_id"] == "trace-me-1"
        assert "scheduler.tick" in _tree_names(tr)
        # tenant keys never reach the admin surface
        st, _, _ = _call_raw(
            fe, "/v1/admin/trace/trace-me-1",
            headers={"Authorization": "Bearer key-acme"})
        assert st == 401
        # unknown request id -> 404
        st, _, _ = _call_raw(
            fe, "/v1/admin/trace/never-issued",
            headers={"Authorization": "Bearer admin-key"})
        assert st == 404
    finally:
        fe.close()
        sched.close()


def test_admin_trace_404_without_keyring(frontend):
    st, _, _ = _call_raw(frontend, "/v1/admin/trace/whatever",
                         headers={"Authorization": "Bearer key-acme"})
    assert st == 404


def test_http_memory_timing_and_traced_retrieve(frontend):
    mem = HttpMemory(frontend.address, "key-acme", namespace="conv7")
    mem.record_session("conv7", "s0", [
        type("M", (), {"speaker": "U", "text": "I live in Turin.",
                       "timestamp": 1.0})()])
    t = mem.last_timing
    assert t["request_id"] and t["service_s"] >= 0 and t["batch_size"] >= 1
    ctx, trace = mem.retrieve_traced("Which city does the user live in?")
    assert any("turin" in tr.object for tr in ctx.triples)
    assert trace["op"] == "retrieve"
    assert "plan.dense" in _tree_names(trace)
    assert mem.last_timing["request_id"] == trace["request_id"]


def test_metrics_exports_all_latency_histograms(tmp_path):
    """The acceptance scrape: with a durable service mounted, one
    record + one retrieve over HTTP populate all four latency histograms
    (retrieve/record/flush/fsync) on /v1/metrics."""
    from repro_torch.obs.telemetry import (Telemetry, get_telemetry,
                                           set_telemetry)
    prev = get_telemetry()
    set_telemetry(Telemetry())
    svc = _service(data_dir=str(tmp_path / "data"))
    svc.runtime._stop.set()
    sched = MemoryScheduler(svc, tick_interval_s=0.002, max_batch=16)
    fe = MemoryFrontend(svc, KEYS).start()
    try:
        st, _, _ = _call(fe, "/v1/record", _record_body())
        assert st == 200
        st, _, _ = _call(fe, "/v1/retrieve",
                         {"namespace": "conv0", "query": "Which city?"})
        assert st == 200
        _, text, _ = _scrape(fe)
        types, _, samples = _parse_exposition(text)
        for hist in ("memori_retrieve_latency_seconds",
                     "memori_record_latency_seconds",
                     "memori_flush_latency_seconds",
                     "memori_fsync_latency_seconds"):
            assert types.get(hist) == "histogram", f"{hist} not exported"
            assert int(samples[hist + "_count"]) >= 1, hist
            _check_histogram_family(hist, samples)
        # the write path's counters rode along
        assert float(samples["memori_wal_appends_total"]) >= 1
        assert float(samples["memori_wal_fsyncs_total"]) >= 1
    finally:
        fe.close()
        sched.close()
        svc.close(final_snapshot=False)
        set_telemetry(prev)


# -- the port's wire format against the reference's ----------------------------

_TIMING = ("queued_s", "service_s", "request_id")


def _lean(env):
    """An envelope without its timings and request id (they differ run to
    run); nested envelopes too."""
    if isinstance(env, dict):
        return {k: _lean(v) for k, v in env.items() if k not in _TIMING}
    if isinstance(env, list):
        return [_lean(v) for v in env]
    return env


def _stream(fe, body, key="key-acme"):
    req = urllib.request.Request(
        fe.address + "/v1/retrieve", data=json.dumps(body).encode(),
        headers={"Authorization": f"Bearer {key}"})
    with urllib.request.urlopen(req, timeout=30) as r:
        events = [json.loads(ln) for ln in r.read().decode().splitlines()
                  if ln.strip()]
    # results arrive in completion order; `index` maps them back
    return sorted((_lean(e) for e in events),
                  key=lambda e: (e["event"] != "accepted",
                                 e["event"] == "done", e.get("index", -1)))


def _wire_sequence(fe):
    out = [_call(fe, "/v1/record", _record_body("Quito"))[:2],
           _call(fe, "/v1/record", dict(_record_body("Hanoi"),
                                        namespace="conv1"))[:2],
           _call(fe, "/v1/retrieve", {"namespace": "conv0",
                                      "query": "Which city?"})[:2],
           _call(fe, "/v1/retrieve",
                 {"namespace": "conv0",
                  "queries": [{"query": "city", "top_k": 1},
                              {"query": "What job?"},
                              {"namespace": "conv1", "query": "city",
                               "stages": ["sparse", "budget"]}]})[:2],
           _stream(fe, {"namespace": "conv1", "stream": True,
                        "queries": [{"query": "Which city?"},
                                    {"query": "welder", "top_k": 2}]}),
           _call(fe, "/v1/retrieve", {"namespace": "conv0",
                                      "query": "Which city?"},
                 key="key-beta")[:2],
           _call(fe, "/v1/evict", {"namespace": "conv0"}, key="key-beta")[:2],
           _call(fe, "/v1/evict", {"namespace": "conv1"})[:2],
           _call(fe, "/v1/retrieve", {"namespace": "conv1",
                                      "query": "Which city?"})[:2],
           _call(fe, "/v1/record", {"namespace": "c"})[:2],
           _call(fe, "/v1/nope", {})[:2]]
    out = [(st, _lean(env)) if isinstance(st, int) else st
           for st, env in (o if isinstance(o, tuple) else (o, None)
                           for o in out)]
    _, text, _ = _scrape(fe)
    types, _, _ = _parse_exposition(text)
    return out, types


def test_wire_format_and_metric_names_match_the_reference():
    from repro.core import MemoryScheduler as JScheduler
    from repro.core import MemoryService as JService
    from repro.core.embedder import HashEmbedder as JEmb
    from repro.obs import telemetry as jtel
    from repro.serving.frontend import MemoryFrontend as JFrontend
    from repro_torch.obs import telemetry as ttel

    got = {}
    for name, tel, make, sched_cls, fe_cls in (
            ("jax", jtel, lambda: JService(JEmb(), use_kernel=False,
                                           budget=800),
             JScheduler, JFrontend),
            ("port", ttel, _service, MemoryScheduler, MemoryFrontend)):
        prev = tel.get_telemetry()
        # no slow-query threshold: which request is slow is timing, not
        # wire format
        tel.set_telemetry(tel.Telemetry(slow_query_s=None))
        svc = make()
        sched = sched_cls(svc, tick_interval_s=0.002, max_batch=16)
        fe = fe_cls(svc, KEYS).start()
        try:
            got[name] = _wire_sequence(fe)
        finally:
            fe.close()
            sched.close()
            tel.set_telemetry(prev)
    (j_out, j_types), (t_out, t_types) = got["jax"], got["port"]
    assert len(t_out) == len(j_out)
    for i, (t, j) in enumerate(zip(t_out, j_out)):
        assert t == j, f"step {i}"
    # the streamed batch and the evictions answered as expected
    assert t_out[4][-1] == {"event": "done", "count": 2, "errors": 0}
    assert t_out[6][0] == 200 and t_out[6][1]["payload"] == 0
    assert t_out[7][0] == 200 and t_out[7][1]["payload"] > 0
    assert sorted(t_types.items()) == sorted(j_types.items())
