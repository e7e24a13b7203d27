"""HTTP serving surface for the memory layer — the network face of the
typed API (the ROADMAP's "network serving surface with streaming +
per-tenant QoS").

Stdlib-only (`http.server.ThreadingHTTPServer`; one handler thread per
connection, all of them funneling into the scheduler's micro-batch ticks —
the thread-per-request frontend and the batched backend compose exactly
like the SDK clients do).  Four endpoints:

    POST /v1/retrieve   {"query": ...} or {"queries": [{...}, ...]}
    POST /v1/record     {"session_id", "messages": [{speaker,text,ts}]}
    POST /v1/evict      {"namespace", "superseded_only": false}
    GET  /v1/stats      service + scheduler + admission + frontend counters
    GET  /v1/metrics    Prometheus text exposition: every numeric leaf of
                        service/scheduler/frontend stats as a `memori_<path>`
                        gauge, plus the telemetry registry's latency
                        histograms and monotonic counters
                        (obs/telemetry.py), all with `# HELP`/`# TYPE`
    GET  /v1/healthz    liveness (unauthenticated): 200 while serving
    GET  /v1/readyz     readiness (unauthenticated): 503 while any
                        placement shard is down or the lifecycle queue is
                        in reject-backpressure

**Observability**: every request gets a request id — `X-Request-Id` is
honored when the client sends one (sanitized), minted otherwise, echoed
as a response header and as `request_id` in the JSON envelope.  The op
endpoints open a telemetry `Trace` at the edge; the id rides with the
request through admission, the scheduler tick and every plan stage, and
the finished span tree lands in the registry's ring buffer —
`GET /v1/admin/trace/<request_id>` (admin keyring) fetches it, and
`"debug": true` on /v1/retrieve returns it inline.  The response envelope
carries the server-side split (`queued_s` / `service_s` / `batch_size`),
so remote clients see where the time went, not just wall clock.

**Tenancy** is workspace/api-key shaped (the MemoryLayer SDK surface):
every request authenticates with `Authorization: Bearer <key>` (or
`X-Api-Key`), the key maps to a *tenant*, and every namespace the body
names is scoped to `<tenant>/<namespace>` before it touches the service —
a key can never read, write, or evict outside its own prefix, and the
tenant is also the QoS identity the scheduler's admission control
charges.

**Requests/responses are the typed API on the wire**: bodies decode
through `core/api.py`'s `*_from_json` codecs (same validation as direct
callers) and every reply is the `MemoryResponse` envelope via
`response_to_json`.  Errors use the same envelope with `status="error"`:
400 for validation, 401 for a bad key, 404 for an unknown route, 429 +
`Retry-After` when admission control rejects (rate limit / shed /
backpressure), 504 when a request times out in the queue.

**Streaming**: `{"stream": true}` on /v1/retrieve switches the response
to chunked transfer, NDJSON framed — one `accepted` event as soon as the
batch is admitted, one `result` event per request *as its future
resolves* (completion order, `index` maps back to the submitted order),
and a final `done` event.  A client fanning one batch across namespaces
renders early results while late ones still sit in a tick.

**Devices**: with a scheduler mounted, handler threads never touch the
device — they submit and wait, and the tick thread runs every batch on the
read path's CUDA stream.  Without one, a handler runs its request on the
direct engine on its own thread, as the reference does.  The
service's stats hold host numbers only, so `/v1/stats` and `/v1/metrics`
never wait on the device.  `/v1/readyz` reads the placement shards through
`store.sharded`; the port's store has one placement, so `shards_down` is
always empty.
"""
from __future__ import annotations

import json
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Mapping, Optional, Tuple

from concurrent.futures import TimeoutError as FutureTimeoutError

from repro_torch.core.admission import (AdmissionError,
                                        admission_policy_from_json)
from repro_torch.core.api import (CompactRequest, EvictRequest,
                                  MemoryResponse, RecordRequest,
                                  RetrieveRequest, record_request_from_json,
                                  response_to_json,
                                  retrieve_request_from_json)
from repro_torch.core.lifecycle import BackpressureError
from repro_torch.obs.telemetry import get_telemetry, new_request_id

_MAX_BODY = 8 << 20          # one request body; sessions are small
# client-supplied X-Request-Id values must be log/header-safe; anything
# else is replaced with a minted id (never rejected — ids are advisory)
_REQ_ID_RE = re.compile(r"^[A-Za-z0-9._\-]{1,64}$")


class _HttpError(Exception):
    def __init__(self, code: int, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.code = code
        self.retry_after_s = retry_after_s


def _json_default(o):
    """stats() dicts can carry numpy scalars (or 0-d host tensors); render
    them, never crash."""
    item = getattr(o, "item", None)
    return item() if callable(item) else repr(o)


def _metric_name(*parts: str) -> str:
    name = "_".join(re.sub(r"[^a-zA-Z0-9_]", "_", str(p)) for p in parts)
    return re.sub(r"__+", "_", name)


def flatten_metrics(stats: Mapping, prefix: str = "memori") -> List[Tuple[str, float]]:
    """Flatten a nested stats dict into Prometheus gauge samples: every
    numeric leaf becomes `<prefix>_<path> <value>` (bools as 0/1, numpy
    scalars unwrapped, None/str/unbounded-cardinality subtrees skipped).
    Deterministic order — scrapes diff cleanly."""
    out: List[Tuple[str, float]] = []
    for k in stats:
        v = stats[k]
        if k == "per_namespace":       # unbounded label cardinality
            continue
        name = _metric_name(prefix, k)
        if isinstance(v, Mapping):
            out.extend(flatten_metrics(v, prefix=name))
            continue
        item = getattr(v, "item", None)
        if callable(item) and not isinstance(v, (bool, int, float)):
            try:
                v = item()
            except Exception:
                continue
        if isinstance(v, bool):
            out.append((name, 1.0 if v else 0.0))
        elif isinstance(v, (int, float)) and math.isfinite(v):
            out.append((name, float(v)))
    return out


def render_prometheus(samples: List[Tuple[str, float]],
                      metrics: Tuple = ()) -> str:
    """Prometheus text exposition: `samples` are point-in-time gauges
    (flattened stats leaves, each with `# HELP`/`# TYPE`); `metrics` are
    telemetry registry objects (Counter/Histogram from obs/telemetry.py)
    rendered through their own `exposition()` — counters get the `_total`
    suffix and `counter` type, histograms emit cumulative
    `_bucket`/`_sum`/`_count` series."""
    lines = []
    for name, value in samples:
        lines.append(f"# HELP {name} point-in-time gauge "
                     "(stats() leaf)")
        lines.append(f"# TYPE {name} gauge")
        if value == int(value) and abs(value) < 2 ** 53:
            lines.append(f"{name} {int(value)}")
        else:
            lines.append(f"{name} {value}")
    for m in metrics:
        lines.extend(m.exposition())
    return "\n".join(lines) + "\n"


class MemoryFrontend:
    """The server object: owns the ThreadingHTTPServer, the api-key ->
    tenant map, and the request counters.  `service` is a MemoryService;
    when it has a MemoryScheduler mounted every handler thread submits
    through it (admission control + cross-client batching), otherwise
    requests run on the direct engine."""

    def __init__(self, service, api_keys: Mapping[str, str],
                 host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 60.0,
                 admin_keys: Optional[Mapping[str, str]] = None):
        if not api_keys:
            raise ValueError("MemoryFrontend needs at least one api key "
                             "(api_key -> tenant)")
        self.service = service
        self.api_keys: Dict[str, str] = dict(api_keys)
        # the admin keyring (admin_key -> operator label) is DISJOINT from
        # tenant keys: a tenant key can never reach the admin surface, and
        # an admin key is not a tenant.  No admin_keys = no admin surface.
        self.admin_keys: Dict[str, str] = dict(admin_keys or {})
        overlap = set(self.api_keys) & set(self.admin_keys)
        if overlap:
            raise ValueError("api_keys and admin_keys must be disjoint "
                             f"({len(overlap)} shared keys)")
        self.request_timeout_s = float(request_timeout_s)
        self.counters = {"requests": 0, "unauthorized": 0, "bad_requests": 0,
                         "rejected": 0, "errors": 0, "timeouts": 0,
                         "streams": 0, "policy_reloads": 0}
        self._counter_lock = threading.Lock()
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):   # keep stdout clean
                pass

            def do_GET(self):
                frontend._dispatch(self, "GET")

            def do_POST(self):
                frontend._dispatch(self, "POST")

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            # socketserver's default listen backlog of 5 RSTs concurrent
            # connects the moment a fleet of clients arrives together
            request_queue_size = 128

        self.server = Server((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    @property
    def address(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "MemoryFrontend":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self.server.serve_forever,
                                            name="memori-http", daemon=True)
            self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.server.serve_forever()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    def __enter__(self) -> "MemoryFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- plumbing -----------------------------------------------------------
    def _count(self, key: str) -> None:
        with self._counter_lock:
            self.counters[key] += 1

    def _auth(self, handler) -> str:
        auth = handler.headers.get("Authorization", "")
        key = auth[7:] if auth.startswith("Bearer ") else \
            handler.headers.get("X-Api-Key", "")
        tenant = self.api_keys.get(key)
        if tenant is None:
            self._count("unauthorized")
            raise _HttpError(401, "unknown api key")
        return tenant

    def _admin_auth(self, handler) -> str:
        if not self.admin_keys:
            # no keyring mounted: the admin surface does not exist — 404,
            # not 401, so probing cannot distinguish "wrong key" from
            # "no surface"
            raise _HttpError(404, "admin surface not enabled")
        auth = handler.headers.get("Authorization", "")
        key = auth[7:] if auth.startswith("Bearer ") else \
            handler.headers.get("X-Api-Key", "")
        operator = self.admin_keys.get(key)
        if operator is None:
            self._count("unauthorized")
            raise _HttpError(401, "unknown admin key")
        return operator

    @staticmethod
    def _body(handler) -> dict:
        length = int(handler.headers.get("Content-Length") or 0)
        if length > _MAX_BODY:
            raise _HttpError(413, f"body over {_MAX_BODY} bytes")
        raw = handler.rfile.read(length) if length else b"{}"
        try:
            obj = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            raise _HttpError(400, f"invalid JSON body: {e}")
        if not isinstance(obj, dict):
            raise _HttpError(400, "body must be a JSON object")
        return obj

    @staticmethod
    def _scope(tenant: str, namespace) -> str:
        ns = str(namespace if namespace not in (None, "") else "default")
        return f"{tenant}/{ns}"

    def _send_json(self, handler, code: int, obj: dict,
                   retry_after_s: Optional[float] = None) -> None:
        rid = getattr(handler, "memori_request_id", None)
        if rid is not None:
            obj.setdefault("request_id", rid)
        blob = json.dumps(obj, default=_json_default).encode()
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(blob)))
        if rid is not None:
            handler.send_header("X-Request-Id", rid)
        if retry_after_s is not None:
            handler.send_header("Retry-After",
                                str(max(1, math.ceil(retry_after_s))))
        handler.end_headers()
        handler.wfile.write(blob)

    def _error_body(self, message: str, **extra) -> dict:
        body = {"status": "error", "error": message}
        body.update(extra)
        return body

    def _dispatch(self, handler, method: str) -> None:
        self._count("requests")
        # honor a sane client X-Request-Id, mint one otherwise; the id is
        # echoed on every response (header + envelope) and keys the trace
        rid = handler.headers.get("X-Request-Id", "")
        if not _REQ_ID_RE.match(rid):
            rid = new_request_id()
        handler.memori_request_id = rid
        try:
            path = handler.path.split("?", 1)[0]
            route = (method, path)
            if route == ("GET", "/v1/healthz"):
                # liveness, unauthenticated: answering at all is the signal
                self._send_json(handler, 200, {"status": "ok"})
                return
            if route == ("GET", "/v1/readyz"):
                self._handle_readyz(handler)
                return
            if route == ("POST", "/v1/admin/policy"):
                # admin routes authenticate against their own keyring, so
                # they match BEFORE tenant auth (a tenant key must 401
                # here, not fall through to "unknown route")
                self._handle_admin_policy(handler)
                return
            if method == "GET" and path.startswith("/v1/admin/trace/"):
                self._handle_admin_trace(
                    handler, path[len("/v1/admin/trace/"):])
                return
            tenant = self._auth(handler)
            if route == ("POST", "/v1/retrieve"):
                self._handle_retrieve(handler, tenant)
            elif route == ("POST", "/v1/record"):
                self._handle_record(handler, tenant)
            elif route == ("POST", "/v1/evict"):
                self._handle_evict(handler, tenant)
            elif route == ("GET", "/v1/stats"):
                self._handle_stats(handler, tenant)
            elif route == ("GET", "/v1/metrics"):
                self._handle_metrics(handler)
            else:
                raise _HttpError(404, f"unknown route {method} "
                                      f"{handler.path}")
        except _HttpError as e:
            body = self._error_body(str(e))
            if e.retry_after_s is not None:
                body["retry_after_s"] = e.retry_after_s
            self._send_json(handler, e.code, body,
                            retry_after_s=e.retry_after_s)
        except AdmissionError as e:
            # QoS rejection: the one error a well-behaved client must
            # treat as backoff, not failure
            self._count("rejected")
            self._send_json(handler, 429, self._error_body(
                str(e), reason=e.reason, retry_after_s=e.retry_after_s),
                retry_after_s=e.retry_after_s)
        except (ValueError, TypeError) as e:
            self._count("bad_requests")
            self._send_json(handler, 400, self._error_body(str(e)))
        except BrokenPipeError:
            pass                                  # client went away
        except Exception as e:                    # pragma: no cover
            self._count("errors")
            self._send_json(handler, 500, self._error_body(repr(e)))

    # -- submission ---------------------------------------------------------
    def _submit(self, requests: List, tenant: str, trace=None) -> List:
        """Route typed requests through the mounted scheduler (admission +
        batching) and return futures; without one, run directly and return
        pre-resolved envelopes.  `trace` (the edge Trace, may be None) gets
        an `admission` span around the submit and rides with each request
        so the executing tick records into it."""
        tel = get_telemetry()
        sched = getattr(self.service, "scheduler", None)
        if sched is not None and sched.can_submit():
            with tel.activate([trace]):
                with tel.span("admission", tenant=tenant,
                              requests=len(requests)):
                    return sched.submit_many(
                        requests, tenant=tenant,
                        traces=[trace] * len(requests))
        # schedulerless: the engine runs on this thread — activate here so
        # execute()'s plan-stage spans still land in the tree
        with tel.activate([trace]):
            return [self._direct(r) for r in requests]

    def _direct(self, req) -> "_Resolved":
        t0 = time.monotonic()
        try:
            if isinstance(req, RetrieveRequest):
                payload = self.service.execute([req])[0]
                resp = MemoryResponse(
                    payload=payload, op="retrieve",
                    service_s=time.monotonic() - t0,
                    token_count=getattr(payload, "token_count", None),
                    degraded=getattr(payload, "degraded", False))
            elif isinstance(req, RecordRequest):
                self.service.record(req.namespace, req.session_id,
                                    list(req.messages))
                durable = getattr(self.service, "runtime", None) is not None \
                    and self.service.runtime.wal is not None
                resp = MemoryResponse(
                    payload={"queued": True, "flushed": True,
                             "durable": durable},
                    op="record", service_s=time.monotonic() - t0)
            elif isinstance(req, EvictRequest):
                n = (self.service.evict_superseded(req.namespace)
                     if req.superseded_only
                     else self.service.evict(req.namespace))
                resp = MemoryResponse(payload=n, op="evict",
                                      service_s=time.monotonic() - t0)
            elif isinstance(req, CompactRequest):
                resp = MemoryResponse(payload=self.service.compact(),
                                      op="compact",
                                      service_s=time.monotonic() - t0)
            else:                                 # pragma: no cover
                raise TypeError(type(req).__name__)
        except AdmissionError:
            raise
        except BaseException as e:
            resp = MemoryResponse(payload=None, op=type(req).__name__,
                                  status="error", error=repr(e), exception=e)
        return _Resolved(resp)

    def _wait(self, fut) -> MemoryResponse:
        try:
            return fut.result(timeout=self.request_timeout_s)
        except FutureTimeoutError:
            self._count("timeouts")
            raise _HttpError(
                504, f"request timed out after {self.request_timeout_s}s "
                     "in the scheduler queue")

    def _respond_envelope(self, handler, resp: MemoryResponse,
                          extra: Optional[dict] = None) -> None:
        body = response_to_json(resp)
        if extra:
            body.update(extra)
        if resp.ok:
            self._send_json(handler, 200, body)
        elif isinstance(resp.exception, (BackpressureError, AdmissionError)):
            # capacity, not failure: same backoff contract as admission
            self._count("rejected")
            retry = getattr(resp.exception, "retry_after_s", 1.0)
            body["retry_after_s"] = retry
            self._send_json(handler, 429, body, retry_after_s=retry)
        else:
            self._count("errors")
            self._send_json(handler, 500, body)

    # -- endpoints ----------------------------------------------------------
    def _handle_retrieve(self, handler, tenant: str) -> None:
        tel = get_telemetry()
        trace = tel.start_trace(handler.memori_request_id, op="retrieve")
        try:
            with tel.activate([trace]):
                with tel.span("frontend", tenant=tenant) as sp:
                    body = self._body(handler)
                    queries = body.get("queries")
                    single = queries is None
                    if single:
                        queries = [body]
                    if not isinstance(queries, list) or not queries:
                        raise _HttpError(400,
                                         "'queries' must be a non-empty "
                                         "list")
                    default_ns = body.get("namespace")
                    reqs = [retrieve_request_from_json(
                                q, self._scope(tenant,
                                               q.get("namespace",
                                                     default_ns)))
                            for q in queries]
                    sp.set(queries=len(reqs))
            futs = self._submit(reqs, tenant, trace=trace)
            if body.get("stream"):
                self._stream_results(handler, futs)
                return
            resps = [self._wait(f) for f in futs]
            # the tick span closed before any future resolved, so the tree
            # is complete (and no longer being written) by the time it is
            # finished + serialized here
            tel.finish_trace(trace)
            debug = (trace.to_dict() if body.get("debug")
                     and trace is not None else None)
            if single:
                self._respond_envelope(
                    handler, resps[0],
                    extra={"trace": debug} if debug else None)
            else:
                ok = all(r.ok for r in resps)
                out = {"responses": [response_to_json(r) for r in resps]}
                if debug:
                    out["trace"] = debug
                self._send_json(handler, 200 if ok else 207, out)
        finally:
            # error paths (timeouts, 4xx) still land the partial trace in
            # the ring buffer; idempotent after the happy path above
            tel.finish_trace(trace)

    def _handle_record(self, handler, tenant: str) -> None:
        tel = get_telemetry()
        trace = tel.start_trace(handler.memori_request_id, op="record")
        try:
            with tel.activate([trace]):
                with tel.span("frontend", tenant=tenant):
                    body = self._body(handler)
                    req = record_request_from_json(
                        body, self._scope(tenant, body.get("namespace")))
            [fut] = self._submit([req], tenant, trace=trace)
            self._respond_envelope(handler, self._wait(fut))
        finally:
            tel.finish_trace(trace)

    def _handle_evict(self, handler, tenant: str) -> None:
        tel = get_telemetry()
        trace = tel.start_trace(handler.memori_request_id, op="evict")
        try:
            with tel.activate([trace]):
                with tel.span("frontend", tenant=tenant):
                    body = self._body(handler)
                    req = EvictRequest(
                        self._scope(tenant, body.get("namespace")),
                        superseded_only=bool(body.get("superseded_only",
                                                      False)))
            [fut] = self._submit([req], tenant, trace=trace)
            self._respond_envelope(handler, self._wait(fut))
        finally:
            tel.finish_trace(trace)

    def _handle_admin_policy(self, handler) -> None:
        """POST /v1/admin/policy — swap the scheduler's AdmissionPolicy
        without a restart.  Authenticated against the admin keyring; the
        body is the `admission_policy_from_json` shape.  Traffic in flight
        keeps its queues; the next submit/select runs under the new
        limits."""
        operator = self._admin_auth(handler)
        body = self._body(handler)
        policy = admission_policy_from_json(body)
        sched = getattr(self.service, "scheduler", None)
        if sched is None or sched.closed:
            raise _HttpError(409, "no scheduler mounted: admission policy "
                                  "reload needs one running")
        sched.set_admission_policy(policy)
        self._count("policy_reloads")
        self._send_json(handler, 200,
                        {"status": "ok", "op": "policy_reload",
                         "operator": operator,
                         "tenants": sorted(policy.tenants)})

    def _handle_readyz(self, handler) -> None:
        """Readiness (unauthenticated): 503 while the deployment is
        degraded — any placement shard marked down, or the lifecycle
        queue rejecting writes under backpressure — so a load balancer
        stops routing here before clients see degraded answers.  A store
        without a sharded placement (the port's, today) has no shard to
        be down."""
        sharded = getattr(self.service.store, "sharded", None)
        shards_down = (sorted(sharded.down)
                       if sharded is not None and sharded.down else [])
        rt = getattr(self.service, "runtime", None)
        rejecting = bool(rt is not None and rt.rejecting)
        if shards_down or rejecting:
            self._send_json(handler, 503, {
                "status": "unavailable",
                "shards_down": shards_down,
                "backpressure_reject": rejecting})
            return
        self._send_json(handler, 200, {"status": "ok"})

    def _handle_admin_trace(self, handler, request_id: str) -> None:
        """GET /v1/admin/trace/<request_id> — fetch a recent finished
        trace from the telemetry ring buffer (admin keyring)."""
        operator = self._admin_auth(handler)
        if not request_id:
            raise _HttpError(400, "missing request id")
        tr = get_telemetry().get_trace(request_id)
        if tr is None:
            raise _HttpError(404, f"no recent trace for request id "
                                  f"{request_id!r} (never issued, or "
                                  "evicted from the ring buffer)")
        self._send_json(handler, 200, {"status": "ok",
                                       "operator": operator, "trace": tr})

    def _handle_stats(self, handler, tenant: str) -> None:
        st = {"service": self.service.stats(),
              "frontend": dict(self.counters), "tenant": tenant}
        sched = getattr(self.service, "scheduler", None)
        if sched is not None:
            st["scheduler"] = sched.stats()
        self._send_json(handler, 200, st)

    def _handle_metrics(self, handler) -> None:
        """Prometheus text exposition of every numeric counter: service
        stats (bank/tier/lifecycle sections included), scheduler stats
        when one is mounted, frontend counters, and the telemetry
        registry's latency histograms + monotonic counters."""
        samples = flatten_metrics(self.service.stats(), prefix="memori")
        sched = getattr(self.service, "scheduler", None)
        if sched is not None:
            samples.extend(flatten_metrics(sched.stats(),
                                           prefix="memori_scheduler"))
        with self._counter_lock:
            counters = dict(self.counters)
        samples.extend(flatten_metrics(counters, prefix="memori_frontend"))
        blob = render_prometheus(
            samples, metrics=tuple(get_telemetry().metrics())).encode()
        handler.send_response(200)
        handler.send_header("Content-Type",
                            "text/plain; version=0.0.4; charset=utf-8")
        handler.send_header("Content-Length", str(len(blob)))
        handler.end_headers()
        handler.wfile.write(blob)

    # -- streaming ----------------------------------------------------------
    @staticmethod
    def _write_chunk(handler, obj: dict) -> None:
        data = (json.dumps(obj, default=_json_default) + "\n").encode()
        handler.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        handler.wfile.flush()

    def _stream_results(self, handler, futs: List) -> None:
        """Chunked NDJSON: `accepted`, then one `result` per request as its
        future resolves (completion order; `index` is the submitted
        position), then `done`."""
        self._count("streams")
        handler.send_response(200)
        handler.send_header("Content-Type", "application/x-ndjson")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.send_header("Cache-Control", "no-cache")
        handler.end_headers()
        self._write_chunk(handler, {"event": "accepted", "count": len(futs)})
        pending: Dict[int, object] = dict(enumerate(futs))
        deadline = time.monotonic() + self.request_timeout_s
        errors = 0
        while pending:
            # resolve-order streaming without as_completed's thread pool:
            # poll the done set, then block briefly on one future so a
            # stalled tick doesn't spin the handler
            done_now: List[Tuple[int, MemoryResponse]] = []
            for i, f in list(pending.items()):
                if f.done():
                    done_now.append((i, f.result()))
                    del pending[i]
            if not done_now:
                if time.monotonic() >= deadline:
                    for i in list(pending):
                        self._write_chunk(handler, {
                            "event": "result", "index": i,
                            "response": {"status": "error",
                                         "error": "timed out"}})
                        errors += 1
                    pending.clear()
                    break
                i, f = next(iter(pending.items()))
                try:
                    f.result(timeout=min(0.05,
                                         deadline - time.monotonic()))
                except Exception:
                    pass
                continue
            for i, resp in done_now:
                errors += 0 if resp.ok else 1
                self._write_chunk(handler, {"event": "result", "index": i,
                                            "response":
                                                response_to_json(resp)})
        self._write_chunk(handler, {"event": "done", "count": len(futs),
                                    "errors": errors})
        handler.wfile.write(b"0\r\n\r\n")
        handler.wfile.flush()


class _Resolved:
    """A future-alike for the schedulerless direct path."""

    def __init__(self, resp: MemoryResponse):
        self._resp = resp

    def result(self, timeout=None) -> MemoryResponse:
        return self._resp

    def done(self) -> bool:
        return True
