"""Telemetry — the process-wide observability spine of the memory layer.

The paper's pitch is cost-efficiency (1,294 tokens/query, 20x cheaper than
full context), but a serving stack can only *defend* numbers it can see:
where a request's latency goes once it enters the frontend, which plan
stage a slow tenant is paying for, how long an fsync stalls a group
commit.  This module is the one registry every layer reports into, built
from three primitives:

* **Metrics** — fixed-bucket latency `Histogram`s (numpy-backed bucket
  counts, exact Prometheus `_bucket`/`_sum`/`_count` semantics) and
  monotonic `Counter`s (`_total` suffix on the wire).  One tiny lock per
  metric; an `observe()` is a bisect + two in-place adds, cheap enough for
  every request on the hot path (CI gates the end-to-end overhead at
  < 5% p50 — benchmarks/telemetry_overhead_bench.py).
* **Traces** — per-request span trees.  A `Trace` is created at the edge
  (the HTTP frontend honors/emits `X-Request-Id`) and *activated* on
  whichever thread is currently doing the request's work; `span()` then
  records a timed child span into every active trace.  This is what makes
  batched execution traceable: a scheduler tick activates the traces of
  every request in the batch, so the shared `plan.dense` launch appears —
  with its batch size — in each request's own tree.  Finished traces land
  in a bounded ring buffer, retrievable by request id
  (`GET /v1/admin/trace/<id>`, or `debug: true` on a retrieve).
* **Events** — a bounded structured event log (ring buffer of dicts,
  optional JSONL file sink): slow queries over a configurable threshold,
  admission rejections, degraded-shard responses, backpressure, recovery.

Everything hangs off one process-wide registry (`get_telemetry()`);
`set_telemetry(Telemetry(enabled=False))` turns the whole layer into
no-ops (the overhead bench's baseline).  The registry never calls out
under its locks and never blocks, so it is safe to use inside the
lifecycle runtime's lock, the scheduler tick, and the WAL append path.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# canonical metric names (the acceptance set: retrieve/record/flush/fsync)
RETRIEVE_LATENCY = "memori_retrieve_latency_seconds"
RECORD_LATENCY = "memori_record_latency_seconds"
FLUSH_LATENCY = "memori_flush_latency_seconds"
FSYNC_LATENCY = "memori_fsync_latency_seconds"
GRAPH_EXPAND_LATENCY = "memori_graph_expand_latency_seconds"

# 100us .. 10s: wide enough for a CPU dev box and a production accelerator
# without reconfiguration; override per-histogram via buckets=
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonic counter with classic Prometheus exposition (`_total`)."""

    mtype = "counter"
    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help or "monotonic counter"
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def exposition(self) -> List[str]:
        n = self.name + "_total"
        return [f"# HELP {n} {self.help}",
                f"# TYPE {n} counter",
                f"{n} {_fmt(self._value)}"]


class Histogram:
    """Fixed-bucket histogram with exact Prometheus semantics: cumulative
    `_bucket{le="..."}` counts (closed upper bounds, implicit `+Inf`),
    `_sum`, `_count`.  Bucket counts live in one int64 numpy array; an
    observe is a bisect + two in-place adds under a per-metric lock, so
    concurrent recorders never lose an observation and a scrape mid-storm
    always reads a consistent (counts, sum) pair."""

    mtype = "histogram"
    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_lock")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help or "latency histogram (seconds)"
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("a histogram needs at least one bucket bound")
        self.buckets = bounds
        self._counts = np.zeros(len(bounds) + 1, np.int64)  # [+Inf] last
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float, n: int = 1) -> None:
        """Record `n` observations of `value` (n > 1 amortizes a batched
        launch whose per-request latency is the shared duration)."""
        v = float(value)
        # first bound >= v: Prometheus buckets are closed above (v <= le)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += n
            self._sum += v * n

    def snapshot(self) -> Tuple[np.ndarray, float]:
        """(per-bucket counts copy, sum) read atomically."""
        with self._lock:
            return self._counts.copy(), float(self._sum)

    @property
    def count(self) -> int:
        return int(self._counts.sum())

    def exposition(self) -> List[str]:
        counts, total = self.snapshot()
        cum = np.cumsum(counts)
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for b, c in zip(self.buckets, cum):
            lines.append(f'{self.name}_bucket{{le="{_fmt(b)}"}} {int(c)}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {int(cum[-1])}')
        lines.append(f"{self.name}_sum {_fmt(total)}")
        lines.append(f"{self.name}_count {int(cum[-1])}")
        return lines


class Span:
    """One timed operation inside a trace.  `t0` is absolute
    `time.perf_counter()`; serialization re-bases it on the trace start."""

    __slots__ = ("name", "t0", "duration_s", "attrs", "children")

    def __init__(self, name: str, t0: float,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.t0 = t0
        self.duration_s: Optional[float] = None
        self.attrs = attrs or {}
        self.children: List["Span"] = []

    def to_dict(self, base: float) -> dict:
        d: Dict[str, Any] = {"name": self.name,
                             "start_s": self.t0 - base,
                             "duration_s": self.duration_s}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict(base) for c in self.children]
        return d


class Trace:
    """A per-request span tree.  Only one thread works a trace at a time
    (the handler thread hands off to the tick thread at a span boundary),
    so the open-span stack needs no lock; serialization snapshots under
    the GIL."""

    def __init__(self, request_id: str, op: str = ""):
        self.request_id = request_id
        self.op = op
        self.started_unix = time.time()
        self.t0 = time.perf_counter()
        self.root = Span(op or "request", self.t0)
        self.duration_s: Optional[float] = None
        self.finished = False
        self._stack: List[Span] = [self.root]

    # -- span plumbing (called via Telemetry.span / add_completed) ----------
    def push(self, name: str, attrs: Optional[dict] = None) -> Span:
        sp = Span(name, time.perf_counter(), attrs)
        self._stack[-1].children.append(sp)
        self._stack.append(sp)
        return sp

    def pop(self, span: Span, duration_s: float) -> None:
        span.duration_s = duration_s
        # tolerate a child left open by an exception path: unwind to span
        while len(self._stack) > 1 and self._stack[-1] is not span:
            self._stack.pop()
        if len(self._stack) > 1 and self._stack[-1] is span:
            self._stack.pop()

    def add_completed(self, name: str, duration_s: float,
                      t0: Optional[float] = None, **attrs) -> Span:
        """Attach an already-measured span (e.g. queue wait, whose start
        predates the thread that reports it)."""
        sp = Span(name, t0 if t0 is not None
                  else time.perf_counter() - duration_s, attrs or None)
        sp.duration_s = duration_s
        self._stack[-1].children.append(sp)
        return sp

    def finish(self) -> None:
        if not self.finished:
            self.duration_s = time.perf_counter() - self.t0
            self.root.duration_s = self.duration_s
            self.finished = True

    def to_dict(self) -> dict:
        return {"request_id": self.request_id, "op": self.op,
                "started_unix": self.started_unix,
                "duration_s": self.duration_s,
                "root": self.root.to_dict(self.t0)}


class _SpanHandle:
    """What `Telemetry.span()` yields: set attributes on every span the
    context opened (one per active trace)."""

    __slots__ = ("_spans",)

    def __init__(self, spans: Tuple[Span, ...] = ()):
        self._spans = spans

    def set(self, **attrs) -> None:
        for sp in self._spans:
            sp.attrs.update(attrs)


_NULL_HANDLE = _SpanHandle()


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


def walk_spans(span_dict: dict) -> Iterator[dict]:
    """Depth-first walk of a serialized span tree (tests, tooling)."""
    yield span_dict
    for child in span_dict.get("children", ()):
        yield from walk_spans(child)


def span_names(trace_dict: dict) -> List[str]:
    return [s["name"] for s in walk_spans(trace_dict["root"])]


class Telemetry:
    """The process-wide registry: metrics + trace ring + event log.

    `enabled=False` turns every entry point into a near-free no-op — the
    overhead bench's baseline, and the escape hatch for hosts that want
    zero instrumentation cost.  `slow_query_s` is the structured-log
    threshold: any finished trace slower than it emits a `slow_query`
    event.  `event_sink` (a path or file-like) appends every event as one
    JSON line — the durable tail of the bounded in-memory ring."""

    def __init__(self, enabled: bool = True, trace_capacity: int = 512,
                 event_capacity: int = 1024,
                 slow_query_s: Optional[float] = 0.5,
                 event_sink=None):
        self.enabled = bool(enabled)
        self.slow_query_s = slow_query_s
        self._metrics: Dict[str, Any] = {}
        self._mlock = threading.Lock()
        self._traces: deque = deque(maxlen=int(trace_capacity))
        self._tlock = threading.Lock()
        self._events: deque = deque(maxlen=int(event_capacity))
        self._elock = threading.Lock()
        self._tls = threading.local()
        self._own_sink = isinstance(event_sink, str)
        self._sink = (open(event_sink, "a", encoding="utf-8")
                      if self._own_sink else event_sink)

    # -- metrics ------------------------------------------------------------
    def counter(self, name: str, help: str = "") -> Counter:
        m = self._metrics.get(name)
        if m is None:
            with self._mlock:
                m = self._metrics.setdefault(name, Counter(name, help))
        return m

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            with self._mlock:
                m = self._metrics.setdefault(name,
                                             Histogram(name, help, buckets))
        return m

    def inc(self, name: str, n: float = 1.0, help: str = "") -> None:
        if self.enabled:
            self.counter(name, help).inc(n)

    def observe(self, name: str, value: float, n: int = 1, help: str = "",
                buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        if self.enabled:
            self.histogram(name, help, buckets).observe(value, n)

    def metrics(self) -> List[Any]:
        """Registered metrics in registration order (for exposition)."""
        with self._mlock:
            return list(self._metrics.values())

    def render(self) -> str:
        """Prometheus text exposition of just the telemetry metrics."""
        lines: List[str] = []
        for m in self.metrics():
            lines.extend(m.exposition())
        return "\n".join(lines) + ("\n" if lines else "")

    # -- traces -------------------------------------------------------------
    def start_trace(self, request_id: Optional[str] = None,
                    op: str = "") -> Optional[Trace]:
        if not self.enabled:
            return None
        return Trace(request_id or new_request_id(), op=op)

    @contextlib.contextmanager
    def activate(self, traces: Sequence[Optional[Trace]]):
        """Make `traces` the current thread's active set: every `span()`
        inside the block records into each of them.  REPLACES the previous
        active set (restored on exit) — a scheduler tick activating a
        batch, then a retrieve run activating its subset, nests exactly."""
        if not self.enabled:
            yield
            return
        out: List[Trace] = []
        seen = set()
        for t in traces:
            if t is not None and not t.finished and id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        prev = getattr(self._tls, "active", None)
        self._tls.active = out
        try:
            yield
        finally:
            self._tls.active = prev

    def current_traces(self) -> List[Trace]:
        return list(getattr(self._tls, "active", None) or ())

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """A timed child span in every active trace (no-op with none
        active — the duration is measured either way only if someone is
        listening: zero perf_counter calls when disabled)."""
        if not self.enabled:
            yield _NULL_HANDLE
            return
        active = getattr(self._tls, "active", None)
        if not active:
            yield _NULL_HANDLE
            return
        opened = [(tr, tr.push(name, dict(attrs))) for tr in active]
        t0 = time.perf_counter()
        try:
            yield _SpanHandle(tuple(sp for _, sp in opened))
        finally:
            dt = time.perf_counter() - t0
            for tr, sp in opened:
                tr.pop(sp, dt)

    def finish_trace(self, trace: Optional[Trace]) -> None:
        """Close a trace and push it into the ring buffer (oldest traces
        evict first).  Emits a `slow_query` event past the threshold.
        Idempotent — a safety `finally` may call it after the happy
        path already did."""
        if trace is None or not self.enabled or trace.finished:
            return
        trace.finish()
        with self._tlock:
            self._traces.append(trace)
        if (self.slow_query_s is not None
                and trace.duration_s is not None
                and trace.duration_s >= self.slow_query_s):
            self.inc("memori_slow_queries",
                     help="requests slower than the slow-query threshold")
            self.event("slow_query", request_id=trace.request_id,
                       op=trace.op, duration_s=trace.duration_s)

    def get_trace(self, request_id: str) -> Optional[dict]:
        """Most recent finished trace with this request id (None if it
        never existed or already evicted from the ring)."""
        with self._tlock:
            for tr in reversed(self._traces):
                if tr.request_id == request_id:
                    return tr.to_dict()
        return None

    def recent_traces(self, limit: int = 32) -> List[dict]:
        with self._tlock:
            snap = list(self._traces)[-limit:]
        return [t.to_dict() for t in snap]

    # -- structured events --------------------------------------------------
    def event(self, kind: str, **fields) -> None:
        """Append one structured event to the bounded ring (FIFO eviction)
        and, when a sink is mounted, as a JSON line.  Never raises: the
        event log is diagnostics, not a failure mode."""
        if not self.enabled:
            return
        ev = {"ts": time.time(), "kind": kind}
        ev.update(fields)
        with self._elock:
            self._events.append(ev)
            if self._sink is not None:
                try:
                    self._sink.write(json.dumps(ev, default=str) + "\n")
                    self._sink.flush()
                except Exception:
                    pass

    def events(self, kind: Optional[str] = None,
               limit: Optional[int] = None) -> List[dict]:
        with self._elock:
            out = [dict(e) for e in self._events
                   if kind is None or e["kind"] == kind]
        return out[-limit:] if limit else out

    def close(self) -> None:
        if self._own_sink and self._sink is not None:
            try:
                self._sink.close()
            finally:
                self._sink = None


# -- the process-wide registry ----------------------------------------------
_GLOBAL = Telemetry()


def get_telemetry() -> Telemetry:
    return _GLOBAL


def set_telemetry(telemetry: Telemetry) -> Telemetry:
    """Swap the process-wide registry (tests, the overhead bench's
    disabled baseline).  Returns the new registry."""
    global _GLOBAL
    _GLOBAL = telemetry
    return telemetry
