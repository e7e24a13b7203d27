"""MemoryScheduler — continuous batching for memory operations.

`serving/scheduler.py`'s ContinuousBatcher admits queued generation
requests into free engine slots between decode steps; this is the same
idea applied to the memory layer's read/write path.  Real deployments are
many independent clients (SDK wrappers, server handlers, concurrent
agents) each issuing ONE operation at a time — exactly the traffic shape
that pays a solo embed call and a solo device launch per request.  The
scheduler turns that traffic back into the batched hot path the paper's
economics assume:

* `submit(request)` is thread-safe and returns a `concurrent.futures.
  Future[MemoryResponse]`; requests queue until the next tick.
* each tick collects up to `max_batch` requests inside a bounded
  micro-batch window (`tick_interval_s` from the first arrival, closing
  early when the batch fills).  Size `max_batch` to a power of two: the
  service pads every device batch to the next pow2 Q bucket, so a
  64-request tick costs exactly what a 33-request tick costs.
* consecutive RetrieveRequests in a tick run as ONE `MemoryService.
  execute` call — one embed, one masked `topk_mips`, one stacked BM25, one
  fused RRF launch — with per-request `top_k`/weights/stages honored
  inside the shared launches.  N clients submitting single retrieves in
  the same tick answer bit-identically to N sequential `retrieve()` calls
  (asserted in tests/test_torch_scheduler.py).
* writes route through the existing LifecycleRuntime queue, so bounded-
  queue backpressure and WAL ordering are exactly what a direct caller
  gets.  With `flush_writes="tick"` (default) a tick that drained
  RecordRequests ends with ONE batched flush — one embed call, one bank
  append, one WAL record — and a durable ALL-write tick (several write
  requests, no retrieves: the multi-writer drain) group-commits its
  records into one fsync'd WAL segment (`LifecycleRuntime.group_commit`);
  every write future resolves only after that segment is on disk.  Mixed
  ticks keep per-op appends — grouping holds the runtime lock, and a
  retrieve's embed call must stay outside it.
* submission order is preserved within a tick, so a write submitted before
  a read is visible to it (read-your-writes through the runtime).

The tick's drain is no longer FIFO: an `AdmissionController`
(core/admission.py) owns per-tenant queues and the scheduler asks it to
*admit* at submit time (token-bucket rate limits, queue caps, fair-share
shedding — rejections raise `AdmissionError` with a retry-after hint) and
to *select* each tick's batch (strict priority classes, weighted
round-robin across tenants, FIFO within a tenant).  One tenant flooding
`submit()` can therefore no longer starve anyone: its backlog waits in
its own queue while every other tenant keeps its weight share of each
tick (asserted in tests/test_torch_admission.py).  Selection decides only WHO
enters an oversubscribed tick; execution inside the tick returns to
global submission order, so cross-tenant side-effect ordering (evict
before compact), read-your-writes, and consecutive-retrieve launch
sharing are all exactly what the FIFO drain gave.  The default policy
has no limits and admits everything — a limit-free deployment behaves
byte-for-byte as before.

The daemon thread is optional: `run_tick_once()` is the tick body, public
so tests and single-threaded hosts can drive the identical policy
deterministically (mirroring `LifecycleRuntime.run_maintenance_once`).

On a CUDA device two rules keep the tick's device work ordered, whichever
thread runs it (the daemon, a test's `run_tick_once`, `close()`'s drain):

* torch's current stream is per thread, so every tick runs on the stream
  that was current where the scheduler was built — the read path's, as
  the lifecycle daemon does — and a tick that wrote to the device waits
  for that stream before its futures resolve.  Only the tick thread (and
  the lifecycle daemon) touch the bank in scheduled mode: submitters only
  queue and wait.
* the engine captures its decode graph in thread-local mode
  (`serving/engine.py` `CountedGraph`), so a tick may run on its own
  stream while another thread captures, and takes no lock for it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import torch

from repro_torch.core.admission import (AdmissionController, AdmissionError,
                                        AdmissionPolicy, tenant_of)
from repro_torch.core.api import (CompactRequest, EvictRequest,
                                  MemoryRequest, MemoryResponse,
                                  RecordRequest, RetrieveRequest)
from repro_torch.obs.telemetry import RECORD_LATENCY, get_telemetry

_REQUEST_TYPES = (RetrieveRequest, RecordRequest, EvictRequest,
                  CompactRequest)
_OP_NAMES = {RetrieveRequest: "retrieve", RecordRequest: "record",
             EvictRequest: "evict", CompactRequest: "compact"}


@dataclass
class _Pending:
    req: MemoryRequest
    future: Future
    t_submit: float
    tenant: str = ""
    seq: int = 0
    # the edge's Trace (obs/telemetry.py), when the submitter wants this
    # request's tick + plan stages recorded into its span tree
    trace: Optional[object] = None


class MemoryScheduler:
    def __init__(self, service, tick_interval_s: float = 0.002,
                 max_batch: int = 64, flush_writes: str = "tick",
                 start: bool = True, mount: bool = True,
                 admission: Union[AdmissionController, AdmissionPolicy,
                                  None] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if flush_writes not in ("tick", "defer"):
            raise ValueError(f"flush_writes {flush_writes!r} must be "
                             "'tick' or 'defer'")
        self.service = service
        self.tick_interval_s = float(tick_interval_s)
        self.max_batch = int(max_batch)
        self.flush_writes = flush_writes
        if admission is None or isinstance(admission, AdmissionPolicy):
            admission = AdmissionController(admission)
        self.admission = admission
        self._seq = 0
        self._cv = threading.Condition()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._thread_ident: Optional[int] = None
        self.last_error: Optional[BaseException] = None
        # the stream the read path runs on (the building thread's): every
        # tick's device work goes there (see the module docstring)
        store = getattr(service, "store", None)
        device = getattr(store, "device", None)
        self._stream = (torch.cuda.current_stream(device)
                        if device is not None and device.type == "cuda"
                        else None)
        self.counters = {"ticks": 0, "requests": 0, "retrieves": 0,
                         "retrieve_launches": 0, "write_flushes": 0,
                         "group_commits": 0, "max_tick_batch": 0}
        if mount:
            if getattr(service, "scheduler", None) is not None \
                    and not service.scheduler.closed:
                raise ValueError("service already has a scheduler mounted")
            service.scheduler = self
        self._mounted = mount
        if start:
            self.start()

    # -- submission ---------------------------------------------------------
    def submit(self, request: MemoryRequest,
               tenant: Optional[str] = None) -> Future:
        """Queue one typed request; resolves to a MemoryResponse at the end
        of the tick that executes it.  Thread-safe.  Raises AdmissionError
        when the tenant is over its rate limit or shed under load."""
        return self.submit_many([request], tenant=tenant)[0]

    def submit_many(self, requests: Sequence[MemoryRequest],
                    tenant: Optional[str] = None,
                    traces: Optional[Sequence] = None) -> List[Future]:
        """Queue several requests as one adjacent block (they share a tick
        and, for retrieves, one device launch — plus whatever other clients
        queued around them).  `tenant` pins the whole block to one QoS
        identity (the HTTP frontend passes its api-key tenant); without it
        each request's namespace prefix is the tenant.  Admission is
        all-or-nothing: a rejected block (AdmissionError) queues nothing.
        `traces` (parallel to `requests`, entries may be None) carries each
        request's edge Trace so the tick that executes it records its queue
        wait, the tick itself, and every plan stage into that tree."""
        for r in requests:
            if not isinstance(r, _REQUEST_TYPES):
                raise TypeError(
                    f"submit() takes typed requests "
                    f"({', '.join(t.__name__ for t in _REQUEST_TYPES)}), "
                    f"got {type(r).__name__}")
        tenants = [tenant if tenant is not None else tenant_of(r)
                   for r in requests]
        tr = list(traces) if traces is not None else [None] * len(tenants)
        counts: dict = {}
        for t in tenants:
            counts[t] = counts.get(t, 0) + 1
        now = time.monotonic()
        with self._cv:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            try:
                self.admission.admit_batch(list(counts.items()))
            except AdmissionError as e:
                tel = get_telemetry()
                tel.inc("memori_admission_rejections",
                        help="request blocks rejected by admission control "
                             "(rate limit or load shed)")
                tel.event("admission_reject", tenants=sorted(counts),
                          requests=len(requests), error=str(e))
                raise
            pend = []
            for r, t, trc in zip(requests, tenants, tr):
                self._seq += 1
                pend.append(_Pending(r, Future(), now, t, seq=self._seq,
                                     trace=trc))
            for p in pend:
                self.admission.push(p.tenant, p)
            self._cv.notify_all()
        return [p.future for p in pend]

    def set_admission_policy(self, policy: AdmissionPolicy) -> None:
        """Swap the mounted admission policy without a restart (the
        frontend's authenticated reload endpoint lands here).  Queued
        requests are untouched; the next submit/select sees the new
        limits.  Thread-safe: swaps under the same lock submit holds."""
        with self._cv:
            self.admission.set_policy(policy)

    def can_submit(self) -> bool:
        """True when the sync service wrappers should route through this
        scheduler: it is accepting work, someone will run ticks, and the
        caller is not the scheduler thread itself (the tick body calls the
        service's engine directly — re-submitting would deadlock)."""
        return (not self._closed and self.running
                and threading.get_ident() != self._thread_ident)

    # -- tick body ----------------------------------------------------------
    def run_tick_once(self) -> dict:
        """Drain everything currently queued (up to max_batch) and execute
        it as one tick.  Public so tests and hosts without the daemon can
        drive the exact tick policy deterministically."""
        with self._cv:
            batch = self._drain_locked()
        return self._run_tick(batch)

    def _drain_locked(self) -> List[_Pending]:
        # admission decides WHICH requests enter an oversubscribed tick
        # (priority, WRR, fair share); within the tick, execution returns
        # to global submission order — every future in a tick resolves at
        # the same tick end, so intra-tick order buys no fairness, but it
        # does decide cross-tenant side-effect semantics (an evict
        # submitted before a compact must land before it) and keeps
        # consecutive retrieves sharing one launch exactly as before
        batch = self.admission.select(self.max_batch)
        batch.sort(key=lambda p: p.seq)
        return batch

    @staticmethod
    def _resolve(future: Future, resp: MemoryResponse) -> None:
        """Resolve a future, tolerating one already resolved (close() may
        have error-resolved a stranded request a wedged daemon later got
        around to)."""
        try:
            future.set_result(resp)
        except InvalidStateError:
            pass

    def _run_tick(self, batch: List[_Pending]) -> dict:
        if not batch:
            return {"requests": 0, "retrieve_launches": 0}
        svc = self.service
        tel = get_telemetry()
        t_tick = time.monotonic()
        # attach each request's queue wait to its trace: t_submit/t_tick are
        # monotonic, spans are perf_counter — back-compute the span start
        # from "now" so the clock bases never mix inside one tree
        batch_traces = [p.trace for p in batch if p.trace is not None]
        if batch_traces:
            now_perf = time.perf_counter()
            for p in batch:
                if p.trace is not None and not p.trace.finished:
                    queued = max(0.0, t_tick - p.t_submit)
                    p.trace.add_completed("queued", queued,
                                          t0=now_perf - queued)
        resolutions: List[tuple] = []          # (future, MemoryResponse)
        records: List[_Pending] = []
        launches = 0
        retrieves = 0

        def done(p: _Pending, resp: MemoryResponse) -> None:
            resp.queued_s = t_tick - p.t_submit
            resolutions.append((p.future, resp))

        def fail(p: _Pending, op: str, exc: BaseException) -> None:
            done(p, MemoryResponse(payload=None, op=op, status="error",
                                   error=repr(exc), exception=exc))

        # a durable ALL-write tick (the multi-writer drain: several record/
        # evict/compact requests, no retrieves) commits its WAL records as
        # ONE fsync'd segment.  Mixed ticks fall back to per-op appends:
        # group_commit holds the runtime lock for the whole block, and a
        # retrieve's embed call belongs OUTSIDE that lock (it must never
        # stall the flusher or blocked enqueuers).
        writes = sum(1 for p in batch
                     if not isinstance(p.req, RetrieveRequest))
        rt = getattr(svc, "runtime", None)
        group = (rt.group_commit() if rt is not None and rt.wal is not None
                 and writes > 1 and writes == len(batch)
                 else contextlib.nullcontext())
        grouped = not isinstance(group, contextlib.nullcontext)
        ginfo = None
        # the tick span closes (stack.close below) BEFORE any future
        # resolves, so a handler thread never serializes a trace this
        # thread is still writing.  The read path's stream comes first
        stack = contextlib.ExitStack()
        if self._stream is not None:
            stack.enter_context(torch.cuda.stream(self._stream))
        if batch_traces:
            stack.enter_context(tel.activate(batch_traces))
            stack.enter_context(tel.span("scheduler.tick",
                                         batch_size=len(batch),
                                         grouped=grouped))
        try:
            with group as ginfo:
                i = 0
                while i < len(batch):
                    p = batch[i]
                    if isinstance(p.req, RetrieveRequest):
                        run = [p]
                        while i + len(run) < len(batch) and isinstance(
                                batch[i + len(run)].req, RetrieveRequest):
                            run.append(batch[i + len(run)])
                        t0 = time.monotonic()
                        try:
                            # the run's traces (a subset of the batch)
                            # receive the plan-stage spans execute records
                            with tel.activate([q.trace for q in run]):
                                payloads = svc.execute([q.req for q in run])
                        except BaseException as e:
                            for q in run:
                                fail(q, "retrieve", e)
                        else:
                            dt = time.monotonic() - t0
                            launches += 1
                            retrieves += len(run)
                            for q, pay in zip(run, payloads):
                                done(q, MemoryResponse(
                                    payload=pay, op="retrieve",
                                    service_s=dt, batch_size=len(run),
                                    token_count=getattr(pay, "token_count",
                                                        None),
                                    degraded=getattr(pay, "degraded",
                                                     False)))
                        i += len(run)
                        continue
                    t0 = time.monotonic()
                    try:
                        # write-class ops record only into their own trace
                        # (the batch-wide set would smear one tenant's
                        # evict into every tree in the tick)
                        with tel.activate([p.trace]):
                            if isinstance(p.req, RecordRequest):
                                with tel.span("record.enqueue"):
                                    self._enqueue_record(p.req)
                                records.append(p)
                            elif isinstance(p.req, EvictRequest):
                                with tel.span("evict"):
                                    n = (svc.evict_superseded(
                                             p.req.namespace)
                                         if p.req.superseded_only
                                         else svc.evict(p.req.namespace))
                                done(p, MemoryResponse(
                                    payload=n, op="evict",
                                    service_s=time.monotonic() - t0))
                            elif isinstance(p.req, CompactRequest):
                                with tel.span("compact"):
                                    payload = svc.compact()
                                done(p, MemoryResponse(
                                    payload=payload, op="compact",
                                    service_s=time.monotonic() - t0))
                    except BaseException as e:
                        fail(p, type(p.req).__name__, e)
                    i += 1
                if records:
                    self._finish_records(records, done, fail)
            if self._stream is not None and writes:
                # a reader on another stream must see this tick's bank
                # writes once its future resolves
                self._stream.synchronize()
        except BaseException as e:
            # the group commit itself failed: every write-class future in
            # this tick resolves to an error — nothing is acknowledged as
            # durable that is not on disk (retrieve responses stand; reads
            # promise no durability)
            self.last_error = e
            resolutions = [(f, r) for f, r in resolutions
                           if r.op == "retrieve"]
            resolved = {id(f) for f, _ in resolutions}
            for p in batch:
                if id(p.future) not in resolved:
                    fail(p, "group", e)
        finally:
            stack.close()
        # futures resolve only after the (possibly grouped) WAL writes are
        # durable — a client never observes an ack for a lost write
        for fut, resp in resolutions:
            self._resolve(fut, resp)
        # counters mutate under the condition lock: stats() snapshots under
        # the same lock, so /v1/stats never reports a torn view of a tick
        with self._cv:
            c = self.counters
            if grouped and ginfo is not None and ginfo["appended"]:
                # count group segments actually written (not grouping
                # attempts: a failed append or a fail-stopped sink writes
                # nothing)
                c["group_commits"] += 1
            c["ticks"] += 1
            c["requests"] += len(batch)
            c["retrieves"] += retrieves
            c["retrieve_launches"] += launches
            c["max_tick_batch"] = max(c["max_tick_batch"], len(batch))
        return {"requests": len(batch), "retrieve_launches": launches}

    def _enqueue_record(self, req: RecordRequest) -> None:
        """Writes go through the existing runtime queue: same bounded-queue
        backpressure, same WAL ordering as a direct caller.  `"reject"`
        backpressure raises exactly as it would for a direct caller (the
        future carries the BackpressureError).  In `"block"` mode a full
        queue is drained here rather than waited on — the tick thread is
        itself the consumer, and a Condition.wait under the reentrant
        group lock could not release it."""
        svc = self.service
        rt = getattr(svc, "runtime", None)
        if rt is not None and rt.policy.max_pending is not None \
                and rt.policy.backpressure == "block":
            # drain-and-enqueue under ONE hold of the runtime lock: a
            # direct writer cannot refill the queue between the flush and
            # the enqueue, so the enqueue below can never reach the
            # Condition.wait
            with rt.lock:
                if svc.store.pending_count >= rt.policy.max_pending:
                    svc.store.flush()
                svc.enqueue(req.namespace, req.session_id,
                            list(req.messages),
                            conversation_id=req.conversation_id)
            return
        svc.enqueue(req.namespace, req.session_id, list(req.messages),
                    conversation_id=req.conversation_id)

    def _finish_records(self, records, done, fail) -> None:
        durable = getattr(self.service, "runtime", None) is not None and \
            self.service.runtime.wal is not None
        if self.flush_writes == "defer":
            for p in records:
                done(p, MemoryResponse(
                    payload={"queued": True, "durable": False},
                    op="record"))
            return
        tel = get_telemetry()
        t0 = time.monotonic()
        try:
            # one batched flush for every session this tick accepted (plus
            # anything else pending): one embed call, one bank append, one
            # WAL record.  Through the store under the runtime guard so the
            # commit hook still stamps flush times / wakes blocked
            # enqueuers.
            with tel.activate([p.trace for p in records]):
                with self.service._guard():
                    self.service.store.flush()
        except BaseException as e:
            for p in records:
                fail(p, "record", e)
            return
        with self._cv:
            self.counters["write_flushes"] += 1
        dt = time.monotonic() - t0
        tel.observe(RECORD_LATENCY, dt, n=len(records),
                    help="synchronous record (enqueue + flush) latency")
        for p in records:
            done(p, MemoryResponse(
                payload={"queued": True, "flushed": True,
                         "durable": durable},
                op="record", service_s=dt, batch_size=len(records)))

    # -- daemon -------------------------------------------------------------
    def _loop(self) -> None:
        self._thread_ident = threading.get_ident()
        while True:
            with self._cv:
                while not self.admission.total_queued and not self._closed:
                    self._cv.wait()
                if self._closed and not self.admission.total_queued:
                    return
                # bounded micro-batch window: wait out the tick interval
                # from the first arrival (letting concurrent clients join
                # this tick), closing early once the batch is full
                deadline = time.monotonic() + self.tick_interval_s
                while (self.admission.total_queued < self.max_batch
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch = self._drain_locked()
            try:
                self._run_tick(batch)
            except BaseException as e:       # pragma: no cover - last resort
                self.last_error = e
                for p in batch:
                    if not p.future.done():
                        self._resolve(p.future, MemoryResponse(
                            payload=None, op="tick", status="error",
                            error=repr(e), exception=e))

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="memori-scheduler", daemon=True)
        self._thread.start()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting work, drain everything still queued (no future is
        left hanging), unmount from the service.  Idempotent.

        If the daemon is wedged mid-tick past the join `timeout` (a stuck
        embedder, a dead device), the queued requests whose tick will never
        run are NOT left hanging their callers forever: each resolves to an
        error envelope (`status="error"`, timeout).  Only the requests the
        wedged tick already drained stay with it — if it ever finishes,
        their futures resolve normally (and its late set_result on anything
        we error-resolved is ignored)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=timeout)
        # drain only once the daemon has actually stopped: running ticks
        # from two threads at once would race the store.
        if self._thread is None or not self._thread.is_alive() \
                or self._thread is threading.current_thread():
            while True:
                with self._cv:
                    batch = self._drain_locked()
                if not batch:
                    break
                self._run_tick(batch)
        else:
            # wedged daemon: running its queue from this thread would race
            # the store, and leaving it queued would strand every caller
            # blocked on .result() — resolve to error envelopes instead
            with self._cv:
                stranded = self.admission.drain_all()
            for p in stranded:
                self._resolve(p.future, MemoryResponse(
                    payload=None, op=_OP_NAMES[type(p.req)], status="error",
                    error=f"scheduler close() timed out after {timeout}s "
                          "with the tick daemon wedged; this queued "
                          "request's tick never ran"))
        if self._mounted and getattr(self.service, "scheduler", None) is self:
            self.service.scheduler = None

    def __enter__(self) -> "MemoryScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        # counters snapshot under the same lock their writers hold, so a
        # concurrent tick can never be observed half-applied
        with self._cv:
            st = dict(self.counters,
                      queue_depth=self.admission.total_queued,
                      admission=self.admission.stats())
        st["running"] = self.running
        if st["retrieve_launches"]:
            st["avg_retrieves_per_launch"] = (st["retrieves"]
                                              / st["retrieve_launches"])
        return st
