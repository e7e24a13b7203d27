"""Memori SDK — the client wrapper (paper Fig. 1): wraps any LLM callable,
intercepts chat requests, injects retrieved memory as context, and records
the exchange back into memory.  LLM-agnostic by construction: `llm_fn` is
just `prompt -> str` (`serving.engine.Engine.generate`, or anything else).

`memory` is anything with the read/write surface of `MemoryLike`
(answer_prompt / retrieve / record_session) — the production shape is a
MemoryService namespace view (`service.namespace("user/conv")`), so many
clients share one packed bank and the batched retrieval path.  When the
backing service has a MemoryScheduler mounted (`service.start_scheduler()`),
every client's single-question retrieves coalesce with its concurrent
peers into one device launch per scheduler tick — the SDK code does not
change.  `HttpMemory` is the same surface over the HTTP frontend
(serving/frontend.py), with a bounded `RetryPolicy`; it is stdlib only and
touches no device.
"""
from __future__ import annotations

import dataclasses
import http.client
import itertools
import json
import random
import time
import urllib.error
import urllib.request
from typing import Callable, Optional, Protocol, Tuple

from repro_torch.core.admission import AdmissionError
from repro_torch.core.extraction import Message
from repro_torch.core.memory import ANSWER_PROMPT, RetrievedContext
from repro_torch.core.summaries import Summary
from repro_torch.core.triples import Triple

_session_counter = itertools.count()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry for the HTTP client's transient failures.

    Retried: 429 (admission control — honoring the server's Retry-After
    hint), 5xx, and connection-level failures (reset, refused, timeout).
    Never retried: every other 4xx — the request itself is wrong, and a
    retry would just fail again (or worse, double-apply a write the
    server already rejected for a reason).  Backoff is exponential with
    full jitter (`base * 2^attempt * uniform(1-jitter, 1)`), capped at
    `max_backoff_s`; a server Retry-After hint REPLACES the computed
    backoff (capped the same way).  `max_attempts` counts tries, not
    retries: 4 means 1 try + up to 3 retries."""
    max_attempts: int = 4
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    jitter: float = 0.5
    retry_rate_limited: bool = True

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff bounds must be >= 0")
        if not 0 <= self.jitter <= 1:
            raise ValueError("jitter must be in [0, 1]")

    def backoff_s(self, attempt: int, rng: random.Random,
                  retry_after_s: Optional[float] = None) -> float:
        """Sleep before retry number `attempt` (0-based)."""
        if retry_after_s is not None:
            return min(self.max_backoff_s, max(0.0, retry_after_s))
        raw = self.base_backoff_s * (2.0 ** attempt)
        if self.jitter:
            raw *= rng.uniform(1.0 - self.jitter, 1.0)
        return min(self.max_backoff_s, raw)


class MemoryLike(Protocol):
    def answer_prompt(self, question: str) -> Tuple[str, RetrievedContext]: ...
    def retrieve(self, query: str, top_k=None) -> RetrievedContext: ...
    def record_session(self, conversation_id: str, session_id: str,
                       messages) -> object: ...


class HttpMemory:
    """MemoryLike over the HTTP frontend (serving/frontend.py): the same
    SDK client, pointed at a remote memory service instead of an in-process
    one.  `namespace` is the *client* namespace — the server scopes it
    under the tenant the api key resolves to, so two keys can use the same
    namespace string without ever seeing each other's memories.

    Transient failures are retried under a bounded `RetryPolicy`
    (exponential backoff + full jitter): QoS rejections (HTTP 429) back
    off by the server's Retry-After hint, 5xx and connection-level
    failures (reset / refused / timeout) by the computed backoff.  Once
    attempts are exhausted the last failure surfaces unchanged — 429 as
    `AdmissionError` with the server's `reason` and `retry_after_s` (the
    same exception an in-process submit raises, so caller backoff logic
    is transport-agnostic).  Stdlib urllib only; one request per call
    (the server side batches across clients, which is where the
    economics live)."""

    # connection-level failures worth retrying: the request may never have
    # reached the server (refused, reset, DNS) or died mid-flight
    _TRANSIENT = (urllib.error.URLError, ConnectionError,
                  http.client.HTTPException, TimeoutError)

    def __init__(self, base_url: str, api_key: str,
                 namespace: str = "default", timeout_s: float = 60.0,
                 retry: Optional[RetryPolicy] = None):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.namespace = namespace
        self.timeout_s = timeout_s
        self.retry = retry or RetryPolicy()
        self.counters = {"requests": 0, "retries": 0}
        # server-side timing of the most recent op (the envelope's
        # queued_s/service_s/batch_size + the request id): remote callers
        # see where the time went, not just wall clock
        self.last_timing: dict = {}
        # injectable for deterministic tests (no real sleeping, seeded
        # jitter)
        self._sleep: Callable[[float], None] = time.sleep
        self._rng = random.Random()

    # -- transport ----------------------------------------------------------
    def _post_once(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + path, data=json.dumps(body).encode(),
            headers={"Authorization": f"Bearer {self.api_key}",
                     "Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            detail = {}
            try:
                detail = json.loads(e.read().decode())
            except Exception:
                pass
            if e.code == 429:
                raise AdmissionError(
                    detail.get("error", "rejected by admission control"),
                    reason=detail.get("reason", "overloaded"),
                    retry_after_s=float(detail.get("retry_after_s", 1.0)))
            err = RuntimeError(
                f"HTTP {e.code} from {path}: "
                f"{detail.get('error', e.reason)}")
            err.http_status = e.code
            raise err from None

    def _post(self, path: str, body: dict) -> dict:
        """_post_once under the retry policy.  Retries 429 (Retry-After
        honored), 5xx, and connection failures; every other failure — and
        the last attempt's — propagates unchanged."""
        pol = self.retry
        self.counters["requests"] += 1
        for attempt in range(pol.max_attempts):
            last = attempt == pol.max_attempts - 1
            try:
                return self._post_once(path, body)
            except AdmissionError as e:
                if last or not pol.retry_rate_limited:
                    raise
                delay = pol.backoff_s(attempt, self._rng,
                                      retry_after_s=e.retry_after_s)
            except self._TRANSIENT:
                if last:
                    raise
                delay = pol.backoff_s(attempt, self._rng)
            except RuntimeError as e:
                status = getattr(e, "http_status", None)
                if last or status is None or status < 500:
                    raise
                delay = pol.backoff_s(attempt, self._rng)
            self.counters["retries"] += 1
            if delay > 0:
                self._sleep(delay)
        raise AssertionError("unreachable")      # loop always returns/raises

    @staticmethod
    def _context_from_payload(payload) -> RetrievedContext:
        if not isinstance(payload, dict) \
                or payload.get("kind") != "retrieved_context":
            raise RuntimeError(f"unexpected retrieve payload: {payload!r}")
        return RetrievedContext(
            triples=[Triple(**t) for t in payload.get("triples", [])],
            summaries=[Summary(**s) for s in payload.get("summaries", [])],
            text=payload.get("text", ""),
            token_count=int(payload.get("token_count") or 0),
            degraded=bool(payload.get("degraded", False)))

    def _note_timing(self, env: dict) -> None:
        """Keep the envelope's server-side timing split where callers can
        read it back."""
        self.last_timing = {
            "queued_s": float(env.get("queued_s") or 0.0),
            "service_s": float(env.get("service_s") or 0.0),
            "batch_size": int(env.get("batch_size") or 1),
            "request_id": env.get("request_id"),
        }

    # -- MemoryLike ---------------------------------------------------------
    def retrieve(self, query: str, top_k=None) -> RetrievedContext:
        body = {"namespace": self.namespace, "query": query}
        if top_k is not None:
            body["top_k"] = top_k
        env = self._post("/v1/retrieve", body)
        if env.get("status") != "ok":
            raise RuntimeError(env.get("error") or "retrieve failed")
        self._note_timing(env)
        return self._context_from_payload(env.get("payload"))

    def retrieve_traced(self, query: str,
                        top_k=None) -> Tuple[RetrievedContext, dict]:
        """`retrieve` with `debug: true` — returns (context, span tree):
        the server-side trace of THIS request (frontend, admission, queue
        wait, scheduler tick, every executed plan stage), inline."""
        body = {"namespace": self.namespace, "query": query, "debug": True}
        if top_k is not None:
            body["top_k"] = top_k
        env = self._post("/v1/retrieve", body)
        if env.get("status") != "ok":
            raise RuntimeError(env.get("error") or "retrieve failed")
        self._note_timing(env)
        return (self._context_from_payload(env.get("payload")),
                env.get("trace") or {})

    def answer_prompt(self, question: str) -> Tuple[str, RetrievedContext]:
        ctx = self.retrieve(question)
        return ANSWER_PROMPT.format(memories=ctx.text,
                                    question=question), ctx

    def record_session(self, conversation_id: str, session_id: str,
                       messages) -> dict:
        env = self._post("/v1/record", {
            "namespace": self.namespace,
            "session_id": session_id,
            "conversation_id": conversation_id,
            "messages": [{"speaker": m.speaker, "text": m.text,
                          "timestamp": m.timestamp} for m in messages]})
        if env.get("status") != "ok":
            raise RuntimeError(env.get("error") or "record failed")
        self._note_timing(env)
        return env.get("payload") or {}

    def stats(self) -> dict:
        req = urllib.request.Request(
            self.base_url + "/v1/stats",
            headers={"Authorization": f"Bearer {self.api_key}"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return json.loads(r.read().decode())


class MemoriClient:
    def __init__(self, llm_fn: Callable[[str], str], memory: MemoryLike,
                 user_name: str = "user", agent_name: str = "assistant"):
        self.llm = llm_fn
        self.memory = memory
        self.user_name = user_name
        self.agent_name = agent_name
        self._turn_buffer: list[Message] = []

    def chat(self, user_text: str, conversation_id: str = "default",
             timestamp: Optional[float] = None) -> str:
        ts = timestamp if timestamp is not None else time.time()
        prompt, ctx = self.memory.answer_prompt(user_text)
        reply = self.llm(prompt)
        self._turn_buffer.append(Message(self.user_name, user_text, ts))
        self._turn_buffer.append(Message(self.agent_name, reply, ts))
        return reply

    def end_session(self, conversation_id: str = "default",
                    session_id: Optional[str] = None) -> None:
        """Flush the buffered turns through Advanced Augmentation."""
        if not self._turn_buffer:
            return
        sid = session_id or f"s{next(_session_counter)}"
        self.memory.record_session(conversation_id, sid, self._turn_buffer)
        self._turn_buffer = []

    def context_tokens(self, user_text: str) -> int:
        """The Table-2 metric: tokens injected for this query."""
        return self.memory.retrieve(user_text).token_count

    def close(self) -> None:
        """Record any buffered turns, then shut the memory layer down
        cleanly if it is closable."""
        self.end_session()
        closer = getattr(self.memory, "close", None)
        if callable(closer):
            closer()

    def __enter__(self) -> "MemoriClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
