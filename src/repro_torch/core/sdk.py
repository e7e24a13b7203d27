"""Memori SDK — the client wrapper (paper Fig. 1): wraps any LLM callable,
intercepts chat requests, injects retrieved memory as context, and records
the exchange back into memory.  LLM-agnostic by construction: `llm_fn` is
just `prompt -> str` (`serving.engine.Engine.generate`, or anything else).

`memory` is anything with the read/write surface of `MemoryLike`
(answer_prompt / retrieve / record_session) — the production shape is a
MemoryService namespace view (`service.namespace("user/conv")`), so many
clients share one packed bank and the batched retrieval path.  The HTTP
client (`HttpMemory`, with its retry policy) comes with the serving slice
of the port.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Optional, Protocol, Tuple

from repro_torch.core.extraction import Message
from repro_torch.core.memory import RetrievedContext

_session_counter = itertools.count()


class MemoryLike(Protocol):
    def answer_prompt(self, question: str) -> Tuple[str, RetrievedContext]: ...
    def retrieve(self, query: str, top_k=None) -> RetrievedContext: ...
    def record_session(self, conversation_id: str, session_id: str,
                       messages) -> object: ...


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
