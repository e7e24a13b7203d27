"""The comparison memory systems the paper benchmarks against (§3.6):

* FullContextMemory — the ceiling: injects every stored message verbatim.
* RagChunkMemory    — "traditional RAG": raw transcripts chunked (~chunk_tokens
  per chunk), embedded, and the top-k chunks retrieved without any
  structuring.

Both expose the same retrieve(query) -> RetrievedContext surface as
MemoriMemory, so the evaluation treats them interchangeably.
"""
from __future__ import annotations

import time
from typing import List, Sequence

from repro_torch.core.bm25 import BM25Index
from repro_torch.core.extraction import Message
from repro_torch.core.hybrid import hybrid_search
from repro_torch.core.memory import RetrievedContext
from repro_torch.core.vector_index import VectorIndex
from repro_torch.data.tokenizer import default_tokenizer


def _fmt(msg: Message) -> str:
    ts = (time.strftime("%Y-%m-%d", time.gmtime(msg.timestamp))
          if msg.timestamp else "?")
    return f"[{ts}] {msg.speaker}: {msg.text}"


class FullContextMemory:
    def __init__(self, tokenizer=None):
        self.tokenizer = tokenizer or default_tokenizer()
        self._messages: List[Message] = []

    def record_session(self, conversation_id: str, session_id: str,
                       messages: Sequence[Message]):
        self._messages.extend(messages)

    def retrieve(self, query: str) -> RetrievedContext:
        text = "\n".join(_fmt(m) for m in self._messages)
        return RetrievedContext([], [], text, self.tokenizer.count(text))


class RagChunkMemory:
    def __init__(self, embedder, chunk_tokens: int = 120, top_k: int = 8,
                 dim: int = 256, tokenizer=None, device="cuda"):
        self.embedder = embedder
        self.chunk_tokens = chunk_tokens
        self.top_k = top_k
        self.tokenizer = tokenizer or default_tokenizer()
        self.vindex = VectorIndex(dim=dim, device=device)
        self.bm25 = BM25Index(max_doc_len=chunk_tokens + 16, device=device)
        self._chunks: List[str] = []

    def record_session(self, conversation_id: str, session_id: str,
                       messages: Sequence[Message]):
        cur: List[str] = []
        count = 0
        chunks: List[str] = []
        for m in messages:
            line = _fmt(m)
            n = self.tokenizer.count(line)
            if cur and count + n > self.chunk_tokens:
                chunks.append("\n".join(cur))
                cur, count = [], 0
            cur.append(line)
            count += n
        if cur:
            chunks.append("\n".join(cur))
        if chunks:
            self.vindex.add(self.embedder.embed_texts(chunks))
            self.bm25.add(chunks)
            self._chunks.extend(chunks)

    def retrieve(self, query: str) -> RetrievedContext:
        qv = self.embedder.embed_texts([query])
        fused = hybrid_search(query, qv, self.vindex, self.bm25,
                              top_k=self.top_k)
        text = "\n---\n".join(self._chunks[cid] for cid, _ in fused)
        return RetrievedContext([], [], text, self.tokenizer.count(text))
