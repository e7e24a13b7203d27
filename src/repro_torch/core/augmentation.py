"""Advanced Augmentation — the paper's memory-creation pipeline (§2.1).

Distills raw dialogue sessions into the dual-layer memory asset: semantic
triples (precise, token-efficient facts, embedded + BM25-indexed) and
conversation summaries (narrative context), with triples linked to the
summary of the session they came from.

Designed as a background pipeline: `enqueue` is cheap; `process_pending`
runs extraction, embedding and indexing in one batch.

It is a thin single-tenant wrapper over `core/store.py`'s MemoryStore — the
write path MemoryService batches across tenants.  All sessions (any number
of conversations) land in one internal namespace, which keeps the
alignment triple id == bank row == BM25 doc id that `MemoriMemory`'s
hybrid search relies on.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.core.extraction import Extractor, Message
from repro_torch.core.store import MemoryStore
from repro_torch.core.summaries import Summary
from repro_torch.core.triples import Triple


class AdvancedAugmentation:
    _NS = "__single__"

    def __init__(self, embedder, extractor: Optional[Extractor] = None,
                 dim: int = 256, device="cuda"):
        self.store = MemoryStore(embedder, extractor, dim=dim, device=device)
        self.embedder = embedder
        self.extractor = self.store.extractor

    # the single tenant's stores, under the historical names
    @property
    def triples(self):
        return self.store.tenant(self._NS).triples

    @property
    def summaries(self):
        return self.store.tenant(self._NS).summaries

    @property
    def vindex(self):
        return self.store.vindex

    @property
    def bm25(self):
        return self.store.bm25

    # -- background pipeline surface ------------------------------------
    def enqueue(self, conversation_id: str, session_id: str,
                messages: Sequence[Message]) -> None:
        self.store.enqueue(self._NS, session_id, messages,
                           conversation_id=conversation_id)

    def process_pending(self) -> int:
        """Batched drain: one embed_texts call + one bank append for every
        pending session (see MemoryStore.flush)."""
        return len(self.store.flush())

    def ingest(self, conversation_id: str, session_id: str,
               messages: Sequence[Message]) -> Tuple[List[Triple], Summary]:
        """Synchronous enqueue + process of one session."""
        return self.store.ingest(self._NS, session_id, messages,
                                 conversation_id=conversation_id)

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "triples": len(self.triples),
            "summaries": len(self.summaries),
            "bank_rows": self.vindex.n,
            "pending": self.store.pending_count,
        }
