"""Semantic triples — the atomic memory unit of Advanced Augmentation.

Each triple is (subject, predicate, object) plus provenance: the conversation
and session it came from, its timestamp, and the id of the session summary it
links to — "granular facts are never divorced from their broader context"
(paper §2.1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


def normalize_entity(s: str) -> str:
    """Canonical form of an entity mention: casefold + whitespace collapse.
    `Triple.key()` and the memory graph's node interning (core/graph.py)
    share this function, so "Caroline", "caroline" and "  Caroline " are ONE
    version chain and ONE graph node instead of silently splitting."""
    return " ".join(s.split()).lower()


@dataclasses.dataclass(frozen=True)
class Triple:
    subject: str
    predicate: str
    object: str
    conversation_id: str = ""
    session_id: str = ""
    timestamp: float = 0.0
    source_text: str = ""
    confidence: float = 1.0

    def text(self) -> str:
        return f"{self.subject} {self.predicate} {self.object}"

    def render(self) -> str:
        """Prompt rendering (paper Appendix A: timestamped factual triples)."""
        ts = time.strftime("%Y-%m-%d", time.gmtime(self.timestamp)) if self.timestamp else "?"
        return f"[{ts}] ({self.subject}; {self.predicate}; {self.object})"

    def key(self) -> str:
        return f"{normalize_entity(self.subject)}|" \
               f"{normalize_entity(self.predicate)}"


class TripleStore:
    """Append-only store with contradiction bookkeeping: triples sharing
    (subject, predicate) are versions of one evolving attribute; retrieval
    surfaces all of them and the answering policy prefers the most recent
    (paper Appendix A instruction 4)."""

    def __init__(self):
        self._triples: List[Triple] = []
        self._by_key: Dict[str, List[int]] = {}

    def add(self, triple: Triple) -> int:
        tid = len(self._triples)
        self._triples.append(triple)
        self._by_key.setdefault(triple.key(), []).append(tid)
        return tid

    def get(self, tid: int) -> Triple:
        return self._triples[tid]

    def latest_for_key(self, key: str) -> Optional[Triple]:
        ids = self._by_key.get(key)
        if not ids:
            return None
        return max((self._triples[i] for i in ids), key=lambda t: t.timestamp)

    def versions(self, tid: int) -> List[Triple]:
        return [self._triples[i] for i in self._by_key[self._triples[tid].key()]]

    def superseded_ids(self) -> List[int]:
        """Ids of every triple that is NOT the latest version of its
        (subject, predicate) key — the rows a service may physically evict
        from its indices once conflict resolution has settled on the newest
        value.  Tie-breaking matches latest_for_key (first max by timestamp)."""
        out: List[int] = []
        for ids in self._by_key.values():
            if len(ids) < 2:
                continue
            latest = max(ids, key=lambda i: self._triples[i].timestamp)
            out.extend(i for i in ids if i != latest)
        return out

    def __len__(self) -> int:
        return len(self._triples)

    def __iter__(self):
        return iter(self._triples)

    def all(self) -> List[Triple]:
        return list(self._triples)
