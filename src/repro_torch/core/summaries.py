"""Conversation summaries — the narrative layer of the dual memory asset."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Summary:
    conversation_id: str
    session_id: str
    timestamp: float
    text: str

    def render(self) -> str:
        ts = time.strftime("%Y-%m-%d", time.gmtime(self.timestamp)) if self.timestamp else "?"
        return f"[{ts}] (session {self.session_id}) {self.text}"


class SummaryStore:
    def __init__(self):
        self._by_session: Dict[str, Summary] = {}

    @staticmethod
    def skey(conversation_id: str, session_id: str) -> str:
        return f"{conversation_id}/{session_id}"

    def add(self, summary: Summary) -> str:
        key = self.skey(summary.conversation_id, summary.session_id)
        self._by_session[key] = summary
        return key

    def get(self, conversation_id: str, session_id: str) -> Optional[Summary]:
        return self._by_session.get(self.skey(conversation_id, session_id))

    def all(self) -> List[Summary]:
        return list(self._by_session.values())

    def __len__(self):
        return len(self._by_session)
