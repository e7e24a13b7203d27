"""MemoriMemory — the persistent single-tenant memory facade.

record_session() feeds Advanced Augmentation; retrieve() runs hybrid search
(cosine + BM25, RRF-fused), pulls linked summaries, and assembles the
context block under the token budget, rendered in the paper's Appendix-A
format (timestamped memories + summaries) by `render`, which the
multi-tenant service renders through too.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core.augmentation import AdvancedAugmentation
from repro_torch.core.budget import TokenBudgeter
from repro_torch.core.extraction import Extractor, Message
from repro_torch.core.hybrid import hybrid_search
from repro_torch.core.summaries import Summary
from repro_torch.core.triples import Triple
from repro_torch.data.tokenizer import HashTokenizer, default_tokenizer


@dataclasses.dataclass
class RetrievedContext:
    triples: List[Triple]
    summaries: List[Summary]
    text: str
    token_count: int
    # True when the owning shard was down at retrieval time
    degraded: bool = False


ANSWER_PROMPT = """You are an intelligent memory assistant tasked with retrieving
accurate information from conversation memories.

# CONTEXT:
You have access to two types of information from a conversation:
- Memories: timestamped factual triples extracted from conversations.
- Summaries: high-level conversation summaries (also timestamped) that provide
  broader context around the memories.

# INSTRUCTIONS:
1. Carefully analyze all provided memories and summaries
2. Pay special attention to the timestamps to determine the answer
3. If the memories contain contradictory information, prioritize the most recent memory
4. Always convert relative time references to specific dates, months, or years.
5. The answer should be less than 5-6 words.

{memories}

Question: {question}
Answer:"""


def render(triples: Sequence[Triple], summaries: Sequence[Summary]) -> str:
    lines = ["# MEMORIES:"]
    lines += [t.render() for t in triples]
    lines.append("")
    lines.append("# SUMMARIES:")
    lines += [s.render() for s in summaries]
    return "\n".join(lines)


class MemoriMemory:
    def __init__(self, embedder, extractor: Optional[Extractor] = None,
                 dim: int = 256, budget: int = 1300, top_k: int = 10,
                 tokenizer: HashTokenizer | None = None,
                 dense_weight: float = 1.0, sparse_weight: float = 0.7,
                 device="cuda"):
        self.embedder = embedder
        self.pipeline = AdvancedAugmentation(embedder, extractor, dim=dim,
                                             device=device)
        self.tokenizer = tokenizer or default_tokenizer()
        self.budgeter = TokenBudgeter(budget=budget, tokenizer=self.tokenizer)
        self.top_k = top_k
        self.dense_weight = dense_weight
        self.sparse_weight = sparse_weight

    render = staticmethod(render)

    # -- write path --------------------------------------------------------
    def record_session(self, conversation_id: str, session_id: str,
                       messages: Sequence[Message]):
        return self.pipeline.ingest(conversation_id, session_id, messages)

    # -- read path -----------------------------------------------------------
    def retrieve(self, query: str,
                 top_k: Optional[int] = None) -> RetrievedContext:
        qv = self.embedder.embed_texts([query])
        fused = hybrid_search(query, qv, self.pipeline.vindex,
                              self.pipeline.bm25, top_k=top_k or self.top_k,
                              dense_weight=self.dense_weight,
                              sparse_weight=self.sparse_weight)
        scored = [(self.pipeline.triples.get(tid), score)
                  for tid, score in fused]
        ctx = self.budgeter.select(scored, self.pipeline.summaries)
        text = render(ctx.triples, ctx.summaries)
        return RetrievedContext(ctx.triples, ctx.summaries, text,
                                self.tokenizer.count(text))

    def answer_prompt(self, question: str) -> tuple[str, RetrievedContext]:
        ctx = self.retrieve(question)
        return ANSWER_PROMPT.format(memories=ctx.text, question=question), ctx

    def resolve(self, query: str) -> Optional[Triple]:
        """Conflict-resolving point lookup (paper Appendix A, instruction
        4): retrieve, then return the most recent version of the
        best-ranked triple's (subject, predicate) key."""
        ctx = self.retrieve(query)
        if not ctx.triples:
            return None
        best = ctx.triples[0]
        return self.pipeline.triples.latest_for_key(best.key()) or best

    def stats(self) -> dict:
        return self.pipeline.stats()
