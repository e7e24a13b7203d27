"""Token budgeter: assembles the retrieved context under a hard token budget
(the paper's operating point: ~1,294 tokens/query ≈ 5% of full context).

Greedy by fused retrieval score; each triple pulls in its linked session
summary once (triples are never divorced from their context, paper §2.1);
anything that would overflow the budget is skipped.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from repro_torch.core.summaries import Summary, SummaryStore
from repro_torch.core.triples import Triple
from repro_torch.data.tokenizer import HashTokenizer, default_tokenizer


@dataclasses.dataclass
class BudgetedContext:
    triples: List[Triple]
    summaries: List[Summary]
    token_count: int


class TokenBudgeter:
    def __init__(self, budget: int = 1300,
                 tokenizer: HashTokenizer | None = None,
                 include_summaries: bool = True):
        self.budget = budget
        self.tokenizer = tokenizer or default_tokenizer()
        self.include_summaries = include_summaries

    def select(self, scored_triples: Sequence[Tuple[Triple, float]],
               summaries: SummaryStore) -> BudgetedContext:
        used = 0
        out_triples: List[Triple] = []
        out_summaries: List[Summary] = []
        seen_sessions = set()
        for triple, _score in scored_triples:
            cost = self.tokenizer.count(triple.render())
            extra = None
            skey = (triple.conversation_id, triple.session_id)
            if self.include_summaries and skey not in seen_sessions:
                extra = summaries.get(*skey)
                if extra is not None:
                    cost += self.tokenizer.count(extra.render())
            if used + cost > self.budget:
                continue
            used += cost
            out_triples.append(triple)
            if extra is not None:
                seen_sessions.add(skey)
                out_summaries.append(extra)
        return BudgetedContext(out_triples, out_summaries, used)
