"""Retrieved-context rendering: the paper's Appendix-A context block
(timestamped memories + summaries) and its answer prompt.

The single-tenant `MemoriMemory` facade of the reference package arrives
with the paper's harness; the service renders through `render` below,
which is the reference's `MemoriMemory.render`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.core.summaries import Summary
from repro_torch.core.triples import Triple


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
