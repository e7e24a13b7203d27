"""Plain reference of the memory layer's read path for one tenant: the exact
dense ranking, the namespace-scoped BM25 ranking, weighted reciprocal-rank
fusion, the token budget and the rendered context.

Everything is worked out again from the generated conversations (through
`extraction.RuleExtractor` and `text.Embedder`), in NumPy: dense scores in
float64 from the f32 vectors, BM25 in float64 (k1 1.5, b 0.75, documents
cut to 32 tokens, df / N / average length over the tenant's own rows), RRF
accumulated in float32 as the program promises, ties ranked by the lower
row.  Frozen copies of the arithmetic of `repro_torch/core/{bm25,hybrid,
budget,memory}.py`; nothing imports the program.

`lower_precision` gives the check's control: the dense scores with both
operands rounded to TF32 (10-bit mantissa), the BM25 arithmetic in
bfloat16.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from h100bench.reference import text
from h100bench.reference.extraction import RuleExtractor, Summary, Triple

K1, B = 1.5, 0.75
MAX_DOC_LEN = 32
RRF_C = 60.0

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


@dataclasses.dataclass
class Tenant:
    """One namespace's rows, in the order the store appended them."""
    triples: List[Triple]
    summaries: Dict[Tuple[str, str], Summary]
    vecs: np.ndarray                 # (n, D) f32
    docs: List[List[int]]            # BM25 token ids, cut to MAX_DOC_LEN
    questions: List[str]

    @property
    def n(self) -> int:
        return len(self.triples)


def extract_sessions(conversation_id: str, sessions) -> List[tuple]:
    """[(triples, summary)] of each (session id, messages)."""
    ex = RuleExtractor()
    return [ex.extract(conversation_id, sid, msgs) for sid, msgs in sessions]


def make_tenant(extracted, embedder: text.Embedder,
                questions: Sequence[str]) -> Tenant:
    triples = [t for trs, _ in extracted for t in trs]
    summaries = {(s.conversation_id, s.session_id): s for _, s in extracted}
    return Tenant(triples=triples, summaries=summaries,
                  vecs=embedder.embed([t.text() for t in triples]),
                  docs=[text.encode(t.text())[:MAX_DOC_LEN] for t in triples],
                  questions=list(questions))


def _tf32(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to TF32's 10-bit mantissa (to nearest)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return b.view(np.float32)


def _bf16(x) -> np.ndarray:
    """Values rounded to bfloat16 (to nearest even), kept as f32."""
    b = np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)
    b = b.astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return b.view(np.float32)


def dense_scores(tenant: Tenant, qvec: np.ndarray,
                 lower_precision: bool = False) -> np.ndarray:
    if lower_precision:
        return (_tf32(tenant.vecs) @ _tf32(qvec)).astype(np.float64)
    return tenant.vecs.astype(np.float64) @ qvec.astype(np.float64)


def bm25_scores(tenant: Tenant, query: str,
                lower_precision: bool = False) -> np.ndarray:
    """BM25 of every row of the tenant against the query's distinct terms."""
    terms = list(dict.fromkeys(text.encode(query)))
    n = tenant.n
    if not terms or not n:
        return np.zeros((n,), np.float64)
    dt = np.float32 if lower_precision else np.float64
    rnd = _bf16 if lower_precision else (lambda a: a)
    lens = np.asarray([max(1, len(d)) for d in tenant.docs], dt)
    tf = np.asarray([[d.count(t) for t in terms] for d in tenant.docs], dt)
    df = (tf > 0).sum(axis=0).astype(dt)
    idf = np.where(df > 0, np.log(1.0 + (n - df + 0.5) / (df + 0.5)), 0.0)
    norm = rnd(K1 * (1.0 - B + B * lens / lens.mean()))
    idf = rnd(idf)
    out = np.zeros((n,), dt)
    for j in range(len(terms)):
        out = rnd(out + rnd(rnd(idf[j] * tf[:, j] * (K1 + 1.0))
                            / rnd(tf[:, j] + norm)))
    return out.astype(np.float64)


def ranking(scores: np.ndarray, k: int) -> List[int]:
    """Rows by (score desc, row asc), the first k."""
    order = sorted(range(len(scores)), key=lambda i: (-scores[i], i))
    return order[:k]


def rrf_fuse(rankings: Sequence[Sequence[int]], weights: Sequence[float],
             c: float = RRF_C) -> List[Tuple[int, float]]:
    """Weighted RRF; a row's first rank in each ranking counts; float32
    accumulation; (score desc, row asc)."""
    scores: Dict[int, np.float32] = {}
    for rank_list, w in zip(rankings, weights):
        w32 = np.float32(w)
        seen = set()
        for rank, doc in enumerate(rank_list):
            doc = int(doc)
            if doc < 0 or doc in seen:
                continue
            seen.add(doc)
            scores[doc] = np.float32(scores.get(doc, np.float32(0.0))
                                     + w32 / np.float32(c + rank + 1.0))
    return sorted(((d, float(s)) for d, s in scores.items()),
                  key=lambda kv: (-kv[1], kv[0]))


def budget_select(tenant: Tenant, fused: Sequence[Tuple[int, float]],
                  budget: int):
    """Greedy by fused score: each triple with its session summary (once);
    whatever would pass the budget is skipped."""
    used, triples, summaries, seen = 0, [], [], set()
    for row, _ in fused:
        t = tenant.triples[row]
        cost = text.count(t.render())
        key = (t.conversation_id, t.session_id)
        extra = None
        if key not in seen:
            extra = tenant.summaries.get(key)
            if extra is not None:
                cost += text.count(extra.render())
        if used + cost > budget:
            continue
        used += cost
        triples.append(t)
        if extra is not None:
            seen.add(key)
            summaries.append(extra)
    return triples, summaries


def render(triples, summaries) -> str:
    lines = ["# MEMORIES:"] + [t.render() for t in triples]
    lines += ["", "# SUMMARIES:"] + [s.render() for s in summaries]
    return "\n".join(lines)


def context(tenant: Tenant, rankings: Sequence[Sequence[int]],
            weights: Sequence[float], top_k: int, budget: int) -> str:
    """The rendered context of fusing `rankings` (tenant rows)."""
    fused = rrf_fuse(rankings, weights)[:top_k]
    return render(*budget_select(tenant, fused, budget))


def prompt(context_text: str, question: str) -> str:
    return ANSWER_PROMPT.format(memories=context_text, question=question)


def ranking_error(ref_scores: np.ndarray, got: Sequence[int],
                  got_scores: Sequence[float], k: int,
                  scale: float) -> Optional[float]:
    """How far a ranking `got` (tenant rows, best first, with the scores it
    gives them) departs from the exact one, over `scale`: the larger of the
    ranking's gap (the largest ref_sorted[j] - ref[got[j]]) and its scores'
    error (the largest |got_scores[j] - ref[got[j]]|).  None where `got` is
    not a ranking of the tenant's rows of the right length, or is not in
    the order of its own scores, rows of equal score by the lower row
    first (the program's tie order; rows the float64 reference ties may
    differ in the program's float32 last bit, and rank by it)."""
    n = len(ref_scores)
    want = min(k, n)
    if len(got) != want or len(set(got)) != want:
        return None
    if any(g < 0 or g >= n for g in got):
        return None
    for (a, sa), (b, sb) in zip(zip(got, got_scores),
                                zip(got[1:], got_scores[1:])):
        if sb > sa or (sb == sa and b < a):
            return None
    mine = ref_scores[np.asarray(got)]
    best = np.sort(ref_scores)[::-1][:want]
    gap = float(np.max(best - mine))
    err = float(np.max(np.abs(np.asarray(got_scores, np.float64) - mine)))
    return max(gap, err, 0.0) / scale
