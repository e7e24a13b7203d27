"""The paper's LoCoMo evaluation on the port: builds the memory systems,
runs the synthetic LoCoMo conversations through them, and aggregates
per-category accuracy and tokens per query into the paper's tables.

    python -m repro_torch.eval.locomo [--device cuda|cpu]

prints Table 1 (accuracy by category: Memori, its triples-only ablation,
raw-chunk RAG and the full-context ceiling), Table 2 (tokens and cost per
query, context footprint), Table 3 (the question-category distribution)
and Figure 2 (Memori's mean ± std over three disjoint seed groups).  The
judge is `locomo_synth.oracle_read`, a function of the context text: the
figures are exact given the texts, whatever the device.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import statistics
import sys
from typing import Dict, List, Sequence

from repro_torch.core.baselines import FullContextMemory, RagChunkMemory
from repro_torch.core.embedder import HashEmbedder
from repro_torch.core.memory import MemoriMemory
from repro_torch.data.locomo_synth import (CATEGORIES, LOCOMO_WEIGHTS, NAMES,
                                           generate_conversation, judge,
                                           oracle_read)

SYSTEMS = ("memori", "memori-triples-only", "memori-dense-only",
           "memori-bm25-only", "rag", "full-context")
TABLE1_SYSTEMS = ("memori", "memori-triples-only", "rag", "full-context")
TABLE2_SYSTEMS = ("memori", "rag", "full-context")
FIGURE2_SEEDS = ((0, 1), (3, 4), (6, 7))
PRICE_PER_TOKEN = 0.8 / 1e6          # gpt-4.1-mini, as in the paper


@dataclasses.dataclass(frozen=True)
class Answered:
    """One question's context and verdict."""
    question: str
    text: str
    token_count: int
    correct: bool


@dataclasses.dataclass
class EvalResult:
    name: str
    per_category: Dict[str, float]
    overall: float                 # LoCoMo-weighted (paper Table 1 footnote)
    unweighted: float
    mean_tokens: float
    n_questions: int
    answered: List[Answered]       # in question order


def build_system(name: str, device="cuda", budget: int = 1300):
    if name not in SYSTEMS:
        raise KeyError(name)
    if name == "full-context":
        return FullContextMemory()
    emb = HashEmbedder(device=device)
    if name == "rag":
        return RagChunkMemory(emb, device=device)
    weights = {"memori-dense-only": dict(sparse_weight=0.0),
               "memori-bm25-only": dict(dense_weight=0.0)}.get(name, {})
    mem = MemoriMemory(emb, budget=budget, device=device, **weights)
    if name == "memori-triples-only":
        mem.budgeter.include_summaries = False
    return mem


def evaluate(system_name: str, *, seeds=(0, 1), n_sessions: int = 10,
             noise_turns: int = 120, budget: int = 1300,
             conversations_per_store: int = 5, device="cuda") -> EvalResult:
    """One persistent store per seed holds `conversations_per_store`
    conversations with disjoint speaker pairs (cross-conversation memory:
    most of the bank is distractors for any one question)."""
    cat_hits = collections.Counter()
    cat_total = collections.Counter()
    answered: List[Answered] = []
    for seed in seeds:
        mem = build_system(system_name, device=device, budget=budget)
        convs = []
        for c in range(conversations_per_store):
            pair = (NAMES[(2 * c) % len(NAMES)],
                    NAMES[(2 * c + 1) % len(NAMES)])
            conv = generate_conversation(
                seed=1000 * seed + c, n_sessions=n_sessions,
                noise_turns=noise_turns, name_pair=pair)
            convs.append(conv)
            for sid, msgs in conv.sessions:
                mem.record_session(conv.conversation_id, sid, msgs)
        for conv in convs:
            for q in conv.questions:
                ctx = mem.retrieve(q.question)
                ok = judge(q, oracle_read(q, ctx.text, salt=system_name))
                answered.append(Answered(q.question, ctx.text,
                                         ctx.token_count, ok))
                cat_hits[q.category] += ok
                cat_total[q.category] += 1
    per_cat = {c: cat_hits[c] / max(1, cat_total[c]) for c in CATEGORIES}
    wsum = sum(LOCOMO_WEIGHTS.values())
    overall = sum(per_cat[c] * LOCOMO_WEIGHTS[c] for c in CATEGORIES) / wsum
    unweighted = sum(cat_hits.values()) / max(1, sum(cat_total.values()))
    return EvalResult(system_name, per_cat, overall, unweighted,
                      sum(a.token_count for a in answered) / len(answered),
                      len(answered), answered)


# -- the paper's tables --------------------------------------------------------

def table1(results: Dict[str, EvalResult]) -> List[str]:
    """Accuracy by reasoning category (percent) and mean tokens."""
    lines = [f"{'method':22s} " + " ".join(f"{c:>11s}" for c in CATEGORIES)
             + f" {'overall':>8s} {'tokens':>9s}"]
    for name in TABLE1_SYSTEMS:
        r = results[name]
        cols = " ".join(f"{100 * r.per_category[c]:10.2f}%"
                        for c in CATEGORIES)
        lines.append(f"{name:22s} {cols} {100 * r.overall:7.2f}% "
                     f"{r.mean_tokens:9.1f}")
    return lines


def table2(results: Dict[str, EvalResult]) -> List[str]:
    """Tokens and cost per query, and the context footprint against the
    full-context ceiling."""
    full = results["full-context"].mean_tokens
    lines = [f"{'method':14s} {'added tokens':>12s} {'cost($)':>10s} "
             f"{'footprint':>9s}"]
    for name in TABLE2_SYSTEMS:
        r = results[name]
        lines.append(f"{name:14s} {r.mean_tokens:12.1f} "
                     f"{r.mean_tokens * PRICE_PER_TOKEN:10.6f} "
                     f"{100 * r.mean_tokens / full:8.2f}%")
    lines.append(f"memori vs full-context: "
                 f"{full / results['memori'].mean_tokens:.1f}x cheaper per "
                 "query")
    return lines


def table3() -> List[str]:
    """The question-category distribution of the synthetic benchmark
    beside LoCoMo's."""
    counts = collections.Counter()
    for seed in range(4):
        conv = generate_conversation(seed=seed, n_sessions=6, noise_turns=20)
        counts.update(q.category for q in conv.questions)
    lines = [f"{'category':14s} {'synthetic n':>11s} {'LoCoMo n':>9s}"]
    lines += [f"{c:14s} {counts[c]:11d} {LOCOMO_WEIGHTS[c]:9d}"
              for c in CATEGORIES]
    return lines


def figure2(runs: Sequence[EvalResult]) -> List[str]:
    """Memori's accuracy mean ± std per category over the seed groups."""
    lines = []
    for c in CATEGORIES:
        vals = [100 * r.per_category[c] for r in runs]
        lines.append(f"{c:14s} {statistics.mean(vals):6.2f}% ± "
                     f"{statistics.stdev(vals):5.2f}")
    overall = [100 * r.overall for r in runs]
    lines.append(f"{'overall':14s} {statistics.mean(overall):6.2f}% ± "
                 f"{statistics.stdev(overall):5.2f}")
    return lines


def run_all(device="cuda") -> Dict[str, object]:
    """Every table at the paper's defaults.  Returns the results, the
    Figure 2 runs and each table's lines."""
    results = {name: evaluate(name, device=device) for name in TABLE1_SYSTEMS}
    runs = [results["memori"] if seeds == (0, 1)
            else evaluate("memori", seeds=seeds, device=device)
            for seeds in FIGURE2_SEEDS]
    return {"results": results, "figure2_runs": runs,
            "tables": {"table1": table1(results), "table2": table2(results),
                       "table3": table3(), "figure2": figure2(runs)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    out = run_all(args.device)
    titles = {"table1": "Table 1 — accuracy by category (synthetic LoCoMo, "
                        "oracle judge)",
              "table2": "Table 2 — token usage and cost efficiency",
              "table3": "Table 3 — question category distribution",
              "figure2": "Figure 2 — Memori accuracy mean ± std (n=3 runs)"}
    for key, lines in out["tables"].items():
        print(f"\n# {titles[key]}")
        print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
