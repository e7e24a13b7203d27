"""The graph stage's scoreboard on the port: recall uplift and latency cost
of the k-hop expansion.

Plants graph-answerable chains (`generate_conversation(...,
graph_chains=True)`: multi-hop entity chains and succession within a
session) into a multi-tenant MemoryService, then asks every
GRAPH_CATEGORIES question twice through the raw plans — flat hybrid
(dense + sparse + fuse) against graph-expanded (dense + sparse + graph +
fuse) — and scores triple-level support recall: a question counts as
recalled when the returned triples textually contain each of its evidence
pairs.  Raw plans (no budgeting, no summaries) isolate what the expansion
adds.

It also checks device residency end to end: after two probe links grow
the graph within its lanes' capacity, the graph-plan batch re-executes
with no whole-lane re-upload (`MemoryGraph.counters["lane_uploads"]`).

    python -m repro_torch.eval.graph_recall [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.core.api import RetrievalPlan, RetrieveRequest
from repro_torch.core.embedder import HashEmbedder
from repro_torch.core.service import MemoryService
from repro_torch.data.locomo_synth import (GRAPH_CATEGORIES,
                                           generate_conversation)


def build(seeds, n_sessions, noise_turns, device="cuda"):
    svc = MemoryService(HashEmbedder(device=device), device=device,
                        top_k=10)
    questions = []          # (namespace, Question)
    for seed in seeds:
        conv = generate_conversation(seed=seed, n_sessions=n_sessions,
                                     noise_turns=noise_turns,
                                     graph_chains=True)
        ns = conv.conversation_id
        for sid, msgs in conv.sessions:
            svc.record(ns, sid, msgs)
        questions.extend((ns, q) for q in conv.questions
                         if q.category in GRAPH_CATEGORIES)
    svc.flush()
    return svc, questions


def recalled(svc, ns, q, raw) -> bool:
    t = svc.store.get(ns)
    texts = [t.triples.get(tid).text().lower() for tid in raw.triple_ids]
    need = len(q.supports) if q.min_supports < 0 else q.min_supports
    hits = sum(1 for sup in q.supports
               if any(all(term.lower() in tx for term in sup)
                      for tx in texts))
    return hits >= need


def _timed(svc, reqs, plan):
    t0 = time.perf_counter()
    out = svc.execute(reqs, plan=plan)
    if svc.vindex.device.type == "cuda":
        torch.cuda.synchronize(svc.vindex.device)
    return out, time.perf_counter() - t0


def run_plan(svc, questions, plan, hops, repeats):
    reqs = [RetrieveRequest(ns, q.question, top_k=10,
                            hops=hops if plan.wants_graph else None)
            for ns, q in questions]
    outs = svc.execute(reqs, plan=plan)          # warm-up, and the recall
    per_cat = {c: [0, 0] for c in GRAPH_CATEGORIES}
    for (ns, q), raw in zip(questions, outs):
        per_cat[q.category][0] += recalled(svc, ns, q, raw)
        per_cat[q.category][1] += 1
    times = sorted(_timed(svc, reqs, plan)[1] for _ in range(repeats))
    lat_ms = 1e3 * times[len(times) // 2]
    recall = {c: h / max(1, n) for c, (h, n) in per_cat.items()}
    overall = (sum(h for h, _ in per_cat.values())
               / max(1, sum(n for _, n in per_cat.values())))
    return reqs, recall, overall, lat_ms


def run(seeds=(0, 1, 2), sessions: int = 6, noise: int = 40, hops: int = 2,
        repeats: int = 5, device="cuda") -> dict:
    svc, questions = build(seeds, sessions, noise, device=device)
    g = svc.store.graph
    before = {"nodes": g.n_nodes, "edges": g.n_edges}
    flat_plan = RetrievalPlan.raw()
    graph_plan = RetrievalPlan.graph_expanded(budget=False)
    _, flat_recall, flat_overall, flat_ms = run_plan(
        svc, questions, flat_plan, hops, repeats)
    graph_reqs, graph_recall, graph_overall, graph_ms = run_plan(
        svc, questions, graph_plan, hops, repeats)
    # steady state: with the lanes growing within their capacity bucket,
    # the warmed graph-plan batch re-executes without a lane upload
    ns0 = questions[0][0]
    svc.store.link(ns0, "bench probe a", "bench probe b", "entity")
    uploads = g.counters["lane_uploads"]
    svc.execute(graph_reqs, plan=graph_plan)
    svc.store.link(ns0, "bench probe c", "bench probe d", "entity")
    svc.execute(graph_reqs, plan=graph_plan)
    reuploads = g.counters["lane_uploads"] - uploads
    return {
        "bench": "graph_expansion",
        "device": str(svc.vindex.device),
        "questions": len(questions),
        "graph_before_probes": before,
        "graph": {"nodes": g.n_nodes, "edges": g.n_edges,
                  **{f"edges_{k}": v
                     for k, v in g.edge_type_counts().items()}},
        "recall": {"flat": {"overall": flat_overall, **flat_recall},
                   "graph": {"overall": graph_overall, **graph_recall}},
        "uplift": graph_overall - flat_overall,
        "latency_ms": {"flat_batch_p50": flat_ms,
                       "graph_batch_p50": graph_ms,
                       "factor": graph_ms / max(1e-9, flat_ms)},
        "lane_reuploads_steady_state": reuploads,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seeds", default="0,1,2",
                    help="comma-separated conversation seeds")
    ap.add_argument("--sessions", type=int, default=6)
    ap.add_argument("--noise", type=int, default=40)
    ap.add_argument("--hops", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--assert-uplift", type=float, default=0.1,
                    help="required overall recall gain of graph over flat")
    ap.add_argument("--assert-latency-factor", type=float, default=5.0,
                    help="graph batch latency budget, as a multiple of flat")
    args = ap.parse_args(argv)
    result = run([int(s) for s in args.seeds.split(",") if s],
                 args.sessions, args.noise, args.hops, args.repeats,
                 device=args.device)
    result["asserted"] = {"uplift_min": args.assert_uplift,
                          "latency_factor_max": args.assert_latency_factor}
    print(json.dumps(result, indent=2))
    failures = []
    if result["lane_reuploads_steady_state"]:
        failures.append("steady-state graph batch re-uploaded the lanes "
                        f"{result['lane_reuploads_steady_state']}x")
    if result["uplift"] < args.assert_uplift:
        failures.append(f"recall uplift {result['uplift']:.3f} < "
                        f"{args.assert_uplift}")
    factor = result["latency_ms"]["factor"]
    if factor > args.assert_latency_factor:
        failures.append(f"latency factor {factor:.2f}x > "
                        f"{args.assert_latency_factor}x budget")
    if failures:
        print("FAIL: " + "; ".join(failures))
        return 1
    rc = result["recall"]
    print(f"OK: recall {rc['flat']['overall']:.3f} -> "
          f"{rc['graph']['overall']:.3f} (+{result['uplift']:.3f}) at "
          f"{factor:.2f}x flat latency, no lane re-upload")
    return 0


if __name__ == "__main__":
    sys.exit(main())
