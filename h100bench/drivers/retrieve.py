"""Driver of `kind: "retrieve"` mixes: batches of distinct tenants' retrieves
handed to `MemoryService.retrieve_batch` (its `execute`) from one thread,
back to back, each batch ending in a synchronise once its answers are on
the host, as full scheduler ticks would hand them over.

Mix keys: `plan` (a `RetrievalPlan` constructor: "hybrid", "dense_only"),
`batch`, `tenant_zipf`, `warmup_batches`, `profile_at_s` / `profile_s`
(the traced slice), `check_requests`.
"""
from __future__ import annotations

import time

from h100bench.harness import checks, memstore, stats, traffic
from h100bench.harness.run import (Run, Window, peak_bytes, row_of,
                                   spy_rankings, sync)

KERNELS = ("topk_mips",)          # the CUDA sources the timed path runs


def run(cell, seed: int, seconds: float, trace: bool, control: bool,
        clock, device) -> Run:
    import torch
    from repro_torch.core import RetrievalPlan
    from repro_torch.obs.telemetry import get_telemetry

    cfg, mix = cell.config, cell.traffic
    r = Run(cell, trace)
    with clock.part("store"):
        svc, data = memstore.build(cfg, seed, device, clock)
    plan = getattr(RetrievalPlan, mix["plan"])()
    B = int(mix["batch"])
    held = spy_rankings(svc)
    gen = traffic.Requests(mix, data, traffic.rng(seed, "traffic"))
    warm = traffic.Requests(mix, data, traffic.rng(seed, "warmup"))
    with clock.part("warmup"):
        for _ in range(int(mix["warmup_batches"])):
            svc.retrieve_batch(warm.batch(B), plan=plan)
        sync(device)
        held.clear()
    tel = get_telemetry()
    r.setup_s = clock.total()

    batches = []           # (requests, answers, start, end, dense, sparse)
    win = Window(seconds, mix, r)
    while win.open():
        reqs = gen.batch(B)
        tr = tel.start_trace(op="execute") if trace else None
        with r.spans.span("execute", batch=B) as attrs:
            t0 = time.perf_counter()
            if tr is not None:
                with tel.activate([tr]):
                    out = svc.retrieve_batch(reqs, plan=plan)
            else:
                out = svc.retrieve_batch(reqs, plan=plan)
            sync(device)
            t1 = time.perf_counter()
        if tr is not None:
            tel.finish_trace(tr)
            r.program_spans.append((_stage_s(tr), attrs))
        batches.append((reqs, out, t0, t1, held.pop("dense", None),
                        held.pop("sparse", None)))
    win.close(batches[-1][3] if batches else time.perf_counter())
    r.memory_peak = peak_bytes(device)

    lat = [(t1 - t0) * 1e3 for reqs, _, t0, t1, _, _ in batches
           for _ in reqs]
    r.facts["batch_ms"] = [(t1 - t0) * 1e3 for _, _, t0, t1, _, _ in batches]
    r.attempted = len(lat)
    r.failed = sum(max(0, len(reqs) - len(out)) for reqs, out, *_ in batches)
    r.e2e["retrieve_per_s"] = stats.rate(len(lat), win.seconds)
    r.e2e["retrieve_p95_ms"] = stats.percentile(lat, 95)
    in_slice = [reqs for reqs, *_ in batches_in(batches, win)]

    # the comparison, once the window has closed
    flat = [(b, i) for b, batch in enumerate(batches)
            for i in range(len(batch[0]))]
    gen_c = traffic.rng(seed, "check")
    picks = checks.sample(len(flat), int(mix["check_requests"]), gen_c)
    got = []
    for p in picks:
        b, i = flat[p]
        reqs, out, _, _, dense, sparse = batches[b]
        ans = out[i] if i < len(out) else None
        got.append((reqs[i], None if ans is None
                    else (ans.text, ans.token_count),
                    row_of(dense, i), row_of(sparse, i)))
    n_rows = svc.vindex.n
    del svc, batches, held
    ref = memstore.ReferenceStore(data, cfg["dim"])
    judge = checks.RetrievalJudge(ref, cfg, sparse="sparse" in plan.stages)
    for (ns, q), ans, dense, sparse in got:
        judge.judge(ns, q, ans, dense, sparse, control=control)
    if ref.n_rows != n_rows:
        judge._fault(f"the bank holds {n_rows} rows, the reference's layout "
                     f"{ref.n_rows}")
    r.facts["k1_calls"] = [k1_call(ref, reqs, cfg) for reqs in in_slice]
    r.compared = judge.compared(cell.limits)
    r.faults = judge.faults
    return r


def batches_in(batches, win):
    """The batches that ran inside the traced slice."""
    return [b for b in batches if win.in_slice(b[2], b[3])]


def _stage_s(tr) -> dict:
    """Seconds of each telemetry stage span of one execute."""
    return {c["name"]: c["duration_s"]
            for c in tr.to_dict()["root"].get("children", [])}


def k1_call(ref, reqs, cfg) -> dict:
    """What one execute's K1 call needs: the padded queries, the bank's
    labels, the rows the queries' namespaces own and the (query, row)
    pairs, counted from the reference's own tenants."""
    Q = 1 << (len(reqs) - 1).bit_length()
    owned = {ns: ref.tenant(ns).n for ns, _ in reqs}
    return {"Q": Q, "n_labels": ref.n_rows, "D": cfg["dim"],
            "k": cfg["pool"], "rows": sum(owned.values()),
            "pairs": sum(owned[ns] for ns, _ in reqs)}
