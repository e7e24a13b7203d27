#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It prints one JSON line per phase and fails (nonzero exit) on any failed
check:

1. build    — compiles every CUDA kernel of the port with nvcc (sm_90a).
2. kernels  — holds each kernel against its plain PyTorch version on the
              card over edge cases (Q in {1, 7, 64, 130}, N in {1000,
              65536, 2**20}, k in {10, 64, 256}, n_valid < N, tombstones and
              padding labels, an all-masked query, k above the live rows,
              planted duplicate rows), and times it at the main path's
              shape beside its plain version, one PyTorch library call and
              its bound on the card.
3. serve    — drives `MemoryService(device="cuda")`: records synthetic
              LoCoMo-style conversations through enqueue/flush, fills the
              bank to 2**20 rows through the store's commit path, then runs
              `retrieve_batch` at B in {1, 8, 64} under the hybrid,
              dense-only and sparse-only plans, with the kernels' launch
              counters reset just before and read just after; the dense
              ranking each of those executes produced is then held against
              the plain version on inputs rebuilt from its requests.

The last three lines are the kernels' summary, the card's name and power
limit (as nvidia-smi reports them), and `{"ok": true, "device": {...}}`.
The script needs the repository's `src/` beside it and a CUDA card; without
either it exits nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# published H100 SXM rates (NVIDIA data sheet): HBM3 bandwidth and the
# plain (non-tensor-core) FP32 rate, the only rate an exact-f32 kernel uses
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
RTOL, ATOL = 1e-5, 1e-6
NEG_INF = -2.0e38
# bank sizes N of the kernel checks, and the main path's bank size
KERNEL_SIZES = (1000, 65536, 1 << 20)
MAIN_N = 1 << 20
# conversations recorded through enqueue/flush, and the template
# conversations the fill replicates
N_RECORDED = 64
N_TEMPLATES = 128


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- phase 1: build ------------------------------------------------------------

def phase_build() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    log = {name: build.build(name) for name in build.SOURCES}
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "gpu": gpu_line(),
           "kernels": {name: {"nvcc_seconds": e["seconds"],
                              "ptxas": [ln.strip() for ln in
                                        e["ptxas"].splitlines()
                                        if "registers" in ln
                                        or "spill" in ln]}
                       for name, e in log.items()}}
    emit(out)
    return out


# -- phase 2: kernels ----------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` runs, by CUDA events, after one
    warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def topk_bound_ms(Q: int, n_valid: int, D: int, k: int):
    """Least time for one masked top-k on the card: each input read once
    (queries, the live bank prefix, both label vectors), each output written
    once, against the f32 product's 2*Q*n_valid*D flops."""
    bytes_moved = 4 * (Q * D + n_valid * D + Q + n_valid) + 8 * Q * k
    flops = 2.0 * Q * n_valid * D
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare_topk(s_k, i_k, s_r, i_r, what: str) -> float:
    """Hold kernel output (s_k, i_k) against the plain version's (s_r, i_r):
    the same live slots, scores within rtol/atol, and ids equal wherever a
    score is separated from both neighbours by more than the tolerance
    (within a closer run the two summation orders may swap neighbours).
    Returns the largest absolute score difference."""
    import torch
    if s_k.shape != s_r.shape or i_k.shape != i_r.shape:
        fail(f"{what}: shape {tuple(s_k.shape)} vs {tuple(s_r.shape)}")
    live = i_r >= 0
    if not torch.equal(i_k >= 0, live):
        fail(f"{what}: live slots differ")
    if not torch.all(s_k[~live] == NEG_INF):
        fail(f"{what}: an empty slot's score is not NEG_INF")
    if not torch.allclose(s_k[live], s_r[live], rtol=RTOL, atol=ATOL):
        fail(f"{what}: scores differ beyond rtol={RTOL} atol={ATOL}")
    err = float((s_k[live] - s_r[live]).abs().max()) if live.any() else 0.0
    tol = ATOL + RTOL * s_r.abs()
    gap = (s_r[:, :-1] - s_r[:, 1:]).abs()
    sep = torch.ones_like(live)
    sep[:, 1:] &= gap > tol[:, 1:]
    sep[:, :-1] &= (gap > tol[:, :-1]) | ~live[:, 1:]
    sep[:, -1] &= ~live[:, -1]      # a full list's last slot may tie with
    sel = sep & live                # the first row beyond it
    if not torch.equal(i_k[sel], i_r[sel]):
        bad = int((i_k[sel] != i_r[sel]).sum())
        fail(f"{what}: {bad} separated ids differ")
    # kernel order is (score desc, row asc), even within a tie
    ds = s_k[:, :-1] - s_k[:, 1:]
    both = live[:, :-1] & live[:, 1:]
    if torch.any(both & (ds < 0)):
        fail(f"{what}: kernel scores not descending")
    if torch.any(both & (ds == 0) & (i_k[:, :-1] >= i_k[:, 1:])):
        fail(f"{what}: kernel tie not ordered by row")
    return err


def _labels(N: int, n_valid: int, n_big: int, gen, device):
    """Row labels: namespaces 0..n_big-1 over the live prefix, namespace
    n_big owning just 5 rows, a sprinkle of tombstones (-1), padding (-2)
    beyond n_valid."""
    import torch
    lab = torch.randint(0, n_big, (N,), generator=gen, device=device,
                        dtype=torch.int32)
    lab[torch.rand(N, generator=gen, device=device) < 0.02] = -1
    lab[torch.randperm(n_valid, generator=gen, device=device)[:5]] = n_big
    lab[n_valid:] = -2
    return lab


def phase_kernels(device, reps: int) -> dict:
    import torch
    from repro_torch.kernels.topk_mips import (topk_mips_masked,
                                               topk_mips_masked_ref)
    D = 256
    gen = torch.Generator(device=device).manual_seed(0)
    cases, max_err = 0, 0.0
    for N in KERNEL_SIZES:
        n_valid = N - max(1, N // 97)
        n_big = max(2, N // 1400)           # ~1400 rows per namespace
        bank = torch.randn((N, D), generator=gen, device=device)
        bank /= bank.norm(dim=1, keepdim=True)
        lab = _labels(N, n_valid, n_big, gen, device)
        # planted duplicates: one live row copied to rows far apart (other
        # tiles, other chunks), same namespace
        src = int(torch.nonzero(lab[: n_valid // 4] >= 0)[0])
        dups = [src, n_valid // 2, n_valid - 1]
        bank[dups] = bank[src].clone()
        lab[dups] = int(lab[src])
        for Q in (1, 7, 64, 130):         # 130: three query tiles
            q = torch.randn((Q, D), generator=gen, device=device)
            q /= q.norm(dim=1, keepdim=True)
            q_ns = torch.randint(0, n_big, (Q,), generator=gen,
                                 device=device, dtype=torch.int32)
            q[0] = bank[src].clone()
            q_ns[0] = int(lab[src])
            if Q > 1:
                q_ns[1] = n_big             # k above the live rows (5)
                q_ns[2] = n_big + 1         # matches nothing: all masked
            for k in (10, 64, 256):
                s_k, i_k = topk_mips_masked(q, bank, q_ns, lab, k=k,
                                            n_valid=n_valid)
                s_r, i_r = topk_mips_masked_ref(q, bank, q_ns, lab, k=k,
                                                n_valid=n_valid)
                torch.cuda.synchronize()
                what = f"topk_mips Q={Q} N={N} k={k}"
                max_err = max(max_err, compare_topk(s_k, i_k, s_r, i_r, what))
                if i_k[0, :3].tolist() != dups or \
                        len(set(s_k[0, :3].tolist())) != 1:
                    fail(f"{what}: duplicate rows do not tie exactly "
                         f"({i_k[0, :3].tolist()} vs {dups})")
                cases += 1
        del bank, lab
    # the main path's shape: one batch of 64 queries, pool k=64, a full
    # 2**20-row bank of ~1400-row namespaces
    Q, k, N = 64, 64, MAIN_N
    bank = torch.randn((N, D), generator=gen, device=device)
    bank /= bank.norm(dim=1, keepdim=True)
    lab = torch.randint(0, N // 1400, (N,), generator=gen, device=device,
                        dtype=torch.int32)
    q = torch.randn((Q, D), generator=gen, device=device)
    q_ns = lab[torch.randint(0, N, (Q,), generator=gen, device=device)]

    def library():
        s = q @ bank.T
        ok = q_ns[:, None] == lab[None, :]
        return torch.topk(torch.where(ok, s, NEG_INF), k, dim=1)

    t_kernel = time_ms(lambda: topk_mips_masked(q, bank, q_ns, lab, k=k),
                       reps)
    t_plain = time_ms(lambda: topk_mips_masked_ref(q, bank, q_ns, lab, k=k),
                      max(1, reps // 4))
    t_lib = time_ms(library, max(1, reps // 4))
    bound, bound_by = topk_bound_ms(Q, N, D, k)
    out = {"phase": "kernels", "cases": cases, "sizes": list(KERNEL_SIZES),
           "tolerance": {"rtol": RTOL, "atol": ATOL},
           "max_abs_err": max_err,
           "main_shape": {"Q": Q, "N": N, "D": D, "k": k},
           "kernel_ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
           "bound_ms": bound, "bound_by": bound_by,
           "gpu": gpu_line()}
    emit(out)
    return out


# -- phase 3: serve ------------------------------------------------------------

PLANTED_NS = "tenant-planted"
PLANTED_TEXT = "I work as a translator and I live in Cusco."
PLANTED_LINE = "(user; lives in; cusco)"
PLANTED_QUESTION = "Where does the user live?"


def profile_execute(svc, reqs, plan) -> dict:
    """One traced and profiled `retrieve_batch`: the host time of each plan
    stage (telemetry spans; a stage that waits on the device includes the
    wait), the device's busy time (union of kernel intervals) and idle
    share over the call, and the device time of the costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.telemetry import get_telemetry
    tel = get_telemetry()
    svc.retrieve_batch(reqs, plan=plan)                 # warm-up
    torch.cuda.synchronize()
    trace = tel.start_trace(op="execute")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with tel.activate([trace]):
            svc.retrieve_batch(reqs, plan=plan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    tel.finish_trace(trace)
    spans = {c["name"]: c["duration_s"] * 1e3
             for c in trace.to_dict()["root"].get("children", [])}
    kern = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if str(e.device_type).endswith("CUDA"))
    busy_us, end_us, by_name = 0.0, float("-inf"), {}
    for start, end, name in kern:
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "stages_ms": spans,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "device_kernels": len(kern),
            "top_kernels_ms": {name[:60]: ms for name, ms in top}}


def check_dense(svc, reqs, dense, fused, what: str):
    """Hold the dense ranking an `execute` produced against the plain
    version on inputs rebuilt here from the requests: the queries embedded
    into a zero-padded pow2 batch, each query's namespace id (padding and
    unknown namespaces get the never-assigned id), the service's device
    bank and labels.  `dense` is `search_batch`'s output in that execute
    and `fused` the (rankings, output) of its `rrf_fuse_batch`.  Returns
    (largest score difference, ids identical)."""
    import torch
    from repro_torch.kernels.topk_mips import topk_mips_masked_ref
    vi, store = svc.vindex, svc.store
    B = len(reqs)
    Bp = 1 << (B - 1).bit_length()
    unused = store.namespace_id_count()
    ns_ids = [store.get(ns) for ns, _ in reqs]
    q_ns = torch.tensor([t.ns_id if t else unused for t in ns_ids]
                        + [unused] * (Bp - B), dtype=torch.int32,
                        device=vi.device)
    qmat = torch.zeros((Bp, vi.dim), dtype=torch.float32, device=vi.device)
    qmat[:B] = svc.embedder.embed_texts([q for _, q in reqs])
    s_r, i_r = topk_mips_masked_ref(qmat, vi._bank_dev, q_ns, vi._labels_dev,
                                    k=svc.pool, n_valid=vi.n)
    s_k, i_k = dense
    s_k = torch.where(i_k >= 0, s_k, torch.full_like(s_k, NEG_INF))
    err = compare_topk(s_k, i_k, s_r, i_r, what)
    rankings, (f_ids, _) = fused
    if not torch.equal(rankings[0], i_k):
        fail(f"{what}: the dense ranking fused is not the kernel's output")
    if len(rankings) == 1 and not torch.equal(f_ids,
                                              i_k[:, : f_ids.shape[1]]):
        fail(f"{what}: the fused dense-only ranking is not the dense one")
    return err, bool(torch.equal(i_k, i_r))


def phase_serve(device, rows: int, reps: int) -> dict:
    import numpy as np
    import torch
    import repro_torch.core.service as service_mod
    from repro_torch.core import HashEmbedder, MemoryService, RetrievalPlan
    from repro_torch.core.extraction import Message, RuleExtractor
    from repro_torch.data.locomo_synth import generate_conversation
    from repro_torch.kernels.topk_mips import topk_mips_masked

    torch.cuda.reset_peak_memory_stats()
    svc = MemoryService(HashEmbedder(device=device), device=device)
    questions = {}
    # the write path: whole conversations through enqueue/flush
    t0 = time.perf_counter()
    for i in range(N_RECORDED):
        conv = generate_conversation(seed=i)
        for sid, msgs in conv.sessions:
            svc.enqueue(f"tenant-{i}", sid, msgs)
        questions[f"tenant-{i}"] = [qq.question for qq in conv.questions]
    conv = generate_conversation(seed=10_000)
    for sid, msgs in conv.sessions:
        svc.enqueue(PLANTED_NS, sid, msgs)
    svc.enqueue(PLANTED_NS, "s-planted",
                [Message("user", PLANTED_TEXT, conv.sessions[-1][1][0].timestamp)])
    svc.flush()
    t_record = time.perf_counter() - t0
    recorded_rows = svc.vindex.n
    # a first read materializes the device buffers, so the fill below
    # appends to them in place
    svc.retrieve(PLANTED_NS, PLANTED_QUESTION)

    # the fill: pre-extracted sessions committed through the store's
    # commit path (`_apply_flush`, the path log replay takes) in large
    # batches; one extracted conversation per namespace, from a pool of
    # template conversations, with their embeddings computed once
    t0 = time.perf_counter()
    ex, emb = RuleExtractor(), svc.embedder
    templates = []
    for j in range(N_TEMPLATES):
        conv = generate_conversation(seed=20_000 + j)
        sessions = [ex.extract(conv.conversation_id, sid, msgs)
                    for sid, msgs in conv.sessions]
        flat = [tr for trs, _ in sessions for tr in trs]
        vecs = emb.embed_texts_np([tr.text() for tr in flat])
        templates.append((sessions, vecs,
                          [qq.question for qq in conv.questions]))
    t_extract = time.perf_counter() - t0
    fill_ns, batch_rows = 0, 1 << 17
    while svc.vindex.n < rows:
        sessions, vec_parts = [], []
        n_batch = 0
        while n_batch < batch_rows and svc.vindex.n + n_batch < rows:
            tmpl_sessions, vecs, qs = templates[fill_ns % N_TEMPLATES]
            ns = f"fill-{fill_ns}"
            sessions += [(ns, summary, trs) for trs, summary in tmpl_sessions]
            vec_parts.append(vecs)
            questions[ns] = qs
            n_batch += vecs.shape[0]
            fill_ns += 1
        svc.store._apply_flush(sessions, np.concatenate(vec_parts))
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    n_rows = svc.vindex.n
    if n_rows < rows:
        fail(f"serve: bank holds {n_rows} rows, wanted {rows}")

    rng = np.random.default_rng(0)
    names = sorted(questions)
    plans = {"hybrid": RetrievalPlan.hybrid(),
             "dense_only": RetrievalPlan.dense_only(),
             "sparse_only": RetrievalPlan.sparse_only()}

    def batch(B):
        reqs = [(PLANTED_NS, PLANTED_QUESTION)]
        for ns in rng.choice(names, B - 1, replace=False):
            reqs.append((str(ns), str(rng.choice(questions[ns]))))
        return reqs

    # the dense search's output and the fusion's inputs of every execute
    # are kept (references only) for the check against the plain version
    vi = svc.vindex
    seen = {}
    search_batch, fuse = vi.search_batch, service_mod.rrf_fuse_batch

    def spy_search(*a, **kw):
        seen["dense"] = search_batch(*a, **kw)
        return seen["dense"]

    def spy_fuse(rankings, **kw):
        seen["fused"] = (list(rankings), fuse(rankings, **kw))
        return seen["fused"][1]

    vi.search_batch, service_mod.rrf_fuse_batch = spy_search, spy_fuse
    held = {}
    # the main path, with every kernel's launch counter reset just before
    topk_mips_masked.launches = 0
    latency, per_execute = {}, {}
    for B in (1, 8, 64):
        for pname, plan in plans.items():
            times, launches = [], []
            for rep in range(reps + 1):
                reqs = batch(B)
                seen.clear()
                before = topk_mips_masked.launches
                t = time.perf_counter()
                out = svc.retrieve_batch(reqs, plan=plan)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                launches.append(topk_mips_masked.launches - before)
                if "dense" in seen:
                    held[f"{pname}_B{B}"] = (reqs, seen["dense"],
                                             seen["fused"])
                if rep:                      # the first run is a warm-up
                    times.append(dt)
                if len(out) != B:
                    fail(f"serve: {len(out)} results for {B} requests")
                if pname != "sparse_only" and PLANTED_LINE not in out[0].text:
                    fail(f"serve {pname} B={B}: the planted fact did not "
                         f"come back:\n{out[0].text}")
                for o in out[1:]:
                    if "(user;" in o.text:
                        fail(f"serve {pname} B={B}: another tenant's "
                             "context holds the planted namespace's fact")
            want = 0 if pname == "sparse_only" else 1
            if any(n != want for n in launches):
                fail(f"serve {pname} B={B}: topk kernel launches per "
                     f"execute {launches}, expected {want}")
            latency[f"{pname}_B{B}"] = float(np.median(times)) * 1e3
            per_execute[f"{pname}_B{B}"] = want
    launches_main = topk_mips_masked.launches
    del vi.search_batch                 # back to the class's method
    service_mod.rrf_fuse_batch = fuse

    # the dense ranking of each timed execute's last run against the plain
    # version on the same device bank and labels
    err, exact = 0.0, {}
    for key, (reqs, dense, fused) in held.items():
        e, exact[key] = check_dense(svc, reqs, dense, fused,
                                    f"serve {key} dense ids")
        err = max(err, e)
    if len(held) != 6:
        fail(f"serve: dense rankings of {sorted(held)} held, expected the "
             "hybrid and dense-only plans at every B")
    other = svc.retrieve("tenant-0", PLANTED_QUESTION)
    if "(user;" in other.text:
        fail("serve: tenant-0 retrieved the planted namespace's fact")
    breakdown = {f"{p}_B64": profile_execute(svc, batch(64), plan)
                 for p, plan in plans.items()}
    out = {"phase": "serve", "rows": n_rows, "recorded_rows": recorded_rows,
           "namespaces": len(svc.namespaces()),
           "record_seconds": t_record, "template_seconds": t_extract,
           "fill_seconds": t_fill,
           "p50_ms": latency, "topk_launches_per_execute": per_execute,
           "topk_launches": launches_main,
           "dense_vs_plain": {"max_abs_err": err, "ids_identical": exact},
           "profiled": breakdown,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "gpu": gpu_line()}
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20,
                    help="bank rows the serve phase fills to")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed repetitions per measurement")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        sys.exit("chip_smoke: run from a checkout of the repository "
                 f"(no {os.path.join(SRC, 'repro_torch')})")
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "check runs on a CUDA card only")
    if torch.cuda.device_count() != 1:
        sys.exit("chip_smoke: runs on one card; make exactly one visible "
                 f"(CUDA_VISIBLE_DEVICES), not {torch.cuda.device_count()}")
    device = torch.device("cuda", 0)
    phase_build()
    kern = phase_kernels(device, args.reps)
    serve = phase_serve(device, args.rows, max(3, args.reps // 4))
    emit({"kernels": [{
        "name": "topk_mips_masked", "route": "cuda",
        "source": "src/repro_torch/csrc/topk_mips.cu",
        "replaces": "src/repro/kernels/topk_mips.py:92",
        "launches": serve["topk_launches"],
        "max_abs_err": max(kern["max_abs_err"],
                           serve["dense_vs_plain"]["max_abs_err"]),
        "ms": kern["kernel_ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"]}]})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
