#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It runs on `cuda:0` (one card, whatever the host holds), prints one JSON
line per phase and fails (nonzero exit) on any failed check:

1. build       — compiles every CUDA kernel of the port with nvcc (sm_90a).
2. kernels     — holds each top-k kernel (K1-K4) against its plain PyTorch
                 version on the card over edge cases (Q in {1, 7, 64, 130},
                 N in {1000, 65536, 2**20}, k in {10, 64, 256}, n_valid < N,
                 tombstones and padding labels, an all-masked query, k
                 above the live rows, planted duplicate rows; for the int8
                 pair also an all-zero row and rows whose norm differs by
                 10**3 from their neighbours), and times each at the main
                 path's shape beside its plain version, one PyTorch library
                 call and its bound on the card.
3. ops         — drives the four public entry points of kernels/ops.py
                 once each at the main path's shapes (the path of K3 and
                 K4), launch counters reset just before and read just after.
4. serve       — drives `MemoryService(device="cuda")` (f32 bank, K1):
                 records synthetic LoCoMo-style conversations through
                 enqueue/flush, fills the bank to 2**20 rows through the
                 store's commit path, then runs `retrieve_batch` at B in
                 {1, 8, 64} under the hybrid, dense-only and sparse-only
                 plans, with the kernels' launch counters reset just before
                 and read just after; the dense ranking each of those
                 executes produced is then held against the plain version on
                 inputs rebuilt from its requests.  Ends with one hot/warm
                 tier cycle: demotion, a B=64 batch of demoted namespaces
                 answered by host fallback, promotion, the batch again.
5. serve_int8  — the same with `MemoryService(quantize="int8")` (int8 bank,
                 K2 plus the exact f32 rescore) at 2**20 rows, under the
                 hybrid and dense-only plans; K2's candidates and the
                 rescored ranking of each execute are held against the
                 plain path, and recall@10 against the exact f32 host
                 search must reach 0.95.

The last three lines are the kernels' summary, the card's name and power
limit (as nvidia-smi reports them), and `{"ok": true, "device": {...}}`.
The script needs the repository's `src/` beside it and a CUDA card; without
either it exits nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import gc
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
F32_EPS = 2.0 ** -24          # unit roundoff of float32
# bank sizes N of the kernel checks, and the main path's bank size
KERNEL_SIZES = (1000, 65536, 1 << 20)
MAIN_N = 1 << 20
D = 256
# conversations recorded through enqueue/flush, the template conversations
# the fill replicates, and the requests answered before a tier demotion
N_RECORDED = 64
N_TEMPLATES = 128
TIER_POOL = 512
# each kernel: the TPU kernel it replaces, masked?, int8 bank?, and its k
# on the main path (the service's pool of 64; 256 = pow2(64 * rescore 4))
KERNELS = {
    "topk_mips_masked": ("src/repro/kernels/topk_mips.py:92", True, False,
                         64),
    "topk_mips_quant_masked": ("src/repro/kernels/topk_mips.py:134", True,
                               True, 256),
    "topk_mips": ("src/repro/kernels/topk_mips.py:74", False, False, 64),
    "topk_mips_quant": ("src/repro/kernels/topk_mips.py:112", False, True,
                        256),
}


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


def wrappers():
    from repro_torch.kernels import topk_mips as tk
    return {name: getattr(tk, name) for name in KERNELS}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


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


def topk_bound_ms(Q: int, n_valid: int, D: int, k: int, masked: bool = True,
                  quant: bool = False):
    """Least time for one top-k on the card: each input read once (queries,
    the live bank prefix — f32 rows, or int8 codes and f32 scales — and
    both label vectors when masked), each output written once, against the
    f32 product's 2*Q*n_valid*D flops (plus one scale multiply per score
    for the int8 bank)."""
    bank = n_valid * D + 4 * n_valid if quant else 4 * n_valid * D
    labels = 4 * (Q + n_valid) if masked else 0
    bytes_moved = 4 * Q * D + bank + labels + 8 * Q * k
    flops = 2.0 * Q * n_valid * D + (Q * n_valid if quant else 0)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def quant_slack(q, codes, scales, ids):
    """(Q, k) bound on how far two float32 summation orders of one int8
    score (q . codes[r]) * scales[r] can differ: 2 * D * u * scales[r] *
    sum_d |q_d * codes[r, d]| (each order is within D * u * sum|terms| of
    the exact sum).  It matters where a row's norm is 10**3 above its
    neighbours' and its score cancels to near zero."""
    import torch
    rows = codes[ids.clamp(min=0).long()].float().abs()        # (Q, k, D)
    mag = torch.einsum("qd,qkd->qk", q.abs(), rows)
    return 2 * q.shape[1] * F32_EPS * mag * scales[ids.clamp(min=0).long()]


def compare_topk(s_k, i_k, s_r, i_r, what: str, slack=None) -> float:
    """Hold kernel output (s_k, i_k) against the plain version's (s_r, i_r):
    the same live slots, scores within rtol/atol (plus `slack`, a (Q, k)
    summation-order bound, where given), and ids equal wherever a score is
    separated from both neighbours by more than that tolerance (within a
    closer run the two summation orders may swap neighbours).  Returns the
    largest absolute score difference."""
    import torch
    if s_k.shape != s_r.shape or i_k.shape != i_r.shape:
        fail(f"{what}: shape {tuple(s_k.shape)} vs {tuple(s_r.shape)}")
    live = i_r >= 0
    if not torch.equal(i_k >= 0, live):
        fail(f"{what}: live slots differ")
    if not torch.all(s_k[~live] == NEG_INF):
        fail(f"{what}: an empty slot's score is not NEG_INF")
    tol = ATOL + RTOL * s_r.abs()
    if slack is not None:
        tol = tol + slack
    if not torch.all((s_k[live] - s_r[live]).abs() <= tol[live]):
        fail(f"{what}: scores differ beyond rtol={RTOL} atol={ATOL}"
             + (" + summation slack" if slack is not None else ""))
    err = float((s_k[live] - s_r[live]).abs().max()) if live.any() else 0.0
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


def _call(fn, q, bank, codes, scales, q_ns, lab, masked, quant, **kw):
    lead = (q, codes, scales) if quant else (q, bank)
    return fn(*lead, *((q_ns, lab) if masked else ()), **kw)


def phase_kernels(device, reps: int) -> dict:
    import torch
    from repro_torch.kernels import topk_mips as tk
    gen = torch.Generator(device=device).manual_seed(0)
    res = {name: {"cases": 0, "max_abs_err": 0.0} for name in KERNELS}
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
        # the int8 bank: an all-zero row (scale 0), a few rows 10**3 longer
        # and a sprinkle 10**3 shorter than their unit-norm neighbours
        adv = bank.clone()
        far = [r for r in (1, n_valid // 3 + 1, n_valid // 5 + 2)
               if r not in dups]
        adv[far] *= 1e3
        tiny = torch.arange(7, N, 13, device=device)
        tiny = tiny[~torch.isin(tiny, torch.tensor(dups, device=device))]
        adv[tiny] *= 1e-3
        adv[next(r for r in range(N) if r not in dups + far)] = 0.0
        codes, scales = tk.quantize_rows_ref(adv)
        del adv
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
                for name, (_, masked, quant, _) in KERNELS.items():
                    args = (q, bank, codes, scales, q_ns, lab, masked, quant)
                    s_k, i_k = _call(getattr(tk, name), *args, k=k,
                                     n_valid=n_valid)
                    s_r, i_r = _call(getattr(tk, name + "_ref"), *args, k=k,
                                     n_valid=n_valid)
                    torch.cuda.synchronize()
                    what = f"{name} Q={Q} N={N} k={k}"
                    slack = quant_slack(q, codes, scales, i_r) if quant \
                        else None
                    err = compare_topk(s_k, i_k, s_r, i_r, what, slack)
                    res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                                   err)
                    # the duplicates tie exactly, side by side in row order
                    row = i_k[0].tolist()
                    pos = [row.index(d) if d in row else -1 for d in dups]
                    if pos != list(range(pos[0], pos[0] + 3)) or pos[0] < 0 \
                            or len(set(s_k[0, pos].tolist())) != 1:
                        fail(f"{what}: duplicate rows do not tie exactly "
                             f"({[row[p] for p in pos if p >= 0]} vs {dups})")
                    res[name]["cases"] += 1
        del bank, lab, codes, scales
    # a width that is no multiple of the 16-code vector load or of the
    # 32-wide depth step (the kernels' scalar staging path)
    N, Dn, Q, k = 1000, 24, 7, 10
    bank = torch.randn((N, Dn), generator=gen, device=device)
    codes, scales = tk.quantize_rows_ref(bank)
    lab = _labels(N, N - 9, 3, gen, device)
    q = torch.randn((Q, Dn), generator=gen, device=device)
    q_ns = torch.randint(0, 3, (Q,), generator=gen, device=device,
                         dtype=torch.int32)
    for name, (_, masked, quant, _) in KERNELS.items():
        args = (q, bank, codes, scales, q_ns, lab, masked, quant)
        s_k, i_k = _call(getattr(tk, name), *args, k=k, n_valid=N - 9)
        s_r, i_r = _call(getattr(tk, name + "_ref"), *args, k=k,
                         n_valid=N - 9)
        slack = quant_slack(q, codes, scales, i_r) if quant else None
        err = compare_topk(s_k, i_k, s_r, i_r, f"{name} D={Dn}", slack)
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        res[name]["cases"] += 1
    # the main path's shape: one batch of 64 queries over a full 2**20-row
    # bank of ~1400-row namespaces; k as the service asks for it
    Q, N = 64, MAIN_N
    bank, codes, scales, lab, q, q_ns = main_inputs(gen, device)
    for name, (_, masked, quant, k) in KERNELS.items():
        args = (q, bank, codes, scales, q_ns, lab, masked, quant)

        def library():
            s = (q @ codes.float().T) * scales if quant else q @ bank.T
            if masked:
                s = torch.where(q_ns[:, None] == lab[None, :], s, NEG_INF)
            return torch.topk(s, k, dim=1)

        r = res[name]
        r["main_shape"] = {"Q": Q, "N": N, "D": D, "k": k}
        r["kernel_ms"] = time_ms(
            lambda: _call(getattr(tk, name), *args, k=k), reps)
        r["plain_ms"] = time_ms(
            lambda: _call(getattr(tk, name + "_ref"), *args, k=k),
            max(1, reps // 4))
        r["library_ms"] = time_ms(library, max(1, reps // 4))
        r["bound_ms"], r["bound_by"] = topk_bound_ms(Q, N, D, k, masked,
                                                     quant)
    out = {"phase": "kernels", "sizes": list(KERNEL_SIZES),
           "tolerance": {"rtol": RTOL, "atol": ATOL,
                         "int8": "plus 2*D*u*scale*sum|q*codes| (u = 2**-24)"},
           "kernels": res, "gpu": gpu_line()}
    emit(out)
    return out


def main_inputs(gen, device):
    """The main path's kernel inputs: a unit-norm f32 bank of MAIN_N rows
    and its int8 codes and scales, ~1400-row namespaces, 64 queries."""
    import torch
    from repro_torch.kernels.topk_mips import quantize_rows_ref
    bank = torch.randn((MAIN_N, D), generator=gen, device=device)
    bank /= bank.norm(dim=1, keepdim=True)
    codes, scales = quantize_rows_ref(bank)
    lab = torch.randint(0, MAIN_N // 1400, (MAIN_N,), generator=gen,
                        device=device, dtype=torch.int32)
    q = torch.randn((64, D), generator=gen, device=device)
    q_ns = lab[torch.randint(0, MAIN_N, (64,), generator=gen, device=device)]
    return bank, codes, scales, lab, q, q_ns


# -- phase 3: the public kernel entry points -----------------------------------

def phase_ops(device) -> dict:
    """Drive `kernels/ops.py` once per entry point at the main path's shapes
    (the path of K3 and K4, which no service path calls), then hold each
    result against the plain version."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_mips as tk
    gen = torch.Generator(device=device).manual_seed(1)
    bank, codes, scales, lab, q, q_ns = main_inputs(gen, device)
    reset_counts()
    outs = {}
    for name, (_, masked, quant, k) in KERNELS.items():
        outs[name] = _call(getattr(ops, name), q, bank, codes, scales, q_ns,
                           lab, masked, quant, k=k)
    torch.cuda.synchronize()
    launches = counts()
    errs = {}
    for name, (_, masked, quant, k) in KERNELS.items():
        if launches[name] != 1:
            fail(f"ops {name}: {launches[name]} launches, expected 1")
        s_r, i_r = _call(getattr(tk, name + "_ref"), q, bank, codes, scales,
                         q_ns, lab, masked, quant, k=k)
        slack = quant_slack(q, codes, scales, i_r) if quant else None
        errs[name] = compare_topk(*outs[name], s_r, i_r, f"ops {name}",
                                  slack)
    out = {"phase": "ops", "launches": launches, "max_abs_err": errs,
           "gpu": gpu_line()}
    emit(out)
    return out


# -- phases 4 and 5: serve -----------------------------------------------------

PLANTED_NS = "tenant-planted"
PLANTED_TEXT = "I work as a translator and I live in Cusco."
PLANTED_LINE = "(user; lives in; cusco)"
PLANTED_QUESTION = "Where does the user live?"


def make_templates(device):
    """N_TEMPLATES extracted conversations with their embeddings, computed
    once for both serve phases: [(sessions, vecs, questions), ...]."""
    from repro_torch.core import HashEmbedder
    from repro_torch.core.extraction import RuleExtractor
    from repro_torch.data.locomo_synth import generate_conversation
    ex, emb = RuleExtractor(), HashEmbedder(device=device)
    templates = []
    for j in range(N_TEMPLATES):
        conv = generate_conversation(seed=20_000 + j)
        sessions = [ex.extract(conv.conversation_id, sid, msgs)
                    for sid, msgs in conv.sessions]
        flat = [tr for trs, _ in sessions for tr in trs]
        vecs = emb.embed_texts_np([tr.text() for tr in flat])
        templates.append((sessions, vecs,
                          [qq.question for qq in conv.questions]))
    return templates


def profile_execute(svc, reqs, plan, kernel: str) -> dict:
    """One traced and profiled `retrieve_batch`: the host time of each plan
    stage (telemetry spans; a stage that waits on the device includes the
    wait), the device's busy time (union of kernel and copy intervals) and
    idle share over the call, and the device time of the costliest
    kernels.  The profiler records the second of two executes: the first
    is its warm-up step (without one, a profile late in a long process was
    seen to drop the call's first device events).  `kernel_seen` says
    whether `kernel`'s pass 1 is among the recorded events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.obs.telemetry import get_telemetry
    tel = get_telemetry()
    svc.retrieve_batch(reqs, plan=plan)                 # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        svc.retrieve_batch(reqs, plan=plan)
        torch.cuda.synchronize()
        prof.step()
        trace = tel.start_trace(op="execute")
        t0 = time.perf_counter()
        with tel.activate([trace]):
            svc.retrieve_batch(reqs, plan=plan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        # no step() here: leaving the profiler in its active step keeps
        # that step's events for `prof.events()`
    tel.finish_trace(trace)
    spans = {c["name"]: c["duration_s"] * 1e3
             for c in trace.to_dict()["root"].get("children", [])}
    # device work only: the step's own annotation spans the whole call
    kern = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if str(e.device_type).endswith("CUDA")
                  and not e.name.startswith("ProfilerStep"))
    busy_us, end_us, by_name = 0.0, float("-inf"), {}
    for start, end, name in kern:
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    _, masked, quant, _ = KERNELS[kernel]
    tag = f"topk_partial_kernel<{str(masked).lower()}, {str(quant).lower()}>"
    return {"wall_ms": wall_ms, "stages_ms": spans,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "device_kernels": len(kern),
            "kernel_seen": any(tag in n for n in by_name),
            "top_kernels_ms": {name[:60]: ms for name, ms in top}}


def rebuild_queries(svc, reqs):
    """The (Bp, D) query block and (Bp,) namespace ids `execute` builds for
    `reqs`: the queries embedded into a zero-padded pow2 batch, padding and
    unknown namespaces on the never-assigned id."""
    import torch
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
    return qmat, q_ns


def _sentinel(s, i):
    import torch
    return torch.where(i >= 0, s, torch.full_like(s, NEG_INF)), i


def _check_fused(dense_ids, fused, what):
    import torch
    rankings, (f_ids, _) = fused
    if not torch.equal(rankings[0], dense_ids):
        fail(f"{what}: the dense ranking fused is not the search's output")
    if len(rankings) == 1 and not torch.equal(
            f_ids, dense_ids[:, : f_ids.shape[1]]):
        fail(f"{what}: the fused dense-only ranking is not the dense one")


def check_dense(svc, reqs, seen, what: str):
    """Hold the dense ranking an f32 `execute` produced (`search_batch`'s
    output, held in `seen` with the fusion's inputs) against K1's plain
    version on the service's device bank and labels and on queries rebuilt
    from the requests.  Returns (largest score difference, ids
    identical)."""
    import torch
    from repro_torch.kernels.topk_mips import topk_mips_masked_ref
    vi = svc.vindex
    qmat, q_ns = rebuild_queries(svc, reqs)
    s_r, i_r = topk_mips_masked_ref(qmat, vi._bank_dev, q_ns, vi._labels_dev,
                                    k=svc.pool, n_valid=vi.n)
    s_k, i_k = _sentinel(*seen["dense"])
    err = compare_topk(s_k, i_k, s_r, i_r, what)
    _check_fused(i_k, seen["fused"], what)
    return err, bool(torch.equal(i_k, i_r))


def check_dense_int8(svc, reqs, seen, what: str):
    """The int8 twin of `check_dense`: K2's candidates in that execute
    against K2's plain version, then the rescored ranking `search_batch`
    returned against the plain rescore (`_rescore_exact` over the plain
    candidates' f32 rows from the host mirror), and recall@10 of the
    rescored ids against the exact f32 host search over the whole mirror.
    Returns (largest score difference, ids identical, per-query
    recall@10)."""
    import numpy as np
    import torch
    from repro_torch.common.utils import next_pow2, to_device
    from repro_torch.core.vector_index import _rescore_exact
    from repro_torch.kernels.topk_mips import topk_mips_quant_masked_ref
    vi = svc.vindex
    qmat, q_ns = rebuild_queries(svc, reqs)
    kk = min(svc.pool, vi.capacity)
    kc = min(vi.capacity, next_pow2(kk * vi.rescore))
    s_r, i_r = topk_mips_quant_masked_ref(qmat, vi._bank_dev, vi._scales_dev,
                                          q_ns, vi._labels_dev, k=kc,
                                          n_valid=vi.n)
    s_c, i_c = _sentinel(*seen["cand"])
    err = compare_topk(s_c, i_c, s_r, i_r, what + " K2 candidates",
                       quant_slack(qmat, vi._bank_dev, vi._scales_dev, i_r))
    i_host = i_r.cpu().numpy()
    cand = vi._bank[np.clip(i_host, 0, vi.capacity - 1)]
    fs_r, fi_r = _sentinel(*_rescore_exact(
        qmat, to_device(cand, vi.device), i_r, k=kk))
    fs_k, fi_k = _sentinel(*seen["dense"])
    err = max(err, compare_topk(fs_k, fi_k, fs_r, fi_r, what + " rescored"))
    _check_fused(seen["dense"][1], seen["fused"], what)
    B = len(reqs)
    _, want = vi.search_host(qmat[:B].cpu().numpy(), q_ns[:B].cpu().numpy(),
                             k=10)
    got = fi_k[:B, :10].cpu().numpy()
    recall = [len(set(g[g >= 0]) & set(w[w >= 0])) / (w >= 0).sum()
              for g, w in zip(got, want) if (w >= 0).any()]
    return err, bool(torch.equal(fi_k, fi_r)), recall


def tier_cycle(svc, pool, rows: int, seen) -> dict:
    """One hot/warm cycle through the service: answer `pool` hot, attach a
    TierManager holding at most rows // 2 rows on the device and tick it
    (demotion), answer a B=64 hybrid batch of demoted namespaces from the
    pool (host fallbacks, reported on the dense span), tick again
    (promotion), answer the batch again (no fallback).  Both answers must
    equal the hot ones: fused ids, contexts and token counts."""
    import torch
    from repro_torch.core import RetrievalPlan
    from repro_torch.core.tiering import TierPolicy
    from repro_torch.obs.telemetry import get_telemetry, walk_spans
    plan = RetrievalPlan.hybrid()
    tel = get_telemetry()

    def run(reqs):
        trace = tel.start_trace(op="execute")
        t = time.perf_counter()
        with tel.activate([trace]):
            out = svc.retrieve_batch(reqs, plan=plan)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        tel.finish_trace(trace)
        ids = seen["fused"][1][0][: len(reqs)].cpu().numpy()
        dense = [sp for sp in walk_spans(trace.to_dict()["root"])
                 if sp["name"] == "plan.dense"]
        fb = dense[0].get("attrs", {}).get("host_fallbacks", 0)
        return {ns: (o.text, o.token_count, ids[r].tolist())
                for r, ((ns, _), o) in enumerate(zip(reqs, out))}, fb, ms

    hot = {}
    for i in range(0, len(pool), 64):
        hot.update(run(pool[i: i + 64])[0])
    tiers = svc.store.attach_tiers(TierPolicy(max_hot_rows=rows // 2))
    t0 = time.perf_counter()
    demote = tiers.tick()
    t_demote = time.perf_counter() - t0
    demoted = tiers.demoted_namespaces()
    batch = [r for r in pool if svc.store.get(r[0]).ns_id in demoted][:64]
    if len(batch) < 64 or svc.vindex.n_resident > rows // 2:
        fail(f"tier cycle: {len(batch)} pool namespaces demoted, "
             f"{svc.vindex.n_resident} rows resident")
    before = tiers.counters["host_fallbacks"]
    warm, fb_warm, ms_warm = run(batch)
    if fb_warm != 64 or tiers.counters["host_fallbacks"] - before != 64:
        fail(f"tier cycle: {fb_warm} host fallbacks reported, expected 64")
    t0 = time.perf_counter()
    promote = tiers.tick()
    t_promote = time.perf_counter() - t0
    if any(tiers.is_demoted(svc.store.get(ns).ns_id) for ns, _ in batch):
        fail("tier cycle: the tick did not promote the fallback namespaces")
    again, fb_again, ms_again = run(batch)
    if fb_again:
        fail(f"tier cycle: {fb_again} host fallbacks after promotion")
    for ns, _ in batch:
        if not warm[ns] == again[ns] == hot[ns]:
            fail(f"tier cycle {ns}: answers differ hot / warm / promoted:\n"
                 f"{hot[ns]}\n{warm[ns]}\n{again[ns]}")
    return {"demote_tick": demote, "demote_tick_seconds": t_demote,
            "fallback_execute_ms": ms_warm, "host_fallbacks": fb_warm,
            "promote_tick": promote, "promote_tick_seconds": t_promote,
            "promoted_execute_ms": ms_again,
            "answers_equal_hot": len(batch), "stats": tiers.stats()}


def phase_serve(device, rows: int, reps: int, templates,
                quantize: str = "none") -> dict:
    import numpy as np
    import torch
    import repro_torch.core.service as service_mod
    import repro_torch.core.vector_index as vi_mod
    from repro_torch.core import HashEmbedder, MemoryService, RetrievalPlan
    from repro_torch.core.extraction import Message
    from repro_torch.data.locomo_synth import generate_conversation
    int8 = quantize == "int8"
    kernel = "topk_mips_quant_masked" if int8 else "topk_mips_masked"
    name = "serve_int8" if int8 else "serve"

    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
    svc = MemoryService(HashEmbedder(device=device), device=device,
                        quantize=quantize)
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
    # batches; one extracted conversation per namespace, from the pool of
    # template conversations
    t0 = time.perf_counter()
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
        fail(f"{name}: bank holds {n_rows} rows, wanted {rows}")

    rng = np.random.default_rng(0)
    names = sorted(questions)
    plans = {"hybrid": RetrievalPlan.hybrid(),
             "dense_only": RetrievalPlan.dense_only()}
    if not int8:
        plans["sparse_only"] = RetrievalPlan.sparse_only()

    def batch(B):
        reqs = [(PLANTED_NS, PLANTED_QUESTION)]
        for ns in rng.choice(names, B - 1, replace=False):
            reqs.append((str(ns), str(rng.choice(questions[ns]))))
        return reqs

    # the dense search's output (and K2's candidates), and the fusion's
    # inputs of every execute are kept (references only) for the checks
    vi = svc.vindex
    seen = {}
    search_batch, fuse = vi.search_batch, service_mod.rrf_fuse_batch
    search_quant = vi_mod._search_device_quant

    def spy_search(*a, **kw):
        seen["dense"] = search_batch(*a, **kw)
        return seen["dense"]

    def spy_quant(*a, **kw):
        seen["cand"] = search_quant(*a, **kw)
        return seen["cand"]

    def spy_fuse(rankings, **kw):
        seen["fused"] = (list(rankings), fuse(rankings, **kw))
        return seen["fused"][1]

    vi.search_batch, service_mod.rrf_fuse_batch = spy_search, spy_fuse
    vi_mod._search_device_quant = spy_quant
    held = {}
    # the main path, with every kernel's launch counter reset just before
    reset_counts()
    latency, per_execute = {}, {}
    for B in (1, 8, 64):
        for pname, plan in plans.items():
            times, launches = [], []
            for rep in range(reps + 1):
                reqs = batch(B)
                seen.clear()
                before = wrappers()[kernel].launches
                t = time.perf_counter()
                out = svc.retrieve_batch(reqs, plan=plan)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                launches.append(wrappers()[kernel].launches - before)
                if "dense" in seen:
                    held[f"{pname}_B{B}"] = (reqs, dict(seen))
                if rep:                      # the first run is a warm-up
                    times.append(dt)
                if len(out) != B:
                    fail(f"{name}: {len(out)} results for {B} requests")
                if pname != "sparse_only" and PLANTED_LINE not in out[0].text:
                    fail(f"{name} {pname} B={B}: the planted fact did not "
                         f"come back:\n{out[0].text}")
                for o in out[1:]:
                    if "(user;" in o.text:
                        fail(f"{name} {pname} B={B}: another tenant's "
                             "context holds the planted namespace's fact")
            want = 0 if pname == "sparse_only" else 1
            if any(n != want for n in launches):
                fail(f"{name} {pname} B={B}: {kernel} launches per "
                     f"execute {launches}, expected {want}")
            latency[f"{pname}_B{B}"] = float(np.median(times)) * 1e3
            per_execute[f"{pname}_B{B}"] = want
    launches_main = counts()
    if any(n for k, n in launches_main.items() if k != kernel):
        fail(f"{name}: kernels other than {kernel} launched: "
             f"{launches_main}")

    # the dense ranking of each timed execute's last run against the plain
    # path on the same device bank and labels
    err, exact, recall = 0.0, {}, {}
    for key, (reqs, got) in held.items():
        what = f"{name} {key} dense ids"
        if int8:
            e, exact[key], recall[key] = check_dense_int8(svc, reqs, got,
                                                          what)
        else:
            e, exact[key] = check_dense(svc, reqs, got, what)
        err = max(err, e)
    if len(held) != 6:
        fail(f"{name}: dense rankings of {sorted(held)} held, expected the "
             "hybrid and dense-only plans at every B")
    if int8:
        per_query = [r for rs in recall.values() for r in rs]
        recall = {key: float(np.mean(rs)) for key, rs in recall.items()}
        recall["all"] = float(np.mean(per_query))
        if recall["all"] < 0.95:
            fail(f"{name}: recall@10 against the exact f32 search {recall}")
    other = svc.retrieve("tenant-0", PLANTED_QUESTION)
    if "(user;" in other.text:
        fail(f"{name}: tenant-0 retrieved the planted namespace's fact")
    breakdown = {f"{p}_B64": profile_execute(svc, batch(64), plan, kernel)
                 for p, plan in plans.items()}
    fill_names = [n for n in names if n.startswith("fill-")]
    pool = [(str(ns), str(rng.choice(questions[ns])))
            for ns in rng.choice(fill_names, TIER_POOL, replace=False)]
    tiers = tier_cycle(svc, pool, rows, seen)
    del vi.search_batch                 # back to the class's method
    service_mod.rrf_fuse_batch = fuse
    vi_mod._search_device_quant = search_quant
    out = {"phase": name, "quantize": quantize, "rows": n_rows,
           "recorded_rows": recorded_rows,
           "namespaces": len(svc.namespaces()),
           "record_seconds": t_record, "fill_seconds": t_fill,
           "p50_ms": latency, "launches_per_execute": per_execute,
           "launches": launches_main,
           "dense_vs_plain": {"max_abs_err": err, "ids_identical": exact},
           "profiled": breakdown, "tier_cycle": tiers,
           "memory_allocated_at_start_bytes": allocated_at_start,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "gpu": gpu_line()}
    if int8:
        out["recall_at_10"] = recall
        out["bank"] = svc.stats()["bank"]
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20,
                    help="bank rows the serve phases fill to")
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
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()
    phase_build()
    kern = phase_kernels(device, args.reps)["kernels"]
    ops = phase_ops(device)
    templates = make_templates(device)
    reps = max(3, args.reps // 4)
    serve = phase_serve(device, args.rows, reps, templates)
    gc.collect()                   # the f32 service is gone: free its memory
    torch.cuda.empty_cache()
    serve8 = phase_serve(device, args.rows, reps, templates,
                         quantize="int8")
    path_launches = {"topk_mips_masked": serve["launches"],
                     "topk_mips_quant_masked": serve8["launches"],
                     "topk_mips": ops["launches"],
                     "topk_mips_quant": ops["launches"]}
    path_err = {"topk_mips_masked": serve["dense_vs_plain"]["max_abs_err"],
                "topk_mips_quant_masked":
                    serve8["dense_vs_plain"]["max_abs_err"]}
    summary = []
    for name, (replaces, _, _, _) in KERNELS.items():
        r = kern[name]
        launches = path_launches[name][name]
        if launches < 1:
            fail(f"{name} was not launched on its path")
        summary.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/topk_mips.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"], ops["max_abs_err"][name],
                               path_err.get(name, 0.0)),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    emit({"seconds": time.perf_counter() - t_start})
    emit({"kernels": summary})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
