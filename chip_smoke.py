#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It runs on `cuda:0` (one card, whatever the host holds), prints one JSON
line per phase and fails (nonzero exit) on any failed check:

1. build       — compiles every CUDA kernel of the port with nvcc (sm_90a),
                 one nvcc process per source, all at once.
2. kernels     — holds each top-k kernel (K1-K4) against its plain PyTorch
                 version on the card over edge cases (Q in {1, 7, 64, 130},
                 N in {1000, 65536, 2**20}, k in {1, 10, 64, 256, 257, 512,
                 2048}, n_valid < N, tombstones and padding labels, an
                 all-masked query, k above the live rows, planted duplicate
                 rows; for the int8 pair also an all-zero row and rows whose
                 norm differs by 10**3 from their neighbours), the scan
                 kernel's hard cases (a bank whose scores rise with the row,
                 an all-tied bank, n_valid below k and off the tile) and,
                 for K1/K2, the label layouts the compaction must handle
                 (one label everywhere, 28-row contiguous namespaces,
                 scattered namespaces, queries sharing labels, labels that
                 own no row, every row tombstoned, one namespace's rows in
                 one run) at N = 65536 (Q = 130) and 2**20.  It times each at
                 the main path's shape beside its plain version, one
                 PyTorch library call and its bound on the card, with its
                 passes' device time, resident CTAs per SM and ptxas
                 registers (K3/K4 also on a rising bank; K1/K2 under three
                 label layouts: the main shape's, the serve phases' and one
                 label everywhere).
3. ops         — drives the four public entry points of kernels/ops.py
                 once each at the main path's shapes (the path of K3 and
                 K4), launch counters reset just before and read just after.
4. serve       — drives `MemoryService(device="cuda")` (f32 bank, K1):
                 records synthetic LoCoMo-style conversations through
                 enqueue/flush, fills the bank to 2**20 rows through the
                 store's commit path, then runs `retrieve_batch` at B in
                 {1, 8, 64} under the hybrid, dense-only, sparse-only and
                 graph-expanded plans, with the kernels' launch counters
                 reset just before and read just after; the dense ranking
                 each of those executes produced is then held against the
                 plain version on inputs rebuilt from its requests, and the
                 B=8 graph expansion against the same expansion on CPU
                 copies of its lanes and rankings (equal ids, equal score
                 bits).  The graph plan's `plan.graph` span, frontier sizes
                 and peak device memory are reported.  Ends with one
                 hot/warm tier cycle: demotion, a B=64 batch of demoted
                 namespaces answered by host fallback, promotion, the batch
                 again.
5. scheduler   — the serve phase's f32 store (all rows hot again) behind the
                 request scheduler (`MemoryService.start_scheduler`, K1
                 answering every tick): 1, 8 and 64 closed-loop client
                 threads, each issuing one RetrieveRequest at a time (the
                 planted-fact question and other namespaces; hybrid and
                 dense-only), direct (one execute a request, the executes
                 taken in turns through one lock) and scheduled (tick 2 ms,
                 max batch 64), 200 requests or more a run: requests/s,
                 latency p50/p99, the medians of queued_s and service_s,
                 tick batch sizes, K1 launches a tick.  Every response must
                 be ok, the planted fact returned with no leak, K1 launched
                 once an execute, and each scheduled run's last tick equal
                 to the same requests as one direct execute and 8 of them
                 alone.  Then admission (8 closed-loop tenants, 320
                 requests, alone and beside a tenant flooding submit_many
                 under a per-tenant backlog cap: their p99, the
                 rejections, every admitted request ok), HTTP in process (a
                 MemoryFrontend: 8 conversations recorded over the wire,
                 the transport alone as GETs of /v1/healthz, 1, 8 and 64
                 HttpMemory threads -- latency and the host overhead over
                 the server's queued_s + service_s for each -- and one
                 NDJSON stream, all equal to the direct path, key
                 isolation, /v1/metrics and /v1/stats), a fresh full-width
                 engine's first decode step (its CUDA graph capture, in
                 thread-local mode) beside live ticks, captured again until
                 a tick's execute ran inside a capture (its answers equal
                 to a direct execute), and `python -m
                 repro_torch.launch.serve --tick-interval 0.002
                 --http-port 0 ... --qos-rate 50 --qos-burst 100
                 --snapshot-path D` at full width: record and retrieve over
                 HTTP, 429s with Retry-After under a burst, SIGTERM with a
                 final snapshot, a second boot that answers the same.  The
                 K1 count of the phase leaves out the checks' executes.
6. durability  — on the serve phase's f32 store (all rows back on the
                 device): mounts a LifecycleRuntime on a fresh directory
                 (the baseline snapshot generation: bytes and seconds,
                 pack, write + fsync, manifest), journals 64 conversations
                 one segment each, 8 group commits, a link, a namespace
                 eviction, a superseded eviction and a compaction, answers
                 a B=64 hybrid batch over both eras, drops the service
                 without closing it (a crash), recovers the directory with
                 `MemoryService.recover(..., device="cuda")` (seconds by
                 stage, peak device memory) and requires byte-equal
                 contexts, token counts and dense ranking, equal bank bytes
                 (SHA-256 of both mirrors and of the recovered device bank)
                 and K1 launched; times a rotation of the recovered
                 directory.  Then a kill -9 of a writer on the card, whose
                 recovery must match what it last made durable, and
                 `python -m repro_torch.launch.serve --snapshot-path D`
                 (full-width memori-agent) twice on one directory: the
                 second boot must recover the first's final state.
7. serve_int8  — the same with `MemoryService(quantize="int8")` (int8 bank,
                 K2 plus the exact f32 rescore) at 2**20 rows, under the
                 hybrid and dense-only plans; K2's candidates and the
                 rescored ranking of each execute are held against the
                 plain path, and recall@10 against the exact f32 host
                 search must reach 0.95.
8. harness     — `repro_torch.eval.locomo` at the paper's defaults on the
                 card (Table 1's four systems, Table 2, Figure 2; K1
                 through `MemoriMemory` and `RagChunkMemory`): for memori
                 and rag every question's context and token count must
                 equal the CPU run's, and the accuracy and tokens per query
                 the reference package's figures.
9. graph_recall — `repro_torch.eval.graph_recall` on the card: recall 1/6
                 (flat) -> 2/3 (graph) on the 18 graph questions, 99 nodes
                 and 402 edges after the probe links, and no whole-lane
                 re-upload while the lanes grow within their capacity.
10. attention  — holds the attention kernels K6 (flash_attention) and K5
                 (decode_attention) against their plain PyTorch versions on
                 the card, f32 and bf16, over edge cases (the reference
                 tests' shapes, lengths that are no multiple of the tile,
                 G in {1, 3, 8, 16}, D in {16, 64, 128, 256}, causal and not,
                 windows, kv_len of 1, of T and ragged, garbage past
                 kv_len, the model's strided layouts, and one or more
                 cases for each launch path, each checked to take it: K6's
                 wide and narrow CTA shapes, K5's single- and multi-split
                 grids, each with K/V by cp.async and by plain loads at
                 D = 50), holds one K5 call
                 captured in a CUDA graph against the plain version on every
                 replay while kv_len changes in place (f32 and bf16, windows
                 0 and 20), and times each at the agent's shapes (and K6 at
                 S = T = 4096) beside its plain version,
                 scaled_dot_product_attention and its bound (K5 also inside
                 a graph of 100 calls; K6 with its CTA count); the served
                 instances must not spill (ptxas).
11. lm         — `memori-agent` at full width (12 layers, d_model 768,
                 random weights from a seed) served by
                 `Engine(slots=8, max_len=512)` through `ContinuousBatcher`:
                 16 greedy requests of 32 new tokens, prompts from synthetic
                 LoCoMo conversations, K5 and K6 launch counters reset just
                 before and read just after: the decode step must run as a
                 replayed CUDA graph, K5 counted once a layer a step (744),
                 and a replayed step's logits and caches must equal an eager
                 step's on copies of the caches.  Every K6 and K5 call of a
                 teacher-forced run (ragged prefills, then batched decode
                 steps) is held against its plain version on its own
                 inputs.  End to end, on the same weights with wq/wk
                 rescaled to unit score spread (`conditioned`: at the
                 reference's init attention is a hard max, and rounding
                 alone makes two correct paths part ways), the
                 teacher-forced logits are held against the plain path's,
                 prefill + decode against the full forward, and the greedy
                 tokens against the plain path's (a divergence must sit at
                 a counted near-tie).
12. agent      — `MemoriClient` over `MemoryService(device="cuda")` with the
                 engine as its LLM: users record facts through chat +
                 end_session and `retrieve_batch` must return each user's
                 fact and no other's (K1, K5 and K6 all launched);
                 `LMExtractor` over the engine extracts one session;
                 `LMEmbedder` (memori-embedder width) embeds the recorded
                 triples through K6 (bidirectional): each call held against
                 the plain version, the embeddings against the plain path.

Before the phases one line records the host (Python, torch, CUDA, and
whether `import msgpack` works there: the port does not need it).  The
last three lines are the kernels' summary, the card's name and power
limit (as nvidia-smi reports them), and `{"ok": true, "device": {...}}`.
The script needs the repository's `src/` beside it and a CUDA card; without
either it exits nonzero before printing any result.

`--serving-times N` only times the lm phase's serving run N times and
prints its prefill, decode-step and tokens/s numbers; with `--src DIR` it
imports the port from another checkout's `src`, so one card compares two
commits by the same code:

    for src in parent/src src src parent/src; do
        python3 chip_smoke.py --serving-times 5 --src $src; done
"""
from __future__ import annotations

import argparse
import contextlib
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
# k of the kernel checks: 1, the service's pool and over-fetch sizes, and
# past 256 (a narrower query tile) up to MAX_K
KERNEL_KS = (1, 10, 64, 256, 257, 512, 2048)
# k of the masked kernels' label-layout checks
LAYOUT_KS = (1, 64, 256, 300)
MAIN_N = 1 << 20
D = 256
# the shape of most K1 launches: a one-namespace bank of ~280 live rows in
# the index's 1024-row starting buffer, one query (the harness's searches)
SINGLE_N, SINGLE_ROWS = 1024, 280
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
# the attention kernels: the TPU kernel each replaces and its source
ATTN_KERNELS = {
    "flash_attention": ("src/repro/kernels/flash_attention.py:26",
                        "src/repro_torch/csrc/flash_attention.cu"),
    "decode_attention": ("src/repro/kernels/decode_attention.py:25",
                         "src/repro_torch/csrc/decode_attention.cu"),
}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference tests'
# the agent's shapes: memori-agent's 4 kv-heads x 3 grouped heads of 64;
# prefill of a ~150-token prompt (and the config's long-context window);
# a decode step at 8 slots of a 512-position cache, ~170 positions filled
LM_K, LM_G, LM_D = 4, 3, 64
PREFILL_S, LONG_S = 150, 4096
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW_TOKENS = 8, 512, 16, 32
DECODE_KV_LEN = 170
# kv_len values a captured K5 call is replayed through (tile and split edges)
DECODE_REPLAY_LENS = (1, 2, 63, 64, 65, 170, 511, 512)
# K5 calls in the CUDA graph that times a graph-replayed call
GRAPH_CALLS = 100
# host runtime calls that put work on the device, as the profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync")
# logits of the kernel path against the plain path: the same f32 weights and
# inputs; only the attention's summation order differs (online against
# direct softmax, ~1e-6 relative per layer), over 12 layers and a 768-wide
# vocab projection of logits of order 1
LOGIT_TOL = 1e-4
# prefill + decode against the full forward: other matmul shapes, other
# accumulation orders (tests/test_decode_consistency.py holds 2e-3)
DECODE_TOL = 2e-3
EMBED_TOL = 2e-5


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
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import topk_mips as tk
    out = {name: getattr(tk, name) for name in KERNELS}
    out.update(flash_attention=fa.flash_attention,
               decode_attention=da.decode_attention)
    return out


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


# -- phase 1: build ------------------------------------------------------------

def ptxas_entries(report: str) -> dict:
    """Registers and spill bytes of each kernel (entry function) in
    `nvcc -Xptxas -v` output, keyed by a short name: `topk_scan_kernel<0,1,8>`
    or `flash_fwd_kernel<f32,64,8,16,8>` for a template instance (its
    arguments), else the kernel's name."""
    import re
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            t = re.search(r"([A-Za-z][A-Za-z_]*_kernel)(I?)", mangled)
            name = t.group(1)
            if t.group(2):      # template arguments: a type, then literals
                a = re.match(r"(f|\d+__nv_bfloat16)?((?:L[bi]\d+E)*)",
                             mangled[t.end():])
                args = re.findall(r"L[bi](\d+)E", a.group(2))
                if a.group(1):
                    args.insert(0, "f32" if a.group(1) == "f" else "bf16")
                name += "<" + ",".join(args) + ">"
            while name in out:      # other template arguments, same name
                name += "'"
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and "spill_stores" not in out[name]:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def phase_build() -> dict:
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SOURCES)) as pool:   # one nvcc each
        log = dict(zip(build.SOURCES, pool.map(build.build, build.SOURCES)))
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "gpu": gpu_line(),
           "kernels": {name: {"nvcc_seconds": e["seconds"],
                              "ptxas": ptxas_entries(e["ptxas"])}
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


def topk_bound_ms(Q: int, n_valid: int, D: int, k: int, quant: bool = False,
                  work=None):
    """Least time for one top-k on the card: each input read once, each
    output written once, against the f32 operations.  Unmasked (`work`
    None): the queries and the live bank prefix (f32 rows, or int8 codes
    and f32 scales), against the product's 2*Q*n_valid*D flops (plus one
    scale multiply per score for the int8 bank).  Masked, `work` = (rows,
    pairs) as `masked_work` counts them on these labels: both label
    vectors, the queries and each row some query's label matches, against
    2*D flops (plus the int8 multiply) per matching (query, row) pair;
    (n_valid, Q*n_valid) gives the full product's bound."""
    rows, pairs = (n_valid, Q * n_valid) if work is None else work
    row_bytes = D + 4 if quant else 4 * D
    labels = 0 if work is None else 4 * (Q + n_valid)
    bytes_moved = 4 * Q * D + rows * row_bytes + labels + 8 * Q * k
    flops = 2.0 * D * pairs + (pairs if quant else 0)
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


def kernel_instances(name: str, k: int, d: int):
    """The kernels (ptxas_entries names) that wrapper `name` launches at
    list length k and width d: the label compaction (masked), the scan
    kernel and the list merge."""
    from repro_torch.kernels import topk_mips as tk
    _, masked, quant, _ = KERNELS[name]
    queries, _ = tk.scan_tile(k, quant, d, masked)
    scan = (f"topk_scan_kernel<{int(masked)},{int(quant)},{queries // 8}>",
            "topk_merge_lists_kernel")
    return ("topk_count_kernel", "topk_compact_kernel") + scan if masked \
        else scan


def device_split_ms(fn, reps: int) -> dict:
    """Mean device ms per call of a top-k's passes, from a profile of
    `reps` calls after a warm-up: the label compaction (count + write, a
    masked call's), the scan kernel (its sample pass included), the merge
    of the chunk lists (both merges) and the rest (the floors' memset)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {"compact": 0.0, "scan": 0.0, "merge": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        part = ("compact" if "topk_count_kernel" in e.key
                or "topk_compact_kernel" in e.key else
                "scan" if "topk_scan_kernel" in e.key else
                "merge" if "topk_merge_lists_kernel" in e.key else "other")
        split[part] += e.device_time_total
    return {part: t / 1e3 / reps for part, t in split.items()}


def kernel_hard_cases(gen, device, res) -> None:
    """The scan kernel's own hard cases, for all four kernels: a bank whose
    scores rise with the row, so every row is admitted (the worst case for
    the candidate buffers); a bank of equal rows, so every score ties and
    the ids must be the first k live rows in ascending order; n_valid
    below k; n_valid off the 256-row tile."""
    import torch
    from repro_torch.kernels import topk_mips as tk
    N, Q = 65536, 7
    base = torch.rand((1, D), generator=gen, device=device) + 0.1
    rising = base * torch.linspace(0.01, 1.0, N, device=device)[:, None]
    q_up = base.repeat(Q, 1) + 0.01 * torch.rand((Q, D), generator=gen,
                                                 device=device)
    small = torch.randn((5000, D), generator=gen, device=device)
    q64 = torch.randn((64, D), generator=gen, device=device)
    cases = [("rising", rising, q_up, N - 77, k) for k in (64, 256, 2048)]
    cases += [("ties", torch.ones((N, D), device=device),
               torch.randn((Q, D), generator=gen, device=device), N - 300, k)
              for k in (1, 257, 2048)]
    cases += [("n_valid<k", small, q64, 700, 2048),
              ("n_valid off tile", small, q64, 4099, 64)]
    for tag, bank, q, n_valid, k in cases:
        codes, scales = tk.quantize_rows_ref(bank)
        lab = torch.randint(0, 3, (bank.shape[0],), generator=gen,
                            device=device, dtype=torch.int32)
        q_ns = torch.randint(0, 3, (q.shape[0],), generator=gen,
                             device=device, dtype=torch.int32)
        for name, (_, masked, quant, _) in KERNELS.items():
            args = (q, bank, codes, scales, q_ns, lab, masked, quant)
            s_k, i_k = _call(getattr(tk, name), *args, k=k, n_valid=n_valid)
            s_r, i_r = _call(getattr(tk, name + "_ref"), *args, k=k,
                             n_valid=n_valid)
            torch.cuda.synchronize()
            what = f"{name} {tag} N={bank.shape[0]} n_valid={n_valid} k={k}"
            slack = quant_slack(q, codes, scales, i_r) if quant else None
            err = compare_topk(s_k, i_k, s_r, i_r, what, slack)
            if tag == "ties" and not torch.equal(i_k, i_r):
                fail(f"{what}: tied rows not the first live rows in order")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            res[name]["cases"] += 1


def phase_kernels(device, reps: int, build_log=None) -> dict:
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
            for k in KERNEL_KS:
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
                    # (at k >= 3; below, an int8 row 10**3 longer may
                    # outrank them)
                    row = i_k[0].tolist()
                    pos = [row.index(d) if d in row else -1 for d in dups]
                    if k >= 3 and (
                            pos != list(range(pos[0], pos[0] + 3))
                            or pos[0] < 0
                            or len(set(s_k[0, pos].tolist())) != 1):
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
    kernel_hard_cases(gen, device, res)
    for N in KERNEL_SIZES[1:]:
        masked_layout_cases(gen, device, res, N)
    # the main path's shape: one batch of 64 queries over a full 2**20-row
    # bank of ~1400-row namespaces; k as the service asks for it.  The
    # masked pair is also timed under the serve phases' labels (37,450
    # contiguous 28-row namespaces) and under one label everywhere (the
    # single-tenant search: every row is compacted, K3's/K4's work)
    Q, N = 64, MAIN_N
    bank, codes, scales, lab, q, q_ns = main_inputs(gen, device)
    serve_lab = torch.arange(N, device=device, dtype=torch.int32) // 28
    layouts = {"main": (q_ns, lab),
               "serve_like": (serve_lab[torch.randint(
                   0, N, (Q,), generator=gen, device=device)], serve_lab),
               "uniform": (torch.zeros_like(q_ns), torch.zeros_like(lab))}
    for name, (_, masked, quant, k) in KERNELS.items():
        r = res[name]
        fn = getattr(tk, name)
        r["main_shape"] = {"Q": Q, "N": N, "D": D, "k": k}
        for lname, (ql, bl) in layouts.items() if masked else [("", layouts[
                "main"])]:
            t = time_topk(fn, (q, bank, codes, scales, ql, bl, masked, quant),
                          k, reps)
            if lname:
                r.setdefault("layouts", {})[lname] = t
            if lname in ("", "main"):
                r.update(t)
        r["plain_ms"] = time_ms(
            lambda: _call(getattr(tk, name + "_ref"), q, bank, codes, scales,
                          q_ns, lab, masked, quant, k=k), max(1, reps // 4))
        r["ctas_per_sm"] = tk.occupancy(fn, k, D)
        if build_log is not None:
            entries = build_log["kernels"]["topk_mips"]["ptxas"]
            r["ptxas"] = {inst: entries.get(inst)
                          for inst in kernel_instances(name, k, D)}
        if not masked:
            # the worst case for selection: scores rise with the row
            rise = (bank[:1].abs() + 0.01) * torch.linspace(
                0.01, 1.0, N, device=device)[:, None]
            lead = tk.quantize_rows_ref(rise) if quant else (rise,)
            r["rising_ms"] = time_ms(lambda: fn(q.abs(), *lead, k=k), reps)
            del rise, lead
    res["topk_mips_masked"]["single_query"] = single_query_case(gen, device,
                                                                reps)
    for name, (_, masked, _, _) in KERNELS.items():
        if masked:   # under one label everywhere, beside the unmasked twin
            twin = res[name.replace("_masked", "")]["kernel_ms"]
            res[name]["layouts"]["uniform"]["vs_unmasked"] = \
                res[name]["layouts"]["uniform"]["kernel_ms"] / twin
    out = {"phase": "kernels", "sizes": list(KERNEL_SIZES), "ks": list(KERNEL_KS),
           "tolerance": {"rtol": RTOL, "atol": ATOL,
                         "int8": "plus 2*D*u*scale*sum|q*codes| (u = 2**-24)"},
           "kernels": res, "gpu": gpu_line()}
    emit(out)
    return out


def time_topk(fn, args, k: int, reps: int, n_valid=None) -> dict:
    """Times of wrapper `fn` on `args` (as `_call` takes them) at the main
    shape: CUDA-event ms a call back to back (nothing else runs between the
    calls, so inputs that fit in the 50 MB L2 stay there: the 4 MB label
    vector, and the compacted rows where they are few) and with a 128 MB
    write between calls that evicts the L2 (its own time subtracted; its
    write-back may still cost the call), the library call's ms (`q @ bankᵀ`
    — int8: `(q @ codes.float()ᵀ) * scales` — then the mask, then
    `torch.topk`), the bound of these inputs and that of the full product,
    the profiler's device ms per pass and, masked, the compacted rows and
    the matching (query, row) pairs.  `n_valid` (default: every row) is
    passed to the wrapper; rows past it must carry label -1."""
    import torch
    from repro_torch.kernels import topk_mips as tk
    q, bank, codes, scales, q_ns, lab, masked, quant = args
    Q, N = q.shape[0], bank.shape[0]
    kw = {} if n_valid is None else {"n_valid": n_valid}
    n_valid = N if n_valid is None else n_valid

    def call():
        return _call(fn, *args, k=k, **kw)

    def library():
        s = (q @ codes.float().T) * scales if quant else q @ bank.T
        if masked:
            s = torch.where(q_ns[:, None] == lab[None, :], s, NEG_INF)
        return torch.topk(s, k, dim=1)

    flush = torch.empty(1 << 25, device=q.device)   # 128 MB
    out = {"kernel_ms": time_ms(call, reps)}
    out["l2_flushed_ms"] = time_ms(lambda: (flush.zero_(), call()), reps) \
        - time_ms(flush.zero_, reps)
    del flush
    out["library_ms"] = time_ms(library, max(1, reps // 4))
    work = tk.masked_work(q_ns, lab, n_valid) if masked else None
    out["bound_ms"], out["bound_by"] = topk_bound_ms(Q, n_valid, D, k, quant,
                                                     work)
    if masked:
        out["compacted_rows"], out["pairs"] = work
        out["dense_bound_ms"] = topk_bound_ms(
            Q, n_valid, D, k, quant, (n_valid, Q * n_valid))[0]
    out["device_ms"] = device_split_ms(call, max(1, reps // 4))
    return out


def single_query_case(gen, device, reps: int) -> dict:
    """K1 at the shape of most of its launches: the harness's searches and
    every quickstart-style single-tenant retrieve (`VectorIndex.search`) —
    one query over a one-namespace bank of SINGLE_ROWS live rows in a
    SINGLE_N-row buffer (labels collapsed to one namespace, -1 past the
    live rows), k = the pool of 64.  Held against the plain version, then
    timed as at the main shape."""
    import torch
    from repro_torch.kernels import topk_mips as tk
    bank = torch.zeros((SINGLE_N, D), device=device)
    live = torch.randn((SINGLE_ROWS, D), generator=gen, device=device)
    bank[:SINGLE_ROWS] = live / live.norm(dim=1, keepdim=True)
    lab = torch.full((SINGLE_N,), -1, dtype=torch.int32, device=device)
    lab[:SINGLE_ROWS] = 0
    q = torch.randn((1, D), generator=gen, device=device)
    q /= q.norm(dim=1, keepdim=True)
    q_ns = torch.zeros((1,), dtype=torch.int32, device=device)
    k = KERNELS["topk_mips_masked"][3]
    s_k, i_k = tk.topk_mips_masked(q, bank, q_ns, lab, k=k,
                                   n_valid=SINGLE_ROWS)
    s_r, i_r = tk.topk_mips_masked_ref(q, bank, q_ns, lab, k=k,
                                       n_valid=SINGLE_ROWS)
    err = compare_topk(s_k, i_k, s_r, i_r, "topk_mips_masked single query")
    out = time_topk(tk.topk_mips_masked,
                    (q, bank, None, None, q_ns, lab, True, False), k, reps,
                    n_valid=SINGLE_ROWS)
    out["plain_ms"] = time_ms(
        lambda: tk.topk_mips_masked_ref(q, bank, q_ns, lab, k=k,
                                        n_valid=SINGLE_ROWS), reps)
    out.update(shape={"Q": 1, "N": SINGLE_N, "n_valid": SINGLE_ROWS, "D": D,
                      "k": k, "labels": "one namespace"}, max_abs_err=err)
    return out


def masked_layouts(N: int, n_valid: int, Q: int, gen, device) -> dict:
    """The label layouts the compaction must handle, over N rows with the
    live prefix n_valid (padding -2 beyond it): name -> (query labels,
    bank labels).  Query 0's label owns rows 0, n_valid // 2 + 1 and
    n_valid - 1 (the planted duplicates) except where every row is
    tombstoned."""
    import torch
    from repro_torch.kernels import topk_mips as tk

    def rand(hi, n):
        return torch.randint(0, hi, (n,), generator=gen, device=device,
                             dtype=torch.int32)

    def owned(lab, n):   # labels of n random live rows
        live = lab[:n_valid][lab[:n_valid] >= 0]
        return live[torch.randint(0, live.numel(), (n,), generator=gen,
                                  device=device)]

    out = {}
    lab = torch.zeros(N, dtype=torch.int32, device=device)
    lab[torch.rand(N, generator=gen, device=device) < 0.02] = -1
    out["uniform"] = (torch.zeros(Q, dtype=torch.int32, device=device), lab)
    lab = torch.arange(N, dtype=torch.int32, device=device) // 28
    out["contiguous_28"] = (owned(lab, Q), lab)
    lab = rand(max(2, N // 1400), N)
    out["scattered"] = (owned(lab, Q), lab)
    out["shared_labels"] = (owned(lab, 3)[rand(3, Q).long()], lab)
    q_ns = owned(lab, Q)
    q_ns[1::2] = int(lab.max()) + 1 + rand(5, Q // 2)    # own no row
    out["unowned_labels"] = (q_ns, lab)
    out["tombstoned"] = (rand(8, Q), torch.full_like(lab, -1))
    # one namespace owns a run of rows that one chunk of the live prefix
    # holds (chunk C // 3 of K1's plan at k = 64 on 132 SMs, the H100's);
    # half the queries ask for it
    lab = rand(max(2, N // 1400), N) + 1
    C, _ = tk.plan_chunks(n_valid, Q, 132, 64, True, False, D)
    tiles = -(-n_valid // 256)
    lo, hi = (C // 3 * tiles // C * 256,
              min(n_valid, (C // 3 + 1) * tiles // C * 256))
    lab[lo: min(hi, lo + max(300, N // 256))] = 0
    q_ns = owned(lab, Q)
    q_ns[::2] = 0
    out["skewed"] = (q_ns, lab)
    dups = [0, n_valid // 2 + 1, n_valid - 1]
    for name, (q_ns, lab) in out.items():
        lab = lab.clone()
        out[name] = (q_ns, lab)
        lab[n_valid:] = -2
        if name != "tombstoned":
            lab[dups] = q_ns[0]
    return out


def masked_layout_cases(gen, device, res, N: int) -> None:
    """K1 and K2 against their plain versions under every label layout of
    `masked_layouts` at k in LAYOUT_KS, over N rows with n_valid off the
    256-row tile (Q = 130, three query tiles, below 2**20; 64 at 2**20),
    and the planted duplicate rows tying exactly, side by side in row
    order."""
    import torch
    from repro_torch.kernels import topk_mips as tk
    n_valid = N - N // 97
    Q = 64 if N >= MAIN_N else 130
    bank = torch.randn((N, D), generator=gen, device=device)
    bank /= bank.norm(dim=1, keepdim=True)
    dups = [0, n_valid // 2 + 1, n_valid - 1]
    bank[dups] = bank[0].clone()
    codes, scales = tk.quantize_rows_ref(bank)
    q = torch.randn((Q, D), generator=gen, device=device)
    q /= q.norm(dim=1, keepdim=True)
    q[0] = bank[0]
    for layout, (q_ns, lab) in masked_layouts(N, n_valid, Q, gen,
                                              device).items():
        for k in LAYOUT_KS:
            for name, (_, masked, quant, _) in KERNELS.items():
                if not masked:
                    continue
                args = (q, bank, codes, scales, q_ns, lab, masked, quant)
                s_k, i_k = _call(getattr(tk, name), *args, k=k,
                                 n_valid=n_valid)
                s_r, i_r = _call(getattr(tk, name + "_ref"), *args, k=k,
                                 n_valid=n_valid)
                torch.cuda.synchronize()
                what = f"{name} {layout} Q={Q} N={N} k={k}"
                slack = quant_slack(q, codes, scales, i_r) if quant else None
                err = compare_topk(s_k, i_k, s_r, i_r, what, slack)
                row = i_k[0].tolist()
                pos = [row.index(d) if d in row else -1 for d in dups]
                if layout != "tombstoned" and k >= 3 and (
                        pos != list(range(pos[0], pos[0] + 3)) or pos[0] < 0
                        or len(set(s_k[0, pos].tolist())) != 1):
                    fail(f"{what}: duplicate rows do not tie exactly")
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
                res[name]["cases"] += 1
    del bank, codes, scales


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


# -- phases 4 and 7: serve -----------------------------------------------------

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


def device_activity(prof) -> dict:
    """What a profile recorded on the device and the host's calls that put
    work there: the device's busy ms (union of kernel and copy intervals),
    its kernel count, device ms by kernel name, and the host's launch calls
    (`HOST_LAUNCH_CALLS`) by name."""
    kern = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if str(e.device_type).endswith("CUDA")
                  and not e.name.startswith("ProfilerStep"))
    host_calls = {}
    for e in prof.events():
        if (str(e.device_type).endswith("CPU")
                and e.name in HOST_LAUNCH_CALLS):
            host_calls[e.name] = host_calls.get(e.name, 0) + 1
    busy_us, end_us, by_name = 0.0, float("-inf"), {}
    for start, end, name in kern:
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    return {"busy_ms": busy_us / 1e3, "kernels": len(kern),
            "by_name": by_name, "host_calls": host_calls}


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
    act = device_activity(prof)    # device work only, not the step's span
    by_name = act["by_name"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    _, masked, quant, _ = KERNELS[kernel]
    tag = f"topk_scan_kernel<{str(masked).lower()}, {str(quant).lower()},"
    return {"wall_ms": wall_ms, "stages_ms": spans,
            "device_busy_ms": act["busy_ms"],
            "device_idle_share": 1.0 - act["busy_ms"] / wall_ms,
            "device_kernels": act["kernels"],
            "host_launch_calls": sum(act["host_calls"].values()),
            "host_launch_calls_by_name": act["host_calls"],
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


def check_graph(seen, planted_rows, pool: int, what: str) -> dict:
    """Hold one graph-plan execute made on the card (its `_expand_device`
    inputs and outputs and its fusion's inputs, kept by the spies in
    `phase_serve`) against the same functions on CPU copies of those
    inputs: the expansion's ids must be equal and its scores equal to the
    bit; the seeds plus the CPU expansion, fused on the CPU at the pool's
    width, must give the ids of the card's rankings fused on the card at
    that width, and the execute's own fusion must be their prefix.  Returns
    the planted row's rank in request 0's fused ranking, which must hold
    one of `planted_rows`."""
    import torch
    import repro_torch.core.graph as graph_mod
    from repro_torch.core.hybrid import rrf_fuse_batch

    def cpu(a):
        if isinstance(a, torch.Tensor):
            return a.cpu()
        return [cpu(x) for x in a] if isinstance(a, list) else a

    args, kw, got = seen["graph"]
    t0 = time.perf_counter()
    ids, scores, per_hop = graph_mod._expand_device(*map(cpu, args), **kw)
    seconds = time.perf_counter() - t0
    d_ids, d_scores, d_hops = (x.cpu() for x in got)
    if not torch.equal(ids, d_ids):
        fail(f"{what}: graph ids differ from the CPU expansion")
    if not torch.equal(scores.view(torch.int32), d_scores.view(torch.int32)):
        fail(f"{what}: graph scores differ from the CPU expansion's bits")
    if not torch.equal(per_hop, d_hops):
        fail(f"{what}: frontier sizes / edges touched differ from the CPU "
             "expansion's")
    rankings, (served, _) = seen["fused"]
    weights = seen["fuse_kw"]["weights"]
    card = rrf_fuse_batch(rankings, weights=weights, k=pool)[0].cpu()
    host = rrf_fuse_batch(cpu(list(args[8])) + [ids], weights=weights,
                          k=pool)[0]
    if not torch.equal(card, host):
        fail(f"{what}: fused ids differ from the CPU fusion of the CPU "
             "expansion")
    if not torch.equal(served.cpu(), card[:, : served.shape[1]]):
        fail(f"{what}: the execute's fusion is not the prefix of the "
             "pool-wide one")
    ranks = [i for i, r in enumerate(host[0].tolist()) if r in planted_rows]
    if not ranks:
        fail(f"{what}: no planted row {sorted(planted_rows)} in the "
             f"planted request's fused ranking of {pool}")
    return {"ids_equal": True, "score_bits_equal": True,
            "fused_ids_equal": True, "planted_rank": ranks[0],
            "expanded_rows": int((ids >= 0).sum()),
            "cpu_seconds": seconds}


def graph_plan_stats(svc, plan, reqs, reps: int) -> dict:
    """The graph plan's own stage at one batch, from `reps` traced executes
    of `reqs` after the timed runs: the `plan.graph` span's median ms and
    attributes, and the device memory an execute allocated over what was
    held before it (the allocator's peak is reset before each, so the
    caller reads the phase's peak before this)."""
    import numpy as np
    import torch
    from repro_torch.obs.telemetry import get_telemetry, walk_spans
    tel = get_telemetry()
    span_ms, transient, peak = [], 0, 0
    for _ in range(reps):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trace = tel.start_trace(op="execute")
        with tel.activate([trace]):
            svc.retrieve_batch(reqs, plan=plan)
        torch.cuda.synchronize()
        tel.finish_trace(trace)
        span = next(sp for sp in walk_spans(trace.to_dict()["root"])
                    if sp["name"] == "plan.graph")
        span_ms.append(span["duration_s"] * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated())
        transient = max(transient, torch.cuda.max_memory_allocated() - base)
    return {"span_ms_p50": float(np.median(span_ms)), "attrs": span["attrs"],
            "peak_bytes": peak, "transient_bytes": transient}


def phase_serve(device, rows: int, reps: int, templates,
                quantize: str = "none", keep: bool = False):
    """The serve phase (see the module docstring); with `keep` it returns
    (result, the service, {namespace: its questions}) for the durability
    phase, else the result."""
    import numpy as np
    import torch
    import repro_torch.core.graph as graph_mod
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
        plans["graph"] = RetrievalPlan.graph_expanded()

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
        seen["fuse_kw"] = kw
        return seen["fused"][1]

    expand_device = graph_mod._expand_device

    def spy_expand(*a, **kw):
        seen["graph"] = (a, kw, expand_device(*a, **kw))
        return seen["graph"][2]

    vi.search_batch, service_mod.rrf_fuse_batch = spy_search, spy_fuse
    vi_mod._search_device_quant = spy_quant
    graph_mod._expand_device = spy_expand
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
                # the graph plan's column lifts the namespace's non-seed
                # rows over its seeds (as in the reference): the planted
                # fact falls out of its top 10, and check_graph holds its
                # rank instead
                if (pname in ("hybrid", "dense_only")
                        and PLANTED_LINE not in out[0].text):
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
    graph_mod._expand_device = expand_device
    peaks, graph_stats = [torch.cuda.max_memory_allocated()], {}
    if not int8:
        # the B=8 graph ranking and fusion of the last timed execute against
        # the same functions on CPU copies of their inputs
        tenant = svc.store.get(PLANTED_NS)
        planted_rows = set()
        for r in np.flatnonzero(svc.store.row_namespaces() == tenant.ns_id):
            tr = tenant.triples.get(svc.store.row_tid(int(r)))
            if tr is not None and PLANTED_LINE in tr.render():
                planted_rows.add(int(r))
        graph_stats = {f"B{B}": graph_plan_stats(svc, plans["graph"],
                                                 batch(B), reps)
                       for B in (1, 8, 64)}
        graph_stats["B8"]["vs_cpu"] = check_graph(
            held["graph_B8"][1], planted_rows, svc.pool, f"{name} graph B=8")
        peaks += [st["peak_bytes"] for st in graph_stats.values()]

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
    dense_plans = [p for p in plans if p != "sparse_only"]
    if len(held) != 3 * len(dense_plans):
        fail(f"{name}: dense rankings of {sorted(held)} held, expected the "
             f"{dense_plans} plans at every B")
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
           "max_memory_allocated_bytes": max(
               peaks + [torch.cuda.max_memory_allocated()]),
           "gpu": gpu_line()}
    if not int8:
        g = svc.store.graph
        out["graph"] = {"nodes": g.n_nodes, "edges": g.n_edges,
                        "node_capacity": int(g._node_ns.shape[0]),
                        "edge_capacity": int(g._edge_src.shape[0]),
                        "row_capacity": int(g._row_sub.shape[0]),
                        "per_batch": graph_stats}
    if int8:
        out["recall_at_10"] = recall
        out["bank"] = svc.stats()["bank"]
    emit(out)
    return (out, svc, questions) if keep else out


# -- phase 5: the request scheduler, admission control and HTTP ---------------

# closed-loop clients of the scheduler phase, and the requests each client
# issues one at a time in a run: every p99 rests on 200 requests or more and
# each scheduled run spans tens of ticks (C = 64: 20 full ticks); the
# direct C = 64 run, 64 executes taken in turns a round, is kept to 384
SCHED_CLIENTS = (1, 8, 64)
SCHED_ROUNDS = {"direct": {1: 200, 8: 40, 64: 6},
                "scheduled": {1: 200, 8: 40, 64: 20}}
SCHED_TICK_S, SCHED_MAX_BATCH = 0.002, 64
# requests of a scheduled run's last tick that are also answered alone
SCHED_ALONE = 8
# a future waits at most this long: a B = 64 hybrid tick takes ~0.42 s on
# the 2**20-row store, a tier-demoted one seconds
SCHED_WAIT_S = 120.0
# admission: well-behaved closed-loop tenants beside one flooding tenant
# that submits blocks of ADMISSION_BLOCK without waiting, under a
# per-tenant backlog cap
ADMISSION_CLIENTS, ADMISSION_ROUNDS = 8, 40
ADMISSION_BLOCK, ADMISSION_CAP = 64, 128
# the policy's fair-share window (default 0.1 s) sized to a B = 64 hybrid
# tick on the card, for a second flooded run
ADMISSION_WINDOW_S = 1.0
# HTTP in process: conversations recorded over the wire by one tenant, then
# for each C in HTTP_CLIENTS, C `HttpMemory` threads of HTTP_ROUNDS[C]
# retrieves each; HTTP_PROBES single-client GETs of /v1/healthz time the
# transport alone (a connection, a handler thread, no JSON body)
HTTP_CONVS = 8
HTTP_CLIENTS = (1, 8, 64)
HTTP_ROUNDS = {1: 100, 8: 25, 64: 6}
HTTP_PROBES = 100
HTTP_KEYS = {"k-acme": "acme", "k-beta": "beta"}
# closed-loop clients (dense-only: ticks of a few ms) that keep the
# scheduler ticking through the engine's first decode step (its CUDA graph
# capture); further captures of the same step, up to CAPTURE_TRIES in all,
# until a tick's execute has run inside one
CAPTURE_CLIENTS = 8
CAPTURE_TRIES = 8
# the full-width launcher on the serving path; a burst of concurrent
# clients over its token bucket (rate 50/s, burst 100)
SERVE_LAUNCHER_ARGS = ("--tick-interval", "0.002", "--http-port", "0",
                       "--http-host", "127.0.0.1",
                       "--api-keys", "k1=acme,k2=beta",
                       "--qos-rate", "50", "--qos-burst", "100")
LAUNCHER_BURST_CLIENTS, LAUNCHER_BURST_EACH = 64, 5


def _ctx_key(payload):
    """What two answers must share: the context's text, its triples' texts
    and its token count."""
    return (payload.text, [t.text() for t in payload.triples],
            payload.token_count)


def _quantiles_ms(xs) -> dict:
    import numpy as np
    xs = np.asarray(xs, dtype=np.float64) * 1e3
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)), "max": float(xs.max())}


@contextlib.contextmanager
def uncounted():
    """Launches made inside are a check's own, not the path's: every
    wrapper's count is put back on the way out.  Only where no other
    thread launches meanwhile."""
    saved = {f: f.launches for f in wrappers().values()}
    try:
        yield
    finally:
        for f, n in saved.items():
            f.launches = n


def closed_loop(svc, sched, make_req, clients: int, rounds: int,
                tenants=None) -> dict:
    """`clients` threads, each issuing `rounds` requests one at a time:
    through `sched` (submit, then wait on the future) or, with `sched`
    None, directly (one `execute` per request, the executes taken in turns
    through one lock; the wait for it is the request's queue time).
    Returns every (client, request, response, seconds) and the wall
    time."""
    import threading
    import numpy as np
    from repro_torch.core import MemoryResponse
    barrier = threading.Barrier(clients + 1)
    records, errors = [], []
    lock, turns = threading.Lock(), threading.Lock()

    def direct(req):
        t0 = time.monotonic()
        with turns:
            t1 = time.monotonic()
            try:
                payload = svc.execute([req])[0]
            except Exception as e:
                return MemoryResponse(payload=None, op="retrieve",
                                      status="error", error=repr(e),
                                      exception=e)
            return MemoryResponse(payload=payload, op="retrieve",
                                  queued_s=t1 - t0,
                                  service_s=time.monotonic() - t1,
                                  batch_size=1,
                                  token_count=payload.token_count)

    def client(c):
        rng = np.random.default_rng(1000 + c)
        tenant = None if tenants is None else tenants(c)
        mine = []
        try:
            barrier.wait()
            for _ in range(rounds):
                req = make_req(c, rng)
                t = time.perf_counter()
                if sched is None:
                    resp = direct(req)
                else:
                    resp = sched.submit(req, tenant=tenant).result(
                        timeout=SCHED_WAIT_S)
                mine.append((c, req, resp, time.perf_counter() - t))
        except Exception as e:          # surfaced below: fails the run
            errors.append(repr(e))
        with lock:
            records.extend(mine)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"scheduler: a client failed: {errors[:3]}")
    return {"records": records, "wall": wall}


def check_answers(records, what: str) -> None:
    """Every response ok; the planted question (client 0) answered with the
    planted fact; no other client's context holds it."""
    for c, req, resp, _ in records:
        if not resp.ok:
            fail(f"{what}: request {req} failed: {resp.error}")
        text = resp.payload.text
        if c == 0 and PLANTED_LINE not in text:
            fail(f"{what}: the planted fact did not come back:\n{text}")
        if c != 0 and "(user;" in text:
            fail(f"{what}: {req.namespace}'s context holds the planted "
                 "namespace's fact")


def loop_stats(run, ticks) -> dict:
    """Requests/s, latency p50/p99, the medians of queued_s and service_s,
    and the executes' batch sizes (`ticks`), from one closed-loop run."""
    import numpy as np
    recs = run["records"]
    return {"requests": len(recs),
            "requests_per_s": len(recs) / run["wall"],
            "latency_ms": _quantiles_ms([r[3] for r in recs]),
            "queued_ms_p50": float(np.median(
                [r[2].queued_s for r in recs])) * 1e3,
            "service_ms_p50": float(np.median(
                [r[2].service_s for r in recs])) * 1e3,
            "ticks": len(ticks), "tick_batch_mean": float(np.mean(ticks)),
            "tick_batch_max": int(max(ticks))}


def phase_scheduler(device, svc, questions, src: str) -> dict:
    """The serve phase's f32 store (all rows hot) behind the request
    scheduler: closed loops direct and scheduled, admission under a flood,
    HTTP in process, a CUDA graph capture beside live ticks, and the
    full-width launcher (see the module docstring)."""
    import gc
    import threading
    import numpy as np
    import torch
    from repro_torch.core import (AdmissionError, AdmissionPolicy,
                                  RetrieveRequest, TenantPolicy)
    from repro_torch.kernels import topk_mips as tk
    t_phase = time.perf_counter()
    # the serve phase's tier cycle left half the rows warm (answered by the
    # host fallback): every row comes back to the device and the manager
    # is detached, so K1 answers every request
    vi = svc.vindex
    promoted = vi.promote_rows(np.flatnonzero(~vi.resident_mask()))
    svc.store.tiers = None
    k1 = tk.topk_mips_masked
    names = sorted(questions)
    stages = {"hybrid": None, "dense_only": ("dense", "budget")}

    def request_maker(plan):
        def make(c, rng):
            if c == 0:
                ns, q = PLANTED_NS, PLANTED_QUESTION
            else:
                ns = str(names[int(rng.integers(len(names)))])
                q = str(questions[ns][int(rng.integers(len(questions[ns])))])
            if stages[plan] is None:
                return RetrieveRequest(ns, q)
            return RetrieveRequest(ns, q, stages=stages[plan])
        return make

    # every execute's requests and payloads, for the checks of each
    # scheduled run's last tick (references only)
    executes = []
    execute = svc.execute

    def spy_execute(reqs, plan=None):
        out = execute(reqs, plan=plan)
        executes.append((list(reqs), out))
        return out

    svc.execute = spy_execute
    reset_counts()          # the phase's path: every count from 0
    runs, tick_checks = {}, {}
    for plan in stages:
        for C in SCHED_CLIENTS:
            for mode in ("direct", "scheduled"):
                key = f"{plan}_{mode}_C{C}"
                executes.clear()
                k1_before = k1.launches
                sched = (svc.start_scheduler(tick_interval_s=SCHED_TICK_S,
                                             max_batch=SCHED_MAX_BATCH)
                         if mode == "scheduled" else None)
                run = closed_loop(svc, sched, request_maker(plan), C,
                                  SCHED_ROUNDS[mode][C])
                if sched is not None:
                    st = sched.stats()
                    sched.close()
                    if sched.last_error is not None:
                        fail(f"scheduler {key}: a tick failed: "
                             f"{sched.last_error!r}")
                k1_run = k1.launches - k1_before
                check_answers(run["records"], f"scheduler {key}")
                ticks = [len(r) for r, _ in executes]
                out = loop_stats(run, ticks)
                n = len(run["records"])
                if mode == "scheduled":
                    if st["retrieves"] != n or \
                            st["retrieve_launches"] != len(ticks):
                        fail(f"scheduler {key}: {st['retrieves']} retrieves "
                             f"in {st['retrieve_launches']} launches, "
                             f"{n} requests in {len(ticks)} executes")
                    # the last tick in full as one direct execute, and
                    # SCHED_ALONE of its requests each alone (the
                    # scheduler is closed: no other thread launches)
                    reqs, payloads = executes[-1]
                    with uncounted():
                        again = execute(reqs)
                        alone = [execute([r])[0]
                                 for r in reqs[:SCHED_ALONE]]
                    for r, p, a in zip(reqs, payloads, again):
                        if _ctx_key(p) != _ctx_key(a):
                            fail(f"scheduler {key}: {r} answered in a "
                                 "tick differs from a direct execute")
                    for r, p, a in zip(reqs, payloads, alone):
                        if _ctx_key(p) != _ctx_key(a):
                            fail(f"scheduler {key}: {r} answered in a "
                                 "tick differs from the request alone")
                    tick_checks[key] = {"last_tick": len(reqs),
                                        "alone": len(alone)}
                # one K1 launch an execute, as the serve phase holds
                if k1_run != len(ticks):
                    fail(f"scheduler {key}: K1 launched {k1_run} times for "
                         f"{len(ticks)} executes")
                out["k1_launches"] = k1_run
                out["k1_per_tick"] = k1_run / len(ticks)
                runs[key] = out

    # admission: ADMISSION_CLIENTS closed-loop tenants alone, then beside a
    # tenant that floods submit_many without waiting, under the default
    # fair-share window and under one sized to the card's ticks
    cap = TenantPolicy(max_queued=ADMISSION_CAP)
    policies = {"alone": AdmissionPolicy(default=cap),
                "flooded": AdmissionPolicy(default=cap),
                "flooded_window": AdmissionPolicy(
                    default=cap, share_window_s=ADMISSION_WINDOW_S)}
    make = request_maker("hybrid")
    flood_reqs = [RetrieveRequest(str(ns), str(questions[ns][0]))
                  for ns in np.random.default_rng(5).choice(
                      [n for n in names if n.startswith("fill-")],
                      ADMISSION_BLOCK, replace=False)]
    admission = {}
    for key, policy in policies.items():
        flooded = key != "alone"
        sched = svc.start_scheduler(tick_interval_s=SCHED_TICK_S,
                                    max_batch=SCHED_MAX_BATCH,
                                    admission=policy)
        stop, flood_futs, rejected = threading.Event(), [], [0]

        def flood():
            while not stop.is_set():
                try:
                    flood_futs.extend(sched.submit_many(
                        flood_reqs, tenant="flood"))
                except AdmissionError:
                    rejected[0] += 1
                    time.sleep(0.001)      # a rejected client backs off 1 ms

        flooder = threading.Thread(target=flood)
        executes.clear()
        k1_before = k1.launches
        if flooded:
            flooder.start()
            while not flood_futs:
                time.sleep(0.001)
        run = closed_loop(svc, sched, make, ADMISSION_CLIENTS,
                          ADMISSION_ROUNDS, tenants=lambda c: f"client-{c}")
        stop.set()
        if flooded:
            flooder.join()
        flood_resps = [f.result(timeout=SCHED_WAIT_S) for f in flood_futs]
        st = sched.stats()
        sched.close()
        check_answers(run["records"], "scheduler admission")
        if not all(r.ok for r in flood_resps):
            fail("scheduler admission: an admitted flood request failed")
        k1_run = k1.launches - k1_before
        if k1_run != len(executes):
            fail(f"scheduler admission {key}: K1 launched {k1_run} times "
                 f"for {len(executes)} executes")
        admission[key] = dict(loop_stats(run, [len(r) for r, _ in executes]),
                              k1_launches=k1_run,
                              flood_admitted=len(flood_futs),
                              flood_rejected_blocks=rejected[0],
                              shed=st["admission"]["shed"])
    for key in ("flooded", "flooded_window"):
        admission[key]["p99_vs_alone"] = (
            admission[key]["latency_ms"]["p99"]
            / admission["alone"]["latency_ms"]["p99"])

    http = phase_scheduler_http(svc, execute)
    capture = capture_beside_ticks(device, svc, request_maker("dense_only"),
                                   execute)
    # the phase's path in process, read just after: ticks and direct
    # executes (the checks' own executes were made uncounted)
    launches = counts()
    del svc.execute                     # back to the class's method
    gc.collect()
    torch.cuda.empty_cache()
    launcher = serve_launcher(src)
    out = {"phase": "scheduler", "rows": svc.vindex.n,
           "promoted_rows": promoted,
           "tick_interval_s": SCHED_TICK_S, "max_batch": SCHED_MAX_BATCH,
           "closed_loop": runs, "checked_ticks": tick_checks,
           "launches": launches, "admission": admission, "http": http,
           "capture": capture, "launcher": launcher,
           "seconds": time.perf_counter() - t_phase, "gpu": gpu_line()}
    emit(out)
    return out


def phase_scheduler_http(svc, execute) -> dict:
    """A MemoryFrontend over the scheduled service: HTTP_CONVS conversations
    recorded over the wire by tenant acme (the planted fact in c0); the
    transport alone (HTTP_PROBES single-client GETs of /v1/healthz); then
    for each C in HTTP_CLIENTS, C `HttpMemory` threads of HTTP_ROUNDS[C]
    retrieves each, and one NDJSON streaming batch, every answer equal to
    the direct path's; the second key sees nothing of acme's; /v1/metrics
    and /v1/stats parse.  Each retrieve's time in the frontend's handler
    (`_dispatch`, keyed by request id) splits its host overhead into the
    handler's own work and the client's with the transport.  `execute`
    is the service's own (unspied) execute."""
    import threading
    import urllib.request
    import numpy as np
    from repro_torch.core import HttpMemory, Message, RetrieveRequest
    from repro_torch.data.locomo_synth import generate_conversation
    from repro_torch.kernels import topk_mips as tk
    from repro_torch.serving.frontend import MemoryFrontend
    k1 = tk.topk_mips_masked
    sched = svc.start_scheduler(tick_interval_s=SCHED_TICK_S,
                                max_batch=SCHED_MAX_BATCH)
    fe = MemoryFrontend(svc, HTTP_KEYS).start()
    runs, handled = {}, {}
    dispatch = fe._dispatch

    def timed_dispatch(handler, method):
        t = time.perf_counter()
        try:
            return dispatch(handler, method)
        finally:
            if handler.path == "/v1/retrieve":
                handled[handler.memori_request_id] = time.perf_counter() - t

    fe._dispatch = timed_dispatch
    try:
        convs = {}
        t0 = time.perf_counter()
        for i in range(HTTP_CONVS):
            conv = generate_conversation(seed=40_000 + i)
            mem = HttpMemory(fe.address, "k-acme", namespace=f"c{i}")
            for sid, msgs in conv.sessions:
                mem.record_session(conv.conversation_id, sid, msgs)
            convs[f"c{i}"] = [qq.question for qq in conv.questions]
        HttpMemory(fe.address, "k-acme", namespace="c0").record_session(
            "c0", "s-planted",
            [Message("user", PLANTED_TEXT, conv.sessions[-1][1][0].timestamp)])
        record_s = time.perf_counter() - t0
        probes = []
        for _ in range(HTTP_PROBES):
            t = time.perf_counter()
            _http_get(fe.address + "/v1/healthz", "k-acme")
            probes.append(time.perf_counter() - t)
        got = []
        for C in HTTP_CLIENTS:
            k1_before = k1.launches
            st0 = sched.stats()
            mine_all, errors = [], []
            barrier = threading.Barrier(C + 1)

            def client(c):
                rng = np.random.default_rng(2000 + c)
                ns = f"c{c % HTTP_CONVS}"
                mem = HttpMemory(fe.address, "k-acme", namespace=ns)
                mine = []
                try:
                    barrier.wait()
                    for _ in range(HTTP_ROUNDS[C]):
                        q = (PLANTED_QUESTION if c == 0 else
                             convs[ns][int(rng.integers(len(convs[ns])))])
                        t = time.perf_counter()
                        ctx = mem.retrieve(q)
                        mine.append((ns, q, ctx, time.perf_counter() - t,
                                     dict(mem.last_timing)))
                except Exception as e:
                    errors.append(repr(e))
                mine_all.extend(mine)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(C)]
            for t in threads:
                t.start()
            barrier.wait()
            t0 = time.perf_counter()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            if errors:
                fail(f"scheduler http C={C}: a client failed: {errors[:3]}")
            st1 = sched.stats()
            k1_run = k1.launches - k1_before
            ticks = st1["retrieve_launches"] - st0["retrieve_launches"]
            if k1_run != ticks or \
                    st1["retrieves"] - st0["retrieves"] != len(mine_all):
                fail(f"scheduler http C={C}: K1 launched {k1_run} times in "
                     f"{ticks} retrieve ticks for {len(mine_all)} requests")
            lat = np.asarray([g[3] for g in mine_all])
            server = np.asarray([g[4]["queued_s"] + g[4]["service_s"]
                                 for g in mine_all])
            handler = np.asarray([handled[g[4]["request_id"]]
                                  for g in mine_all])
            runs[f"C{C}"] = {
                "requests": len(mine_all),
                "requests_per_s": len(mine_all) / wall,
                "latency_ms": _quantiles_ms(lat),
                "server_ms_p50": float(np.median(server)) * 1e3,
                "http_overhead_ms": _quantiles_ms(lat - server),
                "handler_own_ms": _quantiles_ms(handler - server),
                "client_and_transport_ms": _quantiles_ms(lat - handler),
                "ticks": ticks, "k1_launches": k1_run}
            got.extend(mine_all)
        # one NDJSON streaming batch across acme's namespaces
        stream_q = [(f"c{i}", convs[f"c{i}"][0]) for i in range(HTTP_CONVS)]
        body = {"stream": True, "queries": [{"namespace": ns, "query": q}
                                            for ns, q in stream_q]}
        req = urllib.request.Request(
            fe.address + "/v1/retrieve", data=json.dumps(body).encode(),
            headers={"Authorization": "Bearer k-acme"})
        with urllib.request.urlopen(req, timeout=SCHED_WAIT_S) as r:
            events = [json.loads(ln) for ln in r.read().decode().splitlines()
                      if ln.strip()]
        results = {e["index"]: e["response"] for e in events
                   if e["event"] == "result"}
        if events[-1] != {"event": "done", "count": HTTP_CONVS,
                          "errors": 0} or len(results) != HTTP_CONVS:
            fail(f"scheduler http: the streamed batch ended {events[-1]}")
        # every answer against the direct path on the same requests (no
        # request in flight: the ticks launch nothing meanwhile)
        pairs = sorted({(ns, q) for ns, q, _, _, _ in got} | set(stream_q))
        want = {}
        with uncounted():
            for i in range(0, len(pairs), SCHED_MAX_BATCH):
                chunk = pairs[i: i + SCHED_MAX_BATCH]
                for p, a in zip(chunk, execute(
                        [RetrieveRequest(f"acme/{ns}", q)
                         for ns, q in chunk])):
                    want[p] = a
        for ns, q, ctx, _, _ in got:
            if _ctx_key(ctx) != _ctx_key(want[(ns, q)]):
                fail(f"scheduler http: acme/{ns} {q!r} over HTTP differs "
                     "from the direct path")
            if ns == "c0" and q == PLANTED_QUESTION \
                    and PLANTED_LINE not in ctx.text:
                fail("scheduler http: the planted fact did not come back")
        for i, (ns, q) in enumerate(stream_q):
            pay = results[i]["payload"]
            if (pay["text"], pay["token_count"]) != (
                    want[(ns, q)].text, want[(ns, q)].token_count):
                fail(f"scheduler http: streamed acme/{ns} differs")
        beta = HttpMemory(fe.address, "k-beta", namespace="c0").retrieve(
            PLANTED_QUESTION)
        if beta.triples or "(user;" in beta.text:
            fail("scheduler http: the second key saw acme's memories")
        stats = json.loads(_http_get(fe.address + "/v1/stats", "k-acme"))
        metrics = {}
        for ln in _http_get(fe.address + "/v1/metrics",
                            "k-acme").splitlines():
            if ln and not ln.startswith("#"):
                name, value = ln.rsplit(" ", 1)
                metrics[name] = float(value)
        if metrics.get("memori_scheduler_retrieves") is None or \
                stats["scheduler"]["retrieves"] < len(got):
            fail("scheduler http: /v1/metrics or /v1/stats lack the "
                 "scheduler's retrieves")
    finally:
        fe.close()
        sched.close()
    return {"record_seconds": record_s,
            "healthz_ms": _quantiles_ms(probes), "runs": runs,
            "streamed": len(results), "metrics_samples": len(metrics)}


def _http_get(url: str, key: str) -> str:
    import urllib.request
    req = urllib.request.Request(url,
                                 headers={"Authorization": f"Bearer {key}"})
    with urllib.request.urlopen(req, timeout=SCHED_WAIT_S) as r:
        return r.read().decode()


def capture_beside_ticks(device, svc, make, execute) -> dict:
    """A fresh full-width engine takes its first decode step (the CUDA
    graph capture, in the engine's thread-local mode) while
    CAPTURE_CLIENTS closed-loop clients keep a scheduler on the same
    service ticking; further captures of the same step follow, up to
    CAPTURE_TRIES in all, until a tick's execute has run inside one.
    Every response ok; each execute that overlapped a capture equal to its
    requests executed again afterwards (`execute`, the service's own); the
    last captured step replayed equal to an eager one (as the lm phase
    holds it)."""
    import threading
    import numpy as np
    import torch
    import repro_torch.serving.engine as engine_mod
    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.kernels import topk_mips as tk
    from repro_torch.models.model_api import Model
    from repro_torch.serving.requests import Request
    cfg = get_config("memori-agent")
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    tok = HashTokenizer(cfg.vocab_size)
    engine = engine_mod.Engine(model, params, max_len=LM_MAX_LEN,
                               slots=LM_SLOTS, tokenizer=tok)
    prompts = lm_prompts(tok, LM_SLOTS)
    sched = svc.start_scheduler(tick_interval_s=SCHED_TICK_S,
                                max_batch=SCHED_MAX_BATCH)
    k1 = tk.topk_mips_masked
    k1_before = k1.launches
    # each capture proper (begin to end) and its mode; each tick's execute
    windows, spans = [], []
    cuda_graph, inner = torch.cuda.graph, svc.execute

    class TimedCapture(cuda_graph):
        def __enter__(self):
            out = super().__enter__()
            windows.append([time.monotonic(), None,
                            getattr(self, "capture_error_mode", None)])
            return out

        def __exit__(self, *exc):
            windows[-1][1] = time.monotonic()
            return super().__exit__(*exc)

    def timed(reqs, plan=None):
        t0 = time.monotonic()
        out = inner(reqs, plan=plan)
        spans.append((t0, time.monotonic(), list(reqs), out))
        return out

    def inside():
        return [sp for sp in spans
                if any(sp[0] < w[1] and sp[1] > w[0] for w in windows)]

    stop, resps, errors = threading.Event(), [], []

    def client(c):
        rng = np.random.default_rng(3000 + c)
        try:
            while not stop.is_set():
                resps.append((c, sched.submit(make(c, rng)).result(
                    timeout=SCHED_WAIT_S)))
        except Exception as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CAPTURE_CLIENTS)]
    torch.cuda.graph, svc.execute = TimedCapture, timed
    try:
        for t in threads:
            t.start()
        while sched.stats()["ticks"] < 2:
            time.sleep(0.01)
        got, wall, _, _ = greedy_run(engine, [
            Request(tok.encode(p), LM_NEW_TOKENS) for p in prompts])
        while not inside() and len(windows) < CAPTURE_TRIES:
            engine.graph = engine_mod.CountedGraph(engine.decode)
        time.sleep(0.2)                 # more ticks after the captures
    finally:
        stop.set()
        for t in threads:
            t.join()
        torch.cuda.graph, svc.execute = cuda_graph, inner
    ticks = sched.stats()["ticks"]
    sched.close()
    # K1 once a tick's execute: a launch during a capture is the tick's,
    # neither lost nor replayed with the decode graph
    k1_run = k1.launches - k1_before
    if errors:
        fail(f"scheduler capture: a client failed: {errors[:3]}")
    if k1_run != len(spans):
        fail(f"scheduler capture: K1 launched {k1_run} times for "
             f"{len(spans)} executes")
    if engine.graph is None or not windows:
        fail("scheduler capture: the engine captured no decode graph")
    for c, resp in resps:
        if not resp.ok:
            fail(f"scheduler capture: a retrieve failed: {resp.error}")
        if c == 0 and PLANTED_LINE not in resp.payload.text:
            fail("scheduler capture: the planted fact did not come back")
    during = inside()
    if not during:
        fail(f"scheduler capture: no tick ran inside any of {len(windows)} "
             "captures")
    if not any(sp[0] > windows[-1][1] for sp in spans):
        fail("scheduler capture: no tick after the captures")
    with uncounted():                   # the scheduler is closed
        for _, _, reqs, payloads in during:
            for r, p, a in zip(reqs, payloads, execute(reqs)):
                if _ctx_key(p) != _ctx_key(a):
                    fail(f"scheduler capture: {r} answered inside a "
                         "capture differs from a direct execute")
    if not all(r.tokens for r in got):
        fail("scheduler capture: a request generated nothing")
    with uncounted():
        err = replay_vs_eager(engine, tok, prompts)
    if not err <= LOGIT_TOL:
        fail(f"scheduler capture: replayed decode graph vs eager "
             f"decode_step differ by {err} > {LOGIT_TOL}")
    out = {"captures": len(windows),
           "capture_ms": [(w[1] - w[0]) * 1e3 for w in windows],
           "capture_error_mode": windows[0][2],
           "executes_inside": len(during),
           "requests_inside": sum(len(sp[2]) for sp in during),
           "retrieves": len(resps), "ticks": ticks,
           "executes": len(spans), "k1_launches": k1_run,
           "generate_wall_s": wall, "replay_vs_eager": err}
    del engine, params, model
    return out


def serve_launcher(src: str) -> dict:
    """`python -m repro_torch.launch.serve` on the serving path at full
    width (SERVE_LAUNCHER_ARGS and a snapshot directory): it prints its
    address; acme records and retrieves through `HttpMemory`, the second
    key sees nothing of it; a burst of concurrent clients over the token
    bucket gets 429s with Retry-After; SIGTERM exits 0 with a final
    snapshot, and a second boot on the directory answers the same."""
    import queue
    import shutil
    import signal
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    from repro_torch.core import HttpMemory, Message
    workdir = tempfile.mkdtemp(prefix="memori-serve-")
    d = os.path.join(workdir, "memori.d")
    env = dict(os.environ, PYTHONPATH=src)

    def boot():
        t = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve",
             *SERVE_LAUNCHER_ARGS, "--snapshot-path", d],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)
        lines = queue.Queue()

        def pump():
            for ln in proc.stdout:
                lines.put(ln)
            lines.put(None)

        threading.Thread(target=pump, daemon=True).start()
        while True:
            try:
                ln = lines.get(timeout=300)
            except queue.Empty:
                ln = None
            if ln is None:
                proc.kill()
                fail(f"scheduler launcher: no address:\n"
                     f"{proc.stderr.read()[-3000:]}")
            if ln.startswith("memory layer serving on "):
                return proc, lines, ln.split()[4], time.perf_counter() - t

    def stop(proc, lines):
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            fail("scheduler launcher: no exit after SIGTERM")
        rest = []
        while (ln := lines.get(timeout=60)) is not None:
            rest.append(ln)
        if rc != 0 or f"final snapshot rotation -> {d}\n" not in rest:
            fail(f"scheduler launcher exited {rc}: {rest[-5:]}\n"
                 f"{proc.stderr.read()[-3000:]}")

    def post(addr):
        req = urllib.request.Request(
            addr + "/v1/retrieve",
            data=json.dumps({"namespace": "conv0",
                             "query": PLANTED_QUESTION}).encode(),
            headers={"Authorization": "Bearer k1"})
        try:
            with urllib.request.urlopen(req, timeout=SCHED_WAIT_S) as r:
                return r.status, json.loads(r.read().decode()), None
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode()), \
                e.headers.get("Retry-After")

    try:
        proc, lines, addr, boot_s = boot()
        try:
            acme = HttpMemory(addr, "k1", namespace="conv0")
            acme.record_session("conv0", "s0",
                                [Message("user", PLANTED_TEXT, 1.7e9)])
            first = acme.retrieve(PLANTED_QUESTION)
            if PLANTED_LINE not in first.text:
                fail(f"scheduler launcher: the planted fact did not come "
                     f"back:\n{first.text}")
            beta = HttpMemory(addr, "k2", namespace="conv0").retrieve(
                PLANTED_QUESTION)
            if beta.triples:
                fail("scheduler launcher: the second key saw acme's facts")
            codes, bad = [], []

            def burst():
                for _ in range(LAUNCHER_BURST_EACH):
                    st, body, retry = post(addr)
                    codes.append(st)
                    if st == 429 and not (retry and int(retry) >= 1
                                          and body["reason"]
                                          == "rate_limited"):
                        bad.append((st, body, retry))
                    elif st not in (200, 429) or (
                            st == 200 and body["status"] != "ok"):
                        bad.append((st, body, retry))

            threads = [threading.Thread(target=burst)
                       for _ in range(LAUNCHER_BURST_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            burst_s = time.perf_counter() - t0
            if bad or 429 not in codes:
                fail(f"scheduler launcher: burst answered {bad[:3]}, "
                     f"{codes.count(429)} of {len(codes)} were 429")
        finally:
            stop(proc, lines)
        proc, lines, addr, boot2_s = boot()
        try:
            again = HttpMemory(addr, "k1", namespace="conv0").retrieve(
                PLANTED_QUESTION)
        finally:
            stop(proc, lines)
        if _ctx_key(again) != _ctx_key(first):
            fail("scheduler launcher: the second boot answers differently")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"boot_seconds": boot_s, "second_boot_seconds": boot2_s,
            "burst_requests": len(codes), "burst_429": codes.count(429),
            "burst_seconds": burst_s}


# -- phase 6: durability -------------------------------------------------------

# conversations journaled one segment each after the baseline; group
# commits and the conversations in each; the recovered batch's size
N_WAL_CONVS = 64
N_GROUPS, GROUP_CONVS = 8, 2
DURABLE_B = 64
# the launcher's flags beside --snapshot-path (the background flusher on)
LAUNCHER_ARGS = ("--flush-interval", "0.2")

# the kill -9 writer: the reference test's script shape on the card
# (tests/test_lifecycle.py), six users, one rotation at the second flush
CRASH_CHILD = r"""
import hashlib, json, os, sys, time
import numpy as np
import torch
from repro_torch.core import HashEmbedder, MemoryService, Message

d = sys.argv[1]
dev = torch.device("cuda", 0)
svc = MemoryService(HashEmbedder(device=dev), device=dev,
                    data_dir=os.path.join(d, "data"))
cities = ["Tallinn", "Porto", "Cusco", "Oslo", "Quito", "Hanoi"]
for i, city in enumerate(cities):
    ns = "u%d/c0" % i
    svc.enqueue(ns, "s0", [
        Message("U", "I live in %s." % city, 1700000000.0),
        Message("U", "I adopted a gecko named G%d." % i, 1700000000.0)])
    svc.flush()                     # durability point: WAL segment on disk
    if i == 1:
        svc.rotate()                # one mid-stream snapshot generation
    queries = [("u%d/c0" % j, "Which city does the user live in?")
               for j in range(i + 1)]
    texts = [c.text for c in svc.retrieve_batch(queries)]
    bank = np.ascontiguousarray(svc.vindex.bank)
    exp = {"n": i + 1, "texts": texts, "bank_rows": int(bank.shape[0]),
           "bank_sha": hashlib.sha256(bank.tobytes()).hexdigest(),
           "modules": sorted(m for m in ("jax", "msgpack", "repro")
                             if m in sys.modules)}
    tmp = os.path.join(d, "expected.json.tmp")
    with open(tmp, "w") as f:
        json.dump(exp, f); f.flush(); os.fsync(f.fileno())
    os.replace(tmp, os.path.join(d, "expected.json"))
    print("FLUSHED %d" % (i + 1), flush=True)
print("DONE", flush=True)
time.sleep(120)
"""


class StageClock:
    """Seconds spent inside patched functions, by stage name, while
    installed.  `key(stack)` may name a call by the stages it runs inside
    (the stack of enclosing patched calls)."""

    def __init__(self):
        import collections
        self.seconds = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self.stack = []
        self._undo = []

    def wrap(self, owner, attr, key):
        real = owner.__dict__[attr] if isinstance(owner, type) \
            else getattr(owner, attr)
        is_cm = isinstance(real, classmethod)
        fn = real.__func__ if is_cm else real
        name_of = key if callable(key) else (lambda stack, _k=key: _k)

        def timed(*a, **kw):
            name = name_of(self.stack)
            self.stack.append(name)
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds[name] += time.perf_counter() - t
                self.calls[name] += 1
                self.stack.pop()

        setattr(owner, attr, classmethod(timed) if is_cm else timed)
        self._undo.append((owner, attr, real))

    def undo(self) -> None:
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo.clear()


def fsync_histogram():
    """(per-bucket counts, sum) of memori_fsync_latency_seconds so far."""
    from repro_torch.obs.telemetry import FSYNC_LATENCY, get_telemetry
    return get_telemetry().histogram(FSYNC_LATENCY).snapshot()


def fsync_stats(before) -> dict:
    """The fsync latency histogram's observations since `before`: count,
    mean and the bucket upper bounds that hold the p50 and p99."""
    import numpy as np
    from repro_torch.obs.telemetry import FSYNC_LATENCY, get_telemetry
    hist = get_telemetry().histogram(FSYNC_LATENCY)
    counts, total = hist.snapshot()
    counts, total = counts - before[0], total - before[1]
    n = int(counts.sum())
    bounds = list(hist.buckets) + [float("inf")]
    cum = np.cumsum(counts)

    def upper(q):
        return bounds[int(np.searchsorted(cum, q * n))] if n else None

    return {"count": n, "mean_ms": total / n * 1e3 if n else None,
            "p50_le_ms": None if not n else upper(0.5) * 1e3,
            "p99_le_ms": None if not n else upper(0.99) * 1e3}


def _ms_quantiles(xs) -> dict:
    import numpy as np
    xs = np.asarray(xs) * 1e3
    return {"n": int(xs.size), "p50_ms": float(np.percentile(xs, 50)),
            "p99_ms": float(np.percentile(xs, 99)), "max_ms": float(xs.max())}


def sha(a) -> str:
    import hashlib
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def durable_answers(svc, reqs, reps: int):
    """One B = len(reqs) hybrid execute kept for the checks (contexts, token
    counts, the dense ranking its K1 search returned) and the host-clock
    p50 of `reps` more, each ending in a synchronize; (answers, the first
    execute's ms, the p50 ms)."""
    import numpy as np
    import torch
    from repro_torch.core import RetrievalPlan
    plan, vi, seen = RetrievalPlan.hybrid(), svc.vindex, {}
    search = vi.search_batch

    def spy(*a, **kw):
        seen["dense"] = search(*a, **kw)
        return seen["dense"]

    vi.search_batch = spy
    try:
        t = time.perf_counter()
        out = svc.retrieve_batch(reqs, plan=plan)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t) * 1e3
        got = {"texts": [o.text for o in out],
               "tokens": [o.token_count for o in out],
               "dense_ids": seen["dense"][1].cpu().numpy().copy()}
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            svc.retrieve_batch(reqs, plan=plan)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
    finally:
        del vi.search_batch
    return got, first, float(np.median(times)) * 1e3


def crash_case(device, src: str, workdir: str) -> dict:
    """kill -9 on the card: a child process journals six users on `cuda`
    (one rotation at the second flush), is SIGKILLed after >= 4 durable
    flushes, and the recovery here must answer and hold the bank exactly
    as the child last wrote to expected.json."""
    import json
    from repro_torch.core import HashEmbedder, MemoryService
    env = dict(os.environ, PYTHONPATH=src)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", CRASH_CHILD, workdir],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    killed_at = None
    try:
        deadline = time.time() + 300
        for line in iter(proc.stdout.readline, ""):
            if line.startswith("FLUSHED") and int(line.split()[1]) >= 4:
                proc.kill()              # SIGKILL: no atexit, no snapshot
                killed_at = int(line.split()[1])
                break
            if time.time() > deadline:
                break
    finally:
        if killed_at is None:
            proc.kill()
        proc.wait(timeout=60)
    if killed_at is None:
        fail(f"durability kill -9: the writer never reached 4 flushes:\n"
             f"{proc.stderr.read()[-3000:]}")
    t_child = time.perf_counter() - t0
    with open(os.path.join(workdir, "expected.json")) as f:
        exp = json.load(f)
    if exp["n"] < 4 or exp["modules"]:
        fail(f"durability kill -9: expected.json {exp}")
    t0 = time.perf_counter()
    rec = MemoryService.recover(os.path.join(workdir, "data"),
                                HashEmbedder(device=device), device=device,
                                budget=1300)
    queries = [(f"u{j}/c0", "Which city does the user live in?")
               for j in range(exp["n"])]
    texts = [c.text for c in rec.retrieve_batch(queries)]
    t_recover = time.perf_counter() - t0
    bank = rec.vindex.bank[: exp["bank_rows"]]
    dev_bank = rec.vindex._bank_dev[: exp["bank_rows"]].cpu().numpy()
    if texts != exp["texts"]:
        fail(f"durability kill -9: recovered texts differ:\n{texts}\n"
             f"{exp['texts']}")
    if not (sha(bank) == sha(dev_bank) == exp["bank_sha"]):
        fail("durability kill -9: the recovered bank's SHA-256 differs")
    return {"flushes_before_kill": killed_at, "durable_flushes": exp["n"],
            "child_seconds": t_child, "recover_seconds": t_recover,
            "texts_equal": len(texts), "bank_rows": exp["bank_rows"],
            "bank_sha256_equal": True}


def launcher_twice(src: str, workdir: str) -> dict:
    """`python -m repro_torch.launch.serve --snapshot-path D
    --flush-interval 0.2` (full-width memori-agent on cuda) twice on one
    directory: both exit 0 and the second boots into the first's final
    state."""
    import ast
    d = os.path.join(workdir, "memori.d")
    env = dict(os.environ, PYTHONPATH=src)

    def run():
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                            "--snapshot-path", d, *LAUNCHER_ARGS],
                           capture_output=True, text=True, env=env, cwd=ROOT,
                           timeout=600)
        if p.returncode != 0:
            fail(f"durability launcher exited {p.returncode}:\n"
                 f"{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
        return p.stdout, time.perf_counter() - t

    def stats_after(stdout, prefix):
        for ln in stdout.splitlines():
            if ln.startswith(prefix):
                return ast.literal_eval(ln[ln.index("{"):])
        fail(f"durability launcher: no line starting {prefix!r}:\n"
             f"{stdout[-2000:]}")

    out1, t1 = run()
    final = stats_after(out1, "service:")
    out2, t2 = run()
    boot = stats_after(out2, f"recovered memory store from {d}")
    keys = ("namespaces", "bank_rows", "per_namespace")
    if final["bank_rows"] < 1 or any(boot[k] != final[k] for k in keys):
        fail(f"durability launcher: the second boot recovered "
             f"{[boot[k] for k in keys]}, the first run ended with "
             f"{[final[k] for k in keys]}")
    return {"first_run_seconds": t1, "second_run_seconds": t2,
            "recovered": {k: final[k] for k in keys},
            "second_run_final_rows": stats_after(out2, "service:")[
                "bank_rows"]}


def phase_durability(device, svc, questions, reps: int, src: str) -> dict:
    """The serve phase's f32 store made durable, crashed and recovered on
    the card; then the kill -9 case and the launcher twice."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import repro_torch.checkpoint.io as ckpt_io
    import repro_torch.checkpoint.packing as packing
    import repro_torch.checkpoint.wal as wal_mod
    from repro_torch.core import (HashEmbedder, LifecyclePolicy,
                                  LifecycleRuntime, MemoryService)
    from repro_torch.core.store import MemoryStore
    from repro_torch.data.locomo_synth import generate_conversation

    # the serve phase's tier cycle left half the rows warm: every row comes
    # back to the device and the manager is detached (a recovered store is
    # all hot), so both stores answer from K1
    vi = svc.vindex
    promoted = vi.promote_rows(np.flatnonzero(~vi.resident_mask()))
    svc.store.tiers = None
    work = tempfile.mkdtemp(prefix="memori-durability-")
    try:
        data = os.path.join(work, "data")
        # 1. mount: the baseline generation of the populated store
        fs_before = fsync_histogram()
        clock = StageClock()
        clock.wrap(packing, "packb", "pack")
        clock.wrap(wal_mod, "atomic_write_bytes",
                   lambda stack: "manifest" if "manifest_total" in stack
                   else "write_fsync")
        clock.wrap(wal_mod.WriteAheadLog, "write_manifest", "manifest_total")
        clock.wrap(MemoryStore, "snapshot", "snapshot_total")
        t0 = time.perf_counter()
        try:
            rt = LifecycleRuntime(svc.store, data_dir=data, start=False)
        finally:
            clock.undo()
        t_mount = time.perf_counter() - t0
        snaps = rt.wal.snapshots()
        if [s for s, _ in snaps] != [0]:
            fail(f"durability: mounting wrote generations {snaps}, "
                 "expected the baseline snapshot-00000000")
        s = clock.seconds
        baseline = {
            "seconds": t_mount, "bytes": os.path.getsize(snaps[0][1]),
            "rows": vi.n, "namespaces": len(svc.store.namespaces()),
            "pack_seconds": s["pack"],
            "meta_build_seconds": s["snapshot_total"] - s["pack"]
            - s["write_fsync"],
            "write_fsync_seconds": s["write_fsync"],
            "manifest_seconds": s["manifest_total"],
            "rest_seconds": t_mount - s["snapshot_total"]
            - s["manifest_total"]}
        live = MemoryService(runtime=rt, budget=1300)

        # 2. journal: N_WAL_CONVS conversations one segment each, group
        # commits, a link, both evictions and a compaction
        appends, group_appends = [], []
        sink = rt.store.wal_sink

        def timed_sink(rec):
            t = time.perf_counter()
            out = sink(rec)
            appends.append((rec["op"], time.perf_counter() - t))
            return out

        rt.store.wal_sink = timed_sink
        append_group = rt.wal.append_group

        def timed_group(recs):
            t = time.perf_counter()
            out = append_group(recs)
            group_appends.append((len(recs), time.perf_counter() - t))
            return out

        rt.wal.append_group = timed_group
        wal_qs = {}

        def record(ns, seed):
            conv = generate_conversation(seed=seed)
            for sid, msgs in conv.sessions:
                live.enqueue(ns, sid, msgs)
            wal_qs[ns] = [qq.question for qq in conv.questions]

        t0 = time.perf_counter()
        for i in range(N_WAL_CONVS):
            record(f"wal-{i}", 30_000 + i)
            live.flush()
        t_single = time.perf_counter() - t0
        t0 = time.perf_counter()
        for g in range(N_GROUPS):
            with rt.group_commit():
                for j in range(GROUP_CONVS):
                    record(f"group-{g}-{j}", 40_000 + GROUP_CONVS * g + j)
                    live.flush()
                t = live.store.get(f"group-{g}-0").triples.get(0)
                live.store.link(f"group-{g}-0", t.subject, t.object,
                                "entity", 0.5)
        t_groups = time.perf_counter() - t0
        first = live.store.get("wal-0").triples.get(0)
        live.store.link("wal-0", first.subject, "cusco", "causal", 0.75)
        evicted_ns = "wal-1"
        evicted_rows = live.evict(evicted_ns)
        sup_ns = next((ns for ns in wal_qs if ns != evicted_ns
                       and live.store.get(ns).triples.superseded_ids()),
                      None)
        if sup_ns is None:
            fail("durability: no journaled conversation has superseded "
                 "triples to evict")
        superseded = live.evict_superseded(sup_ns)
        t0 = time.perf_counter()
        compacted = live.compact()
        t_compact = time.perf_counter() - t0
        ops = [op for op, _ in appends]
        want_ops = (["flush"] * N_WAL_CONVS + ["graph_edge", "evict_ns",
                                               "evict_superseded", "compact"])
        if ops != want_ops or len(group_appends) != N_GROUPS:
            fail(f"durability: journaled {ops} and {len(group_appends)} "
                 "groups")
        segs = rt.wal.segment_seqs()

        # 3. the answers of a B = 64 hybrid batch over both eras
        rng = np.random.default_rng(7)
        old = [n for n in questions if n != PLANTED_NS]
        new = [n for n in wal_qs if n not in (evicted_ns, sup_ns)]
        n_new = min(len(new), DURABLE_B - 25)       # the rest snapshot-era
        names = ([PLANTED_NS, evicted_ns, sup_ns]
                 + list(rng.choice(old, DURABLE_B - 3 - n_new, replace=False))
                 + list(rng.choice(new, n_new, replace=False)))
        reqs = [(PLANTED_NS, PLANTED_QUESTION)] + [
            (str(n), str(rng.choice({**questions, **wal_qs}[n])))
            for n in names[1:]]
        want, _, live_p50 = durable_answers(live, reqs, reps)
        if PLANTED_LINE not in want["texts"][0]:
            fail(f"durability: the planted fact did not come back:\n"
                 f"{want['texts'][0]}")
        n = vi.n
        live_sha = sha(vi.bank)
        if sha(vi._bank_dev[:n].cpu().numpy()) != live_sha:
            fail("durability: the live device bank differs from its mirror")

        # 4. crash: the live service is dropped without close() — no final
        # snapshot, no flush; the directory is what the WAL made durable
        del live, rt

        # 5. recover on the card, split into its stages
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        clock = StageClock()
        clock.wrap(ckpt_io, "load_raw", "load_raw")
        clock.wrap(packing, "unpackb",
                   lambda stack: {"load_raw": "decode_snapshot",
                                  "from_arrays": "decode_meta"}.get(
                                      stack[-1] if stack else "",
                                      "decode_wal"))
        clock.wrap(MemoryStore, "from_arrays", "from_arrays")
        clock.wrap(MemoryStore, "apply_wal", "apply_wal")
        compact_replay = []
        apply_wal = MemoryStore.apply_wal

        def timed_apply(store, record):
            t = time.perf_counter()
            try:
                return apply_wal(store, record)
            finally:
                if record["op"] == "compact":
                    compact_replay.append(time.perf_counter() - t)

        MemoryStore.apply_wal = timed_apply
        t0 = time.perf_counter()
        try:
            # one retained generation, so the rotation below truncates
            rec = MemoryService.recover(
                data, HashEmbedder(device=device), device=device,
                policy=LifecyclePolicy(snapshot_retain=1), budget=1300)
            torch.cuda.synchronize()
        finally:
            MemoryStore.apply_wal = apply_wal
            clock.undo()
        t_recover = time.perf_counter() - t0
        s = clock.seconds
        recovery = {
            "seconds": t_recover,
            "read_and_copy_seconds": s["load_raw"] - s["decode_snapshot"],
            "decode_seconds": s["decode_snapshot"] + s["decode_meta"],
            "decode_snapshot_arrays_seconds": s["decode_snapshot"],
            "decode_meta_seconds": s["decode_meta"],
            "from_arrays_seconds": s["from_arrays"] - s["decode_meta"],
            "replay_seconds": t_recover - s["load_raw"] - s["from_arrays"],
            "replay_apply_seconds": s["apply_wal"],
            "replay_decode_seconds": s["decode_wal"],
            "replayed_records": clock.calls["apply_wal"],
            "compact_replay_seconds": sum(compact_replay),
            "peak_device_bytes_over_held": torch.cuda.max_memory_allocated()
            - held}
        # the replay appends to the host mirror; the bank goes up whole on
        # the first search (reported as the first recovered execute)
        recovery["bank_on_device_after_recover"] = \
            rec.vindex._bank_dev is not None

        # 6. the same answers and the same bank bytes; 7. K1 launched
        reset_counts()
        got, first_ms, rec_p50 = durable_answers(rec, reqs, reps)
        launches = counts()
        # with the bank's upload on the first search and the executes' own
        # temporaries
        recovery["peak_device_bytes_over_held_with_executes"] = \
            torch.cuda.max_memory_allocated() - held
        if launches["topk_mips_masked"] < 1:
            fail(f"durability: K1 was not launched by the recovered "
                 f"executes: {launches}")
        if any(v for k, v in launches.items() if k != "topk_mips_masked"):
            fail(f"durability: other kernels launched: {launches}")
        for key in ("texts", "tokens"):
            if got[key] != want[key]:
                bad = [i for i, (a, b) in enumerate(zip(got[key], want[key]))
                       if a != b]
                fail(f"durability: recovered {key} differ at requests {bad}")
        if not np.array_equal(got["dense_ids"], want["dense_ids"]):
            fail("durability: the recovered dense ranking differs")
        rv = rec.vindex
        shas = {"live_mirror": live_sha, "recovered_mirror": sha(rv.bank),
                "recovered_device": sha(rv._bank_dev[: rv.n].cpu().numpy())}
        if rv.n != n or len(set(shas.values())) != 1:
            fail(f"durability: bank rows {rv.n} vs {n}, SHA-256 {shas}")

        # rotation of the recovered directory
        before = rec.runtime.wal.segment_seqs()
        t0 = time.perf_counter()
        rot = rec.rotate()
        t_rotate = time.perf_counter() - t0
        after = rec.runtime.wal.segment_seqs()
        rotation = {"seconds": t_rotate, "bytes": rot["bytes"],
                    "wal_through": rot["wal_through"],
                    "truncated_segments": sorted(set(before) - set(after)),
                    "kept_segments": after,
                    "retained_snapshots": rot["retained_snapshots"],
                    "dropped_snapshots": rot["dropped_snapshots"]}
        rec.close(final_snapshot=False)
        fsync = fsync_stats(fs_before)
        del rec
        gc.collect()
        torch.cuda.empty_cache()

        kill9 = crash_case(device, src, os.path.join(work, "kill9"))
        os.makedirs(os.path.join(work, "launcher"))
        launcher = launcher_twice(src, os.path.join(work, "launcher"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"phase": "durability", "rows": n, "promoted_rows": promoted,
           "baseline": baseline,
           "journal": {
               "segments": len(segs), "single_seconds": t_single,
               "groups_seconds": t_groups,
               "append_one_conversation": _ms_quantiles(
                   [t for op, t in appends if op == "flush"]),
               "append_group": {**_ms_quantiles(
                   [t for _, t in group_appends]),
                   "records": [r for r, _ in group_appends]},
               "evicted_rows": evicted_rows, "superseded_rows": superseded,
               "compact": {**compacted, "seconds": t_compact}},
           "fsync": fsync, "recovery": recovery,
           "answers_equal": len(reqs), "bank_sha256_equal": True,
           "first_recovered_execute_ms": first_ms,
           "hybrid_B64_p50_ms": {"live": live_p50, "recovered": rec_p50},
           "launches": launches, "rotation": rotation, "kill9": kill9,
           "launcher": launcher, "gpu": gpu_line()}
    emit(out)
    return out


# -- phases 8 and 9: the paper's harness and the graph bench ------------------

# the reference package's figures (benchmarks/common.evaluate at the
# paper's defaults on the synthetic LoCoMo data): LoCoMo-weighted accuracy
# in percent and mean tokens per query, rounded as Table 1 and 2 print them
HARNESS_FIGURES = {"memori": (94.64, 498.4), "rag": (32.85, 873.4),
                   "full-context": (78.55, 112377.5)}
# BENCH_graph.json: graph-question recall flat -> graph, and the graph's
# size after the two probe links
GRAPH_RECALL = (1 / 6, 2 / 3)
GRAPH_SIZE = {"nodes": 99, "edges": 402}


def phase_harness(device) -> dict:
    """`repro_torch.eval.locomo` on the card at the paper's defaults:
    Table 1's four systems, Table 2 and Figure 2 (its other two seed
    groups), K1 counted.  For memori and rag every question's context and
    token count must equal the same system's run on the CPU, and the
    figures the reference's."""
    import torch
    from repro_torch.eval import locomo
    t0 = time.perf_counter()
    reset_counts()
    out = locomo.run_all(device)
    torch.cuda.synchronize()
    launches = counts()
    t_cuda = time.perf_counter() - t0
    if launches["topk_mips_masked"] < 1:
        fail("harness: topk_mips_masked was not launched")
    results = out["results"]
    for name, (acc, tokens) in HARNESS_FIGURES.items():
        r = results[name]
        got = (round(100 * r.overall, 2), round(r.mean_tokens, 1))
        if got != (acc, tokens):
            fail(f"harness {name}: accuracy / tokens {got}, the reference "
                 f"gives {(acc, tokens)}")
    t0 = time.perf_counter()
    for name in ("memori", "rag"):
        cpu = locomo.evaluate(name, device="cpu")
        if len(cpu.answered) != len(results[name].answered):
            fail(f"harness {name}: question counts differ")
        for a, b in zip(results[name].answered, cpu.answered):
            if (a.text, a.token_count) != (b.text, b.token_count):
                fail(f"harness {name}: the context of {a.question!r} "
                     "differs between cuda and cpu")
    res = {"phase": "harness", "cuda_seconds": t_cuda,
           "cpu_check_seconds": time.perf_counter() - t0,
           "launches": launches,
           "systems": {n: {"overall": r.overall, "unweighted": r.unweighted,
                           "per_category": r.per_category,
                           "mean_tokens": r.mean_tokens,
                           "questions": r.n_questions}
                       for n, r in results.items()},
           "figure2_overall": [r.overall for r in out["figure2_runs"]],
           "contexts_equal_cpu": ["memori", "rag"],
           "tables": out["tables"], "gpu": gpu_line()}
    emit(res)
    return res


def phase_graph_recall(device) -> dict:
    """`repro_torch.eval.graph_recall` on the card: BENCH_graph.json's
    recall and graph size, and no whole-lane re-upload while the lanes
    grow within their capacity."""
    from repro_torch.eval import graph_recall
    reset_counts()
    t0 = time.perf_counter()
    r = graph_recall.run(device=device)
    launches = counts()
    if launches["topk_mips_masked"] < 1:
        fail("graph_recall: topk_mips_masked was not launched")
    got = (r["recall"]["flat"]["overall"], r["recall"]["graph"]["overall"])
    if any(abs(a - b) > 1e-12 for a, b in zip(got, GRAPH_RECALL)):
        fail(f"graph_recall: recall flat -> graph {got}, expected "
             f"{GRAPH_RECALL}")
    size = {key: r["graph"][key] for key in GRAPH_SIZE}
    if size != GRAPH_SIZE or r["questions"] != 18:
        fail(f"graph_recall: graph {size}, {r['questions']} questions")
    if r["lane_reuploads_steady_state"]:
        fail(f"graph_recall: {r['lane_reuploads_steady_state']} lane "
             "re-uploads while the lanes grew within their capacity")
    res = {"phase": "graph_recall", "seconds": time.perf_counter() - t0,
           "launches": launches, **r, "gpu": gpu_line()}
    emit(res)
    return res


# -- phase 10: the attention kernels -------------------------------------------

def attention_bound_ms(n_q_heads_pairs: int, bytes_moved: int, D: int):
    """Least time on the card for attention over `n_q_heads_pairs` allowed
    (query head, key) pairs: 4*D FP32 flops each (q.k and p.v), against the
    bytes that must move once; returns (ms, "bytes" | "operations")."""
    t_ops = 4.0 * D * n_q_heads_pairs / FP32_FLOPS_PER_S * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def device_ms(fn, reps: int, tag: str) -> float:
    """Mean device time per call of `fn` spent in kernels whose name holds
    `tag`, from a profile of `reps` calls after one warm-up call: the
    kernel's own time, without the host's launch cost that a back-to-back
    CUDA-event time of a microsecond-scale kernel also holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if tag in e.key)
    return total_us / 1e3 / reps


def flash_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """Allowed (query, key) pairs of one head: t < T, t <= s when causal,
    t > s - window when window > 0."""
    total = 0
    for s in range(S):
        hi = min(T, s + 1) if causal else T
        lo = max(0, s - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def _rand(shape, gen, device, dtype):
    import torch
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def check_flash(gen, device, dtype, B, K, G, S, T, D, causal, window,
                strided=False, path=None) -> float:
    """One K6 case against its plain version; returns the largest error.
    With `path` ("wide" or "narrow", whether K/V go by cp.async), the case
    must take that path: `flash_grid` and `cp_async_ok` must say so, and the
    C launcher must report the rows per CTA of the shape `flash_grid`
    names."""
    import torch
    from repro_torch.common.utils import sm_count
    from repro_torch.kernels import flash_attention as fa
    if strided:      # the model's layout: (B, S, H, D) and (B, T, K, D)
        q = _rand((B, S, K * G, D), gen, device, dtype).view(
            B, S, K, G, D).permute(0, 2, 3, 1, 4)
        k = _rand((B, T, K, D), gen, device, dtype).permute(0, 2, 1, 3)
        v = _rand((B, T, K, D), gen, device, dtype).permute(0, 2, 1, 3)
    else:
        q = _rand((B, K, G, S, D), gen, device, dtype)
        k = _rand((B, K, T, D), gen, device, dtype)
        v = _rand((B, K, T, D), gen, device, dtype)
    what = (f"flash_attention {str(dtype)[6:]} B={B} K={K} G={G} S={S} T={T} "
            f"D={D} causal={causal} window={window} strided={strided}")
    fa.flash_attention.rows_per_cta = 0
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    if path is not None:
        narrow, rows, _, _ = fa.flash_grid(B, K, G, S, D, sm_count(device))
        planned = ("narrow" if narrow else "wide",
                   fa.cp_async_ok(D, q.element_size(), k, v))
        if planned != path:
            fail(f"{what}: takes path {planned}, the case is for {path}")
        ran = fa.flash_attention.rows_per_cta
        if ran != rows:
            fail(f"{what}: launched CTAs of {ran} rows, flash_grid "
                 f"says {rows} ({path[0]})")
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    tol = ATTN_TOL[str(dtype)[6:]]
    err = float((got.float() - want.float()).abs().max())
    if not err <= tol:
        fail(f"{what}: max error {err} > {tol}")
    return err


def check_decode(gen, device, dtype, B, K, G, T, D, lens, window,
                 strided=False, path=None) -> float:
    """One K5 case against its plain version, then again with every cache
    row past kv_len overwritten by garbage: the output must not move by a
    bit.  Returns the largest error.  With `path` (whether the grid has one
    split, so each CTA writes its output directly; whether K/V go by
    cp.async), the launch plan the wrapper used must be that one."""
    import torch
    from repro_torch.common.utils import sm_count
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    if strided:      # the engine's (B, T, K, D) cache, (B, 1, H, D) query
        q = _rand((B, 1, K * G, D), gen, device, dtype).view(B, K, G, D)
        k = _rand((B, T, K, D), gen, device, dtype).permute(0, 2, 1, 3)
        v = _rand((B, T, K, D), gen, device, dtype).permute(0, 2, 1, 3)
    else:
        q = _rand((B, K, G, D), gen, device, dtype)
        k = _rand((B, K, T, D), gen, device, dtype)
        v = _rand((B, K, T, D), gen, device, dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    got = da.decode_attention(q, k, v, kv_len, window=window)
    want = da.decode_attention_ref(q, k, v, kv_len, window=window)
    tail = (torch.arange(T, device=device)[None, :]
            >= kv_len[:, None])[:, None, :, None]          # (B, 1, T, 1)
    k2 = torch.where(tail, torch.full_like(k, 999.0), k)
    v2 = torch.where(tail, torch.full_like(v, -999.0), v)
    got2 = da.decode_attention(q, k2, v2, kv_len, window=window)
    torch.cuda.synchronize()
    what = (f"decode_attention {str(dtype)[6:]} B={B} K={K} G={G} T={T} "
            f"D={D} kv_len={lens} window={window} strided={strided}")
    if path is not None:
        n_split = da.plan_splits(T, B, K, sm_count(device))
        planned = (n_split == 1, fa.cp_async_ok(D, q.element_size(), k, v))
        used = {p.dims[7:9] for p in da._plans.values()
                if p.dims[:5] == (B, K, G, T, D)}
        if planned != path or used != {(n_split, int(planned[1]))}:
            fail(f"{what}: plan (one split, cp.async) {planned}, launch "
                 f"plans (splits, cp.async) {used}; the case is for {path}")
    tol = ATTN_TOL[str(dtype)[6:]]
    err = float((got.float() - want.float()).abs().max())
    if got.shape != want.shape or not err <= tol:
        fail(f"{what}: max error {err} > {tol}")
    if not torch.equal(got, got2):
        fail(f"{what}: rows past kv_len changed the output")
    return err


def sdpa_gqa(q, k, v, **kw):
    """One `scaled_dot_product_attention` call on the kernels' grouped
    layout: (B, K, G, S, D) queries over (B, K, T, D) keys."""
    import torch
    B, K, G, S, D = q.shape
    return torch.nn.functional.scaled_dot_product_attention(
        q.reshape(B, K * G, S, D), k, v, enable_gqa=True, **kw)


def attention_instances(entries: dict, name: str) -> dict:
    """The ptxas entries of `name`'s instances that the served paths run
    (memori-agent is f32 with D = 64): K5's one, K6's two CTA shapes."""
    from repro_torch.kernels import flash_attention as fa
    dp = fa.padded_head_dim(LM_D)
    want = {"decode_attention": (f"decode_attention_kernel<f32,{dp}>", 1),
            "flash_attention": (f"flash_fwd_kernel<f32,{dp},", 2)}[name]
    found = {i: e for i, e in entries.items() if i.startswith(want[0])}
    if len(found) != want[1]:
        fail(f"{name}: ptxas entries {sorted(found)}, want {want[1]} "
             f"starting {want[0]!r}")
    return found


def graph_ms(fn, calls: int, reps: int) -> float:
    """Mean device time of one `fn` call inside a CUDA graph of `calls`
    back-to-back calls, replayed `reps` times between CUDA events (one
    eager call first builds whatever the capture must not allocate)."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def decode_replays(gen, device) -> dict:
    """One K5 call at the engine's shape captured in a CUDA graph, replayed
    while kv_len changes in place: replay i gives row b the length
    DECODE_REPLAY_LENS[(b + i) % 8], so every row takes every length.  Each
    replay is held against the plain version on the same inputs (a counter
    left unreset, or a split taken from the wrong kv_len, shows here).
    Returns {dtype: {window: largest error}}."""
    import torch
    from repro_torch.kernels import decode_attention as da
    lens = DECODE_REPLAY_LENS
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dtype)[6:]]
        q = _rand((LM_SLOTS, 1, LM_K * LM_G, LM_D), gen, device,
                  dtype).view(LM_SLOTS, LM_K, LM_G, LM_D)
        k = _rand((LM_SLOTS, LM_MAX_LEN, LM_K, LM_D), gen, device,
                  dtype).permute(0, 2, 1, 3)
        v = _rand((LM_SLOTS, LM_MAX_LEN, LM_K, LM_D), gen, device,
                  dtype).permute(0, 2, 1, 3)
        kv_len = torch.full((LM_SLOTS,), LM_MAX_LEN, dtype=torch.int32,
                            device=device)
        res = out[str(dtype)[6:]] = {}
        for window in (0, 20):
            da.decode_attention(q, k, v, kv_len, window=window)   # the plan
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                got = da.decode_attention(q, k, v, kv_len, window=window)
            err = 0.0
            for i in range(len(lens)):
                kv_len.copy_(torch.tensor(
                    [lens[(b + i) % len(lens)] for b in range(LM_SLOTS)],
                    dtype=torch.int32))
                g.replay()
                want = da.decode_attention_ref(q, k, v, kv_len,
                                               window=window)
                e = float((got.float() - want.float()).abs().max())
                if not e <= tol:
                    fail(f"decode_attention {str(dtype)[6:]} window={window}"
                         f" graph replay {i} kv_len={kv_len.tolist()}: max "
                         f"error {e} > {tol}")
                err = max(err, e)
            res[str(window)] = err
    return out


def phase_attention(device, reps: int, build_log=None) -> dict:
    import torch
    from repro_torch.common.utils import sm_count
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(2)
    res = {name: {"cases": 0, "max_abs_err": {"float32": 0.0,
                                              "bfloat16": 0.0}}
           for name in ATTN_KERNELS}

    def note(name, dtype, err):
        r = res[name]
        key = str(dtype)[6:]
        r["max_abs_err"][key] = max(r["max_abs_err"][key], err)
        r["cases"] += 1

    flash_shapes = [  # (B, K, G, S, T, D): the reference tests' shapes,
        (1, 1, 1, 32, 32, 16), (2, 2, 4, 64, 64, 32), (1, 3, 2, 70, 70, 32),
        (1, 2, 2, 96, 96, 16),
        # S, T off the 64-row tile; G in {1, 3, 8, 16}; D up to 256
        (1, 4, 3, 150, 150, 64), (3, 4, 1, 64, 64, 64),
        (2, 2, 8, 130, 130, 128), (1, 2, 3, 77, 77, 256),
        (1, 1, 16, 33, 33, 64), (1, 4, 3, 1, 1, 64),
        (2, 1, 3, 40, 100, 64), (1, 2, 2, 100, 40, 16)]   # T != S
    # each launch path that no case above reaches at 132 SMs, named:
    # (B, K, G, S, T, D, causal, window, (CTA shape, K/V by cp.async))
    flash_paths = [
        (1, 4, 3, LONG_S, LONG_S, 64, True, 0, ("wide", True)),
        (1, 4, 3, LONG_S, LONG_S, 64, True, 512, ("wide", True)),
        (40, 4, 1, 64, 64, 64, False, 0, ("wide", True)),  # 40 texts embedded
        (12, 4, 2, 96, 96, 32, False, 16, ("wide", True)),
        (4, 4, 8, 130, 130, 128, True, 0, ("wide", True)),
        (4, 4, 4, 77, 77, 256, True, 16, ("wide", True)),
        (40, 4, 1, 64, 64, 50, False, 0, ("wide", False)),
        (40, 4, 1, 64, 64, 50, True, 16, ("wide", False)),
        (1, 4, 3, PREFILL_S, PREFILL_S, 64, True, 0, ("narrow", True)),
        (1, 2, 3, 70, 70, 50, True, 0, ("narrow", False)),
        (1, 2, 3, 70, 90, 50, False, 16, ("narrow", False))]
    # (B, K, G, T, D, kv_len, (one split, K/V by cp.async)): B * K >= 264
    # gives one split a (b, kv-head); D = 50 rows are not 16-byte multiples
    one_split_lens = [1 + 37 * i % 100 for i in range(34)]
    decode_paths = [
        (34, 8, 2, 100, 64, one_split_lens, (True, True)),
        (34, 8, 2, 100, 50, one_split_lens, (True, False)),
        (3, 2, 4, 200, 50, [197, 1, 120], (False, False)),
        (3, 2, 4, 200, 64, [197, 1, 120], (False, True))]
    decode_shapes = [  # (B, K, G, T, D, kv_len)
        (1, 1, 1, 64, 16, [61]), (3, 2, 4, 200, 32, [197, 190, 183]),
        (LM_SLOTS, LM_K, LM_G, LM_MAX_LEN, LM_D,
         [1, 2, 63, 64, 65, 170, 511, 512]),
        (2, 2, 8, 300, 128, [1, 300]), (2, 1, 16, 100, 256, [37, 100]),
        (3, 4, 3, LONG_S, 64, [LONG_S, 1, LONG_S // 2 + 1])]
    for dtype in (torch.float32, torch.bfloat16):
        for B, K, G, S, T, D in flash_shapes:
            for causal in (True, False):
                for window in (0, 16):
                    note("flash_attention", dtype, check_flash(
                        gen, device, dtype, B, K, G, S, T, D, causal, window))
        note("flash_attention", dtype, check_flash(
            gen, device, dtype, 1, LM_K, LM_G, PREFILL_S, PREFILL_S, LM_D,
            True, 0, strided=True))
        note("flash_attention", dtype, check_flash(
            gen, device, dtype, 5, 4, 1, 64, 64, 64, False, 0, strided=True))
        for B, K, G, S, T, D, causal, window, path in flash_paths:
            note("flash_attention", dtype, check_flash(
                gen, device, dtype, B, K, G, S, T, D, causal, window,
                path=path))
        for B, K, G, T, D, lens in decode_shapes:
            for window in (0, 20):
                note("decode_attention", dtype, check_decode(
                    gen, device, dtype, B, K, G, T, D, lens, window))
        note("decode_attention", dtype, check_decode(
            gen, device, dtype, LM_SLOTS, LM_K, LM_G, LM_MAX_LEN, LM_D,
            [DECODE_KV_LEN + 7 * i for i in range(LM_SLOTS)], 0,
            strided=True))
        for B, K, G, T, D, lens, path in decode_paths:
            for window in (0, 20):
                note("decode_attention", dtype, check_decode(
                    gen, device, dtype, B, K, G, T, D, lens, window,
                    path=path))

    # timings at the agent's shapes
    f32 = torch.float32
    timed = {}
    for label, S in (("prefill", PREFILL_S), ("long_context", LONG_S)):
        q = _rand((1, LM_K, LM_G, S, LM_D), gen, device, f32)
        k = _rand((1, LM_K, S, LM_D), gen, device, f32)
        v = _rand((1, LM_K, S, LM_D), gen, device, f32)
        pairs = LM_K * LM_G * flash_pairs(S, S, True, 0)
        bytes_moved = 4 * (2 * q.numel() + k.numel() + v.numel())
        bound, by = attention_bound_ms(pairs, bytes_moved, LM_D)
        narrow, rows, _, ctas = fa.flash_grid(1, LM_K, LM_G, S, LM_D,
                                              sm_count(device))
        timed[label] = {
            "shape": {"B": 1, "K": LM_K, "G": LM_G, "S": S, "T": S,
                      "D": LM_D, "causal": True},
            "ctas": ctas, "cta_shape": "narrow" if narrow else "wide",
            "rows_per_cta": rows,
            "kernel_ms": time_ms(lambda: fa.flash_attention(q, k, v), reps),
            "device_ms": device_ms(lambda: fa.flash_attention(q, k, v), reps,
                                   "flash_fwd_kernel"),
            "plain_ms": time_ms(lambda: fa.flash_attention_ref(q, k, v),
                                max(1, reps // 4)),
            "library_ms": time_ms(lambda: sdpa_gqa(q, k, v, is_causal=True),
                                  reps),
            "bound_ms": bound, "bound_by": by}
    res["flash_attention"].update(timed["prefill"])
    res["flash_attention"]["long_context"] = timed["long_context"]
    # the embedder's bidirectional pass: 16 texts of 64 tokens, 4 heads
    q = _rand((16, 4, 1, 64, 64), gen, device, f32)
    k = _rand((16, 4, 64, 64), gen, device, f32)
    v = _rand((16, 4, 64, 64), gen, device, f32)
    res["flash_attention"]["embedder"] = {
        "shape": {"B": 16, "K": 4, "G": 1, "S": 64, "T": 64, "D": 64,
                  "causal": False},
        "kernel_ms": time_ms(lambda: fa.flash_attention(q, k, v,
                                                        causal=False), reps)}

    q = _rand((LM_SLOTS, LM_K, LM_G, LM_D), gen, device, f32)
    cache_k = _rand((LM_SLOTS, LM_MAX_LEN, LM_K, LM_D), gen, device, f32)
    cache_v = _rand((LM_SLOTS, LM_MAX_LEN, LM_K, LM_D), gen, device, f32)
    k, v = cache_k.permute(0, 2, 1, 3), cache_v.permute(0, 2, 1, 3)
    kv_len = torch.full((LM_SLOTS,), DECODE_KV_LEN, dtype=torch.int32,
                        device=device)
    mask = (torch.arange(LM_MAX_LEN, device=device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    rows = LM_SLOTS * DECODE_KV_LEN
    bytes_moved = 4 * (2 * q.numel() + 2 * rows * LM_K * LM_D + LM_SLOTS)
    bound, by = attention_bound_ms(rows * LM_K * LM_G, bytes_moved, LM_D)
    res["decode_attention"].update({
        "shape": {"B": LM_SLOTS, "K": LM_K, "G": LM_G, "T": LM_MAX_LEN,
                  "D": LM_D, "kv_len": DECODE_KV_LEN},
        "kernel_ms": time_ms(lambda: da.decode_attention(q, k, v, kv_len),
                             reps),
        "device_ms": device_ms(lambda: da.decode_attention(q, k, v, kv_len),
                               reps, "decode_"),
        "graph_ms": graph_ms(lambda: da.decode_attention(q, k, v, kv_len),
                             GRAPH_CALLS, reps),
        "splits": da.plan_splits(LM_MAX_LEN, LM_SLOTS, LM_K,
                                 sm_count(device)),
        "plain_ms": time_ms(lambda: da.decode_attention_ref(q, k, v, kv_len),
                            reps),
        "library_ms": time_ms(lambda: torch.nn.functional.
                              scaled_dot_product_attention(
                                  q.reshape(LM_SLOTS, LM_K * LM_G, 1, LM_D),
                                  k, v, attn_mask=mask, enable_gqa=True),
                              reps),
        "bound_ms": bound, "bound_by": by})
    res["decode_attention"]["graph_replays_max_abs_err"] = decode_replays(
        gen, device)
    if build_log is not None:
        for name in ATTN_KERNELS:
            entries = build_log["kernels"][name]["ptxas"]
            if not entries:         # the library was built before this run
                continue
            ptxas = res[name]["ptxas"] = attention_instances(entries, name)
            for inst, e in ptxas.items():
                if e.get("spill_stores", 0) or e.get("spill_loads", 0):
                    fail(f"{inst}: ptxas reports spills: {e}")
    out = {"phase": "attention", "tolerance": ATTN_TOL, "kernels": res,
           "gpu": gpu_line()}
    emit(out)
    return out


# -- phases 11 and 12: the agent's LM, and the agent loop ------------------------

@contextlib.contextmanager
def plain_attention():
    """Route the attention layer to the kernels' plain PyTorch versions
    (the comparison path only; the port never does this on a card)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import attention as attn
    saved = attn.flash_attention, attn.decode_attention
    attn.flash_attention = fa.flash_attention_ref
    attn.decode_attention = da.decode_attention_ref
    try:
        yield
    finally:
        attn.flash_attention, attn.decode_attention = saved


def lm_prompts(tokenizer, n: int):
    """n prompts of 100 to 250 tokens: consecutive turns of synthetic
    LoCoMo conversations, as `speaker: text` lines."""
    import numpy as np
    from repro_torch.data.locomo_synth import generate_conversation
    rng = np.random.default_rng(7)
    prompts = []
    for i in range(n):
        conv = generate_conversation(seed=30_000 + i)
        msgs = [m for _, ms in conv.sessions for m in ms]
        start = int(rng.integers(0, len(msgs) // 2))
        target = int(rng.integers(100, 251))
        lines, count = [], 0
        for m in msgs[start:]:
            line = f"{m.speaker}: {m.text}"
            c = len(tokenizer.encode(line))
            if count + c > target:
                break
            lines.append(line)
            count += c
        prompts.append("\n".join(lines))
    return prompts


def teacher_forced(model, params, seqs, prefix, steps, device):
    """The engine's dataflow, teacher-forced: each sequence prefilled on
    its first prefix[i] tokens into its own slot of a batched cache, then
    `steps` batched decode steps feeding the sequences' next tokens at
    per-slot positions.  Returns (prefill logits (n, V), decode logits
    (steps, n, V))."""
    import torch
    n = len(seqs)
    caches = model.init_caches(n, LM_MAX_LEN, device=device)
    first = []
    for i, seq in enumerate(seqs):
        lg, pre = model.prefill(params, {"tokens": seq[None, :prefix[i]]})
        first.append(lg[0, -1])
        pre = model.prepare_decode_caches(pre, prefix[i], LM_MAX_LEN)
        for full, single in zip(caches, pre):
            for name, x in single.items():
                full[name][i].copy_(x[0])
    pos = torch.tensor(prefix, device=device)
    out = []
    for step in range(steps):
        toks = torch.stack([seq[p + step] for seq, p in zip(seqs, prefix)])
        lg, caches = model.decode_step(params, toks[:, None], caches,
                                       pos + step)
        out.append(lg[:, 0])
    return torch.stack(first), torch.stack(out)


def greedy_run(engine, requests, margins=None):
    """Run `requests` through a ContinuousBatcher; returns (responses by
    request index, wall seconds, prefill seconds per admission, decode
    seconds per step with every slot busy).  With `margins` (a dict), the
    top-two logit margin of every sampled token is recorded in it under
    (request index, token index)."""
    import torch
    import repro_torch.serving.engine as engine_mod
    from repro_torch.serving.scheduler import ContinuousBatcher
    admit, step, sample = engine.admit, engine.step, engine_mod.sample
    index = {r.request_id: i for i, r in enumerate(requests)}
    prefill_s, step_s, admitting = [], [], []

    def timed_admit(req):
        admitting.append(req)
        t = time.perf_counter()
        slot = admit(req)              # ends in a device -> host read
        prefill_s.append(time.perf_counter() - t)
        admitting.pop()
        return slot

    def timed_step():
        full = bool(engine.slot_active.all())
        t = time.perf_counter()
        done = step()                  # ends in a device -> host read
        if full:
            step_s.append(time.perf_counter() - t)
        return done

    def recording_sample(logits, generator, cfg):
        top2 = torch.topk(logits[:, -1].float(), 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        if admitting:
            margins[(index[admitting[-1].request_id], 0)] = gaps[0]
        else:
            for s, req in enumerate(engine.slot_req):
                if req is not None:
                    margins[(index[req.request_id],
                             len(engine.slot_out[s]))] = gaps[s]
        return sample(logits, generator, cfg)

    engine.admit, engine.step = timed_admit, timed_step
    if margins is not None:
        engine_mod.sample = recording_sample
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ContinuousBatcher(engine).run(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del engine.admit, engine.step
        engine_mod.sample = sample
    return [out[r.request_id] for r in requests], wall, prefill_s, step_s


def profile_decode(engine, tok, prompts) -> dict:
    """One profiled `Engine.step` with every slot busy: its host wall time,
    the device's busy time (union of kernel and copy intervals) and idle
    share, the number of device kernels beside the host's launch calls
    (runtime API calls that put work on the device: a replayed graph is one
    `cudaGraphLaunch`) and the costliest kernels by device time.
    The profiler records the second of two steps (the first is its
    warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.serving.requests import Request
    for p in prompts[: engine.slots]:
        engine.admit(Request(tok.encode(p), 4 * LM_NEW_TOKENS))
    engine.step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        engine.step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    act = device_activity(prof)
    by_name = act["by_name"]
    engine.slot_active[:] = False          # release the slots
    engine.slot_req = [None] * engine.slots
    engine.slot_out = [[] for _ in range(engine.slots)]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": act["busy_ms"],
            "device_idle_share": 1.0 - act["busy_ms"] / wall_ms,
            "device_kernels": act["kernels"],
            "host_launch_calls": sum(act["host_calls"].values()),
            "host_launch_calls_by_name": act["host_calls"],
            "decode_attention_ms": sum(ms for n, ms in by_name.items()
                                       if "decode_" in n),
            "top_kernels_ms": {n[:60]: ms for n, ms in top}}


@contextlib.contextmanager
def checked_attention(errs: list):
    """Hold every attention kernel call against its plain version on the
    very same inputs: each call appends (kernel, max error, tolerance) to
    `errs`, the tolerance being ATTN_TOL's f32 value scaled by the largest
    |v| (the output is a convex combination of value rows)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import attention as attn
    flash, decode = attn.flash_attention, attn.decode_attention

    def note(name, got, want, v):
        tol = ATTN_TOL["float32"] * max(1.0, float(v.abs().max()))
        errs.append((name, float((got - want).abs().max()), tol))

    def checked_flash(q, k, v, **kw):
        got = flash(q, k, v, **kw)
        note("flash_attention", got, fa.flash_attention_ref(q, k, v, **kw), v)
        return got

    def checked_decode(q, k, v, kv_len, **kw):
        got = decode(q, k, v, kv_len, **kw)
        note("decode_attention", got,
             da.decode_attention_ref(q, k, v, kv_len, **kw), v)
        return got

    attn.flash_attention, attn.decode_attention = checked_flash, checked_decode
    try:
        yield
    finally:
        attn.flash_attention, attn.decode_attention = flash, decode


def conditioned(params, cfg):
    """The same weights with wq and wk rescaled from the reference's init
    law (std 1/sqrt(heads): `scaled_normal` takes fan_in = shape[-2]) to
    std 1/sqrt(d_model), so that q.k * D**-0.5 has unit spread.  At the
    reference's scale the scores spread by ~64 at full width: attention is a
    hard max, and a last-ulp difference in one score can switch the winning
    key — any two correct implementations then part ways by O(1) logits."""
    f = (cfg.num_heads / cfg.d_model) ** 0.5
    layers = [{**blk, "attn": {**blk["attn"], "wq": blk["attn"]["wq"] * f,
                               "wk": blk["attn"]["wk"] * f}}
              for blk in params["layers"]]
    return {**params, "layers": layers}


def check_kernel_calls(errs, what: str) -> dict:
    """Fail on any call of `errs` beyond its tolerance; per-kernel count and
    largest error."""
    out = {}
    for name, err, tol in errs:
        if not err <= tol:
            fail(f"{what}: a {name} call differs from its plain version on "
                 f"the same inputs by {err} > {tol}")
        r = out.setdefault(name, {"calls": 0, "max_abs_err": 0.0})
        r["calls"] += 1
        r["max_abs_err"] = max(r["max_abs_err"], err)
    return out


def replay_vs_eager(engine, tok, prompts) -> float:
    """On one engine state (every slot busy), the largest difference
    between the logits of the engine's replayed decode graph and of an
    eager `decode_step` on copies of the caches and the same static
    inputs.  The same kernels on the same inputs: expected 0."""
    import torch
    from repro_torch.serving.requests import Request
    for p in prompts[: engine.slots]:
        engine.admit(Request(tok.encode(p), 4 * LM_NEW_TOKENS))
    engine.step()
    host = engine._host_inputs.numpy()
    host[:, 0] = engine.slot_tokens
    host[:, 1] = engine.slot_pos
    engine._inputs.copy_(engine._host_inputs)
    copies = [{n: x.clone() for n, x in layer.items()}
              for layer in engine.caches]
    with torch.no_grad():
        eager, _ = engine.model.decode_step(
            engine.params, engine._inputs[:, :1].clone(), copies,
            engine._inputs[:, 1].clone())
    replayed = engine.graph.replay()
    torch.cuda.synchronize()
    err = float((replayed - eager).abs().max())
    for cp, layer in zip(copies, engine.caches):   # the graph wrote in place
        for n, x in layer.items():
            err = max(err, float((cp[n] - x).abs().max()))
    engine.slot_active[:] = False          # release the slots
    engine.slot_req = [None] * engine.slots
    engine.slot_out = [[] for _ in range(engine.slots)]
    return err


def lm_setup(device):
    """memori-agent with random weights (seed 0), its engine (LM_SLOTS
    slots of LM_MAX_LEN), the tokenizer, LM_REQUESTS prompts and a maker
    of their requests; one warm-up run of two requests (cuBLAS handles,
    the kernels' first launches) has been made on the engine."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models.model_api import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.requests import Request
    cfg = get_config("memori-agent")
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    tok = HashTokenizer(cfg.vocab_size)
    engine = Engine(model, params, max_len=LM_MAX_LEN, slots=LM_SLOTS,
                    tokenizer=tok)
    prompts = lm_prompts(tok, LM_REQUESTS)

    def requests():
        return [Request(tok.encode(p), LM_NEW_TOKENS) for p in prompts]

    greedy_run(engine, requests()[:2])
    return cfg, model, params, tok, engine, prompts, requests


def serving_times(device, rounds: int) -> dict:
    """The lm phase's serving run alone, `rounds` times on one engine:
    prefill ms per admission and decode ms per step at full slots (mean and
    median over all rounds) and each round's tokens/s.  It uses only what
    the port's earlier slices have too, so with `--src` it times another
    checkout's port by the same code (an A/B on one card)."""
    import numpy as np
    _, _, _, _, engine, _, requests = lm_setup(device)
    prefill_s, step_s, tokens_per_s = [], [], []
    for _ in range(rounds):
        got, wall, p, st = greedy_run(engine, requests())
        prefill_s += p
        step_s += st
        tokens_per_s.append(sum(len(r.tokens) for r in got) / wall)
    return {"phase": "serving_times", "rounds": rounds,
            "prefill_ms": {"mean": float(np.mean(prefill_s)) * 1e3,
                           "median": float(np.median(prefill_s)) * 1e3},
            "decode_step_ms_at_full_slots": {
                "mean": float(np.mean(step_s)) * 1e3,
                "median": float(np.median(step_s)) * 1e3},
            "tokens_per_s": tokens_per_s, "gpu": gpu_line()}


def phase_lm(device) -> dict:
    import numpy as np
    import torch
    from repro_torch.serving.engine import Engine
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params, tok, engine, prompts, requests = lm_setup(device)
    lens = [len(tok.encode(p)) for p in prompts]

    # the main path, every launch counter reset just before it
    reset_counts()
    got, wall, prefill_s, step_s = greedy_run(engine, requests())
    launches = counts()
    for name in ATTN_KERNELS:
        if launches[name] < 1:
            fail(f"lm: {name} was not launched on the serving path")
    if engine.graph is None:
        fail("lm: the engine's decode step was not captured as a CUDA graph")
    # every request decodes LM_NEW_TOKENS - 1 tokens after its prefill, the
    # slots filling and draining together: 2 x 31 steps, K5 in each layer
    want_k5 = (-(-LM_REQUESTS // LM_SLOTS) * (LM_NEW_TOKENS - 1)
               * cfg.num_layers)
    if launches["decode_attention"] != want_k5:
        fail(f"lm: K5 counted {launches['decode_attention']} launches on the "
             f"serving path, want {want_k5}")
    tokens_out = sum(len(r.tokens) for r in got)
    if len(got) != LM_REQUESTS or any(len(r.tokens) != LM_NEW_TOKENS
                                      for r in got):
        fail(f"lm: {[len(r.tokens) for r in got]} tokens per request")
    max_memory = torch.cuda.max_memory_allocated()

    # teacher-forced: 4 prompts (ragged lengths) prefilled on all but their
    # last 8 tokens, then 8 batched decode steps; every kernel call held
    # against its plain version on its own inputs
    steps = 8
    seqs = [torch.tensor(tok.encode(p), device=device) for p in prompts[:4]]
    prefix = [len(s) - steps for s in seqs]

    def logits_pair(p):
        """(kernel path, plain path) teacher-forced logits and the full
        forward of each sequence, for weights `p`."""
        with torch.no_grad():
            kern = teacher_forced(model, p, seqs, prefix, steps, device)
            with plain_attention():
                plain = teacher_forced(model, p, seqs, prefix, steps, device)
            full = [model(p, s[None])[0] for s in seqs]
        return kern, plain, full

    errs = []
    with checked_attention(errs):
        kern, plain, _ = logits_pair(params)
    per_call = check_kernel_calls(errs, "lm")
    reference_init = {
        "prefill": float((kern[0] - plain[0]).abs().max()),
        "decode": float((kern[1] - plain[1]).abs().max())}

    # end to end, on the conditioned weights
    cparams = conditioned(params, cfg)
    (k_first, k_dec), (p_first, p_dec), full = logits_pair(cparams)
    err_prefill = float((k_first - p_first).abs().max())
    err_decode = float((k_dec - p_dec).abs().max())
    if not max(err_prefill, err_decode) <= LOGIT_TOL:
        fail(f"lm: kernel vs plain logits differ by {err_prefill} "
             f"(prefill) / {err_decode} (decode) > {LOGIT_TOL}")
    err_full = 0.0
    for i, f in enumerate(full):       # positions prefix-1 .. prefix+steps-1
        want = f[prefix[i] - 1:]
        have = torch.cat([k_first[i][None], k_dec[:, i]])
        err_full = max(err_full, float((have - want).abs().max()))
    if not err_full <= DECODE_TOL:
        fail(f"lm: prefill + decode vs full forward differ by {err_full}")
    if not all(torch.isfinite(x).all() for x in (k_first, k_dec)):
        fail("lm: non-finite logits")

    # greedy tokens of the same requests, kernel path against plain path
    # (conditioned weights): a request may leave the plain path's tokens
    # only at a step where the plain path's top-two logits are closer than
    # LOGIT_TOL (a near-tie)
    c_engine = Engine(model, cparams, max_len=LM_MAX_LEN, slots=LM_SLOTS,
                      tokenizer=tok)
    c_got, _, _, _ = greedy_run(c_engine, requests())
    margins = {}
    with plain_attention():
        c_plain, _, _, _ = greedy_run(Engine(
            model, cparams, max_len=LM_MAX_LEN, slots=LM_SLOTS,
            tokenizer=tok), requests(), margins)
    near_ties = sum(1 for m in margins.values() if m < LOGIT_TOL)
    diverged = {}
    for i, (a, b) in enumerate(zip(c_got, c_plain)):
        diff = [j for j, (x, y) in enumerate(zip(a.tokens, b.tokens))
                if x != y]
        if not diff:
            continue
        j = diff[0]
        diverged[i] = {"index": j, "plain_margin": margins[(i, j)]}
        if margins[(i, j)] >= LOGIT_TOL:
            fail(f"lm: request {i} token {j}: kernel path {a.tokens[j]}, "
                 f"plain path {b.tokens[j]}, plain top-two margin "
                 f"{margins[(i, j)]} >= {LOGIT_TOL}")
    replay_err = replay_vs_eager(engine, tok, prompts)
    if not replay_err <= LOGIT_TOL:
        fail(f"lm: replayed decode graph vs eager decode_step differ by "
             f"{replay_err} > {LOGIT_TOL}")
    profiled = profile_decode(engine, tok, prompts)
    out = {"phase": "lm", "config": "memori-agent", "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
           "params": cfg.param_count(),
           "slots": LM_SLOTS, "max_len": LM_MAX_LEN,
           "requests": LM_REQUESTS, "new_tokens": LM_NEW_TOKENS,
           "prompt_tokens": {"min": min(lens), "mean": float(np.mean(lens)),
                             "max": max(lens)},
           "launches": launches,
           "prefill_ms_per_request": float(np.mean(prefill_s)) * 1e3,
           "prefill_ms_median": float(np.median(prefill_s)) * 1e3,
           "decode_step_ms_at_full_slots": float(np.median(step_s)) * 1e3,
           "decode_steps_at_full_slots": len(step_s),
           "tokens_per_s": tokens_out / wall, "wall_s": wall,
           "max_memory_allocated_bytes": max_memory,
           "kernel_calls_vs_plain": per_call,
           "reference_init_logits_vs_plain_max_abs": reference_init,
           "conditioned": {
               "logits_vs_plain_max_abs": {"prefill": err_prefill,
                                           "decode": err_decode,
                                           "tolerance": LOGIT_TOL},
               "decode_vs_full_forward_max_abs": err_full,
               "greedy_vs_plain": {
                   "requests_equal": LM_REQUESTS - len(diverged),
                   "plain_near_tie_steps": near_ties,
                   "sampled_steps": len(margins),
                   "diverged_at_near_tie": diverged}},
           "decode_graph": {"replayed_vs_eager_max_abs": replay_err,
                            "captured_launches": {
                                f.__name__: d
                                for f, d in engine.graph.deltas.items()}},
           "profiled_step": profiled,
           "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                          "cudnn": torch.backends.cudnn.allow_tf32},
           "gpu": gpu_line()}
    emit(out)
    return out, engine


AGENT_USERS = {
    "priya/c0": ("Priya", ["Hi there! I am Priya.",
                           "I work as a botanist and I live in Tallinn.",
                           "I adopted a hedgehog named Biscuit."],
                 "Where does Priya live?", "(Priya; lives in; tallinn)"),
    "marco/c0": ("Marco", ["Hello, Marco here.",
                           "I work as a glassblower and I live in Porto.",
                           "I adopted a parrot named Olive."],
                 "Where does Marco live?", "(Marco; lives in; porto)"),
    "ines/c0": ("Ines", ["Good morning, this is Ines.",
                         "I work as a cartographer and I live in Quito."],
                "Where does Ines live?", "(Ines; lives in; quito)"),
    "kofi/c0": ("Kofi", ["Hey, Kofi speaking.",
                         "I work as a luthier and I live in Accra."],
                "Where does Kofi live?", "(Kofi; lives in; accra)"),
}


def phase_agent(device, engine) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (HashEmbedder, LMEmbedder, LMExtractor,
                                  MemoriClient, MemoryService)
    from repro_torch.models.model_api import Model

    def llm(prompt: str) -> str:     # the launch/serve.py shape
        return engine.generate([prompt[-500:]], max_new_tokens=12)[0]

    svc = MemoryService(HashEmbedder(device=device), device=device,
                        budget=800)
    reset_counts()
    t0 = time.perf_counter()
    replies = 0
    for ns, (name, turns, _, _) in AGENT_USERS.items():
        client = MemoriClient(llm, svc.namespace(ns), user_name=name)
        for i, turn in enumerate(turns):
            client.chat(turn, timestamp=1_700_000_000.0 + i)
            replies += 1
        client.end_session()
    torch.cuda.synchronize()
    t_chat = time.perf_counter() - t0
    reqs = [(ns, q) for ns, (_, _, q, _) in AGENT_USERS.items()]
    ctxs = svc.retrieve_batch(reqs)
    torch.cuda.synchronize()
    launches = counts()
    for (ns, _), ctx in zip(reqs, ctxs):
        for other, (_, _, _, fact) in AGENT_USERS.items():
            if other == ns and fact not in ctx.text:
                fail(f"agent {ns}: its fact {fact} did not come back:\n"
                     f"{ctx.text}")
            if other != ns and fact in ctx.text:
                fail(f"agent {ns}: retrieved {other}'s fact {fact}")
    for name in ("topk_mips_masked", "flash_attention", "decode_attention"):
        if launches[name] < 1:
            fail(f"agent: {name} was not launched on the agent loop")

    # LM-backed extraction of one session (a random-init LM yields no
    # triples: this drives the wiring, prompt -> engine -> parser)
    ns0, (name0, turns0, _, _) = next(iter(AGENT_USERS.items()))
    from repro_torch.core.extraction import Message
    msgs = [Message(name0, t, float(i)) for i, t in enumerate(turns0)]
    triples, summary = LMExtractor(llm).extract(ns0, "s-lm", msgs)

    # the embedder at memori-embedder width over the recorded triples
    ecfg = get_config("memori-embedder")
    emodel = Model(ecfg)
    eparams = emodel.init_params(
        torch.Generator(device=device).manual_seed(1))
    texts = [t.text() for ns in AGENT_USERS
             for t in svc.store.get(ns).triples.all()]
    errs = []
    before = counts()["flash_attention"]
    with checked_attention(errs):
        emb = LMEmbedder(emodel, eparams, out_dim=256).embed_texts(texts)
    torch.cuda.synchronize()
    emb_launches = counts()["flash_attention"] - before
    per_call = check_kernel_calls(errs, "agent LMEmbedder")
    if emb_launches != ecfg.num_layers:
        fail(f"agent: LMEmbedder launched K6 {emb_launches} times")
    norms = emb.norm(dim=1)
    if not torch.allclose(norms, torch.ones_like(norms), atol=1e-5):
        fail("agent: LMEmbedder rows are not unit-norm")
    with plain_attention():
        ref_init_err = float((LMEmbedder(emodel, eparams, out_dim=256)
                              .embed_texts(texts) - emb).abs().max())
    # end to end on the conditioned weights (see `conditioned`)
    embedder = LMEmbedder(emodel, conditioned(eparams, ecfg), out_dim=256)
    emb_c = embedder.embed_texts(texts)
    with plain_attention():
        err = float((embedder.embed_texts(texts) - emb_c).abs().max())
    if not err <= EMBED_TOL:
        fail(f"agent: LMEmbedder differs from its plain path by {err} > "
             f"{EMBED_TOL}")
    out = {"phase": "agent", "users": len(AGENT_USERS), "chat_turns": replies,
           "chat_seconds": t_chat, "launches": launches,
           "facts_returned": len(reqs),
           "lm_extractor": {"triples": len(triples),
                            "summary": summary.text[:60]},
           "lm_embedder": {"texts": len(texts), "dim": int(emb.shape[1]),
                           "k6_launches": emb_launches,
                           "kernel_calls_vs_plain": per_call,
                           "reference_init_max_abs_vs_plain": ref_init_err,
                           "conditioned_max_abs_vs_plain": err},
           "engine": dict(engine.stats), "gpu": gpu_line()}
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20,
                    help="bank rows the serve phases fill to")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed repetitions per measurement")
    ap.add_argument("--serving-times", type=int, default=0, metavar="ROUNDS",
                    help="only time the lm phase's serving run ROUNDS times "
                         "and print its numbers (no checks)")
    ap.add_argument("--src", default=SRC,
                    help="the source tree to import the port from (an A/B "
                         "of --serving-times against another checkout)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(args.src, "repro_torch")):
        sys.exit("chip_smoke: run from a checkout of the repository "
                 f"(no {os.path.join(args.src, 'repro_torch')})")
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "check runs on a CUDA card only")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # full FP32 products everywhere (the plain versions and the library
    # yardsticks included): TF32 keeps ~3 decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.serving_times:
        emit({**serving_times(device, args.serving_times), "src": args.src})
        return 0
    t_start = time.perf_counter()
    # the card's host: the port needs no msgpack (its own codec writes the
    # durable files); whether the package is there is recorded all the same
    probe = subprocess.run([sys.executable, "-c", "import msgpack"],
                           capture_output=True, text=True, timeout=120)
    emit({"host": {"python": sys.version.split()[0],
                   "torch": torch.__version__, "cuda": torch.version.cuda,
                   "msgpack_importable": probe.returncode == 0}})
    build = phase_build()
    kern = phase_kernels(device, args.reps, build)["kernels"]
    attn = phase_attention(device, args.reps, build)["kernels"]
    ops = phase_ops(device)
    templates = make_templates(device)
    reps = max(3, args.reps // 4)
    serve, svc, questions = phase_serve(device, args.rows, reps, templates,
                                        keep=True)
    sched = phase_scheduler(device, svc, questions,
                            os.path.abspath(args.src))
    durable = phase_durability(device, svc, questions, reps,
                               os.path.abspath(args.src))
    del svc, questions
    gc.collect()                   # the f32 service is gone: free its memory
    torch.cuda.empty_cache()
    serve8 = phase_serve(device, args.rows, reps, templates,
                         quantize="int8")
    gc.collect()
    torch.cuda.empty_cache()
    harness = phase_harness(device)
    graph_bench = phase_graph_recall(device)
    lm, engine = phase_lm(device)
    agent = phase_agent(device, engine)
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
        if name == "topk_mips_masked":     # the scheduler, the harness,
            launches += (sched["launches"][name]       # graph bench and
                         + harness["launches"][name]   # recovered service
                         + graph_bench["launches"][name]
                         + durable["launches"][name])
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
    for name, (replaces, source) in ATTN_KERNELS.items():
        r = attn[name]
        if agent["launches"][name] < 1:
            fail(f"{name} was not launched on the agent loop")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": lm["launches"][name],
            "max_abs_err": r["max_abs_err"]["float32"],
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
