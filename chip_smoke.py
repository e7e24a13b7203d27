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
                 label everywhere).  Past k = 2048 the large-k path of all
                 four (`large_k_cases`): at the main shape at k in {2049,
                 4096, 16384, 65536} under labels in which one namespace
                 owns 2**18 rows, each size timed beside its bound, its
                 plain version and `q @ bankᵀ` + `torch.topk(k)`, with
                 each pass's device ms; over 65,536 rows at k = n_valid
                 and past it; an all-tied bank; the device tile plan
                 against its mirror; the served int8 over-fetch shape (64
                 queries of 28-row namespaces, k = 4096; timed, with the
                 workspace's bytes); interleaved query labels, a crowded
                 pivot bin and one past the candidate cap (ids equal).
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
                 alone.  Then admission (8 closed-loop tenants, 200
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
6. sharded     — the serve store's snapshot arrays into
                 `MemoryStore.from_arrays(..., shards=8)` (the same global
                 row ids): the slab layout (rebuild and upload seconds,
                 per-shard rows, capacity, bytes, peak memory); at B in
                 {1, 8, 64} under the hybrid and dense-only plans and B=64
                 under the graph plan, contexts, token counts and dense
                 ranking byte-equal to the unsharded store's for the same
                 requests (the ranking also against K1's plain version
                 over the slabs), K1 once an execute, p50 beside the
                 unsharded store's, peak memory with and without the graph
                 plan (which uploads the index's own bank beside the
                 slabs); `sharded_topk` at Q=64 over the slab bank (masked
                 k=64, unmasked k=256, and k above a shard's rows) against
                 one K1/K3 over the whole bank, S launches a call;
                 degraded serving with the planted namespace's shard down
                 (victims flagged empty, survivors byte-equal, mark_down/up
                 times, /v1/readyz 503 then 200, and the shard taken down
                 from a thread while 8 closed-loop scheduler clients run:
                 every answer healthy-equal or flagged); writes into the
                 down shard's namespaces over 5 flush+retrieve cycles with
                 no bank-sized upload, surfacing after mark_up; then a
                 LifecycleRuntime (a ShardedWal) with a sync follower, 64
                 conversations, 8 group commits, a rotation in the middle,
                 a crash, shard-03/ deleted, `restore_missing_from_follower`
                 and `MemoryService.recover` (8 shards autodetected; seconds
                 by stage): byte-equal contexts, tokens, dense ranking and
                 bank SHA-256 (mirror and slabs), K1 launched.
7. durability  — on the serve phase's f32 store (all rows back on the
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
                 recovery must match what it last made durable.  Beside
                 the phase (subprocesses started at its start, joined at
                 its end): `python -m repro_torch.launch.serve
                 --snapshot-path D` (full-width memori-agent) twice on one
                 directory, the second boot recovering the first's final
                 state, and phase 15's (e).
8. serve_int8  — the same with `MemoryService(quantize="int8")` (int8 bank,
                 K2 plus the exact f32 rescore) at 2**20 rows, under the
                 hybrid and dense-only plans; K2's candidates and the
                 rescored ranking of each execute are held against the
                 plain path, and recall@10 against the exact f32 host
                 search must reach 0.95.
9. harness     — `repro_torch.eval.locomo` at the paper's defaults on the
                 card (Table 1's four systems, Table 2, Figure 2; K1
                 through `MemoriMemory` and `RagChunkMemory`): for memori
                 and rag every question's context and token count must
                 equal the CPU run's, and the accuracy and tokens per query
                 the reference package's figures.
10. graph_recall — `repro_torch.eval.graph_recall` on the card: recall 1/6
                 (flat) -> 2/3 (graph) on the 18 graph questions, 99 nodes
                 and 402 edges after the probe links, and no whole-lane
                 re-upload while the lanes grow within their capacity.
11. attention  — holds the attention kernels K6 (flash_attention) and K5
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
                 instances must not spill (ptxas).  Also the zoo's
                 variants, f32 and bf16: K5 with slot positions (ring
                 caches before, at and past a lap, emptied slots, windows
                 0 / 20 / T) and with int8 codes and scales (and both),
                 K6's prefix mask (scalar and per row), cross-attention at
                 1500 keys; every rejected key filled with garbage must
                 leave the output bit-equal.  The bf16 instances run on the
                 tensor cores: each of K6's head-dim classes (64, 128, 192,
                 256, 576) in its wide and its narrow (2-, 4- and 8-way
                 key-split cluster) shape, with K/V by tensor-map copies and
                 by plain loads (D = 50, 100, 180, 250, 515), causal,
                 bidirectional, windowed, S != T, strided, the prefix mask
                 scalar and per row, each checked to take its path.  K6 at
                 per-row position offsets (`OFFSET_CASES`, f32 and bf16):
                 causal, a window with queries ahead of their keys, the
                 prefix mask, keys below position 0, D = 576.
12. lm         — `memori-agent` at full width (12 layers, d_model 768,
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
13. agent      — `MemoriClient` over `MemoryService(device="cuda")` with the
                 engine as its LLM: users record facts through chat +
                 end_session and `retrieve_batch` must return each user's
                 fact and no other's (K1, K5 and K6 all launched);
                 `LMExtractor` over the engine extracts one session;
                 `LMEmbedder` (memori-embedder width) embeds the recorded
                 triples through K6 (bidirectional): each call held against
                 the plain version, the embeddings against the plain path.
17. examples   — (after agent) the port's two examples through their
                 `run("cuda")`, counters reset around each and every plain
                 version refused: `repro_torch.examples.quickstart` (K1;
                 recovered answers identical) and `agent_serve` (K1, the
                 engine's K6 prefill and K5 decode; each tenant's pet fact
                 and no other's; 2 scheduled retrieves).  Then the large-k
                 path through the public entry points (`large_k_path`):
                 `VectorIndex.search_batch` at k = 4096 (K1), an int8 index
                 over-fetching 4096 (K2), `sharded_topk` (K3 a slab) and
                 `ops.topk_mips_quant` (K4) at k = 4096, each held against
                 the plain versions.

14. zoo        — the rest of the model zoo at full width in bf16, random
                 weights from a seed (attention projections at unit score
                 spread, see `unit_scores`), one arch at a time, freed
                 before the next: phi3.5-moe (4 of 32 layers; MoE top-2 of
                 16) and deepseek-v3 (4 of 61: 3 dense + the first MoE
                 layer, MLA, 256 experts top-8 + the shared one, MTP
                 specs) through `Engine` (phi3.5 again with the int8 KV
                 cache: K5's int8 variant), recurrentgemma-9b (38 layers,
                 RG-LRU + local attention, max_len 4096, prompts past 2048
                 tokens: the ring cache, K5's slot-position variant) and
                 mamba2-2.7b (64 layers, SSD) through `Engine`,
                 whisper-small (12 + 12: the encoder and cross-attention
                 through K6, cross decode through K5) and paligemma-3b (18;
                 the 256-position image prefix: K6's prefix variant)
                 through `Model.prefill` / `decode_step` with seeded stub
                 audio / images.  For each: launch counters reset around
                 the main path (K5 once an attention layer a decode step,
                 each variant too; K6 once an attention layer a prefill),
                 prefill ms a request, decode step ms, tokens/s, peak
                 memory; a replayed step against an eager one; a profiled
                 step and the MoE / SSM / RG-LRU / MLA-decode / K5 share of
                 an eager step; every K5/K6 call of a teacher-forced run
                 against its plain version, the teacher-forced logits
                 against the plain path (within 2**-5 of the logit scale)
                 and prefill + decode against the full forward (2**-5;
                 mamba2 2**-5 per 16 layers, its bf16 roundings adding up
                 over 64 layers, with the same weights at f32 held to
                 2**-10), and greedy tokens against the plain path (a
                 divergence must sit at a near-tie); phi3.5 all of it again
                 with the int8 cache (against the full forward within the
                 reference's int8 gate, 5%).  Every zoo launch of K5 and K6
                 must be a tensor-core instance (their counters).  Then
                 each bf16 instance at its arch's shape (and K6 at
                 internlm2's train shape): CUDA-event ms a call and the
                 kernel's own device ms (profiler; its kernels must be the
                 tensor-core ones), resident CTAs an SM, beside its plain
                 version, its bound (bf16 operations at the bf16
                 tensor-core rate) and `scaled_dot_product_attention`
                 (event and device ms) where one call computes it.
15. train      — training on the card.  (a) K6's gradient: the autograd
                 Function's dq/dk/dv (K6 forward, torch-ops backward)
                 against autograd through the plain version over causal,
                 window, prefix (int and per-row tensor), bidirectional and
                 cross (S != T) masks, G in {1, 3, 4, 16}, D in {64, 128,
                 192, 256}, S off the backward's block, f32 and bf16
                 (TRAIN_GRAD_TOL).  (b) `memori-agent` at full width, f32,
                 as `repro_torch.examples.train_100m` trains it (B = 8,
                 S = 256, on the data pipeline, its optimizer
                 settings; 160 of its 200 steps) but from the conditioned
                 weights (at the
                 reference's init the 12-layer gradient norm is ~1e6 and ce
                 stays flat: TRAIN_CE_DROP), counters reset around the run:
                 K6 exactly 2 x 12 a step (each layer's forward and its
                 recompute), ce falling by the reference's 0.2; step 1's
                 loss and every leaf's gradient against the plain path on
                 the same batch (reported at the reference's init too); the
                 checkpoint read back bit-equal; step ms, tokens/s, peak
                 memory, FLOPs and their share of the FP32 peak; one
                 profiled step (K6 forward, attention backward, GEMMs,
                 optimizer, kernels, idle share); two samples through
                 `Engine` (K6 and K5 launched).  (c) `internlm2-1.8b` at
                 full width and depth in bf16 through
                 `launch.sharding.build_train_step`, B = 2, S = 4096, 3
                 steps: finite loss and gradient norm, step 1's loss
                 against the plain path's, K6 exactly 2 x 24 a step.  (d)
                 one train step of every assigned arch, reduced, f32,
                 against the plain path (loss and every leaf's gradient).
                 (e) `python -m repro_torch.launch.train --arch
                 internlm2-1.8b --shape train_4k --steps 3 --host-demo`
                 (run beside phase 7).

16. dist       — the distribution slices (M7b, M7c) on a one-rank NCCL mesh
                 (DIST_MESH: gloo moves CUDA tensors for its raw
                 collectives here, but DTensor's functional collectives on
                 a gloo group of CUDA tensors kill the ranks, and NCCL takes
                 one rank a card; several ranks are the CPU tests'), in two
                 parts.  After the sharded phase, on the serve store: its
                 arrays into `MemoryStore.from_arrays(..., shards=8,
                 mesh=)` — contexts, token counts and dense ranking
                 byte-equal to the unmeshed store at B in {1, 8, 64}, hybrid
                 and dense-only, K1 once a rank an execute, p50 beside the
                 sharded phase's; the meshed `sharded_topk` against one K1
                 over the bank; the meshed service through a
                 MemoryScheduler (every tick broadcast over the mesh's gloo
                 group) by 8 closed-loop clients, answers byte-equal to
                 the unmeshed service's scheduled run, K1 once a rank an
                 execute, and a MemoryFrontend over it (sessions recorded
                 and asked back over HTTP, each answer byte-equal to the
                 scheduler's); memori-agent (f32, conditioned) step 1's
                 loss and every leaf's gradient on the mesh against the
                 one-device step, 5 steps of `build_train_step(mesh)`
                 beside the one-device step's ms; greedy tokens through
                 `build_prefill_step` / `build_decode_step` on the mesh
                 against the Engine's.  After the train phase: deepseek-v3
                 at full width in bf16 with `mla_absorbed_train` (K6's
                 D = 576 instance): a 4-layer prefill, every K6 call against
                 its plain version, the logits against the decompressed
                 path's (2**-5 of the scale); context-parallel long_500k
                 decode (`build_decode_step(..., context_parallel=True)`:
                 the caches placed by `long_context_rules`, K5[lse] or
                 MLA's local softmax on the rank's rows, the combine) of
                 internlm2-1.8b (24 layers, its 8,192-slot ring) and
                 deepseek-v3 (4 layers, the 524,288-row latent cache) with
                 seeded rows up to position 500,000: 3 steps' logits
                 against the one-device step (2**-5 of the scale), K5[lse]
                 once per attention layer a step, step ms and peak
                 memory; K5[lse] against its plain version at seven
                 instances (f32 at the agent's shape, the bf16 ring,
                 int8, a 32,768-row bf16 shard; the tensor-core instance
                 at G = 16, 8 and 1), and each cache cut into
                 1, 4 and 16 shards whose `combine_partials` equals the
                 whole call; one train step at 2 layers
                 (and the MTP block) through FlashAttentionFn; the instance's
                 ms at G = 128, S = T = 512 beside its plain version, SDPA
                 and its bound.  The attention phase holds the instance
                 against its plain version too (ABSORBED_CASES).

Before the phases one line records the host (Python, torch, CUDA, and
whether `import msgpack` works there: the port does not need it).  The
last three lines are the kernels' summary, the card's name and power
limit (as nvidia-smi reports them), and `{"ok": true, "device": {...}}`.
The script needs the repository's `src/` beside it and a CUDA card; without
either it exits nonzero before printing any result.  The dist phase's
process group lives in a temporary directory's FileStore (no TCP port) and
is destroyed before the summary.

`--serving-times N` only times the lm phase's serving run N times and
prints its prefill, decode-step and tokens/s numbers; with `--src DIR` it
imports the port from another checkout's `src`, so one card compares two
commits by the same code:

    for src in parent/src src src parent/src; do
        python3 chip_smoke.py --serving-times 5 --src $src; done

`--topk-times` only builds the kernels and times K1-K4's scan kernel at
the main shape and their large-k path (each pass's device ms) at the
main shape and the served int8 over-fetch shape (with `--src`, another
checkout's).  `--attention-times`
only builds the kernels and times every K5/K6
instance (`attention_times`: the zoo's and train's bf16 instances, D =
576, K5[lse], the agent's f32 ones) with ptxas's registers; with `--src`
it times another checkout's kernels by the same code.  `--train-times N`
only builds the kernels and times internlm2-1.8b's train step (B = 2, S =
4096) over N steps, with `--src` another checkout's.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# published H100 SXM rates (NVIDIA data sheet, dense): HBM3 bandwidth, the
# plain (non-tensor-core) FP32 rate, the only rate an exact-f32 kernel uses,
# and the bf16 tensor-core rate, the least time for bf16 operands
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
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
# k of the large-k path's checks at the main shape (past MAX_K = 2048), the
# bank of its k = n_valid and k > n_valid cases, and its k on the examples
# phase's main-path searches
LARGE_KS = (2049, 4096, 16384, 65536)
LARGE_SMALL_N = 65536
LARGE_PATH_K = 4096
# the served int8 over-fetch shape of the large-k path: B queries, each of
# its own ~28-row namespace (the serve store's conversations) of MAIN_N
# rows, at k = pow2(pool x rescore) past MAX_K; and the rows and ks of the
# large-k path's hard cases (interleaved labels, crowded pivot bins)
SERVED_B, SERVED_NS_ROWS, SERVED_K = 64, 28, 4096
LARGE_HARD_N, LARGE_HARD_KS = 1 << 18, (4096, 30000)
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
# the K5 / K6 variants of the zoo (other template instances of K5, a mask
# of K6): the TPU kernel each replaces and its source
ATTN_VARIANTS = {
    "decode_attention[slot_pos]": ATTN_KERNELS["decode_attention"],
    "decode_attention[int8]": ATTN_KERNELS["decode_attention"],
    "flash_attention[prefix]": ATTN_KERNELS["flash_attention"],
}
# K6 at per-row position offsets: (B, K, G, S, T, D, causal, window, prefix,
# (query offsets, key offsets)): the agent's prefill (f32 narrow, bf16
# key-split) and a window with queries ahead of their keys, a wide shape
# (G 2, D 128, 1,024 rows), paligemma's image prefix (an int and per row),
# whisper's cross-attention with keys below position 0, MLA's D = 576
OFFSET_CASES = [
    (2, 4, 3, 150, 150, 64, True, 0, None, ([3, 17], [3, 17])),
    (2, 4, 3, 150, 154, 64, True, 16, None, ([9, 20], [5, 16])),
    (2, 8, 2, 1024, 1024, 128, True, 0, None, ([100, 7], [100, 7])),
    (2, 1, 8, 320, 320, 256, True, 0, 256, ([0, 5], [0, 5])),
    (2, 1, 8, 320, 320, 256, True, 16, [256, 200], ([4, 0], [4, 0])),
    (2, 12, 1, 64, 1500, 64, False, 0, None, ([0, 3], [-5, -9])),
    (1, 1, 16, 100, 100, 576, True, 0, None, ([40], [40])),
]
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


T_IMPORT = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's elapsed
    seconds (`elapsed_s`)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_IMPORT}
    print(json.dumps(obj), flush=True)


class Background:
    """`fn(*args)` on a thread of its own (a check that waits on
    subprocesses, run beside host-bound work); `result()` joins it and
    returns its value or raises what it raised."""

    def __init__(self, fn, *args):
        import threading
        self._out = {}

        def run():
            try:
                self._out["value"] = fn(*args)
            except BaseException as e:          # fail()'s SystemExit too
                self._out["error"] = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def wrappers():
    """Every launch counter: the kernels' wrappers, and the K5/K6 variants'
    counters (counted besides their kernel's)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import topk_mips as tk
    out = {name: getattr(tk, name) for name in KERNELS}
    out.update(flash_attention=fa.flash_attention,
               decode_attention=da.decode_attention)
    out.update({c.__name__: c for c in (  # (an older tree, --src, lacks some)
        getattr(m, name, None) for m, name in (
            (da, "slot_launches"), (da, "int8_launches"), (da, "lse_launches"),
            (da, "tc_launches"), (fa, "prefix_launches"), (fa, "tc_launches"),
            (fa, "offset_launches"), (tk, "large_launches")))
        if c is not None})
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
            if t.group(2):      # template arguments: types, then literals
                a = re.match(r"((?:f|a|\d+__nv_bfloat16|S\d*_)*)"
                             r"((?:L[bi]\d+E)*)", mangled[t.end():])
                # float, signed char, __nv_bfloat16 (a repeat of it is a
                # substitution S_: the only substitutable type here)
                types = [{"f": "f32", "a": "i8"}.get(x, "bf16") for x in
                         re.findall(r"f|a|\d+__nv_bfloat16|S\d*_",
                                    a.group(1))]
                args = types + re.findall(r"L[bi](\d+)E", a.group(2))
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


def compare_topk(s_k, i_k, s_r, i_r, what: str, slack=None,
                 ordered: bool = True) -> float:
    """Hold kernel output (s_k, i_k) against the plain version's (s_r, i_r):
    the same live slots, scores within rtol/atol (plus `slack`, a (Q, k)
    summation-order bound, where given), and ids equal wherever a score is
    separated from both neighbours by more than that tolerance (within a
    closer run the two summation orders may swap neighbours).  `ordered`:
    the kernel's (score desc, row asc) order is checked too (not for an
    int8 search's rescored answer, whose exact ties keep the candidates'
    order).  Returns the largest absolute score difference."""
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
    if not ordered:
        return err
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
    large = large_k_cases(gen, device, max(2, reps // 5))
    out = {"phase": "kernels", "sizes": list(KERNEL_SIZES), "ks": list(KERNEL_KS),
           "tolerance": {"rtol": RTOL, "atol": ATOL,
                         "int8": "plus 2*D*u*scale*sum|q*codes| (u = 2**-24)"},
           "kernels": res, "large_k": large, "gpu": gpu_line()}
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


# -- the large-k path (k > MAX_K) ----------------------------------------------

def large_k_bound_ms(Q: int, n_valid: int, entries: int, D: int, k: int,
                     quant: bool, masked: bool, pairs: int):
    """Least time of one large-k call on the card, from what the function
    needs: the queries, the bank rows it must read (the live prefix, or a
    masked call's compacted rows, `entries` a query), both label vectors
    (masked) and the (Q, k) outputs, over 3.35 TB/s; against 2*D flops per
    scored (query, entry) pair (`pairs`, plus the int8 multiply) at the
    FP32 rate.  The path's own workspace traffic is not in it
    (`large_k_workspace_bytes`)."""
    row_bytes = D + 4 if quant else 4 * D
    labels = 4 * (Q + n_valid) if masked else 0
    bytes_moved = 4 * Q * D + entries * row_bytes + labels + 8 * Q * k
    flops = 2.0 * D * pairs + (pairs if quant else 0)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def large_k_workspace_bytes(Q: int, entries: int, k: int) -> int:
    """The bytes the large-k path's design moves through its device
    workspace, beyond what the function needs: a 4-byte key per (query,
    entry) written once and read twice (the first digit's histogram and
    the filter; a heavy query's four more reads are not counted), and
    8-byte sort keys per survivor (min(k, entries) a query) written by the
    filter, then read and written by the run sort and each merge round
    (the last stage writes the outputs instead, which the bound counts).
    The candidates (the pivot bin's keys, 8 bytes written and read once)
    depend on the scores and are not counted.  A record beside the bound,
    not part of it."""
    survivors = Q * min(k, entries)
    rounds = max(0, (max(1, -(-min(k, entries) // 16384)) - 1).bit_length())
    return 12 * Q * entries + 16 * survivors * (1 + rounds)


def all_device_ms(fn, reps: int) -> float:
    """Mean device time a call of `fn` over every kernel and memset it runs
    (`device_profile` with no tag)."""
    return device_profile(fn, reps, "")[0]


def large_k_inputs(gen, device, N: int, Q: int, big: float):
    """A unit-norm bank of N rows with its int8 codes, labels in which
    namespace 0 owns a `big` share of the rows and ~1400-row namespaces the
    rest (2% tombstones), three planted duplicate rows in namespace 0, and
    Q unit-norm queries: the even ones ask namespace 0 (query 0 is a
    duplicate's row), the odd ones a random small namespace."""
    import torch
    from repro_torch.kernels import topk_mips as tk
    bank = torch.randn((N, D), generator=gen, device=device)
    bank /= bank.norm(dim=1, keepdim=True)
    lab = torch.randint(1, max(2, N // 1400), (N,), generator=gen,
                        device=device, dtype=torch.int32)
    lab[torch.rand(N, generator=gen, device=device) < big] = 0
    lab[torch.rand(N, generator=gen, device=device) < 0.02] = -1
    dups = [5, N // 3, N // 2 + 7]
    bank[dups] = bank[5].clone()
    lab[dups] = 0
    codes, scales = tk.quantize_rows_ref(bank)
    q = torch.randn((Q, D), generator=gen, device=device)
    q /= q.norm(dim=1, keepdim=True)
    q[0] = bank[5]
    q_ns = torch.randint(1, max(2, N // 1400), (Q,), generator=gen,
                         device=device, dtype=torch.int32)
    q_ns[::2] = 0
    return bank, codes, scales, lab, q, q_ns, dups


def check_large(fn, ref, args, k: int, n_valid: int, what: str,
                dups=None):
    """One large-k call of wrapper `fn` against its plain version `ref`
    (`compare_topk`, the int8 slack for the quantized pair); it must run
    the large-k path (one launch of `topk_mips[large_k]`), and with `dups`
    query 0's planted duplicate rows must tie side by side in row order.
    Returns (largest score error, live slots, whether the ids equal the
    plain version's everywhere)."""
    import torch
    from repro_torch.kernels import topk_mips as tk
    q, bank, codes, scales, q_ns, lab, masked, quant = args
    before = tk.large_launches.launches
    s_k, i_k = _call(fn, *args, k=k, n_valid=n_valid)
    if tk.large_launches.launches != before + 1:
        fail(f"{what}: the call did not run the large-k path")
    s_r, i_r = _call(ref, *args, k=k, n_valid=n_valid)
    torch.cuda.synchronize()
    slack = quant_slack(q, codes, scales, i_r) if quant else None
    err = compare_topk(s_k, i_k, s_r, i_r, what, slack)
    if dups is not None:
        row = i_k[0].tolist()
        pos = [row.index(d) if d in row else -1 for d in dups]
        if pos[0] < 0 or pos != list(range(pos[0], pos[0] + 3)):
            fail(f"{what}: duplicate rows do not tie side by side")
    return err, int((i_k >= 0).sum()), bool(torch.equal(i_k, i_r))


# the large-k path's passes, by the names of the kernels that make each
# (this tree's and the parent's, for an A/B): the tile plan and label
# compaction, the score pass, the radix select with its filters, the sort
# runs and merge rounds (whose last stage writes the outputs), and the
# parent's separate output pass
LARGE_PASSES = (("compact", ("topk_count_kernel", "topk_compact_kernel",
                             "topk_group_")),
                ("score", ("topk_score_kernel",)),
                ("select", ("topk_radix_", "topk_select_", "topk_filter_")),
                ("sort", ("topk_sort_runs", "topk_merge_runs")),
                ("emit", ("topk_emit_kernel",)))


def large_split_ms(fn, reps: int) -> dict:
    """Mean device ms per call of the large-k path's passes (LARGE_PASSES;
    memsets and the rest as `other`) and of each kernel (`kernels`), from
    a profile of `reps` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    import re
    split = {name: 0.0 for name, _ in LARGE_PASSES}
    split["other"] = 0.0
    kernels = {}
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        part = next((name for name, tags in LARGE_PASSES
                     if any(t in e.key for t in tags)), "other")
        split[part] += e.device_time_total
        m = re.search(r"topk_\w+_kernel(<[^>]*>)?", e.key)
        name = m.group(0) if m else e.key[:40]
        kernels[name] = kernels.get(name, 0.0) + e.device_time_total / 1e3 / reps
    out = {part: t / 1e3 / reps for part, t in split.items()}
    out["kernels"] = kernels
    return out


def large_modes(s, ok, k: int, n_valid: int) -> dict:
    """How many queries take each select mode of the large-k path on scores
    s (Q, N) where `ok` (live and matching): `all` (fewer live entries
    than k), `filtered` (the k-th key's first-digit bin within the
    candidate cap, `large_cap`) or `heavy` (past it), counted from the
    plain scores' order-preserving keys; and the most entries that tie
    with a query's k-th score."""
    import torch
    from repro_torch.kernels import topk_mips as tk
    s = torch.where(s == 0, torch.zeros_like(s), s)    # -0 ranks as +0
    bits = s.contiguous().view(torch.int32).to(torch.int64) & 0xffffffff
    key = torch.where(bits >= 2 ** 31, (~bits) & 0xffffffff, bits | 2 ** 31)
    key = torch.where(ok, key, torch.zeros_like(key))
    live = ok.sum(1)
    kth = torch.topk(key, min(k, key.shape[1]), dim=1).values[:, -1]
    c0 = (((key >> 21) == (kth >> 21)[:, None]) & ok).sum(1)
    ties = ((key == kth[:, None]) & ok).sum(1)
    cap = tk.large_cap(n_valid, k)
    full = live >= k
    return {"all": int((~full).sum()),
            "filtered": int((full & (c0 <= cap)).sum()),
            "heavy": int((full & (c0 > cap)).sum()),
            "most_ties_at_kth": int(torch.where(full, ties, 0).max())}


def plain_scores(q, bank, codes, scales, q_ns, lab, masked, quant,
                 n_valid):
    """The plain scores (Q, N) of a call and where they count (live and,
    masked, matching labels)."""
    import torch
    s = (q @ codes.float().T) * scales if quant else q @ bank.T
    ok = torch.arange(bank.shape[0], device=q.device)[None, :] < n_valid
    if masked:
        ok = ok & (q_ns[:, None] == lab[None, :])
    return s, ok.expand_as(s)


def large_plan_check(device) -> dict:
    """The device tile plan (`topk_group_plan_kernel`, through the C entry
    `topk_mips_large_plan`) against `group_tiles`, the wrapper's mirror,
    on label vectors that take each branch: one label, all distinct,
    interleaved labels with singletons, a label of exactly GROUP_MIN and
    GROUP_MIN - 1, a label past one tile, and PLAN_MAX queries."""
    import ctypes
    import torch
    from repro_torch.kernels import topk_mips as tk
    g = torch.Generator().manual_seed(5)
    layouts = {
        "one label": [3] * 70,
        "distinct": list(range(64, 0, -1)),
        "interleaved": [i % 6 if i % 6 < 5 else 100 + i for i in range(130)],
        "group_min edge": [7] * tk.GROUP_MIN + [9] * (tk.GROUP_MIN - 1)
        + [2] * 5,
        "past a tile": [1] * 45 + [0] * 3 + [1] * 30,
        "plan max": torch.randint(-3, 300, (tk.PLAN_MAX,),
                                  generator=g).tolist()}
    lib = tk._library()
    out = {}
    for name, labels in layouts.items():
        qc = len(labels)
        t = tk.group_tiles_max(qc)
        q_ns = torch.tensor(labels, dtype=torch.int32, device=device)
        slots = torch.empty(t * tk.GROUP_TILE, dtype=torch.int32,
                            device=device)
        slot_ns = torch.empty_like(slots)
        n_tiles = torch.empty(1, dtype=torch.int32, device=device)
        rc = lib.topk_mips_large_plan(
            ctypes.c_void_p(q_ns.data_ptr()), qc,
            ctypes.c_void_p(slots.data_ptr()),
            ctypes.c_void_p(slot_ns.data_ptr()),
            ctypes.c_void_p(n_tiles.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
        if rc != 0:
            fail(f"large-k plan {name}: CUDA error {rc}")
        torch.cuda.synchronize()
        nt = int(n_tiles.item())
        rows = slots.view(t, tk.GROUP_TILE)[:nt].tolist()
        got = [[x for x in r if x >= 0] for r in rows]
        want = tk.group_tiles(labels)
        if got != want:
            fail(f"large-k plan {name}: device tiles {got} != {want}")
        if any(r[len(w):] != [-1] * (tk.GROUP_TILE - len(w))
               for r, w in zip(rows, want)):
            fail(f"large-k plan {name}: a tile's slots are not a prefix")
        lab_rows = slot_ns.view(t, tk.GROUP_TILE)[:nt].tolist()
        if any(lab_rows[i][j] != labels[q] for i, w in enumerate(want)
               for j, q in enumerate(w)):
            fail(f"large-k plan {name}: slot labels differ")
        out[name] = {"queries": qc, "tiles": nt, "tiles_max": t}
    return out


def served_inputs(gen, device):
    """The served int8 over-fetch shape's inputs: a unit-norm MAIN_N-row
    bank with its int8 codes, SERVED_NS_ROWS-row namespaces in row order
    (2% tombstones), SERVED_B unit-norm queries of distinct namespaces."""
    import torch
    from repro_torch.kernels import topk_mips as tk
    N = MAIN_N
    bank = torch.randn((N, D), generator=gen, device=device)
    bank /= bank.norm(dim=1, keepdim=True)
    codes, scales = tk.quantize_rows_ref(bank)
    lab = (torch.arange(N, device=device) // SERVED_NS_ROWS).to(torch.int32)
    lab[torch.rand(N, generator=gen, device=device) < 0.02] = -1
    q_ns = torch.randperm(N // SERVED_NS_ROWS, generator=gen,
                          device=device)[:SERVED_B].to(torch.int32)
    q = torch.randn((SERVED_B, D), generator=gen, device=device)
    q /= q.norm(dim=1, keepdim=True)
    return bank, codes, scales, lab, q, q_ns


def served_large_case(gen, device, reps: int) -> dict:
    """The served int8 over-fetch shape of the large-k path (SERVED_*):
    SERVED_B queries, each asking its own SERVED_NS_ROWS-row namespace of a
    MAIN_N-row bank (an int8 index at rescore 8 over-fetches pow2(8 k)
    candidates: K2, and K1 at the same k), held against the plain
    version; timed (CUDA-event ms, device ms and its passes), beside the
    workspace's bytes, the bound of these labels (`masked_work`), the
    plain version and `q @ bankᵀ` + mask + `torch.topk(k)`."""
    import torch
    from repro_torch.common.utils import sm_count
    from repro_torch.kernels import topk_mips as tk
    N, Q, k = MAIN_N, SERVED_B, SERVED_K
    bank, codes, scales, lab, q, q_ns = served_inputs(gen, device)
    rows, pairs = tk.masked_work(q_ns, lab, N)
    sms = sm_count(device)
    out = {"queries": Q, "rows": N, "k": k, "namespace_rows": SERVED_NS_ROWS}
    for name in ("topk_mips_quant_masked", "topk_mips_masked"):
        _, masked, quant, _ = KERNELS[name]
        args = (q, bank, codes, scales, q_ns, lab, masked, quant)
        fn, ref = getattr(tk, name), getattr(tk, name + "_ref")
        err, live, same = check_large(fn, ref, args, k, N,
                                      f"{name} served k={k} B={Q}")
        if not same:
            fail(f"{name} served k={k}: ids differ from the plain version")

        def call():
            return _call(fn, *args, k=k, n_valid=N)

        def library():
            s, ok = plain_scores(*args, N)
            return torch.topk(torch.where(ok, s, NEG_INF), k, dim=1)

        qc = tk.large_k_chunk(Q, N, k, masked, D, sms)
        bound, by = large_k_bound_ms(Q, N, rows, D, k, quant, masked, pairs)
        out[name] = {
            "kernel_ms": time_ms(call, reps),
            "device_ms": all_device_ms(call, reps),
            "passes": large_split_ms(call, reps),
            "plain_ms": time_ms(lambda: _call(ref, *args, k=k, n_valid=N), 1),
            "library_ms": time_ms(library, 2),
            "bound_ms": bound, "bound_by": by, "live_slots": live,
            "max_abs_err": err, "chunk_queries": qc,
            "workspace_bytes": tk.large_workspace_bytes(qc, N, k, masked, D,
                                                        sms)}
    return out


def large_k_hard_cases(gen, device) -> dict:
    """The large-k path's hard cases, each kernel against its plain version
    with the ids required equal (integer-valued rows and queries, so that
    both summation orders are exact and every tie is decided by row), over
    LARGE_HARD_N rows at each k of LARGE_HARD_KS: `interleaved` -- 130
    queries whose labels cycle through 0..4 with a query of its own small
    namespace every sixth, so that a chunk's plan gives each of the five
    labels tiles of its own and packs the rest, and 8 of a label that owns
    no row (a tile with no entry); the same again in chunks of 50 queries; `crowded` -- rows and
    queries of entries in {-1, 0, 1}: ~60 distinct scores, thousands of
    rows tied on both sides of the k-th, its first-digit bin within the
    candidate cap; `past the cap` -- rows of 0/1 entries against all-ones
    queries, half the rows in the k-th key's bin (the heavy select).  The
    modes the queries take are counted from the plain scores
    (`large_modes`); each case must take the mode it is there for."""
    import torch
    from repro_torch.kernels import topk_mips as tk
    N = LARGE_HARD_N
    n_valid = N - 123
    out = {}
    tern = torch.randint(-1, 2, (N, D), generator=gen, device=device).float()
    q_tern = torch.randint(-1, 2, (138, D), generator=gen,
                           device=device).float()
    lab = torch.randint(0, 5, (N,), generator=gen, device=device,
                        dtype=torch.int32)
    small = torch.rand(N, generator=gen, device=device) < 0.1
    lab[small] = torch.randint(5, 40, (int(small.sum()),), generator=gen,
                               device=device, dtype=torch.int32)
    lab[n_valid:] = -2
    q_ns = torch.tensor([i % 6 if i % 6 < 5 else 5 + i // 6 % 35
                         for i in range(130)] + [10 ** 6] * 8,
                        dtype=torch.int32, device=device)
    binary = torch.randint(0, 2, (N, D), generator=gen,
                           device=device).float()
    cases = {"interleaved": (tern, q_tern, lab, q_ns, "masked"),
             "crowded": (tern, q_tern[:64], torch.zeros_like(lab),
                         torch.zeros(64, dtype=torch.int32, device=device),
                         None),
             "past the cap": (binary, torch.ones((16, D), device=device),
                              torch.zeros_like(lab),
                              torch.zeros(16, dtype=torch.int32,
                                          device=device), None)}
    want_mode = {"interleaved": "filtered", "crowded": "filtered",
                 "past the cap": "heavy"}
    for case, (bank, q, labels, qns, only) in cases.items():
        codes, scales = tk.quantize_rows_ref(bank)
        for k in LARGE_HARD_KS:
            for name, (_, masked, quant, _) in KERNELS.items():
                if only == "masked" and not masked:
                    continue
                args = (q, bank, codes, scales, qns, labels, masked, quant)
                what = f"{name} large {case} k={k} N={N}"
                err, _, same = check_large(
                    getattr(tk, name), getattr(tk, name + "_ref"), args, k,
                    n_valid, what)
                if not same:
                    fail(f"{what}: ids differ from the plain version")
                modes = large_modes(*plain_scores(*args, n_valid), k,
                                    n_valid)
                if modes[want_mode[case]] == 0:
                    fail(f"{what}: no query took the "
                         f"{want_mode[case]} select ({modes})")
                out[f"{case} {name} k={k}"] = {"max_abs_err": err, **modes}
    # the interleaved queries again in chunks of 50 (a smaller workspace
    # aim): each chunk plans, compacts and selects on its own
    from repro_torch.common.utils import sm_count
    k = LARGE_HARD_KS[0]
    aim = tk.LARGE_WORKSPACE
    tk.LARGE_WORKSPACE = tk.large_workspace_bytes(50, n_valid, k, True, D,
                                                  sm_count(device))
    try:
        qc = tk.large_k_chunk(q_tern.shape[0], n_valid, k, True, D,
                              sm_count(device))
        if not qc < q_tern.shape[0]:
            fail(f"large-k chunks: one chunk of {qc} queries")
        for name in ("topk_mips_masked", "topk_mips_quant_masked"):
            _, masked, quant, _ = KERNELS[name]
            codes, scales = tk.quantize_rows_ref(tern)
            args = (q_tern, tern, codes, scales, q_ns, lab, masked, quant)
            what = f"{name} large interleaved in chunks of {qc} k={k}"
            err, _, same = check_large(getattr(tk, name),
                                       getattr(tk, name + "_ref"), args, k,
                                       n_valid, what)
            if not same:
                fail(f"{what}: ids differ from the plain version")
            out[f"chunks {name} k={k}"] = {"max_abs_err": err,
                                           "chunk_queries": qc}
    finally:
        tk.LARGE_WORKSPACE = aim
    return out


def large_k_cases(gen, device, reps: int) -> dict:
    """The large-k path of all four kernels against their plain versions:
    at the main shape (Q = 64, N = 2**20, D = 256; namespace 0 owns a
    quarter of the rows, 2**18, so that a large k is really selected, the
    odd queries ask ~1400-row namespaces and are mostly fill) at every k of
    LARGE_KS, each size timed (CUDA-event ms, the device ms of all its
    kernels and of each pass, its bound, the plain version and `q @ bankᵀ`
    (+ mask) + `torch.topk(k)`); over LARGE_SMALL_N rows at k = n_valid
    and past it; over an all-tied bank, whose ids must be the first k live
    rows in order; the device tile plan against its mirror
    (`large_plan_check`); the served int8 over-fetch shape
    (`served_large_case`); interleaved labels and crowded pivot bins
    (`large_k_hard_cases`)."""
    import torch
    from repro_torch.kernels import topk_mips as tk
    res = {name: {"cases": 0, "max_abs_err": 0.0, "sizes": {}}
           for name in KERNELS}
    Q, N = 64, MAIN_N
    n_valid = N - 1000
    bank, codes, scales, lab, q, q_ns, dups = large_k_inputs(
        gen, device, N, Q, 0.25)
    lab[n_valid:] = -2
    rows, pairs = tk.masked_work(q_ns, lab, n_valid)
    for k in LARGE_KS:
        for name, (_, masked, quant, _) in KERNELS.items():
            args = (q, bank, codes, scales, q_ns, lab, masked, quant)
            fn, ref = getattr(tk, name), getattr(tk, name + "_ref")
            what = f"{name} large k={k} Q={Q} N={N}"
            err, live, _ = check_large(fn, ref, args, k, n_valid, what, dups)
            r = res[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["cases"] += 1

            def call():
                return _call(fn, *args, k=k, n_valid=n_valid)

            def library():
                s = ((q @ codes.float().T) * scales if quant
                     else q @ bank.T)
                ok = torch.arange(N, device=device)[None, :] < n_valid
                if masked:
                    ok = ok & (q_ns[:, None] == lab[None, :])
                return torch.topk(torch.where(ok, s, NEG_INF), k, dim=1)

            entries = rows if masked else n_valid
            bound, by = large_k_bound_ms(Q, n_valid, entries, D, k, quant,
                                         masked, pairs if masked
                                         else Q * n_valid)
            work = large_k_workspace_bytes(Q, entries, k)
            r["sizes"][str(k)] = {
                "kernel_ms": time_ms(call, reps),
                "device_ms": all_device_ms(call, reps),
                "passes": large_split_ms(call, reps),
                "plain_ms": time_ms(lambda: _call(ref, *args, k=k,
                                                  n_valid=n_valid), 1),
                "library_ms": time_ms(library, 2),
                "bound_ms": bound, "bound_by": by, "workspace_bytes": work,
                "workspace_ms": work / HBM_BYTES_PER_S * 1e3,
                "max_abs_err": err, "live_slots": live}
    del bank, codes, scales, lab, q, q_ns
    # k = n_valid and past it, over LARGE_SMALL_N rows
    N, Q = LARGE_SMALL_N, 7
    n_valid = N - 300
    bank, codes, scales, lab, q, q_ns, dups = large_k_inputs(
        gen, device, N, Q, 0.4)
    lab[n_valid:] = -2
    for k in (n_valid, n_valid + 4000):
        for name, (_, masked, quant, _) in KERNELS.items():
            args = (q, bank, codes, scales, q_ns, lab, masked, quant)
            err, _, _ = check_large(
                getattr(tk, name), getattr(tk, name + "_ref"), args, k,
                n_valid, f"{name} large k={k} N={N} n_valid={n_valid}", dups)
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            res[name]["cases"] += 1
    # an all-tied bank: every live score equal, so the ids are the first k
    # live (matching) rows in row order -- the select's tie rule
    bank = torch.ones((N, D), device=device)
    codes, scales = tk.quantize_rows_ref(bank)
    for k in (4096, 40000):
        for name, (_, masked, quant, _) in KERNELS.items():
            args = (q, bank, codes, scales, q_ns, lab, masked, quant)
            what = f"{name} large k={k} all tied"
            err, _, same = check_large(
                getattr(tk, name), getattr(tk, name + "_ref"), args, k,
                n_valid, what)
            if not same:
                fail(f"{what}: tied rows not the first live rows in order")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            res[name]["cases"] += 1
    del bank, codes, scales, lab, q, q_ns
    res["plan"] = large_plan_check(device)
    res["served"] = served_large_case(gen, device, reps)
    res["hard"] = large_k_hard_cases(gen, device)
    for name in KERNELS:
        errs = [r["max_abs_err"] for key, r in res["hard"].items()
                if key.split()[-2] == name]
        errs += [res["served"][name]["max_abs_err"]] \
            if name in res["served"] else []
        res[name]["max_abs_err"] = max([res[name]["max_abs_err"], *errs])
        res[name]["cases"] += len(errs)
    return res


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
# each scheduled run spans ten ticks or more (C = 64: 12 full ticks); the
# direct C = 64 run, 64 executes taken in turns a round, is kept to 384
SCHED_CLIENTS = (1, 8, 64)
SCHED_ROUNDS = {"direct": {1: 200, 8: 25, 64: 6},
                "scheduled": {1: 200, 8: 25, 64: 12}}
SCHED_TICK_S, SCHED_MAX_BATCH = 0.002, 64
# requests of a scheduled run's last tick that are also answered alone
SCHED_ALONE = 8
# a future waits at most this long: a B = 64 hybrid tick takes ~0.42 s on
# the 2**20-row store, a tier-demoted one seconds
SCHED_WAIT_S = 120.0
# admission: well-behaved closed-loop tenants beside one flooding tenant
# that submits blocks of ADMISSION_BLOCK without waiting, under a
# per-tenant backlog cap
ADMISSION_CLIENTS, ADMISSION_ROUNDS = 8, 25
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
HTTP_ROUNDS = {1: 100, 8: 25, 64: 4}
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


def answers_with_dense(svc, reqs, plan):
    """One execute of `reqs` under `plan`, with the dense ranking its
    search returned (the sharded store's `sharded_search`, else the index's
    `search_batch`): (payloads, (scores, ids) or None, host ms to the end of
    a synchronize)."""
    import torch
    seen = {}
    owner, attr = ((svc.store, "sharded_search")
                   if svc.store.sharded is not None
                   else (svc.vindex, "search_batch"))
    search = getattr(owner, attr)

    def spy(*a, **kw):
        seen["dense"] = search(*a, **kw)
        return seen["dense"]

    setattr(owner, attr, spy)
    try:
        t = time.perf_counter()
        out = svc.retrieve_batch(reqs, plan=plan)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    finally:
        delattr(owner, attr)
    return out, seen.get("dense"), ms


def durable_answers(svc, reqs, reps: int):
    """One B = len(reqs) hybrid execute kept for the checks (contexts, token
    counts, the dense ranking its K1 search returned) and the host-clock
    p50 of `reps` more, each ending in a synchronize; (answers, the first
    execute's ms, the p50 ms)."""
    import numpy as np
    from repro_torch.core import RetrievalPlan
    plan = RetrievalPlan.hybrid()
    out, dense, first = answers_with_dense(svc, reqs, plan)
    got = {"texts": [o.text for o in out],
           "tokens": [o.token_count for o in out],
           "dense_ids": dense[1].cpu().numpy().copy()}
    times = [answers_with_dense(svc, reqs, plan)[2] for _ in range(reps)]
    return got, first, float(np.median(times))


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
    the card; then the kill -9 case.  The launcher twice and the train
    launcher (phase 15's part (e), its result kept in `out["train_launcher"]`)
    run as subprocesses beside the phase's host-bound work (neither shares
    a file with it), and are joined before the phase ends."""
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
    os.makedirs(os.path.join(work, "launcher"))
    beside = {"launcher": Background(launcher_twice, src,
                                     os.path.join(work, "launcher")),
              "train_launcher": Background(train_launcher, src)}
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
    finally:
        done = {}
        for key, job in beside.items():     # joined even on a failure, so
            try:                            # no launcher outlives the phase
                done[key] = job.result()
            except BaseException as e:
                done.setdefault("error", e)
        shutil.rmtree(work, ignore_errors=True)
    if "error" in done:
        raise done["error"]
    launcher = done["launcher"]
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
    out["train_launcher"] = done["train_launcher"]
    return out


# -- phase 7: sharding and replication on the serve store ---------------------

# the serve store laid out over SHARDS namespace-affine slabs (core/shards.py)
SHARDS = 8
SHARDED_B = (1, 8, 64)
# sharded_topk at Q = 64 over the slab bank: (k, masked); then k above the
# shard's rows on a bank of SMALL_SLAB rows a shard
SHARDED_TOPK = ((64, True), (256, False))
SMALL_SLAB = 128
# closed-loop scheduler clients beside a shard marked down from a thread
SHARD_CLIENTS, SHARD_ROUNDS = 8, 40
# conversations recorded into the down shard's namespaces, and the
# flush+retrieve cycles that must move no bank-sized buffer to the device
N_DOWN_CONVS, DOWN_CYCLES = 8, 5
# the journal of the lost-disk case: conversations before and after the
# rotation (one segment each), then group commits of GROUP_CONVS each
N_FOLLOW_CONVS = 64
LOST_SHARD = 3


def _status(url: str) -> int:
    """HTTP status of an unauthenticated GET."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=SCHED_WAIT_S) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _same_payloads(got, want, what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if (g.text, g.token_count) != (w.text, w.token_count):
            fail(f"{what}: request {i} answered differently:\n{g.text}\n"
                 f"{w.text}")


def check_sharded_dense(sh, reqs, dense, what: str) -> float:
    """Hold the ranking a sharded execute's K1 returned against K1's plain
    version over the same slab bank and labels, on queries rebuilt from the
    requests; both lists mapped to global rows.  Returns the largest score
    difference."""
    from repro_torch.kernels.topk_mips import topk_mips_masked_ref
    sb = sh.store.sharded
    qmat, q_ns = rebuild_queries(sh, reqs)
    s_r, i_r = topk_mips_masked_ref(qmat, sb._bank_dev, q_ns, sb._labels_dev,
                                    k=sh.pool, n_valid=sb.n_slots)
    s_k, i_k = _sentinel(*dense)
    return compare_topk(s_k, i_k, s_r, sb.slots_to_rows(i_r), what)


def sharded_topk_cases(sh, qmat, q_ns, reps: int) -> dict:
    """`sharded_topk` at Q = 64 over the slab bank (masked k = 64,
    unmasked k = 256) and with k above the shard's rows, each against one
    K1/K3 over the whole bank (ids equal, scores within rtol): its launches
    (one a slab), its CUDA-event ms beside the one-launch search's.  Only
    the first call of each case counts as the path's."""
    import torch
    from repro_torch.core.vector_index import sharded_topk
    from repro_torch.kernels import topk_mips as tk
    sb = sh.store.sharded
    bank, labels, C = sb._bank_dev, sb._labels_dev, sb.C
    small = torch.cat([bank[s * C: s * C + SMALL_SLAB]
                       for s in range(SHARDS)])
    small_labels = torch.cat([labels[s * C: s * C + SMALL_SLAB]
                              for s in range(SHARDS)])
    cases = [(f"{'masked' if m else 'unmasked'}_k{k}", bank, labels, k, m)
             for k, m in SHARDED_TOPK]
    cases += [(f"{'masked' if m else 'unmasked'}_k256_over_{SMALL_SLAB}_rows",
               small, small_labels, 256, m) for m in (True, False)]
    out = {}
    for name, b, lab, k, masked in cases:
        kw = dict(q_ns=q_ns, bank_ns=lab) if masked else {}
        wrapper = tk.topk_mips_masked if masked else tk.topk_mips
        before = wrapper.launches
        s_sh, i_sh = sharded_topk(qmat, b, k, SHARDS, **kw)
        torch.cuda.synchronize()
        launched = wrapper.launches - before
        if launched != SHARDS:
            fail(f"sharded_topk {name}: {launched} launches, expected "
                 f"{SHARDS} (one a slab)")
        with uncounted():
            if masked:
                s_one, i_one = tk.topk_mips_masked(qmat, b, q_ns, lab, k=k)
            else:
                s_one, i_one = tk.topk_mips(qmat, b, k=k)
            if not torch.equal(i_sh, i_one):
                fail(f"sharded_topk {name}: ids differ from one search "
                     "over the whole bank")
            live = i_one >= 0
            tol = RTOL * s_one.abs() + ATOL
            if not torch.all((s_sh - s_one).abs()[live] <= tol[live]):
                fail(f"sharded_topk {name}: scores beyond rtol={RTOL}")
            ms = time_ms(lambda: sharded_topk(qmat, b, k, SHARDS, **kw),
                         reps)
            if masked:
                one_ms = time_ms(lambda: tk.topk_mips_masked(
                    qmat, b, q_ns, lab, k=k), reps)
            else:
                one_ms = time_ms(lambda: tk.topk_mips(qmat, b, k=k), reps)
        out[name] = {"Q": int(qmat.shape[0]), "bank_rows": int(b.shape[0]),
                     "shard_rows": int(b.shape[0]) // SHARDS, "k": k,
                     "launches_per_call": launched,
                     "max_abs_err": float((s_sh - s_one).abs()[live].max())
                     if live.any() else 0.0,
                     "ms": ms, "one_search_ms": one_ms,
                     "live_slots": int(live.sum())}
    return out


def phase_sharded(device, svc, questions, reps: int) -> dict:
    """The serve store laid out over SHARDS slabs (see the module
    docstring): layout, parity with the unsharded store, sharded_topk,
    degraded serving, writes while a shard is down, and a lost shard's
    disk restored from the follower and recovered."""
    import shutil
    import tempfile
    import threading
    import numpy as np
    import torch
    import repro_torch.checkpoint.io as ckpt_io
    import repro_torch.checkpoint.packing as packing
    import repro_torch.core.shards as shards_mod
    import repro_torch.core.vector_index as vi_mod
    from repro_torch.checkpoint.replication import (
        DirectorySink, ShardedWal, restore_missing_from_follower)
    from repro_torch.core import (HashEmbedder, LifecyclePolicy,
                                  LifecycleRuntime, MemoryService,
                                  RetrievalPlan, RetrieveRequest)
    from repro_torch.core.extraction import Message
    from repro_torch.core.store import MemoryStore
    from repro_torch.data.locomo_synth import generate_conversation
    from repro_torch.serving.frontend import MemoryFrontend
    t_phase = time.perf_counter()
    vi = svc.vindex
    promoted = vi.promote_rows(np.flatnonzero(~vi.resident_mask()))
    svc.store.tiers = None
    reset_counts()          # the phase's path: every count from 0

    # 1. layout: the serve store's snapshot arrays into a sharded store (the
    # same global row ids), then its slab layout and upload
    t0 = time.perf_counter()
    arrays = svc.store.snapshot_arrays()
    t_arrays = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = MemoryStore.from_arrays(arrays, HashEmbedder(device=device),
                                    device=device, shards=SHARDS)
    t_from = time.perf_counter() - t0
    sh = MemoryService(store=store, budget=svc.budgeter.budget)
    sb = store.sharded
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sb.rebuild(store.vindex)
    t_rebuild = time.perf_counter() - t0
    t0 = time.perf_counter()
    sb.bank_device()
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    st = sb.stats()
    slab_bytes = sb.n_slots * (sb.dim * 4 + 4 + 4)
    layout = {"snapshot_arrays_seconds": t_arrays,
              "from_arrays_seconds": t_from, "rebuild_seconds": t_rebuild,
              "upload_seconds": t_upload, "rows": store.vindex.n,
              "per_shard_rows": st["per_shard_rows"],
              "per_shard_capacity": sb.C, "total_slots": sb.n_slots,
              "slab_bank_bytes": slab_bytes,
              "allocated_before_bytes": held,
              "peak_after_upload_bytes": torch.cuda.max_memory_allocated()}
    if sum(st["per_shard_rows"]) != store.vindex.n_alive:
        fail(f"sharded: {st['per_shard_rows']} slab rows for "
             f"{store.vindex.n_alive} live rows")

    # 2. parity with the unsharded serve store, request for request
    rng = np.random.default_rng(11)
    names = sorted(questions)

    def batch(B):
        reqs = [(PLANTED_NS, PLANTED_QUESTION)]
        for ns in rng.choice(names, B - 1, replace=False):
            reqs.append((str(ns), str(rng.choice(questions[ns]))))
        return reqs

    k1 = wrappers()["topk_mips_masked"]
    plans = {"hybrid": RetrievalPlan.hybrid(),
             "dense_only": RetrievalPlan.dense_only(),
             "graph": RetrievalPlan.graph_expanded()}
    runs = [(B, p) for B in SHARDED_B for p in ("hybrid", "dense_only")]
    runs.append((64, "graph"))
    p50, checked, peak, err = {}, {}, {}, 0.0
    for B, pname in runs:
        key = f"{pname}_B{B}"
        if pname == "graph":
            # the graph stage reads the vector index's device labels: the
            # index's own bank goes up beside the slabs (as the reference)
            peak["dense_and_hybrid_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        times = {"sharded": [], "unsharded": []}
        for rep in range(reps + 1):
            reqs = batch(B)
            before = k1.launches
            got, dense, ms = answers_with_dense(sh, reqs, plans[pname])
            if k1.launches - before != 1:
                fail(f"sharded {key}: K1 launched {k1.launches - before} "
                     "times in one execute")
            with uncounted():
                want, want_dense, ms_u = answers_with_dense(svc, reqs,
                                                         plans[pname])
            _same_payloads(got, want, f"sharded {key}")
            if not torch.equal(dense[1], want_dense[1]):
                fail(f"sharded {key}: the dense ranking differs from the "
                     "unsharded store's")
            if any(o.degraded for o in got):
                fail(f"sharded {key}: a healthy batch came back degraded")
            if rep:
                times["sharded"].append(ms)
                times["unsharded"].append(ms_u)
        err = max(err, check_sharded_dense(sh, reqs, dense,
                                           f"sharded {key} dense ids"))
        checked[key] = B
        p50[key] = {k: float(np.median(v)) for k, v in times.items()}
    peak["graph_bytes"] = torch.cuda.max_memory_allocated()
    peak["allocated_after_graph_bytes"] = torch.cuda.memory_allocated()
    peak["index_bank_on_device_after_graph"] = \
        store.vindex._bank_dev is not None
    profiled = {f"{p}_B64": profile_execute(sh, batch(64), plans[p],
                                            "topk_mips_masked")
                for p in ("hybrid", "dense_only")}

    # 3. sharded_topk over the slab bank (the last B = 64 batch's queries)
    qmat, q_ns = rebuild_queries(sh, reqs)
    topk = sharded_topk_cases(sh, qmat, q_ns, reps)

    # 4. degraded serving: the planted namespace's shard down
    down = store.shard_of_namespace(PLANTED_NS)
    reqs = batch(64)
    victims = [i for i, (ns, _) in enumerate(reqs)
               if store.shard_of_namespace(ns) == down]
    healthy, _, _ = answers_with_dense(sh, reqs, plans["hybrid"])
    fe = MemoryFrontend(sh, HTTP_KEYS).start()
    try:
        ready = {"before": _status(fe.address + "/v1/readyz")}
        t0 = time.perf_counter()
        sh.set_shard_down(down)
        torch.cuda.synchronize()
        t_down = time.perf_counter() - t0
        ready["down"] = _status(fe.address + "/v1/readyz")
        got, _, ms_degraded = answers_with_dense(sh, reqs, plans["hybrid"])
        t0 = time.perf_counter()
        sh.set_shard_up(down)
        torch.cuda.synchronize()
        t_up = time.perf_counter() - t0
        ready["up"] = _status(fe.address + "/v1/readyz")
    finally:
        fe.close()
    if ready != {"before": 200, "down": 503, "up": 200}:
        fail(f"sharded: /v1/readyz answered {ready}")
    for i, (g, h) in enumerate(zip(got, healthy)):
        if i in victims:
            if not g.degraded or g.triples:
                fail(f"sharded degraded: victim {reqs[i]} not flagged empty")
        elif g.degraded or _ctx_key(g) != _ctx_key(h):
            fail(f"sharded degraded: survivor {reqs[i]} differs from the "
                 "healthy batch")
    healed, _, _ = answers_with_dense(sh, reqs, plans["hybrid"])
    _same_payloads(healed, healthy, "sharded after mark_up")

    # once, the shard goes down from another thread while SHARD_CLIENTS
    # closed-loop clients run through the scheduler: every answer is ok and
    # either the healthy one or flagged empty
    pool = batch(64)                 # one request a namespace
    with uncounted():
        pool_healthy = dict(zip(
            (ns for ns, _ in pool),
            sh.execute([RetrieveRequest(ns, q) for ns, q in pool])))
    sched = sh.start_scheduler(tick_interval_s=SCHED_TICK_S,
                               max_batch=SCHED_MAX_BATCH)

    def make(c, rng_c):
        return RetrieveRequest(*pool[int(rng_c.integers(len(pool)))])

    def take_down():                 # a quarter of the way through
        while sched.stats()["retrieves"] < SHARD_CLIENTS * SHARD_ROUNDS // 4:
            time.sleep(0.001)
        sh.set_shard_down(down)

    downer = threading.Thread(target=take_down)
    before = k1.launches
    downer.start()
    run = closed_loop(sh, sched, make, SHARD_CLIENTS, SHARD_ROUNDS)
    downer.join()
    ticks = sched.stats()["retrieve_launches"]
    sched.close()
    sh.set_shard_up(down)
    if k1.launches - before != ticks:
        fail(f"sharded concurrent: K1 launched {k1.launches - before} "
             f"times for {ticks} ticks")
    flagged = 0
    for _, req, resp, _ in run["records"]:
        if not resp.ok:
            fail(f"sharded concurrent: {req} failed: {resp.error}")
        if resp.degraded:
            flagged += 1
            if store.shard_of_namespace(req.namespace) != down or \
                    resp.payload.triples:
                fail(f"sharded concurrent: {req} flagged wrongly")
        elif _ctx_key(resp.payload) != _ctx_key(
                pool_healthy[req.namespace]):
            fail(f"sharded concurrent: {req} answered neither healthy nor "
                 "flagged")
    if not flagged:
        fail("sharded concurrent: no response saw the shard down")
    recs = run["records"]
    concurrent = {"requests": len(recs), "flagged": flagged, "ticks": ticks,
                  "requests_per_s": len(recs) / run["wall"],
                  "latency_ms": _quantiles_ms([r[3] for r in recs])}

    # 5. writes while down: conversations into the down shard's namespaces
    # stay out of retrieval until mark_up, then surface; no cycle moves a
    # bank-sized buffer to the device
    mine = [ns for ns in names if ns.startswith("fill-")
            and store.shard_of_namespace(ns) == down][:N_DOWN_CONVS]
    bank_bytes = sb.n_slots * sb.dim * 4
    uploads, undo = [], []
    for mod in (shards_mod, vi_mod):
        real = mod.to_device

        def to_device(a, dev, _real=real, _mod=mod):
            if np.asarray(a).nbytes >= bank_bytes:
                uploads.append((_mod.__name__, np.shape(a)))
            return _real(a, dev)
        mod.to_device = to_device
        undo.append((mod, real))
    ptr, counters = sb._bank_dev.data_ptr(), dict(sb.counters)
    n_before = store.vindex.n
    sh.set_shard_down(down)
    cycle_ms = []
    try:
        for c in range(DOWN_CYCLES):
            if c == 0:
                for j, ns in enumerate(mine):
                    conv = generate_conversation(seed=50_000 + j)
                    for sid, msgs in conv.sessions:
                        sh.enqueue(ns, sid, msgs)
            else:
                sh.enqueue(mine[c], f"s-down-{c}", [Message(
                    "user", f"I adopted a gecko named Gex{c}.", 1.8e9)])
            t0 = time.perf_counter()
            sh.flush()
            out, _, _ = answers_with_dense(
                sh, [(ns, PLANTED_QUESTION) for ns in mine], plans["hybrid"])
            cycle_ms.append((time.perf_counter() - t0) * 1e3)
            if not all(o.degraded and not o.triples for o in out):
                fail("sharded writes while down: a down namespace answered")
    finally:
        for mod, real in undo:
            mod.to_device = real
    if uploads or sb._bank_dev.data_ptr() != ptr or \
            sb.counters["rebuilds"] != counters["rebuilds"] or \
            sb.counters["grows"] != counters["grows"]:
        fail(f"sharded writes while down: bank-sized uploads {uploads}, "
             f"counters {sb.counters} (were {counters})")
    sh.set_shard_up(down)
    new_rows = np.arange(n_before, store.vindex.n)
    row_ns = store.row_namespaces()
    reqs = [(ns, PLANTED_QUESTION) for ns in mine]
    out, dense, _ = answers_with_dense(sh, reqs, plans["dense_only"])
    ranked = dense[1].cpu().numpy()
    for i, ns in enumerate(mine):
        theirs = new_rows[row_ns[new_rows] == store.get(ns).ns_id]
        if out[i].degraded or not np.isin(theirs, ranked[i]).any():
            fail(f"sharded writes while down: {ns}'s new rows did not "
                 "surface after mark_up")
    err = max(err, check_sharded_dense(sh, reqs, dense,
                                       "sharded after writes dense ids"))
    writes = {"namespaces": len(mine), "new_rows": int(new_rows.size),
              "cycles": DOWN_CYCLES, "cycle_ms": cycle_ms,
              "bank_sized_uploads": 0, "slab_bank_kept": True}

    # 6. a lost shard's disk: journal with a follower, crash, lose
    # shard-NN/, restore from the follower, recover
    work = tempfile.mkdtemp(prefix="memori-sharded-")
    try:
        data, follower = os.path.join(work, "data"), \
            os.path.join(work, "follower")
        t0 = time.perf_counter()
        # one retained generation, so the rotation reaps the covered
        # coordinator and shard segments
        rt = LifecycleRuntime(store, data_dir=data, start=False,
                              policy=LifecyclePolicy(snapshot_retain=1))
        t_mount = time.perf_counter() - t0
        if not isinstance(rt.wal, ShardedWal) or rt.wal.n_shards != SHARDS:
            fail(f"sharded: the runtime mounted {type(rt.wal).__name__}")
        live = MemoryService(runtime=rt, budget=svc.budgeter.budget)
        shipper = live.attach_follower(DirectorySink(follower))
        wal_qs = {}

        def record(ns, seed):
            conv = generate_conversation(seed=seed)
            for sid, msgs in conv.sessions:
                live.enqueue(ns, sid, msgs)
            wal_qs[ns] = [qq.question for qq in conv.questions]

        t0 = time.perf_counter()
        for i in range(N_FOLLOW_CONVS):
            record(f"shard-wal-{i}", 60_000 + i)
            live.flush()
            if i == N_FOLLOW_CONVS // 2 - 1:
                t_r = time.perf_counter()
                rot = live.rotate()
                t_rotate = time.perf_counter() - t_r
        for g in range(N_GROUPS):
            with rt.group_commit():
                for j in range(GROUP_CONVS):
                    record(f"shard-group-{g}-{j}",
                           70_000 + GROUP_CONVS * g + j)
                    live.flush()
                t = live.store.get(f"shard-group-{g}-0").triples.get(0)
                live.store.link(f"shard-group-{g}-0", t.subject, t.object,
                                "entity", 0.5)
        t_journal = time.perf_counter() - t0 - t_rotate
        shard_dir = os.path.join(data, f"shard-{LOST_SHARD:02d}")
        lost = sorted(os.listdir(shard_dir))
        if not lost:
            fail(f"sharded: shard-{LOST_SHARD:02d}/ holds no segment to lose")
        old = [n for n in names if n != PLANTED_NS]
        new = list(wal_qs)
        n_new = min(len(new), DURABLE_B // 2)      # the rest from before
        picks = ([PLANTED_NS]
                 + list(rng.choice(old, DURABLE_B - 1 - n_new, replace=False))
                 + list(rng.choice(new, n_new, replace=False)))
        reqs = [(PLANTED_NS, PLANTED_QUESTION)] + [
            (str(n), str(rng.choice({**questions, **wal_qs}[n])))
            for n in picks[1:]]
        want, _, live_p50 = durable_answers(live, reqs, reps)
        live_sha = {"mirror": sha(store.vindex.bank),
                    "slabs": sha(sb._bank_dev.cpu().numpy())}
        shipped = dict(shipper.counters)

        # the crash: nothing closed, nothing flushed; then the disk goes
        del live, rt, sh, store, sb, shipper, fe, sched
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(shard_dir)
        t0 = time.perf_counter()
        restored = restore_missing_from_follower(DirectorySink(follower),
                                                 data)
        t_restore = time.perf_counter() - t0
        got_back = sorted(r.split("/", 1)[1] for r in restored
                          if r.startswith(f"shard-{LOST_SHARD:02d}/"))
        if not set(lost) <= set(got_back):
            fail(f"sharded: restored {got_back}, lost {lost}")

        torch.cuda.synchronize()
        held_r = torch.cuda.memory_allocated()
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
        t0 = time.perf_counter()
        try:
            rec = MemoryService.recover(data, HashEmbedder(device=device),
                                        device=device,
                                        budget=svc.budgeter.budget)
            torch.cuda.synchronize()
        finally:
            clock.undo()
        t_recover = time.perf_counter() - t0
        sec = clock.seconds
        if rec.store.shards != SHARDS:
            fail(f"sharded: recovery found {rec.store.shards} shards")
        recovery = {
            "seconds": t_recover,
            "read_and_copy_seconds": sec["load_raw"] - sec["decode_snapshot"],
            "decode_snapshot_arrays_seconds": sec["decode_snapshot"],
            "decode_meta_seconds": sec["decode_meta"],
            "from_arrays_seconds": sec["from_arrays"] - sec["decode_meta"],
            "replay_seconds": t_recover - sec["load_raw"]
            - sec["from_arrays"],
            "replay_apply_seconds": sec["apply_wal"],
            "replay_decode_seconds": sec["decode_wal"],
            "replayed_records": clock.calls["apply_wal"]}
        before = k1.launches
        t0 = time.perf_counter()
        got, first_ms, rec_p50 = durable_answers(rec, reqs, reps)
        recovery["first_execute_with_rebuild_ms"] = first_ms
        recovery["peak_device_bytes_over_held"] = \
            torch.cuda.max_memory_allocated() - held_r
        if k1.launches - before != reps + 1:
            fail(f"sharded: K1 launched {k1.launches - before} times in "
                 f"{reps + 1} recovered executes")
        for key in ("texts", "tokens"):
            if got[key] != want[key]:
                bad = [i for i, (a, b) in enumerate(zip(got[key], want[key]))
                       if a != b]
                fail(f"sharded: recovered {key} differ at requests {bad}")
        if not np.array_equal(got["dense_ids"], want["dense_ids"]):
            fail("sharded: the recovered dense ranking differs")
        rec_sha = {"mirror": sha(rec.vindex.bank),
                   "slabs": sha(rec.store.sharded._bank_dev.cpu().numpy())}
        if rec_sha != live_sha:
            fail(f"sharded: bank SHA-256 {rec_sha} vs live {live_sha}")
        rec.close(final_snapshot=False)
        del rec
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    launches = counts()
    out = {"phase": "sharded", "shards": SHARDS, "promoted_rows": promoted,
           "layout": layout, "parity": {"checked": checked,
                                         "dense_vs_plain_max_abs_err": err},
           "p50_ms": p50, "peak_bytes": peak, "profiled": profiled,
           "sharded_topk": topk,
           "degraded": {"shard": down, "victims": len(victims),
                        "survivors": len(healthy) - len(victims),
                        "mark_down_ms": t_down * 1e3,
                        "mark_up_ms": t_up * 1e3,
                        "degraded_B64_ms": ms_degraded, "readyz": ready,
                        "concurrent": concurrent},
           "writes_while_down": writes,
           "lost_disk": {"lost_shard": LOST_SHARD, "lost_segments": lost,
                         "mount_seconds": t_mount,
                         "journal_seconds": t_journal,
                         "rotation_seconds": t_rotate,
                         "rotation_reaped_shard_segments":
                             rot["truncated_shard_segments"],
                         "shipped": shipped,
                         "restore_seconds": t_restore,
                         "restored_files": len(restored),
                         "recovery": recovery,
                         "hybrid_B64_p50_ms": {"live": live_p50,
                                               "recovered": rec_p50},
                         "answers_equal": len(reqs),
                         "bank_sha256_equal": True},
           "launches": launches,
           "seconds": time.perf_counter() - t_phase, "gpu": gpu_line()}
    emit(out)
    # the dist phase builds its meshed store from the same arrays (the serve
    # store answers reads only in between, which leave its snapshot as it is)
    out["snapshot_arrays"] = arrays
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

def attention_bound_ms(n_q_heads_pairs: int, bytes_moved: int, D: int,
                       peak: float = FP32_FLOPS_PER_S):
    """Least time on the card for attention over `n_q_heads_pairs` allowed
    (query head, key) pairs: 4*D flops each (q.k and p.v) at the `peak`
    rate of the operands' type (FP32_FLOPS_PER_S for f32, BF16_FLOPS_PER_S
    for bf16, int8 codes dequantised to bf16 included), against the bytes
    that must move once; returns (ms, "bytes" | "operations")."""
    t_ops = 4.0 * D * n_q_heads_pairs / peak * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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
                strided=False, path=None, prefix=None,
                offsets=None) -> float:
    """One K6 case against its plain version; returns the largest error.
    With `path` ("wide" or "narrow", whether K/V go by cp.async), the case
    must take that path: `flash_grid` and `cp_async_ok` must say so, and the
    C launcher must report the rows per CTA of the shape `flash_grid`
    names.  `prefix` (an int, or a list of B per-row lengths passed as an
    int32 tensor) sets the prefix-LM mask; `offsets` (two lists of B
    per-row query and key position offsets, passed as int32 tensors) a
    window of positions."""
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
            f"D={D} causal={causal} window={window} strided={strided} "
            f"prefix={prefix} offsets={offsets}")
    if isinstance(prefix, list):
        prefix = torch.tensor(prefix, dtype=torch.int32, device=device)
    off = {}
    if offsets is not None:
        off = {name: torch.tensor(o, dtype=torch.int32, device=device)
               for name, o in zip(("q_offset", "kv_offset"), offsets)}
    fa.flash_attention.rows_per_cta = 0
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             prefix_len=prefix, **off)
    if path is not None:
        narrow, rows, _, _ = fa.flash_grid(B, K, G, S, D, sm_count(device),
                                           dtype)
        planned = ("narrow" if narrow else "wide",
                   fa.cp_async_ok(D, q.element_size(), k, v))
        if planned != path:
            fail(f"{what}: takes path {planned}, the case is for {path}")
        ran = fa.flash_attention.rows_per_cta
        if ran != rows:
            fail(f"{what}: launched CTAs of {ran} rows, flash_grid "
                 f"says {rows} ({path[0]})")
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  prefix_len=prefix, **off)
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
        n_split = da.plan_splits(T, B, K, sm_count(device), G, dtype)
        planned = (n_split == 1, fa.cp_async_ok(D, q.element_size(), k, v))
        used = {p.dims[7:9] for key, p in da._plans.items()     # the base
                if p.dims[:5] == (B, K, G, T, D)                 # instance:
                and key[-3:] == (None, None, None)               # no variant
                and key[1] == dtype}
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


def ring_slots(q_pos, T: int, holes: int, gen, device):
    """Slot positions of a ring-buffer cache of T slots (B, T) int32 for
    rows whose query sits at q_pos[b]: slot i holds the latest position
    p <= q_pos[b] with p = i (mod T), or -1 if there is none yet; then
    `holes` random slots of each row are emptied (-1) and the row's own
    slot kept, so masking by slot position is exercised beyond the ring's
    order."""
    import torch
    i = torch.arange(T, device=device)[None, :]
    qp = torch.tensor(q_pos, device=device)[:, None]
    pos = qp - ((qp - i) % T)
    pos = torch.where(pos >= 0, pos, torch.full_like(pos, -1))
    if holes:
        drop = torch.rand(pos.shape, generator=gen, device=device) < holes / T
        drop &= pos != qp
        pos = torch.where(drop, torch.full_like(pos, -1), pos)
    return pos.to(torch.int32)


def quant_cache(B, K, T, D, gen, device):
    """int8 codes (B, K, T, D) as permuted views of a (B, T, K, D) cache and
    f32 scales (B, K, T) as views of (B, T, K), as the model holds them."""
    import torch
    codes = torch.randint(-127, 128, (B, T, K, D), generator=gen,
                          device=device, dtype=torch.int32).to(torch.int8)
    scales = torch.rand((B, T, K), generator=gen, device=device) * 0.05 + 1e-3
    return codes.permute(0, 2, 1, 3), scales.permute(0, 2, 1)


def check_decode_variant(gen, device, dtype, B, K, G, T, D, q_pos, window,
                         slots: bool, quant: bool, holes: int = 0) -> float:
    """One case of K5's slot-position and/or int8 variant against the plain
    version, then again with garbage (finite) in every slot the mask
    rejects, or past kv_len: the output must not move by a bit.  Returns the
    largest error."""
    import torch
    from repro_torch.kernels import decode_attention as da
    q = _rand((B, 1, K * G, D), gen, device, dtype).view(B, K, G, D)
    kv_len = torch.tensor([p + 1 for p in q_pos], dtype=torch.int32,
                          device=device)
    kw = {"window": window}
    if quant:
        k, kw["k_scale"] = quant_cache(B, K, T, D, gen, device)
        v, kw["v_scale"] = quant_cache(B, K, T, D, gen, device)
    else:
        k = _rand((B, T, K, D), gen, device, dtype).permute(0, 2, 1, 3)
        v = _rand((B, T, K, D), gen, device, dtype).permute(0, 2, 1, 3)
    qp = kv_len[:, None].long() - 1
    if slots:
        kw["slot_pos"] = sp = ring_slots(q_pos, T, holes, gen, device)
        allowed = (sp >= 0) & (sp <= qp)
    else:
        sp = torch.arange(T, device=device)[None, :]
        allowed = sp <= qp
    if window > 0:
        allowed &= sp > qp - window
    got = da.decode_attention(q, k, v, kv_len, **kw)
    want = da.decode_attention_ref(q, k, v, kv_len, **kw)
    junk = (~allowed)[:, None, :, None]                     # (B, 1, T, 1)
    fill = 99 if quant else 999.0                  # stay finite: p * v = 0
    k2 = torch.where(junk, torch.full_like(k, fill), k)
    v2 = torch.where(junk, torch.full_like(v, -fill), v)
    got2 = da.decode_attention(q, k2, v2, kv_len, **kw)
    torch.cuda.synchronize()
    what = (f"decode_attention {str(dtype)[6:]} B={B} K={K} G={G} T={T} "
            f"D={D} q_pos={q_pos} window={window} slots={slots} "
            f"quant={quant} holes={holes}")
    # the output is a convex combination of value rows, rounded to q's
    # dtype: the tolerance scales with the largest |v| (dequantised codes
    # reach ~6)
    vmax = float((da.dequantize(v, kw["v_scale"], dtype) if quant
                  else v).float().abs().max())
    tol = ATTN_TOL[str(dtype)[6:]] * max(1.0, vmax)
    err = float((got.float() - want.float()).abs().max())
    if got.shape != want.shape or not err <= tol:
        fail(f"{what}: max error {err} > {tol}")
    if not torch.equal(got, got2):
        fail(f"{what}: rows the mask rejects changed the output")
    return err


def sdpa_gqa(q, k, v, **kw):
    """One `scaled_dot_product_attention` call on the kernels' grouped
    layout: (B, K, G, S, D) queries over (B, K, T, D) keys."""
    import torch
    B, K, G, S, D = q.shape
    return torch.nn.functional.scaled_dot_product_attention(
        q.reshape(B, K * G, S, D), k, v, enable_gqa=True, **kw)


# the K5 / K6 instances the served paths run: memori-agent (f32, D = 64)
# and the zoo, train and dist phases on the tensor cores (bf16: phi3.5-moe
# and internlm2 D = 128, phi3.5 also with the int8 cache, internlm2's
# long_500k ring; recurrentgemma D = 256 on the ring; paligemma D = 256;
# whisper D = 64; deepseek's decompressed prefill at D = 192 and its
# absorbed latent at 576), each K6 instance in its two CTA shapes, with
# and without position offsets
SERVED_INSTANCES = {
    "decode_attention": ("decode_attention_kernel<f32,f32,64,0>",
                         "decode_attention_tc_kernel<bf16,64,0>",
                         "decode_attention_tc_kernel<bf16,128,0>",
                         "decode_attention_tc_kernel<bf16,128,1>",
                         "decode_attention_tc_kernel<i8,128,0>",
                         "decode_attention_tc_kernel<bf16,256,0>",
                         "decode_attention_tc_kernel<bf16,256,1>"),
    "flash_attention": ("flash_fwd_kernel<f32,64,", "flash_fwd_tc_kernel<64,",
                        "flash_fwd_tc_kernel<128,", "flash_fwd_tc_kernel<192,",
                        "flash_fwd_tc_kernel<256,", "flash_fwd_tc_kernel<576,")}


def attention_instances(entries: dict, name: str) -> dict:
    """The ptxas entries of `name`'s instances that the served paths run
    (SERVED_INSTANCES: one entry each for K5; for K6 two CTA shapes, each
    with and without position offsets)."""
    found = {}
    for want in SERVED_INSTANCES[name]:
        got = {i: e for i, e in entries.items()
               if i == want or (want.endswith(",") and i.startswith(want))}
        n = 4 if want.endswith(",") else 1
        if len(got) != n:
            fail(f"{name}: ptxas entries {sorted(got)}, want {n} "
                 f"matching {want!r}")
        found.update(got)
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
           for name in (*ATTN_KERNELS, *ATTN_VARIANTS, ABSORBED,
                        "flash_attention[offset]")}

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
    # the bf16 tensor-core instances: each head-dim class (64, 128, 192,
    # 256, 576) in its wide and narrow (2-, 4- and 8-way split) CTA shape,
    # K/V by tensor-map copies (D a multiple of 8) and by plain loads (D =
    # 50, 100, 180, 250, 515), under causal, bidirectional, window and
    # S != T masks:
    # (B, K, G, S, T, D, causal, window, (CTA shape, K/V by cp.async))
    tc_flash_paths = [
        (1, 128, 1, 200, 200, 192, True, 0, ("wide", True)),      # MLA prefill
        (1, 128, 1, 200, 200, 180, True, 0, ("wide", False)),
        (1, 4, 4, 130, 130, 192, False, 16, ("narrow", True)),    # 4-way split
        (1, 4, 4, 130, 90, 180, True, 0, ("narrow", False)),
        (2, 12, 1, 64, 1500, 64, False, 0, ("narrow", True)),     # cross, 8-way
        (2, 12, 1, 64, 1500, 50, False, 0, ("narrow", False)),
        (4, 32, 1, 70, 70, 64, True, 16, ("wide", True)),
        (8, 16, 1, 70, 70, 50, True, 16, ("wide", False)),
        (2, 8, 2, 1000, 1000, 128, True, 0, ("wide", True)),      # train
        (2, 8, 2, 300, 300, 100, True, 64, ("wide", False)),
        (1, 8, 4, 200, 200, 128, True, 0, ("narrow", True)),      # phi3.5, 2-way
        (1, 8, 4, 77, 77, 100, False, 0, ("narrow", False)),
        (4, 4, 4, 200, 200, 256, True, 0, ("wide", True)),
        (4, 4, 4, 200, 180, 250, False, 20, ("wide", False)),
        (1, 1, 8, 320, 320, 256, True, 0, ("narrow", True)),      # paligemma
        (1, 1, 8, 99, 99, 250, True, 0, ("narrow", False)),
        (1, 1, 64, 70, 70, 576, True, 0, ("wide", True)),         # absorbed
        (1, 1, 64, 70, 70, 515, True, 0, ("wide", False)),
        (1, 1, 8, 40, 40, 576, False, 0, ("narrow", True)),
        (1, 1, 8, 40, 60, 515, True, 8, ("narrow", False)),
        (1, 2, 1, 30, 700, 64, False, 0, ("narrow", True)),       # few rows
        (1, 1, 3, 20, 20, 128, True, 0, ("narrow", True))]
    # K6's prefix mask on the tensor cores, scalar and per row:
    # (B, K, G, S, D, prefix)
    tc_prefix_cases = [(1, 1, 8, 320, 256, 256), (1, 1, 8, 320, 256, [256]),
                       (3, 2, 4, 100, 128, [5, 99, 0]),
                       (2, 4, 2, 90, 64, [64, 1]), (1, 8, 1, 80, 192, 40)]
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
    # (B, K, G, T, D) of the K5 variants: the reference tests' shapes, the
    # agent's, recurrentgemma's ring (G = 16, D = 256, 2048 slots) and
    # phi3.5-moe's int8 cache (G = 4, D = 128)
    variant_shapes = [(1, 1, 1, 64, 16), (3, 2, 4, 200, 32),
                      (LM_SLOTS, LM_K, LM_G, LM_MAX_LEN, LM_D),
                      (ZOO_SLOTS, 1, 16, 2048, 256),
                      (ZOO_SLOTS, 8, 4, ZOO_MAX_LEN, 128),
                      (34, 8, 2, 100, 64), (2, 2, 8, 300, 128),
                      (2, 4, 2, 700, 50)]
    # (B, K, G, S, D) of K6's prefix mask: paligemma's 256 image tokens +
    # text (G = 8, D = 256), and others off the tiles
    prefix_shapes = [(ZOO_BATCH, 1, 8, 256 + ZOO_PROMPT, 256),
                     (2, 2, 3, 150, 64), (1, 4, 2, 70, 50),
                     (4, 4, 8, 130, 128)]
    # (B, K, G, S, T, D) of cross-attention: whisper's decoder over 1500
    # frames (K = 12, D = 64)
    cross_shapes = [(ZOO_BATCH, 12, 1, ZOO_PROMPT, 1500, 64)]
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
            note("flash_attention", dtype, check_flash(      # the f32 CTA
                gen, device, dtype, B, K, G, S, T, D, causal, window,
                path=path if dtype == torch.float32 else None))   # shapes
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
        # the zoo's variants: slot positions (the ring: query positions
        # before, at and past a lap of the T slots, emptied slots), int8
        # codes (and both), the prefix mask (scalar and per row), and
        # cross-attention S != T at whisper's 1500 frames
        # K6's D = 576 instance (MLA's absorbed latent: G query heads over
        # one kv head): both CTA shapes, K/V by cp.async and by plain loads
        # (D = 515), D padded to 576 (520), a window
        for B, K, G, S, T, D, causal, window, path in ABSORBED_CASES:
            note(ABSORBED, dtype, check_flash(
                gen, device, dtype, B, K, G, S, T, D, causal, window,
                path=path))
        for B, K, G, T, D in variant_shapes:
            lap = [(37 * (b + 3) * 7) % (2 * T) for b in range(B)]
            for window in (0, 20, T):
                for slots, quant in ((True, False), (False, True),
                                     (True, True)):
                    if window == T and not slots:
                        continue
                    q_pos = lap if slots else [p % T for p in lap]
                    for holes in ((0, 5) if slots else (0,)):
                        name = ("decode_attention[int8]" if quant else
                                "decode_attention[slot_pos]")
                        note(name, dtype, check_decode_variant(
                            gen, device, dtype, B, K, G, T, D, q_pos,
                            window, slots, quant, holes))
        for B, K, G, S, D in prefix_shapes:
            for prefix in (16, S - 64, [(37 * b) % S for b in range(B)]):
                for window in (0, 16):
                    note("flash_attention[prefix]", dtype, check_flash(
                        gen, device, dtype, B, K, G, S, S, D, True, window,
                        prefix=prefix))
        for B, K, G, S, T, D in cross_shapes:
            note("flash_attention", dtype, check_flash(
                gen, device, dtype, B, K, G, S, T, D, False, 0))
            note("decode_attention", dtype, check_decode(
                gen, device, dtype, B, K, G, T, D, [T] * B, 0))
    bf = torch.bfloat16
    for B, K, G, S, T, D, causal, window, path in tc_flash_paths:
        name = ABSORBED if D > 256 else "flash_attention"
        note(name, bf, check_flash(gen, device, bf, B, K, G, S, T, D, causal,
                                   window, path=path))
    for B, K, G, S, T, D, causal, window, path in tc_flash_paths[:8]:
        note("flash_attention", bf, check_flash(
            gen, device, bf, B, K, G, S, T, D, causal, window, strided=True))
    for B, K, G, S, D, prefix in tc_prefix_cases:
        for window in (0, 16):
            note("flash_attention[prefix]", bf, check_flash(
                gen, device, bf, B, K, G, S, S, D, True, window,
                prefix=prefix))
    # per-row position offsets (a window of positions past 0), both dtypes:
    # each f32 CTA shape, the bf16 wide and key-split shapes and D = 576;
    # causal (queries ahead of their keys, a window), the prefix mask (an
    # int and per row, on the keys' absolute positions) and bidirectional
    # with keys below position 0
    for dtype in (torch.float32, bf):
        for B, K, G, S, T, D, causal, window, prefix, offsets in OFFSET_CASES:
            before = fa.offset_launches.launches
            note("flash_attention[offset]", dtype, check_flash(
                gen, device, dtype, B, K, G, S, T, D, causal, window,
                prefix=prefix, offsets=offsets))
            if fa.offset_launches.launches != before + 1:
                fail(f"flash_attention offsets={offsets}: the call did not "
                     "run an instance that takes offsets")

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
            "device_ms": kernel_device_ms(lambda: fa.flash_attention(q, k, v),
                                          reps, "flash_fwd_kernel")[0],
            "plain_ms": time_ms(lambda: fa.flash_attention_ref(q, k, v),
                                max(1, reps // 4)),
            "library_ms": time_ms(lambda: sdpa_gqa(q, k, v, is_causal=True),
                                  reps),
            "library_device_ms": profiled_ms(
                lambda: sdpa_gqa(q, k, v, is_causal=True), reps, ""),
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

    def sdpa_decode():
        return torch.nn.functional.scaled_dot_product_attention(
            q.reshape(LM_SLOTS, LM_K * LM_G, 1, LM_D), k, v, attn_mask=mask,
            enable_gqa=True)

    bytes_moved = 4 * (2 * q.numel() + 2 * rows * LM_K * LM_D + LM_SLOTS)
    bound, by = attention_bound_ms(rows * LM_K * LM_G, bytes_moved, LM_D)
    res["decode_attention"].update({
        "shape": {"B": LM_SLOTS, "K": LM_K, "G": LM_G, "T": LM_MAX_LEN,
                  "D": LM_D, "kv_len": DECODE_KV_LEN},
        "kernel_ms": time_ms(lambda: da.decode_attention(q, k, v, kv_len),
                             reps),
        "device_ms": kernel_device_ms(lambda: da.decode_attention(
            q, k, v, kv_len), reps, "decode_")[0],
        "graph_ms": graph_ms(lambda: da.decode_attention(q, k, v, kv_len),
                             GRAPH_CALLS, reps),
        "splits": da.plan_splits(LM_MAX_LEN, LM_SLOTS, LM_K,
                                 sm_count(device)),
        "plain_ms": time_ms(lambda: da.decode_attention_ref(q, k, v, kv_len),
                            reps),
        "library_ms": time_ms(sdpa_decode, reps),
        "library_device_ms": profiled_ms(sdpa_decode, reps, ""),
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
    `errs`, the tolerance being ATTN_TOL's value for the output's dtype
    scaled by the largest |v| (the output is a convex combination of value
    rows; int8 codes are dequantised first)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import attention as attn
    flash, decode = attn.flash_attention, attn.decode_attention

    def note(name, got, want, v):
        tol = ATTN_TOL[str(got.dtype)[6:]] * max(1.0, float(v.abs().max()))
        errs.append((name, float((got.float() - want.float()).abs().max()),
                     tol))

    def checked_flash(q, k, v, **kw):
        got = flash(q, k, v, **kw)
        note("flash_attention", got, fa.flash_attention_ref(q, k, v, **kw), v)
        return got

    def checked_decode(q, k, v, kv_len, **kw):
        got = decode(q, k, v, kv_len, **kw)
        values = (v if kw.get("v_scale") is None else
                  da.dequantize(v, kw["v_scale"], q.dtype))
        note("decode_attention", got,
             da.decode_attention_ref(q, k, v, kv_len, **kw), values)
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
            engine._inputs[:, 1].clone(),
            window_override=engine.window_override)
    replayed = engine.graph.replay()
    torch.cuda.synchronize()
    err = float((replayed - eager).abs().max())
    for cp, layer in zip(copies, engine.caches):   # the graph wrote in place
        for n, x in layer.items():
            err = max(err, float((cp[n].float() - x.float()).abs().max()))
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


# -- phase 17: the examples ------------------------------------------------------

@contextlib.contextmanager
def no_plain_versions(hits: list):
    """Every kernel's plain version refuses to run while the block does
    (its name goes to `hits`, then it raises): on the card a path that
    fell back to the plain versions would call one."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import topk_mips as tk
    saved = [(m, n, getattr(m, n)) for m, n in
             [(tk, name + "_ref") for name in KERNELS]
             + [(fa, "flash_attention_ref"), (da, "decode_attention_ref")]]

    def refuse(name):
        def plain(*args, **kwargs):
            hits.append(name)
            raise RuntimeError(f"{name} ran on the card's path")
        return plain

    for m, n, _ in saved:
        setattr(m, n, refuse(n))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _between(lines, start: str, stop: str) -> str:
    """The printed lines from the one starting with `start` up to the next
    one starting with `stop`, joined."""
    i = next(j for j, ln in enumerate(lines) if ln.startswith(start))
    j = next(j for j in range(i + 1, len(lines)) if lines[j].startswith(stop))
    return "\n".join(lines[i:j])


def large_k_path(device) -> dict:
    """The large-k path (k > MAX_K) through the port's public entry points,
    the launch counts reset just before and read just after: an f32
    `VectorIndex.search_batch` at k = LARGE_PATH_K (K1), an int8 index
    (rescore 8) at k = LARGE_PATH_K // 8, whose over-fetch pow2(8 k) is
    LARGE_PATH_K (K2), `sharded_topk` over 4 slabs of 16,384 rows at k =
    LARGE_PATH_K (K3 on each) and `ops.topk_mips_quant` at k =
    LARGE_PATH_K (K4), over 65,536 rows of width D, namespace 0 owning 70%.
    Each result is then held against a CPU index fed the same rows (the
    plain versions) or the plain version on the card."""
    import numpy as np
    import torch
    from repro_torch.core import vector_index as vi_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_mips as tk
    rng = np.random.default_rng(17)
    N, Q = 65536, 8
    rows = rng.standard_normal((N, D)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    labels = np.where(rng.random(N) < 0.7, 0,
                      rng.integers(1, 40, N)).astype(np.int32)
    queries = rng.standard_normal((Q, D)).astype(np.float32)
    q_ns = np.array([0, 0, 0, 3, 0, 7, 0, 0], np.int32)
    idx = {}
    for quantize in ("none", "int8"):
        for dev in (device, "cpu"):
            v = vi_mod.VectorIndex(dim=D, capacity=N, device=dev,
                                   quantize=quantize, rescore=8)
            v.add(rows, labels)
            idx[quantize, str(dev)] = v
    bank = torch.from_numpy(rows).to(device)
    codes, scales = tk.quantize_rows_ref(bank)
    q = torch.from_numpy(queries).to(device)
    k8 = LARGE_PATH_K // 8
    reset_counts()
    t0 = time.perf_counter()
    got = {"K1": idx["none", str(device)].search_batch(queries, q_ns,
                                                      LARGE_PATH_K),
           "K2": idx["int8", str(device)].search_batch(queries, q_ns, k8),
           "K3": vi_mod.sharded_topk(q, bank, LARGE_PATH_K, n_shards=4),
           "K4": ops.topk_mips_quant(q, codes, scales, k=LARGE_PATH_K)}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    want = {"topk_mips_masked": 1, "topk_mips_quant_masked": 1,
            "topk_mips": 4, "topk_mips_quant": 1, "topk_mips[large_k]": 7}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"large-k path: {name} launched {launches[name]} times, "
                 f"expected {n}")

    def host(s, i):       # the index's -inf empty slots as NEG_INF
        s = torch.where(i >= 0, s, torch.full_like(s, NEG_INF))
        return s.to(device), i.to(device)

    err = {}
    for key, quantize, k in (("K1", "none", LARGE_PATH_K),
                             ("K2", "int8", k8)):
        plain = idx[quantize, "cpu"].search_batch(queries, q_ns, k)
        err[key] = compare_topk(*host(*got[key]), *host(*plain),
                                f"large-k path {key} search_batch k={k}",
                                ordered=quantize == "none")
        if int((got[key][1][0] >= 0).sum()) != k:
            fail(f"large-k path {key}: namespace 0 did not fill k={k}")
    err["K3"] = compare_topk(*got["K3"], *tk.topk_mips_ref(
        q, bank, k=LARGE_PATH_K), "large-k path K3 sharded_topk")
    s_r, i_r = tk.topk_mips_quant_ref(q, codes, scales, k=LARGE_PATH_K)
    err["K4"] = compare_topk(*got["K4"], s_r, i_r, "large-k path K4 ops",
                             quant_slack(q, codes, scales, i_r))
    return {"seconds": seconds, "launches": launches, "max_abs_err": err,
            "k": LARGE_PATH_K, "int8_k": k8, "rows": N, "queries": Q}


def phase_examples(device) -> dict:
    """The port's two examples through `run("cuda")`, each with the launch
    counts reset just before and read just after and every plain version
    refused (`no_plain_versions`): the quickstart must recover identical
    answers with K1 launched; agent_serve must launch K1 for its retrieves
    and its engine's K6 (prefill) and K5 (decode), answer each tenant's
    pet question with its own fact only and count 2 scheduled retrieves.
    Then the large-k path (`large_k_path`)."""
    import tempfile
    import torch
    from repro_torch.examples import agent_serve, quickstart
    out = {"phase": "examples"}
    wants = {"quickstart": ("topk_mips_masked",),
             "agent_serve": ("topk_mips_masked", "flash_attention",
                             "decode_attention")}
    with tempfile.TemporaryDirectory() as tmp:
        for name, example in (("quickstart", quickstart),
                              ("agent_serve", agent_serve)):
            hits = []
            reset_counts()
            t0 = time.perf_counter()
            with no_plain_versions(hits):
                lines = example.run("cuda", data_dir=os.path.join(tmp, name))
            torch.cuda.synchronize()
            launches = counts()
            if hits:
                fail(f"examples {name}: plain versions ran: {sorted(set(hits))}")
            for kernel in wants[name]:
                if launches[kernel] < 1:
                    fail(f"examples {name}: {kernel} was not launched")
            out[name] = {"seconds": time.perf_counter() - t0,
                         "launches": launches, "lines": len(lines)}
            if name == "quickstart":
                if lines[-1] != "recovered answers identical: True":
                    fail(f"examples quickstart: {lines[-1]!r}")
            else:
                priya = _between(lines, "[priya/c0]", "[marco/c0]")
                marco = _between(lines, "[marco/c0]", "scheduler:")
                if "biscuit" not in priya or "olive" in priya or \
                        "olive" not in marco or "biscuit" in marco:
                    fail(f"examples agent_serve: tenants' answers\n{priya}\n"
                         f"{marco}")
                sched = next(ln for ln in lines if ln.startswith("scheduler:"))
                if not sched.startswith("scheduler: 2 concurrent"):
                    fail(f"examples agent_serve: {sched}")
                out[name]["scheduler"] = sched
    out["large_k"] = large_k_path(device)
    out["gpu"] = gpu_line()
    emit(out)
    return out


# -- phase 14: the rest of the model zoo ----------------------------------------

# each arch at full width in its config's dtype (bf16), random weights from
# a seed: the layers on the card (None: all), how it is driven (the
# continuous-batching Engine, or Model.prefill / decode_step for the
# encoder-decoder and the image prefix), its Engine's max_len and the
# prompt lengths in tokens; `int8`: served and checked again with the int8
# KV cache; `f32_witness`: also run at f32 (zoo_f32_witness)
ZOO = {
    "phi3.5-moe-42b-a6.6b": {"layers": 4, "engine": True, "int8": True},
    "deepseek-v3-671b": {"layers": 4, "engine": True},
    "recurrentgemma-9b": {"layers": None, "engine": True, "max_len": 4096,
                          "prompt": (2100, 2400)},
    "mamba2-2.7b": {"layers": None, "engine": True, "f32_witness": True},
    "whisper-small": {"layers": None, "engine": False},
    "paligemma-3b": {"layers": None, "engine": False},
}
ZOO_SLOTS, ZOO_REQUESTS, ZOO_NEW_TOKENS, ZOO_MAX_LEN = 4, 8, 16, 512
# whisper / paligemma: a batch of ZOO_BATCH prompts of ZOO_PROMPT tokens,
# ZOO_STEPS greedy decode steps
ZOO_BATCH, ZOO_PROMPT, ZOO_STEPS = 2, 64, 16
# teacher-forced runs: ZOO_TF sequences, ZOO_TF_STEPS decode steps
ZOO_TF, ZOO_TF_STEPS = 4, 8
# bf16 end to end: logits of two correct paths (kernel / plain, prefill +
# decode / full forward) differ by bf16 roundings (2**-8 relative each)
# carried through the layers.  Kernel against plain path: held to 2**-5 of
# the largest |logit|, and a greedy divergence to a plain top-two margin
# under the same bound, and prefill + decode against the full forward.
# For mamba2-2.7b the latter rounds the SSD's chunked prefill and its
# recurrent decode in other orders at each of 64 layers (~6% of the logit
# scale on an H100; the reference's own bf16 model parts as far, see
# tests/test_torch_zoo.py::test_ssd_depth_gap_matches_the_reference):
# held to 2**-5 per 16 layers, and the same weights at f32 to 2**-10
ZOO_REL_TOL = 2.0 ** -5
ZOO_DEPTH_TOL_LAYERS = 16
ZOO_F32_TOL = 2.0 ** -10
# the int8 KV cache's prefill + decode against the full forward (no
# cache): the reference's gate for int8 against f32 caches
# (tests/test_perf_variants.py), 5% of the logit scale
ZOO_INT8_TOL = 0.05


def zoo_config(arch):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    layers = ZOO[arch]["layers"]
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def unit_scores(params, cfg):
    """The lm phase's `conditioned` for every attention of the zoo: query
    and key projections rescaled so that each q and k element has unit
    spread over a unit-variance input (wq by sqrt(H / d), wk by
    sqrt(K / d); MLA's up-projections by sqrt(H / rank)) and q.k * D**-0.5
    has unit spread.  At the reference's init (fan_in = shape[-2], the
    head count) scores spread by ~100-250 at these widths: attention is a
    hard max and rounding alone parts two correct paths."""
    d, H, K = cfg.d_model, cfg.num_heads, cfg.num_kv_heads

    def attn(p):
        if "wuq" in p:                       # MLA
            m = cfg.mla
            return {**p, "wuq": p["wuq"] * (H / m.q_lora_rank) ** 0.5,
                    "wuk": p["wuk"] * (H / m.kv_lora_rank) ** 0.5}
        return {**p, "wq": p["wq"] * (H / d) ** 0.5,
                "wk": p["wk"] * (K / d) ** 0.5}

    def layers(ls):
        return [{**b, **{n: attn(b[n]) for n in ("attn", "cross_attn")
                         if n in b}} for b in ls]

    out = {**params, "layers": layers(params["layers"])}
    if "encoder" in params:
        out["encoder"] = {**params["encoder"],
                          "layers": layers(params["encoder"]["layers"])}
    return out


def long_prompts(tokenizer, n: int, lo: int, hi: int):
    """n prompts of lo to hi tokens: consecutive turns of one synthetic
    LoCoMo conversation each (a conversation holds ~22k tokens)."""
    import numpy as np
    from repro_torch.data.locomo_synth import generate_conversation
    rng = np.random.default_rng(8)
    prompts = []
    for i in range(n):
        conv = generate_conversation(seed=31_000 + i)
        msgs = [m for _, ms in conv.sessions for m in ms]
        target = int(rng.integers(lo, hi))
        lines, count = [], 0
        for m in msgs:
            line = f"{m.speaker}: {m.text}"
            c = len(tokenizer.encode(line))
            if count + c > target:
                break
            lines.append(line)
            count += c
        prompts.append("\n".join(lines))
    return prompts


def zoo_extra(cfg, n: int, gen, device):
    """Seeded stub inputs of n rows: image patch embeddings (paligemma) or
    audio frames (whisper), else {}."""
    import torch
    from repro_torch.models.model_api import cfg_vision_dim
    if cfg.num_image_tokens:
        return {"images": torch.randn(
            (n, cfg.num_image_tokens, cfg_vision_dim(cfg)), generator=gen,
            device=device)}
    if cfg.is_encoder_decoder:
        return {"audio": torch.randn((n, cfg.encoder_seq_len, cfg.d_model),
                                     generator=gen, device=device)}
    return {}


def zoo_teacher_forced(model, params, seqs, extra, prefix, steps, max_len,
                       device):
    """The engine's dataflow for any arch, teacher-forced: sequence i
    prefilled alone on its first prefix[i] tokens (with row i of `extra`)
    into slot i of batched caches, then `steps` batched decode steps at
    per-slot positions (after an image prefix of P positions).  Returns
    (prefill logits (n, V), decode logits (steps, n, V))."""
    import torch
    n, P = len(seqs), model.cfg.num_image_tokens or 0
    caches = model.init_caches(n, max_len, device=device)
    first = []
    for i, seq in enumerate(seqs):
        batch = {"tokens": seq[None, :prefix[i]],
                 **{k: v[i:i + 1] for k, v in extra.items()}}
        lg, pre = model.prefill(params, batch)
        first.append(lg[0, -1])
        pre = model.prepare_decode_caches(pre, P + prefix[i], max_len)
        for full, single in zip(caches, pre):
            for name, x in single.items():
                full[name][i].copy_(x[0])
    pos = torch.tensor(prefix, device=device) + P
    out = []
    for step in range(steps):
        toks = torch.stack([seq[p + step] for seq, p in zip(seqs, prefix)])
        lg, caches = model.decode_step(params, toks[:, None], caches,
                                       pos + step)
        out.append(lg[:, 0])
    return torch.stack(first), torch.stack(out)


def zoo_greedy(model, params, batch, steps, max_len, margins=None):
    """Model.prefill on a batch, then `steps` greedy decode steps (eager);
    with `margins`, the top-two logit margin of every sampled token is
    recorded under (row, token index).  Returns (tokens (B, steps + 1),
    prefill seconds, decode seconds per step)."""
    import torch
    P = model.cfg.num_image_tokens or 0
    B, S = batch["tokens"].shape

    def pick(lg, j):
        lg = lg[:, -1].float()
        if margins is not None:
            top2 = torch.topk(lg, 2, dim=-1).values
            for b, g in enumerate((top2[:, 0] - top2[:, 1]).tolist()):
                margins[(b, j)] = g
        return lg.argmax(-1)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, pre = model.prefill(params, batch)
    toks = [pick(lg, 0)]
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    caches = model.prepare_decode_caches(pre, P + S, max_len)
    t0 = time.perf_counter()
    for j in range(steps):
        lg, caches = model.decode_step(params, toks[-1][:, None], caches,
                                       P + S + j)
        toks.append(pick(lg, j + 1))
    torch.cuda.synchronize()
    return (torch.stack(toks, 1), t_prefill,
            (time.perf_counter() - t0) / steps)


def module_shares(engine) -> dict:
    """The share of the MoE FFN, the SSM and RG-LRU mixers, MLA's absorbed
    decode and K5 in one eager `Engine.decode` (its device span between
    CUDA events; each module's span between events recorded around its
    calls on the same stream), after the served run (slots released)."""
    import torch
    from repro_torch.models.layers import attention, mla, moe, rglru, ssm
    targets = {"moe": (moe, "apply"), "ssm": (ssm, "apply"),
               "rglru": (rglru, "apply"), "mla_decode": (mla, "apply"),
               "decode_attention": (attention, "decode_attention")}
    saved = {k: getattr(m, a) for k, (m, a) in targets.items()}
    spans = {k: [] for k in targets}

    def wrap(key, fn):
        def run(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **kw)
            e.record()
            spans[key].append((s, e))
            return out
        return run

    engine.decode()                       # warm (the caches hold garbage)
    for k, (m, a) in targets.items():
        setattr(m, a, wrap(k, saved[k]))
    try:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        engine.decode()
        end.record()
        torch.cuda.synchronize()
    finally:
        for k, (m, a) in targets.items():
            setattr(m, a, saved[k])
    total = start.elapsed_time(end)
    return {"eager_step_ms": total,
            "share": {k: sum(s.elapsed_time(e) for s, e in v) / total
                      for k, v in spans.items() if v}}


def zoo_rel_check(what, got, want, scale, tol=ZOO_REL_TOL) -> float:
    """max |got - want| against `tol` of the logit scale; returns the error
    relative to that scale."""
    err = float((got.float() - want.float()).abs().max()) / max(1.0, scale)
    if not err <= tol:
        fail(f"zoo {what}: relative max difference {err} > {tol}")
    return err


def check_greedy(what, got, plain, margins, scale) -> dict:
    """Greedy tokens of the kernel path against the plain path's: a row may
    leave them only at a step where the plain path's top-two margin is
    within ZOO_REL_TOL of the logit scale (a near-tie)."""
    tie = ZOO_REL_TOL * max(1.0, scale)
    diverged = {}
    for i, (a, b) in enumerate(zip(got, plain)):
        diff = [j for j, (x, y) in enumerate(zip(a, b)) if x != y]
        if not diff:
            continue
        j = diff[0]
        diverged[i] = {"index": j, "plain_margin": margins[(i, j)]}
        if margins[(i, j)] >= tie:
            fail(f"zoo {what}: row {i} token {j}: kernel path {a[j]}, plain "
                 f"path {b[j]}, plain top-two margin {margins[(i, j)]} >= "
                 f"{tie}")
    return {"rows_equal": len(got) - len(diverged),
            "near_tie_threshold": tie,
            "plain_near_tie_steps": sum(1 for m in margins.values()
                                        if m < tie),
            "sampled_steps": len(margins), "diverged_at_near_tie": diverged}


def zoo_engine_run(arch, cfg, model, params, tok, device, prompts,
                   quant=False) -> dict:
    """The served path: an Engine (ZOO_SLOTS slots) over ZOO_REQUESTS
    greedy requests, counters reset just before and read just after; the
    decode step must be a replayed CUDA graph, K5 once an attention layer a
    decode step (each variant too), K6 once an attention layer a prefill.
    Then a replayed step against an eager one, a profiled step and the
    modules' shares."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models.model_api import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.requests import Request
    if quant:
        cfg = dataclasses.replace(cfg, kv_cache_quant="int8")
        model = Model(cfg)
    max_len = ZOO[arch].get("max_len", ZOO_MAX_LEN)
    engine = Engine(model, params, max_len=max_len, slots=ZOO_SLOTS,
                    tokenizer=tok)

    def requests():
        return [Request(tok.encode(p), ZOO_NEW_TOKENS) for p in prompts]

    greedy_run(engine, requests()[:2])      # warm up: the graph's capture
    torch.cuda.reset_peak_memory_stats()
    steps0, admitted0 = (engine.stats["decode_steps"],
                         engine.stats["admitted"])
    reset_counts()
    got, wall, prefill_s, step_s = greedy_run(engine, requests())
    launches = counts()
    max_memory = torch.cuda.max_memory_allocated()
    steps = engine.stats["decode_steps"] - steps0
    admitted = engine.stats["admitted"] - admitted0
    if engine.graph is None:
        fail(f"zoo {arch}: the decode step was not captured as a CUDA graph")
    n_attn = sum(1 for k in cfg.layer_kinds() if k[0] == "attn")
    ring = any("pos" in c for c in engine.caches)
    want = {"decode_attention": steps * n_attn * (not cfg.use_mla),
            "flash_attention": admitted * n_attn,
            "decode_attention[slot_pos]": steps * n_attn * ring,
            "decode_attention[int8]": steps * n_attn * quant}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"zoo {arch}: {name} counted {launches[name]} launches on "
                 f"the served path, want {n} ({steps} decode steps, "
                 f"{admitted} prefills, {n_attn} attention layers)")
    replay_err = replay_vs_eager(engine, tok, prompts)
    if not replay_err <= LOGIT_TOL:
        fail(f"zoo {arch}: replayed decode graph vs eager decode_step "
             f"differ by {replay_err} > {LOGIT_TOL}")
    profiled = profile_decode(engine, tok, prompts)
    shares = module_shares(engine)
    tokens_out = sum(len(r.tokens) for r in got)
    out = {"slots": ZOO_SLOTS, "max_len": max_len,
           "requests": len(prompts), "new_tokens": ZOO_NEW_TOKENS,
           "kv_cache_quant": cfg.kv_cache_quant or None,
           "ring_cache": ring, "launches": launches,
           "decode_steps": steps, "prefills": admitted,
           "prefill_ms_per_request": float(np.mean(prefill_s)) * 1e3,
           "prefill_ms_median": float(np.median(prefill_s)) * 1e3,
           "decode_step_ms_at_full_slots": float(np.median(step_s)) * 1e3,
           "tokens_per_s": tokens_out / wall, "wall_s": wall,
           "max_memory_allocated_bytes": max_memory,
           "decode_graph": {"replayed_vs_eager_max_abs": replay_err,
                            "captured_launches": {
                                f.__name__: d for f, d in
                                engine.graph.deltas.items()}},
           "profiled_step": profiled, "modules": shares}
    return out, engine, requests


def zoo_hold(what, cfg, params, seqs, extra, max_len, device, full_tol,
             greedy):
    """Teacher-forced runs of `cfg` (ragged prefixes): every K5/K6 call
    against its plain version, the kernel path's logits against the plain
    path's (ZOO_REL_TOL) and prefill + decode against the full forward
    (`full_tol`); then `greedy(model)`'s tokens against the plain path's.
    MoE runs drop-free in the teacher-forced runs (capacity factor E / k,
    as the reference's consistency test): a prefill and a full forward of
    other lengths would drop other tokens at capacity.  Returns (teacher-
    forced record, greedy record, (prefill + decode logits, full forward
    logits) per sequence)."""
    import dataclasses
    import torch
    from repro_torch.models.model_api import Model
    model = tf_model = Model(cfg)
    if cfg.use_moe:
        m = cfg.moe
        tf_model = Model(dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.experts_per_token)))
    prefix = [len(sq) - ZOO_TF_STEPS for sq in seqs]
    errs = []
    with torch.no_grad():
        with checked_attention(errs):
            k_first, k_dec = zoo_teacher_forced(
                tf_model, params, seqs, extra, prefix, ZOO_TF_STEPS, max_len,
                device)
        per_call = check_kernel_calls(errs, f"zoo {what}")
        with plain_attention():
            p_first, p_dec = zoo_teacher_forced(
                tf_model, params, seqs, extra, prefix, ZOO_TF_STEPS, max_len,
                device)
        full = zoo_full_forward(tf_model, params, seqs, extra, prefix)
    if not all(torch.isfinite(x).all() for x in (k_first, k_dec)):
        fail(f"zoo {what}: non-finite logits")
    scale = float(p_dec.float().abs().max())
    rel_plain = max(zoo_rel_check(f"{what} prefill vs plain", k_first,
                                  p_first, scale),
                    zoo_rel_check(f"{what} decode vs plain", k_dec, p_dec,
                                  scale))
    have = [torch.cat([k_first[i][None], k_dec[:, i]])
            for i in range(len(seqs))]
    rel_full = max(zoo_rel_check(f"{what} prefill + decode vs full forward",
                                 h, f, scale, full_tol)
                   for h, f in zip(have, full))
    record = {
        "sequences": len(seqs), "prefix_tokens": prefix,
        "decode_steps": ZOO_TF_STEPS, "kernel_calls_vs_plain": per_call,
        "logit_scale": scale,
        "logits_vs_plain_rel": rel_plain,
        "decode_vs_full_forward_rel": rel_full,
        "tolerance": {"vs_plain": ZOO_REL_TOL, "vs_full_forward": full_tol}}
    got, plain, margins = greedy(model)
    return (record, check_greedy(what, got, plain, margins, scale),
            (have, full))


def zoo_full_forward(model, params, seqs, extra, prefix):
    """The full forward's logits of each sequence from the position of its
    last prefill token (after an image prefix) to its end."""
    P = model.cfg.num_image_tokens or 0
    return [model(params, {"tokens": sq[None],
                           **{k: v[i:i + 1] for k, v in extra.items()}}
                  )[0, P + prefix[i] - 1:].clone()
            for i, sq in enumerate(seqs)]


def zoo_f32_witness(arch, cfg, params, seqs, extra, max_len, device,
                    bf16) -> dict:
    """The bf16 weights widened to f32 and run at f32 at the same depth:
    prefill + decode against the full forward within ZOO_F32_TOL of the
    logit scale, so that the bf16 gap is rounding and not a fault.  Also
    how far each bf16 path (`bf16` = (prefill + decode, full forward) per
    sequence) lies from the f32 full forward: both about as far when the
    gap between them is rounding."""
    import dataclasses
    import torch
    from repro_torch.common.module import tree_map
    from repro_torch.models.model_api import Model
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model = Model(cfg32)
    p32 = tree_map(lambda x: x.float() if x.is_floating_point() else x,
                   params)
    prefix = [len(sq) - ZOO_TF_STEPS for sq in seqs]
    with torch.no_grad():
        first, dec = zoo_teacher_forced(model, p32, seqs, extra, prefix,
                                        ZOO_TF_STEPS, max_len, device)
        full = zoo_full_forward(model, p32, seqs, extra, prefix)
    del p32
    scale = float(dec.abs().max())
    rel = max(zoo_rel_check(f"{arch} f32 prefill + decode vs full forward",
                            torch.cat([first[i][None], dec[:, i]]), f,
                            scale, ZOO_F32_TOL)
              for i, f in enumerate(full))

    def gap(xs):
        return max(float((x.float() - f).abs().max())
                   for x, f in zip(xs, full)) / max(1.0, scale)
    return {"logit_scale": scale, "decode_vs_full_forward_rel": rel,
            "tolerance": ZOO_F32_TOL,
            "bf16_prefill_decode_vs_f32_full_rel": gap(bf16[0]),
            "bf16_full_vs_f32_full_rel": gap(bf16[1])}


def zoo_arch(arch, device) -> dict:
    """One arch of the zoo phase: its main path, every K5/K6 call of a
    teacher-forced run against the plain version, teacher-forced logits
    against the plain path, prefill + decode against the full forward, and
    greedy tokens against the plain path."""
    import dataclasses
    import torch
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models.model_api import Model
    from repro_torch.serving.engine import Engine
    t0 = time.perf_counter()
    spec = ZOO[arch]
    cfg = zoo_config(arch)
    model = Model(cfg)
    gen = torch.Generator(device=device).manual_seed(21)
    torch.cuda.reset_peak_memory_stats()
    params = unit_scores(model.init_params(gen), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = torch.cuda.memory_allocated()
    tok = HashTokenizer(cfg.vocab_size)
    max_len = spec.get("max_len", ZOO_MAX_LEN)
    out = {"arch": arch, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": cfg.compute_dtype,
           "params": cfg.param_count(), "param_bytes_on_card": param_bytes,
           "init_seconds": init_s}

    if spec["engine"]:
        lo, hi = spec.get("prompt", (100, 250))
        prompts = (long_prompts(tok, ZOO_REQUESTS, lo, hi) if "prompt" in spec
                   else lm_prompts(tok, ZOO_REQUESTS))
        out["prompt_tokens"] = [len(tok.encode(p)) for p in prompts]
        served, engine, requests = zoo_engine_run(arch, cfg, model, params,
                                                  tok, device, prompts)
        out["served"] = served
        del engine
        if spec.get("int8"):                 # the same engine, int8 cache
            served8, engine8, _ = zoo_engine_run(arch, cfg, model, params,
                                                 tok, device, prompts,
                                                 quant=True)
            out["served_int8"] = served8
            del engine8
        seqs = [torch.tensor(tok.encode(p), device=device)
                for p in prompts[:ZOO_TF]]
        extra = {}
    else:
        # the main path: Model.prefill of a batch (with its stub images /
        # audio) and greedy decode steps, counters reset around it
        ids = torch.randint(4, cfg.vocab_size, (ZOO_BATCH, ZOO_PROMPT),
                            generator=gen, device=device)
        extra = zoo_extra(cfg, ZOO_BATCH, gen, device)
        batch = {"tokens": ids, **extra}
        zoo_greedy(model, params, batch, 2, max_len)         # warm up
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        toks, t_pre, t_step = zoo_greedy(model, params, batch, ZOO_STEPS,
                                         max_len)
        torch.cuda.synchronize()
        launches = counts()
        n_attn = cfg.num_layers
        n_enc = cfg.encoder_layers if cfg.is_encoder_decoder else 0
        n_cross = cfg.num_layers if cfg.is_encoder_decoder else 0
        want = {"flash_attention": n_attn + n_enc + n_cross,
                "decode_attention": ZOO_STEPS * (n_attn + n_cross),
                "flash_attention[prefix]": n_attn * bool(cfg.num_image_tokens)}
        for name, n in want.items():
            if launches[name] != n:
                fail(f"zoo {arch}: {name} counted {launches[name]} launches "
                     f"on the main path, want {n}")
        out["served"] = {
            "batch": ZOO_BATCH, "prompt_tokens": ZOO_PROMPT,
            "prefix_positions": cfg.num_image_tokens or 0,
            "encoder_frames": cfg.encoder_seq_len if n_enc else 0,
            "decode_steps": ZOO_STEPS, "launches": launches,
            "prefill_ms_per_request": t_pre / ZOO_BATCH * 1e3,
            "prefill_ms_batch": t_pre * 1e3, "decode_step_ms": t_step * 1e3,
            "tokens_per_s": ZOO_BATCH * (ZOO_STEPS + 1) / (t_pre + t_step *
                                                          ZOO_STEPS),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        seqs = [torch.cat([ids[i % ZOO_BATCH], torch.randint(
            4, cfg.vocab_size, (ZOO_TF_STEPS + 8 * i,), generator=gen,
            device=device)]) for i in range(ZOO_TF)]
        extra = {k: v[torch.arange(ZOO_TF, device=device) % ZOO_BATCH]
                 for k, v in extra.items()}

    def greedy(m):
        """Greedy tokens of model `m` on the kernel path and on the plain
        path, and the plain path's top-two margins."""
        margins = {}
        if spec["engine"]:
            def served(rec=None):
                return [r.tokens for r in greedy_run(
                    Engine(m, params, max_len=max_len, slots=ZOO_SLOTS,
                           tokenizer=tok), requests(), rec)[0]]
            got = served()
            with plain_attention():
                plain = served(margins)
        else:
            got = zoo_greedy(m, params, batch, ZOO_STEPS, max_len)[0]
            with plain_attention():
                plain = zoo_greedy(m, params, batch, ZOO_STEPS, max_len,
                                   margins)[0]
            got, plain = got.tolist(), plain.tolist()
        return got, plain, margins

    # prefill + decode against the full forward: 2**-5 of the logit scale,
    # per 16 layers where an f32 run of the same weights shows the gap is
    # bf16 rounding (ZOO_F32_TOL)
    depth = cfg.num_layers + (cfg.encoder_layers
                              if cfg.is_encoder_decoder else 0)
    full_tol = (ZOO_REL_TOL * max(1.0, depth / ZOO_DEPTH_TOL_LAYERS)
                if spec.get("f32_witness") else ZOO_REL_TOL)
    out["teacher_forced"], out["greedy_vs_plain"], tf = zoo_hold(
        arch, cfg, params, seqs, extra, max_len, device, full_tol, greedy)
    if spec.get("int8"):                    # the int8 cache's served path
        cfg8 = dataclasses.replace(cfg, kv_cache_quant="int8")
        out["teacher_forced_int8"], out["greedy_vs_plain_int8"], _ = zoo_hold(
            f"{arch} int8", cfg8, params, seqs, extra, max_len, device,
            ZOO_INT8_TOL, greedy)
    if spec.get("f32_witness"):
        out["f32_witness"] = zoo_f32_witness(arch, cfg, params, seqs, extra,
                                             max_len, device, tf)
    out["seconds"] = time.perf_counter() - t0
    return out


def device_profile(fn, reps: int, tag: str):
    """(ms, names): the mean device time per call of `fn` in kernels whose
    name holds `tag` ("" for every kernel), from a profile of `reps` calls
    after one warm-up call, and the names of those kernels.  Late in a long
    process the profiler drops events, so a profile counts only when the
    one before it recorded the same number of such kernel runs, a nonzero
    multiple of the calls; after five profiles without that, (0.0, [])."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = None
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if tag in e.key and e.device_time_total > 0]
        runs = sum(e.count for e in hits)
        if runs and runs % reps == 0 and runs == seen:
            return (sum(e.device_time_total for e in hits) / 1e3 / reps,
                    sorted({e.key for e in hits}))
        seen = runs
    return 0.0, []


# the kernels of K5's and K6's bf16 instances run on the tensor cores: their
# names hold this (the f32 instances' do not)
TC_TAG = "_tc_kernel"


def variant_entry(run, plain, library, pairs, nbytes, D, shape, reps: int,
                  tag: str, tc=None, peak=BF16_FLOPS_PER_S) -> dict:
    """One instance's times: CUDA-event ms a call (host launch path
    included), the kernel's own device ms (profiler, kernels named with
    `tag`; where a profile records none, the ms a call inside a CUDA graph
    of GRAPH_CALLS calls), the plain version's ms, one library call's
    event and device ms (all its kernels), and the bound
    (`attention_bound_ms` at `peak`).  With `tc` set, the kernels the
    profiler saw must (True) or must not (False) be the tensor-core
    instances."""
    bound, by = attention_bound_ms(pairs, nbytes, D, peak)
    dev, names, dev_by = kernel_device_ms(run, reps, tag)
    if tc is not None and any((TC_TAG in n) != tc for n in names):
        fail(f"{shape}: kernels {names}, want tensor-core instances: {tc}")
    out = {"shape": shape, "ms": time_ms(run, reps), "device_ms": dev,
           "device_ms_by": dev_by, "kernels": names,
           "plain_ms": time_ms(plain, max(1, reps // 4)),
           "library_ms": None, "library_device_ms": None,
           "bound_ms": bound, "bound_by": by}
    if library is not None:
        out["library_ms"] = time_ms(library, reps)
        out["library_device_ms"] = profiled_ms(library, reps, "")
    return out


def profiled_ms(fn, reps: int, tag: str):
    """`device_profile`'s ms, or None where the profiler missed calls."""
    ms, names = device_profile(fn, reps, tag)
    return ms if names else None


def kernel_device_ms(fn, reps: int, tag: str):
    """(ms, kernel names, "profiler" | "graph"): `device_profile`'s ms a
    call of a one-launch `fn`, or where the profiler missed calls the ms a
    call inside a CUDA graph of GRAPH_CALLS calls (no names then)."""
    ms, names = device_profile(fn, reps, tag)
    if names:
        return ms, names, "profiler"
    return graph_ms(fn, GRAPH_CALLS, max(1, reps // 4)), [], "graph"


# internlm2-1.8b's train step (bf16, B 2, S = T = 4,096): K6's shape there
TRAIN_K6_SHAPE = (2, 8, 2, 4096, 128)


def zoo_variant_times(device, reps: int, tc=True) -> dict:
    """Each bf16 K5/K6 instance of the zoo and the train phase at the shape
    its arch gives it (`variant_entry`): the ring, int8, the prefix mask,
    deepseek's decompressed MLA prefill (D = 192), whisper's
    cross-attention and cross decode, internlm2's train step
    (TRAIN_K6_SHAPE).  The library call is `scaled_dot_product_attention`
    with the mask as a boolean input (none for int8 codes).  `tc` as for
    `variant_entry` (None: not checked, as for an older tree)."""
    import torch
    from repro_torch.common.utils import sm_count
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(23)
    bf = torch.bfloat16
    out = {}

    def entry(run, plain, library, pairs, nbytes, D, shape, quant=False):
        tag = "flash_fwd" if "S" in shape else "decode_attention"
        out = variant_entry(run, plain, library, pairs, nbytes, D, shape,
                            reps, tag, tc)
        if tc:      # resident CTAs an SM and shared memory of the instance
            if "S" in shape:
                narrow = fa.flash_grid(shape["B"], shape["K"], shape["G"],
                                       shape["S"], D, sm_count(device), bf)[0]
                occ = fa.occupancy(bf, D, narrow)
            else:
                occ = da.occupancy(bf, D, quant, "window" in shape)
            out["ctas_per_sm"], out["smem_bytes"] = occ
        return out

    # recurrentgemma's local attention on the ring: 16 heads on one kv
    # head, D = 256, 2048 slots, queries past the first lap
    B, K, G, T, D = ZOO_SLOTS, 1, 16, 2048, 256
    q = _rand((B, K, G, D), gen, device, bf)
    k = _rand((B, T, K, D), gen, device, bf).permute(0, 2, 1, 3)
    v = _rand((B, T, K, D), gen, device, bf).permute(0, 2, 1, 3)
    q_pos = [2100 + 97 * b for b in range(B)]
    kv_len = torch.tensor([p + 1 for p in q_pos], dtype=torch.int32,
                          device=device)
    sp = ring_slots(q_pos, T, 0, gen, device)
    ok = (sp >= 0) & (sp <= kv_len[:, None] - 1) & (sp > kv_len[:, None] - 1 - T)
    rows = int(ok.sum())
    mask = ok[:, None, None, :]
    out["decode_attention[slot_pos]"] = entry(
        lambda: da.decode_attention(q, k, v, kv_len, window=T, slot_pos=sp),
        lambda: da.decode_attention_ref(q, k, v, kv_len, window=T,
                                        slot_pos=sp),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q.reshape(B, K * G, 1, D), k, v, attn_mask=mask, enable_gqa=True),
        rows * K * G, 2 * (2 * q.numel() + 2 * rows * K * D) + 4 * B * T, D,
        {"B": B, "K": K, "G": G, "T": T, "D": D, "window": T})
    # phi3.5-moe's int8 cache: 8 kv heads x 4, D = 128, ~200 positions
    B, K, G, T, D = ZOO_SLOTS, 8, 4, ZOO_MAX_LEN, 128
    q = _rand((B, K, G, D), gen, device, bf)
    kc, ks = quant_cache(B, K, T, D, gen, device)
    vc, vs = quant_cache(B, K, T, D, gen, device)
    kv_len = torch.full((B,), DECODE_KV_LEN + 30, dtype=torch.int32,
                        device=device)
    rows = B * (DECODE_KV_LEN + 30)
    out["decode_attention[int8]"] = entry(
        lambda: da.decode_attention(q, kc, vc, kv_len, k_scale=ks,
                                    v_scale=vs),
        lambda: da.decode_attention_ref(q, kc, vc, kv_len, k_scale=ks,
                                        v_scale=vs),
        None, rows * K * G,
        2 * 2 * q.numel() + 2 * rows * K * (D + 4) + 4 * B, D,
        {"B": B, "K": K, "G": G, "T": T, "D": D, "kv_len": DECODE_KV_LEN + 30},
        quant=True)
    # paligemma's prefill: 256 image positions + text, 8 heads on one kv
    # head, D = 256, the prefix mask
    B, K, G, S, D, P = 1, 1, 8, 256 + ZOO_PROMPT, 256, 256
    q = _rand((B, K, G, S, D), gen, device, bf)
    k = _rand((B, K, S, D), gen, device, bf)
    v = _rand((B, K, S, D), gen, device, bf)
    t = torch.arange(S, device=device)
    ok = (t[None, :] <= t[:, None]) | (t[None, :] < P)
    out["flash_attention[prefix]"] = entry(
        lambda: fa.flash_attention(q, k, v, prefix_len=P),
        lambda: fa.flash_attention_ref(q, k, v, prefix_len=P),
        lambda: sdpa_gqa(q, k, v, attn_mask=ok),
        int(ok.sum()) * K * G, 2 * (2 * q.numel() + k.numel() + v.numel()), D,
        {"B": B, "K": K, "G": G, "S": S, "T": S, "D": D, "prefix": P})
    # deepseek's decompressed MLA prefill: 128 heads of 192 (v padded)
    B, K, G, S, D = 1, 128, 1, 200, 192
    q = _rand((B, K, G, S, D), gen, device, bf)
    k = _rand((B, K, S, D), gen, device, bf)
    v = _rand((B, K, S, D), gen, device, bf)
    out["flash_attention mla_prefill"] = entry(
        lambda: fa.flash_attention(q, k, v), lambda: fa.flash_attention_ref(
            q, k, v), lambda: sdpa_gqa(q, k, v, is_causal=True),
        K * G * flash_pairs(S, S, True, 0),
        2 * (2 * q.numel() + k.numel() + v.numel()), D,
        {"B": B, "K": K, "G": G, "S": S, "T": S, "D": D})
    # whisper's cross-attention: 64 text positions over 1500 frames
    B, K, G, S, T, D = ZOO_BATCH, 12, 1, ZOO_PROMPT, 1500, 64
    q = _rand((B, K, G, S, D), gen, device, bf)
    k = _rand((B, K, T, D), gen, device, bf)
    v = _rand((B, K, T, D), gen, device, bf)
    out["flash_attention cross"] = entry(
        lambda: fa.flash_attention(q, k, v, causal=False),
        lambda: fa.flash_attention_ref(q, k, v, causal=False),
        lambda: sdpa_gqa(q, k, v), B * K * G * S * T,
        2 * (2 * q.numel() + k.numel() + v.numel()), D,
        {"B": B, "K": K, "G": G, "S": S, "T": T, "D": D})
    qd = q[:, :, :, 0]
    full = torch.full((B,), T, dtype=torch.int32, device=device)
    out["decode_attention cross"] = entry(
        lambda: da.decode_attention(qd, k, v, full),
        lambda: da.decode_attention_ref(qd, k, v, full),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qd.reshape(B, K * G, 1, D), k, v, enable_gqa=True),
        B * K * G * T, 2 * (2 * qd.numel() + 2 * B * K * T * D), D,
        {"B": B, "K": K, "G": G, "T": T, "D": D})
    # internlm2-1.8b's train step: K6's forward (and its recompute)
    B, K, G, S, D = TRAIN_K6_SHAPE
    q = _rand((B, S, K * G, D), gen, device, bf).view(
        B, S, K, G, D).permute(0, 2, 3, 1, 4)
    k = _rand((B, S, K, D), gen, device, bf).permute(0, 2, 1, 3)
    v = _rand((B, S, K, D), gen, device, bf).permute(0, 2, 1, 3)
    out["flash_attention train"] = entry(
        lambda: fa.flash_attention(q, k, v), lambda: fa.flash_attention_ref(
            q, k, v), lambda: sdpa_gqa(q, k, v, is_causal=True),
        B * K * G * flash_pairs(S, S, True, 0),
        2 * (2 * q.numel() + k.numel() + v.numel()), D,
        {"B": B, "K": K, "G": G, "S": S, "T": S, "D": D})
    return out


def phase_zoo(device, reps: int) -> dict:
    """The rest of the zoo at full width (ZOO), one arch at a time, each
    built from a seed on the card and freed before the next; then the
    variants' times."""
    import torch
    t0 = time.perf_counter()
    archs = {}
    totals = {name: 0 for name in wrappers()}
    for arch in ZOO:
        r = archs[arch] = zoo_arch(arch, device)
        for part in ("served", "served_int8"):
            if part in r:
                for name, n in r[part]["launches"].items():
                    totals[name] += n
        emit({"phase": "zoo", "arch": arch, **r, "gpu": gpu_line()})
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("flash_attention", "decode_attention"):  # every zoo call is bf16
        if totals[f"{name}[tc]"] != totals[name]:
            fail(f"zoo: {totals[name]} {name} launches, "
                 f"{totals[f'{name}[tc]']} of them on the tensor cores")
    times = zoo_variant_times(device, reps)
    out = {"phase": "zoo", "launches": totals, "variant_times": times,
           "seconds": time.perf_counter() - t0, "gpu": gpu_line()}
    emit(out)
    out["archs"] = archs
    return out


# -- phase 15: train -------------------------------------------------------------

# (a) K6's gradient: mask cases x (G, D) pairs x dtypes; S off the
# backward's 256-row block
TRAIN_GRAD_MASKS = {
    "causal": dict(causal=True), "window": dict(causal=True, window=40),
    "prefix": dict(causal=True, prefix=70),
    "prefix_rows": dict(causal=True, prefix=[5, 290]),
    "bidir": dict(causal=False), "cross": dict(causal=False, S=40, T=700),
}
TRAIN_GRAD_SHAPES = ((1, 64), (3, 128), (4, 192), (16, 256))   # (G, D)
# the Function's dq/dk/dv against autograd through the plain version on
# the card, relative to the plain gradient's largest |g|: f32, K6's output
# (which D = rowsum(dO * O) takes in) is within ATTN_TOL of the plain
# version's; bf16, that output is rounded to bf16 (2**-8) before D and
# each gradient is rounded once more: ATTN_TOL's bf16 value
TRAIN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (b) memori-agent as the example trains it: B x S tokens a step, its
# optimizer settings, TRAIN_STEPS steps (the example's 200 cut to keep the
# script's time; ce has fallen from 10.4 to ~0.5 by step 200)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 256, 160
# batches the pipeline makes alone, to time its share of a step
PIPELINE_BATCHES = 20
# step 1 of the kernel path against the plain path on the same weights and
# batch: loss relative TRAIN_LOSS_TOL; each leaf's gradient within
# TRAIN_LEAF_TOL of max(its largest |g|, 1e-2 x the tree's largest) — f32
# through 12 layers whose attention sums in another order (online against
# direct softmax); the floor keeps a leaf whose exact gradient is ~0 from
# being judged on rounding.  On the conditioned weights (`conditioned`,
# as the lm phase): at the reference's init attention is a hard max and
# two correct paths part by O(1), so there the difference is reported,
# not held
TRAIN_LOSS_TOL, TRAIN_LEAF_TOL = 1e-5, 1e-3
# the reference's own criterion (tests/test_training.py): ce falls by 0.2.
# The run starts from the conditioned weights: at the reference's init a
# 12-layer stack's attention is a hard max and its gradient norm ~1e6
# (both packages: 12 layers of width 256 on the CPU read 1e6 to 9e7), so
# after clipping to 1.0 most elements sit below Adam's eps and ce stays
# flat; the reference-init step is reported beside it
TRAIN_CE_DROP = 0.2
# (c) internlm2-1.8b at full width and depth, bf16, train_4k's length
BIG_ARCH, BIG_B, BIG_S, BIG_STEPS = "internlm2-1.8b", 2, 4096, 3
# its step-1 loss against the plain path's (both bf16 end to end, 24
# layers; the loss is a mean over 8,192 tokens near ln V): relative 2**-7
BIG_LOSS_TOL = 2.0 ** -7
# (d) every assigned arch reduced as tests/test_torch_train_zoo*.py:
# relative to max(leaf, 1e-2 x tree) largest |g|, as (b)
ZOO_TRAIN_TOL = 1e-3
TRAIN_LAUNCHER_ARGS = ("--arch", "internlm2-1.8b", "--shape", "train_4k",
                       "--steps", "3", "--host-demo")


def grad_case(gen, device, dtype, B, K, G, S, T, D, causal, window=0,
              prefix=None):
    """One K6 gradient case: the Function's (dq, dk, dv) against autograd
    through the plain version, same inputs and output gradient; returns
    the largest error relative to each plain gradient's largest |g|."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    q = _rand((B, K, G, S, D), gen, device, dtype).requires_grad_(True)
    k = _rand((B, K, T, D), gen, device, dtype).requires_grad_(True)
    v = _rand((B, K, T, D), gen, device, dtype).requires_grad_(True)
    g = _rand((B, K, G, S, D), gen, device, dtype)
    if isinstance(prefix, list):
        prefix = torch.tensor(prefix, dtype=torch.int32, device=device)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    out = fa.flash_attention(q, k, v, **kw)
    if type(out.grad_fn).__name__ != "FlashAttentionFnBackward":
        fail(f"train: K6 on a CUDA tensor needing a gradient ran "
             f"{out.grad_fn}, not its autograd Function")
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(fa.flash_attention_ref(q, k, v, **kw),
                               (q, k, v), g)
    torch.cuda.synchronize()
    tol = TRAIN_GRAD_TOL[str(dtype)[6:]]
    worst = 0.0
    for name, a, b in zip("qkv", got, want):
        if a.dtype != dtype or a.shape != b.shape:
            fail(f"train: d{name} {a.dtype} {tuple(a.shape)}")
        err = float((a.float() - b.float()).abs().max()) / max(
            float(b.float().abs().max()), 1e-30)
        if not err <= tol:
            fail(f"train: K6 d{name} {str(dtype)[6:]} B={B} K={K} G={G} "
                 f"S={S} T={T} D={D} {kw}: relative error {err} > {tol}")
        worst = max(worst, err)
    return worst


def train_grad_cases(device) -> dict:
    """(a): every mask kind x (G, D) pair, f32 and bf16."""
    import torch
    gen = torch.Generator(device=device).manual_seed(15)
    worst, n = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        for mask, kw in TRAIN_GRAD_MASKS.items():
            kw = dict(kw)
            S, T = kw.pop("S", 300), kw.pop("T", 300)
            for G, D in TRAIN_GRAD_SHAPES:
                err = grad_case(gen, device, dtype, 2, 2, G, S, T, D, **kw)
                key = str(dtype)[6:]
                worst[key] = max(worst.get(key, 0.0), err)
                n += 1
    # three query blocks, the last of one row, and rows with no allowed key
    worst["float32"] = max(worst["float32"], grad_case(
        gen, device, torch.float32, 1, 2, 3, 513, 513, 64, True),
        grad_case(gen, device, torch.float32, 1, 2, 3, 600, 100, 64, True,
                  window=30))
    return {"cases": n + 2, "max_rel_err": worst, "tolerance": TRAIN_GRAD_TOL}


def tree_rel_err(got, want, what: str, tol=None) -> float:
    """The largest error of a gradient tree (leaves in one order) relative
    to max(the leaf's largest |g|, 1e-2 x the tree's largest); fails above
    `tol` (when given) or on a non-finite leaf."""
    import torch
    top = max(float(w.float().abs().max()) for w in want)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(a).all()):
            fail(f"train: {what}: leaf {i} has a non-finite gradient")
        scale = max(float(b.float().abs().max()), 1e-2 * top, 1e-30)
        err = float((a.float() - b.float()).abs().max()) / scale
        if tol is not None and not err <= tol:
            fail(f"train: {what}: leaf {i} gradient differs by {err} of "
                 f"its scale > {tol}")
        worst = max(worst, err)
    return worst


def kernel_vs_plain_step(model, params, batch, what: str, leaf_tol=None,
                         loss_tol=None) -> dict:
    """The loss and every leaf's gradient of one train step, kernel path
    (K6 through its Function) against the plain path (autograd through the
    plain version) on the same weights and batch; checked when tolerances
    are given."""
    from repro_torch.common.module import leaves_with_names
    from repro_torch.training.train_loop import loss_and_grads
    m_k, g_k = loss_and_grads(model, params, batch)
    with plain_attention():
        m_p, g_p = loss_and_grads(model, params, batch)
    loss_err = abs(float(m_k["loss"]) - float(m_p["loss"])) / max(
        abs(float(m_p["loss"])), 1e-30)
    if loss_tol is not None and not loss_err <= loss_tol:
        fail(f"train: {what}: loss {float(m_k['loss'])} vs plain "
             f"{float(m_p['loss'])}: relative {loss_err} > {loss_tol}")
    leaf_err = tree_rel_err([g for _, g in leaves_with_names(g_k)],
                            [g for _, g in leaves_with_names(g_p)], what,
                            leaf_tol)
    from repro_torch.training.optimizer import global_norm
    return {"loss": float(m_k["loss"]), "plain_loss": float(m_p["loss"]),
            "loss_rel_err": loss_err, "max_leaf_rel_err": leaf_err,
            "grad_norm": float(global_norm(g_k))}


def train_flops(cfg, B: int, S: int) -> dict:
    """FLOPs of one train step from the shapes.  Model FLOPs: 6 N T (N the
    parameters that multiply: an untied embedding table's lookup is no
    product) plus attention 12 x (allowed query-key pairs) x D x heads x
    layers (forward 4, backward 8; causal).  Executed adds the recompute:
    the blocks' forward again (2 N_blocks T + 4 pairs D H L) and the
    backward's recomputed scores (2 pairs D H L)."""
    T = B * S
    n = cfg.param_count()
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model
    n_blocks = n - cfg.vocab_size * cfg.d_model       # the logits product
    pairs = B * S * (S + 1) // 2
    attn_unit = pairs * cfg.resolved_head_dim * cfg.num_heads * sum(
        1 for kind in cfg.layer_kinds() if kind[0] == "attn")
    model = 6 * n * T + 12 * attn_unit
    executed = model + 2 * n_blocks * T + 6 * attn_unit
    return {"model_flops": model, "executed_flops": executed,
            "n_multiplying_params": n, "tokens": T}


def profile_train_step(step_fn, params, opt_state, batch) -> dict:
    """One profiled train step (after the run): device ms of K6's forward
    (`flash_fwd` kernels), of the attention backward (CUDA events around
    each `flash_attention_bwd`), of the GEMMs (kernels named `gemm` /
    `gemv`), of the optimizer update (CUDA events around `update`); the
    device's kernels, busy ms and idle share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.training import optimizer as opt
    spans = {"bwd": [], "opt": []}

    def timed(fn, key):
        def run(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **kw)
            e.record()
            spans[key].append((s, e))
            return out
        return run

    bwd, update = fa.flash_attention_bwd, opt.update
    fa.flash_attention_bwd = timed(bwd, "bwd")
    opt.update = timed(update, "opt")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        fa.flash_attention_bwd, opt.update = bwd, update
    act = device_activity(prof)
    by_name = act["by_name"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": act["busy_ms"],
            "device_idle_share": 1.0 - act["busy_ms"] / wall_ms,
            "device_kernels": act["kernels"],
            "host_launch_calls": sum(act["host_calls"].values()),
            "k6_forward_ms": sum(ms for n, ms in by_name.items()
                                 if "flash_fwd" in n),
            "attention_backward_ms": sum(s.elapsed_time(e)
                                         for s, e in spans["bwd"]),
            "attention_backward_calls": len(spans["bwd"]),
            "gemm_ms": sum(ms for n, ms in by_name.items()
                           if "gemm" in n.lower() or "gemv" in n.lower()),
            "optimizer_ms": sum(s.elapsed_time(e) for s, e in spans["opt"]),
            "top_kernels_ms": {n[:60]: ms for n, ms in top}}


def step_stats(walls, tokens: int) -> dict:
    import numpy as np
    ms = np.diff(np.asarray([0.0] + walls)) * 1e3
    return {"step_ms_p50": float(np.median(ms)),
            "step_ms_first": float(ms[0]),
            "step_ms_p50_after_first": float(np.median(ms[1:]))
            if len(ms) > 1 else float(ms[0]),
            "tokens_per_s": tokens / (float(np.median(ms)) / 1e3)}


def train_agent(device, totals) -> dict:
    """(b): memori-agent at full width, f32, trained as the example trains
    it from the conditioned weights (TRAIN_CE_DROP); step 1 against the
    plain path; the checkpoint read back; sampling through Engine."""
    import tempfile
    import torch
    from repro_torch.checkpoint import io as ckpt
    from repro_torch.common.module import leaves_with_names
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batches
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models.model_api import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_train_step, train)
    cfg = get_config("memori-agent")
    model = Model(cfg)
    init = model.init_params(torch.Generator(device=device).manual_seed(0))
    params = conditioned(init, cfg)
    tok = HashTokenizer(cfg.vocab_size)
    first = next(batches(TRAIN_B, TRAIN_S, tokenizer=tok, device=device))
    # the run's step 1, kernel path against plain path; the same at the
    # reference's init, reported
    held = kernel_vs_plain_step(model, params, first,
                                "memori-agent step 1 (conditioned)",
                                TRAIN_LEAF_TOL, TRAIN_LOSS_TOL)
    at_init = kernel_vs_plain_step(model, init, first,
                                   "memori-agent step 1 (reference init)")
    del init
    gc.collect()
    torch.cuda.empty_cache()

    tc = TrainConfig(steps=TRAIN_STEPS, log_every=1, opt=opt.OptimizerConfig(
        peak_lr=6e-4, warmup_steps=TRAIN_STEPS // 10,
        total_steps=TRAIN_STEPS))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trained, hist = train(model, params, batches(
        TRAIN_B, TRAIN_S, tokenizer=tok, device=device), tc)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        totals[name] += n
    want_k6 = 2 * cfg.num_layers * TRAIN_STEPS
    if launches["flash_attention"] != want_k6:
        fail(f"train: K6 counted {launches['flash_attention']} launches "
             f"over {TRAIN_STEPS} steps, want {want_k6} (forward + recompute "
             f"of each of {cfg.num_layers} layers a step)")
    if launches["decode_attention"]:
        fail("train: K5 launched in a training step")
    ce0, ce1 = hist[0]["ce"], hist[-1]["ce"]
    if not ce1 < ce0 - TRAIN_CE_DROP:
        fail(f"train: memori-agent ce {ce0} -> {ce1}: fell by less than "
             f"{TRAIN_CE_DROP}")
    if abs(hist[0]["loss"] - held["loss"]) > TRAIN_LOSS_TOL * abs(
            held["loss"]):
        fail(f"train: the run's step-1 loss {hist[0]['loss']} is not the "
             f"checked one {held['loss']}")
    stats = step_stats([h["wall"] for h in hist], TRAIN_B * TRAIN_S)
    # the pipeline's share of a step: host ms to make and upload a batch
    data = batches(TRAIN_B, TRAIN_S, tokenizer=tok, device=device, seed=2)
    t = time.perf_counter()
    for _ in range(PIPELINE_BATCHES):
        next(data)
    torch.cuda.synchronize()
    pipeline_ms = (time.perf_counter() - t) * 1e3 / PIPELINE_BATCHES

    # the checkpoint, read back bit-equal
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "memori_agent.msgpack")
        t = time.perf_counter()
        nbytes = ckpt.save_params(path, cfg, trained)
        save_s = time.perf_counter() - t
        back = ckpt.load_params(path, cfg, like=trained)
    for (name, a), (_, b) in zip(leaves_with_names(trained),
                                 leaves_with_names(back)):
        if not torch.equal(a, b):
            fail(f"train: checkpoint leaf {name} did not read back equal")

    # one profiled step of the trained state (its output is dropped)
    step_fn = make_train_step(model, tc)
    batch = next(batches(TRAIN_B, TRAIN_S, tokenizer=tok, device=device,
                         seed=1))
    state = opt.init(tc.opt, trained)
    step_fn(trained, state, batch)                    # warm-up
    profiled = profile_train_step(step_fn, trained, state, batch)

    # sampling from the trained weights: K6 prefill, K5 decode
    reset_counts()
    eng = Engine(model, trained, max_len=TRAIN_S, slots=2,
                 sampler=SamplerConfig(temperature=0.8, top_k=40),
                 tokenizer=tok)
    samples = eng.generate(["Caroline: My favorite food is",
                            "Ben: I went to"], max_new_tokens=12)
    sampled = counts()
    for name, n in sampled.items():
        totals[name] += n
    if sampled["flash_attention"] < 1 or sampled["decode_attention"] < 1:
        fail(f"train: sampling launched K6 {sampled['flash_attention']} / "
             f"K5 {sampled['decode_attention']} times")
    flops = train_flops(cfg, TRAIN_B, TRAIN_S)
    step_s = stats["step_ms_p50"] / 1e3
    return {"arch": "memori-agent", "dtype": cfg.compute_dtype,
            "params": cfg.param_count(), "batch": TRAIN_B, "seq": TRAIN_S,
            "steps": TRAIN_STEPS, "ce_first": ce0, "ce_last": ce1,
            "accuracy_last": hist[-1]["accuracy"],
            "grad_norm_first": hist[0]["grad_norm"],
            "grad_norm_last": hist[-1]["grad_norm"],
            **stats, "pipeline_ms_per_batch": pipeline_ms,
            "peak_memory_bytes": peak, "launches": launches,
            "k6_launches_per_step": launches["flash_attention"] / TRAIN_STEPS,
            "weights": "conditioned (wq, wk at unit score spread)",
            "step1_vs_plain_conditioned": held,
            "step1_vs_plain_reference_init": at_init,
            "checkpoint": {"bytes": nbytes, "save_s": save_s,
                           "read_back": "bit-equal"},
            **flops,
            "model_flops_share_of_fp32_peak":
                flops["model_flops"] / step_s / FP32_FLOPS_PER_S,
            "executed_flops_share_of_fp32_peak":
                flops["executed_flops"] / step_s / FP32_FLOPS_PER_S,
            "profiled_step": profiled,
            "sampling_launches": sampled, "samples": samples}


def train_big(device, totals, steps: int = BIG_STEPS) -> dict:
    """(c): internlm2-1.8b at full width and depth, bf16, through
    `launch.sharding.build_train_step` at B = 2, S = 4096, `steps` steps."""
    import numpy as np
    import torch
    from repro_torch.common.module import materialize
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import build_train_step
    from repro_torch.launch.train import fold_in
    from repro_torch.models.config import InputShape
    from repro_torch.models.model_api import Model
    from repro_torch.training import optimizer as opt
    cfg = get_config(BIG_ARCH)
    model = Model(cfg)
    shape = InputShape("train_4k", BIG_S, BIG_B, "train")
    bundle = build_train_step(cfg, shape, device=device)
    torch.cuda.reset_peak_memory_stats()
    params = materialize(torch.Generator(device=device).manual_seed(0),
                         model.param_specs(), cfg.pdtype)
    opt_state = opt.init(bundle.opt, params)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()

    def batch_of(step):
        gen = torch.Generator(device=device).manual_seed(fold_in(1, step))
        (shp, dt), = bundle.inputs.values()
        return {"tokens": torch.randint(4, cfg.vocab_size, shp,
                                        generator=gen, device=device,
                                        dtype=dt)}
    with torch.no_grad(), plain_attention():
        plain_loss = float(model.train_loss(params, batch_of(0))[0])
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    losses, gnorms, walls = [], [], []
    t0 = time.perf_counter()
    for step in range(steps):
        params, opt_state, metrics = bundle.fn(params, opt_state,
                                               batch_of(step))
        losses.append(float(metrics["loss"]))          # waits for the step
        gnorms.append(float(metrics["grad_norm"]))
        walls.append(time.perf_counter() - t0)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        totals[name] += n
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        fail(f"train: {BIG_ARCH} loss {losses} / grad norm {gnorms} not "
             f"finite")
    err = abs(losses[0] - plain_loss) / abs(plain_loss)
    if not err <= BIG_LOSS_TOL:
        fail(f"train: {BIG_ARCH} step-1 loss {losses[0]} vs plain path "
             f"{plain_loss}: relative {err} > {BIG_LOSS_TOL}")
    want_k6 = 2 * cfg.num_layers * steps
    if launches["flash_attention"] != want_k6:
        fail(f"train: {BIG_ARCH} K6 counted {launches['flash_attention']}, "
             f"want {want_k6}")
    # the model's positions are 0..S-1 and it says so: no K6 call takes
    # the instances with offsets (whose backward has no key cut)
    if launches.get("flash_attention[offset]", 0):
        fail(f"train: {BIG_ARCH} K6 ran with position offsets "
             f"{launches['flash_attention[offset]']} times")
    stats = step_stats(walls, BIG_B * BIG_S)
    flops = train_flops(cfg, BIG_B, BIG_S)
    step_s = stats["step_ms_p50_after_first"] / 1e3
    del params, opt_state
    return {"arch": BIG_ARCH, "dtype": cfg.compute_dtype,
            "params": cfg.param_count(), "batch": BIG_B, "seq": BIG_S,
            "opt_state_dtype": bundle.opt.state_dtype, "losses": losses,
            "grad_norms": gnorms, "plain_step1_loss": plain_loss,
            "step1_loss_rel_err": err, "loss_tolerance": BIG_LOSS_TOL,
            **stats, "resident_bytes_params_and_moments": resident,
            "peak_memory_bytes": peak, "launches": launches, **flops,
            "model_flops_share_of_bf16_peak":
                flops["model_flops"] / step_s / BF16_FLOPS_PER_S,
            "executed_flops_share_of_bf16_peak":
                flops["executed_flops"] / step_s / BF16_FLOPS_PER_S}


def train_zoo(device, totals) -> dict:
    """(d): one train step of every assigned arch, reduced as the CPU
    tests reduce it (f32), kernel path against plain path."""
    import numpy as np
    import torch
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.models.model_api import Model
    out = {}
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        cfg = cfg.reduced(layers=3 if cfg.hybrid_period else 2, d_model=64)
        model = Model(cfg)
        params = model.init_params(
            torch.Generator(device=device).manual_seed(22))
        rng = np.random.default_rng(23)
        B, S = 2, 24
        batch = {"tokens": rng.integers(4, cfg.vocab_size, (B, S)).astype(
                     np.int32),
                 "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
        if cfg.num_image_tokens:
            batch["images"] = rng.standard_normal(
                (B, cfg.num_image_tokens, 1152)).astype(np.float32)
        if cfg.is_encoder_decoder:
            batch["audio"] = rng.standard_normal(
                (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        reset_counts()
        r = kernel_vs_plain_step(model, params, batch, f"{arch} reduced",
                                 ZOO_TRAIN_TOL, TRAIN_LOSS_TOL)
        launches = counts()
        has_attn = any(kind[0] == "attn" for kind in cfg.layer_kinds())
        if has_attn and launches["flash_attention"] < 1:
            fail(f"train: {arch}: K6 not launched in its train step")
        for name, n in launches.items():
            totals[name] += n
        out[arch] = {**r, "k6_launches": launches["flash_attention"],
                     "k6_prefix_launches":
                         launches["flash_attention[prefix]"]}
    if out["paligemma-3b"]["k6_prefix_launches"] < 1:
        fail("train: paligemma's step did not launch K6's prefix mask")
    return out


def train_launcher(src: str) -> dict:
    """(e): `python -m repro_torch.launch.train ... --host-demo` on the
    card as a subprocess: exit 0, a line a step, then `done`."""
    env = dict(os.environ, PYTHONPATH=src)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         *TRAIN_LAUNCHER_ARGS], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines or lines[-1] != "done":
        fail(f"train: launcher exit {proc.returncode}:\n{proc.stdout[-2000:]}"
             f"\n{proc.stderr[-3000:]}")
    steps = [ln for ln in lines if ln.startswith("step ")]
    if len(steps) != 3:
        fail(f"train: launcher printed {steps}")
    return {"args": list(TRAIN_LAUNCHER_ARGS), "seconds":
            time.perf_counter() - t, "lines": steps}


def phase_train(device, launcher: dict) -> dict:
    """Phase 15: K6's gradient, memori-agent trained at full width,
    internlm2-1.8b at full size in bf16, every arch's reduced step against
    the plain path, and the train launcher's result (`launcher`: it ran
    beside the durability phase)."""
    import torch
    t0 = time.perf_counter()
    totals = {name: 0 for name in wrappers()}
    parts = {}
    t = time.perf_counter()
    parts["grad"] = {**train_grad_cases(device),
                     "seconds": time.perf_counter() - t}
    emit({"phase": "train", "part": "grad", **parts["grad"]})
    for key, fn in (("agent", train_agent), ("internlm2", train_big),
                    ("zoo", train_zoo)):
        t = time.perf_counter()
        parts[key] = fn(device, totals)
        parts[key]["seconds"] = time.perf_counter() - t
        emit({"phase": "train", "part": key, **parts[key],
              "gpu": gpu_line()})
        gc.collect()
        torch.cuda.empty_cache()
    big = parts["internlm2"]["launches"]
    if big["flash_attention[tc]"] != big["flash_attention"]:
        fail(f"train: internlm2-1.8b (bf16) launched K6 {big['flash_attention']} "
             f"times, {big['flash_attention[tc]']} on the tensor cores")
    if parts["agent"]["launches"]["flash_attention[tc]"]:
        fail("train: memori-agent's f32 K6 launches ran tensor-core instances")
    parts["launcher"] = launcher
    out = {"phase": "train", "launches": totals,
           "seconds": time.perf_counter() - t0, "gpu": gpu_line(),
           "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                          "cudnn": torch.backends.cudnn.allow_tf32}}
    emit({**out, "launcher": parts["launcher"]})
    out["parts"] = parts
    return out


# -- phase 16: dist ------------------------------------------------------------

# The mesh of the dist phase: one NCCL rank on the card.  With torch 2.11 on
# an H100, gloo moves CUDA tensors for its raw collectives, but DTensor's
# functional collectives on a 2-rank gloo group of CUDA tensors on one card
# end both ranks, and NCCL takes one rank a card, so every meshed path runs
# on a (1, 1) ("data", "model") mesh (PERF.md §6).  Several ranks are
# covered on the CPU (tests/test_torch_distribution*.py: 4 gloo ranks).
DIST_BACKEND, DIST_MESH = "nccl", (1, 1)
DIST_TRAIN_B, DIST_TRAIN_S, DIST_TRAIN_STEPS = 8, 256, 5
DIST_LOSS_TOL, DIST_LEAF_TOL = 1e-5, 1e-4
DIST_SERVE_B, DIST_PROMPT, DIST_NEW, DIST_MAX_LEN = 4, 96, 16, 160
# a greedy divergence from the Engine's tokens must sit at a top-two margin
# below this (kernel against kernel, other batch shapes, f32)
DIST_MARGIN_TOL = 1e-3
# deepseek-v3's absorbed MLA: prefill at the zoo's 4 layers; one train step
# at 2 layers (the first dense layers, and the MTP block) beside bf16 moments
MLA_LAYERS, MLA_TRAIN_LAYERS, MLA_B, MLA_S = 4, 2, 2, 64
# the D = 576 instance timed at B = 1, G = 128 heads over one latent, S = T
ABSORBED = "flash_attention[d576]"
ABSORBED_TIME_S = 512
# (B, K, G, S, T, D, causal, window, (CTA shape, K/V by cp.async)) of the
# attention phase's D = 576 cases
ABSORBED_CASES = [
    (1, 1, 128, 64, 64, 576, True, 0, ("wide", True)),
    (2, 1, 128, 32, 32, 520, True, 0, ("wide", True)),
    (1, 1, 16, 40, 40, 576, False, 0, ("narrow", True)),
    (1, 1, 16, 40, 40, 515, True, 0, ("narrow", False)),
    (1, 1, 16, 70, 70, 576, True, 16, None)]
_DIST = {}


def dist_mesh():
    """The dist phase's mesh (DIST_BACKEND, DIST_MESH), made once: a
    FileStore in a temporary directory, no TCP port."""
    if "mesh" not in _DIST:
        import tempfile
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_host_mesh
        _DIST["dir"] = tempfile.TemporaryDirectory()
        dist.init_process_group(
            DIST_BACKEND, init_method="file://" + os.path.join(
                _DIST["dir"].name, "store"), rank=0, world_size=1)
        _DIST["mesh"] = make_host_mesh(*DIST_MESH, device_type="cuda")
    return _DIST["mesh"]


def close_dist() -> None:
    if "mesh" in _DIST:
        import torch.distributed as dist
        dist.destroy_process_group()
        _DIST.pop("mesh")
        _DIST.pop("dir").cleanup()


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def dist_store(device, svc, questions, reps: int, mesh, arrays) -> dict:
    """The serve store's snapshot arrays (taken by the sharded phase) into
    `MemoryStore.from_arrays(...,
    shards=SHARDS, mesh=mesh)`: contexts, token counts and dense ranking
    byte-equal to the unmeshed store at B in SHARDED_B, hybrid and
    dense-only, K1 once a rank an execute; the meshed `sharded_topk`
    against one K1 over the bank; then the meshed service through its
    scheduler and frontend (`dist_scheduled`)."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard
    from repro_torch.core import HashEmbedder, MemoryService, RetrievalPlan
    from repro_torch.core.store import MemoryStore
    from repro_torch.core.vector_index import sharded_topk
    from repro_torch.kernels import topk_mips as tk
    t0 = time.perf_counter()
    store = MemoryStore.from_arrays(arrays, HashEmbedder(device=device),
                                    device=device, shards=SHARDS, mesh=mesh)
    del arrays
    msvc = MemoryService(store=store, budget=svc.budgeter.budget)
    sb = store.sharded
    sb.rebuild(store.vindex)
    bank = sb.bank_device()
    torch.cuda.synchronize()
    layout = {"seconds": time.perf_counter() - t0,
              "placements": [str(p) for p in bank.placements],
              "local_rows": int(bank.to_local().shape[0]),
              "total_slots": sb.n_slots, "stats_meshed": sb.stats()["meshed"]}
    if tuple(bank.placements) != (Shard(0),) * mesh.ndim or \
            not layout["stats_meshed"]:
        fail(f"dist store: the meshed bank is laid out as {layout}")
    rng = np.random.default_rng(23)
    names = sorted(questions)

    def batch(B):
        reqs = [(PLANTED_NS, PLANTED_QUESTION)]
        for ns in rng.choice(names, B - 1, replace=False):
            reqs.append((str(ns), str(rng.choice(questions[ns]))))
        return reqs

    k1 = wrappers()["topk_mips_masked"]
    plans = {"hybrid": RetrievalPlan.hybrid(),
             "dense_only": RetrievalPlan.dense_only()}
    p50 = {}
    for B in SHARDED_B:
        for pname, plan in plans.items():
            times = {"meshed": [], "unmeshed": []}
            for rep in range(reps + 1):
                reqs = batch(B)
                before = k1.launches
                got, dense, ms = answers_with_dense(msvc, reqs, plan)
                if k1.launches - before != mesh.size():
                    fail(f"dist store {pname} B={B}: K1 launched "
                         f"{k1.launches - before} times in one execute on "
                         f"{mesh.size()} rank(s)")
                with uncounted():
                    want, want_dense, ms_u = answers_with_dense(svc, reqs,
                                                                plan)
                _same_payloads(got, want, f"dist store {pname} B={B}")
                if not torch.equal(dense[1], want_dense[1]):
                    fail(f"dist store {pname} B={B}: the dense ranking "
                         "differs from the unmeshed store's")
                if rep:
                    times["meshed"].append(ms)
                    times["unmeshed"].append(ms_u)
            p50[f"{pname}_B{B}"] = {k: float(np.median(v))
                                    for k, v in times.items()}
    qmat, q_ns = rebuild_queries(msvc, reqs)
    labels = sb._dtensor(sb._labels_dev, (sb.n_slots,))
    before = k1.launches
    s_m, i_m = sharded_topk(qmat, bank, 64, q_ns=q_ns, bank_ns=labels,
                            mesh=mesh)
    launched = k1.launches - before
    with uncounted():
        s_one, i_one = tk.topk_mips_masked(qmat, sb._bank_dev, q_ns,
                                           sb._labels_dev, k=64)
        if not torch.equal(i_m, i_one) or launched != mesh.size():
            fail(f"dist store: the meshed sharded_topk ({launched} "
                 "launches) differs from one K1 over the bank")
        live = i_one >= 0
        topk_err = (float((s_m - s_one).abs()[live].max())
                    if live.any() else 0.0)
    scheduled = dist_scheduled(device, svc, msvc, questions, mesh)
    del msvc, store, sb, bank
    gc.collect()
    torch.cuda.empty_cache()
    return {"layout": layout, "p50_ms": p50, "sharded_topk": {
        "Q": int(qmat.shape[0]), "k": 64, "launches": launched,
        "max_abs_err": topk_err}, "scheduled": scheduled}


# K5[lse]: each instance the context-parallel decode gives it, (dtype, B,
# K, G, T, D, cache kind, per-row kv_len): f32 at the agent's decode shape;
# internlm2-1.8b's long_500k ring (8,192 slots, window 8,192, the query at
# position 500,000); int8 codes at phi3.5-moe's shape; a bf16 full cache of
# 524,288 / 16 rows (one rank's shard on a 16-wide `data` axis) at
# internlm2's heads, filled to 13,000.  MLA's 576-wide latent is beyond
# K5 (head dim <= 256, group <= 16): its decode stays torch ops
LSE_CASES = {
    "f32": ("float32", LM_SLOTS, LM_K, LM_G, LM_MAX_LEN, LM_D, "full",
            [DECODE_KV_LEN + 7 * b for b in range(LM_SLOTS)]),
    "bf16_ring": ("bfloat16", 1, 8, 2, 8192, 128, "ring", [500_001]),
    "int8": ("bfloat16", 4, 8, 4, 512, 128, "int8", [200, 1, 77, 512]),
    "bf16_shard": ("bfloat16", 1, 8, 2, 32768, 128, "full", [13_000]),
    # the tensor-core instance at G = 16, 8 and 1 query heads a kv head
    "bf16_g16_ring": ("bfloat16", 2, 1, 16, 2048, 256, "ring", [2100, 2500]),
    "bf16_g8": ("bfloat16", 2, 2, 8, 1024, 64, "full", [1000, 3]),
    "int8_g1": ("bfloat16", 2, 4, 1, 512, 128, "int8", [300, 512]),
}
LSE_TIMED = "bf16_ring"      # the kernels line's shape: the long_500k path's
LSE_SPLITS = (1, 4, 16)
# the log-sum-exp of f32 scores (values ~ log T + a few): the kernel sums
# the exponentials in another order than the plain version's logsumexp
LSE_TOL = 1e-4


def lse_case(gen, device, name: str, reps: int) -> dict:
    """K5 with `return_lse` on one LSE_CASES instance against its plain
    version (output at ATTN_TOL of the plain output's largest |value|: a
    long cache's output averages thousands of rows and is far smaller
    than its largest |v|; lse at LSE_TOL, -inf at the same rows), then the cache cut into R in LSE_SPLITS shards of
    consecutive rows (a full cache's at kv_len - its first row; a ring's
    slot positions as they are), K5[lse] on each and `combine_partials`
    over them against the whole call: no NaN, every shard wholly past
    kv_len at output 0 and lse -inf.  Then ms a call, the plain version's,
    SDPA's with the mask as a boolean input (none for int8 codes) and the
    bound."""
    import torch
    from repro_torch.kernels import decode_attention as da
    dt_name, B, K, G, T, D, kind, lens = LSE_CASES[name]
    dtype = getattr(torch, dt_name)
    q = _rand((B, 1, K * G, D), gen, device, dtype).view(B, K, G, D)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    kw = {}
    if kind == "int8":
        k, kw["k_scale"] = quant_cache(B, K, T, D, gen, device)
        v, kw["v_scale"] = quant_cache(B, K, T, D, gen, device)
    else:
        k = _rand((B, T, K, D), gen, device, dtype).permute(0, 2, 1, 3)
        v = _rand((B, T, K, D), gen, device, dtype).permute(0, 2, 1, 3)
    qp = kv_len[:, None].long() - 1
    if kind == "ring":
        kw["window"] = T
        kw["slot_pos"] = sp = ring_slots([n - 1 for n in lens], T, 0, gen,
                                         device)
        allowed = (sp >= 0) & (sp <= qp) & (sp > qp - T)
    else:
        allowed = torch.arange(T, device=device)[None, :] <= qp
    what = f"K5[lse] {name} B={B} K={K} G={G} T={T} D={D} kv_len={lens}"
    got, lse = da.decode_attention(q, k, v, kv_len, return_lse=True, **kw)
    want, lse_w = da.decode_attention_ref(q, k, v, kv_len, return_lse=True,
                                          **kw)
    tol = ATTN_TOL[dt_name] * float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    fin = torch.isfinite(lse_w)
    if not torch.equal(torch.isfinite(lse), fin) or not err <= tol:
        fail(f"{what}: output error {err} > {tol}, or lse -inf at other "
             "rows than the plain version's")
    lse_err = float((lse - lse_w)[fin].abs().max()) if fin.any() else 0.0
    if not lse_err <= LSE_TOL:
        fail(f"{what}: lse error {lse_err} > {LSE_TOL}")
    splits = {}
    for R in LSE_SPLITS:
        outs, lses, empty = [], [], []
        for r in range(R):
            a, b = T * r // R, T * (r + 1) // R
            cut = {n: (t[:, :, a:b] if t.dim() == 3 else t[:, a:b])
                   for n, t in kw.items() if n != "window"}
            if "window" in kw:
                cut["window"] = kw["window"]
            o, l = da.decode_attention(
                q, k[:, :, a:b], v[:, :, a:b],
                kv_len if kind == "ring" else kv_len - a, return_lse=True,
                **cut)
            outs.append(o)
            lses.append(l)
            if kind != "ring":
                empty.extend((r, i) for i in range(B) if lens[i] <= a)
        co, cl = da.combine_partials(torch.stack(outs), torch.stack(lses))
        c_err = float((co.float() - got.float()).abs().max())
        l_err = float((cl - lse)[fin].abs().max()) if fin.any() else 0.0
        bad = [(r, i) for r, i in empty
               if outs[r][i].any() or not bool((lses[r][i] == float("-inf"))
                                               .all())]
        if torch.isnan(co).any() or torch.isnan(cl).any() or bad \
                or not c_err <= tol or not l_err <= LSE_TOL:
            fail(f"{what}: {R} shards combined: output {c_err} (> {tol}?), "
                 f"lse {l_err} (> {LSE_TOL}?), shards past kv_len not at "
                 f"0 / -inf: {bad}")
        splits[R] = {"max_abs_err": c_err, "lse_max_abs_err": l_err,
                     "shards_past_kv_len": len({r for r, _ in empty})}
    rows = int(allowed.sum())
    esize = 1 if kind == "int8" else q.element_size()
    nbytes = (2 * q.numel() * q.element_size() + 2 * rows * K * D * esize
              + 4 * B * K * G + 4 * B
              + (4 * B * T if kind == "ring" else 0)
              + (2 * 4 * rows * K if kind == "int8" else 0))
    peak = FP32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    bound, by = attention_bound_ms(rows * K * G, nbytes, D, peak)
    mask = allowed[:, None, None, :]
    library = None
    if kind != "int8":
        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q.reshape(B, K * G, 1, D), k, v, attn_mask=mask,
                enable_gqa=True)
    return {"shape": {"B": B, "K": K, "G": G, "T": T, "D": D,
                      "dtype": dt_name, "kind": kind, "kv_len": lens},
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "tolerance": tol, "splits": splits,
            "ms": time_ms(lambda: da.decode_attention(
                q, k, v, kv_len, return_lse=True, **kw), reps),
            "device_ms": kernel_device_ms(lambda: da.decode_attention(
                q, k, v, kv_len, return_lse=True, **kw), reps,
                "decode_attention")[0],
            "library_device_ms": (profiled_ms(library, reps, "")
                                  if library is not None else None),
            "plain_ms": time_ms(lambda: da.decode_attention_ref(
                q, k, v, kv_len, return_lse=True, **kw), max(1, reps // 4)),
            "library_ms": (time_ms(library, reps) if library is not None
                           else None),
            "bound_ms": bound, "bound_by": by}


def dist_lse(device, reps: int) -> dict:
    """K5[lse] on every LSE_CASES instance (`lse_case`), uncounted."""
    import torch
    gen = torch.Generator(device=device).manual_seed(29)
    with uncounted():
        return {name: lse_case(gen, device, name, reps)
                for name in LSE_CASES}


# context-parallel long_500k decode at full width on the dist mesh, its
# caches placed by `long_context_rules` (`context_parallel=True`: on a
# 1-wide `data` axis the rules' sequence shard is the whole cache), filled
# with seeded rows up to LONG_POS - 1 (not prefilled): internlm2-1.8b's 24
# layers on their 8,192-slot ring, deepseek-v3's MLA_LAYERS layers on the
# full 524,288-row latent cache; LONG_STEPS tokens from LONG_POS on
LONG_ARCHS = ("internlm2-1.8b", "deepseek-v3-671b")
LONG_POS, LONG_STEPS = 500_000, 3


def long_caches(model, window, gen, device):
    """Decode caches of long_500k (batch 1) holding seeded rows at every
    position below LONG_POS: a ring's slots the latest position of their
    residue (and its true position), a full cache's rows 0..LONG_POS-1
    (MLA's latent and rope key at unit spread)."""
    import torch
    from repro_torch.models.config import INPUT_SHAPES
    T = INPUT_SHAPES["long_500k"].seq_len
    caches = model.init_caches(1, T, window_override=window, device=device)
    for c in caches:
        if c is None:
            continue
        if "pos" in c:
            c["pos"].copy_(ring_slots([LONG_POS - 1], c["pos"].shape[1], 0,
                                      gen, device))
            rows = slice(None)
        else:
            rows = slice(0, LONG_POS)
        for name, x in c.items():
            if name != "pos":
                x[:, rows] = _rand(x[:, rows].shape, gen, device, x.dtype)
    return caches


def long_decode(device, mesh, arch, cfg, params) -> dict:
    """LONG_STEPS greedy tokens of `build_decode_step(long_500k, mesh,
    context_parallel=True)` against the one-device step on a copy of the
    same caches: the logits within ZOO_REL_TOL of the largest |logit| (a
    bf16 model; K5[lse] and the combine against K5, MLA's local softmax and
    its combine against one softmax), K5[lse] launched once per attention
    layer each step (MLA's decode is torch ops), the combine run once per
    attention layer each step; step ms and the meshed step's own memory:
    what was allocated as it began (the weights and both copies of the
    caches), the peak during it (its peak counter reset just before), and
    the difference, its transient bytes (the uncounted one-device step's
    ms beside it)."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.sharding import build_decode_step
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.models.layers import attention, mla
    dec = build_decode_step(cfg, INPUT_SHAPES["long_500k"], mesh,
                            context_parallel=True)
    window = dec.meta["window_override"]
    gen = torch.Generator(device=device).manual_seed(31)
    caches = long_caches(dec.model, window, gen, device)
    plain = [None if c is None else {k: v.clone() for k, v in c.items()}
             for c in caches]
    dparams = dec.model.shard_params(params, mesh, dec.rules)
    n_attn = sum(1 for kind in cfg.layer_kinds() if kind[0] == "attn")
    combines = {"n": 0}
    real = attention.combine_shards

    def counted(*a):
        combines["n"] += 1
        return real(*a)

    attention.combine_shards = mla.combine_shards = counted
    tok = torch.tensor([[7]], dtype=torch.int32, device=device)
    ms, ms_one, rel, resident, peak = [], [], [], [], []
    try:
        for t in range(LONG_STEPS):
            pos = torch.full((1,), LONG_POS + t, dtype=torch.int32,
                             device=device)
            before = (da.lse_launches.launches, combines["n"])
            torch.cuda.synchronize()
            resident.append(torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits, caches = dec.fn(dparams, tok, caches, pos)
            got = _full(logits).float()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            peak.append(torch.cuda.max_memory_allocated())
            lse_n = da.lse_launches.launches - before[0]
            comb_n = combines["n"] - before[1]
            want_lse = 0 if cfg.use_mla else n_attn
            if lse_n != want_lse or comb_n != n_attn:
                fail(f"long decode {arch} step {t}: K5[lse] launched "
                     f"{lse_n} times (want {want_lse}), the combine ran "
                     f"{comb_n} times over {n_attn} attention layers")
            with uncounted(), torch.no_grad():
                t0 = time.perf_counter()
                want, plain = dec.model.decode_step(
                    params, tok, plain, pos, window_override=window)
                torch.cuda.synchronize()
                ms_one.append((time.perf_counter() - t0) * 1e3)
            want = want.float()
            if not bool(torch.isfinite(got).all()):
                fail(f"long decode {arch} step {t}: logits not finite")
            rel.append(float((got - want).abs().max())
                       / float(want.abs().max()))
            if not rel[-1] <= ZOO_REL_TOL:
                fail(f"long decode {arch} step {t}: logits {rel[-1]} of the "
                     f"scale from the one-device step's > {ZOO_REL_TOL}")
            tok = got[:, -1].argmax(-1).to(torch.int32)[:, None]
    finally:
        attention.combine_shards = mla.combine_shards = real
    cache_bytes = sum(x.numel() * x.element_size() for c in plain if c
                      for x in c.values())
    out = {"arch": arch, "layers": cfg.num_layers, "dtype": str(cfg.cdtype),
           "position": LONG_POS, "steps": LONG_STEPS,
           "window": window, "cache_bytes": cache_bytes,
           "placements": sorted({str(tuple(x.placements)) for c in caches
                                 if c for x in c.values()}),
           "logits_rel_err_vs_one_device": max(rel),
           "step_ms": ms, "one_device_step_ms": ms_one,
           "step_resident_bytes": max(resident),
           "step_peak_bytes": max(peak),
           "step_transient_bytes": max(p - r for p, r in zip(peak, resident)),
           "lse_launches_per_step": 0 if cfg.use_mla else n_attn,
           "combines_per_step": n_attn}
    del caches, plain, dparams, dec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_long(device, mesh, mla_params) -> dict:
    """`long_decode` of LONG_ARCHS: internlm2-1.8b whole, from `unit_scores`
    weights; deepseek-v3 at the dist MLA phase's MLA_LAYERS layers and
    weights (`mla_params`).  K5[lse]'s launches are counted from 0."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.model_api import Model
    reset_counts()
    cfg = get_config(LONG_ARCHS[0])
    params = unit_scores(Model(cfg).init_params(
        torch.Generator(device=device).manual_seed(33)), cfg)
    out = {LONG_ARCHS[0]: long_decode(device, mesh, LONG_ARCHS[0], cfg,
                                      params)}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = mla_params
    out[LONG_ARCHS[1]] = long_decode(device, mesh, LONG_ARCHS[1], cfg,
                                     params)
    out["lse_launches"] = da.lse_launches.launches
    return out


# the meshed store through its scheduler and frontend: DIST_SCHED_CLIENTS
# closed-loop clients of DIST_SCHED_ROUNDS retrieves each (client 0 the
# planted question), then DIST_HTTP_CONVS sessions recorded over HTTP and
# asked back by as many HttpMemory clients
DIST_SCHED_CLIENTS, DIST_SCHED_ROUNDS, DIST_HTTP_CONVS = 8, 8, 8
CITIES = ("Tallinn", "Porto", "Cusco", "Oslo", "Quito", "Hanoi", "Lagos",
          "Lima")


def _payload_json(payload) -> str:
    import json
    from repro_torch.core.api import payload_to_json
    return json.dumps(payload_to_json(payload), sort_keys=True)


def dist_scheduled(device, svc, msvc, questions, mesh) -> dict:
    """The meshed service `msvc` through a MemoryScheduler (its ticks
    broadcast over the mesh's gloo group) against the unmeshed `svc`
    through its own, the same seeded requests from the same clients: every
    answer byte-equal (the payload's JSON), K1 once a rank an execute,
    every tick broadcast; then a MemoryFrontend over `msvc`: sessions
    recorded over HTTP, and each HttpMemory answer byte-equal to the same
    request submitted to the scheduler."""
    import dataclasses as dc
    import json
    import threading
    from repro_torch.core import HttpMemory, Message, RetrieveRequest
    from repro_torch.serving.frontend import MemoryFrontend
    names = sorted(questions)
    k1 = wrappers()["topk_mips_masked"]

    def make(c, rng):
        if c == 0:
            return RetrieveRequest(PLANTED_NS, PLANTED_QUESTION)
        ns = str(names[int(rng.integers(len(names)))])
        return RetrieveRequest(
            ns, str(questions[ns][int(rng.integers(len(questions[ns])))]))

    def answers(run):
        seen = {}
        for c, _, resp, _ in run["records"]:
            seen.setdefault(c, []).append(_payload_json(resp.payload))
        return seen

    with uncounted():
        sched = svc.start_scheduler(tick_interval_s=SCHED_TICK_S,
                                    max_batch=SCHED_MAX_BATCH)
        want = answers(closed_loop(svc, sched, make, DIST_SCHED_CLIENTS,
                                   DIST_SCHED_ROUNDS))
        sched.close()
    sched = msvc.start_scheduler(tick_interval_s=SCHED_TICK_S,
                                 max_batch=SCHED_MAX_BATCH)
    before = k1.launches
    run = closed_loop(msvc, sched, make, DIST_SCHED_CLIENTS,
                      DIST_SCHED_ROUNDS)
    launched = k1.launches - before
    st = sched.stats()
    check_answers(run["records"], "dist scheduler")
    if answers(run) != want:
        fail("dist scheduler: the meshed service's answers differ from the "
             "unmeshed service's")
    if launched != mesh.size() * st["retrieve_launches"] or \
            sched.mesh_ticks.count != st["ticks"] or not st["ticks"]:
        fail(f"dist scheduler: {launched} K1 launches in "
             f"{st['retrieve_launches']} executes on {mesh.size()} rank(s), "
             f"{sched.mesh_ticks.count} ticks broadcast of {st['ticks']}")
    out = {"clients": DIST_SCHED_CLIENTS, "rounds": DIST_SCHED_ROUNDS,
           "requests": len(run["records"]), "ticks": st["ticks"],
           "ticks_broadcast": sched.mesh_ticks.count,
           "executes": st["retrieve_launches"], "k1_launches": launched,
           "requests_per_s": len(run["records"]) / run["wall"],
           "equal_to_unmeshed": True}
    fe = MemoryFrontend(msvc, HTTP_KEYS).start()
    try:
        ts = 1_700_000_000.0
        for i in range(DIST_HTTP_CONVS):
            HttpMemory(fe.address, "k-acme", namespace=f"m{i}") \
                .record_session(f"m{i}", "s0", [Message(
                    "user", f"I live in {CITIES[i]}.", ts + i)])
        got = [None] * DIST_HTTP_CONVS

        def ask(i):
            ctx = HttpMemory(fe.address, "k-acme",
                             namespace=f"m{i}").retrieve(PLANTED_QUESTION)
            got[i] = json.dumps(dc.asdict(ctx), sort_keys=True)

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(DIST_HTTP_CONVS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(DIST_HTTP_CONVS):
            direct = sched.submit(RetrieveRequest(
                f"acme/m{i}", PLANTED_QUESTION)).result(
                    timeout=SCHED_WAIT_S).payload
            if got[i] != json.dumps(dc.asdict(direct), sort_keys=True) \
                    or CITIES[i].lower() not in got[i]:
                fail(f"dist frontend: m{i} answered over HTTP\n{got[i]}\n"
                     "differs from the scheduler's answer or lacks the fact")
        out["http"] = {"sessions": DIST_HTTP_CONVS,
                       "answers_equal_to_scheduler": DIST_HTTP_CONVS,
                       "ticks_broadcast": sched.mesh_ticks.count}
    finally:
        fe.close()
        sched.close()
    return out


def dist_train(device, mesh) -> dict:
    """memori-agent, f32, from the conditioned weights: step 1's loss and
    every leaf's gradient on the mesh against the one-device step, then
    DIST_TRAIN_STEPS steps of `build_train_step(..., mesh)` beside the
    one-device step's ms."""
    import dataclasses
    import numpy as np
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.common.module import leaves_with_names
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batches
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.launch.sharding import build_train_step, place_batch
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.models.model_api import Model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import loss_and_grads
    cfg = get_config("memori-agent")
    model = Model(cfg)
    params = conditioned(model.init_params(
        torch.Generator(device=device).manual_seed(0)), cfg)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"],
                                global_batch=DIST_TRAIN_B,
                                seq_len=DIST_TRAIN_S)
    bm = build_train_step(cfg, shape, mesh)
    b1 = build_train_step(cfg, shape, device=device)
    data = batches(DIST_TRAIN_B, DIST_TRAIN_S,
                   tokenizer=HashTokenizer(cfg.vocab_size), device=device)
    first = next(data)
    dparams = bm.model.shard_params(params, mesh, bm.rules)
    m1, g1 = loss_and_grads(model, params, first)
    with implicit_replication():
        mm, gm = loss_and_grads(bm.model, dparams, place_batch(first, mesh))
    loss_err = abs(float(_full(mm["loss"])) - float(m1["loss"])) / abs(
        float(m1["loss"]))
    if not loss_err <= DIST_LOSS_TOL:
        fail(f"dist train: step-1 loss {float(_full(mm['loss']))} vs "
             f"{float(m1['loss'])} one-device ({loss_err})")
    leaf_err = 0.0
    for (path, a), (_, b) in zip(leaves_with_names(gm),
                                 leaves_with_names(g1)):
        scale = max(float(b.abs().max()), 1e-30)
        err = float((_full(a) - b).abs().max()) / scale
        if not err <= DIST_LEAF_TOL:
            fail(f"dist train: {path} gradient differs by {err} of its "
                 f"largest |g|")
        leaf_err = max(leaf_err, err)
    del gm, g1
    walls = {"meshed": [], "one_device": []}
    losses = []
    for key, bundle, p in (("meshed", bm, dparams), ("one_device", b1,
                                                     params)):
        state = opt.init(bundle.opt, p)
        for _ in range(DIST_TRAIN_STEPS):
            b = next(data)
            torch.cuda.synchronize()
            t = time.perf_counter()
            p, state, m = bundle.fn(p, state, b)
            torch.cuda.synchronize()
            walls[key].append((time.perf_counter() - t) * 1e3)
            if key == "meshed":
                losses.append(float(_full(m["loss"])))
        del p, state
    if not all(np.isfinite(losses)):
        fail(f"dist train: losses {losses}")
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    return {"B": DIST_TRAIN_B, "S": DIST_TRAIN_S,
            "step1_loss_rel_err": loss_err, "max_leaf_rel_err": leaf_err,
            "losses": losses,
            "step_ms_p50": {k: float(np.median(v[1:]))
                            for k, v in walls.items()},
            "step_ms": walls}


def dist_serve(device, mesh) -> dict:
    """memori-agent's greedy tokens through `build_prefill_step` /
    `build_decode_step` on the mesh against the Engine's for the same
    prompts (cut to DIST_PROMPT tokens each)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.launch.sharding import (build_decode_step,
                                             build_prefill_step)
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.models.model_api import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.requests import Request
    cfg = get_config("memori-agent")
    model = Model(cfg)
    params = conditioned(model.init_params(
        torch.Generator(device=device).manual_seed(0)), cfg)
    tok = HashTokenizer(cfg.vocab_size)
    prompts = [tok.encode(p)[:DIST_PROMPT]
               for p in lm_prompts(tok, DIST_SERVE_B)]
    engine = Engine(model, params, max_len=DIST_MAX_LEN,
                    slots=DIST_SERVE_B, tokenizer=tok)
    margins = {}
    with uncounted():
        want, _, _, _ = greedy_run(
            engine, [Request(list(p), DIST_NEW) for p in prompts], margins)
    del engine
    pre = build_prefill_step(cfg, dataclasses.replace(
        INPUT_SHAPES["prefill_32k"], global_batch=DIST_SERVE_B,
        seq_len=DIST_PROMPT), mesh)
    dec = build_decode_step(cfg, dataclasses.replace(
        INPUT_SHAPES["decode_32k"], global_batch=DIST_SERVE_B,
        seq_len=DIST_MAX_LEN), mesh)
    dparams = pre.model.shard_params(params, mesh, pre.rules)
    toks = torch.tensor(prompts, dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = pre.fn(dparams, {"tokens": toks})
    caches = dec.model.prepare_decode_caches(caches, DIST_PROMPT,
                                             DIST_MAX_LEN)
    nxt = _full(logits)[:, -1].argmax(-1).to(torch.int32)
    out = [nxt]
    for t in range(DIST_NEW - 1):
        pos = torch.full((DIST_SERVE_B,), DIST_PROMPT + t, dtype=torch.int32,
                         device=device)
        logits, caches = dec.fn(dparams, nxt[:, None], caches, pos)
        nxt = _full(logits)[:, -1].argmax(-1).to(torch.int32)
        out.append(nxt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = torch.stack(out, 1).tolist()
    diverged = 0
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.tokens[:DIST_NEW]
        if g != w:
            j = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
            if not margins.get((i, j), 0.0) < DIST_MARGIN_TOL:
                fail(f"dist serve: request {i} token {j}: {g[j]} on the "
                     f"mesh, {w[j]} from the Engine (margin "
                     f"{margins.get((i, j))})")
            diverged += 1
    del params, dparams, caches
    gc.collect()
    torch.cuda.empty_cache()
    return {"requests": DIST_SERVE_B, "prompt": DIST_PROMPT,
            "new_tokens": DIST_NEW, "equal_to_engine": DIST_SERVE_B - diverged,
            "diverged_at_near_tie": diverged, "wall_s": wall}


def absorbed_times(device, reps: int) -> dict:
    """The D = 576 instance at deepseek's absorbed shape (G = 128 heads over
    one latent kv head, S = T = ABSORBED_TIME_S, bf16, causal): ms a call,
    its plain version's, `scaled_dot_product_attention`'s on the same
    inputs (one library call; its fused backends stop at D = 256) and the
    bound (bf16 operations at the tensor-core rate)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(5)
    S, G, D = ABSORBED_TIME_S, 128, 576
    q = _rand((1, 1, G, S, D), gen, device, torch.bfloat16)
    k = _rand((1, 1, S, D), gen, device, torch.bfloat16)
    v = _rand((1, 1, S, D), gen, device, torch.bfloat16)
    with uncounted():
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), reps)
        dev, names, _ = kernel_device_ms(
            lambda: fa.flash_attention(q, k, v, causal=True), reps,
            "flash_fwd")
        plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v,
                                                          causal=True), reps)
        lib_ms = time_ms(lambda: sdpa_gqa(q, k, v, is_causal=True), reps)
        lib_dev = profiled_ms(lambda: sdpa_gqa(q, k, v, is_causal=True),
                              reps, "")
        err = float((fa.flash_attention(q, k, v, causal=True).float()
                     - fa.flash_attention_ref(q, k, v, causal=True).float()
                     ).abs().max())
    tol = ATTN_TOL["bfloat16"] * max(1.0, float(v.abs().max()))
    if not err <= tol:
        fail(f"dist mla: the D = 576 instance at the timed shape (G {G}, "
             f"S = T {S}) is {err} from its plain version > {tol}")
    bound, by = attention_bound_ms(
        G * flash_pairs(S, S, True, 0),
        (q.numel() + 2 * k.numel() + q.numel()) * 2, D, BF16_FLOPS_PER_S)
    return {"shape": {"B": 1, "K": 1, "G": G, "S": S, "T": S, "D": D,
                      "dtype": "bfloat16", "causal": True},
            "ms": ms, "device_ms": dev, "kernels": names,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev,
            "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "tolerance": tol}


def dist_mla(device, reps: int) -> dict:
    """deepseek-v3 at full width in bf16 with `mla_absorbed_train`: a
    prefill at MLA_LAYERS layers, every K6 call (the D = 576 instance)
    against its plain version and the logits against the decompressed
    path's; with the same weights, context-parallel long_500k decode of
    internlm2-1.8b and deepseek-v3 (`dist_long`); one train step at
    MLA_TRAIN_LAYERS layers through FlashAttentionFn at D = 576 (finite
    loss and gradient norm)."""
    import dataclasses
    import math
    import torch
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model_api import Model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    out = {}
    cfg = dataclasses.replace(zoo_config("deepseek-v3-671b"),
                              num_layers=MLA_LAYERS, mla_absorbed_train=True)
    model = Model(cfg)
    params = unit_scores(model.init_params(
        torch.Generator(device=device).manual_seed(21)), cfg)
    tok = HashTokenizer(cfg.vocab_size)
    toks = torch.tensor([tok.encode(p)[:MLA_S]
                         for p in lm_prompts(tok, MLA_B)],
                        dtype=torch.int32, device=device)
    errs = []
    before = fa.absorbed_launches.launches
    with torch.no_grad(), checked_attention(errs):
        logits, _ = model.prefill(params, {"tokens": toks})
    launched = fa.absorbed_launches.launches - before
    with torch.no_grad(), uncounted():
        plain, _ = Model(dataclasses.replace(
            cfg, mla_absorbed_train=False)).prefill(params,
                                                    {"tokens": toks})
    scale = float(plain.float().abs().max())
    rel = float((logits.float() - plain.float()).abs().max()) / scale
    if launched != MLA_LAYERS:
        fail(f"dist mla: the D = 576 instance launched {launched} times in "
             f"a {MLA_LAYERS}-layer prefill")
    bad = [e for e in errs if not e[1] <= e[2]]
    if bad or not errs:
        fail(f"dist mla: K6 calls against their plain version: {bad or errs}")
    if not rel <= ZOO_REL_TOL:
        fail(f"dist mla: absorbed logits {rel} of the scale from the "
             f"decompressed path's > {ZOO_REL_TOL}")
    out["prefill"] = {"layers": MLA_LAYERS, "B": MLA_B, "S": MLA_S,
                      "k6_calls_checked": len(errs),
                      "k6_max_abs_err": max(e[1] for e in errs),
                      "d576_launches": launched,
                      "logits_rel_err_vs_decompressed": rel}
    del model, plain, logits
    gc.collect()
    out["long"] = dist_long(device, dist_mesh(), (cfg, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(cfg, num_layers=MLA_TRAIN_LAYERS)
    tmodel = Model(tcfg)
    params = unit_scores(tmodel.init_params(
        torch.Generator(device=device).manual_seed(21)), tcfg)
    ocfg = opt.OptimizerConfig(state_dtype="bfloat16")
    step = make_train_step(tmodel, TrainConfig(opt=ocfg))
    state = opt.init(ocfg, params)
    before = fa.absorbed_launches.launches
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    params, state, m = step(params, state, {"tokens": toks})
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    launched_t = fa.absorbed_launches.launches - before
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(gnorm)) or launched_t < 1:
        fail(f"dist mla train: loss {loss}, grad norm {gnorm}, "
             f"{launched_t} D = 576 launches")
    out["train"] = {"layers": MLA_TRAIN_LAYERS, "mtp_block": True,
                    "B": MLA_B, "S": MLA_S, "loss": loss, "grad_norm": gnorm,
                    "d576_launches": launched_t, "step_ms": step_ms,
                    "peak_bytes": torch.cuda.max_memory_allocated()}
    del params, state, step, tmodel
    gc.collect()
    torch.cuda.empty_cache()
    out["times"] = absorbed_times(device, reps)
    out["launches"] = launched + launched_t
    return out


def phase_dist(device, svc, questions, reps: int, sharded) -> dict:
    """Phase 16, part 1: the meshed store, the meshed train step and the
    meshed prefill/decode on the DIST_MESH mesh (the launch counters reset
    before each part's path)."""
    import torch
    t0 = time.perf_counter()
    mesh = dist_mesh()
    out = {"backend": DIST_BACKEND, "mesh": list(DIST_MESH),
           "ranks": mesh.size()}
    reset_counts()
    out["store"] = dist_store(device, svc, questions, reps, mesh,
                              sharded.pop("snapshot_arrays"))
    out["store"]["sharded_phase_p50_ms"] = sharded["p50_ms"]
    out["launches"] = counts()
    emit({"phase": "dist", "part": "store", **out["store"],
          "gpu": gpu_line()})
    out["train"] = dist_train(device, mesh)
    emit({"phase": "dist", "part": "train", **out["train"],
          "gpu": gpu_line()})
    out["serve"] = dist_serve(device, mesh)
    emit({"phase": "dist", "part": "serve", **out["serve"],
          "gpu": gpu_line()})
    out["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


def phase_dist_mla(device, reps: int) -> dict:
    """Phase 16, part 2 (after the zoo, when the card is free): deepseek's
    absorbed MLA through the D = 576 instance, context-parallel long_500k
    decode of internlm2-1.8b and deepseek-v3 (`dist_long`), and K5[lse]
    against its plain version (`dist_lse`)."""
    t0 = time.perf_counter()
    out = dist_mla(device, reps)
    out["lse"] = dist_lse(device, reps)
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "dist", "part": "mla", **out, "gpu": gpu_line()})
    return out


def attention_times(device, reps: int, build_log, tc) -> dict:
    """The `--attention-times` mode: every K5/K6 instance the served paths
    run, timed (`variant_entry`): the zoo's and the train step's bf16
    instances (`zoo_variant_times`), the D = 576 instance
    (`absorbed_times`), K5[lse] at its four instances (`lse_case`), the
    agent's f32 K6 prefill and K5 step (with a CUDA graph's ms a call),
    and ptxas's registers of every instance.  `tc` as for `variant_entry`
    (None for an older tree)."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(31)
    f32 = torch.float32
    out = {"phase": "attention_times", "gpu": gpu_line()}
    with uncounted():
        out["variants"] = zoo_variant_times(device, reps, tc)
        out["d576"] = absorbed_times(device, reps)
        out["lse"] = {n: lse_case(gen, device, n, reps) for n in LSE_CASES}
        S = PREFILL_S
        q = _rand((1, LM_K, LM_G, S, LM_D), gen, device, f32)
        k = _rand((1, LM_K, S, LM_D), gen, device, f32)
        v = _rand((1, LM_K, S, LM_D), gen, device, f32)
        out["f32_prefill"] = variant_entry(
            lambda: fa.flash_attention(q, k, v),
            lambda: fa.flash_attention_ref(q, k, v),
            lambda: sdpa_gqa(q, k, v, is_causal=True),
            LM_K * LM_G * flash_pairs(S, S, True, 0),
            4 * (2 * q.numel() + k.numel() + v.numel()), LM_D,
            {"B": 1, "K": LM_K, "G": LM_G, "S": S, "T": S, "D": LM_D},
            reps, "flash_fwd", False if tc else None, FP32_FLOPS_PER_S)
        q = _rand((LM_SLOTS, LM_K, LM_G, LM_D), gen, device, f32)
        k = _rand((LM_SLOTS, LM_MAX_LEN, LM_K, LM_D), gen, device,
                  f32).permute(0, 2, 1, 3)
        v = _rand((LM_SLOTS, LM_MAX_LEN, LM_K, LM_D), gen, device,
                  f32).permute(0, 2, 1, 3)
        kv_len = torch.full((LM_SLOTS,), DECODE_KV_LEN, dtype=torch.int32,
                            device=device)
        rows = LM_SLOTS * DECODE_KV_LEN
        run = functools.partial(da.decode_attention, q, k, v, kv_len)
        e = out["f32_decode"] = variant_entry(
            run, functools.partial(da.decode_attention_ref, q, k, v, kv_len),
            None, rows * LM_K * LM_G,
            4 * (2 * q.numel() + 2 * rows * LM_K * LM_D + LM_SLOTS), LM_D,
            {"B": LM_SLOTS, "K": LM_K, "G": LM_G, "T": LM_MAX_LEN,
             "D": LM_D, "kv_len": DECODE_KV_LEN},
            reps, "decode_attention", False if tc else None,
            FP32_FLOPS_PER_S)
        e["graph_ms"] = graph_ms(run, GRAPH_CALLS, reps)
    out["ptxas"] = {name: build_log["kernels"][name]["ptxas"]
                    for name in ATTN_KERNELS}
    return out


# the scan kernel's narrower query tiles (32, 16 and 8 queries) in
# `--topk-times`, beside each kernel's main-path k (64)
TOPK_TIMES_KS = (512, 1024, 2048)


def topk_times(device, reps: int) -> dict:
    """The `--topk-times` mode: after the build (its ptxas report of
    `topk_mips.cu`'s kernels kept), K1-K4 at the main shape
    (`main_inputs`, each kernel's k on the main path): CUDA-event ms a call
    over `reps` calls and the device ms a call of their kernels
    (profiler, reps // 2 calls); the device ms at each k of TOPK_TIMES_KS
    (`by_k`); and the large-k path (`large_k`): at the main shape of
    `large_k_cases` at each k of LARGE_KS and at the served int8
    over-fetch shape (`served`, the masked pair at SERVED_K), each call's
    event ms, device ms, its passes' device ms (`large_split_ms`) and the
    library call's event ms (`q @ bankᵀ` + mask + `torch.topk(k)`)."""
    import torch
    from repro_torch.kernels import topk_mips as tk
    build = phase_build()
    gen = torch.Generator(device=device).manual_seed(0)
    bank, codes, scales, lab, q, q_ns = main_inputs(gen, device)
    out = {"phase": "topk_times", "gpu": gpu_line(),
           "ptxas": build["kernels"]["topk_mips"]["ptxas"]}
    for name, (_, masked, quant, k) in KERNELS.items():
        fn, args = getattr(tk, name), (q, bank, codes, scales, q_ns, lab,
                                       masked, quant)

        def call():
            return _call(fn, *args, k=k)

        out[name] = {"k": k, "event_ms": time_ms(call, reps),
                     "device_ms": device_profile(call, max(1, reps // 2),
                                                 "topk_")[0], "by_k": {}}
        for kk in TOPK_TIMES_KS:
            out[name]["by_k"][kk] = device_profile(
                lambda: _call(fn, *args, k=kk), max(1, reps // 2),
                "topk_")[0]
    del bank, codes, scales, lab, q, q_ns
    n_valid = MAIN_N - 1000
    bank, codes, scales, lab, q, q_ns, _ = large_k_inputs(gen, device,
                                                          MAIN_N, 64, 0.25)
    lab[n_valid:] = -2
    shapes = [("main", (q, bank, codes, scales, q_ns, lab), n_valid,
               LARGE_KS, tuple(KERNELS))]
    served = served_inputs(gen, device)
    shapes.append(("served", (served[4], *served[:3], served[5], served[3]),
                   MAIN_N, (SERVED_K,), ("topk_mips_masked",
                                         "topk_mips_quant_masked")))
    large = {}
    for shape, inputs, nv, ks, names in shapes:
        for name in names:
            _, masked, quant, _ = KERNELS[name]
            fn, args = getattr(tk, name), (*inputs, masked, quant)
            for kk in ks:
                def call():
                    return _call(fn, *args, k=kk, n_valid=nv)

                def library():
                    s, ok = plain_scores(*args, nv)
                    return torch.topk(torch.where(ok, s, NEG_INF), kk, dim=1)

                large[f"{shape} {name} k={kk}"] = {
                    "event_ms": time_ms(call, reps),
                    "device_ms": all_device_ms(call, max(1, reps // 2)),
                    "passes": large_split_ms(call, max(1, reps // 2)),
                    "library_ms": time_ms(library, 2)}
    out["large_k"] = large
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
    ap.add_argument("--attention-times", action="store_true",
                    help="only build the kernels and time every K5/K6 "
                         "instance (`attention_times`; no other phase)")
    ap.add_argument("--topk-times", action="store_true",
                    help="only build the kernels and time K1-K4's scan "
                         "kernel and large-k path (`topk_times`; no other "
                         "phase)")
    ap.add_argument("--train-times", type=int, default=0, metavar="STEPS",
                    help="only build the kernels and time internlm2-1.8b's "
                         "train step over STEPS steps (`train_big`; no "
                         "other phase)")
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
    if args.topk_times:
        emit({**topk_times(device, args.reps), "src": args.src})
        return 0
    if args.train_times:
        phase_build()
        emit({"phase": "train_times", "src": args.src, "gpu": gpu_line(),
              **train_big(device, {name: 0 for name in wrappers()},
                          args.train_times)})
        return 0
    if args.attention_times:
        own = os.path.samefile(args.src, SRC)
        emit({**attention_times(device, args.reps, phase_build(),
                                True if own else None), "src": args.src})
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
    kern_phase = phase_kernels(device, args.reps, build)
    kern = kern_phase["kernels"]
    attn = phase_attention(device, args.reps, build)["kernels"]
    ops = phase_ops(device)
    templates = make_templates(device)
    reps = max(3, args.reps // 4)
    serve, svc, questions = phase_serve(device, args.rows, reps, templates,
                                        keep=True)
    sched = phase_scheduler(device, svc, questions,
                            os.path.abspath(args.src))
    sharded = phase_sharded(device, svc, questions, reps)
    gc.collect()
    torch.cuda.empty_cache()
    dist_part = phase_dist(device, svc, questions, reps, sharded)
    gc.collect()
    torch.cuda.empty_cache()
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
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    examples = phase_examples(device)
    gc.collect()
    torch.cuda.empty_cache()
    zoo = phase_zoo(device, args.reps)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(device, durable["train_launcher"])
    gc.collect()
    torch.cuda.empty_cache()
    dist_mla_part = phase_dist_mla(device, args.reps)
    close_dist()
    path_launches = {"topk_mips_masked": serve["launches"],
                     "topk_mips_quant_masked": serve8["launches"],
                     "topk_mips": ops["launches"],
                     "topk_mips_quant": ops["launches"]}
    lse = dist_mla_part["lse"]
    path_err = {"topk_mips_masked": max(
                    serve["dense_vs_plain"]["max_abs_err"],
                    sharded["parity"]["dense_vs_plain_max_abs_err"]),
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
        if name in ("topk_mips_masked", "topk_mips"):  # sharded store,
            launches += sharded["launches"][name]      # sharded_topk
        if name == "topk_mips_masked":     # the meshed store, the examples
            launches += (dist_part["launches"][name]
                         + examples["quickstart"]["launches"][name]
                         + examples["agent_serve"]["launches"][name])
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
    # the large-k path: launched on the examples phase's searches, timed at
    # K1's main shape (Q 64, N 2**20, D 256) at k = 16384
    large = kern_phase["large_k"]
    t = large["topk_mips_masked"]["sizes"][str(LARGE_KS[2])]
    launches = examples["large_k"]["launches"]["topk_mips[large_k]"]
    if launches < 1:
        fail("topk_mips[large_k] was not launched on its path")
    summary.append({
        "name": "topk_mips[large_k]", "route": "cuda",
        "source": "src/repro_torch/csrc/topk_mips.cu",
        "replaces": KERNELS["topk_mips_masked"][0], "launches": launches,
        "max_abs_err": max(max(large[n]["max_abs_err"] for n in KERNELS),
                           *examples["large_k"]["max_abs_err"].values()),
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "workspace_ms": t["workspace_ms"]})
    for name, (replaces, source) in ATTN_KERNELS.items():
        r = attn[name]
        if agent["launches"][name] < 1:
            fail(f"{name} was not launched on the agent loop")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (lm["launches"][name] + train["launches"][name]
                         + examples["agent_serve"]["launches"][name]),
            "max_abs_err": r["max_abs_err"]["float32"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    for name, (replaces, source) in ATTN_VARIANTS.items():
        r, t = attn[name], zoo["variant_times"][name]
        if zoo["launches"][name] < 1:
            fail(f"{name} was not launched on the zoo's served path")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": zoo["launches"][name],
            "max_abs_err": max(r["max_abs_err"].values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    # the bf16 instances on the tensor cores, timed at MLA's decompressed
    # prefill (K6) and whisper's cross decode (K5)
    for name, shape in (("flash_attention[tc]", "flash_attention mla_prefill"),
                        ("decode_attention[tc]", "decode_attention cross")):
        base, t = name.split("[")[0], zoo["variant_times"][shape]
        launches = zoo["launches"][name] + train["launches"][name]
        if launches < 1:
            fail(f"{name} was not launched on the zoo's and train's paths")
        summary.append({
            "name": name, "route": "cuda", "source": ATTN_KERNELS[base][1],
            "replaces": ATTN_KERNELS[base][0], "launches": launches,
            "max_abs_err": attn[base]["max_abs_err"]["bfloat16"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    t = dist_mla_part["times"]
    summary.append({
        "name": ABSORBED, "route": "cuda",
        "source": ATTN_KERNELS["flash_attention"][1],
        "replaces": ATTN_KERNELS["flash_attention"][0],
        "launches": dist_mla_part["launches"],
        "max_abs_err": max(*attn[ABSORBED]["max_abs_err"].values(),
                           t["max_abs_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    t = lse[LSE_TIMED]
    if dist_mla_part["long"]["lse_launches"] < 1:
        fail("decode_attention[lse] was not launched on the long_500k path")
    summary.append({
        "name": "decode_attention[lse]", "route": "cuda",
        "source": ATTN_KERNELS["decode_attention"][1],
        "replaces": ATTN_KERNELS["decode_attention"][0],
        "launches": dist_mla_part["long"]["lse_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in lse.values()),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    emit({"seconds": time.perf_counter() - t_start})
    emit({"kernels": summary})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
