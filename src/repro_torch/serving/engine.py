"""Serving engine: slot-based continuous batching over prefill/decode.

A fixed number of batch slots share one decode computation; each slot has
its own cache region and position (vector cache_pos).  Admission prefills
a single request (B=1; attention through K6 on the card), pads its cache
to `max_len` and copies it into the slot's row of the batched caches in
place; each `step` runs one batched decode (attention through K5 in every
layer) and samples the next token of every slot.  The dataflow of the
reference's `repro/serving/engine.py`, with the PRNG key replaced by an
explicit `torch.Generator` and the caches updated in place.

The reference jits its decode step; on a CUDA device the engine captures
`model.decode_step` for its (slots, max_len) as one CUDA graph instead.
The step's inputs live in static device buffers (`tokens (slots, 1)` and
`pos (slots,)`, one int32 (slots, 2) tensor); every `step` copies the
slots' tokens and positions into them and runs the decode, eagerly the
first time (the warm-up, which also builds the kernels' launch plans) and
as a replay of the graph captured right after it from then on.  The graph
writes the caches in place and leaves the logits in its static output;
sampling stays outside it (the module-level `sample`).  A capture that
fails raises: on CUDA the graph is the path, with no eager fallback.  A
CPU engine (which a caller asks for explicitly) runs every step eagerly
through the same static buffers and builds no graph.  Prefill stays eager:
every prompt length differs.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.data.tokenizer import EOS_ID, HashTokenizer, default_tokenizer
from repro_torch.kernels import captured_launches, count_launch
from repro_torch.models.model_api import Model
from repro_torch.serving.requests import Request, Response
from repro_torch.serving.sampler import SamplerConfig, sample


class CountedGraph:
    """`fn` captured as a CUDA graph whose replays count kernel launches as
    eager calls would.  Capturing runs fn's Python once, so each wrapper it
    calls counts a launch that did not run: the capture collects this
    thread's counts apart (`kernels.captured_launches`), and every
    `replay` adds them.  `graph` and `capture` default to
    `torch.cuda.CUDAGraph()` and `torch.cuda.graph` in thread-local capture
    mode: only this thread's unsafe calls break the capture, so the memory
    layer's scheduler tick, lifecycle daemon and frontend handlers go on
    working on the device (on their own streams) while it runs, with no
    lock, and their launches meanwhile count as theirs."""

    def __init__(self, fn: Callable, *, graph=None, capture=None):
        self.graph = graph if graph is not None else torch.cuda.CUDAGraph()
        capture = capture if capture is not None else functools.partial(
            torch.cuda.graph, capture_error_mode="thread_local")
        with captured_launches() as tally, capture(self.graph):
            self.output = fn()
        self.deltas = dict(tally)

    def replay(self):
        """Run the captured work once; returns the static output."""
        self.graph.replay()
        for f, d in self.deltas.items():
            count_launch(f, d)
        return self.output


class Engine:
    def __init__(self, model: Model, params, *, max_len: int = 512,
                 slots: int = 4, sampler: SamplerConfig = SamplerConfig(),
                 tokenizer: Optional[HashTokenizer] = None, seed: int = 0):
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.max_len = max_len
        self.slots = slots
        self.sampler = sampler
        self.tokenizer = tokenizer or default_tokenizer()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.caches = model.init_caches(slots, max_len, device=self.device)
        self.slot_pos = np.zeros((slots,), np.int32)
        self.slot_active = np.zeros((slots,), bool)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_out: List[List[int]] = [[] for _ in range(slots)]
        self.slot_tokens = np.zeros((slots,), np.int32)
        self.stats = {"decode_steps": 0, "tokens_out": 0, "admitted": 0}
        # the decode step's static inputs: column 0 the tokens, 1 the positions
        cuda = self.device.type == "cuda"
        self._inputs = torch.zeros((slots, 2), dtype=torch.int32,
                                   device=self.device)
        self._host_inputs = torch.zeros((slots, 2), dtype=torch.int32,
                                        pin_memory=cuda)
        self.graph: Optional[CountedGraph] = None

    # -- admission -----------------------------------------------------------
    def _insert_cache(self, slot: int, single_caches) -> None:
        for full, single in zip(self.caches, single_caches):
            for name, x in single.items():
                full[name][slot].copy_(x[0])

    def admit(self, req: Request) -> int:
        free = np.where(~self.slot_active)[0]
        assert free.size, "no free slot"
        slot = int(free[0])
        toks = req.prompt_tokens[: self.max_len - req.max_new_tokens - 1]
        batch = {"tokens": torch.tensor([toks], dtype=torch.int32,
                                        device=self.device)}
        logits, pre_caches = self.model.prefill(self.params, batch)
        self._insert_cache(slot, self.model.prepare_decode_caches(
            pre_caches, len(toks), self.max_len))
        first = int(sample(logits, self.generator, self.sampler)[0])
        self.slot_pos[slot] = len(toks)
        self.slot_active[slot] = True
        self.slot_req[slot] = req
        self.slot_out[slot] = [first]
        self.slot_tokens[slot] = first
        self.stats["admitted"] += 1
        return slot

    @property
    def has_free_slot(self) -> bool:
        return bool((~self.slot_active).any())

    # -- decode ----------------------------------------------------------------
    def step(self) -> List[Response]:
        """One batched decode step across all slots; returns finished
        responses."""
        if not self.slot_active.any():
            return []
        host = self._host_inputs.numpy()
        host[:, 0] = self.slot_tokens
        host[:, 1] = self.slot_pos
        # the pinned buffer is rewritten only after this step's sample has
        # come back to the host, so the copy may run ahead of the host
        self._inputs.copy_(self._host_inputs,
                           non_blocking=self.device.type == "cuda")
        if self.graph is not None:
            logits = self.graph.replay()
        elif self.device.type == "cuda":
            logits = self._warm_up_and_capture()
        else:
            logits = self.decode()
        nxt = sample(logits, self.generator, self.sampler).cpu().numpy()
        self.stats["decode_steps"] += 1

        done: List[Response] = []
        for s in range(self.slots):
            if not self.slot_active[s]:
                continue
            self.slot_pos[s] += 1
            tok = int(nxt[s])
            self.slot_out[s].append(tok)
            self.slot_tokens[s] = tok
            self.stats["tokens_out"] += 1
            req = self.slot_req[s]
            eos = req.eos_id if req.eos_id is not None else EOS_ID
            if (len(self.slot_out[s]) >= req.max_new_tokens
                    or tok == eos
                    or self.slot_pos[s] >= self.max_len - 1):
                done.append(Response(req.request_id, list(self.slot_out[s]),
                                     prompt_len=len(req.prompt_tokens)))
                self.slot_active[s] = False
                self.slot_req[s] = None
                self.slot_out[s] = []
        return done

    def decode(self):
        """One eager decode step on the static inputs (caches written in
        place) -> logits (slots, 1, V)."""
        logits, _ = self.model.decode_step(self.params, self._inputs[:, :1],
                                           self.caches, self._inputs[:, 1])
        return logits

    def _warm_up_and_capture(self):
        """The first step on CUDA: the decode runs eagerly on a side stream
        (lazy initialisation, the kernels' launch plans and workspaces stay
        out of the capture), then the same step is captured; returns the
        eager step's logits."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits = self.decode()
        main.wait_stream(side)
        self.graph = CountedGraph(self.decode)
        return logits

    # -- convenience -------------------------------------------------------------
    def generate(self, prompts: List[str], max_new_tokens: int = 32) -> List[str]:
        from repro_torch.serving.scheduler import ContinuousBatcher
        reqs = [Request(self.tokenizer.encode(p), max_new_tokens)
                for p in prompts]
        out = ContinuousBatcher(self).run(reqs)
        return [self.tokenizer.decode(out[r.request_id].tokens) for r in reqs]
