"""Serving engine: slot-based continuous batching over prefill/decode.

A fixed number of batch slots share one decode computation; each slot has
its own cache region and position (vector cache_pos).  Admission prefills
a single request (B=1; attention through K6 on the card), pads its cache
to `max_len` and copies it into the slot's row of the batched caches in
place; each `step` runs one batched decode (attention through K5 in every
layer) and samples the next token of every slot.  The dataflow of the
reference's `repro/serving/engine.py`, with the PRNG key replaced by an
explicit `torch.Generator` and the caches updated in place.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.data.tokenizer import EOS_ID, HashTokenizer, default_tokenizer
from repro_torch.models.model_api import Model
from repro_torch.serving.requests import Request, Response
from repro_torch.serving.sampler import SamplerConfig, sample


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
        tokens = torch.from_numpy(self.slot_tokens[:, None].copy()).to(
            self.device)
        pos = torch.from_numpy(self.slot_pos.copy()).to(self.device)
        logits, self.caches = self.model.decode_step(self.params, tokens,
                                                     self.caches, pos)
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

    # -- convenience -------------------------------------------------------------
    def generate(self, prompts: List[str], max_new_tokens: int = 32) -> List[str]:
        from repro_torch.serving.scheduler import ContinuousBatcher
        reqs = [Request(self.tokenizer.encode(p), max_new_tokens)
                for p in prompts]
        out = ContinuousBatcher(self).run(reqs)
        return [self.tokenizer.decode(out[r.request_id].tokens) for r in reqs]
