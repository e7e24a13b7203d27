"""LM training data pipeline: synthetic conversational text -> token
batches, as the reference's `repro/data/pipeline.py`.

Source text is the benchmark's generator family (multi-session dialogues,
the port's own `locomo_synth`), which gives the 100M-model example a
learnable distribution.  `batches` is an infinite, deterministic iterator
of {tokens, loss_mask} dicts of shape (batch, seq_len) — or (M, batch,
seq_len) with M stacked micro-batches for gradient accumulation — on an
explicit device, token for token the reference's numpy arrays.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.common.utils import resolve_device, to_device
from repro_torch.data.locomo_synth import generate_conversation
from repro_torch.data.tokenizer import (BOS_ID, EOS_ID, HashTokenizer,
                                        default_tokenizer)


def token_stream(tokenizer: HashTokenizer, seed: int = 0) -> Iterator[int]:
    """BOS, `speaker: text` tokens, EOS for every message of conversations
    seed * 1000, seed * 1000 + 1, ... (4 sessions, 40 noise turns)."""
    for conv_seed in itertools.count(seed * 1000):
        conv = generate_conversation(seed=conv_seed, n_sessions=4,
                                     noise_turns=40)
        for _, msgs in conv.sessions:
            for m in msgs:
                yield BOS_ID
                yield from tokenizer.encode(f"{m.speaker}: {m.text}")
                yield EOS_ID


def batches(batch_size: int, seq_len: int, *, tokenizer=None, seed: int = 0,
            microbatches: int = 0, vocab_size: int = 0,
            device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite iterator of {tokens (B, S) int32, loss_mask (B, S) f32} on
    `device` ("cuda", the default, or "cpu").  With microbatches > 0 the
    shapes are (M, B, S).  Pass vocab_size to build a tokenizer matched to
    the model's vocab."""
    device = resolve_device(device)
    tok = tokenizer or (HashTokenizer(vocab_size) if vocab_size
                        else default_tokenizer())
    stream = token_stream(tok, seed)
    eff = batch_size * max(1, microbatches)
    while True:
        buf = np.fromiter(itertools.islice(stream, eff * seq_len),
                          np.int32, count=eff * seq_len)
        tokens = buf.reshape(eff, seq_len)
        mask = (tokens != 0).astype(np.float32)
        if microbatches:
            tokens = tokens.reshape(microbatches, batch_size, seq_len)
            mask = mask.reshape(microbatches, batch_size, seq_len)
        yield {"tokens": to_device(tokens, device),
               "loss_mask": to_device(mask, device)}
