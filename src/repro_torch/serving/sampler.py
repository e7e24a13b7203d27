"""Token samplers: greedy / temperature / top-k.

The reference draws with `jax.random.categorical` from a PRNG key; here
`torch.multinomial` draws from an explicit `torch.Generator` (other bits,
same distribution).  Greedy takes the first maximal index, as `jnp.argmax`
does."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => no truncation


def sample(logits, generator, cfg: SamplerConfig):
    """logits: (B, 1, V) or (B, V) -> (B,) int32.  `generator` (on the
    logits' device) is used only when temperature > 0."""
    if logits.dim() == 3:
        logits = logits[:, -1]
    if cfg.temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    logits = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
