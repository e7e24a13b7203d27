"""Rotary position embeddings (GPT-NeoX half-split layout), with partial
rotary support (stablelm rotates only the first 25% of head_dim) — the
reference's `repro/models/layers/rope.py` in torch."""
from __future__ import annotations

import torch


def _freqs(rot_dim: int, theta: float, device):
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, *, theta: float = 10000.0, pct: float = 1.0):
    """x: (..., S, H, Dh) or (..., S, Dh);  positions: broadcastable to (..., S)."""
    head_dim = x.shape[-1]
    rot = int(head_dim * pct)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    inv = _freqs(rot, theta, x.device)                      # (rot/2,)
    ang = positions.float()[..., None] * inv                # (..., S, rot/2)
    # broadcast over the heads dim if present
    for _ in range(x.dim() - ang.dim()):
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                        dim=-1).to(x.dtype)
    return torch.cat([rotated, xp], dim=-1) if rot < head_dim else rotated


def sinusoidal_positions(seq_len: int, dim: int, dtype=torch.float32,
                         device="cpu"):
    """Whisper-style sinusoidal embeddings (seq_len, dim), used by the
    encoder and the decoder of the encoder-decoder config."""
    return sinusoidal_at(torch.arange(seq_len, device=device), dim).to(dtype)


def sinusoidal_at(positions, dim: int):
    """The same embedding at arbitrary (N,) positions, in f32: (N, dim)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :dim]
