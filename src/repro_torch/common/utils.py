"""Small shared helpers: integer rounding, deterministic hashing, devices."""
from __future__ import annotations

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def stable_hash(text: str, mod: int) -> int:
    """Deterministic (cross-run, cross-process) string hash -> [0, mod)."""
    h = 2166136261
    for b in text.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h % mod


def to_device(a, device) -> torch.Tensor:
    """A copy of host array `a` on `device` — a copy on the CPU too, so a
    buffer updated in place never aliases the host mirror it came from."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def resolve_device(device) -> torch.device:
    """The port's device argument: "cuda" (the default everywhere) or
    "cpu".  Asking for CUDA on a host without a usable card raises — the
    port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False (pass device='cpu' to run the plain PyTorch path)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: 'cuda' or 'cpu'")
    return dev
