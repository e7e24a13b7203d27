"""Small shared helpers: integer rounding, deterministic hashing, devices."""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.obs.telemetry import get_telemetry


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


def upload(a, device, dtype=None) -> torch.Tensor:
    """`a` as a tensor on `device` (`dtype` if given): the host-to-device
    copy of the port's serving path.  The bytes of host data (an array or
    a list) are added to `h2d_bytes` of the innermost open telemetry span,
    on the CPU too (where `.to` copies nothing), so the CPU tests read the
    card's numbers; a tensor counts only when it leaves the CPU for
    another device."""
    t = torch.as_tensor(a, dtype=dtype)
    if not isinstance(a, torch.Tensor) or (
            t.device.type == "cpu" and torch.device(device).type != "cpu"):
        get_telemetry().add_count("h2d_bytes", t.numel() * t.element_size())
    return t.to(device)


def to_device(a, device) -> torch.Tensor:
    """A copy of host array `a` on `device` — a copy on the CPU too, so a
    buffer updated in place never aliases the host mirror it came from.
    Counted as `upload` counts."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    get_telemetry().add_count("h2d_bytes", t.numel() * t.element_size())
    return t.to(device, copy=True)


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of CUDA `device` (its index, or the
    current device when it has none)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _sm_count(index)
