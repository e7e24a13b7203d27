"""Flash-decode: one query token against a KV cache (K5).

Replaces the reference's Pallas TPU kernel
src/repro/kernels/decode_attention.py `_kernel` (pallas_call :80) with the
hand-written CUDA kernel `csrc/decode_attention.cu`:

  decode_attention(q, k, v, kv_len, *, scale=None, window=0)
      q (B, K, G, D), k and v (B, K, T, D), f32 or bf16, kv_len (B,) int32
      -> (B, K, G, D)

For batch row b the allowed cache positions are t < kv_len[b] (the new
token already written), and t > kv_len[b] - 1 - window when window > 0;
output = softmax((q . k) * scale) over them . v, in q's dtype.  Rows past
kv_len never reach the output, whatever they hold.

What bounds it on an H100: bytes — every allowed cache row is read once
for the G heads that share it, 2·D·4 bytes per (row, kv-head) in f32
against 4·G·D flops.  The kernel splits T across CTAs so that the
engine's few slots fill the card (`plan_splits`), then merges the splits'
partial softmax states in a second small kernel; both run in plain FP32.

The cache is read through its strides (D must have stride 1): the engine's
(B, T, K, D) per-layer cache goes in as a permuted view, never copied.
`kv_len` stays on the device; a split past it returns at once.

A CPU tensor runs the plain PyTorch version (`decode_attention_ref`, the
reference's oracle `ref.decode_attention_ref`); a CUDA tensor launches the
kernel or the call raises.  `decode_attention.launches` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.flash_attention import (DTYPES, MAX_HEAD_DIM,
                                                 NEG_INF, check_operand)

MAX_GROUP = 16      # query heads per kv-head (kMaxG in the source)
TILE = 64           # cache rows per tile (kKeys in the source)
CTAS_PER_SM = 4     # the split plan's target occupancy


def decode_attention_ref(q, k, v, kv_len, *, scale=None, window: int = 0):
    """Plain version: (B,K,G,D) against (B,K,T,D) with per-row lengths, by
    one masked softmax over f32 scores.  A row with no allowed position
    (kv_len 0, or a window past the cache) outputs 0, as the kernel — and
    the reference's Pallas kernel — do."""
    B, K, G, D = q.shape
    T = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), k.float()) * scale
    pos = torch.arange(T, device=q.device)[None, None, None, :]
    kl = kv_len.to(q.device).long()[:, None, None, None]
    ok = pos < kl
    if window > 0:
        ok = ok & (pos > kl - 1 - window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * ok.any(-1, keepdim=True)
    out = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    return out.to(q.dtype)


def plan_splits(T: int, B: int, K: int, sms: int):
    """Cut the cache's T axis into splits of whole tiles so that the
    (split, kv-head, batch row) grid puts about CTAS_PER_SM CTAs on every
    SM.  Returns (n_split, rows_per_split)."""
    tiles = -(-T // TILE)
    want = max(1, -(-CTAS_PER_SM * sms // max(1, B * K)))
    per = -(-tiles // min(tiles, want))
    return -(-tiles // per), per * TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library, with its C signature set."""
    from repro_torch.kernels.build import load
    lib = load("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = [i, p, p, p, p, p, i, i, i, i, i,
                                            ctypes.c_float, i, i, i, p, p, p,
                                            p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_max_group.restype = i
    lib.decode_attention_max_head_dim.restype = i
    if (lib.decode_attention_max_group() != MAX_GROUP
            or lib.decode_attention_max_head_dim() != MAX_HEAD_DIM):
        raise RuntimeError("MAX_GROUP / MAX_HEAD_DIM are out of step with "
                           "csrc/decode_attention.cu")
    return lib


def _launch(q, k, v, kv_len, window: int, scale: float):
    device = q.device
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention takes f32 or bf16, got {q.dtype}")
    check_operand("q", q, q.dtype, 4, device)
    check_operand("k", k, q.dtype, 4, device)
    check_operand("v", v, q.dtype, 4, device)
    check_operand("kv_len", kv_len, torch.int32, 1, device)
    B, K, G, D = q.shape
    T = k.shape[2]
    if tuple(k.shape) != (B, K, T, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if kv_len.shape[0] != B:
        raise ValueError(f"{kv_len.shape[0]} lengths for {B} batch rows")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside [1, {MAX_HEAD_DIM}]")
    if G > MAX_GROUP:
        raise ValueError(f"{G} query heads per kv-head > {MAX_GROUP}")
    if T < 1 or T >= 2 ** 31 or B > 65535 or K > 65535:
        raise ValueError(f"cache shape {tuple(k.shape)} beyond the kernel")
    if window < 0:
        raise ValueError(f"window={window} < 0")
    out = torch.empty((B, K, G, D), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    n_split, chunk = plan_splits(T, B, K, _sm_count(index))
    part_ml = torch.empty((B, K, n_split, G, 2), dtype=torch.float32,
                          device=device)
    part_acc = torch.empty((B, K, n_split, G, D), dtype=torch.float32,
                           device=device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _library().decode_attention_launch(
        DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), B, K, G, T, D, float(scale),
        int(window), n_split, chunk, strides, part_ml.data_ptr(),
        part_acc.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    decode_attention.launches += 1
    return out


def decode_attention(q, k, v, kv_len, *, scale=None, window: int = 0):
    """K5.  q (B, K, G, D), k and v (B, K, T, D), f32 or bf16, kv_len (B,)
    int32 -> (B, K, G, D) in q's dtype (see the module docstring)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len, scale=scale,
                                    window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _launch(q, k, v, kv_len, window, scale)


decode_attention.launches = 0
