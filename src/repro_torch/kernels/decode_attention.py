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
against 4·G·D flops.  One launch a call: the grid (split, kv-head, batch
row) is fixed by the shape (`plan_splits`), each CTA takes its share of
the allowed range from kv_len on the device (`split_range`), and the last
CTA of each (b, kv-head) merges the splits' partial softmax states; all
arithmetic is plain FP32.

The cache is read through its strides (D must have stride 1): the engine's
(B, T, K, D) per-layer cache goes in as a permuted view, never copied.
`kv_len` stays on the device, so a captured call (a CUDA graph) stays right
when kv_len changes between replays.

Host path: the first call of a (device, dtypes, shapes, strides, window,
scale, alignment) checks its operands and builds a launch plan — the split
count, the ctypes stride array and a persistent workspace (the partials,
and one arrival counter per (b, kv-head) that the kernel leaves at 0).
Later calls look the plan up, allocate the output and make one ctypes
call.  A plan must be built outside any graph capture (an eager call
first); building one while capturing raises.  Calls that share a plan share
its workspace, so they must be ordered on one stream, as the engine makes
them: two calls of one shape on two streams at once would race.

A CPU tensor runs the plain PyTorch version (`decode_attention_ref`, the
reference's oracle `ref.decode_attention_ref`); a CUDA tensor launches the
kernel or the call raises.  `decode_attention.launches` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch

from repro_torch.common.utils import sm_count
from repro_torch.kernels import count_launch
from repro_torch.kernels.flash_attention import (DTYPES, MAX_HEAD_DIM,
                                                 NEG_INF, check_operand,
                                                 cp_async_ok, padded_head_dim)

MAX_GROUP = 16      # query heads per kv-head (kMaxG in the source)
MAX_SPLITS = 32     # splits of one (b, kv-head) (kMaxSplits in the source)
CTAS_PER_SM = 2     # the split plan's target occupancy


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


def plan_splits(T: int, B: int, K: int, sms: int) -> int:
    """The number of CTAs that share one (b, kv-head): about CTAS_PER_SM
    CTAs on every SM over the (split, kv-head, batch row) grid, at most
    MAX_SPLITS and T.  It depends on the shape alone, so a captured graph
    keeps it whatever kv_len does."""
    want = -(-CTAS_PER_SM * sms // max(1, B * K))
    return max(1, min(MAX_SPLITS, T, want))


def split_range(kv_len: int, T: int, window: int, n_split: int,
                split: int):
    """Rows [lo, hi) of split `split`: of the n rows of the allowed range
    [max(0, kv_len - window), min(kv_len, T)), rows [n * split // n_split,
    n * (split + 1) // n_split) — pieces that differ by at most one row,
    none empty while n >= n_split.  The kernel's `split_range` does the
    same arithmetic on the device."""
    hi_all = max(0, min(kv_len, T))
    lo_all = max(0, kv_len - window) if window > 0 else 0
    n = max(0, hi_all - lo_all)
    return lo_all + n * split // n_split, lo_all + n * (split + 1) // n_split


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library, with its C signature set."""
    from repro_torch.kernels.build import load
    lib = load("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = [i, p, p, p, p, p, i, i, i, i, i,
                                            ctypes.c_float, i, i, i, p, p, p,
                                            p, p]
    lib.decode_attention_launch.restype = i
    for name in ("max_group", "max_head_dim", "max_splits"):
        getattr(lib, f"decode_attention_{name}").restype = i
    if (lib.decode_attention_max_group() != MAX_GROUP
            or lib.decode_attention_max_head_dim() != MAX_HEAD_DIM
            or lib.decode_attention_max_splits() != MAX_SPLITS):
        raise RuntimeError("MAX_GROUP / MAX_HEAD_DIM / MAX_SPLITS are out of "
                           "step with csrc/decode_attention.cu")
    return lib


class _Plan(NamedTuple):
    """What a call of one key needs besides its pointers: the C function,
    the leading arguments, the ctypes strides, the workspace pointers (the
    tensors are kept alive here) and the output's shape."""
    fn: object
    dims: tuple
    strides: object
    workspace: tuple
    tensors: tuple
    out_shape: tuple


_plans: Dict[tuple, _Plan] = {}


def _make_plan(q, k, v, kv_len, window: int, scale: float, vec: bool):
    device = q.device
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("decode_attention: no launch plan for this shape "
                           "yet; make one eager call before capturing a "
                           "graph (the plan allocates its workspace)")
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
    n_split = plan_splits(T, B, K, sm_count(device))
    f32 = torch.float32
    part_ml = torch.empty((B, K, n_split, G, 2), dtype=f32, device=device)
    part_acc = torch.empty((B, K, n_split, G, padded_head_dim(D)), dtype=f32,
                           device=device)
    counters = torch.zeros((B, K), dtype=torch.int32, device=device)
    out_strides = (K * G * D, G * D, D)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out_strides)
    return _Plan(
        fn=_library().decode_attention_launch,
        dims=(B, K, G, T, D, float(scale), int(window), n_split, int(vec)),
        strides=strides,
        workspace=(part_ml.data_ptr(), part_acc.data_ptr(),
                   counters.data_ptr()),
        tensors=(part_ml, part_acc, counters), out_shape=(B, K, G, D))


def _launch(q, k, v, kv_len, window: int, scale: float):
    vec = cp_async_ok(q.shape[-1], q.element_size(), k, v)
    key = (q.device, q.dtype, k.dtype, v.dtype, kv_len.dtype, k.device,
           v.device, kv_len.device, q.shape, k.shape, v.shape, kv_len.shape,
           q.stride(), k.stride(), v.stride(), kv_len.stride(), window,
           scale, vec)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _make_plan(q, k, v, kv_len, window, scale, vec)
    out = torch.empty(plan.out_shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    B, K, G, T, D, fscale, win, n_split, ivec = plan.dims
    rc = plan.fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kv_len.data_ptr(), out.data_ptr(), B, K, G, T, D, fscale,
                 win, n_split, ivec, plan.strides, *plan.workspace,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    count_launch(decode_attention)
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
