"""Flash-decode: one query token against a KV cache (K5).

Replaces the reference's Pallas TPU kernel
src/repro/kernels/decode_attention.py `_kernel` (pallas_call :80) with the
hand-written CUDA kernel `csrc/decode_attention.cu`:

  decode_attention(q, k, v, kv_len, *, scale=None, window=0,
                   slot_pos=None, k_scale=None, v_scale=None,
                   return_lse=False)
      q (B, K, G, D), k and v (B, K, T, D), f32 or bf16, kv_len (B,) int32
      -> (B, K, G, D), or with return_lse ((B, K, G, D), lse (B, K, G) f32)

For batch row b the allowed cache positions are t < kv_len[b] (the new
token already written), and t > kv_len[b] - 1 - window when window > 0;
output = softmax((q . k) * scale) over them . v, in q's dtype.  Rows past
kv_len never reach the output, whatever they hold.  `return_lse` adds each
row's log-sum-exp of its scaled f32 scores over the allowed keys (-inf
where there is none; that row's output is 0).

Context-parallel decode splits a cache's sequence over ranks.  A shard
holding absolute positions [start, start + T) of a full cache is called
with kv_len - start (which may be <= 0, or past T: the allowed range is
cut to the shard's own rows, and a shard wholly past kv_len has none); a
ring shard needs no offset, its slot positions are absolute.
`combine_partials` merges the shards' (output, lse) pairs into the whole
cache's, the combine XLA emits for the reference's sharded softmax.

Two variants of the same kernel (template instances of it):

  * `slot_pos` (B, T) int32, the ring-buffer cache of a sliding window:
    slot t holds the token at position slot_pos[b, t] (-1: empty) and the
    query sits at position kv_len[b] - 1.  Slot t is allowed where
    0 <= slot_pos[b, t] <= kv_len[b] - 1 and, with a window,
    slot_pos[b, t] > kv_len[b] - 1 - window.  Every slot is read.
  * `k_scale`, `v_scale` (B, K, T) f32 with int8 codes in k and v, the
    quantised cache: each row is dequantised as the reference's
    `dequantize_kv` does, code * scale in f32 rounded to q's dtype.

What bounds it on an H100: bytes — every allowed cache row is read once
for the G heads that share it, 2·D·4 bytes per (row, kv-head) in f32
against 4·G·D flops.  One launch a call: the grid (split, kv-head, batch
row) is fixed by the shape (`plan_splits`), each CTA takes its share of
the allowed range from kv_len on the device (`split_range`), and the last
CTA of each (b, kv-head) merges the splits' partial softmax states.  An
f32 call runs plain FP32 on the CUDA cores (the reference's 2e-5; the
agent is f32).  A bf16 call (a bf16 cache, or int8 codes dequantised to
bf16) runs both products on the tensor cores (`mma.sync` m16n8k16, bf16 x
bf16 -> f32): the G query heads are the 16 rows of a tile, each of the
CTA's 4 warps takes 16 of a 64-row cache tile, and P is rounded to bf16
before P·V (l summed from the f32 probabilities), inside the zoo's 2e-2 x
max|v| gate.

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
kernel or the call raises.  `decode_attention.launches` counts launches,
and `slot_launches` / `int8_launches` / `lse_launches` / `tc_launches`
(bf16, on the tensor cores) those of each variant.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple

import torch

from repro_torch.common.utils import sm_count
from repro_torch.kernels import VariantCounter, count_launch
from repro_torch.kernels.flash_attention import (DTYPES, NEG_INF,
                                                 check_operand, cp_async_ok,
                                                 padded_head_dim)

MAX_HEAD_DIM = 256  # K5's (decode_attention_max_head_dim; K6 also takes 576)
MAX_GROUP = 16      # query heads per kv-head (kMaxG in the source)
MAX_SPLITS = 32     # splits of one (b, kv-head) (kMaxSplits in the source)
CTAS_PER_SM = 2     # the split plan's target occupancy
TC_KEYS = 64        # cache rows a tile of the bf16 kernel (kTcKeys)


def dequantize(codes, scales, dtype):
    """int8 codes (..., D) times f32 scales (...,) in f32, rounded to
    `dtype`: the reference's `dequantize_kv`."""
    return (codes.float() * scales.float()[..., None]).to(dtype)


def decode_attention_ref(q, k, v, kv_len, *, scale=None, window: int = 0,
                         slot_pos=None, k_scale=None, v_scale=None,
                         return_lse: bool = False):
    """Plain version: (B,K,G,D) against (B,K,T,D) with per-row lengths (or
    slot positions), by one masked softmax over f32 scores; int8 codes are
    dequantised first.  A row with no allowed position (kv_len <= 0, or a
    window past the cache) outputs 0, as the kernel — and the reference's
    Pallas kernel — do.  `return_lse` adds the (B,K,G) f32 log-sum-exp of
    the masked scores (-inf for such a row)."""
    B, K, G, D = q.shape
    T = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if k_scale is not None:
        k, v = dequantize(k, k_scale, q.dtype), dequantize(v, v_scale, q.dtype)
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), k.float()) * scale
    kl = kv_len.to(q.device).long()[:, None, None, None]
    if slot_pos is None:
        pos = torch.arange(T, device=q.device)[None, None, None, :]
        ok = pos < kl
    else:
        pos = slot_pos.to(q.device).long()[:, None, None, :]
        ok = (pos >= 0) & (pos <= kl - 1)
    if window > 0:
        ok = ok & (pos > kl - 1 - window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * ok.any(-1, keepdim=True)
    out = torch.einsum("bkgt,bktd->bkgd", p, v.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(torch.where(ok, s, float("-inf")), dim=-1)
    return out, lse


def combine_partials(outs, lses):
    """The whole cache's attention from its shards': outs (R, ..., D) and
    lses (R, ...) f32 (one entry per shard, as `return_lse` gives them) ->
    (out (..., D) in outs' dtype, lse (...) f32).  Shard r weighs
    e^(lse_r - max_r lse_r); a shard at -inf (no allowed key) weighs 0,
    and a row no shard allows outputs 0 with lse -inf, never NaN.  Plain
    torch ops: the reference has no kernel for this, XLA emits it."""
    m = lses.amax(0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lses - m)
    total = w.sum(0)
    out = (outs.float() * w[..., None]).sum(0) \
        / total.clamp_min(1e-37)[..., None]
    lse = torch.where(total > 0, m + torch.log(total),
                      torch.full_like(m, float("-inf")))
    return out.to(outs.dtype), lse


def plan_splits(T: int, B: int, K: int, sms: int, G: int = 1,
                dtype=torch.float32) -> int:
    """The number of CTAs that share one (b, kv-head): about CTAS_PER_SM
    CTAs on every SM over the (split, kv-head, batch row) grid, at most
    MAX_SPLITS and T.  A bf16 call also gives each split at least one
    TC_KEYS-row tile, and at most sqrt(T / G) splits: a split streams
    4·D·T/n bytes of bf16 K and V, and the last CTA merges n·G·D·4 bytes
    of f32 partials, which balance at n² = T / G (recurrentgemma's ring, T
    2,048 over G 16: 11 splits, not 32).  It depends on the shape alone,
    so a captured graph keeps it whatever kv_len does."""
    want = -(-CTAS_PER_SM * sms // max(1, B * K))
    if dtype == torch.bfloat16:
        want = min(want, -(-T // TC_KEYS), max(1, math.isqrt(T // max(1, G))))
    return max(1, min(MAX_SPLITS, T, want))


def split_range(kv_len: int, T: int, window: int, n_split: int,
                split: int):
    """Rows [lo, hi) of split `split`: of the n rows of the allowed range
    [max(0, kv_len - window), min(kv_len, T)), rows [n * split // n_split,
    n * (split + 1) // n_split) — pieces that differ by at most one row,
    none empty while n >= n_split.  The kernel's `split_range` does the
    same arithmetic on the device; with slot positions it cuts all T slots
    (kv_len = T, no window)."""
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
    lib.decode_attention_launch.argtypes = [i, p, p, p, p, p, p, p, p, i, i,
                                            i, i, i, ctypes.c_float, i, i, i,
                                            p, p, p, p, p, p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(i),
                                               ctypes.POINTER(i)]
    lib.decode_attention_occupancy.restype = i
    for name in ("max_group", "max_head_dim", "max_splits"):
        getattr(lib, f"decode_attention_{name}").restype = i
    if (lib.decode_attention_max_group() != MAX_GROUP
            or lib.decode_attention_max_head_dim() != MAX_HEAD_DIM
            or lib.decode_attention_max_splits() != MAX_SPLITS):
        raise RuntimeError("MAX_GROUP / MAX_HEAD_DIM / MAX_SPLITS are out of "
                           "step with csrc/decode_attention.cu")
    return lib


def occupancy(dtype, D: int, quant: bool = False, slots: bool = False):
    """(resident CTAs per SM, dynamic shared memory bytes) of the instance
    a call with q of `dtype`, int8 codes or not, slot positions or not,
    at head dim D launches (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    ctas, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = _library().decode_attention_occupancy(
        DTYPES[dtype], int(quant), int(slots), D, ctypes.byref(ctas),
        ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return ctas.value, smem.value


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


def _make_plan(q, k, v, kv_len, slot_pos, k_scale, v_scale, window: int,
               scale: float, vec: bool):
    device = q.device
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("decode_attention: no launch plan for this shape "
                           "yet; make one eager call before capturing a "
                           "graph (the plan allocates its workspace)")
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention takes f32 or bf16, got {q.dtype}")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale go together")
    check_operand("q", q, q.dtype, 4, device)
    check_operand("k", k, torch.int8 if quant else q.dtype, 4, device)
    check_operand("v", v, torch.int8 if quant else q.dtype, 4, device)
    check_operand("kv_len", kv_len, torch.int32, 1, device)
    B, K, G, D = q.shape
    T = k.shape[2]
    if tuple(k.shape) != (B, K, T, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if kv_len.shape[0] != B:
        raise ValueError(f"{kv_len.shape[0]} lengths for {B} batch rows")
    if slot_pos is not None:
        check_operand("slot_pos", slot_pos, torch.int32, 2, device,
                      unit_last=False)
        if tuple(slot_pos.shape) != (B, T):
            raise ValueError(f"slot_pos {tuple(slot_pos.shape)}, want "
                             f"{(B, T)}")
    if quant:
        for what, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            check_operand(what, sc, torch.float32, 3, device,
                          unit_last=False)
            if tuple(sc.shape) != (B, K, T):
                raise ValueError(f"{what} {tuple(sc.shape)}, want "
                                 f"{(B, K, T)}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside [1, {MAX_HEAD_DIM}]")
    if G > MAX_GROUP:
        raise ValueError(f"{G} query heads per kv-head > {MAX_GROUP}")
    if T < 1 or T >= 2 ** 31 or B > 65535 or K > 65535:
        raise ValueError(f"cache shape {tuple(k.shape)} beyond the kernel")
    if window < 0:
        raise ValueError(f"window={window} < 0")
    n_split = plan_splits(T, B, K, sm_count(device), G, q.dtype)
    f32 = torch.float32
    part_ml = torch.empty((B, K, n_split, G, 2), dtype=f32, device=device)
    part_acc = torch.empty((B, K, n_split, G, padded_head_dim(D)), dtype=f32,
                           device=device)
    counters = torch.zeros((B, K), dtype=torch.int32, device=device)
    out_strides = (K * G * D, G * D, D)
    sp = slot_pos.stride() if slot_pos is not None else (0, 0)
    ks = k_scale.stride() if quant else (0, 0, 0)
    vs = v_scale.stride() if quant else (0, 0, 0)
    strides = (ctypes.c_longlong * 20)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out_strides, *sp,
        *ks, *vs)
    return _Plan(
        fn=_library().decode_attention_launch,
        dims=(B, K, G, T, D, float(scale), int(window), n_split, int(vec)),
        strides=strides,
        workspace=(part_ml.data_ptr(), part_acc.data_ptr(),
                   counters.data_ptr()),
        tensors=(part_ml, part_acc, counters), out_shape=(B, K, G, D))


def _meta(t):
    """What a launch plan depends on of an optional operand."""
    return None if t is None else (t.dtype, t.device, t.shape, t.stride())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, k, v, kv_len, slot_pos, k_scale, v_scale, window: int,
            scale: float, return_lse: bool):
    vec = k_scale is None and cp_async_ok(q.shape[-1], q.element_size(), k, v)
    key = (q.device, q.dtype, k.dtype, v.dtype, kv_len.dtype, k.device,
           v.device, kv_len.device, q.shape, k.shape, v.shape, kv_len.shape,
           q.stride(), k.stride(), v.stride(), kv_len.stride(), window,
           scale, vec, return_lse, _meta(slot_pos), _meta(k_scale),
           _meta(v_scale))
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _make_plan(q, k, v, kv_len, slot_pos, k_scale,
                                        v_scale, window, scale, vec)
    out = torch.empty(plan.out_shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty(plan.out_shape[:3], dtype=torch.float32,
                       device=q.device) if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    B, K, G, T, D, fscale, win, n_split, ivec = plan.dims
    rc = plan.fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kv_len.data_ptr(), _ptr(slot_pos), _ptr(k_scale),
                 _ptr(v_scale), out.data_ptr(), B, K, G, T, D, fscale,
                 win, n_split, ivec, plan.strides, *plan.workspace,
                 _ptr(lse), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    count_launch(decode_attention)
    if slot_pos is not None:
        count_launch(slot_launches)
    if k_scale is not None:
        count_launch(int8_launches)
    if q.dtype == torch.bfloat16:
        count_launch(tc_launches)
    if return_lse:
        count_launch(lse_launches)
        return out, lse
    return out


def decode_attention(q, k, v, kv_len, *, scale=None, window: int = 0,
                     slot_pos=None, k_scale=None, v_scale=None,
                     return_lse: bool = False):
    """K5.  q (B, K, G, D), k and v (B, K, T, D), f32 or bf16 (or int8
    codes with k_scale / v_scale (B, K, T) f32), kv_len (B,) int32,
    slot_pos (B, T) int32 or None -> (B, K, G, D) in q's dtype, and with
    `return_lse` its (B, K, G) f32 log-sum-exp too (see the module
    docstring)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len, scale=scale,
                                    window=window, slot_pos=slot_pos,
                                    k_scale=k_scale, v_scale=v_scale,
                                    return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _launch(q, k, v, kv_len, slot_pos, k_scale, v_scale, window, scale,
                   bool(return_lse))


decode_attention.launches = 0
# launches of the two variants, counted besides decode_attention.launches
slot_launches = VariantCounter("decode_attention[slot_pos]")
int8_launches = VariantCounter("decode_attention[int8]")
lse_launches = VariantCounter("decode_attention[lse]")
# launches of the bf16 (tensor-core) instances
tc_launches = VariantCounter("decode_attention[tc]")
