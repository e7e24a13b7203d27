"""Blocked GQA attention for prefill and the bidirectional encoder (K6).

Replaces the reference's Pallas TPU kernel
src/repro/kernels/flash_attention.py `_kernel` (pallas_call :93) with the
hand-written CUDA kernel `csrc/flash_attention.cu`:

  flash_attention(q, k, v, *, causal=True, window=0, scale=None)
      q (B, K, G, S, D), k and v (B, K, T, D), f32 or bf16 -> (B, K, G, S, D)

For query position s and key t of the same (b, kv-head): score =
(q . k) * scale (default D**-0.5), allowed where t <= s when causal and
t > s - window when window > 0; output = softmax over the allowed keys
. v, in q's dtype.  Positions count from 0 on both sides, so prefill of a
whole prompt and the encoder's bidirectional pass are exactly this function.

What bounds it on an H100: operations, 4·K·G·D·S·T flops (halved when
causal) in plain FP32 — 25.8 GFLOP, 0.39 ms at 67 TFLOP/s, for the
long-context shape K=4, G=3, S=T=4096, D=64 — against 25 MB of inputs.
The kernel stays in full FP32 (no TF32, no tensor cores) to hold the
reference's 2e-5.  It has two CTA shapes (`FLASH_CONFIGS`): a wide one (4
rows x 4 keys a thread, 64 rows a CTA at D <= 64) for problems that fill
the card with it, and a narrow one (8 rows a CTA) for small ones such as
the agent's prefill.  The C launcher picks one from the grid and the SM
count; `flash_grid` mirrors that choice and `flash_key_range` each CTA's
key loop.

The kernel reads q, k and v through their strides (D must have stride 1),
so the model's (B, S, H, D) projections and (B, T, K, D) caches are passed
as permuted views, not copied.  The output is allocated (B, S, K, G, D) in
memory and returned as a (B, K, G, S, D) view, which the attention layer
folds back to (B, S, H, D) without a copy.

A CPU tensor runs the plain PyTorch version (`flash_attention_ref`, the
reference's oracle `ref.flash_attention_ref`); a CUDA tensor launches the
kernel or the call raises.  `flash_attention.launches` counts launches,
and `flash_attention.rows_per_cta` holds the query rows per CTA of the
shape the C launcher last launched.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import count_launch

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale=None):
    """Plain version: (B,K,G,S,D) x (B,K,T,D) -> (B,K,G,S,D) by one masked
    softmax over f32 scores.  A query with no allowed key (only possible
    with a window and S > T) outputs 0, as the kernel does: masked keys get
    exactly zero weight (the reference oracle's NEG_INF fill would average
    them instead)."""
    B, K, G, S, D = q.shape
    T = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bkgsd,bktd->bkgst", q.float(), k.float()) * scale
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window > 0:
        ok = ok & (k_pos > q_pos - window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * ok.any(-1, keepdim=True)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.to(q.dtype)


def check_operand(what: str, t, dtype, ndim: int, device) -> None:
    """Raise unless `t` is an `ndim`-D tensor of `dtype` on `device` with a
    unit stride on its last axis (any other strides are read in place)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} dtype {t.dtype}, q's is {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got {tuple(t.shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{what}'s last axis must have stride 1")


# padded head dim -> {narrow: (query rows per CTA, keys per tile)}: the CTA
# shapes of csrc/flash_attention.cu (`Shape`)
FLASH_CONFIGS = {
    32: {False: (64, 32), True: (8, 64)},
    64: {False: (64, 32), True: (8, 64)},
    128: {False: (64, 64), True: (8, 64)},
    256: {False: (32, 32), True: (8, 32)},
}


def padded_head_dim(D: int) -> int:
    """The kernels' instance for head dim D: D rounded up to 32, 64, 128
    or 256."""
    for dp in (32, 64, 128, 256):
        if D <= dp:
            return dp
    raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")


def flash_grid(B: int, K: int, G: int, S: int, D: int, sms: int):
    """(narrow, query rows per CTA, keys per tile, CTAs): the wide CTA
    shape when its grid puts at least one CTA on every SM, else the narrow
    one, as the C launcher decides.  Row block i of a (b, kv-head) holds its flattened (s, g) rows
    [i * rows, (i + 1) * rows)."""
    dp = padded_head_dim(D)
    for narrow in (False, True):
        rows, keys = FLASH_CONFIGS[dp][narrow]
        ctas = -(-G * S // rows) * K * B
        if ctas >= sms or narrow:
            return narrow, rows, keys, ctas


def flash_key_range(r0: int, rows: int, keys: int, G: int, S: int, T: int,
                    causal: bool, window: int):
    """Keys [t_begin, t_end) that the CTA of rows [r0, r0 + rows) walks in
    tiles of `keys` (t_begin a tile boundary): from the first tile a
    window lets any of its rows see, to the block's last position when
    causal.  The kernel does the same arithmetic on the device."""
    s_lo = r0 // G
    s_hi = (min(r0 + rows, G * S) - 1) // G
    t_end = min(T, s_hi + 1) if causal else T
    t_begin = max(0, s_lo - window + 1) if window > 0 else 0
    return t_begin - t_begin % keys, t_end


def cp_async_ok(D: int, esize: int, *tensors) -> bool:
    """Whether K/V rows of `tensors` may be copied by 16-byte cp.async: D
    times the element size, each base and each stride of the first three
    axes are multiples of 16 bytes.  Else the kernels stage with plain
    loads."""
    return D * esize % 16 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s * esize % 16 == 0
                                       for s in t.stride()[:3])
        for t in tensors)


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library, with its C signature set."""
    from repro_torch.kernels.build import load
    lib = load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [i, p, p, p, p, i, i, i, i, i, i,
                                           ctypes.c_float, i, i, i, p, p,
                                           ctypes.POINTER(i)]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_max_head_dim.restype = i
    if lib.flash_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("MAX_HEAD_DIM is out of step with "
                           "csrc/flash_attention.cu")
    return lib


def _launch(q, k, v, causal: bool, window: int, scale: float):
    device = q.device
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes f32 or bf16, got {q.dtype}")
    check_operand("q", q, q.dtype, 5, device)
    check_operand("k", k, q.dtype, 4, device)
    check_operand("v", v, q.dtype, 4, device)
    B, K, G, S, D = q.shape
    T = k.shape[2]
    if tuple(k.shape) != (B, K, T, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside [1, {MAX_HEAD_DIM}]")
    if T < 1:
        raise ValueError("flash_attention needs at least one key")
    if max(G * S, T, B * K * G * S) >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} beyond the kernel's grid")
    if window < 0:
        raise ValueError(f"window={window} < 0")
    out = torch.empty((B, S, K, G, D), dtype=q.dtype,
                      device=device).permute(0, 2, 3, 1, 4)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *out.stride()[:4])
    vec = cp_async_ok(D, q.element_size(), k, v)
    stream = torch.cuda.current_stream(device).cuda_stream
    rows = ctypes.c_int(0)
    rc = _library().flash_attention_launch(
        DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, K, G, S, T, D, float(scale), int(bool(causal)),
        int(window), int(vec), strides, ctypes.c_void_p(stream),
        ctypes.byref(rows))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    count_launch(flash_attention)
    flash_attention.rows_per_cta = rows.value
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None):
    """K6.  q (B, K, G, S, D), k and v (B, K, T, D), f32 or bf16 ->
    (B, K, G, S, D) in q's dtype (see the module docstring)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, window, scale)


flash_attention.launches = 0
flash_attention.rows_per_cta = 0
