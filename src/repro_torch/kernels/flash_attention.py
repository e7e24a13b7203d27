"""Blocked GQA attention for prefill and the bidirectional encoder (K6).

Replaces the reference's Pallas TPU kernel
src/repro/kernels/flash_attention.py `_kernel` (pallas_call :93) with the
hand-written CUDA kernel `csrc/flash_attention.cu`:

  flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                  prefix_len=None, q_offset=None, kv_offset=None)
      q (B, K, G, S, D), k and v (B, K, T, D), f32 or bf16 -> (B, K, G, S, D)

For query position s and key t of the same (b, kv-head): score =
(q . k) * scale (default D**-0.5), allowed where t <= s when causal (or
t < prefix_len: the prefix-LM mask of an image prefix, a scalar or a (B,)
int32 tensor of per-row prefixes) and t > s - window when window > 0;
output = softmax over the allowed keys . v, in q's dtype.  Positions count
from 0 on both sides unless the call gives per-row offsets (`q_offset`,
`kv_offset`: an int or a (B,) int tensor each, read on the device): row
b's queries then sit at q_offset[b] + s and its keys at kv_offset[b] + t,
and the mask compares those absolute positions as the reference's
`_allowed` does (causal kv <= q, window kv > q - window, prefix kv <
prefix_len, and a key below position 0 masked).  So prefill of a whole
prompt or of a window of it, the encoder's bidirectional pass and
cross-attention (bidirectional, S != T) are exactly this function.

What bounds it on an H100: operations, 4·K·G·D·S·T flops (halved when
causal) — in plain FP32 25.8 GFLOP, 0.39 ms at 67 TFLOP/s, for the
long-context shape K=4, G=3, S=T=4096, D=64 — against 25 MB of inputs.
Two families of instances, chosen by dtype:

  * f32 stays in full FP32 on the CUDA cores (no TF32, no tensor cores):
    the reference holds an f32 call to 2e-5, and memori-agent and its
    train step are f32.  Two CTA shapes (`FLASH_CONFIGS`): a wide one (4
    rows x 4 keys a thread, 64 rows a CTA at D <= 64) for problems that
    fill the card with it, a narrow one (8 rows a CTA) for small ones such
    as the agent's prefill.
  * bf16 runs both products on the tensor cores (`mma.sync` m16n8k16,
    bf16 x bf16 -> f32, FlashAttention-2's layout: a warp owns 16 query
    rows), P rounded to bf16 before P·V and l summed from the f32
    probabilities.  The zoo holds a bf16 call to 2e-2 x max|v| of its
    plain version, which one bf16 rounding of P (2^-9 relative a weight)
    stays far inside.  D is padded to a multiple of 16 (D = 192 runs 192
    deep, not 256), within head-dim classes 64 / 128 / 192 / 256 / 576
    (`TC_CONFIGS`): 64-row CTAs (4 warps of 16 rows), wide when that grid
    fills the card, else narrow: a cluster of 2, 4 or 8
    CTAs splits each row block's keys and combines them through
    distributed shared memory; D > 256 (MLA's absorbed 576) splits the
    output into 192-column slices, one CTA each.

The C launcher picks the shape from the grid and the SM count;
`flash_grid` mirrors that choice (per dtype) and `flash_key_range` each
CTA's key loop.

The kernel reads q, k and v through their strides (D must have stride 1),
so the model's (B, S, H, D) projections and (B, T, K, D) caches are passed
as permuted views, not copied.  The output is allocated (B, S, K, G, D) in
memory and returned as a (B, K, G, S, D) view, which the attention layer
folds back to (B, S, H, D) without a copy.

A CPU tensor runs the plain PyTorch version (`flash_attention_ref`, the
reference's oracle `ref.flash_attention_ref`); a CUDA tensor launches the
kernel or the call raises.  `flash_attention.launches` counts launches
(`prefix_launches` those with a prefix, `offset_launches` those with
position offsets, `absorbed_launches` those of the
D = 576 instance that MLA's absorbed form runs, `tc_launches` those of the
bf16 tensor-core instances),
and `flash_attention.rows_per_cta` holds the query rows per CTA of the
shape the C launcher last launched.

Gradients.  When grad is enabled and q, k or v requires it, the call goes
through `FlashAttentionFn`, a `torch.autograd.Function` whose forward is
the same dispatch (K6 on a CUDA tensor, launch-counted; the plain version
on a CPU tensor) and whose backward (`flash_attention_bwd`) is torch ops:
per block of at most `BWD_BLOCK` query rows it recomputes the
probabilities from the saved q, k, v under the forward's exact mask, then
D = rowsum(dO * O), dS = P * (dP - D), dq = dS k * scale, and dk = dS^T q
* scale, dv = P^T dO summed over each kv head's G query heads, all in f32,
returned in the inputs' dtype.  A query row with no allowed key has output
0 and gradient 0.  This backward is not the port of a TPU kernel: the
reference's K6 has no `custom_vjp`, and its training gradient is XLA's
autodiff of the pure-JAX `_sdpa_chunked` (src/repro/models/layers/
attention.py), computed outside any Pallas kernel, so torch ops are its
counterpart here, as a plain product stays `torch.matmul`.  A CUDA tensor
that needs a gradient never goes through the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import VariantCounter, count_launch

NEG_INF = -2.0e38
MAX_HEAD_DIM = 576
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _prefix_rows(prefix_len, B: int, device):
    """A prefix length (or a position offset) as a (B, 1, 1) long tensor
    (None: 0)."""
    if prefix_len is None:
        prefix_len = 0
    if isinstance(prefix_len, torch.Tensor):
        return prefix_len.to(device).long().reshape(-1, 1, 1).expand(B, 1, 1)
    return torch.full((B, 1, 1), int(prefix_len), device=device)


def _allowed(B: int, q_rows, k_rows, *, causal: bool, window: int,
             prefix_len, q_offset, kv_offset, device):
    """(B, len(q_rows), len(k_rows)) mask of query rows `q_rows` against
    keys `k_rows` (1-D long tensors of positions before the offsets), on
    absolute positions as the module docstring sets out."""
    q_pos = q_rows[None, :, None] + _prefix_rows(q_offset, B, device)
    k_pos = k_rows[None, None, :] + _prefix_rows(kv_offset, B, device)
    ok = (k_pos >= 0).expand(B, q_rows.shape[0], k_rows.shape[0])
    if causal:
        ok = ok & ((k_pos <= q_pos)
                   | (k_pos < _prefix_rows(prefix_len, B, device)))
    if window > 0:
        ok = ok & (k_pos > q_pos - window)
    return ok


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale=None, prefix_len=None, q_offset=None,
                        kv_offset=None):
    """Plain version: (B,K,G,S,D) x (B,K,T,D) -> (B,K,G,S,D) by one masked
    softmax over f32 scores.  A query with no allowed key (only possible
    with a window and S > T, or with offsets) outputs 0, as the kernel
    does: masked keys get exactly zero weight (the reference oracle's
    NEG_INF fill would average them instead)."""
    B, K, G, S, D = q.shape
    T = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bkgsd,bktd->bkgst", q.float(), k.float()) * scale
    ok = _allowed(B, torch.arange(S, device=q.device),
                  torch.arange(T, device=q.device), causal=causal,
                  window=window, prefix_len=prefix_len, q_offset=q_offset,
                  kv_offset=kv_offset, device=q.device)
    ok = ok[:, None, None]                              # (B, 1, 1, S, T)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * ok.any(-1, keepdim=True)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.to(q.dtype)


def check_operand(what: str, t, dtype, ndim: int, device, *,
                  unit_last: bool = True) -> None:
    """Raise unless `t` is an `ndim`-D tensor of `dtype` on `device` with a
    unit stride on its last axis when `unit_last` (any other strides are
    read in place)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} dtype {t.dtype}, q's is {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got {tuple(t.shape)}")
    if unit_last and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{what}'s last axis must have stride 1")


# padded head dim -> {narrow: (query rows per CTA, keys per tile)}: the CTA
# shapes of csrc/flash_attention.cu (`Shape`)
FLASH_CONFIGS = {
    32: {False: (64, 32), True: (8, 64)},
    64: {False: (64, 32), True: (8, 64)},
    128: {False: (64, 64), True: (8, 64)},
    256: {False: (32, 32), True: (8, 32)},
    576: {False: (16, 16), True: (8, 16)},      # MLA absorbed (512 + 64)
}


# head-dim class -> {narrow: (query rows per CTA, keys per tile)}: the bf16
# tensor-core shapes of csrc/flash_attention.cu (`TcShape`); a CTA of the
# 576 class computes TC_SLICE output columns
TC_CONFIGS = {64: (64, 64), 128: (64, 64), 192: (64, 32), 256: (64, 32),
              576: (64, 32)}
TC_SLICE = 192
TC_MAX_SPLIT = 8    # a narrow cluster's CTAs


def padded_head_dim(D: int) -> int:
    """The f32 instance for head dim D: D rounded up to 32, 64, 128, 256 or
    576 (MLA's absorbed latent width).  K5 sizes its partials by it too."""
    for dp in FLASH_CONFIGS:
        if D <= dp:
            return dp
    raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")


def tc_head_class(D: int) -> int:
    """The bf16 instance's head-dim class for head dim D (64, 128, 192, 256
    or 576); it multiplies D rounded up to 16 deep."""
    for dk in TC_CONFIGS:
        if D <= dk:
            return dk
    raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")


def column_slices(D: int, dtype=torch.float32) -> int:
    """CTAs a row block takes on the grid's second axis: ceil(D / 192) for
    the bf16 576 class, else 1."""
    if dtype == torch.bfloat16 and tc_head_class(D) > 256:
        return -(-D // TC_SLICE)
    return 1


def flash_grid(B: int, K: int, G: int, S: int, D: int, sms: int,
               dtype=torch.float32):
    """(narrow, query rows per CTA, keys per tile, CTAs) of a `dtype` call:
    the wide CTA shape when its grid (row blocks x column slices) puts at
    least one CTA on every SM, else the narrow one, as the C launcher
    decides.  Row block i of a (b, kv-head) holds its flattened (s, g) rows
    [i * rows, (i + 1) * rows).  A bf16 narrow launch is the wide row
    blocks, each a cluster of `tc_splits` CTAs that split its key tiles
    (`tc_split_range`) and finalise rows / n_split rows each: those are the
    rows per CTA returned (and reported by the C launcher)."""
    if dtype == torch.bfloat16:
        rows, keys = TC_CONFIGS[tc_head_class(D)]
        ctas = -(-G * S // rows) * K * B * column_slices(D, dtype)
        n_split = tc_splits(ctas, sms)
        return n_split > 1, rows // n_split, keys, ctas * n_split
    configs = FLASH_CONFIGS[padded_head_dim(D)]
    for narrow in (False, True):
        rows, keys = configs[narrow]
        ctas = -(-G * S // rows) * K * B
        if ctas >= sms or narrow:
            return narrow, rows, keys, ctas


def tc_splits(ctas: int, sms: int) -> int:
    """The CTAs of a bf16 narrow cluster (1 for the wide shape): the
    fewest of 2, 4 and 8 that put `ctas` row blocks' clusters on every SM,
    at most TC_MAX_SPLIT."""
    if ctas >= sms:
        return 1
    n = 2
    while n < TC_MAX_SPLIT and ctas * n < sms:
        n *= 2
    return n


def tc_split_range(tiles: int, n_split: int, split: int):
    """Key tiles [lo, hi) of a row block's `tiles` that split `split` of a
    narrow cluster walks, as the kernel cuts them."""
    return tiles * split // n_split, tiles * (split + 1) // n_split


def flash_key_range(r0: int, rows: int, keys: int, G: int, S: int, T: int,
                    causal: bool, window: int, prefix_len: int = 0):
    """Keys [t_begin, t_end) that the CTA of rows [r0, r0 + rows) walks in
    tiles of `keys` (t_begin a tile boundary): from the first tile a
    window lets any of its rows see, to the block's last position (or the
    prefix's end, if later) when causal.  The kernel does the same
    arithmetic on the device."""
    s_lo = r0 // G
    s_hi = (min(r0 + rows, G * S) - 1) // G
    t_end = min(T, max(s_hi + 1, prefix_len)) if causal else T
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
                                           ctypes.c_float, i, i, i, p, p, i,
                                           p, p, ctypes.POINTER(i)]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_max_head_dim.restype = i
    lib.flash_attention_occupancy.argtypes = [i, i, i, ctypes.POINTER(i),
                                              ctypes.POINTER(i)]
    lib.flash_attention_occupancy.restype = i
    if lib.flash_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("MAX_HEAD_DIM is out of step with "
                           "csrc/flash_attention.cu")
    return lib


def occupancy(dtype, D: int, narrow: bool):
    """(resident CTAs per SM, dynamic shared memory bytes) of the instance
    a `dtype` call at head dim D launches in the given CTA shape
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    ctas, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = _library().flash_attention_occupancy(
        DTYPES[dtype], D, int(narrow), ctypes.byref(ctas), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return ctas.value, smem.value


def _offset_rows(q_offset, kv_offset, B: int, device):
    """The kernel's (2, B) int32 offsets (queries, then keys) of a call,
    made on the device without a read back; None when neither is a tensor
    or a nonzero int (the instances that take no offsets run then)."""
    if not any(isinstance(off, torch.Tensor) or off
               for off in (q_offset, kv_offset)):
        return None
    rows = []
    for off in (q_offset, kv_offset):
        if isinstance(off, torch.Tensor):
            if off.device != device or off.shape != (B,):
                raise ValueError(f"a position offset must be a ({B},) "
                                 f"tensor on {device}, got "
                                 f"{tuple(off.shape)} on {off.device}")
            rows.append(off.to(torch.int32))
        else:
            rows.append(torch.full((B,), int(off or 0), dtype=torch.int32,
                                   device=device))
    return torch.stack(rows).contiguous()


def _launch(q, k, v, causal: bool, window: int, scale: float, prefix_len,
            q_offset=None, kv_offset=None):
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
    prefix_rows, prefix_int = None, 0
    if isinstance(prefix_len, torch.Tensor):
        check_operand("prefix_len", prefix_len, torch.int32, 1, device)
        if prefix_len.shape[0] != B or not prefix_len.is_contiguous():
            raise ValueError(f"prefix_len {tuple(prefix_len.shape)}: want "
                             f"a contiguous ({B},) tensor")
        prefix_rows = prefix_len.data_ptr()
    elif prefix_len is not None:
        prefix_int = int(prefix_len)
        if prefix_int < 0:
            raise ValueError(f"prefix_len={prefix_int} < 0")
    offsets = _offset_rows(q_offset, kv_offset, B, device)
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
        int(window), prefix_int, prefix_rows,
        None if offsets is None else offsets.data_ptr(), int(vec), strides,
        ctypes.c_void_p(stream), ctypes.byref(rows))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    count_launch(flash_attention)
    if prefix_rows is not None or prefix_int > 0:
        count_launch(prefix_launches)
    if offsets is not None:
        count_launch(offset_launches)
    if D > 256:
        count_launch(absorbed_launches)
    if q.dtype == torch.bfloat16:
        count_launch(tc_launches)
    flash_attention.rows_per_cta = rows.value
    return out


def _forward(q, k, v, causal: bool, window: int, scale: float, prefix_len,
             q_offset=None, kv_offset=None):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, prefix_len=prefix_len,
                                   q_offset=q_offset, kv_offset=kv_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, window, scale, prefix_len, q_offset,
                   kv_offset)


# query rows of one block of the backward: its f32 (B, K, G, rows, T)
# probabilities and their gradient are the largest tensors it holds
BWD_BLOCK = 256


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool, window: int,
                        scale: float, prefix_len=None, q_offset=None,
                        kv_offset=None):
    """(dq, dk, dv) of `flash_attention` for the output gradient `dout`,
    by torch ops over query blocks of at most BWD_BLOCK rows (see the
    module docstring).  A block's keys are cut to the range its mask can
    allow when the offsets are ints (or absent) or one tensor for both
    sides (self-attention over a window: query and key frames agree), and
    the causal cut also needs an int prefix (with tensor offsets, none)."""
    B, K, G, S, D = q.shape
    T = k.shape[2]
    f32 = torch.float32
    kf, vf = k.to(f32), v.to(f32)
    dk = torch.zeros((B, K, T, D), dtype=f32, device=q.device)
    dv = torch.zeros((B, K, T, D), dtype=f32, device=q.device)
    dq = torch.empty((B, K, G, S, D), dtype=f32, device=q.device)
    static = not any(isinstance(a, torch.Tensor)
                     for a in (q_offset, kv_offset))
    # the shift between the frames is known on the host
    framed = static or q_offset is kv_offset
    static_prefix = (not isinstance(prefix_len, torch.Tensor)
                     and (static or not prefix_len))
    # in the keys' frame: query s sits at s + shift, the prefix ends at pend
    shift = int(q_offset or 0) - int(kv_offset or 0) if static else 0
    pend = (int(prefix_len or 0) - int(kv_offset or 0)
            if static and static_prefix else 0)
    for s0 in range(0, S, BWD_BLOCK):
        s1 = min(S, s0 + BWD_BLOCK)
        t0 = (max(0, s0 + shift - window + 1)
              if window > 0 and framed else 0)
        t1 = (min(T, max(s1 + shift, pend))
              if causal and framed and static_prefix else T)
        if t1 <= t0:             # no key allowed anywhere in the block
            dq[:, :, :, s0:s1] = 0.0
            continue
        qb = q[:, :, :, s0:s1].to(f32)
        ob = out[:, :, :, s0:s1].to(f32)
        gb = dout[:, :, :, s0:s1].to(f32)
        kb, vb = kf[:, :, t0:t1], vf[:, :, t0:t1]
        s = torch.einsum("bkgsd,bktd->bkgst", qb, kb) * scale
        ok = _allowed(B, torch.arange(s0, s1, device=q.device),
                      torch.arange(t0, t1, device=q.device), causal=causal,
                      window=window, prefix_len=prefix_len,
                      q_offset=q_offset, kv_offset=kv_offset,
                      device=q.device)[:, None, None]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1) * ok.any(-1, keepdim=True)
        dsum = (gb * ob).sum(-1, keepdim=True)            # D = rowsum(dO*O)
        dp = torch.einsum("bkgsd,bktd->bkgst", gb, vb)
        ds = p * (dp - dsum)
        dq[:, :, :, s0:s1] = torch.einsum("bkgst,bktd->bkgsd", ds,
                                          kb) * scale
        dk[:, :, t0:t1] += torch.einsum("bkgst,bkgsd->bktd", ds, qb) * scale
        dv[:, :, t0:t1] += torch.einsum("bkgst,bkgsd->bktd", p, gb)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """K6 with a gradient: the forward is `flash_attention`'s dispatch, the
    backward `flash_attention_bwd` (torch ops, see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, prefix_len,
                q_offset=None, kv_offset=None):
        out = _forward(q, k, v, causal, window, scale, prefix_len, q_offset,
                       kv_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = (causal, window, scale, prefix_len, q_offset, kv_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        causal, window, scale, prefix_len, q_offset, kv_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout, causal=causal, window=window, scale=scale,
            prefix_len=prefix_len, q_offset=q_offset, kv_offset=kv_offset)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None, prefix_len=None, q_offset=None,
                    kv_offset=None):
    """K6.  q (B, K, G, S, D), k and v (B, K, T, D), f32 or bf16 ->
    (B, K, G, S, D) in q's dtype (see the module docstring); through
    `FlashAttentionFn` when a gradient is wanted."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale,
                                      prefix_len, q_offset, kv_offset)
    return _forward(q, k, v, causal, window, scale, prefix_len, q_offset,
                    kv_offset)


flash_attention.launches = 0
# launches with a prefix mask, counted besides flash_attention.launches
prefix_launches = VariantCounter("flash_attention[prefix]")
# launches with per-row position offsets, counted besides
offset_launches = VariantCounter("flash_attention[offset]")
# launches of the D = 576 instance (MLA's absorbed latent), counted besides
absorbed_launches = VariantCounter("flash_attention[d576]")
# launches of the bf16 (tensor-core) instances, counted besides
tc_launches = VariantCounter("flash_attention[tc]")
flash_attention.rows_per_cta = 0
