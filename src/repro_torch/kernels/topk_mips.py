"""Exact namespace-masked top-k MIPS over the Memori triple bank (kernel K1).

Replaces the reference's Pallas TPU kernel `_kernel_masked` + `_merge_topk`
(src/repro/kernels/topk_mips.py, pallas_call at :227) with the hand-written
CUDA kernel in `csrc/topk_mips.cu`: the exact top-k of queries . bankᵀ over
the rows `r < n_valid` whose label `bank_ns[r]` equals the query's
`q_ns[q]`, ranked by (score desc, row asc); an unfilled slot is
(NEG_INF, -1).

What bounds it on an H100: the plain-FP32 product, 2·Q·N·D flops (34.4
GFLOP -> 0.51 ms at 67 TFLOP/s for Q=64, N=2²⁰, D=256), ahead of the bank
read (1.07 GB -> 0.32 ms at 3.35 TB/s).  TF32 would break the rtol=1e-5
parity the reference holds, so the kernel scores in FP32 FMA; the source
explains the two-pass split-bank design.

`topk_mips_masked` dispatches by device: CPU tensors run the plain PyTorch
version `topk_mips_masked_ref`; CUDA tensors launch the kernel, or the call
raises.  `topk_mips_masked.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -2.0e38
MAX_K = 256          # the kernel's list length bound (K2 needs 256)
_ROWS_PER_TILE = 64  # must match kBN / kQT in csrc/topk_mips.cu
_QUERIES_PER_TILE = 64
_CTAS_PER_SM = 2


def topk_mips_masked_ref(queries, bank, q_ns, bank_ns, k: int = 32,
                         n_valid=None):
    """Plain PyTorch version: `einsum` scores, the namespace and `n_valid`
    masks, and a stable (score desc, id asc) sort.  Returns (scores (Q, k)
    f32, ids (Q, k) i32); a slot no live row fills is (NEG_INF, -1)."""
    s = torch.einsum("qd,nd->qn", queries.float(), bank.float())
    N = bank.shape[0]
    ok = q_ns.to(torch.int32)[:, None] == bank_ns.to(torch.int32)[None, :]
    if n_valid is not None:
        col = torch.arange(N, device=bank.device)[None, :]
        ok = ok & (col < int(n_valid))
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    s, idx = torch.sort(s, dim=1, descending=True, stable=True)
    kk = min(k, N)
    s, idx = s[:, :kk], idx[:, :kk].to(torch.int32)
    idx = torch.where(s > NEG_INF / 2, idx, torch.full_like(idx, -1))
    if kk < k:
        pad = k - kk
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    return s, idx


def _check(name, t, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, queries on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype}, kernel takes {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def plan_chunks(n_valid: int, Q: int, sms: int):
    """Split the live prefix into row chunks (whole tiles) so that the
    (chunk, query-tile) grid covers every SM about twice.  Returns
    (n_chunks, rows_per_chunk); (0, 64) for an empty prefix."""
    tiles = -(-n_valid // _ROWS_PER_TILE)
    if tiles == 0:
        return 0, _ROWS_PER_TILE
    q_tiles = -(-Q // _QUERIES_PER_TILE)
    chunks = min(tiles, max(1, _CTAS_PER_SM * sms // q_tiles))
    per = -(-tiles // chunks)
    return -(-tiles // per), per * _ROWS_PER_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point of the built kernel library, with its signature."""
    from repro_torch.kernels.build import load
    fn = load("topk_mips").topk_mips_masked_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p, p, p, p]
    fn.restype = i
    return fn


def topk_mips_masked(queries, bank, q_ns, bank_ns, k: int = 32, *,
                     n_valid=None):
    """queries (Q, D) f32, bank (N, D) f32, q_ns (Q,) i32, bank_ns (N,) i32
    -> (scores (Q, k) f32, ids (Q, k) i32).  `n_valid` (default N) bounds
    the live prefix of a capacity-padded bank.  1 <= k <= MAX_K."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    device = queries.device
    if device.type == "cpu":
        return topk_mips_masked_ref(queries, bank, q_ns, bank_ns, k=k,
                                    n_valid=n_valid)
    if device.type != "cuda":
        raise ValueError(f"topk_mips_masked: unsupported device {device}")
    _check("queries", queries, torch.float32, 2, device)
    _check("bank", bank, torch.float32, 2, device)
    _check("q_ns", q_ns, torch.int32, 1, device)
    _check("bank_ns", bank_ns, torch.int32, 1, device)
    Q, D = queries.shape
    N = bank.shape[0]
    if bank.shape[1] != D:
        raise ValueError(f"bank width {bank.shape[1]} != query width {D}")
    if q_ns.shape[0] != Q or bank_ns.shape[0] != N:
        raise ValueError("q_ns / bank_ns lengths must match queries / bank")
    nv = N if n_valid is None else int(n_valid)
    if not 0 <= nv <= N:
        raise ValueError(f"n_valid={nv} outside [0, {N}]")
    if N >= 2**31 or Q >= 2**31:
        raise ValueError("the kernel indexes rows and queries with int32")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=device)
    if Q == 0:
        return out_s, out_i
    launch = _launcher()
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    n_chunks, rows_per_chunk = plan_chunks(nv, Q, _sm_count(index))
    part = max(1, Q * n_chunks * k)
    part_s = torch.empty((part,), dtype=torch.float32, device=device)
    part_r = torch.empty((part,), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    p = ctypes.c_void_p
    rc = launch(
        p(queries.data_ptr()), p(bank.data_ptr()), p(q_ns.data_ptr()),
        p(bank_ns.data_ptr()), Q, D, nv, k, n_chunks, rows_per_chunk,
        p(part_s.data_ptr()), p(part_r.data_ptr()), p(out_s.data_ptr()),
        p(out_i.data_ptr()), p(stream))
    if rc != 0:
        raise RuntimeError(f"topk_mips kernel launch failed: CUDA error {rc}")
    topk_mips_masked.launches += 1
    return out_s, out_i


topk_mips_masked.launches = 0
