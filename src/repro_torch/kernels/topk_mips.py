"""Exact top-k MIPS over the Memori triple bank (kernels K1-K4).

Replaces the reference's four Pallas TPU kernels in
src/repro/kernels/topk_mips.py with hand-written CUDA in
`csrc/topk_mips.cu`:

  topk_mips_masked        K1  `_kernel_masked` + `_merge_topk` (call :227)
  topk_mips_quant_masked  K2  `_kernel_quant_masked`           (call :227)
  topk_mips               K3  `_kernel`                        (call :210)
  topk_mips_quant         K4  `_kernel_quant`                  (call :210)

Each returns the exact top-k of queries . bankᵀ over the rows
`r < n_valid` (the masked pair: only rows whose label `bank_ns[r]` equals
the query's `q_ns[q]`), ranked by (score desc, row asc); an unfilled slot
is (NEG_INF, -1).  The quantized pair takes an int8 bank with per-row f32
scales and scores `(q . float(codes[r])) * scales[r]` in that order.

What bounds them on an H100.  Unmasked: the plain-FP32 product, 2·Q·N·D
flops (34.4 GFLOP -> 0.51 ms at 67 TFLOP/s for Q=64, N=2²⁰, D=256), ahead
of the bank read (f32: 1.07 GB -> 0.32 ms; int8: 0.28 GB -> 0.08 ms at
3.35 TB/s).  An int8 bank moves a quarter of the bytes for the same
operations.  TF32 would break the rtol=1e-5 parity the reference holds,
so the kernels score in FP32 FMA.  Masked: only the rows a query tile's
namespaces own, which a device-side label compaction lists ahead of the
scan (`masked_work` counts the least work of a masked call).  All four
run one design, the scan kernel over a split bank and a merge of the
chunks' lists (the source explains it).  1 <= k <= MAX_K = 2048 on every
device.

Every wrapper dispatches by device: CPU tensors run its plain PyTorch
version (`*_ref` below); CUDA tensors launch the kernel, or the call
raises.  Each wrapper's `.launches` counts its kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.common.utils import sm_count
from repro_torch.kernels import count_launch

NEG_INF = -2.0e38
MAX_K = 2048         # the scan kernel's list length bound (kScanMaxK)
_TILE_ROWS = 256     # the scan kernel's kTileRows, kSlice, kSliceStride, kBuf,
_SLICE = 16          # kIdBufs
_SLICE_STRIDE = 20
_BUF = 64
_ID_BUFS = 3
SMEM_PER_BLOCK = 232448  # H100: dynamic shared memory one block can use
_SMEM_PER_SM = 233472   # H100: 228 KB of shared memory per SM
_SMEM_PER_CTA = 1024    # reserved by the system for each resident CTA


# -- plain PyTorch versions ---------------------------------------------------

def _select(s, ok, k: int):
    """Masked scores -> top-k by a stable (score desc, id asc) sort; a slot
    no live row fills is (NEG_INF, -1)."""
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    s, idx = torch.sort(s, dim=1, descending=True, stable=True)
    kk = min(k, s.shape[1])
    s, idx = s[:, :kk], idx[:, :kk].to(torch.int32)
    idx = torch.where(s > NEG_INF / 2, idx, torch.full_like(idx, -1))
    if kk < k:
        pad = k - kk
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    return s, idx


def _live(Q: int, N: int, n_valid, device):
    col = torch.arange(N, device=device)[None, :]
    bound = N if n_valid is None else int(n_valid)
    return (col < bound).expand(Q, N)


def _labels_match(q_ns, bank_ns):
    return q_ns.to(torch.int32)[:, None] == bank_ns.to(torch.int32)[None, :]


def masked_work(q_ns, bank_ns, n_valid=None):
    """The least work of a masked top-k on these labels: (rows, pairs) --
    the live rows whose label equals some query's (each read once), and
    the matching (query, live row) pairs (one dot product each).  Runs on
    the labels' device."""
    live = bank_ns[: bank_ns.shape[0] if n_valid is None else int(n_valid)]
    live = torch.sort(live.to(torch.int64)).values
    q = q_ns.to(torch.int64)
    rows = int(torch.isin(live, q).sum())
    pairs = int((torch.searchsorted(live, q, right=True)
                 - torch.searchsorted(live, q)).sum())
    return rows, pairs


def _quant_scores(queries, bank_i8, scales):
    """(Q, N) scores in the kernels' order: contract the int8 codes as f32,
    THEN multiply by the row scale."""
    s = torch.einsum("qd,nd->qn", queries.float(), bank_i8.float())
    return s * scales.float()[None, :]


def topk_mips_ref(queries, bank, k: int = 32, n_valid=None):
    """Plain version of K3: `einsum` scores, the `n_valid` mask and a
    stable (score desc, id asc) sort.  Returns (scores (Q, k) f32, ids
    (Q, k) i32)."""
    s = torch.einsum("qd,nd->qn", queries.float(), bank.float())
    return _select(s, _live(*s.shape, n_valid, s.device), k)


def topk_mips_masked_ref(queries, bank, q_ns, bank_ns, k: int = 32,
                         n_valid=None):
    """Plain version of K1: K3's scores, also masked to the rows whose
    label equals the query's."""
    s = torch.einsum("qd,nd->qn", queries.float(), bank.float())
    ok = _labels_match(q_ns, bank_ns) & _live(*s.shape, n_valid, s.device)
    return _select(s, ok, k)


def topk_mips_quant_ref(queries, bank_i8, scales, k: int = 32, n_valid=None):
    """Plain version of K4: top-k of (q . codes) * scale over an int8
    bank."""
    s = _quant_scores(queries, bank_i8, scales)
    return _select(s, _live(*s.shape, n_valid, s.device), k)


def topk_mips_quant_masked_ref(queries, bank_i8, scales, q_ns, bank_ns,
                               k: int = 32, n_valid=None):
    """Plain version of K2: K4's scores, masked by label as K1."""
    s = _quant_scores(queries, bank_i8, scales)
    ok = _labels_match(q_ns, bank_ns) & _live(*s.shape, n_valid, s.device)
    return _select(s, ok, k)


def quantize_rows_ref(bank):
    """Symmetric per-row int8 quantization (the contract the quantized
    kernels score against): scale = max|row| / 127, codes =
    round-half-even(row / scale) clipped to [-127, 127]; an all-zero row
    gets scale 0 and zero codes.  Returns (codes int8 (N, D), scales f32
    (N,)), bit-identical to `core.vector_index.quantize_rows_np`."""
    bank = bank.float()
    if bank.shape[1] == 0:
        return (torch.zeros(bank.shape, dtype=torch.int8, device=bank.device),
                torch.zeros(bank.shape[:1], device=bank.device))
    scale = bank.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    inv = torch.where(scale > 0, 1.0 / safe, torch.zeros_like(scale))
    codes = torch.clamp(torch.round(bank * inv[:, None]), -127, 127)
    return codes.to(torch.int8), scale


# -- the CUDA kernels ---------------------------------------------------------

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


def _padded_depth(D: int) -> int:
    return -(-D // _SLICE) * _SLICE + 4


def scan_smem_bytes(k: int, quant: bool, D: int, queries: int,
                    resident: bool, masked: bool) -> int:
    """The scan kernel's dynamic shared memory for a tile of `queries`
    queries, as `scan_smem_bytes` in csrc/topk_mips.cu: a 3-stage ring of
    256-row x 16-deep bank slices (int8 raw, f32 with a 20-float row
    stride) plus the queries' slice unless they are resident, the int8
    conversion tile, the resident queries, 8-byte entries of the lists,
    the candidate buffers and a tile's scratch for each of the 8 warps,
    and (masked) three tiles' row ids."""
    bank_stage = _TILE_ROWS * _SLICE if quant else 4 * _TILE_ROWS * _SLICE_STRIDE
    q_stage = 0 if resident else 4 * queries * _SLICE_STRIDE
    conv = 4 * _TILE_ROWS * _SLICE_STRIDE if quant else 0
    qres = 4 * queries * _padded_depth(D) if resident else 0
    ids = 4 * _ID_BUFS * _TILE_ROWS if masked else 0
    return (3 * (bank_stage + q_stage) + conv + qres
            + 8 * (queries * (k + _BUF) + 8 * _TILE_ROWS) + 8 + ids)


def scan_tile(k: int, quant: bool, D: int, masked: bool):
    """The scan kernel's query tile: the widest of 64, 32, 16, 8 queries
    whose lists, buffers and ring fit in a block's shared memory, and
    whether its queries fit too (resident for the whole CTA).  Returns
    (queries, resident)."""
    for queries in (64, 32, 16, 8):
        if scan_smem_bytes(k, quant, D, queries, False,
                           masked) <= SMEM_PER_BLOCK:
            return queries, scan_smem_bytes(k, quant, D, queries, True,
                                            masked) <= SMEM_PER_BLOCK
    raise ValueError(f"k={k}: no query tile fits in shared memory")


def plan_chunks(n_valid: int, Q: int, sms: int, k: int, masked: bool,
                quant: bool, D: int):
    """Split the live prefix's 256-row tiles into chunks so that the
    (chunk, query-tile) grid fills every SM with as many CTAs as its
    shared memory holds (at most two).  Chunk c of C scans the tiles
    [c·T/C, (c+1)·T/C) of its T tiles: the live prefix's, or for a masked
    call the tiles of its query tile's compacted rows (at most as many,
    counted on the device).  Returns (n_chunks, rows_per_chunk), the
    longest chunk of the live prefix; (0, 256) for an empty prefix."""
    queries, resident = scan_tile(k, quant, D, masked)
    smem = scan_smem_bytes(k, quant, D, queries, resident, masked)
    tiles = -(-n_valid // _TILE_ROWS)
    if tiles == 0:
        return 0, _TILE_ROWS
    per_sm = _SMEM_PER_SM // (smem + _SMEM_PER_CTA)
    ctas_per_sm = max(1, min(2, per_sm))
    q_tiles = -(-Q // queries)
    chunks = min(tiles, -(-ctas_per_sm * sms // q_tiles))
    return chunks, -(-tiles // chunks) * _TILE_ROWS


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library, with its C signatures set."""
    from repro_torch.kernels.build import load
    lib = load("topk_mips")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_mips_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                     p, p, p, p, p]
    lib.topk_mips_launch.restype = i
    lib.topk_mips_scratch_ints.argtypes = [i, i, i, i, i, i, i]
    lib.topk_mips_scratch_ints.restype = ctypes.c_size_t
    lib.topk_mips_scan_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.topk_mips_scan_smem_bytes.restype = ctypes.c_size_t
    lib.topk_mips_scan_tile.argtypes = [i, i, i, i]
    lib.topk_mips_scan_tile.restype = i
    lib.topk_mips_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.topk_mips_occupancy.restype = i
    for k in (1, 64, 256, 257, MAX_K):
        for quant in (False, True):
            for masked in (False, True):
                for D in (24, 256, 1000):
                    queries, resident = scan_tile(k, quant, D, masked)
                    if (lib.topk_mips_scan_tile(k, int(quant), D,
                                                int(masked)) !=
                            2 * queries + int(resident) or
                            lib.topk_mips_scan_smem_bytes(
                                k, int(quant), D, queries, int(resident),
                                int(masked)) !=
                            scan_smem_bytes(k, quant, D, queries, resident,
                                            masked)):
                        raise RuntimeError("scan_tile / scan_smem_bytes are "
                                           "out of step with "
                                           "csrc/topk_mips.cu")
    return lib


def occupancy(fn, k: int, D: int) -> int:
    """Resident pass-1 CTAs per SM of the kernel that wrapper `fn` launches
    at list length k and width D (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    masked, quant = "masked" in fn.__name__, "quant" in fn.__name__
    out = ctypes.c_int(0)
    rc = _library().topk_mips_occupancy(int(masked), int(quant), k, D,
                                        ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return out.value


def _launch(fn, queries, bank, scales, q_ns, bank_ns, k, n_valid):
    """Check the operands and launch the kernel behind wrapper `fn`, adding
    one to its count; returns (scores (Q, k) f32, ids (Q, k) i32) on the
    queries' device."""
    name = fn.__name__
    device = queries.device
    masked, quant = q_ns is not None, scales is not None
    _check("queries", queries, torch.float32, 2, device)
    _check("bank", bank, torch.int8 if quant else torch.float32, 2, device)
    if quant:
        _check("scales", scales, torch.float32, 1, device)
    if masked:
        _check("q_ns", q_ns, torch.int32, 1, device)
        _check("bank_ns", bank_ns, torch.int32, 1, device)
    Q, D = queries.shape
    N = bank.shape[0]
    if bank.shape[1] != D:
        raise ValueError(f"bank width {bank.shape[1]} != query width {D}")
    if quant and scales.shape[0] != N:
        raise ValueError(f"{scales.shape[0]} scales for {N} bank rows")
    if masked and (q_ns.shape[0] != Q or bank_ns.shape[0] != N):
        raise ValueError("q_ns / bank_ns lengths must match queries / bank")
    nv = N if n_valid is None else int(n_valid)
    if not 0 <= nv <= N:
        raise ValueError(f"n_valid={nv} outside [0, {N}]")
    if N >= 2**31 or Q >= 2**31:
        raise ValueError(f"{name}: the kernel indexes rows and queries "
                         "with int32")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=device)
    if Q == 0:
        return out_s, out_i
    lib = _library()
    n_chunks, _ = plan_chunks(nv, Q, sm_count(device), k, masked, quant, D)
    part = Q * n_chunks * k    # the chunk lists
    # part_r: the lists' rows, then the score floors and (masked) the
    # compacted row lists
    scratch = lib.topk_mips_scratch_ints(Q, D, nv, k, int(masked),
                                         int(quant), n_chunks)
    part_s = torch.empty((max(1, part),), dtype=torch.float32, device=device)
    part_r = torch.empty((scratch,), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    rc = lib.topk_mips_launch(
        ptr(queries), ptr(bank), ptr(scales), ptr(q_ns), ptr(bank_ns), Q, D,
        nv, k, int(masked), int(quant), n_chunks, ptr(part_s), ptr(part_r), ptr(out_s), ptr(out_i),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    count_launch(fn)
    return out_s, out_i


def _dispatch(fn, ref, queries, bank, scales, q_ns, bank_ns, k, n_valid):
    """CPU tensors -> the plain version; CUDA tensors -> the kernel."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{fn.__name__}: k={k} outside [1, MAX_K={MAX_K}]")
    device = queries.device
    if device.type == "cpu":
        return ref()
    if device.type != "cuda":
        raise ValueError(f"{fn.__name__}: unsupported device {device}")
    return _launch(fn, queries, bank, scales, q_ns, bank_ns, k, n_valid)


def topk_mips(queries, bank, k: int = 32, *, n_valid=None):
    """K3.  queries (Q, D) f32, bank (N, D) f32 -> (scores (Q, k) f32, ids
    (Q, k) i32).  `n_valid` (default N) bounds the live prefix of a
    capacity-padded bank.  1 <= k <= MAX_K."""
    return _dispatch(topk_mips, lambda: topk_mips_ref(
        queries, bank, k=k, n_valid=n_valid), queries, bank, None, None,
        None, k, n_valid)


def topk_mips_masked(queries, bank, q_ns, bank_ns, k: int = 32, *,
                     n_valid=None):
    """K1.  As `topk_mips`, with q_ns (Q,) i32 and bank_ns (N,) i32: only
    rows labelled with the query's namespace match."""
    return _dispatch(topk_mips_masked, lambda: topk_mips_masked_ref(
        queries, bank, q_ns, bank_ns, k=k, n_valid=n_valid), queries, bank,
        None, q_ns, bank_ns, k, n_valid)


def topk_mips_quant(queries, bank_i8, scales, k: int = 32, *, n_valid=None):
    """K4.  As `topk_mips` over an int8 bank (N, D) with per-row f32
    scales (N,): score = (q . codes) * scale."""
    return _dispatch(topk_mips_quant, lambda: topk_mips_quant_ref(
        queries, bank_i8, scales, k=k, n_valid=n_valid), queries, bank_i8,
        scales, None, None, k, n_valid)


def topk_mips_quant_masked(queries, bank_i8, scales, q_ns, bank_ns,
                           k: int = 32, *, n_valid=None):
    """K2.  `topk_mips_quant` with K1's namespace mask."""
    return _dispatch(topk_mips_quant_masked, lambda:
                    topk_mips_quant_masked_ref(queries, bank_i8, scales, q_ns,
                                               bank_ns, k=k, n_valid=n_valid),
                    queries, bank_i8, scales, q_ns, bank_ns, k, n_valid)


KERNELS = (topk_mips, topk_mips_masked, topk_mips_quant,
           topk_mips_quant_masked)
for _fn in KERNELS:
    _fn.launches = 0
