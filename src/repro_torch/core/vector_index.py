"""Exact-MIPS vector index over a device-resident bank.

The packed bank and the per-row effective namespace labels (namespace id
for live resident rows, -1 for tombstones, demoted rows and unfilled
capacity) live in capacity-doubling device buffers.  `add` / `delete` /
`compact` / `demote_rows` / `promote_rows` update them in place (`_dev_*`
below: slice assignment, `index_fill_` and `index_copy_` into the same
storage), so a steady-state search moves no bank bytes host->device and the
buffers are reallocated only when an append crosses a power-of-two
capacity.  The live row count goes to the kernel as `n_valid`.  A host
mirror is kept for snapshot and compaction and as the plain-numpy source
of truth (`bank`, `alive()`).

Every search is one namespace-masked top-k (kernels/topk_mips.py): the
hand-written CUDA kernel for a bank on the card, its plain PyTorch version
for a bank on the CPU.  Exact search is the paper's call: Advanced
Augmentation compresses dialogue into triples, so the bank stays small
enough that exact MIPS at full memory bandwidth beats approximate indexes.
`search_host` answers the same masked search exactly from the host mirror.

**Quantized residency** (`quantize="int8"`): the f32 host mirror stays
the bit-exact ground truth (snapshots and compaction read it), while the
DEVICE buffers become int8 codes plus per-row f32 scales — a quarter of
the bank's device memory and of its bytes per search, scanned by the
quantized masked kernel (K2).  Appends and promotions quantize their rows
on the host (`quantize_rows_np`, symmetric per row: scale = max|row|/127).
Every search over-fetches `rescore`x the requested k from the int8 bank,
copies those candidate ids to the host, gathers the candidates' f32 rows
from the mirror and re-ranks them by exact score (`_rescore_exact`), so
the returned scores are exact and quantization costs recall only when a
true top-k row falls outside the candidate pool.

**Tiered residency** (`demote_rows` / `promote_rows`): a row is resident
(searchable on the device) or demoted (device slot zeroed and labelled -1,
the full-precision truth still in the host mirror — the warm tier).
core/tiering.py's TierManager demotes cold namespaces and promotes them
back; `search_host` is the host-side fallback for queries whose namespace
is demoted.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.common.utils import (next_pow2, resolve_device, to_device,
                                      upload)
from repro_torch.kernels.topk_mips import (NEG_INF, topk_mips,
                                           topk_mips_masked,
                                           topk_mips_quant_masked)


# -- in-place device updates -------------------------------------------------
# f32 mode keeps (bank, labels); int8 mode keeps (codes, scales, labels).

def _dev_append(bank, labels, vecs, ns, start: int) -> None:
    """Write `vecs` rows + `ns` labels at [start, start+m) in place."""
    m = vecs.shape[0]
    bank[start: start + m] = vecs
    labels[start: start + m] = ns


def _dev_delete(bank, labels, ids) -> None:
    """Tombstone (or demote) rows in place: zero the vectors, set the
    labels to -1."""
    bank.index_fill_(0, ids, 0)
    labels.index_fill_(0, ids, -1)


def _dev_compact(bank, labels, keep, n_new: int) -> None:
    """Repack live rows in place: new row r takes old row `keep[r]` for
    r < n_new; the tail is zeroed / labelled -1.  The buffers keep their
    storage and capacity."""
    bank[:n_new] = bank.index_select(0, keep)
    labels[:n_new] = labels.index_select(0, keep)
    bank[n_new:] = 0
    labels[n_new:] = -1


def _dev_restore(bank, labels, ids, vecs, ns) -> None:
    """Scatter rows + labels back into their slots (tier promotion)."""
    bank.index_copy_(0, ids, vecs)
    labels.index_copy_(0, ids, ns)


def _dev_append_q(bank, scales, labels, codes, sc, ns, start: int) -> None:
    _dev_append(bank, labels, codes, ns, start)
    scales[start: start + codes.shape[0]] = sc


def _dev_delete_q(bank, scales, labels, ids) -> None:
    _dev_delete(bank, labels, ids)
    scales.index_fill_(0, ids, 0.0)


def _dev_compact_q(bank, scales, labels, keep, n_new: int) -> None:
    _dev_compact(bank, labels, keep, n_new)
    scales[:n_new] = scales.index_select(0, keep)
    scales[n_new:] = 0.0


def _dev_restore_q(bank, scales, labels, ids, codes, sc, ns) -> None:
    _dev_restore(bank, labels, ids, codes, ns)
    scales.index_copy_(0, ids, sc)


def quantize_rows_np(vecs: np.ndarray):
    """Symmetric per-row int8 quantization on the host (append/promote-time;
    rows are few, the bank-wide pass happens once per materialization).
    Matches `kernels/ref.quantize_rows_ref` bit-exactly: scale =
    max|row|/127, codes = round-half-even(row/scale) in [-127, 127]; an
    all-zero row keeps scale 0 and zero codes."""
    vecs = np.asarray(vecs, np.float32)
    amax = np.max(np.abs(vecs), axis=1) if vecs.size else \
        np.zeros((vecs.shape[0],), np.float32)
    scale = (amax / np.float32(127.0)).astype(np.float32)
    inv = np.where(scale > 0, np.float32(1.0) /
                   np.where(scale > 0, scale, 1), 0).astype(np.float32)
    codes = np.clip(np.rint(vecs * inv[:, None]), -127, 127).astype(np.int8)
    return codes, scale


def _uniform(labels, uniform: bool):
    """With `uniform` the namespace structure is collapsed: any live row
    matches (the single-tenant search)."""
    return (torch.where(labels >= 0, 0, -1).to(torch.int32) if uniform
            else labels)


def _search_device(bank, labels, queries, q_ns, n_valid: int, *, k: int,
                   uniform: bool):
    """One masked top-k over the padded f32 device bank.  Empty slots come
    back as (-inf, -1)."""
    s, i = topk_mips_masked(queries, bank, q_ns, _uniform(labels, uniform),
                            k=k, n_valid=n_valid)
    return torch.where(i >= 0, s, torch.full_like(s, -float("inf"))), i


def _search_device_quant(bank_i8, scales, labels, queries, q_ns,
                         n_valid: int, *, k: int, uniform: bool):
    """The int8 twin of `_search_device`: one quantized masked top-k (K2)
    over the code bank; empty slots are (-inf, -1)."""
    s, i = topk_mips_quant_masked(queries, bank_i8, scales, q_ns,
                                  _uniform(labels, uniform), k=k,
                                  n_valid=n_valid)
    return torch.where(i >= 0, s, torch.full_like(s, -float("inf"))), i


def _rescore_exact(queries, cand_rows, cand_ids, *, k: int):
    """Exact f32 re-rank of the quantized candidates: `cand_rows` (Q, C, D)
    are the candidates' full-precision rows gathered from the host mirror,
    `cand_ids` (Q, C) their bank ids (-1 = empty slot).  Returns the top-k
    by exact score, (-inf, -1) padded; an exact tie keeps the candidates'
    order (a stable sort, as the reference's top_k)."""
    s = torch.einsum("qd,qcd->qc", queries, cand_rows)
    s = torch.where(cand_ids >= 0, s, torch.full_like(s, NEG_INF))
    top_s, pos = torch.sort(s, dim=1, descending=True, stable=True)
    top_s, pos = top_s[:, :k], pos[:, :k]
    top_i = torch.gather(cand_ids, 1, pos)
    top_i = torch.where(top_s > NEG_INF / 2, top_i, torch.full_like(top_i, -1))
    return (torch.where(top_i >= 0, top_s,
                        torch.full_like(top_s, -float("inf"))), top_i)


def _next_capacity(n: int, floor: int = 64) -> int:
    return max(floor, next_pow2(n))


class VectorIndex:
    def __init__(self, dim: int, capacity: int = 1024, device="cuda",
                 quantize: str = "none", rescore: int = 4):
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize {quantize!r} must be 'none' or "
                             "'int8'")
        if rescore < 1:
            raise ValueError("rescore must be >= 1")
        self.dim = dim
        self.device = resolve_device(device)
        self.quantize = quantize
        self.rescore = rescore           # candidate over-fetch multiplier
        self.n = 0
        self._n_dead = 0                 # O(1) tombstone counter
        capacity = _next_capacity(capacity)
        # host mirror: source of truth for snapshot/compact and numpy readers
        self._bank = np.zeros((capacity, dim), np.float32)
        self._alive = np.ones((capacity,), bool)
        self._ns = np.zeros((capacity,), np.int32)   # raw per-row labels
        # tier residency: False = demoted (device slot dead, host truth
        # intact — the warm tier).  Searches only see resident rows.
        self._resident = np.ones((capacity,), bool)
        # device buffers (lazily materialized, then updated in place);
        # int8 mode keeps (capacity, dim) codes + (capacity,) scales in
        # place of the (capacity, dim) f32 bank
        self._bank_dev = None
        self._labels_dev = None
        self._scales_dev = None
        # rescore_hits / rescore_rows is the fraction of final top-k ids the
        # quantized ordering already had in its own top-k (the "rescore hit
        # rate")
        self.counters = {"quant_searches": 0, "rescore_rows": 0,
                         "rescore_hits": 0}

    # -- device residency ---------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._bank.shape[0]

    def _effective_labels(self) -> np.ndarray:
        """(capacity,) i32: ns label for live rows in [0, n), else -1."""
        eff = np.full((self.capacity,), -1, np.int32)
        m = self.n
        eff[:m] = np.where(self._alive[:m], self._ns[:m], -1)
        return eff

    def _invalidate_device(self) -> None:
        self._bank_dev = None
        self._labels_dev = None
        self._scales_dev = None

    def _ensure_device(self) -> None:
        """Upload the device buffers from the host mirror: on the first
        search and after a capacity change or a bulk load only.  Demoted
        rows get a -1 label; int8 mode uploads codes + scales."""
        if self._bank_dev is None:
            eff = np.where(self._resident, self._effective_labels(), -1)
            if self.quantize == "none":
                self._bank_dev = to_device(self._bank, self.device)
            else:
                codes, scales = quantize_rows_np(self._bank)
                self._bank_dev = to_device(codes, self.device)
                self._scales_dev = to_device(scales, self.device)
            self._labels_dev = to_device(eff, self.device)

    def row_labels_device(self) -> torch.Tensor:
        """(capacity,) i32 device tensor of effective namespace labels (the
        live cached buffer — read-only for callers, and only valid until
        the next write)."""
        self._ensure_device()
        return self._labels_dev

    def _ids_dev(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(
            self.device)

    def _dev_kill(self, ids: np.ndarray) -> None:
        """Zero the device slots of `ids` and label them -1."""
        if self.quantize == "none":
            _dev_delete(self._bank_dev, self._labels_dev, self._ids_dev(ids))
        else:
            _dev_delete_q(self._bank_dev, self._scales_dev, self._labels_dev,
                          self._ids_dev(ids))

    # -- writes --------------------------------------------------------------
    def add(self, vecs, ns=None) -> np.ndarray:
        """Append rows.  `ns` labels the new rows' namespace (scalar or
        per-row sequence; default 0).  The device buffers are updated in
        place unless the append crosses a capacity boundary."""
        if isinstance(vecs, torch.Tensor):
            vecs_dev = vecs.to(self.device, torch.float32)
            vecs = vecs_dev.cpu().numpy()
        else:
            vecs = np.asarray(vecs, np.float32)
            vecs_dev = None
        if vecs.ndim == 1:
            vecs = vecs[None]
            vecs_dev = None if vecs_dev is None else vecs_dev[None]
        m = vecs.shape[0]
        if np.ndim(ns) == 0:
            ns_rows = np.full((m,), 0 if ns is None else int(ns), np.int32)
        else:
            ns_rows = np.asarray(ns, np.int32)
            if ns_rows.shape != (m,):
                raise ValueError(
                    f"{ns_rows.shape[0]} namespace labels for {m} rows")
        if self.n + m > self.capacity:
            cap = _next_capacity(self.n + m, floor=2 * self.capacity)
            bank = np.zeros((cap, self.dim), np.float32)
            bank[: self.n] = self._bank[: self.n]
            alive = np.ones((cap,), bool)
            alive[: self.n] = self._alive[: self.n]
            labels = np.zeros((cap,), np.int32)
            labels[: self.n] = self._ns[: self.n]
            resident = np.ones((cap,), bool)
            resident[: self.n] = self._resident[: self.n]
            self._bank, self._alive, self._ns = bank, alive, labels
            self._resident = resident
            self._invalidate_device()     # re-upload once per doubling
        ids = np.arange(self.n, self.n + m)
        self._bank[self.n: self.n + m] = vecs
        self._alive[self.n: self.n + m] = True
        self._ns[self.n: self.n + m] = ns_rows
        self._resident[self.n: self.n + m] = True
        if self._bank_dev is not None and m:
            ns_dev = torch.from_numpy(ns_rows).to(self.device)
            if self.quantize == "none":
                if vecs_dev is None:
                    vecs_dev = torch.from_numpy(vecs).to(self.device)
                _dev_append(self._bank_dev, self._labels_dev, vecs_dev,
                            ns_dev, self.n)
            else:
                # quantize the (few) new rows on the host; the bank-wide
                # code buffer is only ever touched in place
                codes, scales = quantize_rows_np(vecs)
                _dev_append_q(self._bank_dev, self._scales_dev,
                              self._labels_dev, to_device(codes, self.device),
                              to_device(scales, self.device), ns_dev, self.n)
        self.n += m
        return ids

    @property
    def bank(self) -> np.ndarray:
        return self._bank[: self.n]

    @property
    def n_alive(self) -> int:
        return self.n - self._n_dead

    @property
    def n_dead(self) -> int:
        return self._n_dead

    def alive(self, ids=None):
        """Liveness of `ids` (or the full (n,) mask when ids is None)."""
        if ids is None:
            return self._alive[: self.n].copy()
        return self._alive[np.asarray(ids, np.int64)]

    def row_namespaces(self) -> np.ndarray:
        """(n,) i32 raw namespace labels (host mirror; tombstones keep their
        retired label here — the effective device labels mask them)."""
        return self._ns[: self.n].copy()

    def delete(self, ids) -> int:
        """Tombstone rows: ids keep their slots (the row alignment with the
        triple store and BM25 survives) but the vectors are zeroed and the
        rows never surface from search again.  Returns #newly deleted."""
        ids = np.asarray(ids, np.int64).ravel()
        ids = ids[(ids >= 0) & (ids < self.n)]
        ids = np.unique(ids[self._alive[ids]])
        self._alive[ids] = False
        self._bank[ids] = 0.0
        self._n_dead += int(ids.size)
        if ids.size and self._bank_dev is not None:
            self._dev_kill(ids)
        return int(ids.size)

    def compact(self) -> np.ndarray:
        """Physically drop tombstoned rows, repacking the bank.  Returns the
        old→new row id mapping as an (n_old,) int64 array (-1 for dropped
        rows); kept rows keep their relative order.  Capacity is sticky and
        the device buffers are repacked in place; demoted rows stay warm."""
        n_old = self.n
        alive = self._alive[:n_old]
        old_to_new = np.full((n_old,), -1, np.int64)
        keep = np.where(alive)[0]
        old_to_new[keep] = np.arange(keep.size)
        n_new = int(keep.size)
        cap = self.capacity
        bank = np.zeros((cap, self.dim), np.float32)
        bank[:n_new] = self._bank[keep]
        labels = np.zeros((cap,), np.int32)
        labels[:n_new] = self._ns[keep]
        resident = np.ones((cap,), bool)
        resident[:n_new] = self._resident[keep]
        self._bank = bank
        self._alive = np.ones((cap,), bool)
        self._ns = labels
        self._resident = resident
        self.n = n_new
        self._n_dead = 0
        if self._bank_dev is not None:
            # the device gather carries demoted slots along as they are
            # (zeroed rows, -1 labels)
            if self.quantize == "none":
                _dev_compact(self._bank_dev, self._labels_dev,
                             self._ids_dev(keep), n_new)
            else:
                _dev_compact_q(self._bank_dev, self._scales_dev,
                               self._labels_dev, self._ids_dev(keep), n_new)
        return old_to_new

    def load_rows(self, bank, alive, ns=None) -> None:
        """Bulk-load a snapshot's rows (replaces any current content).
        `ns` carries the per-row namespace labels (default 0)."""
        bank = np.asarray(bank, np.float32)
        if bank.ndim != 2 or bank.shape[1] != self.dim:
            raise ValueError(f"bank shape {bank.shape} != (*, {self.dim})")
        n = bank.shape[0]
        cap = _next_capacity(n)
        self._bank = np.zeros((cap, self.dim), np.float32)
        self._bank[:n] = bank
        self._alive = np.ones((cap,), bool)
        self._alive[:n] = np.asarray(alive, bool)
        self._ns = np.zeros((cap,), np.int32)
        if ns is not None:
            self._ns[:n] = np.asarray(ns, np.int32)
        self._resident = np.ones((cap,), bool)   # a fresh load is all-hot
        self.n = n
        self._n_dead = n - int(self._alive[:n].sum())
        self._invalidate_device()

    # -- tiered residency (hot device rows / warm host rows) ------------------
    @property
    def n_resident(self) -> int:
        """Live rows currently searchable on the device (the hot tier)."""
        m = self.n
        return int((self._alive[:m] & self._resident[:m]).sum())

    @property
    def n_warm(self) -> int:
        """Live rows demoted to the host mirror (the warm tier)."""
        m = self.n
        return int((self._alive[:m] & ~self._resident[:m]).sum())

    def resident_mask(self) -> np.ndarray:
        """(n,) bool: True where the row is device-resident."""
        return self._resident[: self.n].copy()

    def rows_in_namespace(self, ns_id: int) -> np.ndarray:
        """Live global row ids labelled `ns_id` (host mirror scan)."""
        m = self.n
        return np.where(self._alive[:m] & (self._ns[:m] == ns_id))[0]

    def _tier_ids(self, ids, resident: bool) -> np.ndarray:
        """The distinct rows of `ids` in [0, n) whose residency is
        `resident`."""
        ids = np.asarray(ids, np.int64).ravel()
        ids = ids[(ids >= 0) & (ids < self.n)]
        return np.unique(ids[self._resident[ids] == resident])

    def demote_rows(self, ids) -> int:
        """Move rows to the warm tier: their device slots are zeroed and
        labelled -1 (they stop matching any query), while the host mirror
        is untouched, so snapshots, compaction and `promote_rows` all still
        see them.  Returns #rows newly demoted."""
        ids = self._tier_ids(ids, True)
        if not ids.size:
            return 0
        self._resident[ids] = False
        if self._bank_dev is not None:
            self._dev_kill(ids)
        return int(ids.size)

    def promote_rows(self, ids) -> int:
        """Bring warm rows back to the device: one in-place scatter of the
        rows (quantized on the host first in int8 mode) and their
        effective labels, from the host mirror.  Returns #rows promoted."""
        ids = self._tier_ids(ids, False)
        if not ids.size:
            return 0
        self._resident[ids] = True
        if self._bank_dev is not None:
            vecs = self._bank[ids]
            # rows tombstoned while warm come back as device tombstones
            ns_up = np.where(self._alive[ids], self._ns[ids],
                             -1).astype(np.int32)
            ids_dev = self._ids_dev(ids)
            ns_dev = to_device(ns_up, self.device)
            if self.quantize == "none":
                _dev_restore(self._bank_dev, self._labels_dev, ids_dev,
                             to_device(vecs, self.device), ns_dev)
            else:
                codes, scales = quantize_rows_np(vecs)
                _dev_restore_q(self._bank_dev, self._scales_dev,
                               self._labels_dev, ids_dev,
                               to_device(codes, self.device),
                               to_device(scales, self.device), ns_dev)
        return int(ids.size)

    def search_host(self, queries, q_ns, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side masked exact search over the full host mirror (hot and
        warm rows alike) — the fallback for queries whose namespace is
        demoted.  Pure numpy: exact f32 scores, same (-inf, -1) fill
        contract as the device searches, and the same ranking key (score
        desc, row asc), so a fallback orders exactly tied rows as the
        device search does.  (The reference takes the tied rows in
        `argpartition`'s order.)"""
        queries = _as_numpy(queries)
        if queries.ndim == 1:
            queries = queries[None]
        Q = queries.shape[0]
        if self.n == 0 or self.n_alive == 0:
            return self._empty(Q, k)
        m = self.n
        eff = np.where(self._alive[:m], self._ns[:m], -1)
        s = queries @ self._bank[:m].T                      # (Q, n)
        ok = np.asarray(_as_numpy(q_ns), np.int32)[:, None] == eff[None, :]
        s = np.where(ok, s, -np.inf).astype(np.float32)
        kk = min(k, m)
        kth = np.partition(s, m - kk, axis=1)[:, m - kk]    # kk-th largest
        scs, idx = self._empty(Q, k)
        for r in range(Q):
            # every live row scoring at least the kk-th score, ties included
            cand = np.flatnonzero((s[r] >= kth[r]) & np.isfinite(s[r]))
            top = cand[np.lexsort((cand, -s[r, cand]))[:kk]]
            idx[r, :top.size] = top
            scs[r, :top.size] = s[r, top]
        return scs, idx

    # -- reads ---------------------------------------------------------------
    def _empty(self, Q: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        return (np.full((Q, k), -np.inf, np.float32),
                np.full((Q, k), -1, np.int64))

    def _queries(self, queries) -> torch.Tensor:
        q = upload(queries, self.device, torch.float32)
        return (q[None] if q.dim() == 1 else q).contiguous()

    def _q_ns(self, q_ns) -> torch.Tensor:
        return upload(q_ns, self.device, torch.int32).contiguous()

    def _run_search(self, queries, q_ns, k: int, labels=None,
                    uniform: bool = False):
        """Shared path of every search flavour: clamp k to the padded
        capacity and run one masked top-k over the device bank.
        `labels=None` uses the cached device labels.

        int8 mode over-fetches `rescore`x k candidates from the code bank
        (rounded up to a power of two, any size: past the scan kernel's
        MAX_K the kernel runs its large-k path), copies their ids to the
        host, gathers their f32 rows from
        the mirror (Q·C·D·4 bytes — candidates, never the bank), uploads
        them and re-ranks by exact score (`_rescore_exact`)."""
        self._ensure_device()
        if labels is None:
            labels = self._labels_dev
        kk = min(k, self.capacity)
        if self.quantize == "none":
            s, i = _search_device(self._bank_dev, labels, queries, q_ns,
                                  self.n, k=kk, uniform=uniform)
            return s, i, kk
        kc = min(self.capacity, next_pow2(kk * self.rescore))
        _, i = _search_device_quant(self._bank_dev, self._scales_dev, labels,
                                    queries, q_ns, self.n, k=kc,
                                    uniform=uniform)
        i_host = i.cpu().numpy()                     # (Q, C) candidate ids
        cand = self._bank[np.clip(i_host, 0, self.capacity - 1)]
        s, i = _rescore_exact(queries, to_device(cand, self.device),
                              to_device(i_host, self.device), k=kk)
        self.counters["quant_searches"] += 1
        i_np = i.cpu().numpy()                       # small (Q, k) copy
        firstk = i_host[:, :kk]
        for r in range(i_np.shape[0]):
            fin = i_np[r][i_np[r] >= 0]
            self.counters["rescore_rows"] += int(fin.size)
            self.counters["rescore_hits"] += int(np.isin(fin,
                                                         firstk[r]).sum())
        return s, i, kk

    def _to_host(self, s, i, k: int, kk: int):
        s = s.cpu().numpy()
        i = i.cpu().numpy().astype(np.int64)
        if kk < k:
            s = np.pad(s, ((0, 0), (0, k - kk)), constant_values=-np.inf)
            i = np.pad(i, ((0, 0), (0, k - kk)), constant_values=-1)
        return s, i

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """queries (Q, D) -> host (scores (Q, k), ids (Q, k)); empty slots
        (rows beyond n, tombstones crowding out candidates) are (-inf, -1).
        Runs the namespace-collapsed masked search over the device bank."""
        queries = self._queries(queries)
        Q = queries.shape[0]
        if self.n == 0 or self.n_alive == 0:
            return self._empty(Q, k)
        s, i, kk = self._run_search(
            queries, torch.zeros((Q,), dtype=torch.int32, device=self.device),
            k, uniform=True)
        return self._to_host(s, i, k, kk)

    def search_batch(self, queries, q_ns, k: int):
        """The multi-tenant hot path: one masked top-k over the device bank
        with the cached device labels.  Returns DEVICE tensors (scores
        (Q, k) f32, ids (Q, k) i32); empty slots are (-inf, -1)."""
        queries = self._queries(queries)
        Q = queries.shape[0]
        if self.n == 0 or self.n_alive == 0:
            return (torch.full((Q, k), -float("inf"), device=self.device),
                    torch.full((Q, k), -1, dtype=torch.int32,
                               device=self.device))
        s, i, kk = self._run_search(queries, self._q_ns(q_ns), k)
        if kk < k:
            s = torch.nn.functional.pad(s, (0, k - kk), value=-float("inf"))
            i = torch.nn.functional.pad(i, (0, k - kk), value=-1)
        return s, i

    def search_masked(self, queries, q_ns, row_ns, k: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched multi-tenant search with caller-supplied labels: q_ns
        (Q,) is each query's namespace, row_ns (n,) labels every bank row;
        tombstoned and demoted rows are masked regardless of their label.
        Only the (capacity,) label vector is uploaded."""
        queries = self._queries(queries)
        Q = queries.shape[0]
        if self.n == 0 or self.n_alive == 0:
            return self._empty(Q, k)
        row_ns = np.asarray(row_ns, np.int32)
        if row_ns.shape != (self.n,):
            raise ValueError(f"row_ns shape {row_ns.shape} != ({self.n},)")
        eff = np.full((self.capacity,), -1, np.int32)
        ok = self._alive[: self.n] & self._resident[: self.n]
        eff[: self.n] = np.where(ok, row_ns, -1)
        s, i, kk = self._run_search(queries, self._q_ns(q_ns), k,
                                    labels=to_device(eff, self.device))
        return self._to_host(s, i, k, kk)


def _rerank(scores, ids, k: int):
    """Candidate lists concatenated in shard order -> the top k by a
    stable descending sort (ties rank by global row, as one search over the
    whole bank); an unfilled slot is (NEG_INF, -1)."""
    s_all, i_all = torch.cat(scores, dim=1), torch.cat(ids, dim=1)
    top_s, pos = torch.sort(s_all, dim=1, descending=True, stable=True)
    top_s, pos = top_s[:, :k], pos[:, :k]
    top_i = torch.gather(i_all, 1, pos)
    top_i = torch.where(top_s > NEG_INF / 2, top_i, torch.full_like(top_i, -1))
    if top_s.shape[1] < k:                 # k beyond the whole bank
        pad = k - top_s.shape[1]
        top_s = torch.nn.functional.pad(top_s, (0, pad), value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, pad), value=-1)
    return top_s, top_i


def _local_topk(queries, slab, k_local: int, offset: int, q_ns, slab_ns):
    """K1 (masked) or K3 over one slab, ids offset into global rows with
    the -1 sentinels kept."""
    if q_ns is not None:
        sc, i = topk_mips_masked(queries, slab, q_ns, slab_ns, k=k_local)
        return sc, torch.where(i >= 0, i + offset, i)
    sc, i = topk_mips(queries, slab, k=k_local)
    return sc, i + offset


def sharded_topk(queries, bank, k: int, n_shards: Optional[int] = None, *,
                 q_ns=None, bank_ns=None, mesh=None,
                 axis_names=("pod", "data", "model")):
    """Top-k over a bank of equal slabs (slab s owns rows [s*R, (s+1)*R)):
    a local top-k of `k_local = min(k, R)` on each slab — K1 with the
    slab's labels when `q_ns`/`bank_ns` are given (both or neither), K3
    otherwise —, its ids offset into global rows (-1 sentinels kept), then
    the lists concatenated in slab order and re-ranked to k by a stable
    descending sort, so ties rank by global row as in one search over the
    whole bank.  Returns (scores (Q, k) f32, ids (Q, k) i32), equal to one
    K1/K3 over the whole bank; an unfilled slot is (NEG_INF, -1).

    One device: `n_shards` slabs of `bank`, searched in turn.  On a mesh
    (`mesh=`, the reference's `sharded_topk(..., mesh, axis_names)`): one
    slab a rank, the rank at position r of the flattened `axis_names`
    order (those of the mesh's axes, in mesh order) owning rows [r*R,
    (r+1)*R) as `P(flat_axes)` lays them out; `bank`/`bank_ns` are
    DTensors sharded that way (Shard(0) over those mesh dims) or whole
    tensors (each rank reads its own rows).  Each rank runs K1/K3 on its
    slab, the (Q, k_local) lists are all-gathered over the flattened
    group in rank order, and every rank re-ranks them alike: every rank
    gets the same answer."""
    masked = q_ns is not None or bank_ns is not None
    if masked and (q_ns is None or bank_ns is None):
        raise ValueError("q_ns and bank_ns must be given together")
    if mesh is not None:
        return _sharded_topk_mesh(queries, bank, k, mesh, axis_names,
                                  q_ns, bank_ns)
    N = bank.shape[0]
    if n_shards is None or n_shards < 1 or N % n_shards:
        raise ValueError(f"{N} bank rows do not split into {n_shards} "
                         "equal shards")
    R = N // n_shards
    k_local = min(k, R)
    scores, ids = [], []
    for s in range(n_shards):
        sc, i = _local_topk(queries, bank[s * R: (s + 1) * R], k_local,
                            s * R, q_ns,
                            bank_ns[s * R: (s + 1) * R] if masked else None)
        scores.append(sc)
        ids.append(i)
    return _rerank(scores, ids, k)


def mesh_slab(mesh, axis_names=("pod", "data", "model")):
    """(position, count) of this rank among the flattened `axis_names`
    of `mesh` (row-major in mesh order), and the placements that shard
    dim 0 over them."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    flat = [i for i, a in enumerate(names) if a in axis_names]
    coord = mesh.get_coordinate()
    r, n = 0, 1
    for i in flat:
        r = r * mesh.size(i) + coord[i]
        n *= mesh.size(i)
    pl = [Shard(0) if i in flat else Replicate() for i in range(len(names))]
    return r, n, pl


def _sharded_topk_mesh(queries, bank, k, mesh, axis_names, q_ns, bank_ns):
    from torch.distributed.tensor import DTensor, Shard
    r, n, pl = mesh_slab(mesh, axis_names)
    N = bank.shape[0]
    if N % n:
        raise ValueError(f"{N} bank rows do not split over {n} ranks")
    R = N // n

    def local(x):
        if isinstance(x, DTensor):
            if tuple(x.placements) != tuple(pl):
                raise ValueError(f"bank placements {x.placements} are not "
                                 f"{pl} over {axis_names}")
            return x.to_local()
        return x[r * R: (r + 1) * R]

    masked = q_ns is not None
    sc, i = _local_topk(queries, local(bank), min(k, R), r * R, q_ns,
                        local(bank_ns) if masked else None)
    # the (Q, k_local) lists of every rank, side by side in rank order
    gl = [Shard(1) if isinstance(p, Shard) else p for p in pl]
    s_all = DTensor.from_local(sc, mesh, gl, run_check=False).full_tensor()
    i_all = DTensor.from_local(i, mesh, gl, run_check=False).full_tensor()
    return _rerank([s_all], [i_all], k)


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
