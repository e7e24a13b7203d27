"""Exact-MIPS vector index over a device-resident f32 bank.

The packed bank and the per-row effective namespace labels (namespace id
for live rows, -1 for tombstones and unfilled capacity) live in
capacity-doubling device buffers.  `add` / `delete` / `compact` update them
in place (`_dev_*` below: slice assignment and `index_fill_` into the same
storage), so a steady-state
search moves no bank bytes host->device and the buffers are reallocated
only when an append crosses a power-of-two capacity.  The live row count
goes to the kernel as `n_valid`.  A host mirror is kept for snapshot and
compaction and as the plain-numpy source of truth (`bank`, `alive()`).

Every search is one namespace-masked top-k (kernels/topk_mips.py): the
hand-written CUDA kernel for a bank on the card, its plain PyTorch version
for a bank on the CPU.  Exact search is the paper's call: Advanced
Augmentation compresses dialogue into triples, so the bank stays small
enough that exact MIPS at full memory bandwidth beats approximate indexes.
`search_host` answers the same masked search exactly from the host mirror.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.common.utils import next_pow2, resolve_device, to_device
from repro_torch.kernels.topk_mips import topk_mips_masked


# -- in-place device updates -------------------------------------------------

def _dev_append(bank, labels, vecs, ns, start: int) -> None:
    """Write `vecs` rows + `ns` labels at [start, start+m) in place."""
    m = vecs.shape[0]
    bank[start: start + m] = vecs
    labels[start: start + m] = ns


def _dev_delete(bank, labels, ids) -> None:
    """Tombstone rows in place: zero the vectors, set the labels to -1."""
    bank.index_fill_(0, ids, 0.0)
    labels.index_fill_(0, ids, -1)


def _dev_compact(bank, labels, keep, n_new: int) -> None:
    """Repack live rows in place: new row r takes old row `keep[r]` for
    r < n_new; the tail is zeroed / labelled -1.  The buffers keep their
    storage and capacity."""
    bank[:n_new] = bank.index_select(0, keep)
    labels[:n_new] = labels.index_select(0, keep)
    bank[n_new:] = 0.0
    labels[n_new:] = -1


def _search_device(bank, labels, queries, q_ns, n_valid: int, *, k: int,
                   uniform: bool):
    """One masked top-k over the padded device bank.  With `uniform` the
    namespace structure is collapsed (any live row matches: the
    single-tenant search).  Empty slots come back as (-inf, -1)."""
    bank_ns = (torch.where(labels >= 0, 0, -1).to(torch.int32) if uniform
               else labels)
    s, i = topk_mips_masked(queries, bank, q_ns, bank_ns, k=k,
                            n_valid=n_valid)
    return torch.where(i >= 0, s, torch.full_like(s, -float("inf"))), i


def _next_capacity(n: int, floor: int = 64) -> int:
    return max(floor, next_pow2(n))


class VectorIndex:
    def __init__(self, dim: int, capacity: int = 1024, device="cuda"):
        self.dim = dim
        self.device = resolve_device(device)
        self.n = 0
        self._n_dead = 0                 # O(1) tombstone counter
        capacity = _next_capacity(capacity)
        # host mirror: source of truth for snapshot/compact and numpy readers
        self._bank = np.zeros((capacity, dim), np.float32)
        self._alive = np.ones((capacity,), bool)
        self._ns = np.zeros((capacity,), np.int32)   # raw per-row labels
        # device buffers (lazily materialized, then updated in place)
        self._bank_dev = None
        self._labels_dev = None

    # -- device residency ---------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._bank.shape[0]

    def _effective_labels(self) -> np.ndarray:
        """(capacity,) i32: ns label for live rows in [0, n)."""
        eff = np.full((self.capacity,), -1, np.int32)
        m = self.n
        eff[:m] = np.where(self._alive[:m], self._ns[:m], -1)
        return eff

    def _invalidate_device(self) -> None:
        self._bank_dev = None
        self._labels_dev = None

    def _ensure_device(self) -> None:
        """Upload the device buffers from the host mirror: on the first
        search and after a capacity change or a bulk load only."""
        if self._bank_dev is None:
            self._bank_dev = to_device(self._bank, self.device)
            self._labels_dev = to_device(self._effective_labels(),
                                         self.device)

    def row_labels_device(self) -> torch.Tensor:
        """(capacity,) i32 device tensor of effective namespace labels (the
        live cached buffer — read-only for callers, and only valid until
        the next write)."""
        self._ensure_device()
        return self._labels_dev

    def _ids_dev(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(
            self.device)

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
            self._bank, self._alive, self._ns = bank, alive, labels
            self._invalidate_device()     # re-upload once per doubling
        ids = np.arange(self.n, self.n + m)
        self._bank[self.n: self.n + m] = vecs
        self._alive[self.n: self.n + m] = True
        self._ns[self.n: self.n + m] = ns_rows
        if self._bank_dev is not None and m:
            if vecs_dev is None:
                vecs_dev = torch.from_numpy(vecs).to(self.device)
            _dev_append(self._bank_dev, self._labels_dev, vecs_dev,
                        torch.from_numpy(ns_rows).to(self.device), self.n)
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
            _dev_delete(self._bank_dev, self._labels_dev, self._ids_dev(ids))
        return int(ids.size)

    def compact(self) -> np.ndarray:
        """Physically drop tombstoned rows, repacking the bank.  Returns the
        old→new row id mapping as an (n_old,) int64 array (-1 for dropped
        rows); kept rows keep their relative order.  Capacity is sticky and
        the device buffers are repacked in place."""
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
        self._bank = bank
        self._alive = np.ones((cap,), bool)
        self._ns = labels
        self.n = n_new
        self._n_dead = 0
        if self._bank_dev is not None:
            _dev_compact(self._bank_dev, self._labels_dev,
                         self._ids_dev(keep), n_new)
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
        self.n = n
        self._n_dead = n - int(self._alive[:n].sum())
        self._invalidate_device()

    def search_host(self, queries, q_ns, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side masked exact search over the host mirror.  Pure numpy: exact f32 scores, same (-inf, -1)
        fill contract as the device searches."""
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
        s = np.where(ok, s, -np.inf)
        kk = min(k, m)
        part = np.argpartition(-s, kk - 1, axis=1)[:, :kk]
        ps = np.take_along_axis(s, part, axis=1)
        order = np.argsort(-ps, axis=1, kind="stable")
        idx = np.take_along_axis(part, order, axis=1).astype(np.int64)
        scs = np.take_along_axis(ps, order, axis=1).astype(np.float32)
        idx = np.where(np.isfinite(scs), idx, -1)
        if kk < k:
            scs = np.pad(scs, ((0, 0), (0, k - kk)),
                         constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, k - kk)), constant_values=-1)
        return scs, idx

    # -- reads ---------------------------------------------------------------
    def _empty(self, Q: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        return (np.full((Q, k), -np.inf, np.float32),
                np.full((Q, k), -1, np.int64))

    def _queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        return (q[None] if q.dim() == 1 else q).contiguous()

    def _q_ns(self, q_ns) -> torch.Tensor:
        return torch.as_tensor(q_ns, dtype=torch.int32).to(
            self.device).contiguous()

    def _run_search(self, queries, q_ns, k: int, labels=None,
                    uniform: bool = False):
        """Shared path of every search flavour: clamp k to the padded
        capacity and run one masked top-k over the device bank.
        `labels=None` uses the cached device labels."""
        self._ensure_device()
        if labels is None:
            labels = self._labels_dev
        kk = min(k, self.capacity)
        s, i = _search_device(self._bank_dev, labels, queries, q_ns, self.n,
                              k=kk, uniform=uniform)
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
        tombstoned rows are masked regardless of their label.
        Only the (capacity,) label vector is uploaded."""
        queries = self._queries(queries)
        Q = queries.shape[0]
        if self.n == 0 or self.n_alive == 0:
            return self._empty(Q, k)
        row_ns = np.asarray(row_ns, np.int32)
        if row_ns.shape != (self.n,):
            raise ValueError(f"row_ns shape {row_ns.shape} != ({self.n},)")
        eff = np.full((self.capacity,), -1, np.int32)
        eff[: self.n] = np.where(self._alive[: self.n], row_ns, -1)
        s, i, kk = self._run_search(queries, self._q_ns(q_ns), k,
                                    labels=torch.from_numpy(eff).to(
                                        self.device))
        return self._to_host(s, i, k, kk)


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
