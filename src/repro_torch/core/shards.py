"""ShardedBank — shard-wise placement of the memory bank (M5).

The single-device `VectorIndex` packs rows in append order; this module
re-lays the LIVE rows out **shard-major** so that the bank splits into
per-shard slabs, searched by one namespace-masked top-k (K1).  Placement is
namespace-affine — shard = ns_id % n_shards — so a tenant's rows live
together on one shard: losing a shard degrades a known subset of tenants
instead of a random subset of every tenant's memory, and marking the shard
down is one label-slab write.

Layout: shard `s` owns the slot range `[s*C, (s+1)*C)` for a uniform pow2
per-shard capacity `C`, so the flattened `(S*C, D)` bank divides evenly
into whole shards' slabs.  On one card the slabs are views of one buffer:
the `(S*C, D)` f32 bank, the `(S*C,)` i32 labels (-1 = empty, tombstone or
down) and the `(S*C,)` i32 slot -> global row map live on the store's
device, and `search` is one K1 launch over all of them.

On a `DeviceMesh` (`mesh=`, one process per device, every rank running the
same program and so holding the same host mirrors) the slot range splits
evenly over the mesh's devices, as the reference's "bank" rules lay it
out: the rank at position r of the flattened ("pod", "data", "model")
order holds slots [r*R, (r+1)*R), R = S*C / devices, of the bank and its
labels on its own device, and uploads only those; the slot -> row map is
held whole on every rank.  Writes touch a rank's device slab only where
it owns the slot.  `search` is the meshed `sharded_topk`: K1 on each
rank's slab, the candidates all-gathered and re-ranked alike on every
rank.  `bank_device()` is then a DTensor, Shard(0) over the mesh.

Three host arrays mirror the device state: the slab-packed bank, the
per-slot namespace labels and the slot -> global row map.  Search returns
device (scores, rows): the slots K1 returns map back to global row ids
with one (Q, k) gather of the row map on the device — no copy to the host,
and the row-id space stays identical to the unsharded path.

Steady state mirrors the VectorIndex contract: appends scatter into the
live device buffers in place (`index_copy_`), deletes scatter -1 labels,
and only capacity growth or a rebuild (first search, after compaction)
uploads the bank.  A down shard is a `(C,)` fill of -1 in the label slab —
retrieval keeps answering from the surviving shards (the service stamps
those responses `degraded`); `mark_up` writes the real labels back.

Every device write runs on the stream that was current where the bank was
built (the read path's, as the lifecycle daemon and the scheduler's ticks
use it), so a write from an operator thread or an HTTP handler is ordered
against the K1 launches that read the slab.  `mark_down` records the shard
as down before its slab write and `mark_up` clears it after its slab
upload: a reader that looks at `down` before and after its launch sees the
shard down whenever its launch may have read the -1 slab.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.common.utils import (next_pow2, resolve_device, to_device,
                                      upload)
from repro_torch.core.vector_index import (_search_device, mesh_slab,
                                           sharded_topk)

MIN_SHARD_CAPACITY = 64


class ShardedBank:
    def __init__(self, dim: int, n_shards: int, mesh=None, device="cuda"):
        if n_shards < 2:
            raise ValueError("ShardedBank needs n_shards >= 2")
        self.mesh = mesh
        self.dim = dim
        self.n_shards = int(n_shards)
        self.device = resolve_device(device)
        # the stream every device write goes to (see the module docstring)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.C = MIN_SHARD_CAPACITY          # per-shard slot capacity (pow2)
        # replaced, never mutated: a reader takes it in one load
        self.down: frozenset = frozenset()
        # stale=True until rebuild(): the bank starts life re-derived from
        # the VectorIndex host mirror (the ground truth), and falls back to
        # stale after compaction re-packs the global row-id space
        self.stale = True
        self._alloc_host()
        self._slot_of_row = np.full((0,), -1, np.int64)
        self._count = np.zeros((self.n_shards,), np.int64)
        self._bank_dev = None
        self._labels_dev = None
        self._rows_dev = None
        self.counters = {"rebuilds": 0, "grows": 0, "searches": 0}

    # -- host layout ---------------------------------------------------------
    @property
    def n_slots(self) -> int:
        return self.n_shards * self.C

    def _alloc_host(self) -> None:
        self._bank_host = np.zeros((self.n_slots, self.dim), np.float32)
        self._labels_host = np.full((self.n_slots,), -1, np.int32)
        self._rows_host = np.full((self.n_slots,), -1, np.int32)

    def shard_of(self, ns_id: int) -> int:
        return int(ns_id) % self.n_shards

    def _local_range(self):
        """[lo, hi): the slots this rank's device slab holds (all of them
        with no mesh)."""
        if self.mesh is None:
            return 0, self.n_slots
        r, n, _ = mesh_slab(self.mesh)
        if self.n_slots % n:
            raise ValueError(f"{self.n_slots} slots do not divide over {n} "
                             "mesh devices")
        R = self.n_slots // n
        return r * R, (r + 1) * R

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _drop_device(self) -> None:
        self._bank_dev = None
        self._labels_dev = None
        self._rows_dev = None

    def invalidate(self) -> None:
        """Global row ids moved (compaction) — the layout must be re-derived
        from the VectorIndex before the next search."""
        self.stale = True
        self._drop_device()

    def rebuild(self, vindex) -> None:
        """Re-derive the shard-major layout from the index's host mirror:
        live rows only, packed per shard in global-row order (deterministic,
        so two replicas that replayed the same WAL lay out identically)."""
        n = vindex.n
        ns = np.asarray(vindex.row_namespaces(), np.int32)
        alive = np.asarray(vindex.alive(), bool) if n else \
            np.zeros((0,), bool)
        shard = ns % self.n_shards if n else np.zeros((0,), np.int64)
        counts = np.bincount(shard[alive], minlength=self.n_shards) if n \
            else np.zeros((self.n_shards,), np.int64)
        self.C = max(MIN_SHARD_CAPACITY,
                     next_pow2(int(counts.max()) if n else 0))
        self._alloc_host()
        self._slot_of_row = np.full((n,), -1, np.int64)
        self._count = np.zeros((self.n_shards,), np.int64)
        bank = vindex.bank
        for s in range(self.n_shards):
            rows = np.nonzero(alive & (shard == s))[0]
            cnt = rows.size
            if cnt:
                slots = s * self.C + np.arange(cnt)
                self._bank_host[slots] = bank[rows]
                self._labels_host[slots] = ns[rows]
                self._rows_host[slots] = rows
                self._slot_of_row[rows] = slots
            self._count[s] = cnt
        self.stale = False
        self._drop_device()
        self.counters["rebuilds"] += 1

    def _grow(self, need: int) -> None:
        new_c = next_pow2(int(need))
        old_c, S = self.C, self.n_shards
        old_bank, old_labels, old_rows = (self._bank_host, self._labels_host,
                                          self._rows_host)
        self.C = new_c
        self._alloc_host()
        for s in range(S):
            cnt = int(self._count[s])
            if cnt:
                self._bank_host[s * new_c: s * new_c + cnt] = \
                    old_bank[s * old_c: s * old_c + cnt]
                self._labels_host[s * new_c: s * new_c + cnt] = \
                    old_labels[s * old_c: s * old_c + cnt]
                self._rows_host[s * new_c: s * new_c + cnt] = \
                    old_rows[s * old_c: s * old_c + cnt]
        live = self._slot_of_row >= 0
        old_slots = self._slot_of_row[live]
        self._slot_of_row[live] = (old_slots // old_c) * new_c \
            + old_slots % old_c
        self._drop_device()                  # re-upload once per doubling
        self.counters["grows"] += 1

    # -- writes --------------------------------------------------------------
    def append(self, rows, vecs, ns_ids) -> None:
        """Mirror a VectorIndex append into the shard layout.  No-op while
        stale (the next rebuild sees the rows in the host mirror anyway).
        The device buffers update in place."""
        if self.stale:
            return
        rows = np.asarray(rows, np.int64).ravel()
        if rows.size == 0:
            return
        vecs = np.asarray(vecs, np.float32).reshape(rows.size, self.dim)
        ns = np.asarray(ns_ids, np.int32).ravel()
        shard = ns % self.n_shards
        need = self._count + np.bincount(shard, minlength=self.n_shards)
        if int(need.max()) > self.C:
            self._grow(int(need.max()))
        slots = np.empty((rows.size,), np.int64)
        for s in range(self.n_shards):
            m = shard == s
            cnt = int(m.sum())
            if cnt:
                slots[m] = s * self.C + int(self._count[s]) + np.arange(cnt)
                self._count[s] += cnt
        self._bank_host[slots] = vecs
        self._labels_host[slots] = ns
        self._rows_host[slots] = rows
        hi = int(rows.max()) + 1
        if hi > self._slot_of_row.shape[0]:
            grown = np.full((hi,), -1, np.int64)
            grown[: self._slot_of_row.shape[0]] = self._slot_of_row
            self._slot_of_row = grown
        self._slot_of_row[rows] = slots
        if self._bank_dev is not None:
            # a down shard's device labels stay -1 (its host truth keeps
            # accumulating; mark_up rewrites the slab)
            down = self.down
            ns_dev = np.where(np.isin(shard, list(down)), -1, ns) \
                if down else ns
            self._scatter_dev(slots, vecs, ns_dev, rows)

    def delete(self, rows) -> None:
        """Tombstone rows in the shard layout (slots are not reused — the
        next rebuild re-packs)."""
        if self.stale:
            return
        rows = np.asarray(rows, np.int64).ravel()
        rows = rows[(rows >= 0) & (rows < self._slot_of_row.shape[0])]
        slots = self._slot_of_row[rows]
        slots = slots[slots >= 0]
        if slots.size == 0:
            return
        self._bank_host[slots] = 0.0
        self._labels_host[slots] = -1
        self._rows_host[slots] = -1
        self._slot_of_row[rows] = -1
        if self._bank_dev is not None:
            with self._on_stream():
                ids, _, local = self._upload_slots(slots)
                self._rows_dev.index_fill_(0, ids, -1)
                if local is not None:
                    self._bank_dev.index_fill_(0, local, 0)
                    self._labels_dev.index_fill_(0, local, -1)

    def _upload_slots(self, slots):
        """(ids, mine, local): the slot ids on the device (for the row map,
        which every rank holds whole), the mask of the slots this rank's
        slab holds (None: all of them) and their ids within the slab (None:
        none).  Off a mesh the slab is the whole bank and `ids` serves for
        all three writes."""
        ids = to_device(slots, self.device)
        if self.mesh is None:
            return ids, None, ids
        lo, hi = self._local_range()
        mine = (slots >= lo) & (slots < hi)
        if not mine.any():
            return ids, mine, None
        return ids, mine, to_device(slots[mine] - lo, self.device)

    def _scatter_dev(self, slots, vecs, ns, rows) -> None:
        ns = np.asarray(ns, np.int32)
        with self._on_stream():
            ids, mine, local = self._upload_slots(slots)
            self._rows_dev.index_copy_(
                0, ids, to_device(rows.astype(np.int32), self.device))
            if local is None:
                return
            if mine is not None:
                vecs, ns = vecs[mine], ns[mine]
            self._bank_dev.index_copy_(0, local, to_device(vecs, self.device))
            self._labels_dev.index_copy_(0, local, to_device(ns, self.device))

    # -- shard liveness ------------------------------------------------------
    def mark_down(self, shard: int) -> None:
        """Take a shard out of retrieval: its device label slab goes to -1
        (the namespace mask hides every row) while the host truth is kept —
        the graceful-degradation switch, one (C,) slab fill."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} of {self.n_shards}")
        if shard in self.down:
            return
        self.down = self.down | {shard}
        if self._labels_dev is not None:
            lo, hi = self._slab_here(shard)
            if lo < hi:
                with self._on_stream():
                    self._labels_dev[lo:hi].fill_(-1)

    def mark_up(self, shard: int) -> None:
        """Bring a shard back: rewrite its label slab from host truth (a
        (C,) upload — a recovery event, not steady state)."""
        if shard not in self.down:
            return
        if self._labels_dev is not None:
            lo, hi = self._slab_here(shard)
            if lo < hi:
                base = self._local_range()[0]
                with self._on_stream():
                    self._labels_dev[lo:hi].copy_(to_device(
                        self._labels_host[base + lo: base + hi],
                        self.device))
        self.down = self.down - {shard}

    def _slab_here(self, shard: int):
        """[lo, hi) of shard's slab within this rank's device slab (empty
        when the rank holds none of it)."""
        base, top = self._local_range()
        lo = max(shard * self.C, base)
        hi = min((shard + 1) * self.C, top)
        return lo - base, max(lo, hi) - base

    # -- device residency ----------------------------------------------------
    def _effective_labels(self) -> np.ndarray:
        down = self.down
        if not down:
            return self._labels_host
        eff = self._labels_host.copy()
        for s in down:
            eff[s * self.C: (s + 1) * self.C] = -1
        return eff

    def _ensure_device(self) -> None:
        if self._bank_dev is not None:
            return
        lo, hi = self._local_range()
        with self._on_stream():
            self._labels_dev = to_device(self._effective_labels()[lo:hi],
                                         self.device)
            self._rows_dev = to_device(self._rows_host, self.device)
            self._bank_dev = to_device(self._bank_host[lo:hi], self.device)

    def _dtensor(self, local, shape):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, self.mesh, mesh_slab(self.mesh)[2],
                                  run_check=False, shape=shape,
                                  stride=local.stride())

    def bank_device(self) -> torch.Tensor:
        """The live (S*C, D) device bank: on a mesh, a DTensor sharded
        over every mesh dim (each rank's slab)."""
        self._ensure_device()
        if self.mesh is None:
            return self._bank_dev
        return self._dtensor(self._bank_dev, (self.n_slots, self.dim))

    # -- search --------------------------------------------------------------
    def search(self, queries, q_ns, k: int):
        """One namespace-masked top-k launch (K1) over the slab bank.
        Returns DEVICE tensors (scores (Q, k) f32, rows (Q, k) i32 global
        row ids), (-inf, -1) for empty slots.  Requires a non-stale layout
        (`rebuild` first)."""
        if self.stale:
            raise RuntimeError("ShardedBank is stale; rebuild() first")
        queries = upload(queries, self.device, torch.float32)
        if queries.dim() == 1:
            queries = queries[None]
        queries = queries.contiguous()
        Q = queries.shape[0]
        if int(self._count.sum()) == 0:
            return (torch.full((Q, k), -float("inf"), device=self.device),
                    torch.full((Q, k), -1, dtype=torch.int32,
                               device=self.device))
        self._ensure_device()
        self.counters["searches"] += 1
        q_ns = upload(q_ns, self.device, torch.int32).contiguous()
        kk = min(k, self.n_slots)
        if self.mesh is not None:
            s, i = sharded_topk(queries, self.bank_device(), kk, q_ns=q_ns,
                                bank_ns=self._dtensor(self._labels_dev,
                                                      (self.n_slots,)),
                                mesh=self.mesh)
        else:
            s, i = _search_device(self._bank_dev, self._labels_dev, queries,
                                  q_ns, self.n_slots, k=kk, uniform=False)
        if kk < k:
            s = torch.nn.functional.pad(s, (0, k - kk), value=-float("inf"))
            i = torch.nn.functional.pad(i, (0, k - kk), value=-1)
        return s, self.slots_to_rows(i)

    def slots_to_rows(self, slot_ids: torch.Tensor) -> torch.Tensor:
        """Map device slot ids back to global row ids (-1 stays -1): one
        (Q, k) gather of the device row map."""
        self._ensure_device()
        safe = slot_ids.clamp(0, self.n_slots - 1).long()
        return torch.where(slot_ids >= 0, self._rows_dev[safe],
                           torch.full_like(slot_ids, -1)).to(torch.int32)

    # -- stats ---------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "per_shard_capacity": self.C,
            "total_slots": self.n_slots,
            "per_shard_rows": [int(c) for c in self._count],
            "down": sorted(self.down),
            "stale": self.stale,
            "meshed": self.mesh is not None,
            **self.counters,
        }
