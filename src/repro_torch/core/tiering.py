"""Hot/warm tiered residency for the device bank (ROADMAP: "tiered bank
for millions of tenants").

The device bank is the capacity bottleneck: every resident row costs HBM
(1 byte/dim + 4 bytes/row quantized, 4 bytes/dim f32) and bank-scan
bandwidth on every search.  A production deployment holds orders of
magnitude more tenants than are active in any window, so the TierManager
bounds the HOT set by *policy* instead of bank size:

* every retrieve/record bumps the owning namespace's **EWMA activity
  score** (exponential decay with a configurable halflife — long-idle
  tenants decay toward zero no matter how busy they once were);
* when the resident row count exceeds ``max_hot_rows``, ``tick()``
  (driven by ``LifecycleRuntime.run_maintenance_once``) **demotes** the
  coldest namespaces' rows out of the device bank
  (``VectorIndex.demote_rows``: device slots zeroed/label -1, the
  full-precision host mirror untouched — the warm tier; snapshots, WAL
  and compaction never notice);
* a retrieve that hits a demoted namespace transparently falls back to
  the host-side masked search (``VectorIndex.search_host`` — exact, just
  not device-accelerated) and **marks the namespace for promotion**; the
  next tick brings its rows back in ONE batched pow2-padded device
  scatter (``promote_rows``), so a tenant waking from the warm tier pays
  one host-search round-trip, not a stampede of uploads.

The manager is deliberately storage-agnostic: it only talks to the
store's public surface (``row_namespaces``/``alive``/``resident_mask``
scans happen at tick time, never on the retrieve hot path) and all its
own bookkeeping is O(#active namespaces).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional, Set

import numpy as np

from repro_torch.obs.telemetry import get_telemetry


@dataclasses.dataclass(frozen=True)
class TierPolicy:
    """Knobs of the hot/warm tier manager (see docs/OPERATIONS.md).

    ``max_hot_rows`` is the device-residency budget: ``tick()`` demotes
    the coldest namespaces until at most this many live rows are
    device-resident.  ``halflife_s`` controls how fast activity evidence
    ages (a namespace idle for one halflife keeps half its score);
    ``retrieve_weight``/``record_weight`` weigh the two activity
    signals."""
    max_hot_rows: int = 1 << 20
    halflife_s: float = 300.0
    retrieve_weight: float = 1.0
    record_weight: float = 1.0

    def __post_init__(self):
        if self.max_hot_rows < 1:
            raise ValueError("max_hot_rows must be >= 1")
        if self.halflife_s <= 0:
            raise ValueError("halflife_s must be > 0")


class TierManager:
    """Per-namespace EWMA activity tracking + policy-driven demotion and
    promotion against one VectorIndex.  Not thread-safe by itself — the
    lifecycle runtime calls every method under its lock, matching how the
    rest of maintenance serializes against the read path."""

    def __init__(self, vindex, policy: Optional[TierPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.vindex = vindex
        self.policy = policy or TierPolicy()
        self._clock = clock
        # ns_id -> (score at _stamp, stamp); decay is applied lazily on
        # touch/compare so idle namespaces cost nothing per tick
        self._score: Dict[int, float] = {}
        self._stamp: Dict[int, float] = {}
        self._demoted: Set[int] = set()
        self._promote_pending: Set[int] = set()
        self.counters = {"promotions": 0, "demotions": 0,
                         "promoted_rows": 0, "demoted_rows": 0,
                         "host_fallbacks": 0, "ticks": 0}

    # -- activity signals (hot path: O(1) dict math, no index access) -------
    def _bump(self, ns_id: int, weight: float) -> None:
        now = self._clock()
        self._score[ns_id] = self.score(ns_id, now=now) + weight
        self._stamp[ns_id] = now

    def score(self, ns_id: int, now: Optional[float] = None) -> float:
        """Decayed EWMA activity score (0.0 for a never-seen namespace)."""
        s = self._score.get(ns_id)
        if s is None:
            return 0.0
        if now is None:
            now = self._clock()
        dt = max(0.0, now - self._stamp[ns_id])
        return s * math.pow(2.0, -dt / self.policy.halflife_s)

    def note_retrieve(self, ns_id: int) -> None:
        self._bump(int(ns_id), self.policy.retrieve_weight)

    def note_record(self, ns_id: int) -> None:
        self._bump(int(ns_id), self.policy.record_weight)

    def note_host_fallback(self, ns_id: int) -> None:
        """A retrieve hit this demoted namespace: count the fallback and
        queue the namespace for promotion on the next maintenance tick."""
        self.counters["host_fallbacks"] += 1
        self.mark_for_promotion(ns_id)

    # -- tier state ---------------------------------------------------------
    def is_demoted(self, ns_id: int) -> bool:
        return int(ns_id) in self._demoted

    def demoted_namespaces(self) -> Set[int]:
        return set(self._demoted)

    def mark_for_promotion(self, ns_id: int) -> None:
        ns_id = int(ns_id)
        if ns_id in self._demoted:
            self._promote_pending.add(ns_id)

    # -- the maintenance body ------------------------------------------------
    def tick(self) -> dict:
        """One maintenance pass: (1) promote every namespace marked since
        the last tick (batched device scatter per namespace), then (2) if
        the resident row count exceeds the policy budget, demote the
        coldest namespaces until it fits.  Returns what happened."""
        self.counters["ticks"] += 1
        did = {"promoted_ns": 0, "demoted_ns": 0,
               "promoted_rows": 0, "demoted_rows": 0}
        vi = self.vindex
        shielded: Set[int] = set()
        for ns_id in sorted(self._promote_pending):
            rows = vi.rows_in_namespace(ns_id)
            n = vi.promote_rows(rows)
            self._demoted.discard(ns_id)
            shielded.add(ns_id)           # never re-demote in the same tick
            did["promoted_ns"] += 1
            did["promoted_rows"] += n
        self._promote_pending.clear()
        over = vi.n_resident - self.policy.max_hot_rows
        if over > 0:
            did_d, rows_d = self._demote_coldest(over, shielded)
            did["demoted_ns"] = did_d
            did["demoted_rows"] = rows_d
        self.counters["promotions"] += did["promoted_ns"]
        self.counters["demotions"] += did["demoted_ns"]
        self.counters["promoted_rows"] += did["promoted_rows"]
        self.counters["demoted_rows"] += did["demoted_rows"]
        tel = get_telemetry()
        if did["promoted_ns"]:
            tel.inc("memori_tier_promotions", did["promoted_ns"],
                    help="namespaces promoted back to the device bank")
        if did["demoted_ns"]:
            tel.inc("memori_tier_demotions", did["demoted_ns"],
                    help="namespaces demoted off the device bank")
        if did["promoted_ns"] or did["demoted_ns"]:
            tel.event("tier_tick", **did)
        return did

    def _demote_coldest(self, over: int, shielded: Set[int]):
        """Demote whole namespaces, coldest (lowest decayed score) first,
        until `over` resident rows have left the device.  One host sort
        builds the per-namespace resident row lists — tick-time cost, never
        on the retrieve path."""
        vi = self.vindex
        m = vi.n
        if m == 0:
            return 0, 0
        ns = vi.row_namespaces()
        live = vi.alive() & vi.resident_mask()
        # the live rows grouped by namespace with one stable sort (each
        # group's rows ascending, the groups by ascending id)
        idx = np.flatnonzero(live)
        keys = ns[idx]
        perm = np.argsort(keys, kind="stable")
        ids, starts = np.unique(keys[perm], return_index=True)
        rows_by_ns: Dict[int, np.ndarray] = {
            int(i): g for i, g in zip(ids, np.split(idx[perm], starts[1:]))}
        now = self._clock()
        order = sorted(
            (nid for nid in rows_by_ns
             if nid not in shielded and nid not in self._demoted),
            key=lambda nid: (self.score(nid, now=now), -len(rows_by_ns[nid])))
        n_ns = n_rows = 0
        for nid in order:
            if over <= 0:
                break
            n = vi.demote_rows(rows_by_ns[nid])
            self._demoted.add(nid)
            n_ns += 1
            n_rows += n
            over -= n
        return n_ns, n_rows

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        return {
            "hot_rows": self.vindex.n_resident,
            "warm_rows": self.vindex.n_warm,
            "max_hot_rows": self.policy.max_hot_rows,
            "demoted_namespaces": len(self._demoted),
            "promote_pending": len(self._promote_pending),
            **self.counters,
        }
