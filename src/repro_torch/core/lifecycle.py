"""Lifecycle runtime — everything that happens to a MemoryStore *between*
requests (the fourth pillar next to service, store and retrieval engine).

Three responsibilities, all policy-driven (`LifecyclePolicy`):

* **incremental persistence** — mounted on a durable directory, the runtime
  attaches itself as the store's `wal_sink`: every `flush()` (and evict /
  compact) durably appends a self-describing segment to a write-ahead log
  (`checkpoint/wal.py`, atomic tmp+fsync+rename) *before* the mutation is
  applied.  Recovery (`LifecycleRuntime.recover`) = newest restorable
  snapshot + ordered WAL replay through the store's own commit path, so a
  restored service answers `retrieve_batch` bit-identically to the
  pre-crash store up to the last durable flush.
* **background flusher** — a daemon thread drains the pending queue through
  the store's one-embed-call batched path every `flush_interval_s` seconds
  (or immediately when the bounded queue fills).  `enqueue()` applies
  backpressure once `max_pending` sessions are buffered: `"block"` waits
  for the flusher (bounded by `enqueue_timeout_s`), `"reject"` raises
  `BackpressureError` — either way the queue depth is bounded, so an
  enqueue-only client sees amortized O(1) cost.
* **policy-driven maintenance** — auto-compaction fires when the tombstone
  ratio crosses `compact_tombstone_ratio` during an idle window
  (`compact_idle_s` since the last client op), and snapshot rotation writes
  a fresh full snapshot every `snapshot_interval_s`, retains
  `snapshot_retain` generations, and truncates WAL segments every retained
  generation already covers.

Thread-safety is one coarse reentrant lock: the daemon, `enqueue`, and the
service's read path (which mounts `runtime.lock`) all serialize against it.
The lock orders the host; on a CUDA device the daemon also has to order
its device work against the readers' — torch's current stream is per
thread, so the daemon runs its maintenance on the stream that was current
where the runtime was built (the read path's), and waits for that stream
before it releases the lock whenever a tick wrote to the device.  So
maintenance never mutates the device-resident bank mid-search, whichever
stream a reader uses.  All the maintenance primitives remain callable
escape hatches (`flush`, `compact`, `rotate`); `run_maintenance_once()` is
the daemon's body, exposed so tests and embedders without threads can
drive the same policy deterministically.

On a mesh (the store built with `mesh=`, one process a rank) only rank 0
journals and snapshots, and no rank starts the daemon: each rank's clock
would time its flushes, compactions and demotions differently and the
ranks' banks would part.  Rank 0's scheduler decides each maintenance tick
(`plan_maintenance`) and ships it with a request tick; every rank applies
it (`apply_maintenance`, core/scheduler.py).  So a meshed service whose
policy wants a daemon is served through its scheduler: a client op on it
with no scheduler mounted raises rather than go unmaintained.  A full
queue in `"block"` mode is flushed by the enqueue itself on a mesh (each
rank's queue fills at the same op), where the daemon would have drained
it.

A sharded store (`shards > 1`) journals through a `ShardedWal` (per-shard
logs behind a coordinator log, checkpoint/replication.py), and
`attach_follower` streams every sealed segment to a follower so that a
lost disk is restored from it (`restore_missing_from_follower`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import warnings
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint.replication import (DirectorySink,
                                                SegmentShipper, open_wal)
from repro_torch.core.extraction import Extractor, Message
from repro_torch.core.store import MemoryStore
from repro_torch.core.tiering import TierPolicy
from repro_torch.obs.telemetry import get_telemetry


class BackpressureError(RuntimeError):
    """The pending queue is at `max_pending` and policy forbids waiting (or
    the wait timed out): the caller must slow down or drop the session."""


@dataclasses.dataclass(frozen=True)
class LifecyclePolicy:
    """Knobs of the lifecycle runtime (see docs/OPERATIONS.md).

    All intervals are seconds; `None` disables that behavior.  A policy
    with every trigger disabled is valid — the runtime is then just the
    WAL mount plus manual escape hatches."""
    flush_interval_s: Optional[float] = None   # time-based background flush
    max_pending: Optional[int] = None          # bounded pending queue
    backpressure: str = "block"                # "block" | "reject" when full
    enqueue_timeout_s: Optional[float] = 30.0  # block-mode wait bound
    compact_tombstone_ratio: Optional[float] = None  # auto-compact trigger
    compact_min_tombstones: int = 64           # don't churn tiny banks
    compact_idle_s: float = 1.0                # idle window before compacting
    snapshot_interval_s: Optional[float] = None  # periodic full snapshot
    snapshot_retain: int = 2                   # generations kept on disk
    tick_s: float = 0.05                       # daemon wake granularity
    tier: Optional[TierPolicy] = None          # hot/warm tiered residency

    def __post_init__(self):
        if self.backpressure not in ("block", "reject"):
            raise ValueError(f"backpressure {self.backpressure!r} must be "
                             "'block' or 'reject'")
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if self.snapshot_retain < 1:
            raise ValueError("snapshot_retain must be >= 1")

    @property
    def wants_daemon(self) -> bool:
        return (self.flush_interval_s is not None
                or self.compact_tombstone_ratio is not None
                or self.snapshot_interval_s is not None
                or self.tier is not None)


class LifecycleRuntime:
    def __init__(self, store: MemoryStore, data_dir: Optional[str] = None,
                 policy: Optional[LifecyclePolicy] = None,
                 start: bool = True, _recovered: bool = False):
        self.store = store
        self.policy = policy or LifecyclePolicy()
        # a sharded store journals through a ShardedWal (per-shard logs +
        # cross-shard commit records); unsharded stores keep the plain log.
        # Autodetect covers mounting over a directory whose layout is known
        # only from disk.
        # on a mesh only rank 0 journals and snapshots; the other ranks
        # apply the same writes and leave the directory to it
        self.mirror = bool(data_dir) and not store.durable_writer
        self.wal = (open_wal(data_dir,
                             shards=(store.shards if store.shards > 1
                                     else None))
                    if data_dir and not self.mirror else None)
        self.shipper: Optional[SegmentShipper] = None
        # the stream the read path runs on (the building thread's): the
        # daemon's device work goes there (see the module docstring)
        self._stream = (torch.cuda.current_stream(store.device)
                        if store.device.type == "cuda" else None)
        self.lock = threading.RLock()
        self._can_enqueue = threading.Condition(self.lock)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.last_error: Optional[BaseException] = None
        now = time.monotonic()
        self._last_flush = now
        self._last_activity = now
        self._last_snapshot_mono: Optional[float] = None
        self.counters = {"flushes": 0, "auto_compactions": 0, "rotations": 0}
        if self.wal is not None:
            snap = self.wal.latest_snapshot()
            has_prior = snap is not None or bool(self.wal.segment_seqs())
            if has_prior and not _recovered:
                # journaling a store that did NOT come out of this
                # directory on top of it would shadow the existing state —
                # and the next rotation would permanently destroy it
                raise ValueError(
                    f"{self.wal.dir} already holds durable state; recover "
                    "it (LifecycleRuntime.recover / MemoryService.recover) "
                    "instead of mounting a new store over it")
            if snap is not None:
                # age of the on-disk generation survives process restarts.
                # The birth recorded in the manifest at commit time is
                # authoritative — file mtime is only a fallback for
                # snapshots predating birth records, and is clamped to now
                # so a doctored/future mtime (restore tools, clock steps)
                # can never yield a generation "born in the future" that
                # indefinitely suppresses interval-based rotation
                born = self.wal.snapshot_births().get(snap[0])
                if born is None:
                    born = min(os.path.getmtime(snap[1]), time.time())
                age = max(0.0, time.time() - born)
                self._last_snapshot_mono = now - age
            if store.wal_sink is not None:
                raise ValueError("store already has a wal_sink attached")
            store.wal_sink = self.wal.append
            # mounting a fresh log onto a store that already holds state
            # would leave that state unrecoverable (the WAL only sees
            # mutations from now on) — write a baseline generation first
            if (not has_prior and (store.vindex.n or store.namespaces()
                                   or store.pending_count)):
                self.rotate()
        # hot/warm tiering: mount the TierManager on the store so the
        # write path notes activity and maintenance ticks drive
        # demotion/promotion (idempotent if the store already has one)
        if self.policy.tier is not None and store.tiers is None:
            store.attach_tiers(self.policy.tier)
        # every queue drain — background, read-your-writes, or a direct
        # store.flush() — must stamp the flush clock and wake blocked
        # enqueuers, so the bookkeeping hangs off the store's commit hook
        store.on_flush_commit = self._flush_committed
        # on a mesh no rank runs the daemon: rank 0's scheduler decides
        # each maintenance tick and ships it to every rank, and sets
        # itself as the maintainer on every rank
        self.meshed = store.mesh is not None
        self.maintainer = None
        if start and self.policy.wants_daemon and not self.meshed:
            self.start()

    def _flush_committed(self, n_sessions: int) -> None:
        with self._can_enqueue:          # reentrant: safe if already held
            self._last_flush = time.monotonic()
            if n_sessions:
                self.counters["flushes"] += 1
            self._can_enqueue.notify_all()

    # -- recovery -----------------------------------------------------------
    @classmethod
    def recover(cls, data_dir: str, embedder,
                extractor: Optional[Extractor] = None, *,
                policy: Optional[LifecyclePolicy] = None, dim: int = 256,
                device="cuda", tokenizer=None,
                start: bool = True, shards: Optional[int] = None,
                mesh=None) -> "LifecycleRuntime":
        """Rebuild a store from a durable directory (written by either
        package): newest restorable snapshot generation (older generations
        are fallbacks if the newest fails to load) + ordered replay of
        every valid WAL segment past its coverage, through the store's own
        commit path, on `device`.  The recovered bank is f32, as the
        snapshot is.  `shards=None` autodetects the on-disk WAL layout, so a
        sharded directory recovers into a sharded store without the caller
        restating the topology."""
        wal = open_wal(data_dir, shards=shards)
        n_shards = getattr(wal, "n_shards", 1)
        store, after = None, 0
        for wal_through, path in reversed(wal.snapshots()):
            try:
                store = MemoryStore.restore(path, embedder,
                                            extractor=extractor,
                                            tokenizer=tokenizer,
                                            device=device, shards=n_shards,
                                            mesh=mesh)
                after = wal_through
                break
            except Exception as e:           # fall back a generation
                get_telemetry().event("recovery_snapshot_fallback",
                                      path=path, error=str(e))
                warnings.warn(f"snapshot {path} unrestorable ({e}); "
                              "falling back to an older generation",
                              stacklevel=2)
        if store is None:
            store = MemoryStore(embedder, extractor, dim=dim,
                                tokenizer=tokenizer, device=device,
                                shards=n_shards, mesh=mesh)
        poison_file = None
        for seq, record in wal.replay_records(after_seq=after):
            try:
                store.apply_wal(record)
            except Exception as e:
                # a record that fails to APPLY (e.g. a poison flush whose
                # embedder emitted garbage) must not brick the directory
                # forever: stop here — everything before it is a
                # consistent prefix, exactly like a torn tail
                poison_file = wal.file_seq_of(seq)
                warnings.warn(f"WAL replay stopped at seq {seq}: applying "
                              f"the record failed ({e!r}); recovered state "
                              "is the consistent prefix before it",
                              stacklevel=2)
                break
        # an un-replayable tail (corrupt or poison) must not keep shadowing
        # the seq space: left in place, every segment appended after the
        # remount would sit behind it and be silently dropped by the NEXT
        # recovery despite its acknowledged-durable fsync.  Quarantine the
        # dead files, then fold the recovered state into a fresh snapshot
        # generation so nothing recovered lives only in memory.
        dead_from = (poison_file if poison_file is not None
                     else wal.replay_stopped_seq)
        if mesh is not None and mesh.size() > 1:
            # every rank has read the directory before rank 0 changes it
            import torch.distributed as dist
            dist.barrier()
        if dead_from is not None and store.durable_writer:
            wal.quarantine_from(dead_from)
        get_telemetry().event("recovery", dir=data_dir,
                              snapshot_through=after,
                              clean=dead_from is None,
                              quarantined_from=dead_from)
        rt = cls(store, data_dir=data_dir, policy=policy, start=start,
                 _recovered=True)
        if dead_from is not None:
            rt.rotate()
        return rt

    # -- replication --------------------------------------------------------
    def attach_follower(self, sink, mode: str = "sync") -> SegmentShipper:
        """Stream every sealed WAL segment (coordinator and shard logs
        alike) to `sink` — a directory path or any object with
        put/has/list — and backfill whatever history the sink is missing.
        Local fsync stays the durability point; the follower is async
        replication whose lag is the disaster-recovery RPO.  Returns the
        shipper (counters: shipped/failed/queued)."""
        if self.mirror:
            return None              # rank 0 of the mesh ships the segments
        if self.wal is None:
            raise RuntimeError("attach_follower needs a durable data_dir")
        if isinstance(sink, str):
            sink = DirectorySink(sink)
        shipper = SegmentShipper(self.wal.dir, sink, mode=mode)
        with self.lock:
            self.wal.on_seal = shipper
            self.shipper = shipper
        shipper.ship_existing()
        return shipper

    # -- write path with backpressure --------------------------------------
    def enqueue(self, namespace: str, session_id: str,
                messages: Sequence[Message],
                conversation_id: Optional[str] = None) -> None:
        """store.enqueue behind the bounded queue.  With `backpressure=
        "block"` a full queue waits for the flusher (the daemon drains a
        full queue on its next tick regardless of the flush interval); with
        `"reject"` it raises BackpressureError immediately."""
        with self._can_enqueue:
            if self._closed:
                raise RuntimeError(
                    "lifecycle runtime is closed: a durable service must "
                    "not accept writes it can no longer journal")
            self.note_activity()
            mp = self.policy.max_pending
            if mp is not None and self.store.pending_count >= mp:
                if self.policy.backpressure == "reject":
                    self._note_backpressure(namespace, "reject")
                    raise BackpressureError(
                        f"pending queue full ({self.store.pending_count}"
                        f"/{mp})")
                if self.meshed:
                    # no daemon drains it: every rank flushes here, at
                    # the same enqueue
                    self.flush()
                deadline = (None if self.policy.enqueue_timeout_s is None
                            else time.monotonic()
                            + self.policy.enqueue_timeout_s)
                while self.store.pending_count >= mp:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        self._note_backpressure(namespace, "block_timeout")
                        raise BackpressureError(
                            f"enqueue blocked > "
                            f"{self.policy.enqueue_timeout_s}s on a full "
                            f"queue ({mp}) — is the flusher running?")
                    self._can_enqueue.wait(timeout=remaining)
            self.store.enqueue(namespace, session_id, messages,
                               conversation_id=conversation_id)

    def note_activity(self) -> None:
        """Client-facing ops call this; the idle window gating
        auto-compaction measures time since the last call.  On a mesh
        whose policy wants a daemon it raises while no scheduler ships
        the maintenance (`maintainer`): no rank would ever run it."""
        if self.meshed and self.policy.wants_daemon \
                and self.maintainer is None:
            raise RuntimeError(
                "a meshed service whose lifecycle policy flushes, compacts, "
                "rotates snapshots or ticks tiers on a clock is maintained "
                "by rank 0's MemoryScheduler: start_scheduler() on every "
                "rank and submit on rank 0, or use a policy without those "
                "triggers")
        self._last_activity = time.monotonic()

    def _note_backpressure(self, namespace: str, kind: str) -> None:
        tel = get_telemetry()
        tel.inc("memori_backpressure_rejections",
                help="enqueues rejected (or timed out) by bounded-queue "
                     "backpressure")
        tel.event("backpressure_reject", namespace=namespace, mode=kind,
                  pending=self.store.pending_count,
                  max_pending=self.policy.max_pending)

    @property
    def rejecting(self) -> bool:
        """True while an enqueue would raise BackpressureError right now:
        reject-mode backpressure with the bounded queue at capacity (the
        frontend's readiness probe reports 503 while this holds)."""
        mp = self.policy.max_pending
        return (mp is not None and self.policy.backpressure == "reject"
                and self.store.pending_count >= mp)

    # -- group commit -------------------------------------------------------
    @contextlib.contextmanager
    def group_commit(self):
        """Coalesce every WAL record the body emits into ONE fsync'd group
        segment (`WriteAheadLog.append_group`) written when the block
        exits.  The scheduler wraps a multi-writer tick in this so a tick's
        batched flush + evictions + compaction cost one fsync, not one per
        mutation.

        Commit-ordering contract: the runtime lock is held for the WHOLE
        block (mutations and their buffered records stay one atomic unit —
        no snapshot rotation, background flush or direct writer can
        interleave), and callers must not acknowledge any of the block's
        writes until this context has exited, because durability moves from
        per-mutation to the group boundary.  A crash inside the block loses
        the whole group, never a prefix — recovery replays exactly the
        groups that reached disk.  The buffered records are appended even
        when the body raises partway: whatever DID apply in memory must
        reach the journal, or every later record would replay against
        missing rows.  If the group append ITSELF fails (disk full, EIO),
        the in-memory store is irreversibly ahead of the journal — the
        runtime fail-stops: it detaches the sink, closes, and stops the
        daemon, so no later record is ever journaled on top of the hole
        (recovery then yields the consistent prefix through the last
        durable segment).  Within the block, callers must not wait on the
        runtime's condition (a Condition.wait under the reentrant lock held
        twice cannot release it) — drain a full queue instead of blocking
        on it."""
        info = {"appended": 0}           # yielded: records actually written
        if self.wal is None:
            yield info
            return
        with self.lock:
            if self.store.wal_sink is None:
                # a closed/unmounted store journals nothing; nothing to group
                yield info
                return
            buffered: list = []
            prev = self.store.wal_sink
            self.store.wal_sink = buffered.append
            try:
                yield info
            finally:
                self.store.wal_sink = prev
                if buffered:
                    try:
                        self.wal.append_group(buffered)
                        info["appended"] = len(buffered)
                    except BaseException as e:
                        # fail-stop: journaling anything further would
                        # build the log on top of a hole
                        self.last_error = e
                        self._closed = True
                        self._stop.set()
                        self.store.wal_sink = None
                        raise

    # -- maintenance primitives (escape hatches + daemon body) --------------
    def flush(self) -> int:
        with self.lock:
            # bookkeeping + waiter wakeup happen in _flush_committed (the
            # store's commit hook), shared with every other drain path
            return len(self.store.flush())

    def compact(self) -> dict:
        with self.lock:
            return self.store.compact()

    def rotate(self) -> dict:
        """Flush, write a full snapshot atomically, retire old generations,
        truncate covered WAL segments."""
        if self.mirror:              # rank 0 of the mesh writes the files
            with self.lock:
                self.flush()
                self.counters["rotations"] += 1
            return {"written_by": "rank 0 of the mesh"}
        if self.wal is None:
            raise RuntimeError("rotate() needs a durable data_dir")
        tel = get_telemetry()
        with self.lock, tel.span("lifecycle.rotate"):
            self.flush()
            wal_through = self.wal.last_seq
            path = self.wal.snapshot_path(wal_through)
            nbytes = self.store.snapshot(path, atomic=True, fsync=True)
            info = self.wal.commit_snapshot(
                wal_through, retain=self.policy.snapshot_retain)
            self._last_snapshot_mono = time.monotonic()
            self.counters["rotations"] += 1
            tel.inc("memori_snapshot_rotations",
                    help="snapshot rotations (full snapshot + WAL "
                         "truncation)")
            info.update({"wal_through": wal_through, "bytes": nbytes,
                         "path": path})
            return info

    def run_maintenance_once(self) -> dict:
        """One daemon tick: time/fullness-triggered flush, idle-window
        auto-compaction, interval-driven snapshot rotation, the tier tick
        (`plan_maintenance` then `apply_maintenance`, under one hold of
        the lock).  Public so tests (and hosts that bring their own
        scheduler) can drive the exact policy the daemon runs,
        deterministically."""
        with self.lock:
            return self.apply_maintenance(self.plan_maintenance())

    def plan_maintenance(self) -> dict:
        """What one maintenance tick does, decided from this process's
        clock and the store's counters, changing nothing: {"flush",
        "compact", "rotate", "tier"} booleans.  On a mesh only rank 0
        decides: its scheduler ships the plan with a tick and every rank
        applies it (core/scheduler.py), so no rank's own clock orders a
        flush, a compaction or a demotion."""
        p = self.policy
        now = time.monotonic()
        with self.lock:
            pending = self.store.pending_count
            full = p.max_pending is not None and pending >= p.max_pending
            due = (p.flush_interval_s is not None and pending
                   and now - self._last_flush >= p.flush_interval_s)
            compact = False
            if p.compact_tombstone_ratio is not None:
                # O(1) counters, not store.stats(): this runs every tick
                dead, rows = self.store.vindex.n_dead, self.store.vindex.n
                idle = now - self._last_activity >= p.compact_idle_s
                compact = bool(idle and rows
                               and dead >= p.compact_min_tombstones
                               and dead / rows >= p.compact_tombstone_ratio)
            rotate = False
            if p.snapshot_interval_s is not None and self.wal is not None:
                ref = (self._last_snapshot_mono
                       if self._last_snapshot_mono is not None else 0.0)
                rotate = now - ref >= p.snapshot_interval_s
            return {"flush": bool(full or due), "compact": compact,
                    "rotate": rotate, "tier": self.store.tiers is not None}

    def apply_maintenance(self, plan: dict) -> dict:
        """Carry out a `plan_maintenance` plan (this process's or rank
        0's).  On a CUDA device a tick that wrote to the device waits for
        the runtime's stream before it releases the lock."""
        did = {"flushed": 0, "compacted": False, "rotated": False,
               "tier": None}
        with self.lock:
            if plan["flush"]:
                did["flushed"] = self.flush()
            if plan["compact"]:
                self.store.compact()
                self.counters["auto_compactions"] += 1
                did["compacted"] = True
            if plan["rotate"]:
                self.rotate()
                did["rotated"] = True
            if plan["tier"] and self.store.tiers is not None:
                # promote namespaces marked by host-fallback retrieves,
                # demote the coldest past the hot-row budget — batched
                # pow2 device scatters, under the same lock as every
                # other bank mutation
                did["tier"] = self.store.tiers.tick()
            if self._stream is not None and (
                    did["flushed"] or did["compacted"] or did["rotated"]
                    or did["tier"]):
                self._stream.synchronize()
        return did

    def _daemon(self) -> None:
        # device work of this thread goes to the read path's stream
        with (torch.cuda.stream(self._stream) if self._stream is not None
              else contextlib.nullcontext()):
            while not self._stop.wait(self.policy.tick_s):
                try:
                    self.run_maintenance_once()
                except Exception as e:   # keep the runtime alive; surface it
                    self.last_error = e
                    warnings.warn(f"lifecycle maintenance failed: {e!r}",
                                  stacklevel=2)

    # -- daemon control -----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._daemon,
                                        name="memori-lifecycle", daemon=True)
        self._thread.start()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self, *, final_snapshot: bool = True) -> None:
        """Stop the daemon, drain the queue, and (with a durable dir)
        write a final snapshot generation.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        with self.lock:
            self.flush()
            if final_snapshot and self.wal is not None:
                self.rotate()
            if self.store.wal_sink is not None and self.wal is not None:
                self.store.wal_sink = None
            self.store.on_flush_commit = None
        if self.shipper is not None:
            self.shipper.close()         # async mode: drain the queue

    def __enter__(self) -> "LifecycleRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        """Operator counters merged into service.stats()."""
        return {
            "pending_depth": self.store.pending_count,
            "wal_segments": (len(self.wal.segment_seqs())
                             if self.wal is not None else 0),
            "last_snapshot_age_s": (
                time.monotonic() - self._last_snapshot_mono
                if self._last_snapshot_mono is not None else None),
            "lifecycle": dict(self.counters,
                              daemon_running=self.running,
                              durable=self.wal is not None),
            "replication": (dict(self.shipper.counters)
                            if self.shipper is not None else None),
        }
