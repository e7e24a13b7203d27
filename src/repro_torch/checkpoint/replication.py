"""Per-shard WAL ownership, cross-shard group commit, and segment shipping.

The sharded store journals one logical flush as several per-shard parts.
`ShardedWal` lays that out as:

    <dir>/
      MANIFEST.msgpack, snapshot-*.msgpack     coordinator (whole-store)
      wal-00000008.msgpack                     commit records + plain ops
      shard-00/wal-00000003.msgpack            shard 0's flush parts
      shard-01/wal-00000005.msgpack            shard 1's flush parts

A `sharded_flush` record's parts are appended to their owning shard's log
first (each an fsync'd atomic segment), and only then does ONE commit
record — `{"op": "shard_commit", "parts": [[shard, shard_seq], ...]}` —
land in the coordinator log.  **The group is durable iff the commit record
is durable**: a crash after some shard appends but before the commit
record leaves orphaned shard segments that replay never references (and
the next rotation reaps).  Replay walks the coordinator log in seq order
and re-inflates each commit record from its shard logs; a missing or
corrupt shard part stops replay at that commit record — the store state is
always a consistent prefix of the commit order, never a partial flush.

`SegmentShipper` streams every sealed segment (coordinator and shard logs
alike, via `WriteAheadLog.on_seal`) to a `Sink` — a follower directory or
an object store — so recovery works after losing the host, not just the
process: `restore_missing_from_follower` re-materializes the lost files
and the ordinary recovery path replays them.  Shipping is best-effort and
off the durability path (local fsync is the commit point; follower lag is
the replication RPO — see docs/OPERATIONS.md).

Every file is the reference package's, byte for byte (the records go
through the port's own codec, `checkpoint/packing.py`), so either package
recovers a sharded directory or a follower the other wrote.  This module
is host code only.
"""
from __future__ import annotations

import os
import queue
import re
import threading
import warnings
from typing import List, Optional, Tuple

from repro_torch.checkpoint import faults
from repro_torch.checkpoint.wal import (CorruptSegmentError, WriteAheadLog,
                                        atomic_write_bytes, fsync_dir)
from repro_torch.obs.telemetry import get_telemetry

SHARD_DIR_RE = re.compile(r"^shard-(\d{2})$")


# -- sinks -------------------------------------------------------------------
class DirectorySink:
    """Follower-directory sink: relative paths mirrored under `root`, each
    file landed atomically (a follower never holds a torn segment).  Also
    the stand-in for an object store: put/get/has/list is the whole
    contract."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def put(self, rel: str, blob: bytes) -> None:
        path = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        atomic_write_bytes(path, blob)

    def get(self, rel: str) -> bytes:
        with open(os.path.join(self.root, rel), "rb") as f:
            return f.read()

    def has(self, rel: str) -> bool:
        return os.path.isfile(os.path.join(self.root, rel))

    def list(self) -> List[str]:
        out = []
        for dirpath, _, names in os.walk(self.root):
            for name in names:
                out.append(os.path.relpath(os.path.join(dirpath, name),
                                           self.root))
        return sorted(out)


class SegmentShipper:
    """Streams sealed WAL segments to a sink.  Install as `wal.on_seal`.

    Shipping NEVER raises into the append path: the local fsync is the
    durability point, the follower is asynchronous replication.  A failed
    ship is counted and warned (`counters["failed"]`) — operators alert on
    it as replication lag.  `mode="sync"` ships inline (tests, small
    deployments); `mode="async"` hands sealed paths to a daemon thread so
    a slow sink cannot stall group commit.
    """

    def __init__(self, source_dir: str, sink, mode: str = "sync"):
        if mode not in ("sync", "async"):
            raise ValueError(f"mode {mode!r} must be 'sync' or 'async'")
        self.source_dir = os.path.abspath(source_dir)
        self.sink = sink
        self.mode = mode
        self.counters = {"shipped": 0, "failed": 0, "queued": 0}
        self._stop = object()
        if mode == "async":
            self._q: queue.Queue = queue.Queue()
            self._thread = threading.Thread(
                target=self._loop, name="wal-shipper", daemon=True)
            self._thread.start()

    def __call__(self, abs_path: str) -> None:
        rel = os.path.relpath(os.path.abspath(abs_path), self.source_dir)
        if self.mode == "sync":
            self._ship_one(rel)
        else:
            self.counters["queued"] += 1
            self._q.put(rel)

    def _ship_one(self, rel: str) -> None:
        tel = get_telemetry()
        try:
            with tel.span("replication.ship", segment=rel):
                faults.active().trip("ship", rel)
                with open(os.path.join(self.source_dir, rel), "rb") as f:
                    blob = f.read()
                self.sink.put(rel, blob)
            self.counters["shipped"] += 1
            tel.inc("memori_replication_shipped",
                    help="WAL segments shipped to the follower sink")
        except Exception as e:
            self.counters["failed"] += 1
            tel.inc("memori_replication_failed",
                    help="WAL segment ship failures (replication lag)")
            tel.event("replication_failed", segment=rel, error=str(e))
            warnings.warn(f"WAL segment ship failed for {rel}: {e}",
                          stacklevel=2)

    def ship_existing(self) -> int:
        """Backfill: ship every sealed segment the sink does not have yet
        (attach-follower on a log with history; also re-ship after an
        outage).  Returns how many were shipped."""
        n = 0
        for dirpath, _, names in os.walk(self.source_dir):
            for name in sorted(names):
                if not (name.startswith("wal-")
                        and name.endswith(".msgpack")):
                    continue
                abs_p = os.path.join(dirpath, name)
                rel = os.path.relpath(abs_p, self.source_dir)
                if not self.sink.has(rel):
                    self._ship_one(rel)
                    n += 1
        return n

    def _loop(self) -> None:
        while True:
            rel = self._q.get()
            if rel is self._stop:
                self._q.task_done()
                return
            self._ship_one(rel)
            self._q.task_done()

    def drain(self) -> None:
        """Block until every queued segment has been attempted."""
        if self.mode == "async":
            self._q.join()

    def close(self) -> None:
        if self.mode == "async":
            self._q.put(self._stop)
            self._q.join()
            self._thread.join(timeout=5)


# -- sharded WAL -------------------------------------------------------------
class ShardedWal:
    """Coordinator WAL + per-shard WALs, presenting the `WriteAheadLog`
    surface the lifecycle runtime mounts.  Seq numbers (and therefore
    snapshot coverage, quarantine, and `last_seq`) live in the COORDINATOR
    log; shard logs have private seq spaces referenced only by commit
    records."""

    def __init__(self, dirpath: str, n_shards: int):
        if n_shards < 2:
            raise ValueError("ShardedWal needs n_shards >= 2 (use "
                             "WriteAheadLog for a single shard)")
        self.n_shards = int(n_shards)
        self.commit = WriteAheadLog(dirpath)
        self.shards = [WriteAheadLog(os.path.join(dirpath, f"shard-{s:02d}"))
                       for s in range(self.n_shards)]
        self.replay_stopped_seq: Optional[int] = None

    # -- delegated surface -------------------------------------------------
    @property
    def dir(self) -> str:
        return self.commit.dir

    @property
    def last_seq(self) -> int:
        return self.commit.last_seq

    @property
    def on_seal(self):
        return self.commit.on_seal

    @on_seal.setter
    def on_seal(self, hook) -> None:
        """One hook observes every sealed segment, coordinator and shard
        logs alike (the shipper computes each file's relative path)."""
        self.commit.on_seal = hook
        for w in self.shards:
            w.on_seal = hook

    def segment_seqs(self) -> List[int]:
        return self.commit.segment_seqs()

    def snapshots(self) -> List[Tuple[int, str]]:
        return self.commit.snapshots()

    def latest_snapshot(self) -> Optional[Tuple[int, str]]:
        return self.commit.latest_snapshot()

    def snapshot_path(self, wal_through: int) -> str:
        return self.commit.snapshot_path(wal_through)

    def snapshot_births(self):
        return self.commit.snapshot_births()

    def write_manifest(self, snaps, births=None) -> None:
        self.commit.write_manifest(snaps, births)

    def read_manifest(self):
        return self.commit.read_manifest()

    def file_seq_of(self, record_seq: int) -> int:
        return self.commit.file_seq_of(record_seq)

    def quarantine_from(self, file_seq: int) -> List[str]:
        """Quarantines the coordinator tail.  Shard segments referenced
        only by the dead tail become unreferenced orphans — harmless to
        replay, reaped by the next rotation."""
        return self.commit.quarantine_from(file_seq)

    # -- append: shard parts first, then the commit record -----------------
    def _decompose(self, record: dict) -> dict:
        if not (isinstance(record, dict)
                and record.get("op") == "sharded_flush"):
            return record
        parts = []
        for shard, part in record["parts"]:
            s = int(shard)
            if not 0 <= s < self.n_shards:
                raise ValueError(f"flush part for shard {s} of "
                                 f"{self.n_shards}")
            parts.append([s, int(self.shards[s].append(part))])
        out = {"op": "shard_commit", "parts": parts}
        if "ns_ids" in record:
            out["ns_ids"] = record["ns_ids"]
        return out

    def append(self, record: dict) -> int:
        """Durably append one record.  A `sharded_flush` lands its parts in
        their shard logs first; the record — and with it the whole flush —
        is durable exactly when the coordinator commit record is.  A crash
        between the two leaves orphaned shard segments replay never sees."""
        return self.commit.append(self._decompose(record))

    def append_group(self, records: List[dict]) -> Tuple[int, int]:
        """Cross-shard group commit: every participating shard's segments
        are appended (each its own fsync'd atomic file), then ONE
        coordinator segment carries all the commit records — the group is
        durable iff that final segment is.  All-or-nothing under any
        crash."""
        return self.commit.append_group(
            [self._decompose(r) for r in list(records)])

    # -- replay ------------------------------------------------------------
    def _read_shard_record(self, shard: int, sseq: int) -> dict:
        w = self.shards[shard]
        fseq = w.file_seq_of(sseq)
        if fseq <= 0:
            raise CorruptSegmentError(
                f"shard {shard}: no segment holds record seq {sseq}")
        records = w.read_records(fseq)
        idx = sseq - fseq
        if not 0 <= idx < len(records):
            raise CorruptSegmentError(
                f"shard {shard}: segment {fseq} does not span seq {sseq}")
        return records[idx]

    def replay_records(self, after_seq: int = 0):
        """Yield (seq, record) in coordinator order, re-inflating each
        commit record from its shard logs.  A missing or corrupt shard
        part stops replay at that commit record's FILE (recorded in
        `replay_stopped_seq` for quarantine): the replayed state is always
        a consistent prefix of the commit order — never a flush with some
        shards' rows and not others."""
        self.replay_stopped_seq = None
        for seq, rec in self.commit.replay_records(after_seq):
            if isinstance(rec, dict) and rec.get("op") == "shard_commit":
                parts = []
                try:
                    for shard, sseq in rec["parts"]:
                        parts.append([int(shard), self._read_shard_record(
                            int(shard), int(sseq))])
                except (CorruptSegmentError, OSError, KeyError, ValueError,
                        IndexError, TypeError) as e:
                    self.replay_stopped_seq = self.commit.file_seq_of(seq)
                    warnings.warn(
                        f"sharded WAL replay stopped at commit seq {seq}: "
                        f"{e}", stacklevel=2)
                    return
                out = {"op": "sharded_flush", "parts": parts}
                if "ns_ids" in rec:
                    out["ns_ids"] = rec["ns_ids"]
                yield seq, out
            else:
                yield seq, rec
        if self.commit.replay_stopped_seq is not None:
            self.replay_stopped_seq = self.commit.replay_stopped_seq

    # -- rotation ----------------------------------------------------------
    def commit_snapshot(self, wal_through: int, retain: int = 2) -> dict:
        """Coordinator rotation first (manifest, snapshot retention,
        coordinator-segment truncation), then shard-log garbage collection:
        a shard segment survives only while some REMAINING commit record
        references a record seq inside it.  This reaps both segments whose
        commits the snapshot now covers and orphans from crashed group
        commits."""
        info = self.commit.commit_snapshot(wal_through, retain)
        referenced = [set() for _ in range(self.n_shards)]
        scan_ok = True
        for seq in self.commit.segment_seqs():
            try:
                for rec in self.commit.read_records(seq):
                    if isinstance(rec, dict) \
                            and rec.get("op") == "shard_commit":
                        for shard, sseq in rec["parts"]:
                            if 0 <= int(shard) < self.n_shards:
                                referenced[int(shard)].add(int(sseq))
            except CorruptSegmentError:
                # can't bound what the unreadable tail references — keep
                # every shard segment until quarantine clears it up
                scan_ok = False
                break
        dropped = 0
        if scan_ok:
            for s, w in enumerate(self.shards):
                pruned = False
                for fseq in w.segment_seqs():
                    count = w.segment_record_count(fseq)
                    if not any(fseq <= r < fseq + count
                               for r in referenced[s]):
                        faults.active().unlink(w._seg_path(fseq))
                        dropped += 1
                        pruned = True
                if pruned:
                    fsync_dir(w.dir)
        info["truncated_shard_segments"] = dropped
        return info


# -- open / recover helpers --------------------------------------------------
def detect_shards(dirpath: str) -> int:
    """Shard count a data directory was written with (0 = unsharded), from
    its `shard-NN/` subdirectories.  A gap in the numbering means lost
    shard logs — refuse to guess."""
    if not os.path.isdir(dirpath):
        return 0
    found = []
    for name in os.listdir(dirpath):
        m = SHARD_DIR_RE.match(name)
        if m and os.path.isdir(os.path.join(dirpath, name)):
            found.append(int(m.group(1)))
    if not found:
        return 0
    n = max(found) + 1
    missing = sorted(set(range(n)) - set(found))
    if missing:
        raise ValueError(
            f"{dirpath}: shard dirs present up to shard-{n - 1:02d} but "
            f"missing {missing} — restore them (e.g. "
            "restore_missing_from_follower) before mounting")
    return n


def open_wal(data_dir: str, shards: Optional[int] = None):
    """Open the right WAL flavor for a data directory: explicit `shards`
    wins (validated against what's on disk), otherwise autodetect from the
    `shard-NN/` layout, otherwise a plain `WriteAheadLog`."""
    detected = detect_shards(data_dir)
    if shards is None:
        n = detected
    else:
        n = int(shards)
        if detected and n != detected:
            raise ValueError(
                f"{data_dir} holds {detected}-shard WAL state but "
                f"shards={n} was requested")
    if n > 1:
        return ShardedWal(data_dir, n)
    return WriteAheadLog(data_dir)


def restore_missing_from_follower(sink, data_dir: str) -> List[str]:
    """Re-materialize every file the follower holds that the local data
    directory lost (the recover-from-follower step after losing a host or
    a shard's disk).  Existing local files are never overwritten — local
    state is newer than or equal to the follower's by construction.
    Returns the restored relative paths; ordinary recovery then replays
    them."""
    os.makedirs(data_dir, exist_ok=True)
    restored = []
    for rel in sink.list():
        local = os.path.join(data_dir, rel)
        if os.path.exists(local) or os.path.exists(local + ".corrupt"):
            continue
        os.makedirs(os.path.dirname(local), exist_ok=True)
        atomic_write_bytes(local, sink.get(rel))
        restored.append(rel)
    return restored


def clone_from_follower(sink, data_dir: str) -> List[str]:
    """Bootstrap an empty data directory purely from shipped segments
    (replay-from-genesis: the follower holds no snapshots)."""
    if os.path.isdir(data_dir) and os.listdir(data_dir):
        raise ValueError(f"clone target {data_dir} is not empty")
    return restore_missing_from_follower(sink, data_dir)
