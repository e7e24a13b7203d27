"""Segmented write-ahead log for the memory store's lifecycle runtime.

One directory holds the full durable state of a `MemoryStore`:

    <dir>/
      MANIFEST.msgpack            advisory index (retained generations)
      snapshot-00000007.msgpack   full-store snapshot, name encodes the WAL
                                  seq it covers ("everything through seq 7")
      wal-00000008.msgpack        one segment per durable mutation after it
      wal-00000009.msgpack

Every append and every snapshot is written **atomically**: the bytes go to a
`*.tmp` sibling, are fsync'd, and are `os.replace`d into the final name (the
directory is fsync'd after the rename), so a crash at any instant leaves
either the complete file or no file — never a torn segment under its real
name.  Each segment is self-describing (version + seq + CRC32 of the
payload), so recovery validates what it reads instead of trusting it.

Recovery = newest restorable snapshot + ordered replay of the segments with
seq greater than the snapshot's coverage.  Rotation writes a fresh snapshot,
re-points the manifest, prunes snapshot generations beyond the retention
count, and only then truncates WAL segments — and only those at or below the
coverage of the *oldest retained* snapshot, so every retained generation can
still be brought fully up to date from the segments that remain.

The log stores opaque MessagePack records (encoded by the port's own
`checkpoint/packing.py`, byte-equal to the reference package's segments);
what they mean is the store's business (`MemoryStore._flush_record` and
the other mutations' records, replayed by `MemoryStore.apply_wal`).  See
docs/OPERATIONS.md for the operator view and docs/STORAGE.md for the
record format.
"""
from __future__ import annotations

import os
import re
import time
import warnings
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.checkpoint import faults, packing
from repro_torch.obs.telemetry import FSYNC_LATENCY, get_telemetry

SEGMENT_VERSION = 1
MANIFEST_NAME = "MANIFEST.msgpack"
_SEG_RE = re.compile(r"^wal-(\d{8})\.msgpack$")
_SNAP_RE = re.compile(r"^snapshot-(\d{8})\.msgpack$")


def fsync_dir(path: str) -> None:
    """Flush a directory entry table (the rename durability point)."""
    faults.active().fsync_dir(path)


def atomic_write_bytes(path: str, blob: bytes) -> None:
    """tmp + fsync + rename + dir-fsync: the file exists completely or not
    at all, and survives power loss once this returns.  All three steps
    route through `checkpoint.faults` so tests can crash between them."""
    tel = get_telemetry()
    t0 = time.perf_counter()
    fs = faults.active()
    tmp = path + ".tmp"
    fs.write_file(tmp, blob, fsync=True)
    fs.replace(tmp, path)
    fs.fsync_dir(os.path.dirname(os.path.abspath(path)))
    tel.inc("memori_wal_fsyncs",
            help="atomic durable writes (file fsync + rename + dir fsync)")
    tel.observe(FSYNC_LATENCY, time.perf_counter() - t0,
                help="atomic durable write latency (fsync + rename + "
                     "dir fsync)")


class CorruptSegmentError(RuntimeError):
    """A WAL segment failed validation (bad version, seq, or checksum)."""


# every field a segment envelope may carry; anything else means the
# envelope bytes themselves were damaged (the CRC only covers the payload,
# so a flipped bit in an envelope KEY would otherwise go unnoticed)
_ENVELOPE_KEYS = frozenset({"version", "seq", "count", "crc", "payload"})


class WriteAheadLog:
    def __init__(self, dirpath: str):
        self.dir = os.path.abspath(dirpath)
        os.makedirs(self.dir, exist_ok=True)
        # seq numbering continues past everything ever named on disk —
        # including snapshots' coverage, so a post-recovery append can never
        # collide with a truncated-away segment's seq.  A group segment is
        # named by its FIRST seq but owns a run of them, so the tail comes
        # from the newest segment's record count (a bounded header peek —
        # the payload is never loaded at open time).
        segs = self.segment_seqs()
        tail = segs[-1] + self.segment_record_count(segs[-1]) - 1 \
            if segs else 0
        snaps = max((s for s, _ in self.snapshots()), default=0)
        self._next_seq = max(tail, snaps) + 1
        # file seq replay last stopped at (None = clean); see quarantine_from
        self.replay_stopped_seq: Optional[int] = None
        # called with the absolute path of every freshly sealed segment
        # (segments are immutable once named, so "written" == "sealed");
        # the replication shipper hangs off this to stream segments to a
        # follower.  Must not raise — durability is the local fsync, the
        # hook is best-effort propagation.
        self.on_seal = None

    # -- paths -------------------------------------------------------------
    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"wal-{seq:08d}.msgpack")

    def snapshot_path(self, wal_through: int) -> str:
        """The snapshot file covering every segment with seq <=
        `wal_through` (the coverage is encoded in the name, so recovery
        needs no manifest to pair snapshots with segments)."""
        return os.path.join(self.dir, f"snapshot-{wal_through:08d}.msgpack")

    # -- scan --------------------------------------------------------------
    def segment_seqs(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _SEG_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def snapshots(self) -> List[Tuple[int, str]]:
        """[(wal_through, path)] sorted oldest -> newest."""
        out = []
        for name in os.listdir(self.dir):
            m = _SNAP_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, name)))
        return sorted(out)

    def latest_snapshot(self) -> Optional[Tuple[int, str]]:
        snaps = self.snapshots()
        return snaps[-1] if snaps else None

    @property
    def last_seq(self) -> int:
        """Seq of the most recently appended segment (0 if none ever)."""
        return self._next_seq - 1

    # -- append ------------------------------------------------------------
    def append(self, record: dict) -> int:
        """Durably append one record as its own segment.  Returns the seq.
        When this returns, the record survives kill -9 / power loss."""
        seq = self._next_seq
        payload = packing.packb(record)
        envelope = packing.packb({
            "version": SEGMENT_VERSION,
            "seq": seq,
            "crc": zlib.crc32(payload),
            "payload": payload,
        })
        tel = get_telemetry()
        with tel.span("wal.append", seq=seq, bytes=len(envelope)):
            atomic_write_bytes(self._seg_path(seq), envelope)
        tel.inc("memori_wal_appends", help="WAL segments appended")
        self._next_seq = seq + 1
        if self.on_seal is not None:
            self.on_seal(self._seg_path(seq))
        return seq

    def append_group(self, records: List[dict]) -> Tuple[int, int]:
        """Group commit: durably append several records as ONE segment file
        (one atomic write, one fsync).  The file is named by the first seq
        and owns `len(records)` consecutive seqs; its CRC covers the whole
        group, so a torn / corrupt group replays all-or-nothing — recovery
        can never apply a prefix of a group.  Returns (first_seq, last_seq).

        This is what coalesces a multi-writer scheduler tick (batched
        flush + evictions + compaction) into a single fsync instead of one
        per mutation (see LifecycleRuntime.group_commit for the commit
        ordering contract)."""
        records = list(records)
        if not records:
            raise ValueError("append_group needs at least one record")
        if len(records) == 1:
            seq = self.append(records[0])
            return seq, seq
        first = self._next_seq
        payload = packing.packb(records)
        envelope = packing.packb({
            "version": SEGMENT_VERSION,
            "seq": first,
            "count": len(records),
            "crc": zlib.crc32(payload),
            "payload": payload,
        })
        tel = get_telemetry()
        with tel.span("wal.group_commit", seq=first, records=len(records),
                      bytes=len(envelope)):
            atomic_write_bytes(self._seg_path(first), envelope)
        tel.inc("memori_wal_group_commits",
                help="multi-record WAL group-commit segments")
        self._next_seq = first + len(records)
        if self.on_seal is not None:
            self.on_seal(self._seg_path(first))
        return first, first + len(records) - 1

    # -- read / replay -----------------------------------------------------
    def segment_record_count(self, seq: int) -> int:
        """Record count of one segment from its envelope header alone — a
        bounded read that never loads the payload (flush payloads carry raw
        embedding vectors and can be large).  The envelope packs its keys
        in order (version, seq, [count], crc, payload), so the count, when
        present, always precedes the payload bytes.  Undecodable headers
        count as 1: replay stops at that file regardless."""
        try:
            with open(self._seg_path(seq), "rb") as f:
                head = f.read(96)
            u = packing.Unpacker()
            u.feed(head)
            for _ in range(u.read_map_header()):
                key = u.unpack()
                if key == "payload":
                    break
                val = u.unpack()
                if key == "count":
                    return int(val)
            return 1
        except Exception:
            return 1

    def quarantine_from(self, file_seq: int) -> List[str]:
        """Set aside every segment file with name seq >= `file_seq`
        (renamed to `*.corrupt`, invisible to scans but preserved for
        forensics).  Called by recovery when replay stops inside the log:
        the un-replayable tail must not keep shadowing the seq space —
        otherwise records appended AFTER the remount would sit behind the
        corrupt file forever and every future recovery would silently drop
        them despite their acknowledged-durable fsync."""
        moved = []
        for seq in self.segment_seqs():
            if seq >= file_seq:
                path = self._seg_path(seq)
                faults.active().replace(path, path + ".corrupt")
                moved.append(os.path.basename(path) + ".corrupt")
        if moved:
            fsync_dir(self.dir)
            get_telemetry().event("wal_quarantine", dir=self.dir,
                                  from_seq=int(file_seq), files=moved)
            warnings.warn(f"WAL quarantined un-replayable tail: {moved}",
                          stacklevel=2)
        return moved

    def file_seq_of(self, record_seq: int) -> int:
        """The name seq of the segment file holding `record_seq` (group
        files own a run of record seqs past their name)."""
        owner = 0
        for seq in self.segment_seqs():
            if seq <= record_seq:
                owner = seq
        return owner

    def _read_env(self, seq: int):
        """Decode + validate one segment file's envelope; returns
        (count, decoded payload) — a dict for single-record segments, a
        list for groups.  Raises CorruptSegmentError."""
        with open(self._seg_path(seq), "rb") as f:
            raw = f.read()
        try:
            env = packing.unpackb(raw)
            version, crc = env["version"], env["crc"]
            payload = env["payload"]
        except Exception as e:
            raise CorruptSegmentError(f"segment {seq}: undecodable ({e})")
        extra = set(env) - _ENVELOPE_KEYS
        if extra:
            raise CorruptSegmentError(
                f"segment {seq}: unknown envelope fields {sorted(extra)}")
        if version != SEGMENT_VERSION:
            raise CorruptSegmentError(
                f"segment {seq}: version {version} != {SEGMENT_VERSION}")
        if env.get("seq") != seq:
            raise CorruptSegmentError(
                f"segment file {seq} claims seq {env.get('seq')}")
        if zlib.crc32(payload) != crc:
            raise CorruptSegmentError(f"segment {seq}: checksum mismatch")
        count = int(env.get("count", 1))
        decoded = packing.unpackb(payload)
        if count > 1:
            if not isinstance(decoded, list) or len(decoded) != count:
                raise CorruptSegmentError(
                    f"segment {seq}: group claims {count} records, payload "
                    f"holds {len(decoded) if isinstance(decoded, list) else 1}")
        elif not isinstance(decoded, dict):
            # records are dicts by contract; a list here means a group's
            # count field was corrupted down to 1 — the payload CRC cannot
            # catch that (the payload is intact, the envelope is not)
            raise CorruptSegmentError(
                f"segment {seq}: single-record payload decodes to "
                f"{type(decoded).__name__}, not a record")
        return count, decoded

    def read_segment(self, seq: int) -> dict:
        """Decode + validate one single-record segment; raises
        CorruptSegmentError (group segments read via read_records)."""
        count, decoded = self._read_env(seq)
        if count > 1:
            raise CorruptSegmentError(
                f"segment {seq} is a {count}-record group; use "
                "read_records()")
        return decoded

    def read_records(self, seq: int) -> List[dict]:
        """Decode + validate one segment file into its record list (length
        1 for classic segments)."""
        count, decoded = self._read_env(seq)
        return decoded if count > 1 else [decoded]

    def replay_records(self, after_seq: int = 0
                       ) -> Iterator[Tuple[int, dict]]:
        """Yield (seq, record) in order for every valid record with
        seq > after_seq — group segments expand to their consecutive seq
        run.  Replay stops at the first invalid segment (with a warning):
        everything after an undecodable record has unknown provenance and
        must not be applied.  Where replay stopped is left in
        `replay_stopped_seq` (the FILE's name seq) so recovery can
        quarantine the dead tail before accepting new appends."""
        self.replay_stopped_seq = None
        segs = self.segment_seqs()
        for i, seq in enumerate(segs):
            if seq <= after_seq:
                # records are consecutive across segment files, so this
                # file ends at segs[i+1] - 1: when that is still <= the
                # coverage, skip by name alone — no read, no checksum (only
                # the last covered file, whose extent the name alone can't
                # bound, needs decoding to find a straddling group tail)
                nxt = segs[i + 1] if i + 1 < len(segs) else None
                if nxt is not None and nxt <= after_seq + 1:
                    continue
            try:
                records = self.read_records(seq)
            except CorruptSegmentError as e:
                # fully-covered corrupt files were already skipped by name
                # above; reaching here means this file's extent cannot be
                # bounded without decoding it — it may be a group whose
                # tail straddles past the coverage, so nothing after it
                # may be applied
                self.replay_stopped_seq = seq
                warnings.warn(f"WAL replay stopped: {e}", stacklevel=2)
                return
            for j, rec in enumerate(records):
                if seq + j <= after_seq:
                    continue
                yield seq + j, rec

    # -- rotation ----------------------------------------------------------
    def commit_snapshot(self, wal_through: int, retain: int = 2) -> dict:
        """Called after the snapshot file for `wal_through` is atomically in
        place: re-point the manifest, prune generations beyond `retain`, and
        truncate segments no retained generation still needs.  Returns a
        summary dict (snapshots kept, segments dropped)."""
        snaps = self.snapshots()
        if wal_through not in [s for s, _ in snaps]:
            raise FileNotFoundError(
                f"no snapshot file for wal_through={wal_through}")
        keep = snaps[-retain:] if retain else snaps
        # carry each retained generation's recorded birth forward; the one
        # being committed (no prior record) is born now.  Births live in the
        # manifest, not in file mtimes: a restore/copy rewrites mtimes, and
        # the mount path's snapshot-age accounting must survive that.
        births = self.snapshot_births()
        now = time.time()
        self.write_manifest(keep, {s: births.get(s, now) for s, _ in keep})
        dropped_snaps = 0
        for through, path in snaps[:-retain] if retain else []:
            faults.active().unlink(path)
            dropped_snaps += 1
        # only segments every retained snapshot already covers may go
        oldest_covered = min(s for s, _ in keep)
        dropped_segs = 0
        for seq in self.segment_seqs():
            if seq <= oldest_covered:
                faults.active().unlink(self._seg_path(seq))
                dropped_segs += 1
        fsync_dir(self.dir)
        return {"retained_snapshots": len(keep),
                "dropped_snapshots": dropped_snaps,
                "truncated_segments": dropped_segs}

    # -- manifest (advisory: recovery trusts the directory scan) -----------
    def write_manifest(self, snaps: List[Tuple[int, str]],
                       births: Optional[Dict[int, float]] = None) -> None:
        births = births or {}
        entries = []
        for s, p in snaps:
            entry = {"wal_through": s, "name": os.path.basename(p)}
            if s in births:
                entry["born_unix"] = float(births[s])
            entries.append(entry)
        atomic_write_bytes(os.path.join(self.dir, MANIFEST_NAME),
                           packing.packb({
                               "version": SEGMENT_VERSION,
                               "snapshots": entries,
                           }))

    def snapshot_births(self) -> Dict[int, float]:
        """Recorded creation time (unix) per snapshot generation, from the
        manifest.  Generations committed before births were recorded are
        simply absent — callers fall back to (clamped) file mtime."""
        manifest = self.read_manifest()
        if not manifest:
            return {}
        out: Dict[int, float] = {}
        for entry in manifest.get("snapshots", []):
            try:
                if "born_unix" in entry:
                    out[int(entry["wal_through"])] = float(entry["born_unix"])
            except (TypeError, ValueError, KeyError):
                continue
        return out

    def read_manifest(self) -> Optional[dict]:
        path = os.path.join(self.dir, MANIFEST_NAME)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return packing.unpackb(f.read())
