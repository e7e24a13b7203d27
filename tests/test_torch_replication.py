"""The port's replicated durability layer (`repro_torch/checkpoint/
replication.py`) on the cases of the reference's tests/test_replication.py:
per-shard WAL ownership with cross-shard commit records, the segment
shipper streaming sealed segments to a follower sink, recover-from-follower
helpers, and the WAL corruption fuzz suite — random bit flips /
truncations over sealed segments must always yield quarantine-and-stop,
never a silent skip or a wrong replay.  Across the packages: the same
mutations journaled by a sharded JAX `MemoryService` and a sharded port
service write byte-identical coordinator and `shard-NN/` segments and
snapshots, and each package recovers the other's sharded directory to the
same answers."""
import os
import random
import shutil
import warnings

import numpy as np
import pytest

from repro_torch.checkpoint import faults
from repro_torch.checkpoint.faults import FaultRule, FaultyFS, InjectedCrash
from repro_torch.checkpoint.replication import (DirectorySink,
                                                SegmentShipper, ShardedWal,
                                                clone_from_follower,
                                                detect_shards, open_wal,
                                                restore_missing_from_follower)
from repro_torch.checkpoint.wal import WriteAheadLog, atomic_write_bytes
from repro_torch.core import HashEmbedder, MemoryService, Message


def _flush(parts, ns_ids=None):
    rec = {"op": "sharded_flush", "parts": [[s, p] for s, p in parts]}
    if ns_ids is not None:
        rec["ns_ids"] = ns_ids
    return rec


def _replay(wal):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return list(wal.replay_records())


# -- commit protocol -----------------------------------------------------------

def test_sharded_flush_round_trips_through_decompose_and_reinflate(tmp_path):
    d = str(tmp_path / "w")
    wal = ShardedWal(d, 2)
    f1 = _flush([(0, {"rows": [1, 2]}), (1, {"rows": [3]})],
                ns_ids={"alice": 0, "bob": 1})
    wal.append(f1)
    wal.append({"op": "evict", "ns": "alice", "ids": [2]})
    # layout: parts live in the shard logs, the coordinator holds ONE
    # commit record per flush (never the vectors themselves)
    assert os.path.isfile(os.path.join(d, "shard-00", "wal-00000001.msgpack"))
    assert os.path.isfile(os.path.join(d, "shard-01", "wal-00000001.msgpack"))
    commit = wal.commit.read_segment(1)
    assert commit["op"] == "shard_commit"
    assert commit["parts"] == [[0, 1], [1, 1]]
    assert commit["ns_ids"] == {"alice": 0, "bob": 1}
    got = _replay(ShardedWal(d, 2))
    assert got == [(1, f1), (2, {"op": "evict", "ns": "alice", "ids": [2]})]


def test_shardedwal_rejects_single_shard_and_out_of_range_parts(tmp_path):
    with pytest.raises(ValueError):
        ShardedWal(str(tmp_path / "a"), 1)
    wal = ShardedWal(str(tmp_path / "b"), 2)
    with pytest.raises(ValueError):
        wal.append(_flush([(5, {"rows": [1]})]))


def test_crash_before_commit_record_leaves_invisible_orphan(tmp_path):
    """Shard parts land first; the flush is durable iff the commit record
    is.  Crash between the two => the shard segment is an orphan replay
    never references."""
    fs = FaultyFS(str(tmp_path),
                  rules=[FaultRule("replace", path_substr="w/wal-00000001")])
    d = str(tmp_path / "w")
    with faults.install(fs):
        wal = ShardedWal(d, 2)
        with pytest.raises(InjectedCrash):
            wal.append(_flush([(0, {"rows": [1]})]))
        fs.simulate_power_loss()
    # the shard part survived (it was fsync'd before the coordinator write)
    assert os.path.isfile(os.path.join(d, "shard-00", "wal-00000001.msgpack"))
    wal2 = ShardedWal(d, 2)
    assert _replay(wal2) == []
    assert wal2.replay_stopped_seq is None      # orphan, not corruption


def test_group_commit_is_all_or_nothing_across_shards(tmp_path):
    fs = FaultyFS(str(tmp_path),
                  rules=[FaultRule("replace", path_substr="w/wal-00000002")])
    d = str(tmp_path / "w")
    with faults.install(fs):
        wal = ShardedWal(d, 2)
        f1 = _flush([(0, {"rows": [1]})])
        wal.append(f1)
        with pytest.raises(InjectedCrash):
            wal.append_group([_flush([(0, {"rows": [2]}), (1, {"rows": [3]})]),
                              {"op": "evict", "ns": "a", "ids": [1]}])
        fs.simulate_power_loss()
    # both shards' parts of the crashed group are durable orphans ...
    assert os.path.isfile(os.path.join(d, "shard-00", "wal-00000002.msgpack"))
    assert os.path.isfile(os.path.join(d, "shard-01", "wal-00000001.msgpack"))
    # ... but the group as a whole never happened
    assert _replay(ShardedWal(d, 2)) == [(1, f1)]


def test_rotation_reaps_orphaned_and_covered_shard_segments(tmp_path):
    fs = FaultyFS(str(tmp_path),
                  rules=[FaultRule("replace", path_substr="w/wal-00000002",
                                   nth=1)])
    d = str(tmp_path / "w")
    with faults.install(fs):
        wal = ShardedWal(d, 2)
        wal.append(_flush([(0, {"rows": [1]})]))
        with pytest.raises(InjectedCrash):        # orphans shard-00 seq 2
            wal.append(_flush([(0, {"rows": [2]})]))
        fs.simulate_power_loss()
    wal = ShardedWal(d, 2)
    wal.append(_flush([(0, {"rows": [3]}), (1, {"rows": [4]})]))  # seq 2
    assert len(wal.shards[0].segment_seqs()) == 3   # incl. the orphan
    atomic_write_bytes(wal.snapshot_path(2), b"snapshot-bytes")
    info = wal.commit_snapshot(2, retain=1)
    # every commit is covered by the snapshot: all shard segments —
    # covered AND orphaned — are unreferenced now
    assert info["truncated_shard_segments"] == 4
    assert wal.shards[0].segment_seqs() == []
    assert wal.shards[1].segment_seqs() == []
    assert _replay(ShardedWal(d, 2)) == []


def test_rotation_keeps_shard_segments_still_referenced(tmp_path):
    d = str(tmp_path / "w")
    wal = ShardedWal(d, 2)
    wal.append(_flush([(0, {"rows": [1]})]))                    # seq 1
    f2 = _flush([(0, {"rows": [2]}), (1, {"rows": [3]})])
    wal.append(f2)                                              # seq 2
    atomic_write_bytes(wal.snapshot_path(1), b"snapshot-bytes")
    info = wal.commit_snapshot(1, retain=1)
    # commit 2 is past the snapshot: its parts must survive the GC
    assert info["truncated_shard_segments"] == 1                # only seq-1's
    assert wal.shards[0].segment_seqs() == [2]
    assert wal.shards[1].segment_seqs() == [1]
    assert _replay(ShardedWal(d, 2)) == [(2, f2)]


def test_missing_shard_part_stops_replay_at_the_commit_record(tmp_path):
    d = str(tmp_path / "w")
    wal = ShardedWal(d, 2)
    f1 = _flush([(0, {"rows": [1]}), (1, {"rows": [2]})])
    f2 = _flush([(0, {"rows": [3]}), (1, {"rows": [4]})])
    f3 = _flush([(1, {"rows": [5]})])
    for f in (f1, f2, f3):
        wal.append(f)
    os.unlink(os.path.join(d, "shard-01", "wal-00000002.msgpack"))  # f2's part
    wal2 = ShardedWal(d, 2)
    with pytest.warns(UserWarning, match="replay stopped"):
        got = list(wal2.replay_records())
    assert got == [(1, f1)]                     # consistent prefix, never
    assert wal2.replay_stopped_seq == 2         # a partial flush
    # quarantine the dead tail, remount, and keep appending cleanly
    with pytest.warns(UserWarning, match="quarantined"):
        wal2.quarantine_from(2)
    wal3 = ShardedWal(d, 2)
    f4 = _flush([(0, {"rows": [6]})])
    wal3.append(f4)
    got = _replay(ShardedWal(d, 2))
    assert [r for _, r in got] == [f1, f4]
    assert ShardedWal(d, 2).replay_stopped_seq is None


def test_corrupt_shard_part_stops_replay_at_the_commit_record(tmp_path):
    d = str(tmp_path / "w")
    wal = ShardedWal(d, 2)
    f1 = _flush([(1, {"rows": [1]})])
    f2 = _flush([(0, {"rows": [2]})])
    wal.append(f1), wal.append(f2)
    p = os.path.join(d, "shard-00", "wal-00000001.msgpack")
    with open(p, "rb") as f:
        raw = bytearray(f.read())
    raw[len(raw) // 2] ^= 0x40
    with open(p, "wb") as f:
        f.write(bytes(raw))
    wal2 = ShardedWal(d, 2)
    got = _replay(wal2)
    assert got == [(1, f1)]
    assert wal2.replay_stopped_seq == 2


# -- open / detect helpers -----------------------------------------------------

def test_detect_shards(tmp_path):
    assert detect_shards(str(tmp_path / "missing")) == 0
    d = tmp_path / "w"
    d.mkdir()
    assert detect_shards(str(d)) == 0
    (d / "shard-00").mkdir(), (d / "shard-01").mkdir()
    assert detect_shards(str(d)) == 2
    (d / "shard-03").mkdir()                    # gap: shard-02 lost
    with pytest.raises(ValueError, match="missing"):
        detect_shards(str(d))


def test_open_wal_autodetects_and_validates(tmp_path):
    fresh = str(tmp_path / "a")
    assert isinstance(open_wal(fresh), WriteAheadLog)
    sharded_dir = str(tmp_path / "b")
    wal = open_wal(sharded_dir, shards=4)
    assert isinstance(wal, ShardedWal) and wal.n_shards == 4
    auto = open_wal(sharded_dir)                # layout remembers the count
    assert isinstance(auto, ShardedWal) and auto.n_shards == 4
    with pytest.raises(ValueError, match="4-shard"):
        open_wal(sharded_dir, shards=3)
    assert isinstance(open_wal(str(tmp_path / "c"), shards=1), WriteAheadLog)


# -- segment shipping ----------------------------------------------------------

def test_shipper_streams_sealed_segments_to_the_sink(tmp_path):
    d, fdir = str(tmp_path / "w"), str(tmp_path / "follower")
    wal = WriteAheadLog(d)
    sink = DirectorySink(fdir)
    shipper = SegmentShipper(d, sink, mode="sync")
    wal.on_seal = shipper
    wal.append({"op": "a"})
    wal.append_group([{"op": "b"}, {"op": "c"}])
    assert sink.list() == ["wal-00000001.msgpack", "wal-00000002.msgpack"]
    assert shipper.counters == {"shipped": 2, "failed": 0, "queued": 0}
    for rel in sink.list():                     # byte-identical replicas
        with open(os.path.join(d, rel), "rb") as f:
            assert sink.get(rel) == f.read()


def test_shipper_covers_shard_logs_through_one_on_seal_hook(tmp_path):
    d, fdir = str(tmp_path / "w"), str(tmp_path / "follower")
    wal = ShardedWal(d, 2)
    sink = DirectorySink(fdir)
    wal.on_seal = SegmentShipper(d, sink, mode="sync")
    wal.append(_flush([(0, {"rows": [1]}), (1, {"rows": [2]})]))
    assert sink.list() == ["shard-00/wal-00000001.msgpack",
                           "shard-01/wal-00000001.msgpack",
                           "wal-00000001.msgpack"]


def test_ship_failure_is_counted_never_raised_into_append(tmp_path):
    class BrokenSink:
        def put(self, rel, blob):
            raise OSError("sink offline")

        def has(self, rel):
            return False

    d = str(tmp_path / "w")
    wal = WriteAheadLog(d)
    shipper = SegmentShipper(d, BrokenSink(), mode="sync")
    wal.on_seal = shipper
    with pytest.warns(UserWarning, match="ship failed"):
        seq = wal.append({"op": "a"})           # append itself succeeds:
    assert seq == 1                             # local fsync is durability,
    assert shipper.counters["failed"] == 1      # shipping is replication


def test_ship_fault_point_and_slow_sink_delay(tmp_path):
    fs = FaultyFS(str(tmp_path), rules=[
        FaultRule("ship", path_substr="wal-00000001"),
        FaultRule("ship", mode="delay", delay_s=0.01,
                  path_substr="wal-00000002")])
    d, fdir = str(tmp_path / "w"), str(tmp_path / "follower")
    with faults.install(fs):
        wal = WriteAheadLog(d)
        sink = DirectorySink(fdir)
        shipper = SegmentShipper(d, sink, mode="sync")
        wal.on_seal = shipper
        with pytest.warns(UserWarning, match="ship failed"):
            wal.append({"op": "a"})             # crash point: ship fails,
        wal.append({"op": "b"})                 # slow sink: just latency
    assert shipper.counters == {"shipped": 1, "failed": 1, "queued": 0}
    assert sink.list() == ["wal-00000002.msgpack"]
    assert [t[:2] for t in fs.trips] == [("ship", "crash"), ("ship", "delay")]


def test_async_shipper_drains_off_the_append_path(tmp_path):
    d, fdir = str(tmp_path / "w"), str(tmp_path / "follower")
    wal = WriteAheadLog(d)
    sink = DirectorySink(fdir)
    shipper = SegmentShipper(d, sink, mode="async")
    wal.on_seal = shipper
    try:
        for op in ("a", "b", "c"):
            wal.append({"op": op})
        shipper.drain()
        assert shipper.counters["shipped"] == 3
        assert len(sink.list()) == 3
    finally:
        shipper.close()


def test_ship_existing_backfills_only_what_the_sink_lacks(tmp_path):
    d, fdir = str(tmp_path / "w"), str(tmp_path / "follower")
    wal = ShardedWal(d, 2)
    wal.append(_flush([(0, {"rows": [1]})]))
    wal.append({"op": "evict", "ns": "a", "ids": [1]})
    sink = DirectorySink(fdir)
    shipper = SegmentShipper(d, sink, mode="sync")
    assert shipper.ship_existing() == 3         # 2 coordinator + 1 shard seg
    assert shipper.ship_existing() == 0         # idempotent
    assert len(sink.list()) == 3


# -- recover from follower -----------------------------------------------------

def test_restore_missing_skips_existing_and_quarantined_twins(tmp_path):
    fdir, d = str(tmp_path / "follower"), str(tmp_path / "data")
    sink = DirectorySink(fdir)
    sink.put("wal-00000001.msgpack", b"one")
    sink.put("wal-00000002.msgpack", b"two")
    sink.put("shard-00/wal-00000001.msgpack", b"part")
    os.makedirs(d)
    with open(os.path.join(d, "wal-00000001.msgpack"), "wb") as f:
        f.write(b"local-is-newer")
    # a quarantined twin means local recovery already rejected this file:
    # re-materializing it would resurrect the corrupt tail
    with open(os.path.join(d, "wal-00000002.msgpack.corrupt"), "wb") as f:
        f.write(b"dead")
    restored = restore_missing_from_follower(sink, d)
    assert restored == ["shard-00/wal-00000001.msgpack"]
    with open(os.path.join(d, "wal-00000001.msgpack"), "rb") as f:
        assert f.read() == b"local-is-newer"
    assert not os.path.exists(os.path.join(d, "wal-00000002.msgpack"))


def test_clone_from_follower_requires_empty_target(tmp_path):
    sink = DirectorySink(str(tmp_path / "follower"))
    sink.put("wal-00000001.msgpack", b"one")
    tgt = tmp_path / "data"
    tgt.mkdir()
    (tgt / "stale").write_bytes(b"x")
    with pytest.raises(ValueError, match="not empty"):
        clone_from_follower(sink, str(tgt))


def test_losing_the_host_entirely_recovers_from_shipped_segments(tmp_path):
    d, fdir = str(tmp_path / "w"), str(tmp_path / "follower")
    wal = ShardedWal(d, 2)
    sink = DirectorySink(fdir)
    shipper = SegmentShipper(d, sink, mode="sync")
    wal.on_seal = shipper
    flushes = [_flush([(i % 2, {"rows": [i]})], ns_ids={"t": i % 2})
               for i in range(5)]
    for f in flushes:
        wal.append(f)
    expected = _replay(ShardedWal(d, 2))
    shutil.rmtree(d)                            # the host is gone
    clone_from_follower(sink, d)
    recovered = open_wal(d)                     # autodetects 2 shards
    assert isinstance(recovered, ShardedWal) and recovered.n_shards == 2
    assert _replay(recovered) == expected
    assert recovered.replay_stopped_seq is None


# -- corruption fuzz: the recovery oracle --------------------------------------
#
# Property: whatever a bit flip or truncation does to one sealed segment,
# replay yields an EXACT PREFIX of the pristine record sequence and flags
# where it stopped — never a silently skipped or altered record.  After
# quarantining the flagged tail, a remount replays that same prefix
# cleanly.

def _corrupt_file(path, rng):
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    if rng.random() < 0.4:
        cut = rng.randrange(0, len(raw))
        blob, what = bytes(raw[:cut]), f"truncate@{cut}"
    else:
        flips = rng.choice([1, 1, 2])
        picks = set()
        while len(picks) < flips:                # distinct bits: two flips
            picks.add((rng.randrange(len(raw)),  # must never cancel out
                       rng.randrange(8)))
        for i, b in picks:
            raw[i] ^= 1 << b
        blob, what = bytes(raw), f"bitflip x{flips}"
    with open(path, "wb") as f:
        f.write(blob)
    return what


def test_fuzz_plain_wal_corruption_always_stops_with_exact_prefix(tmp_path):
    rng = random.Random(0xC0FFEE)
    for trial in range(40):
        d = str(tmp_path / f"t{trial:02d}")
        wal = WriteAheadLog(d)
        wal.append({"op": "a", "trial": trial})
        wal.append_group([{"op": "b", "i": i} for i in range(3)])
        wal.append({"op": "c"})
        wal.append_group([{"op": "d", "i": i} for i in range(2)])
        wal.append({"op": "e"})
        pristine = _replay(WriteAheadLog(d))
        file_seqs = wal.segment_seqs()          # [1, 2, 5, 6, 8]
        victim = rng.choice(file_seqs)
        what = _corrupt_file(wal._seg_path(victim), rng)
        mounted = WriteAheadLog(d)
        got = _replay(mounted)
        expect = [(s, r) for s, r in pristine if wal.file_seq_of(s) < victim]
        assert got == expect, f"trial {trial} ({what} in seq {victim})"
        assert mounted.replay_stopped_seq == victim, \
            f"trial {trial} ({what} in seq {victim}): corruption not flagged"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mounted.quarantine_from(mounted.replay_stopped_seq)
        clean = WriteAheadLog(d)
        assert _replay(clean) == expect
        assert clean.replay_stopped_seq is None


def test_fuzz_sharded_wal_corruption_always_stops_with_exact_prefix(tmp_path):
    rng = random.Random(0xFEEDFACE)
    for trial in range(25):
        d = str(tmp_path / f"t{trial:02d}")
        wal = ShardedWal(d, 2)
        wal.append(_flush([(0, {"rows": [1]}), (1, {"rows": [2]})],
                          ns_ids={"t": 0}))
        wal.append({"op": "evict", "ns": "t", "ids": [1]})
        wal.append_group([_flush([(1, {"rows": [3]})]),
                          _flush([(0, {"rows": [4]}), (1, {"rows": [5]})])])
        wal.append(_flush([(0, {"rows": [6]})]))
        pristine = _replay(ShardedWal(d, 2))
        victims = []                            # every sealed segment file
        for dirpath, _, names in os.walk(d):
            victims += [os.path.join(dirpath, n) for n in sorted(names)
                        if n.startswith("wal-") and n.endswith(".msgpack")]
        victim = rng.choice(victims)
        what = _corrupt_file(victim, rng)
        mounted = ShardedWal(d, 2)
        got = _replay(mounted)
        label = f"trial {trial} ({what} in {os.path.relpath(victim, d)})"
        assert len(got) < len(pristine), f"{label}: corruption unnoticed"
        assert got == pristine[:len(got)], f"{label}: not an exact prefix"
        stopped = mounted.replay_stopped_seq
        assert stopped is not None, f"{label}: stop not flagged"
        # quarantine works at file granularity: a damaged shard part can
        # stop replay mid-group, and the group's earlier records fall with
        # the quarantined coordinator file (recovery snapshots the applied
        # prefix before dropping the tail — see docs/OPERATIONS.md)
        kept = [(s, r) for s, r in got if mounted.file_seq_of(s) < stopped]
        assert kept == pristine[:len(kept)], f"{label}: bad kept prefix"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mounted.quarantine_from(stopped)
        clean = ShardedWal(d, 2)
        assert _replay(clean) == kept
        assert clean.replay_stopped_seq is None


# -- across the packages: a sharded directory ----------------------------------

QUERIES = [("alice/c0", "Which city does the user live in?"),
           ("bob/c0", "What pet was adopted?"),
           ("alice/c0", "What is the user's job?"),
           ("dave/c0", "Which city does the user live in?"),
           ("erin/c0", "Which city does the user live in?"),
           ("ghost/c0", "anything?")]


def _session(texts, speaker, cls, ts=1700000000.0):
    return [cls(speaker, t, ts) for t in texts]


def _sharded_churn(svc, cls):
    """Sharded flushes across shards (one of several sessions), a rotation,
    a group commit with a link, both evictions and a compaction."""
    svc.enqueue("alice/c0", "s0", _session(
        ["I live in Tallinn.", "I work as a botanist."], "Alice", cls))
    svc.enqueue("bob/c0", "s0", _session(
        ["I adopted a parrot named Olive."], "Bob", cls))
    svc.enqueue("carol/c0", "s0", _session(["I collect stamps."], "Carol",
                                           cls))
    svc.flush()
    svc.record("alice/c0", "s1", _session(["I work as a welder."], "Alice",
                                          cls, ts=1700000100.0))
    svc.rotate()
    with svc.runtime.group_commit():
        svc.record("dave/c0", "s0", _session(
            ["I live in Hanoi.", "I adopted a dog named Rex."], "Dave", cls))
        svc.record("erin/c0", "s0", _session(["I live in Lima."], "Erin",
                                             cls))
        svc.store.link("erin/c0", "Erin", "Lima", "temporal", 0.5)
    svc.evict_superseded("alice/c0")
    svc.evict("carol/c0")
    svc.compact()
    svc.record("bob/c0", "s1", _session(["I live in Porto."], "Bob", cls))


def _tree(d):
    """Every segment and snapshot file under `d` (the manifest holds the
    snapshots' birth times, so it is left out)."""
    out = {}
    for dirpath, _, names in os.walk(d):
        for n in names:
            if not n.startswith(("wal-", "snapshot-")):
                continue
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _texts(svc):
    return [(c.text, [t.text() for t in c.triples], c.token_count)
            for c in svc.retrieve_batch(QUERIES)]


@pytest.fixture(scope="module")
def sharded_dirs(tmp_path_factory):
    from repro.core import MemoryService as JService
    from repro.core.embedder import HashEmbedder as JEmb
    from repro.core.extraction import Message as JMessage
    root = tmp_path_factory.mktemp("sharded")
    a, b = str(root / "jax"), str(root / "torch")
    fa, fb = str(root / "jax-follower"), str(root / "torch-follower")
    jsvc = JService(JEmb(), use_kernel=False, budget=800, shards=3,
                    data_dir=a)
    tsvc = MemoryService(HashEmbedder(device="cpu"), device="cpu",
                         budget=800, shards=3, data_dir=b)
    jsvc.attach_follower(fa)
    tsvc.attach_follower(fb)
    _sharded_churn(jsvc, JMessage)
    _sharded_churn(tsvc, Message)
    return jsvc, tsvc, (a, b, fa, fb)


def test_both_packages_journal_byte_identical_sharded_segments(sharded_dirs):
    jsvc, tsvc, (a, b, fa, fb) = sharded_dirs
    got_a, got_b = _tree(a), _tree(b)
    assert sorted(got_a) == sorted(got_b)
    assert any(n.startswith("shard-01/wal-") for n in got_a)
    assert any(n.startswith("snapshot-") for n in got_a)
    for name in got_a:
        assert got_a[name] == got_b[name], f"{name} differs"
    assert _tree(fa) == _tree(fb)                 # the followers too
    assert tsvc.stats()["replication"] == jsvc.stats()["replication"]
    assert tsvc.store.sharded.stats()["per_shard_rows"] == \
        jsvc.store.sharded.stats()["per_shard_rows"]
    assert _texts(tsvc) == _texts(jsvc)


def test_each_package_recovers_the_others_sharded_directory(sharded_dirs):
    from repro.core import MemoryService as JService
    from repro.core.embedder import HashEmbedder as JEmb
    jsvc, tsvc, (a, b, _, _) = sharded_dirs
    want = _texts(jsvc)
    assert any(t for t, _, _ in want)
    port = MemoryService.recover(a, HashEmbedder(device="cpu"),
                                 device="cpu", budget=800)
    back = JService.recover(b, JEmb(), use_kernel=False, budget=800)
    assert port.store.shards == back.store.shards == 3
    assert _texts(port) == want
    assert _texts(back) == want
    np.testing.assert_array_equal(port.vindex.bank,
                                  np.asarray(jsvc.vindex.bank))
    np.testing.assert_array_equal(np.asarray(back.vindex.bank),
                                  tsvc.vindex.bank)
    for svc in (port, back):
        svc.close(final_snapshot=False)
