"""Durability of the port (M3): `checkpoint/faults.py`, `checkpoint/wal.py`,
`core/lifecycle.py`, the store's WAL hooks and the service's
recover/rotate/close, on `device="cpu"`.  The cases of the reference's
tests/test_lifecycle.py and tests/test_faults.py, run on the port (the
reference's zero-recompile case becomes zero bank re-uploads); the
background flusher against a concurrent reader; a kill -9 of a writer
that runs the port alone; and, across the packages, the same mutations
journaled by the JAX `MemoryService(data_dir=..., use_kernel=False)` and
the port write byte-identical segments and snapshots, and each package
recovers the other's directory to byte-identical contexts."""
import errno
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st_

from repro_torch.checkpoint import faults, io
from repro_torch.checkpoint.faults import (FaultRule, FaultyFS, InjectedCrash,
                                           RealFS)
from repro_torch.checkpoint.wal import (CorruptSegmentError, WriteAheadLog,
                                        atomic_write_bytes)
from repro_torch.core import (BackpressureError, HashEmbedder,
                              LifecyclePolicy, LifecycleRuntime,
                              MemoryService, MemoryStore, Message)
from repro_torch.core import bm25 as bm25_mod
from repro_torch.core import vector_index as vi_mod

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")


def _session(texts, speaker="Caroline", ts=1700000000.0, cls=Message):
    return [cls(speaker, t, ts) for t in texts]


def _emb():
    return HashEmbedder(device="cpu")


def _store(emb=None):
    return MemoryStore(emb or _emb(), device="cpu")


def _mounted(tmp_path, policy=None, start=False, emb=None):
    """(service, runtime) on a durable dir, daemon off unless asked."""
    rt = LifecycleRuntime(_store(emb), data_dir=str(tmp_path / "data"),
                          policy=policy, start=start)
    return MemoryService(runtime=rt, budget=800), rt


def _recover(d):
    return MemoryService.recover(str(d), _emb(), device="cpu", budget=800)


class CountingEmbedder(HashEmbedder):
    def __init__(self, *a, **kw):
        super().__init__(*a, device="cpu", **kw)
        self.calls = 0

    def embed_texts(self, texts):
        self.calls += 1
        return super().embed_texts(texts)


# -- WAL mechanics -------------------------------------------------------------

def test_wal_append_is_atomic_self_describing_and_ordered(tmp_path):
    wal = WriteAheadLog(str(tmp_path))
    assert wal.append({"op": "a"}) == 1
    assert wal.append({"op": "b"}) == 2
    # stray tmp files (a crash mid-append) are invisible to the scan
    with open(os.path.join(str(tmp_path), "wal-00000099.msgpack.tmp"),
              "wb") as f:
        f.write(b"torn")
    assert wal.segment_seqs() == [1, 2]
    assert [rec["op"] for _, rec in wal.replay_records()] == ["a", "b"]
    assert [rec["op"] for _, rec in wal.replay_records(after_seq=1)] == ["b"]
    # a reopened log continues the seq numbering
    wal2 = WriteAheadLog(str(tmp_path))
    assert wal2.append({"op": "c"}) == 3


def test_wal_group_append_one_file_consecutive_seqs(tmp_path):
    wal = WriteAheadLog(str(tmp_path))
    wal.append({"op": "a"})                                  # seq 1
    first, last = wal.append_group([{"op": "b"}, {"op": "c"}, {"op": "d"}])
    assert (first, last) == (2, 4)
    assert wal.segment_seqs() == [1, 2], "a group is ONE segment file"
    assert wal.segment_record_count(2) == 3
    assert [(s, r["op"]) for s, r in wal.replay_records()] == \
        [(1, "a"), (2, "b"), (3, "c"), (4, "d")]
    assert [r["op"] for s, r in wal.replay_records(after_seq=3)] == ["d"]
    assert wal.read_records(2) == [{"op": "b"}, {"op": "c"}, {"op": "d"}]
    with pytest.raises(CorruptSegmentError, match="group"):
        wal.read_segment(2)              # the single-record reader refuses
    # a reopened log continues numbering past the whole group run (the
    # record count comes from the envelope's header alone)
    wal2 = WriteAheadLog(str(tmp_path))
    assert wal2.append({"op": "e"}) == 5
    assert wal2.append_group([{"op": "f"}]) == (6, 6)
    assert wal2.read_segment(6) == {"op": "f"}


def test_wal_replay_skips_covered_segments_without_reading(
        tmp_path, monkeypatch):
    wal = WriteAheadLog(str(tmp_path))
    for op in ("a", "b", "c"):
        wal.append({"op": op})
    with open(os.path.join(str(tmp_path), "wal-00000001.msgpack"),
              "wb") as f:
        f.write(b"garbage")              # covered AND corrupt
    reads = []
    real = wal.read_records

    def spy(seq):
        reads.append(seq)
        return real(seq)

    monkeypatch.setattr(wal, "read_records", spy)
    assert [r["op"] for _, r in wal.replay_records(after_seq=2)] == ["c"]
    assert reads == [3], f"covered segments were read: {reads}"


def test_wal_torn_group_segment_replays_all_or_nothing(tmp_path):
    wal = WriteAheadLog(str(tmp_path))
    wal.append({"op": "a"})
    wal.append_group([{"op": "b"}, {"op": "c"}])             # seqs 2-3
    wal.append({"op": "late"})                               # seq 4
    path = os.path.join(str(tmp_path), "wal-00000002.msgpack")
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.warns(UserWarning, match="replay stopped"):
        ops = [r["op"] for _, r in wal.replay_records()]
    assert ops == ["a"]
    with pytest.warns(UserWarning, match="replay stopped"):
        got = [r["op"] for _, r in wal.replay_records(after_seq=2)]
    assert got == []


@pytest.mark.parametrize("damage", [b"\x00garbage", b"", b"\x81\xa3bad\x01"],
                         ids=["garbage", "empty", "foreign-envelope"])
def test_wal_replay_stops_at_corruption_and_quarantines(tmp_path, damage):
    wal = WriteAheadLog(str(tmp_path))
    for op in ("a", "b", "c"):
        wal.append({"op": op})
    with open(os.path.join(str(tmp_path), "wal-00000002.msgpack"), "wb") as f:
        f.write(damage)
    with pytest.raises(CorruptSegmentError):
        wal.read_segment(2)
    with pytest.warns(UserWarning, match="replay stopped"):
        ops = [rec["op"] for _, rec in wal.replay_records()]
    assert ops == ["a"], "nothing past a corrupt segment may be applied"
    assert wal.replay_stopped_seq == 2
    with pytest.warns(UserWarning, match="quarantined"):
        moved = wal.quarantine_from(2)
    assert moved == ["wal-00000002.msgpack.corrupt",
                     "wal-00000003.msgpack.corrupt"]
    assert wal.segment_seqs() == [1]


def test_wal_rotation_truncates_only_fully_covered_segments(tmp_path):
    wal = WriteAheadLog(str(tmp_path))
    for i in range(3):
        wal.append({"op": f"r{i}"})
    atomic_write_bytes(wal.snapshot_path(3), b"snap3")
    wal.commit_snapshot(3, retain=2)
    assert wal.segment_seqs() == []
    for i in range(2):
        wal.append({"op": f"s{i}"})          # seqs 4, 5
    atomic_write_bytes(wal.snapshot_path(5), b"snap5")
    info = wal.commit_snapshot(5, retain=2)
    assert info["retained_snapshots"] == 2
    assert wal.segment_seqs() == [4, 5]
    wal.append({"op": "t0"})                 # seq 6
    atomic_write_bytes(wal.snapshot_path(6), b"snap6")
    info = wal.commit_snapshot(6, retain=2)
    assert info["dropped_snapshots"] == 1
    assert sorted(s for s, _ in wal.snapshots()) == [5, 6]
    assert wal.segment_seqs() == [6]
    m = wal.read_manifest()
    assert [s["wal_through"] for s in m["snapshots"]] == [5, 6]


# -- incremental persistence: recovery == live store ---------------------------

QUERIES = [("alice/c0", "Which city does the user live in?"),
           ("bob/c0", "What pet was adopted?"),
           ("alice/c0", "What is the user's job?"),
           ("ghost/c0", "anything?")]


def _contexts_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.text == w.text
        assert [t.text() for t in g.triples] == [t.text() for t in w.triples]
        assert g.token_count == w.token_count


def _churn(svc, cls=Message):
    """Sessions, a link, both evictions and a compaction."""
    svc.record("alice/c0", "s0", _session(
        ["I live in Tallinn.", "I work as a botanist."], speaker="Alice",
        cls=cls))
    svc.record("bob/c0", "s0", _session(
        ["I adopted a parrot named Olive."], speaker="Bob", cls=cls))
    svc.record("alice/c0", "s1", _session(["I work as a welder."],
                                          speaker="Alice",
                                          ts=1700000100.0, cls=cls))
    svc.store.link("alice/c0", "Alice", "Olive", "entity", 0.75)
    svc.evict_superseded("alice/c0")
    svc.record("carol/c0", "s0", _session(["I collect stamps."],
                                          speaker="Carol", cls=cls))
    svc.evict("carol/c0")
    svc.compact()


def test_pure_wal_replay_is_bit_identical(tmp_path):
    svc, rt = _mounted(tmp_path)
    _churn(svc)
    want = svc.retrieve_batch(QUERIES)
    # no snapshot was ever written: recovery is ordered WAL replay alone
    restored = _recover(tmp_path / "data")
    _contexts_equal(restored.retrieve_batch(QUERIES), want)
    np.testing.assert_array_equal(restored.vindex.bank, svc.vindex.bank)
    np.testing.assert_array_equal(restored.vindex.alive(), svc.vindex.alive())
    assert restored.store.stats() == svc.store.stats()
    for name, lane in svc.store.graph.snapshot_arrays().items():
        np.testing.assert_array_equal(
            restored.store.graph.snapshot_arrays()[name], lane)


def test_snapshot_plus_wal_tail_recovery(tmp_path):
    svc, rt = _mounted(tmp_path)
    svc.record("alice/c0", "s0", _session(["I live in Tallinn."],
                                          speaker="Alice"))
    rt.rotate()
    segs_after_rotate = svc.stats()["wal_segments"]
    svc.record("bob/c0", "s0", _session(
        ["I adopted a parrot named Olive."], speaker="Bob"))
    svc.record("alice/c0", "s1", _session(["I work as a welder."],
                                          speaker="Alice"))
    assert svc.stats()["wal_segments"] == segs_after_rotate + 2
    want = svc.retrieve_batch(QUERIES)
    restored = _recover(tmp_path / "data")
    _contexts_equal(restored.retrieve_batch(QUERIES), want)
    np.testing.assert_array_equal(restored.vindex.bank, svc.vindex.bank)


def test_corrupt_newest_snapshot_falls_back_a_generation(tmp_path):
    svc, rt = _mounted(tmp_path, policy=LifecyclePolicy(snapshot_retain=2))
    svc.record("alice/c0", "s0", _session(["I live in Tallinn."],
                                          speaker="Alice"))
    rt.rotate()
    svc.record("bob/c0", "s0", _session(["I adopted a parrot named Olive."],
                                        speaker="Bob"))
    rt.rotate()
    want = svc.retrieve_batch(QUERIES)
    newest = rt.wal.latest_snapshot()
    with open(newest[1], "wb") as f:
        f.write(b"not a snapshot")
    with pytest.warns(UserWarning, match="unrestorable"):
        restored = _recover(tmp_path / "data")
    _contexts_equal(restored.retrieve_batch(QUERIES), want)


def test_recover_quarantines_unreplayable_tail_so_new_writes_survive(
        tmp_path):
    svc, rt = _mounted(tmp_path)
    svc.record("a/c0", "s0", _session(["I live in Tallinn."], speaker="A"))
    svc.record("b/c0", "s0", _session(["I live in Porto."], speaker="B"))
    last = rt.wal.segment_seqs()[-1]
    with open(os.path.join(rt.wal.dir, f"wal-{last:08d}.msgpack"),
              "wb") as f:
        f.write(b"garbage")
    with pytest.warns(UserWarning) as rec:
        r1 = _recover(tmp_path / "data")
    assert any("quarantined" in str(w.message) for w in rec)
    q = "Which city does the user live in?"
    assert r1.retrieve("a/c0", q).triples, "prefix before the tear survives"
    assert not r1.retrieve("b/c0", q).triples, "torn tail is lost"
    r1.record("c/c0", "s0", _session(["I live in Quito."], speaker="C"))
    r1.close(final_snapshot=False)
    r2 = _recover(tmp_path / "data")
    assert any(t.object == "quito" for t in r2.retrieve("c/c0", q).triples)
    assert r1.retrieve("a/c0", q).text == r2.retrieve("a/c0", q).text


def test_mounting_wal_on_populated_store_writes_baseline(tmp_path):
    store = _store()
    store.ingest("alice/c0", "s0", _session(["I live in Tallinn."],
                                            speaker="Alice"))
    rt = LifecycleRuntime(store, data_dir=str(tmp_path / "data"), start=False)
    assert [s for s, _ in rt.wal.snapshots()] == [0], "baseline generation"
    svc = MemoryService(runtime=rt, budget=800)
    want = svc.retrieve_batch(QUERIES)
    _contexts_equal(_recover(tmp_path / "data").retrieve_batch(QUERIES), want)


def test_remounting_fresh_store_on_durable_dir_is_refused(tmp_path):
    svc, rt = _mounted(tmp_path)
    svc.record("alice/c0", "s0", _session(["I live in Tallinn."],
                                          speaker="Alice"))
    with pytest.raises(ValueError, match="recover"):
        LifecycleRuntime(_store(), data_dir=str(tmp_path / "data"),
                         start=False)
    restored = _recover(tmp_path / "data")
    assert restored.stats()["bank_rows"] == svc.stats()["bank_rows"]


def test_read_path_drain_wakes_blocked_enqueuer(tmp_path):
    policy = LifecyclePolicy(max_pending=1, backpressure="block",
                             enqueue_timeout_s=10.0)
    svc, rt = _mounted(tmp_path, policy=policy)
    svc.enqueue("a/c0", "s0", _session(["I live in Oslo."]))
    unblocked = threading.Event()

    def blocked_writer():
        svc.enqueue("a/c0", "s1", _session(["I work as a chef."]))
        unblocked.set()

    t = threading.Thread(target=blocked_writer)
    t.start()
    time.sleep(0.1)
    assert not unblocked.is_set()
    svc.retrieve("a/c0", "anything?")    # read-your-writes drains the queue
    assert unblocked.wait(timeout=5.0), \
        "read-path flush did not wake the blocked enqueuer"
    t.join(timeout=5.0)
    assert not t.is_alive()


def test_close_is_idempotent_and_final_snapshot_recovers(tmp_path):
    svc, rt = _mounted(tmp_path)
    svc.enqueue("alice/c0", "s0", _session(["I live in Tallinn."],
                                           speaker="Alice"))
    svc.close()
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.record("alice/c0", "s1", _session(["I live in Oslo."]))
    restored = _recover(tmp_path / "data")
    ctx = restored.retrieve("alice/c0", "Which city does the user live in?")
    assert any(t.object == "tallinn" for t in ctx.triples)


def test_context_manager_and_namespace_view_close(tmp_path):
    d = str(tmp_path / "data")
    with MemoryService(_emb(), device="cpu", data_dir=d) as svc:
        view = svc.namespace("alice/c0")
        view.record_session("c", "s0", _session(["I live in Tallinn."],
                                                speaker="Alice"))
    assert svc.runtime.closed
    view.close()                          # shared and idempotent
    assert [s for s, _ in svc.runtime.wal.snapshots()] == [1]
    svc2 = _recover(d)
    assert svc2.runtime.wal.last_seq == 1
    svc2.namespace("alice/c0").close()
    assert svc2.runtime.closed


def test_what_later_slices_bring_still_raises(tmp_path):
    svc, rt = _mounted(tmp_path)
    # the request scheduler came with the serving slice: it mounts on the
    # durable service and closes with it, before the runtime
    sched = svc.start_scheduler(start=False)
    assert svc.scheduler is sched and sched.can_submit() is False
    svc.close(final_snapshot=False)
    assert sched.closed and svc.scheduler is None and rt.closed
    svc, rt = _mounted(tmp_path / "next")
    with pytest.raises(NotImplementedError, match="sharding slice"):
        svc.attach_follower(str(tmp_path / "follower"))
    sharded = tmp_path / "sharded"
    (sharded / "shard-00").mkdir(parents=True)
    (sharded / "shard-01").mkdir()
    with pytest.raises(NotImplementedError, match="sharding slice"):
        _recover(sharded)
    with pytest.raises(NotImplementedError, match="sharding slice"):
        LifecycleRuntime(_store(), data_dir=str(sharded), start=False)
    with pytest.raises(NotImplementedError, match="sharding slice"):
        _store().apply_wal({"op": "sharded_flush", "parts": []})


# -- crash recovery: kill -9 between WAL append and snapshot -------------------

_CRASH_CHILD = r"""
import hashlib, json, os, sys, time
import numpy as np
from repro_torch.core import HashEmbedder, MemoryService, Message

d = sys.argv[1]
svc = MemoryService(HashEmbedder(device="cpu"), device="cpu",
                    data_dir=os.path.join(d, "data"))
cities = ["Tallinn", "Porto", "Cusco", "Oslo", "Quito", "Hanoi"]
assert "jax" not in sys.modules and "msgpack" not in sys.modules
for i, city in enumerate(cities):
    ns = "u%d/c0" % i
    svc.enqueue(ns, "s0", [
        Message("U", "I live in %s." % city, 1700000000.0),
        Message("U", "I adopted a gecko named G%d." % i, 1700000000.0)])
    svc.flush()                     # durability point: WAL segment on disk
    if i == 1:
        svc.rotate()                # one mid-stream snapshot generation
    queries = [("u%d/c0" % j, "Which city does the user live in?")
               for j in range(i + 1)]
    texts = [c.text for c in svc.retrieve_batch(queries)]
    bank = np.ascontiguousarray(svc.vindex.bank)
    exp = {"n": i + 1, "texts": texts, "bank_rows": int(bank.shape[0]),
           "bank_sha": hashlib.sha256(bank.tobytes()).hexdigest(),
           "modules": sorted(m for m in ("jax", "msgpack", "repro")
                             if m in sys.modules)}
    tmp = os.path.join(d, "expected.json.tmp")
    with open(tmp, "w") as f:
        json.dump(exp, f); f.flush(); os.fsync(f.fileno())
    os.replace(tmp, os.path.join(d, "expected.json"))
    print("FLUSHED %d" % (i + 1), flush=True)
print("DONE", flush=True)
time.sleep(60)
"""


def test_kill9_recovery_bit_identical_up_to_last_durable_flush(tmp_path):
    """SIGKILL a writer that runs the port alone (no jax, no msgpack in
    its process) after >= 4 durable flushes and past a rotation, then
    recover: per-namespace contexts and the bank-row prefix must equal
    what the writer observed after its last durable flush."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _CRASH_CHILD, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={"PATH": os.environ.get("PATH", ""), "PYTHONPATH": SRC,
             "HOME": str(tmp_path)},
        cwd=ROOT)
    deadline = time.time() + 180
    killed = False
    try:
        for line in iter(proc.stdout.readline, ""):
            if line.startswith("FLUSHED") and int(line.split()[1]) >= 4:
                proc.kill()          # SIGKILL: no atexit, no final snapshot
                killed = True
                break
            if time.time() > deadline:
                break
    finally:
        if not killed:
            proc.kill()
        proc.wait(timeout=30)
    assert killed, f"writer never reached 4 flushes: {proc.stderr.read()}"
    with open(str(tmp_path / "expected.json")) as f:
        exp = json.load(f)
    assert exp["n"] >= 4 and exp["modules"] == []
    restored = _recover(tmp_path / "data")
    queries = [(f"u{j}/c0", "Which city does the user live in?")
               for j in range(exp["n"])]
    assert [c.text for c in restored.retrieve_batch(queries)] == exp["texts"]
    bank = np.ascontiguousarray(restored.vindex.bank[: exp["bank_rows"]])
    assert restored.vindex.n >= exp["bank_rows"]
    assert hashlib.sha256(bank.tobytes()).hexdigest() == exp["bank_sha"]


# -- background flusher + backpressure -----------------------------------------

def test_background_flusher_drains_on_interval(tmp_path):
    emb = CountingEmbedder()
    policy = LifecyclePolicy(flush_interval_s=0.03, tick_s=0.01)
    svc, rt = _mounted(tmp_path, policy=policy, start=True, emb=emb)
    try:
        for u in range(5):
            svc.enqueue(f"u{u}/c0", "s0",
                        _session(["I live in Lisbon."], speaker=f"U{u}"))
        assert emb.calls == 0, "enqueue must not embed"
        deadline = time.time() + 10
        while svc.stats()["pending_depth"] and time.time() < deadline:
            time.sleep(0.01)
        assert svc.stats()["pending_depth"] == 0, "flusher never drained"
        assert emb.calls == 1, "drain must be ONE batched embed call"
    finally:
        rt.close(final_snapshot=False)
    assert not rt.running


def test_flusher_beside_a_reader_answers_like_a_serial_run(tmp_path):
    """The daemon flushes (device appends from its own thread) while a
    reader thread retrieves: every answer the reader saw equals the serial
    answer over the same prefix of flushed sessions, and the end state
    equals a service that ran everything serially."""
    policy = LifecyclePolicy(flush_interval_s=0.001, tick_s=0.001)
    svc, rt = _mounted(tmp_path, policy=policy, start=True)
    serial = MemoryService(_emb(), device="cpu", budget=800)
    users = [f"w{u}/c0" for u in range(6)]
    q = [(ns, "Which city does the user live in?") for ns in users]
    stop = threading.Event()
    seen, errs = [], []

    def reader():
        try:
            while not stop.is_set():
                seen.append([c.text for c in svc.retrieve_batch(q)])
        except BaseException as e:     # pragma: no cover - failure path
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=reader)
    try:
        t.start()
        for s in range(4):
            for u, ns in enumerate(users):
                msgs = _session([f"I live in City{s}x{u}."], speaker="W",
                                ts=1700000000.0 + s)
                rt.enqueue(ns, f"s{s}", msgs)
                serial.enqueue(ns, f"s{s}", msgs)
                time.sleep(0.002)
    finally:
        stop.set()
        t.join(timeout=30)
        sys.setswitchinterval(old)
        rt.close(final_snapshot=False)
    assert not t.is_alive() and not errs and seen
    serial.flush()
    want = [c.text for c in serial.retrieve_batch(q)]
    assert [c.text for c in svc.retrieve_batch(q)] == want
    # every answer seen mid-run was a consistent prefix: each namespace's
    # context is one the serial service also gives after some flush
    prefixes = set()
    replay = MemoryService(_emb(), device="cpu", budget=800)
    for s in range(4):
        for u, ns in enumerate(users):
            replay.record(ns, f"s{s}", _session(
                [f"I live in City{s}x{u}."], speaker="W",
                ts=1700000000.0 + s))
            prefixes.update((i, c.text) for i, c in
                            enumerate(replay.retrieve_batch(q)))
    for i, c in enumerate(MemoryService(_emb(), device="cpu", budget=800)
                          .retrieve_batch(q)):
        prefixes.add((i, c.text))
    for answers in seen:
        for i, text in enumerate(answers):
            assert (i, text) in prefixes


def test_backpressure_reject(tmp_path):
    policy = LifecyclePolicy(max_pending=2, backpressure="reject")
    svc, rt = _mounted(tmp_path, policy=policy)
    svc.enqueue("a/c0", "s0", _session(["I live in Oslo."]))
    svc.enqueue("a/c0", "s1", _session(["I work as a chef."]))
    assert rt.rejecting
    with pytest.raises(BackpressureError, match="full"):
        svc.enqueue("a/c0", "s2", _session(["I adopted a cat."]))
    svc.flush()
    svc.enqueue("a/c0", "s2", _session(["I adopted a cat."]))  # room again


def test_backpressure_block_times_out_without_flusher(tmp_path):
    policy = LifecyclePolicy(max_pending=1, backpressure="block",
                             enqueue_timeout_s=0.05)
    svc, rt = _mounted(tmp_path, policy=policy)
    svc.enqueue("a/c0", "s0", _session(["I live in Oslo."]))
    t0 = time.monotonic()
    with pytest.raises(BackpressureError, match="blocked"):
        svc.enqueue("a/c0", "s1", _session(["I work as a chef."]))
    assert time.monotonic() - t0 >= 0.04


def test_backpressure_block_unblocked_by_daemon(tmp_path):
    policy = LifecyclePolicy(max_pending=1, backpressure="block",
                             flush_interval_s=0.01, tick_s=0.005,
                             enqueue_timeout_s=10.0)
    svc, rt = _mounted(tmp_path, policy=policy, start=True)
    try:
        svc.enqueue("a/c0", "s0", _session(["I live in Oslo."]))
        svc.enqueue("a/c0", "s1", _session(["I work as a chef."]))
        assert svc.stats()["pending_depth"] <= 1
    finally:
        rt.close(final_snapshot=False)


def test_blocked_enqueues_from_threads_all_land(tmp_path):
    policy = LifecyclePolicy(max_pending=2, backpressure="block",
                             flush_interval_s=0.01, tick_s=0.005,
                             enqueue_timeout_s=30.0)
    svc, rt = _mounted(tmp_path, policy=policy, start=True)
    errs = []

    def writer(u):
        try:
            for s in range(4):
                svc.enqueue(f"w{u}/c0", f"s{s}",
                            _session([f"I live in City{s}."], speaker=f"W{u}"))
        except BaseException as e:   # pragma: no cover - failure path
            errs.append(e)

    try:
        threads = [threading.Thread(target=writer, args=(u,))
                   for u in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs and not any(t.is_alive() for t in threads)
        svc.flush()
        st = svc.stats()
        assert st["pending_depth"] == 0
        assert sum(v["triples"] for v in st["per_namespace"].values()) == 16
    finally:
        rt.close(final_snapshot=False)


# -- policy-driven maintenance -------------------------------------------------

def test_auto_compaction_waits_for_idle_window(tmp_path):
    policy = LifecyclePolicy(compact_tombstone_ratio=0.2,
                             compact_min_tombstones=1, compact_idle_s=30.0)
    svc, rt = _mounted(tmp_path, policy=policy)
    svc.record("a/c0", "s0", _session(["I live in Oslo.",
                                       "I work as a chef."]))
    svc.record("b/c0", "s0", _session(["I adopted a cat."]))
    svc.evict("b/c0")
    assert svc.stats()["tombstones"] == 1
    assert rt.run_maintenance_once()["compacted"] is False, \
        "must not compact inside the activity window"
    rt._last_activity -= 60.0        # fast-forward into the idle window
    assert rt.run_maintenance_once()["compacted"] is True
    st = svc.stats()
    assert st["tombstones"] == 0
    assert st["lifecycle"]["auto_compactions"] == 1
    ctx = svc.retrieve("a/c0", "What is the user's job?")
    assert any(t.object == "chef" for t in ctx.triples)


def test_periodic_rotation_retention(tmp_path):
    policy = LifecyclePolicy(snapshot_interval_s=0.0, snapshot_retain=2)
    svc, rt = _mounted(tmp_path, policy=policy)
    for i in range(4):
        svc.record(f"u{i}/c0", "s0", _session([f"I live in City{i}."]))
        rt.run_maintenance_once()    # interval 0: rotates every tick
    assert len(rt.wal.snapshots()) == 2, "retention must prune generations"
    assert svc.stats()["lifecycle"]["rotations"] >= 4
    assert svc.stats()["last_snapshot_age_s"] is not None
    qs = [(f"u{i}/c0", "Which city?") for i in range(4)]
    _contexts_equal(_recover(tmp_path / "data").retrieve_batch(qs),
                    svc.retrieve_batch(qs))


@pytest.mark.parametrize("legacy_manifest", [False, True],
                         ids=["recorded-birth", "clamped-mtime"])
def test_snapshot_age_comes_from_birth_or_clamped_mtime(tmp_path,
                                                        legacy_manifest):
    """The recorded birth is authoritative; a manifest written before
    births were recorded falls back to the file's mtime clamped to now."""
    svc, rt = _mounted(tmp_path)
    svc.record("a/c0", "s0", _session(["I live in Oslo."]))
    rt.rotate()
    through, path = rt.wal.latest_snapshot()
    if legacy_manifest:
        rt.wal.write_manifest(rt.wal.snapshots())
        assert rt.wal.snapshot_births() == {}
    else:
        births = rt.wal.snapshot_births()
        assert through in births and abs(births[through] - time.time()) < 60
    rt.close()
    os.utime(path, (time.time() + 86400, time.time() + 86400))
    store = MemoryStore.restore(path, _emb(), device="cpu")
    rt2 = LifecycleRuntime(store, data_dir=str(tmp_path / "data"),
                           start=False, _recovered=True)
    age = time.monotonic() - rt2._last_snapshot_mono
    assert 0.0 <= age < 60
    rt2.close()


def test_rotation_preserves_prior_generation_births(tmp_path):
    svc, rt = _mounted(tmp_path, policy=LifecyclePolicy(snapshot_retain=2))
    svc.record("a/c0", "s0", _session(["I live in Oslo."]))
    rt.rotate()
    first_births = rt.wal.snapshot_births()
    svc.record("b/c0", "s0", _session(["I live in Porto."]))
    rt.rotate()
    births = rt.wal.snapshot_births()
    assert len(births) == 2
    for through, born in first_births.items():
        if through in births:
            assert births[through] == born
    rt.close()


def test_stats_runtime_fields_present_with_and_without_runtime(tmp_path):
    st = MemoryService(_emb(), device="cpu").stats()
    assert st["pending_depth"] == 0 and st["wal_segments"] == 0
    assert st["last_snapshot_age_s"] is None
    svc, rt = _mounted(tmp_path)
    svc.enqueue("a/c0", "s0", _session(["I live in Oslo."]))
    st = svc.stats()
    assert st["pending_depth"] == 1
    assert st["last_snapshot_age_s"] is None
    svc.flush()
    assert svc.stats()["wal_segments"] == 1
    rt.rotate()
    st = svc.stats()
    assert st["wal_segments"] == 0 and st["last_snapshot_age_s"] >= 0.0
    assert st["lifecycle"]["durable"] and st["replication"] is None


def test_group_commit_is_one_segment_and_fail_stops(tmp_path):
    svc, rt = _mounted(tmp_path)
    with rt.group_commit() as info:
        svc.record("a/c0", "s0", _session(["I live in Oslo."]))
        svc.store.link("a/c0", "Caroline", "Oslo")
        svc.evict_superseded("a/c0")
    assert info["appended"] == 2 and rt.wal.segment_seqs() == [1]
    fs = FaultyFS(str(tmp_path), rules=[FaultRule("write", mode="enospc")])
    with faults.install(fs):
        with pytest.raises(OSError):
            with rt.group_commit():
                svc.record("b/c0", "s0", _session(["I live in Porto."]))
    assert rt.closed and svc.store.wal_sink is None
    q = [("a/c0", "Which city does the user live in?")]
    want = svc.retrieve_batch(q)
    _contexts_equal(_recover(tmp_path / "data").retrieve_batch(q), want)


# -- property: interleaved ops vs an always-in-memory oracle -------------------

_OP = st_.one_of(
    st_.tuples(st_.just("enqueue"), st_.integers(0, 3), st_.integers(0, 5)),
    st_.just(("flush",)),
    st_.tuples(st_.just("evict"), st_.integers(0, 3)),
    st_.tuples(st_.just("evict_sup"), st_.integers(0, 3)),
    st_.just(("compact",)),
    st_.just(("rotate",)),
)


@given(st_.lists(_OP, min_size=1, max_size=16))
@settings(max_examples=10, deadline=None)
def test_interleaved_lifecycle_ops_match_in_memory_oracle(ops):
    with tempfile.TemporaryDirectory() as d:
        rt = LifecycleRuntime(_store(), data_dir=os.path.join(d, "data"),
                              start=False)
        svc = MemoryService(runtime=rt, budget=800)
        oracle = MemoryService(_emb(), device="cpu", budget=800)
        sid = 0
        for op in ops:
            if op[0] == "enqueue":
                _, u, j = op
                msgs = _session([f"I live in City{j}.",
                                 f"I adopted a pet named P{j}."],
                                speaker=f"U{u}")
                svc.enqueue(f"u{u}/c0", f"s{sid}", msgs)
                oracle.enqueue(f"u{u}/c0", f"s{sid}", msgs)
                sid += 1
            elif op[0] == "flush":
                svc.flush()
                oracle.flush()
            elif op[0] == "evict":
                assert svc.evict(f"u{op[1]}/c0") == \
                    oracle.evict(f"u{op[1]}/c0")
            elif op[0] == "evict_sup":
                assert svc.evict_superseded(f"u{op[1]}/c0") == \
                    oracle.evict_superseded(f"u{op[1]}/c0")
            elif op[0] == "compact":
                svc.compact()
                oracle.compact()
            elif op[0] == "rotate":
                rt.rotate()          # rotate flushes; mirror in the oracle
                oracle.flush()
        svc.flush()
        oracle.flush()
        queries = [(f"u{u}/c0", q) for u in range(4)
                   for q in ("Which city does the user live in?",
                             "What pet was adopted?")]
        want = oracle.retrieve_batch(queries)
        _contexts_equal(svc.retrieve_batch(queries), want)
        _contexts_equal(_recover(os.path.join(d, "data"))
                        .retrieve_batch(queries), want)


# -- steady state: no bank re-upload across runtime cycles ---------------------

def test_runtime_cycles_make_no_bank_or_doc_block_uploads(monkeypatch,
                                                          tmp_path):
    """Across full runtime cycles — enqueue -> flush -> retrieve_batch ->
    evict -> auto-compact -> snapshot rotation — the device bank, the BM25
    doc block and the graph lanes are updated in place: no bank-sized or
    doc-block-sized upload and no whole-lane graph upload."""
    policy = LifecyclePolicy(compact_tombstone_ratio=0.01,
                             compact_min_tombstones=1, compact_idle_s=0.0)
    svc, rt = _mounted(tmp_path, policy=policy)
    queries = [("perm0/c0", "Which city does the user live in?"),
               ("perm1/c0", "Which city does the user live in?"),
               ("nobody/c0", "Which city does the user live in?")]

    def cycle(i):
        svc.enqueue(f"perm{i}/c0", "s0",
                    _session(["I live in Oslo."], speaker="P"))
        svc.enqueue(f"tmp{i}/c0", "s0",
                    _session(["I live in Quito."], speaker="T"))
        rt.flush()
        svc.retrieve_batch(queries)
        svc.evict(f"tmp{i}/c0")
        assert rt.run_maintenance_once()["compacted"]
        rt.rotate()

    for i in range(3):
        cycle(i)
    cap, dim = svc.vindex.capacity, svc.vindex.dim
    bm_block = svc.bm25._docs.shape[0] * svc.bm25.max_doc_len * 4
    lane_uploads = svc.store.graph.counters["lane_uploads"]
    uploads = []

    def spy(mod):
        real = mod.to_device

        def to_device(a, device):
            if np.asarray(a).nbytes >= min(cap * dim * 4, bm_block):
                uploads.append((mod.__name__, np.shape(a)))
            return real(a, device)
        monkeypatch.setattr(mod, "to_device", to_device)

    spy(vi_mod)
    spy(bm25_mod)
    for i in range(3, 8):
        cycle(i)
    assert uploads == [], f"whole-buffer host->device uploads: {uploads}"
    assert svc.store.graph.counters["lane_uploads"] == lane_uploads
    assert svc.vindex.capacity == cap, "compaction must keep the capacity"
    ctx = svc.retrieve("perm0/c0", "Which city does the user live in?")
    assert any(t.object == "oslo" for t in ctx.triples)


# -- the fault layer -------------------------------------------------------------

def test_realfs_is_the_default_and_install_swaps_it(tmp_path):
    assert isinstance(faults.active(), RealFS)
    p = str(tmp_path / "f")
    faults.active().write_file(p, b"hello", fsync=True)
    with open(p, "rb") as f:
        assert f.read() == b"hello"
    fs = FaultyFS(str(tmp_path))
    before = faults.active()
    with faults.install(fs):
        assert faults.active() is fs
    assert faults.active() is before


def _steps_unsynced_file(fs, d):
    fs.write_file(os.path.join(d, "a"), b"one", fsync=True)
    fs.fsync_dir(d)
    fs.write_file(os.path.join(d, "b"), b"two", fsync=False)


def _steps_unsynced_overwrite(fs, d):
    fs.write_file(os.path.join(d, "a"), b"old", fsync=True)
    fs.fsync_dir(d)
    fs.write_file(os.path.join(d, "a"), b"new", fsync=False)


def _steps_no_dir_fsync(fs, d):
    fs.write_file(os.path.join(d, "a"), b"data", fsync=True)


def _steps_rename_no_dir_fsync(fs, d):
    fs.write_file(os.path.join(d, "t.tmp"), b"payload", fsync=True)
    fs.replace(os.path.join(d, "t.tmp"), os.path.join(d, "t"))


@pytest.mark.parametrize("steps,after", [
    (_steps_unsynced_file, {"a": b"one", "b": None}),
    (_steps_unsynced_overwrite, {"a": b"old"}),
    (_steps_no_dir_fsync, {"a": None}),
    (_steps_rename_no_dir_fsync, {"t": None}),
], ids=["unsynced-file-vanishes", "unsynced-overwrite-reverts",
        "content-fsync-without-dir-fsync-loses-entry",
        "rename-without-dir-fsync-reverts"])
def test_power_loss_model(tmp_path, steps, after):
    fs = FaultyFS(str(tmp_path))
    with faults.install(fs):
        steps(fs, str(tmp_path))
        fs.simulate_power_loss()
    for name, content in after.items():
        p = tmp_path / name
        if content is None:
            assert not p.exists()
        else:
            assert p.read_bytes() == content


def test_enospc_mode_raises_oserror_without_crashing_the_model(tmp_path):
    fs = FaultyFS(str(tmp_path),
                  rules=[FaultRule("write", mode="enospc", nth=2)])
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    with faults.install(fs):
        fs.write_file(a, b"x", fsync=True)
        with pytest.raises(OSError) as ei:
            fs.write_file(b, b"y", fsync=True)
        assert ei.value.errno == errno.ENOSPC
        fs.fsync_dir(str(tmp_path))
        fs.simulate_power_loss()
    assert os.path.exists(a) and not os.path.exists(b)


def test_rules_fire_on_nth_match_and_repeat(tmp_path):
    fs = FaultyFS(str(tmp_path), rules=[
        FaultRule("write", path_substr="wal", nth=2)])
    with faults.install(fs):
        fs.write_file(str(tmp_path / "wal-1"), b"x", fsync=True)
        with pytest.raises(InjectedCrash):
            fs.write_file(str(tmp_path / "wal-2"), b"x", fsync=True)
        fs.write_file(str(tmp_path / "wal-3"), b"x", fsync=True)
    assert [t[0] for t in fs.trips] == ["write"]
    rep = FaultyFS(str(tmp_path), rules=[
        FaultRule("unlink", nth=2, repeat=True)])
    with faults.install(rep):
        for i in range(4):
            rep.write_file(str(tmp_path / f"u{i}"), b"x", fsync=True)
        rep.unlink(str(tmp_path / "u0"))
        for i in (1, 2):
            with pytest.raises(InjectedCrash):
                rep.unlink(str(tmp_path / f"u{i}"))
    with pytest.raises(ValueError):
        FaultRule("chmod")


def test_paths_outside_the_root_pass_through(tmp_path):
    inside, outside = tmp_path / "in", tmp_path / "out"
    inside.mkdir(), outside.mkdir()
    fs = FaultyFS(str(inside), rules=[FaultRule("write", path_substr="")])
    p = str(outside / "f")
    with faults.install(fs):
        fs.write_file(p, b"x", fsync=True)
    assert os.path.exists(p)


@pytest.mark.parametrize("rule,survivors", [
    (FaultRule("replace", path_substr="wal-00000002"), ["a"]),
    (FaultRule("write", mode="torn", path_substr="wal-00000002"), ["a"]),
    (FaultRule("fsync", path_substr="wal-00000001"), []),
], ids=["crash-before-rename", "torn-write", "fsync-crash"])
def test_wal_append_under_injected_faults_loses_nothing_durable(
        tmp_path, rule, survivors):
    fs = FaultyFS(str(tmp_path), rules=[rule])
    d = str(tmp_path / "w")
    with faults.install(fs):
        wal = WriteAheadLog(d)
        with pytest.raises(InjectedCrash):
            for op in ("a", "b"):
                wal.append({"op": op})
        fs.simulate_power_loss()
    assert "wal-00000002.msgpack" not in os.listdir(d)
    wal2 = WriteAheadLog(d)
    assert [r["op"] for _, r in wal2.replay_records()] == survivors
    assert wal2.replay_stopped_seq is None      # clean tail, not corrupt


def test_atomic_write_goes_through_the_fault_layer(tmp_path):
    fs = FaultyFS(str(tmp_path))
    p = str(tmp_path / "blob")
    with faults.install(fs):
        atomic_write_bytes(p, b"payload")
        fs.simulate_power_loss()
    with open(p, "rb") as f:
        assert f.read() == b"payload"


@pytest.mark.parametrize("kwargs", [{"fsync": True},
                                    {"atomic": True, "fsync": True}],
                         ids=["fsync", "atomic"])
def test_save_survives_power_loss(tmp_path, kwargs):
    """save(fsync=True) fsyncs the parent directory too, or the freshly
    created snapshot could vanish on power loss; atomic goes through
    tmp + fsync + rename + dir fsync."""
    fs = FaultyFS(str(tmp_path))
    p = str(tmp_path / "state.msgpack")
    tree = {"x": np.arange(8, dtype=np.int64),
            "y": np.ones((2, 3), np.float32)}
    with faults.install(fs):
        io.save(p, tree, **kwargs)
        fs.simulate_power_loss()
        assert os.path.exists(p)
    got = io.load_raw(p)
    np.testing.assert_array_equal(got["x"], tree["x"])
    np.testing.assert_array_equal(got["y"], tree["y"])


def test_save_without_dir_fsync_would_lose_the_file(tmp_path):
    fs = FaultyFS(str(tmp_path),
                  rules=[FaultRule("fsync_dir", path_substr="")])
    p = str(tmp_path / "state.msgpack")
    with faults.install(fs):
        with pytest.raises(InjectedCrash):
            io.save(p, {"x": np.arange(4)}, fsync=True)
        fs.simulate_power_loss()
        assert not os.path.exists(p)


def test_rotation_crash_mid_snapshot_keeps_the_previous_generation(tmp_path):
    svc, rt = _mounted(tmp_path)
    svc.record("a/c0", "s0", _session(["I live in Oslo."]))
    rt.rotate()
    svc.record("b/c0", "s0", _session(["I live in Porto."]))
    q = [("a/c0", "Which city does the user live in?"),
         ("b/c0", "Which city does the user live in?")]
    want = svc.retrieve_batch(q)
    fs = FaultyFS(str(tmp_path), rules=[
        FaultRule("replace", path_substr="snapshot-")])
    with faults.install(fs):
        with pytest.raises(InjectedCrash):
            rt.rotate()
        fs.simulate_power_loss()
    _contexts_equal(_recover(tmp_path / "data").retrieve_batch(q), want)


# -- across the packages ---------------------------------------------------------

def _jax_service(d):
    from repro.core import MemoryService as JService
    from repro.core.embedder import HashEmbedder as JEmb
    return JService(JEmb(), use_kernel=False, budget=800, data_dir=d)


def _wal_files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith(("wal-", "snap"))}


def test_both_packages_journal_byte_identical_segments_and_recover_each_other(
        tmp_path):
    from repro.core import MemoryService as JService
    from repro.core.embedder import HashEmbedder as JEmb
    from repro.core.extraction import Message as JMessage
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsvc = _jax_service(a)
    tsvc = MemoryService(_emb(), device="cpu", budget=800, data_dir=b)
    for svc, cls in ((jsvc, JMessage), (tsvc, Message)):
        _churn(svc, cls)
        svc.rotate()
        svc.record("dave/c0", "s0", _session(
            ["I live in Hanoi.", "I adopted a dog named Rex."],
            speaker="Dave", cls=cls))
        with svc.runtime.group_commit():
            svc.record("erin/c0", "s0", _session(["I live in Lima."],
                                                 speaker="Erin", cls=cls))
            svc.store.link("erin/c0", "Erin", "Lima", "temporal", 0.5)
        svc.evict("bob/c0")
    got_a, got_b = _wal_files(a), _wal_files(b)
    assert sorted(got_a) == sorted(got_b)
    assert any(n.startswith("wal-") for n in got_a)
    assert any(n.startswith("snapshot-") for n in got_a)
    for name in got_a:
        assert got_a[name] == got_b[name], f"{name} differs"
    queries = QUERIES + [("dave/c0", "What pet was adopted?"),
                         ("erin/c0", "Which city does the user live in?")]
    want_j = jsvc.retrieve_batch(queries)
    want_t = tsvc.retrieve_batch(queries)
    _contexts_equal(want_t, want_j)
    # the port recovers the JAX directory, the JAX package the port's
    _contexts_equal(_recover(a).retrieve_batch(queries), want_j)
    restored_j = JService.recover(b, JEmb(), use_kernel=False, budget=800)
    _contexts_equal(restored_j.retrieve_batch(queries), want_t)
    np.testing.assert_array_equal(_recover(a).vindex.bank,
                                  np.asarray(jsvc.vindex.bank))


# -- the launcher's durable path ---------------------------------------------------

def _launch(*args):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


def _stats_line(stdout, prefix):
    import ast
    line = next(ln for ln in stdout.splitlines() if ln.startswith(prefix))
    return ast.literal_eval(line[line.index("{"):])


def test_launcher_recovers_its_directory_on_the_next_boot(tmp_path):
    d = str(tmp_path / "memori.d")
    first = _launch("--host-demo", "--device", "cpu", "--snapshot-path", d,
                    "--flush-interval", "0.2")
    assert first.returncode == 0, first.stderr
    final = _stats_line(first.stdout, "service:")
    assert final["namespaces"] == 1 and final["bank_rows"] > 0
    assert f"final snapshot rotation -> {d}" in first.stdout
    second = _launch("--host-demo", "--device", "cpu", "--snapshot-path", d)
    assert second.returncode == 0, second.stderr
    boot = _stats_line(second.stdout, f"recovered memory store from {d}")
    for key in ("namespaces", "bank_rows", "per_namespace", "graph"):
        assert boot[key] == final[key]


@pytest.mark.parametrize("args,message", [
    (["--http-port", "8080"], "needs --api-keys"),
    (["--qos-rate", "5"], "need --tick-interval"),
    (["--multipod"], "training and launch slice"),
    (["--snapshot-interval", "5"], "needs --snapshot-path"),
], ids=["http", "qos", "multipod", "interval"])
def test_launcher_refuses_what_later_slices_bring(args, message, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as ei:
        serve.parse_args(["--device", "cpu", *args])
    assert ei.value.code == 2
    assert message in capsys.readouterr().err


def test_launcher_refuses_a_single_file_snapshot_path(tmp_path, capsys):
    from repro_torch.launch import serve
    f = tmp_path / "snap.msgpack"
    f.write_bytes(b"x")
    with pytest.raises(SystemExit):
        serve.parse_args(["--snapshot-path", str(f)])
    assert "directory" in capsys.readouterr().err
