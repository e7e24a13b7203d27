"""The port's MessagePack codec (`repro_torch.checkpoint.packing`) against
the `msgpack` package: `packb` writes the bytes of
`msgpack.packb(x, use_bin_type=True)` on every record type the store
journals (flush, graph_edge, evict_ns, evict_superseded, compact), the
segment envelopes (single and group), the manifest and a snapshot's meta,
on every size boundary of the format and on hypothesis-drawn values;
`unpackb` decodes what msgpack wrote as `msgpack.unpackb(raw=False)` does;
the header reader matches `msgpack.Unpacker` on a segment's 96-byte head;
and both raise on the same malformed inputs."""
import dataclasses
import zlib

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.checkpoint import packing
from repro_torch.core import HashEmbedder, MemoryStore, Message


def _same(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    got = packing.packb(obj)
    assert got == want
    assert packing.unpackb(want) == msgpack.unpackb(want, raw=False)
    return want


def _records():
    """Every record the store journals, as a mounted store emits them."""
    store = MemoryStore(HashEmbedder(device="cpu"), device="cpu")
    out = []
    store.wal_sink = out.append
    store.enqueue("alice/c0", "s0", [
        Message("Alice", "I live in Tallinn.", 1700000000.0),
        Message("Alice", "I work as a botanist.", 1700000000.5)])
    store.enqueue("bob/c0", "s0", [
        Message("Bob", "I adopted a parrot named Olive.", 1700000001)])
    store.enqueue("empty/c0", "s0", [])
    store.flush()
    store.ingest("alice/c0", "s1", [
        Message("Alice", "I work as a welder.", 1700000100.0)])
    store.link("alice/c0", "Alice", "Tallinn", "entity", 0.5)
    store.evict_superseded("alice/c0")
    store.evict_namespace("bob/c0")
    store.compact()
    assert [r["op"] for r in out] == ["flush", "flush", "graph_edge",
                                      "evict_superseded", "evict_ns",
                                      "compact"]
    return store, out


def test_every_store_record_packs_like_msgpack():
    _, records = _records()
    for rec in records:
        _same(rec)
    flush = records[0]
    assert flush["n_rows"] > 0 and len(flush["vecs"]) == \
        flush["n_rows"] * flush["dim"] * 4


def test_envelopes_manifest_and_snapshot_meta_pack_like_msgpack(tmp_path):
    store, records = _records()
    payload = packing.packb(records[0])
    _same({"version": 1, "seq": 7, "crc": zlib.crc32(payload),
           "payload": payload})
    group = packing.packb(records)
    _same({"version": 1, "seq": 8, "count": len(records),
           "crc": zlib.crc32(group), "payload": group})
    _same({"version": 1, "snapshots": [
        {"wal_through": 3, "name": "snapshot-00000003.msgpack",
         "born_unix": 1760000000.25},
        {"wal_through": 70000, "name": "snapshot-00070000.msgpack"}]})
    meta = {"version": 2, "dim": store.dim,
            "bm25": {"k1": store.bm25.k1, "b": store.bm25.b,
                     "max_doc_len": store.bm25.max_doc_len},
            "ns_ids": dict(store._ns_ids),
            "tenants": {ns: {"ns_id": t.ns_id, "rows": t.rows,
                             "evicted": sorted(t.evicted),
                             "triples": [dataclasses.asdict(tr)
                                         for tr in t.triples.all()],
                             "summaries": [dataclasses.asdict(s)
                                           for s in t.summaries.all()]}
                        for ns, t in store._tenants.items()},
            "graph": store.graph.snapshot_meta()}
    _same(meta)
    # the snapshot file itself: the meta blob and the arrays as bin
    path = str(tmp_path / "snap.msgpack")
    store.snapshot(path)
    raw = open(path, "rb").read()
    entries = msgpack.unpackb(raw, raw=False)
    assert msgpack.packb(entries, use_bin_type=True) == raw
    assert packing.unpackb(raw) == entries


# every size boundary of the format
_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
         2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
         -2**31 - 1, -2**63]
_LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("value", _INTS)
def test_int_boundaries(value):
    _same(value)
    _same([value, -value if -value <= 2**64 - 1 and -value >= -2**63
           else 0])


@pytest.mark.parametrize("n", _LENGTHS)
def test_length_boundaries(n):
    _same("x" * n)
    _same("é" * (n // 2) + "x" * (n % 2))          # multi-byte UTF-8
    _same(b"\x01" * n)
    _same(bytearray(b"\x02" * n))
    _same(memoryview(b"\x03" * n))
    _same(list(range(n)))
    _same(tuple([None] * n))
    _same({f"k{i}": i for i in range(n)})


def test_scalars_and_large_blobs():
    for v in (None, True, False, 0.0, -0.0, 1.5, 1e300, float("inf"),
              -float("inf"), 2.0**-1074, "", b""):
        _same(v)
    nan = packing.packb(float("nan"))
    assert nan == msgpack.packb(float("nan"), use_bin_type=True)
    big = np.arange(1 << 18, dtype=np.float32)
    _same({"data": big.tobytes(), "view": memoryview(big).cast("B"),
           "tail": [1, "x"]})
    # a float64 subclass (numpy's scalar) packs as a float, as msgpack does
    _same({"np_float": np.float64(0.1), "flag": True, "one": 1})


_SCALAR = (st.none() | st.booleans()
           | st.integers(min_value=-2**63, max_value=2**64 - 1)
           | st.floats(allow_nan=False) | st.text() | st.binary())
_VALUE = st.recursive(
    _SCALAR,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=40), inner,
                                     max_size=20)),
    max_leaves=60)


@given(_VALUE)
@settings(max_examples=300, deadline=None)
def test_hypothesis_values_pack_and_unpack_like_msgpack(value):
    _same(value)


@given(st.lists(st.binary(max_size=300), max_size=8),
       st.lists(st.text(min_size=30, max_size=70), max_size=8))
@settings(max_examples=50, deadline=None)
def test_hypothesis_blobs_and_strings_near_the_8_bit_boundaries(bins, texts):
    _same({"bins": bins, "texts": texts})


def test_header_reader_matches_msgpack_unpacker(tmp_path):
    _, records = _records()
    payload = packing.packb(records[0])
    group = packing.packb(records)
    envelopes = [
        {"version": 1, "seq": 3, "crc": zlib.crc32(payload),
         "payload": payload},
        {"version": 1, "seq": 4, "count": len(records),
         "crc": zlib.crc32(group), "payload": group},
    ]
    for env in envelopes:
        head = packing.packb(env)[:96]
        ours, theirs = packing.Unpacker(), msgpack.Unpacker(raw=False)
        ours.feed(head)
        theirs.feed(head)
        n = theirs.read_map_header()
        assert ours.read_map_header() == n
        seen = []
        for _ in range(n):
            key = theirs.unpack()
            assert ours.unpack() == key
            seen.append(key)
            if key == "payload":
                break
            assert ours.unpack() == theirs.unpack()
        assert seen[-1] == "payload"
        if "count" in env:
            assert "count" in seen
    # past the fed bytes both stop
    ours, theirs = packing.Unpacker(), msgpack.Unpacker(raw=False)
    blob = packing.packb({"payload": b"x" * 200})[:40]
    ours.feed(blob)
    theirs.feed(blob)
    assert ours.read_map_header() == theirs.read_map_header() == 1
    assert ours.unpack() == theirs.unpack() == "payload"
    with pytest.raises(packing.OutOfData):
        ours.unpack()
    with pytest.raises(msgpack.OutOfData):
        theirs.unpack()
    not_a_map = packing.Unpacker()
    not_a_map.feed(packing.packb([1, 2]))
    with pytest.raises(ValueError):
        not_a_map.read_map_header()


@pytest.mark.parametrize("value", [np.int64(3), np.bool_(True),
                                   np.zeros(3), {1, 2}, object(),
                                   {"k": complex(1, 2)}])
def test_unsupported_types_raise_type_error_as_msgpack_does(value):
    with pytest.raises(TypeError):
        msgpack.packb(value, use_bin_type=True)
    with pytest.raises(TypeError):
        packing.packb(value)


@pytest.mark.parametrize("value", [2**64, -2**63 - 1])
def test_out_of_range_ints_raise_overflow_error(value):
    with pytest.raises(OverflowError):
        msgpack.packb(value, use_bin_type=True)
    with pytest.raises(OverflowError):
        packing.packb(value)


_WHOLE = msgpack.packb({"a": [1, 2.5, "three", b"four"], "b": None},
                       use_bin_type=True)


@pytest.mark.parametrize("blob", [
    msgpack.packb({1: "int key"}, use_bin_type=True),
    msgpack.packb({1.5: "float key"}, use_bin_type=True),
    msgpack.packb([{None: 0}], use_bin_type=True),
    _WHOLE[:-1], _WHOLE[:5], b"", _WHOLE + b"\x00", b"\xc1",
    b"\xa5abc", b"\xc4\x05ab", b"\xdc\x00", b"\xcb\x00\x00",
], ids=["int-key", "float-key", "nil-key", "truncated-1",
        "truncated-5", "empty", "trailing", "never-used-c1",
        "short-str", "short-bin", "short-array-len", "short-float"])
def test_malformed_input_raises_value_error_as_msgpack_does(blob):
    with pytest.raises(ValueError):
        msgpack.unpackb(blob, raw=False)
    with pytest.raises(ValueError):
        packing.unpackb(blob)
