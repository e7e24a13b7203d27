"""Sharding on the port (M5), on `device="cpu"`: the cases of the
reference's tests/test_sharded_service.py on the port — parity with the
unsharded oracle, graceful degradation (a downed shard answers empty with
the `degraded` flag while survivors stay bit-identical), writes while a
shard is down, the flag through the scheduler and the HTTP envelope, the
steady state (no bank-sized upload, the slab tensors kept), and the
kill-a-shard case: a port writer SIGKILLed, a shard's disk lost, restored
from the follower and recovered bit-identically.  Against the JAX package
on the same inputs: `ShardedBank`'s host layout, stats and search ids
(mesh None, `use_kernel=False`), a sharded `MemoryService` answer for
answer, and the plain `sharded_topk` against `topk_mips_ref` /
`topk_mips_masked_ref` over the whole bank."""
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest
import torch

import repro_torch.core.shards as shards_mod
import repro_torch.core.vector_index as vi_mod
from repro_torch.checkpoint.replication import (DirectorySink,
                                                restore_missing_from_follower)
from repro_torch.core import (HashEmbedder, MemoryService, Message,
                              RetrieveRequest)
from repro_torch.core.api import RetrievalPlan
from repro_torch.core.shards import ShardedBank
from repro_torch.core.vector_index import VectorIndex, sharded_topk

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
CITIES = ["Tallinn", "Porto", "Cusco", "Oslo", "Quito", "Hanoi"]
QUERY = "Which city does the user live in?"
TS = 1700000000.0


def _svc(shards=1, **kw):
    return MemoryService(HashEmbedder(device="cpu"), device="cpu",
                         budget=800, shards=shards, **kw)


def _fill(svc):
    for i, city in enumerate(CITIES):
        svc.enqueue(f"u{i}/c0", "s0", [
            Message("U", f"I live in {city}.", TS),
            Message("U", f"I like {city} food.", TS)])
    svc.flush()
    return svc


def _queries(n=6):
    return [(f"u{i}/c0", QUERY) for i in range(n)]


def _raw_reqs(n=6):
    return [RetrieveRequest(f"u{i}/c0", QUERY,
                            stages=("dense", "sparse", "fuse"))
            for i in range(n)]


# -- placement + parity --------------------------------------------------------

def test_sharded_retrieval_parity_with_unsharded_oracle():
    base, sh = _fill(_svc()), _fill(_svc(shards=4))
    want = base.retrieve_batch(_queries())
    got = sh.retrieve_batch(_queries())
    assert [c.text for c in got] == [c.text for c in want]
    assert [c.token_count for c in got] == [c.token_count for c in want]
    # the fused ranking itself is identical, not just the rendered text;
    # global row ids differ (a sharded flush places sessions shard-major),
    # so compare the tenant-local ranking and its scores
    raw_want = base.execute(_raw_reqs())
    raw_got = sh.execute(_raw_reqs())
    assert [r.triple_ids for r in raw_got] == \
        [r.triple_ids for r in raw_want]
    for g, w in zip(raw_got, raw_want):
        assert g.scores == pytest.approx(w.scores, rel=1e-5)
    assert not any(r.degraded for r in raw_got)
    # placement: every live row landed in its namespace's shard
    stats = sh.store.sharded.stats()
    assert sum(stats["per_shard_rows"]) == sh.vindex.n
    assert sh.stats()["shards"] == stats
    for i in range(6):
        ns = f"u{i}/c0"
        tid = sh.store.tenant(ns).ns_id
        assert sh.store.shard_of_namespace(ns) == tid % 4


def test_degraded_batch_serves_survivors_bit_identically():
    svc = _fill(_svc(shards=4))
    base = [c.text for c in svc.retrieve_batch(_queries())]
    down = svc.store.shard_of_namespace("u0/c0")
    victims = [i for i in range(6)
               if svc.store.shard_of_namespace(f"u{i}/c0") == down]
    survivors = [i for i in range(6) if i not in victims]
    assert victims and survivors
    svc.set_shard_down(down)
    assert svc.store.down_shards() == [down]
    got = svc.retrieve_batch(_queries())
    raw = svc.execute(_raw_reqs())
    for i in victims:                  # empty by design, flagged, no error
        assert got[i].degraded and not got[i].triples
        assert raw[i].degraded and raw[i].row_ids == []
    for i in survivors:                # bit-identical to the healthy batch
        assert not got[i].degraded and got[i].text == base[i]
        assert not raw[i].degraded
    svc.set_shard_up(down)
    healed = svc.retrieve_batch(_queries())
    assert [c.text for c in healed] == base
    assert not any(c.degraded for c in healed)


def test_writes_accumulate_while_shard_down_and_surface_after_mark_up():
    svc = _fill(_svc(shards=4))
    down = svc.store.shard_of_namespace("u0/c0")
    svc.set_shard_down(down)
    svc.enqueue("u0/c0", "s1",
                [Message("U", "I adopted a gecko named Gex.", TS)])
    svc.flush()                        # host truth keeps absorbing writes
    assert svc.retrieve("u0/c0", "Any pets?").degraded
    svc.set_shard_up(down)
    ctx = svc.retrieve("u0/c0", "Any pets?")
    assert not ctx.degraded
    assert any(t.object == "gex" for t in ctx.triples)


def test_degraded_flag_flows_through_scheduler_responses():
    svc = _fill(_svc(shards=4))
    down = svc.store.shard_of_namespace("u0/c0")
    sched = svc.start_scheduler(tick_interval_s=0.002, max_batch=16)
    try:
        svc.set_shard_down(down)
        futs = [sched.submit(RetrieveRequest(f"u{i}/c0", QUERY))
                for i in range(6)]
        resps = [f.result(timeout=30) for f in futs]
        for i, r in enumerate(resps):
            assert r.ok, r.error
            is_victim = svc.store.shard_of_namespace(f"u{i}/c0") == down
            assert r.degraded == is_victim
            assert r.payload.degraded == is_victim
    finally:
        sched.close()


def test_degraded_flag_in_http_response_envelope():
    import urllib.request
    from repro_torch.serving.frontend import MemoryFrontend

    svc = _svc(shards=2)
    fe = MemoryFrontend(svc, {"key-acme": "acme", "key-beta": "beta"}).start()

    def call(path, body, key):
        req = urllib.request.Request(
            fe.address + path, data=json.dumps(body).encode(),
            headers={"Authorization": f"Bearer {key}"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read().decode())

    try:
        for key, city in (("key-acme", "Lisbon"), ("key-beta", "Quito")):
            call("/v1/record", {
                "namespace": "conv0", "session_id": "s0",
                "messages": [{"speaker": "U", "text": f"I live in {city}.",
                              "timestamp": TS}]}, key)
        ns_beta = next(n for n in svc.namespaces() if n.startswith("beta"))
        ns_acme = next(n for n in svc.namespaces() if n.startswith("acme"))
        down = svc.store.shard_of_namespace(ns_beta)
        assert svc.store.shard_of_namespace(ns_acme) != down
        svc.set_shard_down(down)
        q = {"namespace": "conv0", "query": QUERY}
        beta = call("/v1/retrieve", q, "key-beta")
        acme = call("/v1/retrieve", q, "key-acme")
        assert beta["status"] == "ok" and beta["degraded"] is True
        assert beta["payload"]["degraded"] is True
        assert beta["payload"]["triples"] == []
        assert acme["degraded"] is False
        assert any("lisbon" in t["object"]
                   for t in acme["payload"]["triples"])
    finally:
        fe.close()


# -- residency guarantees on the sharded path ----------------------------------

def test_sharded_steady_state_no_bank_upload(monkeypatch):
    """Once warm, the sharded flush -> scatter -> search cycle moves no
    bank-sized buffer host->device and keeps the slab tensors: sharding
    must not regress the single-device residency guarantees."""
    svc = _fill(_svc(shards=4))
    qs = _queries()
    svc.retrieve_batch(qs)             # first search: rebuild + upload
    for i in range(2):
        svc.enqueue("u0/c0", f"w{i}", [Message("U", "I like Oslo food.", TS)])
        svc.flush()
        svc.retrieve_batch(qs)
    sb = svc.store.sharded
    assert not sb.stale
    slab = sb.n_slots * sb.dim * 4     # full-bank upload size, bytes
    tensors = (sb._bank_dev, sb._labels_dev, sb._rows_dev)
    counters = dict(sb.counters)
    uploads = []

    def spy(mod):
        real = mod.to_device

        def to_device(a, device):
            if np.asarray(a).nbytes >= slab:
                uploads.append((mod.__name__, np.shape(a)))
            return real(a, device)
        monkeypatch.setattr(mod, "to_device", to_device)

    spy(shards_mod)
    spy(vi_mod)
    for i in range(5):
        svc.enqueue("u0/c0", f"x{i}", [Message("U", "I like Oslo food.", TS)])
        svc.flush()
        got = svc.retrieve_batch(qs)
        assert len(got) == 6
    assert uploads == [], f"bank-sized host->device transfers: {uploads}"
    assert all(a is b for a, b in zip(
        (sb._bank_dev, sb._labels_dev, sb._rows_dev), tensors))
    assert sb.counters["rebuilds"] == counters["rebuilds"]
    assert sb.counters["grows"] == counters["grows"]
    assert sb.counters["searches"] == counters["searches"] + 5
    np.testing.assert_array_equal(sb._bank_dev.numpy(), sb._bank_host)
    np.testing.assert_array_equal(sb._rows_dev.numpy(), sb._rows_host)


# -- the acceptance test: kill a shard owner, recover from the follower --------

_KILL_CHILD = r"""
import hashlib, json, os, sys, time
import numpy as np
from repro_torch.core import HashEmbedder, MemoryService, Message

d = sys.argv[1]
svc = MemoryService(HashEmbedder(device="cpu"), device="cpu", shards=2,
                    data_dir=os.path.join(d, "data"))
svc.attach_follower(os.path.join(d, "follower"))   # sync segment shipping
cities = ["Tallinn", "Porto", "Cusco", "Oslo", "Quito", "Hanoi"]
for i, city in enumerate(cities):
    ns = "u%d/c0" % i
    svc.enqueue(ns, "s0", [
        Message("U", "I live in %s." % city, 1700000000.0),
        Message("U", "I adopted a gecko named G%d." % i, 1700000000.0)])
    svc.flush()          # durable: shard parts + cross-shard commit record
    if i == 1:
        svc.rotate()     # mid-stream snapshot + shard-segment GC
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


def test_kill_a_shard_recovery_from_follower_bit_identical(tmp_path):
    """SIGKILL a sharded port writer mid-soak, then lose shard 1's disk
    entirely: re-materialize it from the follower's shipped segments and
    recover — retrieval and the bank-row prefix must be bit-identical to
    the writer's last durable commit.  Surviving-shard tenants answer while
    the shard is marked down, the others are flagged."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={"PATH": os.environ.get("PATH", ""), "PYTHONPATH": SRC,
             "HOME": str(tmp_path)},
        cwd=ROOT)
    deadline = time.time() + 180
    killed = False
    try:
        for line in iter(proc.stdout.readline, ""):
            if line.startswith("FLUSHED") and int(line.split()[1]) >= 4:
                proc.kill()            # SIGKILL: no atexit, no final ship
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
    data = str(tmp_path / "data")
    shutil.rmtree(os.path.join(data, "shard-01"))   # the shard's disk dies
    sink = DirectorySink(str(tmp_path / "follower"))
    restored = restore_missing_from_follower(sink, data)
    assert any(r.startswith("shard-01/") for r in restored), restored

    svc = MemoryService.recover(data, HashEmbedder(device="cpu"),
                                device="cpu", budget=800)
    assert svc.store.shards == 2                    # autodetected layout
    queries = [(f"u{j}/c0", QUERY) for j in range(exp["n"])]
    got = [c.text for c in svc.retrieve_batch(queries)]
    assert got == exp["texts"]
    bank = np.ascontiguousarray(svc.vindex.bank[: exp["bank_rows"]])
    assert svc.vindex.n >= exp["bank_rows"]
    assert hashlib.sha256(bank.tobytes()).hexdigest() == exp["bank_sha"]

    svc.set_shard_down(1)
    dg = svc.retrieve_batch(queries)
    for j in range(exp["n"]):
        if svc.store.shard_of_namespace(f"u{j}/c0") == 1:
            assert dg[j].degraded and not dg[j].triples
        else:
            assert not dg[j].degraded and dg[j].text == exp["texts"][j]
    svc.set_shard_up(1)
    assert [c.text for c in svc.retrieve_batch(queries)] == exp["texts"]


# -- against the JAX package ---------------------------------------------------

def _bank_pair(n_shards, dim=16):
    from repro.core.shards import ShardedBank as JBank
    from repro.core.vector_index import VectorIndex as JIndex
    jv, tv = JIndex(dim, use_kernel=False), VectorIndex(dim, device="cpu")
    return (jv, JBank(dim, n_shards, use_kernel=False),
            tv, ShardedBank(dim, n_shards, device="cpu"))


def _same_layout(jb, tb):
    np.testing.assert_array_equal(tb._bank_host, jb._bank_host)
    np.testing.assert_array_equal(tb._labels_host, jb._labels_host)
    np.testing.assert_array_equal(tb._rows_host, jb._rows_host)
    np.testing.assert_array_equal(tb._slot_of_row, jb._slot_of_row)
    assert tb.stats() == jb.stats()


def _same_search(jb, tb, q, q_ns, k):
    js, jr = jb.search(q, q_ns, k)
    ts, tr = tb.search(torch.from_numpy(q), torch.from_numpy(q_ns), k)
    np.testing.assert_array_equal(tr.numpy(), jr)
    live = jr >= 0
    np.testing.assert_allclose(ts.numpy()[live], np.asarray(js)[live],
                               rtol=1e-5)
    assert np.all(np.isneginf(ts.numpy()[~live]))
    return jr


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_bank_layout_and_search_match_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    dim = 16
    jv, jb, tv, tb = _bank_pair(n_shards, dim)

    def add(m, n_ns, base=0):
        vecs = rng.standard_normal((m, dim)).astype(np.float32)
        ns = (base + rng.integers(0, n_ns, m)).astype(np.int32)
        rows_j = jv.add(vecs, ns=ns)
        rows_t = tv.add(vecs, ns=ns)
        np.testing.assert_array_equal(rows_t, rows_j)
        return rows_j, vecs, ns

    add(100, 11)
    jb.rebuild(jv)
    tb.rebuild(tv)
    _same_layout(jb, tb)
    q = rng.standard_normal((6, dim)).astype(np.float32)
    q_ns = np.array([0, 1, 2, 3, 5, 99], np.int32)   # 99 owns no row
    for k in (1, 5, 64):
        _same_search(jb, tb, q, q_ns, k)
    # appends mirror in place; one shard outgrows C = 64 (a grow)
    for _ in range(2):
        rows, vecs, ns = add(40, 3)
        jb.append(rows, vecs, ns)
        tb.append(rows, vecs, ns)
    rows, vecs, ns = add(90, 1, base=n_shards)      # all on shard 0
    jb.append(rows, vecs, ns)
    tb.append(rows, vecs, ns)
    assert tb.counters["grows"] >= 1
    _same_layout(jb, tb)
    for k in (5, 64):
        _same_search(jb, tb, q, q_ns, k)
    # tombstones
    dead = rng.choice(tv.n, 30, replace=False)
    jv.delete(dead)
    tv.delete(dead)
    jb.delete(dead)
    tb.delete(dead)
    _same_layout(jb, tb)
    _same_search(jb, tb, q, q_ns, 64)
    # a down shard answers nothing; writes while down stay hidden
    jb.mark_down(1)
    tb.mark_down(1)
    rows, vecs, ns = add(12, 4)
    jb.append(rows, vecs, ns)
    tb.append(rows, vecs, ns)
    _same_layout(jb, tb)
    jr = _same_search(jb, tb, q, q_ns, 64)
    assert not np.isin(jr[q_ns % n_shards == 1], np.arange(tv.n)).any()
    np.testing.assert_array_equal(tb._labels_dev.numpy(),
                                  np.asarray(jb._labels_dev))
    jb.mark_up(1)
    tb.mark_up(1)
    _same_search(jb, tb, q, q_ns, 64)
    np.testing.assert_array_equal(tb._labels_dev.numpy(),
                                  np.asarray(jb._labels_dev))
    # compaction moves every row id: both re-derive on the next rebuild
    jv.compact()
    tv.compact()
    jb.invalidate()
    tb.invalidate()
    jb.rebuild(jv)
    tb.rebuild(tv)
    _same_layout(jb, tb)
    _same_search(jb, tb, q, q_ns, 64)
    # on a mesh the slot range must divide over its devices (the
    # reference's ValueError)
    meshed = ShardedBank(dim, n_shards, mesh=_ThreeRanks(), device="cpu")
    meshed.rebuild(tv)
    with pytest.raises(ValueError, match="do not divide over 3 mesh"):
        meshed.bank_device()


class _ThreeRanks:
    """Stands in for a 1-D DeviceMesh of 3 ranks (what ShardedBank reads
    of it)."""
    mesh_dim_names = ("data",)

    def get_coordinate(self):
        return [0]

    def size(self, dim=None):
        return 3


def _j_record(svc, cls):
    from repro.data.locomo_synth import generate_conversation
    convs = [generate_conversation(seed=s) for s in range(5)]
    for j, conv in enumerate(convs):
        for sid, msgs in conv.sessions:
            svc.enqueue(f"user{j}/c0", sid,
                        [cls(m.speaker, m.text, m.timestamp) for m in msgs])
    svc.flush()
    svc.record("user0/c0", "s-extra",
               [cls("User", "I work as a chef and I live in Cusco.", 1.7e9)])
    return convs


def _as_plain(payload):
    if hasattr(payload, "text"):
        return ("ctx", payload.text, payload.token_count,
                [dataclasses.asdict(t) for t in payload.triples],
                payload.degraded)
    return ("raw", payload.row_ids, payload.triple_ids, payload.degraded)


_PLANS = {
    "hybrid": {},
    "dense_raw": {"stages": ("dense", "fuse")},
    "raw": {"stages": ("dense", "sparse", "fuse")},
    "graph_expanded": {"stages": ("dense", "sparse", "graph", "fuse",
                                  "budget")},
}


@pytest.fixture(scope="module")
def sharded_pair():
    from repro.core import service as jsvc
    from repro.core.embedder import HashEmbedder as JEmb
    from repro.core.extraction import Message as JMessage
    js = jsvc.MemoryService(JEmb(), use_kernel=False, shards=4)
    ts = MemoryService(HashEmbedder(device="cpu"), device="cpu", shards=4)
    convs = _j_record(js, JMessage)
    _j_record(ts, Message)
    reqs = [(f"user{j}/c0", q.question) for j, conv in enumerate(convs)
            for q in conv.questions[:8]]
    reqs += [("user0/c0", "Where does the user live?"),
             ("nobody", "Where does the user live?")]
    return js, ts, reqs


@pytest.mark.parametrize("plan", sorted(_PLANS))
def test_sharded_service_answers_like_the_reference(sharded_pair, plan):
    from repro.core.api import RetrievalPlan as JPlan
    js, ts, reqs = sharded_pair
    for down in (None, js.store.shard_of_namespace("user0/c0")):
        if down is not None:
            js.set_shard_down(down)
            ts.set_shard_down(down)
        try:
            want = js.retrieve_batch(reqs, plan=JPlan(**_PLANS[plan]))
            got = ts.retrieve_batch(reqs, plan=RetrievalPlan(**_PLANS[plan]))
        finally:
            if down is not None:
                js.set_shard_up(down)
                ts.set_shard_up(down)
        assert [_as_plain(p) for p in got] == [_as_plain(p) for p in want]
        for g, w in zip(got, want):
            if not hasattr(w, "text"):
                np.testing.assert_allclose(g.scores, w.scores, rtol=1e-5)
        assert any(p.degraded for p in got) == (down is not None)
    assert ts.store.sharded.stats() == js.store.sharded.stats()
    assert ts.store.down_shards() == []


# -- sharded_topk: the plain path against one search over the whole bank -------

def _topk_case(name, rng):
    """(bank (N, D), labels (N,) or None, queries (Q, D), q_ns or None,
    n_shards, k) of one named case."""
    S, R, D, Q = 4, 16, 8, 5
    bank = rng.integers(-3, 4, (S * R, D)).astype(np.float32)
    q = rng.integers(-3, 4, (Q, D)).astype(np.float32)
    labels = rng.integers(0, 3, S * R).astype(np.int32)
    q_ns = np.array([0, 1, 2, 0, 1], np.int32)
    k = {"masked_k_le_rows": 6, "masked_k_gt_rows": 40,
         "unmasked_k_le_rows": 6, "unmasked_k_gt_rows": 40,
         "tombstones": 24, "sparse_namespaces": 8,
         "ties_across_slabs": 20, "unmasked_ties_across_slabs": 20}[name]
    if name.startswith("unmasked"):
        labels = q_ns = None
    if name == "tombstones":
        labels[rng.choice(S * R, 30, replace=False)] = -1
    if name == "sparse_namespaces":
        labels[:] = 5
        labels[[3, 50]] = 7                  # ns 7 owns two rows, 6 none
        q_ns = np.array([7, 6, 5, 7, 6], np.int32)
    if "ties" in name:
        bank[2 * R: 3 * R] = bank[0:R]       # slab 2 duplicates slab 0
        bank[3 * R: 4 * R] = bank[0:R]
        if labels is not None:
            labels[2 * R: 3 * R] = labels[0:R]
    return bank, labels, q, q_ns, S, k


@pytest.mark.parametrize("name", [
    "masked_k_le_rows", "masked_k_gt_rows", "unmasked_k_le_rows",
    "unmasked_k_gt_rows", "tombstones", "sparse_namespaces",
    "ties_across_slabs", "unmasked_ties_across_slabs"])
def test_sharded_topk_plain_matches_the_reference_oracle(name):
    import jax.numpy as jnp
    from repro.kernels import ref as kref
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    bank, labels, q, q_ns, S, k = _topk_case(name, rng)
    tq, tbank = torch.from_numpy(q), torch.from_numpy(bank)
    if labels is None:
        js, ji = kref.topk_mips_ref(jnp.asarray(q), jnp.asarray(bank), k=k)
        ts, ti = sharded_topk(tq, tbank, k, S)
    else:
        js, ji = kref.topk_mips_masked_ref(
            jnp.asarray(q), jnp.asarray(bank), jnp.asarray(q_ns),
            jnp.asarray(labels), k=k)
        ts, ti = sharded_topk(tq, tbank, k, S, q_ns=torch.from_numpy(q_ns),
                              bank_ns=torch.from_numpy(labels))
    assert ti.dtype == torch.int32 and ti.shape == (q.shape[0], k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    if "ties" in name:       # tied rows in several slabs: lowest row first
        assert (np.diff(np.asarray(js), axis=1) == 0).any()
