"""Top-k beyond k = 256 in the port, against the JAX package, and the scan
kernel's launch plan.

The reference's `topk_mips` has no bound on k; the port's scan kernel
takes k <= MAX_K = 2048 and past it the same wrappers run the large-k
path.  So the port must answer the searches that go past 256 and past
2048 as the JAX package does: an f32 `search_batch(k=300)` and
`search_batch(k=3000)`, and any int8 index whose over-fetch
pow2(k * rescore) passes 256 (rescore=8 at the service's pool of 64
over-fetches 512) or 2048 (rescore=8 at k=300 over-fetches 4096).  Ids must match exactly and
scores to rtol=1e-5, atol=1e-6 (the two einsums may round differently in
the last ulp).  The plain versions are held against `repro.kernels.ref`'s
oracles, not Pallas interpret mode, which unrolls k merge steps.  The CUDA
kernels themselves are held against the same plain versions on the card
by chip_smoke.py."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import embedder as jemb
from repro.core import service as jsvc
from repro.core import vector_index as jvi
from repro.core.api import RetrievalPlan as JPlan
from repro.core.extraction import Message as JMessage
from repro.data.locomo_synth import generate_conversation
from repro.kernels import ref as jref
from repro_torch.core import HashEmbedder, MemoryService
from repro_torch.core import vector_index as tvi
from repro_torch.core.api import RetrievalPlan
from repro_torch.core.extraction import Message
from repro_torch.kernels import topk_mips as tk

RTOL, ATOL = 1e-5, 1e-6
NAMES = ["topk_mips", "topk_mips_masked", "topk_mips_quant",
         "topk_mips_quant_masked"]


def _inputs(Q, N, D, seed):
    """Unit-norm queries and rows, four namespaces, tombstones (-1),
    planted duplicate rows tied with query 0, and the reference's int8
    codes of the bank."""
    rng = np.random.default_rng(seed)
    bank = rng.standard_normal((N, D)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    labels = rng.integers(0, 4, N).astype(np.int32)
    labels[rng.random(N) < 0.05] = -1
    dups = [2, N // 3, N // 2]
    bank[dups] = bank[2]
    labels[dups] = 0
    q = rng.standard_normal((Q, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_ns = rng.integers(0, 4, Q).astype(np.int32)
    q[0], q_ns[0] = bank[2], 0
    codes, scales = jvi.quantize_rows_np(bank)
    return q, bank, codes, scales, q_ns, labels


@pytest.mark.parametrize("k", [300, 1024])
@pytest.mark.parametrize("name", NAMES)
def test_plain_versions_match_the_jax_oracle_above_256(name, k):
    q, bank, codes, scales, q_ns, labels = _inputs(5, 1500, 16, seed=k)
    n_valid = 1400
    lead = (q, codes, scales) if "quant" in name else (q, bank)
    args = lead + ((q_ns, labels) if "masked" in name else ())
    t_args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    s, i = getattr(tk, name + "_ref")(*t_args, k=k, n_valid=n_valid)
    s_o, i_o = getattr(jref, name + "_ref")(*args, k=k, n_valid=n_valid)
    assert s.shape == (5, k) and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_o))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_o), rtol=RTOL,
                               atol=ATOL)
    row = i.numpy()[0].tolist()
    assert row[:3] == [2, 500, 750]          # the duplicates, in row order
    if "masked" not in name and k == 1024:
        assert (i.numpy() >= 0).all()        # 1024 of 1400 live rows
    if "masked" in name and k == 1024:
        assert (i.numpy() == -1).any()       # ~330 rows a namespace


@pytest.mark.parametrize("k", [2049, 4096, 10000])
@pytest.mark.parametrize("name", NAMES)
def test_plain_versions_match_the_jax_oracle_past_max_k(name, k):
    """Past MAX_K, at N = 12,288 rows of which 9,000 are live (k = 10,000
    is past n_valid): ids equal, scores to RTOL/ATOL; the masked pair's
    one big namespace (~7,000 live rows) selects really, not as fill."""
    q, bank, codes, scales, q_ns, labels = _inputs(4, 12288, 16, seed=k)
    labels = np.where(labels >= 0, np.where(labels == 3, 1, 0), -1)
    labels[[2, 12288 // 3, 12288 // 2]] = 0
    labels = labels.astype(np.int32)
    q_ns = np.array([0, 0, 1, 0], np.int32)
    n_valid = 9000
    lead = (q, codes, scales) if "quant" in name else (q, bank)
    args = lead + ((q_ns, labels) if "masked" in name else ())
    t_args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    s, i = getattr(tk, name + "_ref")(*t_args, k=k, n_valid=n_valid)
    s_o, i_o = getattr(jref, name + "_ref")(*args, k=k, n_valid=n_valid)
    assert s.shape == (4, k) and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_o))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_o), rtol=RTOL,
                               atol=ATOL)
    assert i.numpy()[0].tolist()[:3] == [2, 4096, 6144]
    live = (i.numpy() >= 0).sum(1)
    if "masked" in name:
        big = int((labels[:n_valid] == 0).sum())
        assert big > 6000 and live[0] == min(k, big)
    else:
        assert (live == min(k, n_valid)).all()


def test_large_k_chunk_keeps_the_workspace_bounded():
    """The large-k path's query chunk: at least one query, whole 64-query
    tiles past 64, and a workspace (4-byte keys, two 8-byte sort keys a
    survivor) within LARGE_WORKSPACE whenever one query fits in it."""
    for Q in (1, 7, 64, 65, 200, 1000):
        for n_valid in (1, 9000, 1 << 20, 1 << 24):
            for k in (2049, 4096, 65536, 1 << 20):
                qc = tk.large_k_chunk(Q, n_valid, k)
                per = 4 * n_valid + 16 * min(k, n_valid)
                assert 1 <= qc <= Q
                if 64 < qc < Q:
                    assert qc % 64 == 0
                if per <= tk.LARGE_WORKSPACE:
                    assert qc * per <= tk.LARGE_WORKSPACE
                    assert qc == Q or (qc + 64) * per > tk.LARGE_WORKSPACE \
                        or qc < 64
    # the main shape: 64 queries over 2^20 rows in one chunk
    assert tk.large_k_chunk(64, 1 << 20, 65536) == 64


def _index_pair(quantize, rescore=4, capacity=1024):
    return (jvi.VectorIndex(dim=16, capacity=capacity, use_kernel=False,
                            quantize=quantize, rescore=rescore),
            tvi.VectorIndex(dim=16, capacity=capacity, device="cpu",
                            quantize=quantize, rescore=rescore))


def _big_namespace_bank(N, seed):
    """A bank whose namespace 0 owns ~80% of N rows, namespace 1 the rest
    (a few tombstones as -1 labels mapped to 0)."""
    q, bank, _, _, _, labels = _inputs(6, N, 16, seed=seed)
    labels = (np.random.default_rng(seed).random(N) < 0.2).astype(np.int32)
    return q, bank, labels, np.array([0, 1, 0, 0, 1, 0], np.int32)


def test_f32_search_batch_at_k_3000_matches_the_reference():
    """k = 3,000 > MAX_K over ~6,500 rows of namespace 0 and ~1,600 of
    namespace 1 (filled past them)."""
    q, bank, labels, q_ns = _big_namespace_bank(8192, seed=11)
    jv, tv = _index_pair("none", capacity=8192)
    for vi in (jv, tv):
        vi.add(bank, labels)
    s_t, i_t = tv.search_batch(q, q_ns, k=3000)
    s_j, i_j = jv.search_batch(q, q_ns, k=3000)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL,
                               atol=ATOL)
    live = (i_t.numpy() >= 0).sum(1)
    assert (live[q_ns == 0] == 3000).all() and (live[q_ns == 1] < 3000).all()


def test_int8_index_with_over_fetch_past_max_k_matches_the_reference():
    """rescore=8 at k=300 over-fetches pow2(2,400) = 4,096 candidates, past
    MAX_K: the same ids, exact scores and counters as the JAX index."""
    q, bank, labels, q_ns = _big_namespace_bank(6000, seed=12)
    jv, tv = _index_pair("int8", rescore=8, capacity=8192)
    for vi in (jv, tv):
        vi.add(bank, labels)
    s_t, i_t = tv.search_batch(q, q_ns, k=300)
    s_j, i_j = jv.search_batch(q, q_ns, k=300)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL,
                               atol=ATOL)
    assert tv.counters == jv.counters
    assert tv.counters["rescore_rows"] == 6 * 300


def test_f32_search_batch_at_k_300_matches_the_reference():
    q, bank, _, _, q_ns, labels = _inputs(6, 900, 16, seed=7)
    jv, tv = _index_pair("none")
    for vi in (jv, tv):
        vi.add(bank, np.maximum(labels, 0))
    s_t, i_t = tv.search_batch(q, q_ns, k=300)
    s_j, i_j = jv.search_batch(q, q_ns, k=300)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL,
                               atol=ATOL)
    assert (i_t.numpy()[:, :150] >= 0).all()     # ~225 rows a namespace
    s_t, i_t = tv.search(q, k=300)
    s_j, i_j = jv.search(q, k=300)
    np.testing.assert_array_equal(np.asarray(i_t), np.asarray(i_j))


def test_int8_index_with_rescore_8_matches_the_reference():
    """pool 64 x rescore 8 over-fetches 512 candidates: past the old bound
    of 256, the same ids, exact scores and counters as the JAX index."""
    q, bank, _, _, q_ns, labels = _inputs(6, 900, 16, seed=8)
    jv, tv = _index_pair("int8", rescore=8)
    for vi in (jv, tv):
        vi.add(bank, np.maximum(labels, 0))
    s_t, i_t = tv.search_batch(q, q_ns, k=64)
    s_j, i_j = jv.search_batch(q, q_ns, k=64)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL,
                               atol=ATOL)
    assert tv.counters == jv.counters
    assert tv.counters["rescore_rows"] > 0


NAMESPACES = ("alice/c0", "bob/c0", "carol/c0")


def _record(svc, message_cls):
    convs = [generate_conversation(seed=s) for s in range(3)]
    for conv, ns in zip(convs, NAMESPACES):
        for sid, msgs in conv.sessions:
            svc.enqueue(ns, sid, [message_cls(m.speaker, m.text, m.timestamp)
                                  for m in msgs])
    svc.flush()
    reqs = []
    for conv, ns in zip(convs, NAMESPACES):
        reqs += [(ns, qq.question) for qq in conv.questions]
    return reqs


@pytest.fixture(scope="module")
def rescore8_pair():
    js = jsvc.MemoryService(jemb.HashEmbedder(), use_kernel=False,
                            quantize="int8", rescore=8)
    ts = MemoryService(HashEmbedder(device="cpu"), device="cpu",
                       quantize="int8", rescore=8)
    reqs = _record(js, JMessage)
    assert _record(ts, Message) == reqs
    return js, ts, reqs


def _plain(payload):
    return (payload.text, payload.token_count,
            [dataclasses.asdict(t) for t in payload.triples])


@pytest.mark.parametrize("stages", [None, ("dense", "fuse", "budget")])
def test_int8_service_with_rescore_8_answers_like_the_reference(
        rescore8_pair, stages):
    js, ts, reqs = rescore8_pair
    kw = {} if stages is None else {"stages": stages}
    want = [_plain(p) for p in js.retrieve_batch(reqs, plan=JPlan(**kw))]
    got = [_plain(p) for p in ts.retrieve_batch(reqs,
                                                plan=RetrievalPlan(**kw))]
    assert got == want
    assert any(w[0] for w in want)
    assert ts.stats()["bank"] == js.stats()["bank"]
    assert ts.stats()["bank"]["quant_searches"] > 0


# -- the scan kernel's launch plan ----------------------------------------------

SMS = 132


def _scan_chunk_rows(chunk, n_chunks, n_valid):
    """Rows [begin, end) of the scan kernel's chunk: tiles
    [chunk·T/C, (chunk+1)·T/C) of the T live 256-row tiles, as the kernel
    splits them (csrc/topk_mips.cu, `t_begin`/`t_end`)."""
    tiles = -(-n_valid // 256)
    return (chunk * tiles // n_chunks * 256,
            min(n_valid, (chunk + 1) * tiles // n_chunks * 256))


@pytest.mark.parametrize("Q", [1, 7, 64, 130])
@pytest.mark.parametrize("k", [1, 10, 64, 65, 128, 256, 257, 512, 2048])
def test_scan_plan_covers_rows_and_queries_and_fills_the_card(k, Q):
    for masked in (False, True):
        for quant in (False, True):
            queries, resident = tk.scan_tile(k, quant, 256, masked)
            assert queries in (64, 32, 16, 8)
            assert tk.scan_smem_bytes(k, quant, 256, queries, resident,
                                      masked) <= 232448
            q_tiles = -(-Q // queries)
            assert q_tiles * queries >= Q > (q_tiles - 1) * queries
            for n_valid in (0, 1, 63, 64, 65, 1000, 65536, 1 << 20):
                n_chunks, rows = tk.plan_chunks(n_valid, Q, SMS, k, masked,
                                                quant, 256)
                tiles = -(-n_valid // 256)
                assert rows % 256 == 0 and rows > 0
                assert 0 <= n_chunks <= tiles
                assert (n_chunks == 0) == (n_valid == 0)
                bounds = [_scan_chunk_rows(c, n_chunks, n_valid)
                          for c in range(n_chunks)]
                # whole tiles, in order, no gap, no overlap, none empty
                if bounds:
                    assert bounds[0][0] == 0 and bounds[-1][1] == n_valid
                for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
                    assert hi == lo2
                for lo, hi in bounds:
                    assert lo % 256 == 0 and lo < hi <= lo + rows
                if tiles * q_tiles >= SMS:
                    assert n_chunks * q_tiles >= SMS


# -- the large-k path's plan: grouped tiles, the select, the workspace --------

def _layouts():
    """Query label layouts for the grouping: the main shape's (even queries
    namespace 0, odd ones their own), one label, all distinct, five labels
    interleaved with singletons, a label at GROUP_MIN and one below it, a
    label spread past one tile, PLAN_MAX random labels."""
    rng = np.random.default_rng(3)
    main = np.zeros(64, np.int32)
    main[1::2] = rng.choice(np.arange(1, 749), 32, replace=False)
    return {
        "main": main.tolist(),
        "one label": [3] * 70,
        "distinct": list(range(64, 0, -1)),
        "interleaved": [i % 6 if i % 6 < 5 else 100 + i for i in range(130)],
        "group_min edge": [7] * tk.GROUP_MIN + [9] * (tk.GROUP_MIN - 1) + [2] * 5,
        "past a tile": [1] * 45 + [0] * 3 + [1] * 30,
        "plan max": rng.integers(-3, 300, tk.PLAN_MAX).tolist()}


@pytest.mark.parametrize("layout", list(_layouts()))
def test_group_tiles_cover_each_query_once_one_label_or_the_rest(layout):
    """Every query in exactly one slot; a tile holds 1..GROUP_TILE queries,
    all of one label asked GROUP_MIN times or more, or only labels asked
    fewer times (the rest, after every label's own tiles, in label order);
    at most group_tiles_max tiles; writing each slot's answer back to its
    query restores the caller's order."""
    q_ns = _layouts()[layout]
    tiles = tk.group_tiles(q_ns)
    Q = len(q_ns)
    assert sorted(q for t in tiles for q in t) == list(range(Q))
    assert 1 <= len(tiles) <= tk.group_tiles_max(Q)
    size = {x: q_ns.count(x) for x in set(q_ns)}
    kinds = []
    for t in tiles:
        assert 1 <= len(t) <= tk.GROUP_TILE
        labels = [q_ns[q] for q in t]
        assert labels == sorted(labels)
        if size[labels[0]] >= tk.GROUP_MIN:
            assert set(labels) == {labels[0]}
            kinds.append("own")
        else:
            assert all(size[x] < tk.GROUP_MIN for x in labels)
            kinds.append("rest")
    assert kinds == sorted(kinds)            # own tiles first
    flat = [q for t in tiles for q in t]
    assert [q_ns[q] for q in flat] == sorted(q_ns[q] for q in flat
                                             if size[q_ns[q]] >= tk.GROUP_MIN) \
        + sorted(q_ns[q] for q in flat if size[q_ns[q]] < tk.GROUP_MIN)
    out = np.full(Q, -1)
    for t in tiles:
        for q in t:
            out[q] = q            # each slot's answer goes to its own query
    assert (out == np.arange(Q)).all()
    own = [len(t) for t, kind in zip(tiles, kinds) if kind == "own"]
    if layout == "main":
        assert own == [32] and len(tiles) == 2
    if layout == "one label":
        assert own == [32, 32, 6]
    if layout == "distinct":
        assert own == [] and len(tiles) == 2


def test_group_tiles_halve_the_pairs_scored_at_the_main_shape():
    """At the main shape (Q = 64 over 2^20 rows; namespace 0 owns a quarter
    of them and the even queries ask it, each odd query a ~1,400-row
    namespace of its own) a grouped tile scores its own labels' rows
    against GROUP_TILE queries: ~9.8 M (query slot, row) pairs, where one
    64-query tile over the union of every label scores ~19.7 M."""
    rng = np.random.default_rng(4)
    N = 1 << 20
    lab = rng.integers(1, N // 1400, N)
    lab[rng.random(N) < 0.25] = 0
    q_ns = np.zeros(64, np.int64)
    q_ns[1::2] = rng.choice(np.arange(1, N // 1400), 32, replace=False)
    rows = np.bincount(lab)

    def slots(tiles, width):
        return sum(width * rows[list({int(q_ns[q]) for q in t})].sum()
                   for t in tiles)

    grouped = slots(tk.group_tiles(q_ns), tk.GROUP_TILE)
    union = slots([list(range(64))], 64)
    assert 8.4e6 <= grouped <= 10.5e6 and 18e6 <= union <= 21e6
    assert grouped <= 0.55 * union


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_valid", [0, 1, 9000, 1 << 18, 1 << 20, 1 << 24])
@pytest.mark.parametrize("k", [2049, 4096, 65536, 1 << 20])
def test_large_workspace_stays_within_the_aim(k, n_valid, masked):
    """The chunk the wrapper plans keeps `large_workspace_bytes` (the C
    side's carve, checked against it when the library loads) within
    LARGE_WORKSPACE whenever one query fits; masked chunks hold at most
    PLAN_MAX queries; whole 64-query tiles past 64 unless the chunk is the
    whole call; no larger chunk of that shape would fit."""
    D = 256
    for Q in (1, 7, 64, 65, 200, 1500):
        qc = tk.large_k_chunk(Q, n_valid, k, masked, D, 132)
        limit = min(Q, tk.PLAN_MAX) if masked else Q
        assert 1 <= qc <= limit
        used = tk.large_workspace_bytes(qc, n_valid, k, masked, D, 132)
        if tk.large_workspace_bytes(1, n_valid, k, masked, D, 132) \
                <= tk.LARGE_WORKSPACE:
            assert used <= tk.LARGE_WORKSPACE
        if qc < limit and qc >= 64:
            assert qc % 64 == 0
            assert tk.large_workspace_bytes(qc + 64, n_valid, k, masked, D,
                                            132) > tk.LARGE_WORKSPACE
    cap, stride = tk.large_cap(n_valid, k), tk.large_stride(n_valid, k)
    assert min(k, n_valid) <= cap <= n_valid and cap >= n_valid // 16
    assert min(k, n_valid) <= stride <= n_valid


def _score_keys(s, ok):
    """The kernels' order-preserving 32-bit keys of f32 scores (-0 as +0),
    0 where not `ok`."""
    s = np.where(s == 0, np.float32(0), s).astype(np.float32)
    b = s.view(np.uint32).astype(np.int64)
    return np.where(ok, np.where(b >= 2 ** 31, ~b & 0xffffffff, b | 2 ** 31),
                    0)


def _pick(hist, want):
    """The bin holding the want-th key from the top, and want less the keys
    of the bins above it (`topk_radix_pick_kernel`)."""
    above = 0
    for d in range(len(hist) - 1, -1, -1):
        if above + hist[d] >= want:
            return d, want - above
        above += hist[d]
    raise AssertionError("fewer keys than wanted")


def _select_model(keys, k, cap, stride):
    """One query's survivors as the large-k path selects them (the entries
    its filters and, heavy, its ordered select keep), and its mode: the
    k-th key T by three digits; filtered, every key at or above T; heavy,
    the keys above T and the lowest entries equal to it."""
    live = keys != 0
    if live.sum() < k:
        return np.flatnonzero(live), "all"
    d0, d1 = keys >> 21, (keys >> 10) & 2047
    b0, rem = _pick(np.bincount(d0[live], minlength=2048), k)
    inb = live & (d0 == b0)
    keep = live & (d0 > b0)
    b1, rem = _pick(np.bincount(d1[inb], minlength=2048), rem)
    in1 = inb & (d1 == b1)
    b2, rem = _pick(np.bincount(keys[in1] & 1023, minlength=1024), rem)
    T = (b0 << 21) | (b1 << 10) | b2
    keep |= inb & (keys > T)
    if inb.sum() <= cap:        # the filters: every key tied with T too
        keep |= keys == T
        mode = "filtered"
    else:                       # the ordered select: the lowest rows
        keep[np.flatnonzero(keys == T)[:rem]] = True
        mode = "heavy"
    assert keep.sum() <= stride
    return np.flatnonzero(keep), mode


def _hard_bank(kind, N, D, rng):
    if kind == "unit":
        b = rng.standard_normal((N, D)).astype(np.float32)
        return b / np.linalg.norm(b, axis=1, keepdims=True)
    if kind == "crowded":
        return rng.integers(-1, 2, (N, D)).astype(np.float32)
    if kind == "binary":
        return rng.integers(0, 2, (N, D)).astype(np.float32)
    return np.ones((N, D), np.float32)


@pytest.mark.parametrize("kind,k,modes", [
    ("unit", 2049, {"filtered"}), ("unit", 6000, {"filtered"}),
    ("crowded", 2049, {"filtered"}), ("crowded", 9000, {"filtered"}),
    ("binary", 3000, {"heavy"}), ("tied", 4096, {"heavy"}),
    ("unit", 40000, {"all"})])
def test_select_model_gives_the_plain_versions_ids(kind, k, modes):
    """A model of the large-k select (first digit, pick, filter into
    survivors and candidates, second digit, filter; past the candidate cap
    the third digit and the lowest-row ties; then the (score desc, row
    asc) sort) on the plain version's own scores gives exactly its ids,
    keeps within the survivor stride, and takes the mode each bank is
    there for: unit vectors and crowded integer scores filter, a bin past
    the cap (0/1 rows against all-ones queries, all-tied) runs heavy."""
    rng = np.random.default_rng(k)
    N, D, n_valid = 32768, 32, 32768 - 77
    bank = _hard_bank(kind, N, D, rng)
    q = np.ones((3, D), np.float32) if kind == "binary" else \
        _hard_bank("crowded" if kind == "crowded" else "unit", 3, D, rng)
    tb, tq = torch.from_numpy(bank), torch.from_numpy(q)
    s_r, i_r = tk.topk_mips_ref(tq, tb, k=k, n_valid=n_valid)
    s = torch.einsum("qd,nd->qn", tq, tb).numpy()
    ok = np.arange(N)[None, :] < n_valid
    keys = _score_keys(s, np.broadcast_to(ok, s.shape))
    cap, stride = tk.large_cap(n_valid, k), tk.large_stride(n_valid, k)
    seen = set()
    for qi in range(q.shape[0]):
        entries, mode = _select_model(keys[qi], k, cap, stride)
        seen.add(mode)
        order = sorted(entries, key=lambda e: (-keys[qi][e], e))[:k]
        ids = np.full(k, -1)
        ids[:len(order)] = order
        np.testing.assert_array_equal(ids, i_r.numpy()[qi])
    assert seen == modes


def _interleaved(N, D, seed):
    """Integer-valued rows and queries (exact in every summation order, so
    ties are decided by row alone): rows labelled 0..2 and a few small
    namespaces, queries whose labels cycle 0, 1, 2 with a small namespace
    every fourth."""
    rng = np.random.default_rng(seed)
    bank = rng.integers(-1, 2, (N, D)).astype(np.float32)
    labels = rng.integers(0, 3, N).astype(np.int32)
    labels[rng.random(N) < 0.1] = rng.integers(3, 9, 1)[0]
    labels[rng.random(N) < 0.03] = -1
    q = rng.integers(-1, 2, (12, D)).astype(np.float32)
    q_ns = np.array([i % 4 if i % 4 < 3 else 3 + i // 4 for i in range(12)],
                    np.int32)
    codes, scales = jvi.quantize_rows_np(bank)
    return q, bank, codes, scales, q_ns, labels


@pytest.mark.parametrize("k", [2049, 4096])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["interleaved labels", "heavy ties"])
def test_plain_versions_match_the_jax_oracle_on_the_hard_cases(case, name, k):
    """Past MAX_K, the large-k path's hard inputs through the plain versions
    against `repro.kernels.ref`: queries whose labels interleave (the
    grouping's case) and integer-valued scores with thousands of rows tied
    across the k-th (0/1 rows against all-ones queries); ids equal, scores
    to RTOL/ATOL."""
    N, D = 12288, 16
    q, bank, codes, scales, q_ns, labels = _interleaved(N, D, seed=k)
    if case == "heavy ties":
        rng = np.random.default_rng(k + 1)
        bank = rng.integers(0, 2, (N, D)).astype(np.float32)
        q = np.ones((12, D), np.float32)
        codes, scales = jvi.quantize_rows_np(bank)
    n_valid = N - 300
    lead = (q, codes, scales) if "quant" in name else (q, bank)
    args = lead + ((q_ns, labels) if "masked" in name else ())
    t_args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    s, i = getattr(tk, name + "_ref")(*t_args, k=k, n_valid=n_valid)
    s_o, i_o = getattr(jref, name + "_ref")(*args, k=k, n_valid=n_valid)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_o))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_o), rtol=RTOL,
                               atol=ATOL)
    s_np = s.numpy()
    if case == "heavy ties":     # hundreds of the list tie with the k-th
        assert ((s_np == s_np[:, k - 1:k]).sum(1) >= 100).all()
