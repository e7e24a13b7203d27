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
