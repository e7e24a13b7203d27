"""Retrieval modules of the port against the JAX package on the same
numpy-seeded inputs: HashEmbedder (bit-identical), VectorIndex under
interleaved mutation, BM25Index.topk_batch_dev and rrf_fuse_batch."""
import numpy as np
import pytest
import torch

from repro.core import bm25 as jbm25
from repro.core import embedder as jemb
from repro.core import hybrid as jhyb
from repro.core import vector_index as jvi
from repro.data.locomo_synth import generate_conversation
from repro_torch.core import bm25 as tbm25
from repro_torch.core import embedder as temb
from repro_torch.core import hybrid as thyb
from repro_torch.core import vector_index as tvi
from repro_torch.core.extraction import RuleExtractor

RTOL, ATOL = 1e-5, 1e-6


def _texts():
    conv = generate_conversation(seed=3, n_sessions=4, noise_turns=10)
    ex = RuleExtractor()
    triples = [tr.text() for sid, msgs in conv.sessions
               for tr in ex.extract(conv.conversation_id, sid, msgs)[0]]
    return triples + [q.question for q in conv.questions] + ["", "?!"]


def _assert_ids(i_port, i_ref, s_ref):
    """Ids equal wherever the reference's neighbouring scores are more than
    the tolerance apart (the two einsums may differ in the last ulp)."""
    i_port, i_ref = np.asarray(i_port), np.asarray(i_ref)
    s_ref = np.asarray(s_ref, np.float64)
    np.testing.assert_array_equal(i_port >= 0, i_ref >= 0)
    tol = ATOL + RTOL * np.abs(s_ref)
    with np.errstate(invalid="ignore"):              # -inf - -inf
        gap = np.abs(np.diff(s_ref, axis=1))
    sep = np.ones(i_ref.shape, bool)
    sep[:, 1:] &= gap > tol[:, 1:]
    sep[:, :-1] &= (gap > tol[:, :-1]) | (i_ref[:, 1:] < 0)
    sep &= i_ref >= 0
    np.testing.assert_array_equal(i_port[sep], i_ref[sep])


# -- HashEmbedder ----------------------------------------------------------

def test_hash_embedder_is_bit_identical():
    texts = _texts()
    want = np.asarray(jemb.HashEmbedder().embed_texts(texts))
    got = temb.HashEmbedder(device="cpu").embed_texts(texts)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        temb.HashEmbedder(dim=64, seed=3, device="cpu").embed_text(
            texts[0]).numpy(),
        np.asarray(jemb.HashEmbedder(dim=64, seed=3).embed_text(texts[0])))


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        temb.HashEmbedder()
    with pytest.raises(RuntimeError):
        tvi.VectorIndex(dim=8)


# -- VectorIndex -------------------------------------------------------------

def _search_all(vi, q, q_ns, k):
    s, i = vi.search_batch(q, q_ns, k=k)
    s, i = np.asarray(s), np.asarray(i, np.int64)
    row_ns = np.arange(vi.n) % 2
    return [(s, i), vi.search(q, k=k),
            vi.search_masked(q, q_ns, row_ns, k=k),
            vi.search_host(q, q_ns, k=k)]


def test_vector_index_parity_under_interleaved_mutation():
    """add / delete / compact / load_rows interleaved with every search
    flavour: the port answers like the JAX index (use_kernel=False)."""
    rng = np.random.default_rng(7)
    dim, k = 16, 6
    jv = jvi.VectorIndex(dim=dim, capacity=64, use_kernel=False)
    tv = tvi.VectorIndex(dim=dim, capacity=64, device="cpu")
    q = rng.standard_normal((4, dim)).astype(np.float32)
    q_ns = np.asarray([0, 1, 2, 9], np.int32)        # ns 9 never populated

    def check(jv, tv):
        assert (tv.n, tv.n_alive, tv.capacity) == (jv.n, jv.n_alive,
                                                   jv.capacity)
        np.testing.assert_array_equal(tv.bank, jv.bank)
        for (s_t, i_t), (s_j, i_j) in zip(_search_all(tv, q, q_ns, k),
                                          _search_all(jv, q, q_ns, k)):
            _assert_ids(i_t, i_j, s_j)
            live = np.asarray(i_j) >= 0
            np.testing.assert_allclose(np.asarray(s_t)[live],
                                       np.asarray(s_j)[live], rtol=RTOL,
                                       atol=ATOL)
            assert np.isneginf(np.asarray(s_t)[~live]).all()

    def both(op, *args, **kw):
        out_j = getattr(jv, op)(*args, **kw)
        out_t = getattr(tv, op)(*args, **kw)
        check(jv, tv)
        return out_j, out_t

    both("add", rng.standard_normal((10, dim)).astype(np.float32),
         ns=np.arange(10) % 3)
    dup = jv.bank[2].copy()
    both("add", np.stack([dup, dup]), ns=[2, 2])     # exact ties
    both("delete", [0, 4, 7])
    both("add", rng.standard_normal((30, dim)).astype(np.float32),
         ns=np.arange(30) % 3)                       # inside capacity
    both("delete", np.arange(10, 25))
    both("delete", [6, 30])
    m_j, m_t = both("compact")
    np.testing.assert_array_equal(m_t, m_j)
    both("add", rng.standard_normal((100, dim)).astype(np.float32),
         ns=np.arange(100) % 3)                      # crosses a capacity
    bank, alive, ns = jv.bank.copy(), jv.alive(), jv.row_namespaces()
    jv = jvi.VectorIndex(dim=dim, use_kernel=False)
    tv = tvi.VectorIndex(dim=dim, device="cpu")
    both("load_rows", bank, alive, ns=ns)
    both("delete", [1, 2])


def test_delete_counts_a_repeated_id_once():
    """The reference counts a repeated id in one delete() call twice (its
    n_alive drifts below the live rows); the port counts rows."""
    tv = tvi.VectorIndex(dim=4, device="cpu")
    tv.add(np.eye(4, dtype=np.float32))
    assert tv.delete([1, 1, 3, 9, -1]) == 2
    assert tv.n_alive == int(tv.alive().sum()) == 2
    assert tv.delete([1]) == 0


def test_append_within_capacity_keeps_the_device_bank_in_place():
    rng = np.random.default_rng(1)
    tv = tvi.VectorIndex(dim=8, capacity=64, device="cpu")
    tv.add(rng.standard_normal((10, 8)).astype(np.float32), ns=0)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    tv.search_batch(q, [0, 0], k=4)                  # materializes buffers
    ptr = tv._bank_dev.data_ptr()
    labels_ptr = tv.row_labels_device().data_ptr()
    for _ in range(20):
        tv.add(rng.standard_normal((2, 8)).astype(np.float32), ns=1)
        tv.delete([tv.n - 1])
        tv.search_batch(q, [0, 1], k=4)
    tv.compact()
    assert tv._bank_dev.data_ptr() == ptr
    assert tv.row_labels_device().data_ptr() == labels_ptr
    # the device copy never aliases the host mirror
    assert ptr != tv._bank.ctypes.data
    np.testing.assert_array_equal(tv._bank_dev.numpy(), tv._bank)
    tv.add(rng.standard_normal((64, 8)).astype(np.float32), ns=0)
    tv.search_batch(q, [0, 1], k=4)                  # crossed: re-uploaded
    assert tv.capacity == 128 and tv._bank_dev.shape[0] == 128


# -- BM25 ----------------------------------------------------------------------

def _bm25_pair():
    texts = _texts()
    rng = np.random.default_rng(2)
    ns = rng.integers(0, 3, len(texts)).tolist()
    jb, tb = jbm25.BM25Index(capacity=16), tbm25.BM25Index(capacity=16,
                                                          device="cpu")
    for idx in (jb, tb):
        idx.add(texts[:20], namespace=ns[:20])
        idx.add(texts[20:], namespace=ns[20:])
        idx.remove([1, 5, 5, 17])
    return jb, tb, texts


@pytest.mark.parametrize("k", [4, 64])
def test_bm25_topk_batch_dev_parity(k):
    jb, tb, texts = _bm25_pair()
    queries = ["What food does Nate like?", "Where does Elena live?",
               texts[3], "", "zzz unknown words", texts[0]]
    namespaces = [0, 1, 2, 0, 1, None]
    for _ in range(2):
        s_j, i_j = jb.topk_batch_dev(queries, k=k, namespaces=namespaces)
        s_t, i_t = tb.topk_batch_dev(queries, k=k, namespaces=namespaces)
        assert i_t.dtype == torch.int32
        _assert_ids(i_t.numpy(), i_j, s_j)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL,
                                   atol=ATOL)
        m_j, m_t = jb.compact(), tb.compact()       # then again, compacted
        np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(tb.doc_array(), jb.doc_array())
    np.testing.assert_array_equal(tb.len_array(), jb.len_array())


def test_bm25_load_rows_round_trip_and_tie_order():
    jb, tb, _ = _bm25_pair()
    tb2 = tbm25.BM25Index(device="cpu")
    tb2.load_rows(jb.doc_array(), jb.len_array(), jb.ns_array(),
                  jb.alive_array())
    s1, i1 = tb.topk_batch(["I like it"], k=30, namespaces=[0])
    s2, i2 = tb2.topk_batch(["I like it"], k=30, namespaces=[0])
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(s1, s2)
    # zero-score in-namespace docs tie: they rank by ascending doc id
    live = i1[0] >= 0
    zero = live & (s1[0] == 0)
    assert zero.sum() >= 2
    assert (np.diff(i1[0][zero]) > 0).all()


def test_topk_lowest_index_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0],
                      [0.0, 0.0, 0.0, 0.0, 5.0, 0.0]])
    v, i = tbm25.topk_lowest_index(x, 4)
    assert i.tolist() == [[1, 2, 4, 5], [4, 0, 1, 2]]
    assert v.tolist() == [[3.0, 3.0, 3.0, 2.0], [5.0, 0.0, 0.0, 0.0]]


# -- RRF fusion ----------------------------------------------------------------

def test_rrf_fuse_batch_matches_reference_and_scalar_oracle_exactly():
    rng = np.random.default_rng(11)
    for trial in range(60):
        B = int(rng.integers(1, 6))
        sizes = [int(x) for x in rng.integers(0, 9, size=int(
            rng.integers(1, 4)))]
        k = int(rng.integers(1, 12))
        R = len(sizes)
        w = rng.uniform(0.1, 2.0, size=(B, R)).astype(np.float32)
        ranks = [rng.integers(-1, 12, size=(B, p)).astype(np.int32)
                 for p in sizes]
        fi, fs = thyb.rrf_fuse_batch([torch.from_numpy(r) for r in ranks],
                                     weights=w, k=k)
        assert fi.dtype == torch.int32 and fs.dtype == torch.float32
        if trial < 8:                   # each new shape compiles on the JAX side
            fi_j, fs_j = jhyb.rrf_fuse_batch(ranks, weights=w, k=k)
            np.testing.assert_array_equal(fi.numpy(), np.asarray(fi_j))
            np.testing.assert_array_equal(fs.numpy(), np.asarray(fs_j))
        for b in range(B):
            want = thyb.rrf_fuse([r[b].tolist() for r in ranks],
                                 weights=w[b].tolist())[:k]
            got = [(int(i), float(x)) for i, x in zip(fi[b], fs[b]) if i >= 0]
            assert got == want, (trial, b)
            assert want == jhyb.rrf_fuse([r[b].tolist() for r in ranks],
                                         weights=w[b].tolist())[:k]
