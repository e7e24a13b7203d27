"""The port's int8 device bank and hot/warm tiering against the JAX package
(mirroring tests/test_quantized_index.py): the int8 VectorIndex under
interleaved add/delete/compact/load_rows answers with the same ids, the
same exact scores and the same counters; demote/promote round trips keep
the device buffers bit-identical to the reference's in both `quantize`
modes; and the TierManager makes the same decisions on the same fake
clock.  Scores agree to rtol=1e-5, atol=1e-6 (the two einsums may round
differently in the last ulp)."""
import numpy as np
import pytest
import torch

from repro.core import tiering as jtier
from repro.core import vector_index as jvi
from repro.kernels import ref as jref
from repro_torch.core import tiering as ttier
from repro_torch.core import vector_index as tvi
from repro_torch.kernels.topk_mips import MAX_K
from repro_torch.obs.telemetry import get_telemetry

RTOL, ATOL = 1e-5, 1e-6


def _pair(dim, quantize, capacity=64, rescore=4):
    return (jvi.VectorIndex(dim=dim, capacity=capacity, use_kernel=False,
                            quantize=quantize, rescore=rescore),
            tvi.VectorIndex(dim=dim, capacity=capacity, device="cpu",
                            quantize=quantize, rescore=rescore))


def _searches(vi, q, q_ns, k):
    s, i = vi.search_batch(q, q_ns, k=k)
    row_ns = np.arange(vi.n) % 2
    return [(np.asarray(s), np.asarray(i, np.int64)), vi.search(q, k=k),
            vi.search_masked(q, q_ns, row_ns, k=k),
            vi.search_host(q, q_ns, k=k)]


def _device_state(vi):
    """The device buffers as numpy: bank (f32 or codes), scales, labels."""
    vi.row_labels_device()
    out = [np.asarray(vi._bank_dev), np.asarray(vi._labels_dev)]
    if vi.quantize == "int8":
        out.append(np.asarray(vi._scales_dev))
    return out


def _ties_by_row(s, i):
    """A ranking with exactly tied entries put in row order (the order of
    every device search; the reference's `search_host` leaves them in
    `argpartition`'s order, the port's puts them in row order)."""
    s, i = np.asarray(s), np.asarray(i, np.int64)
    order = np.stack([np.lexsort((r_i, -r_s)) for r_s, r_i in zip(s, i)])
    return (np.take_along_axis(s, order, axis=1),
            np.take_along_axis(i, order, axis=1))


def _check(jv, tv, q, q_ns, k):
    assert (tv.n, tv.n_alive, tv.capacity, tv.n_resident, tv.n_warm) == \
        (jv.n, jv.n_alive, jv.capacity, jv.n_resident, jv.n_warm)
    np.testing.assert_array_equal(tv.bank, jv.bank)
    np.testing.assert_array_equal(tv.resident_mask(), jv.resident_mask())
    for n, ((s_t, i_t), (s_j, i_j)) in enumerate(
            zip(_searches(tv, q, q_ns, k), _searches(jv, q, q_ns, k))):
        if n == 3:                                   # search_host
            s_j, i_j = _ties_by_row(s_j, i_j)
        np.testing.assert_array_equal(np.asarray(i_t, np.int64),
                                      np.asarray(i_j, np.int64))
        live = np.asarray(i_j) >= 0
        np.testing.assert_allclose(np.asarray(s_t)[live],
                                   np.asarray(s_j)[live], rtol=RTOL,
                                   atol=ATOL)
        assert np.isneginf(np.asarray(s_t)[~live]).all()
    for a_t, a_j in zip(_device_state(tv), _device_state(jv)):
        np.testing.assert_array_equal(a_t, a_j)
    assert tv.counters == jv.counters


def test_int8_index_parity_under_interleaved_mutation():
    """add / delete / compact / load_rows interleaved with every search
    flavour: ids, exact scores, device codes and scales, and the rescore
    counters all match the JAX index."""
    rng = np.random.default_rng(7)
    dim, k = 16, 6
    jv, tv = _pair(dim, "int8")
    q = rng.standard_normal((4, dim)).astype(np.float32)
    q_ns = np.asarray([0, 1, 2, 9], np.int32)        # ns 9 never populated

    def both(op, *args, **kw):
        out = getattr(jv, op)(*args, **kw), getattr(tv, op)(*args, **kw)
        _check(jv, tv, q, q_ns, k)
        return out

    both("add", rng.standard_normal((10, dim)).astype(np.float32),
         ns=np.arange(10) % 3)
    dup = jv.bank[2].copy()
    both("add", np.stack([dup, dup]), ns=[2, 2])     # exact ties
    big = rng.standard_normal((6, dim)).astype(np.float32)
    big[::2] *= 1e3                                  # norms 1e3 apart
    big[1] = 0.0                                     # scale 0
    both("add", big, ns=[0, 1, 2, 0, 1, 2])
    both("delete", [0, 4, 7])
    both("add", rng.standard_normal((30, dim)).astype(np.float32),
         ns=np.arange(30) % 3)                       # inside capacity
    both("delete", np.arange(10, 25))
    m_j, m_t = both("compact")
    np.testing.assert_array_equal(m_t, m_j)
    both("add", rng.standard_normal((100, dim)).astype(np.float32),
         ns=np.arange(100) % 3)                      # crosses a capacity
    bank, alive, ns = jv.bank.copy(), jv.alive(), jv.row_namespaces()
    jv, tv = _pair(dim, "int8", capacity=1024)
    both("load_rows", bank, alive, ns=ns)
    both("delete", [1, 2])
    assert tv.counters["quant_searches"] > 0
    assert 0 < tv.counters["rescore_hits"] <= tv.counters["rescore_rows"]


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_demote_promote_round_trip_matches_the_reference(quantize):
    """Demote a namespace, tombstone one of its rows while warm, promote it
    back (the tombstone comes back as a device tombstone), compact with a
    namespace still warm: every step leaves both packages with the same
    answers and bit-identical device buffers."""
    rng = np.random.default_rng(3)
    dim, k = 24, 8
    jv, tv = _pair(dim, quantize)
    q = rng.standard_normal((8, dim)).astype(np.float32)
    q_ns = np.arange(8) % 4
    jv.add(rng.standard_normal((200, dim)).astype(np.float32),
           np.arange(200) % 4)
    tv.add(jv.bank.copy(), np.arange(200) % 4)
    _check(jv, tv, q, q_ns, k)
    rows = tv.rows_in_namespace(1)
    np.testing.assert_array_equal(rows, jv.rows_in_namespace(1))
    # (every extra search runs on both sides: the counters are compared)
    hot = [vi.search_masked(q, q_ns, np.arange(200) % 4, k=k)
           for vi in (jv, tv)][1]
    assert tv.demote_rows(rows) == jv.demote_rows(rows) == len(rows)
    assert tv.demote_rows(rows) == 0
    _check(jv, tv, q, q_ns, k)
    _, i = [vi.search_masked(q, q_ns, np.arange(200) % 4, k=k)
            for vi in (jv, tv)][1]
    assert (i[q_ns == 1] == -1).all(), "a demoted namespace surfaced"
    # the host fallback answers from the mirror, warm rows included
    np.testing.assert_array_equal(tv.search_host(q, q_ns, k=k)[1], hot[1])
    for vi in (jv, tv):
        vi.delete(rows[:3])                          # tombstoned while warm
    _check(jv, tv, q, q_ns, k)
    assert tv.promote_rows(rows) == jv.promote_rows(rows) == len(rows)
    _check(jv, tv, q, q_ns, k)
    assert (tv.row_labels_device()[torch.from_numpy(rows[:3])] == -1).all()
    for vi in (jv, tv):
        vi.demote_rows(vi.rows_in_namespace(2))
        vi.delete(vi.rows_in_namespace(0))
    m_j, m_t = jv.compact(), tv.compact()
    np.testing.assert_array_equal(m_t, m_j)
    assert tv.n_warm == jv.n_warm == 50, "compaction lost the warm tier"
    _check(jv, tv, q, q_ns, k)
    for vi in (jv, tv):
        vi.promote_rows(vi.rows_in_namespace(2))
    _check(jv, tv, q, q_ns, k)


@pytest.mark.parametrize("distribution", ["clustered", "adversarial"])
def test_int8_recall_vs_f32_oracle_and_reference_ids(distribution):
    """recall@10 of the port's int8 index (K2's plain version + the exact
    rescore) against the f32 oracle stays >= 0.95, and its ids are the JAX
    index's."""
    rng = np.random.default_rng(17)
    dim, n, k = 48, 600, 10
    if distribution == "clustered":
        centers = rng.standard_normal((6, dim)).astype(np.float32) * 3
        vecs = (centers[rng.integers(0, 6, n)]
                + 0.3 * rng.standard_normal((n, dim))).astype(np.float32)
    else:
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        vecs[::11] *= 1e-4                  # tiny-norm rows
        vecs[::17] *= 1e3                   # huge-norm outliers
    ns = rng.integers(0, 4, n)
    jv, tv = _pair(dim, "int8", capacity=1024)
    jv.add(vecs, ns)
    tv.add(vecs, ns)
    q = rng.standard_normal((12, dim)).astype(np.float32)
    q_ns = np.arange(12) % 4
    _, i_t = tv.search_batch(q, q_ns, k=k)
    _, i_j = jv.search_batch(q, q_ns, k=k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    _, want = jref.topk_mips_masked_ref(q, vecs, q_ns.astype(np.int32),
                                        ns.astype(np.int32), k=k)
    want = np.asarray(want)
    got = i_t.numpy()
    rec = np.mean([len(set(g[g >= 0]) & set(w[w >= 0])) / (w >= 0).sum()
                   for g, w in zip(got, want)])
    assert rec >= 0.95, f"recall@{k} = {rec} on {distribution}"
    assert tv.counters == jv.counters


def test_over_fetch_above_max_k_raises():
    """kc = pow2(k * rescore) past the scan kernel's list bound MAX_K is
    answered (the large-k path on the card), here with every live row a
    candidate, so the rescored answer is the exact f32 top-k; a bad
    quantization or rescore raises."""
    tv = tvi.VectorIndex(dim=8, capacity=4096, device="cpu", quantize="int8",
                         rescore=8)
    bank = np.random.default_rng(0).standard_normal((600, 8)).astype(
        np.float32)
    tv.add(bank)
    q = np.ones((2, 8), np.float32)
    tv.search_batch(q, [0, 0], k=MAX_K // 8)         # kc == MAX_K
    k = MAX_K // 8 + 1                               # kc == 2 * MAX_K
    _, ids = tv.search_batch(q, [0, 0], k=k)
    exact = np.lexsort((np.arange(600), -(bank @ q[0])))[:k]
    assert np.array_equal(ids, np.stack([exact, exact]))
    for bad in (dict(quantize="fp8"), dict(rescore=0)):
        with pytest.raises(ValueError):
            tvi.VectorIndex(dim=8, device="cpu", **bad)


def test_search_host_orders_exact_ties_by_row():
    """The port's host fallback ranks like the device search: (score desc,
    row asc), so a fallback cannot reorder exactly tied rows."""
    tv = tvi.VectorIndex(dim=4, device="cpu")
    rows = np.tile(np.eye(4, dtype=np.float32)[:1], (40, 1))
    rows[::3] = np.eye(4, dtype=np.float32)[1]
    tv.add(rows, ns=0)
    q = np.eye(4, dtype=np.float32)[:1]
    s, i = tv.search_host(q, [0], k=30)
    s_d, i_d = tv.search_batch(q, [0], k=30)
    np.testing.assert_array_equal(i[0], i_d[0].numpy())
    np.testing.assert_array_equal(s[0], s_d[0].numpy())
    assert list(i[0][:5]) == [1, 2, 4, 5, 7]


def test_tier_manager_matches_the_reference_on_a_fake_clock():
    """The same activity notes, host fallbacks and ticks on the same fake
    clock: both managers demote and promote the same namespaces, and their
    tick results, stats and scores agree."""
    rng = np.random.default_rng(5)
    now = [0.0]
    jv, tv = _pair(8, "int8")
    vecs = rng.standard_normal((120, 8)).astype(np.float32)
    ns = rng.integers(0, 6, 120)
    jv.add(vecs, ns)
    tv.add(vecs, ns)
    policy = dict(max_hot_rows=50, halflife_s=10.0)
    jt = jtier.TierManager(jv, jtier.TierPolicy(**policy),
                           clock=lambda: now[0])
    tt = ttier.TierManager(tv, ttier.TierPolicy(**policy),
                           clock=lambda: now[0])
    q = rng.standard_normal((6, 8)).astype(np.float32)
    tel = get_telemetry()
    promoted = tel.counter("memori_tier_promotions").value
    demoted = tel.counter("memori_tier_demotions").value
    n_events = len(tel.events("tier_tick"))
    script = [("retrieve", 0), ("retrieve", 0), ("record", 3), ("tick",),
              ("advance", 7.0), ("retrieve", 1), ("fallback", 5),
              ("fallback", 2), ("tick",), ("advance", 25.0), ("record", 4),
              ("retrieve", 2), ("tick",), ("fallback", 0), ("tick",)]
    for step in script:
        if step[0] == "advance":
            now[0] += step[1]
            continue
        if step[0] == "tick":
            assert tt.tick() == jt.tick()
        else:
            for tm in (jt, tt):
                {"retrieve": tm.note_retrieve, "record": tm.note_record,
                 "fallback": tm.note_host_fallback}[step[0]](step[1])
        assert tt.stats() == jt.stats()
        assert tt.demoted_namespaces() == jt.demoted_namespaces()
        for nid in range(6):
            assert tt.score(nid) == jt.score(nid)
        _check(jv, tv, q, np.arange(6, dtype=np.int32), 5)
    assert tt.counters["demotions"] > 0 and tt.counters["promotions"] > 0
    # the port's telemetry sees what the manager did
    assert tel.counter("memori_tier_promotions").value - promoted == \
        tt.counters["promotions"]
    assert tel.counter("memori_tier_demotions").value - demoted == \
        tt.counters["demotions"]
    assert len(tel.events("tier_tick")) > n_events
