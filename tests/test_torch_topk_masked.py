"""The masked top-k kernels K1 and K2 of the port at the label layouts
their device-side label compaction must handle, against the JAX package.

A masked call compacts the bank by label before it scores (only the rows
a query tile's namespaces own), so the layouts that matter are those of
the labels: one label everywhere (the single-tenant search), contiguous
28-row namespaces (the serve phases' bank), scattered namespaces, queries
that share a label, query labels that own no row, every row tombstoned,
and one namespace owning a long run of rows; n_valid off the 256-row tile
throughout.  Each plain PyTorch version (what a CPU tensor runs) is held
against `repro.kernels.ref`'s oracle at k in {1, 64, 256, 300} and against
the Pallas kernel in interpret mode at k = 1, on the same numpy-seeded
inputs: ids exactly equal once the reference's exact ties are put in row
order, scores to rtol=1e-5, atol=1e-6 (the two einsums may round
differently in the last ulp).  Also here: `masked_work` (the least work
of a masked call, which `chip_smoke.py`'s bound counts) against a brute
force count, and the launch plan.  The CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.vector_index import quantize_rows_np
from repro_torch.kernels import topk_mips as tk

RTOL, ATOL = 1e-5, 1e-6
N, N_VALID, Q, D = 1000, 700, 9, 32      # 700 = 2 * 256 + 188
KS = [1, 64, 256, 300]
LAYOUTS = ["uniform", "contiguous_28", "scattered", "shared_labels",
           "unowned_labels", "tombstoned", "skewed"]


def _labels(layout, rng):
    """(query labels (Q,), bank labels (N,)) of `layout`; padding (-2)
    beyond N_VALID."""
    if layout == "uniform":
        lab = np.where(rng.random(N) < 0.05, -1, 0)
        q_ns = np.zeros(Q)
    elif layout == "contiguous_28":
        lab = np.arange(N) // 28
        q_ns = lab[rng.integers(0, N_VALID, Q)]
    elif layout == "tombstoned":
        lab = np.full(N, -1)
        q_ns = rng.integers(0, 5, Q)
    elif layout == "skewed":   # one namespace owns a run of 200 rows
        lab = rng.integers(1, 12, N)
        lab[300:500] = 0
        q_ns = lab[rng.integers(0, N_VALID, Q)]
        q_ns[::2] = 0
    else:
        lab = rng.integers(0, 12, N)
        q_ns = lab[rng.integers(0, N_VALID, Q)]
        if layout == "shared_labels":
            q_ns = q_ns[:2][rng.integers(0, 2, Q)]
        elif layout == "unowned_labels":
            q_ns[1::2] = 12 + rng.integers(0, 3, Q // 2)
    lab = lab.astype(np.int32)
    lab[N_VALID:] = -2
    return q_ns.astype(np.int32), lab


def _case(layout, seed):
    """Unit-norm queries and rows, the layout's labels, and three
    identical rows in query 0's namespace (unless every row is
    tombstoned), query 0 equal to them."""
    rng = np.random.default_rng(seed)
    bank = rng.standard_normal((N, D)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_ns, lab = _labels(layout, rng)
    dups = [5, N_VALID // 2, N_VALID - 1]
    bank[dups] = bank[5]
    q[0] = bank[5]
    if layout != "tombstoned":
        lab[dups] = q_ns[0]
    return q, bank, q_ns, lab, dups


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _row_order(s, i):
    """Each query's (score desc, id asc) order: exact ties in row order."""
    s, i = np.asarray(s), np.asarray(i)
    order = np.stack([np.lexsort((i[r], -s[r])) for r in range(len(s))])
    return (np.take_along_axis(s, order, 1),
            np.take_along_axis(i, order, 1))


def _assert_same(s_port, i_port, s_ref, i_ref):
    s_ref, i_ref = _row_order(s_ref, i_ref)
    np.testing.assert_array_equal(i_port, i_ref)
    np.testing.assert_allclose(s_port, s_ref, rtol=RTOL, atol=ATOL)


def _check_contract(s, i, q_ns, lab, layout, k):
    """Empty slots are (NEG_INF, -1), every id is a live row of the
    query's namespace, the duplicates tie side by side in row order."""
    assert (s[i < 0] == np.float32(tk.NEG_INF)).all()
    live = i >= 0
    assert (i[live] < N_VALID).all()
    assert (lab[i[live]] == np.repeat(q_ns, k).reshape(Q, k)[live]).all()
    if layout == "tombstoned":
        assert not live.any()
    elif k >= 3:
        assert i[0, :3].tolist() == [5, N_VALID // 2, N_VALID - 1]
        assert len(set(s[0, :3].tolist())) == 1


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_k1_plain_version_matches_the_jax_oracle(layout, k):
    q, bank, q_ns, lab, _ = _case(layout, seed=LAYOUTS.index(layout))
    s, i = tk.topk_mips_masked_ref(*_torch(q, bank, q_ns, lab), k=k,
                                   n_valid=N_VALID)
    s_or, i_or = jref.topk_mips_masked_ref(q, bank, q_ns, lab, k=k,
                                           n_valid=N_VALID)
    _assert_same(s.numpy(), i.numpy(), s_or, i_or)
    _check_contract(s.numpy(), i.numpy(), q_ns, lab, layout, k)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_k2_plain_version_matches_the_jax_oracle(layout, k):
    q, bank, q_ns, lab, _ = _case(layout, seed=LAYOUTS.index(layout))
    codes, scales = quantize_rows_np(bank)
    s, i = tk.topk_mips_quant_masked_ref(
        *_torch(q, codes, scales, q_ns, lab), k=k, n_valid=N_VALID)
    s_or, i_or = jref.topk_mips_quant_masked_ref(q, codes, scales, q_ns, lab,
                                                 k=k, n_valid=N_VALID)
    _assert_same(s.numpy(), i.numpy(), s_or, i_or)
    _check_contract(s.numpy(), i.numpy(), q_ns, lab, layout, k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_versions_match_pallas_interpret_at_k_1(layout):
    q, bank, q_ns, lab, _ = _case(layout, seed=LAYOUTS.index(layout))
    codes, scales = quantize_rows_np(bank)
    s, i = tk.topk_mips_masked_ref(*_torch(q, bank, q_ns, lab), k=1,
                                   n_valid=N_VALID)
    s_pl, i_pl = jops.topk_mips_masked(q, bank, q_ns, lab, k=1,
                                       n_valid=N_VALID, interpret=True)
    _assert_same(s.numpy(), i.numpy(), s_pl, i_pl)
    s, i = tk.topk_mips_quant_masked_ref(
        *_torch(q, codes, scales, q_ns, lab), k=1, n_valid=N_VALID)
    s_pl, i_pl = jops.topk_mips_quant_masked(q, codes, scales, q_ns, lab,
                                             k=1, n_valid=N_VALID,
                                             interpret=True)
    _assert_same(s.numpy(), i.numpy(), s_pl, i_pl)


# -- the least work of a masked call -------------------------------------------

@pytest.mark.parametrize("n_valid", [N_VALID, N, 0])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_masked_work_counts_rows_and_pairs_like_brute_force(layout, n_valid):
    _, _, q_ns, lab, _ = _case(layout, seed=7 + LAYOUTS.index(layout))
    match = q_ns[:, None] == lab[None, :n_valid]          # (Q, live rows)
    rows, pairs = tk.masked_work(*_torch(q_ns, lab), n_valid=n_valid)
    assert rows == int(match.any(axis=0).sum())
    assert pairs == int(match.sum())


def test_masked_work_defaults_to_the_whole_bank_and_repeats_shared_labels():
    q_ns = torch.tensor([3, 3, 4, 9], dtype=torch.int32)
    lab = torch.tensor([3, -1, 4, 3, 4, 4, -2], dtype=torch.int32)
    # rows 0 and 3 (label 3), 2, 4 and 5 (label 4) match; label 3 is asked
    # twice (2 rows each), label 4 once (3 rows)
    assert tk.masked_work(q_ns, lab) == (5, 7)
    assert tk.masked_work(q_ns, lab, n_valid=3) == (2, 3)


# -- the launch plan -------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 64, 256, 300, 2048])
@pytest.mark.parametrize("quant", [False, True])
def test_masked_plan_is_the_scan_plan_plus_the_row_id_buffers(k, quant):
    for D_ in (24, 256, 1000):
        queries, resident = tk.scan_tile(k, quant, D_, True)
        plain = tk.scan_smem_bytes(k, quant, D_, queries, resident, False)
        masked = tk.scan_smem_bytes(k, quant, D_, queries, resident, True)
        assert masked == plain + 3 * 256 * 4 <= tk.SMEM_PER_BLOCK
        # never a wider tile than the unmasked twin's; with the same tile,
        # the same grid
        twin = tk.scan_tile(k, quant, D_, False)[0]
        assert queries <= twin
        if queries < twin:
            continue
        for n_valid in (1, 1000, 1 << 20):
            for Q_ in (1, 64, 130):
                assert (tk.plan_chunks(n_valid, Q_, 132, k, True, quant, D_)
                        == tk.plan_chunks(n_valid, Q_, 132, k, False, quant,
                                          D_))


def test_service_calls_keep_one_query_tile_of_64():
    # a B = 64 batch is one query tile: the rows are compacted once
    assert tk.scan_tile(64, False, 256, True) == (64, True)
    assert tk.scan_tile(256, True, 256, True) == (64, False)
