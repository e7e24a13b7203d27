"""The masked top-k MIPS (kernel K1) of the port against the JAX package:
the port's plain PyTorch version `topk_mips_masked_ref` (what a CPU tensor
runs) against the Pallas kernel in interpret mode and the JAX oracle, on
the same numpy-seeded inputs.  Ids must match exactly and scores to
rtol=1e-5, atol=1e-6 (the two einsums may round differently in the last
ulp).  The CUDA kernel itself is held against the same plain version on
the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import topk_mips as tk

RTOL, ATOL = 1e-5, 1e-6
NEG_INF = -2.0e38


def _case(Q, N, n_valid, seed=0, D=32, n_ns=3):
    """Unit-norm queries and rows; namespaces 0..n_ns-1, tombstones (-1),
    padding (-2) beyond n_valid, namespace n_ns owning two rows, planted
    duplicate rows, an all-masked query and a k-above-live-rows query."""
    rng = np.random.default_rng(seed)
    bank = rng.standard_normal((N, D)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    labels = rng.integers(0, n_ns, N).astype(np.int32)
    labels[rng.random(N) < 0.1] = -1
    labels[n_valid:] = -2
    labels[[1, n_valid // 2]] = n_ns               # a two-row namespace
    dups = [3, n_valid // 3, n_valid - 1]
    bank[dups] = bank[3]
    labels[dups] = 0
    q = rng.standard_normal((Q, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_ns = rng.integers(0, n_ns, Q).astype(np.int32)
    q[0], q_ns[0] = bank[3], 0                     # the duplicates tie first
    if Q > 2:
        q_ns[1] = n_ns                             # k above the live rows
        q_ns[2] = n_ns + 7                         # matches no row at all
    return q, bank, q_ns, labels, dups


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_same(s_port, i_port, s_ref, i_ref):
    np.testing.assert_array_equal(i_port, np.asarray(i_ref))
    np.testing.assert_allclose(s_port, np.asarray(s_ref), rtol=RTOL,
                               atol=ATOL)


CASES = [  # (Q, N, n_valid, k)
    (1, 40, 40, 5),
    (7, 40, 31, 16),
    (7, 300, 260, 16),
    (8, 600, 555, 32),
]


@pytest.mark.parametrize("Q,N,n_valid,k", CASES)
def test_plain_version_matches_pallas_interpret_and_jax_oracle(Q, N, n_valid,
                                                               k):
    q, bank, q_ns, labels, dups = _case(Q, N, n_valid, seed=Q * N)
    s, i = tk.topk_mips_masked_ref(*_torch(q, bank, q_ns, labels), k=k,
                                   n_valid=n_valid)
    s, i = s.numpy(), i.numpy()
    s_pl, i_pl = jops.topk_mips_masked(q, bank, q_ns, labels, k=k,
                                       n_valid=n_valid, interpret=True)
    s_or, i_or = jref.topk_mips_masked_ref(q, bank, q_ns, labels, k=k,
                                           n_valid=n_valid)
    _assert_same(s, i, s_pl, i_pl)
    _assert_same(s, i, s_or, i_or)
    # the contract itself: duplicates tie to the lower row, empty slots are
    # (NEG_INF, -1), every live id is in the query's namespace and prefix
    assert i[0, :3].tolist() == dups
    assert (s[i < 0] == np.float32(NEG_INF)).all()
    live = i >= 0
    assert (i[live] < n_valid).all()
    assert (labels[i[live]] == np.repeat(q_ns, k).reshape(Q, k)[live]).all()
    if Q > 2:
        assert live[1].sum() == 2 and not live[2].any()


def test_k_above_bank_rows_pads_like_the_pallas_kernel():
    q, bank, q_ns, labels, _ = _case(7, 24, 20, seed=5)
    s, i = tk.topk_mips_masked_ref(*_torch(q, bank, q_ns, labels), k=32,
                                   n_valid=20)
    s_pl, i_pl = jops.topk_mips_masked(q, bank, q_ns, labels, k=32,
                                       n_valid=20, interpret=True)
    _assert_same(s.numpy(), i.numpy(), s_pl, i_pl)
    assert (i.numpy()[:, 20:] == -1).all()


def test_cpu_tensor_runs_the_plain_version_without_a_launch():
    q, bank, q_ns, labels, _ = _case(7, 300, 260, seed=1)
    args = _torch(q, bank, q_ns, labels)
    before = tk.topk_mips_masked.launches
    s, i = tk.topk_mips_masked(*args, k=16, n_valid=260)
    s_r, i_r = tk.topk_mips_masked_ref(*args, k=16, n_valid=260)
    assert tk.topk_mips_masked.launches == before == 0
    assert torch.equal(i, i_r) and torch.equal(s, s_r)
    assert i.dtype == torch.int32 and s.dtype == torch.float32


@pytest.mark.parametrize("k", [0, tk.MAX_K + 1])
def test_k_outside_the_kernel_range_raises(k):
    q, bank, q_ns, labels, _ = _case(1, 40, 40)
    with pytest.raises(ValueError):
        tk.topk_mips_masked(*_torch(q, bank, q_ns, labels), k=k)


def test_chunk_plan_covers_the_live_prefix():
    for n_valid in (0, 1, 63, 64, 65, 1000, 65536, 1 << 20):
        for Q in (1, 64, 65, 200):
            n_chunks, rows = tk.plan_chunks(n_valid, Q, sms=132)
            assert rows % 64 == 0 and rows > 0
            assert n_chunks * rows >= n_valid
            assert n_valid == 0 or (n_chunks - 1) * rows < n_valid
