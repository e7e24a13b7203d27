"""The top-k MIPS kernels K1-K4 of the port against the JAX package: each
plain PyTorch version (what a CPU tensor runs) against the Pallas kernel
in interpret mode and the JAX oracle, on the same numpy-seeded inputs, and
the port's int8 quantizers bit-exact against the reference's.  Ids must
match exactly and scores to rtol=1e-5, atol=1e-6 (the two einsums may
round differently in the last ulp).  The CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

from repro.core.vector_index import quantize_rows_np as j_quantize_rows_np
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.vector_index import quantize_rows_np
from repro_torch.kernels import ops as tops
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


@pytest.mark.parametrize("k", [0, -1])
def test_k_outside_the_kernel_range_raises(k):
    q, bank, q_ns, labels, _ = _case(1, 40, 40)
    with pytest.raises(ValueError):
        tk.topk_mips_masked(*_torch(q, bank, q_ns, labels), k=k)


@pytest.mark.parametrize("k", [0, -1])
@pytest.mark.parametrize("name", ["topk_mips", "topk_mips_quant",
                                  "topk_mips_quant_masked"])
def test_sibling_k_outside_the_kernel_range_raises_naming_max_k(k, name):
    """k < 1 raises, naming k (every k >= 1 is answered: past MAX_K by the
    large-k path)."""
    q, bank, q_ns, labels, _ = _case(1, 40, 40)
    codes, scales = quantize_rows_np(bank)
    args = {"topk_mips": (q, bank), "topk_mips_quant": (q, codes, scales),
            "topk_mips_quant_masked": (q, codes, scales, q_ns, labels)}[name]
    with pytest.raises(ValueError, match=f"k={k}"):
        getattr(tops, name)(*_torch(*args), k=k)


def test_chunk_plan_covers_the_live_prefix():
    # K1 and K2 as the service calls them (k = 64 f32, k = 256 int8)
    for k, quant in ((64, False), (256, True)):
        for n_valid in (0, 1, 63, 64, 65, 1000, 65536, 1 << 20):
            for Q in (1, 64, 65, 200):
                n_chunks, rows = tk.plan_chunks(n_valid, Q, 132, k, True,
                                                quant, 32)
                tiles = -(-n_valid // 256)
                assert rows % 256 == 0 and rows > 0
                assert n_chunks * rows >= n_valid
                assert (n_chunks == 0) == (n_valid == 0)
                # no chunk without a tile; rows is the longest chunk
                assert n_chunks <= tiles
                assert n_valid == 0 or rows == -(-tiles // n_chunks) * 256


# -- K2, K3, K4 ---------------------------------------------------------------

def _quant_case(Q, N, n_valid, seed):
    """`_case` with the bank quantized by the reference's quantizer, after
    the adversarial rows of tests/test_quantized_index.py: an all-zero row
    (scale 0), tiny-norm rows (x1e-3) and huge-norm outliers (x1e3) beside
    unit-norm neighbours.  The planted duplicates keep identical codes."""
    q, bank, q_ns, labels, dups = _case(Q, N, n_valid, seed=seed)
    bank[5] = 0.0
    tiny = [r for r in range(7, N, 11) if r not in dups]
    huge = [r for r in range(13, N, 97) if r not in dups]
    bank[tiny] *= 1e-3
    bank[huge] *= 1e3
    codes, scales = j_quantize_rows_np(bank)
    return q, codes, scales, q_ns, labels, dups


def _run(name, Q, N, n_valid, k, seed):
    """One case of kernel `name` through the port's plain version, the
    Pallas kernel in interpret mode (k <= 32) and the JAX oracle."""
    if "quant" in name:
        q, bank, scales, q_ns, labels, dups = _quant_case(Q, N, n_valid, seed)
        lead = (q, bank, scales)
    else:
        q, bank, q_ns, labels, dups = _case(Q, N, n_valid, seed=seed)
        lead = (q, bank)
    args = lead + ((q_ns, labels) if "masked" in name else ())
    s, i = getattr(tk, name + "_ref")(*_torch(*args), k=k, n_valid=n_valid)
    s, i = s.numpy(), i.numpy()
    _assert_same(s, i, *getattr(jref, name + "_ref")(*args, k=k,
                                                       n_valid=n_valid))
    if k <= 32:
        _assert_same(s, i, *getattr(jops, name)(*args, k=k, n_valid=n_valid,
                                                interpret=True))
    return s, i, q_ns, labels, dups


SIBLINGS = ["topk_mips", "topk_mips_quant", "topk_mips_quant_masked"]


@pytest.mark.parametrize("name", SIBLINGS)
@pytest.mark.parametrize("Q,N,n_valid,k", [(7, 300, 260, 16),
                                           (8, 2048, 1900, 32)])
def test_sibling_plain_versions_match_pallas_interpret(name, Q, N, n_valid,
                                                       k):
    s, i, q_ns, labels, dups = _run(name, Q, N, n_valid, k, seed=Q + N)
    live = i >= 0
    assert (s[~live] == np.float32(NEG_INF)).all()
    assert (i[live] < n_valid).all()
    if "masked" in name:
        assert (labels[i[live]] ==
                np.repeat(q_ns, k).reshape(Q, k)[live]).all()
        assert live[1].sum() == 2 and not live[2].any()
    else:
        assert live.all()
    # the duplicates tie exactly and rank in row order, side by side
    pos = [list(i[0]).index(d) for d in dups]
    assert pos == list(range(pos[0], pos[0] + 3))
    assert len(set(s[0, pos].tolist())) == 1


@pytest.mark.parametrize("name", SIBLINGS + ["topk_mips_masked"])
def test_plain_versions_match_the_jax_oracle_at_k_256(name):
    _run(name, 64, 1500, 1400, 256, seed=3)


@pytest.mark.parametrize("name", SIBLINGS + ["topk_mips_masked"])
def test_ops_entry_points_run_the_plain_version_on_cpu(name):
    q, bank, q_ns, labels, _ = _case(7, 300, 260, seed=1)
    codes, scales = quantize_rows_np(bank)
    lead = (q, codes, scales) if "quant" in name else (q, bank)
    args = _torch(*lead, *((q_ns, labels) if "masked" in name else ()))
    fn = getattr(tops, name)
    assert fn is getattr(tk, name)
    s, i = fn(*args, k=16, n_valid=260)
    s_r, i_r = getattr(tk, name + "_ref")(*args, k=16, n_valid=260)
    assert fn.launches == 0
    assert torch.equal(i, i_r) and torch.equal(s, s_r)
    assert i.dtype == torch.int32 and s.dtype == torch.float32


def test_quantizers_are_bit_exact_against_the_reference():
    rng = np.random.default_rng(11)
    bank = rng.standard_normal((257, 48)).astype(np.float32)
    bank[3] = 0.0
    bank[7] *= 1e-5
    bank[11] *= 1e4
    bank[20] = np.float32(0.5) * 127 / np.arange(1, 49)   # halfway codes
    want_c, want_s = j_quantize_rows_np(bank)
    for codes, scales in (quantize_rows_np(bank),
                          tuple(t.numpy() for t in
                                tk.quantize_rows_ref(torch.from_numpy(bank)))):
        assert codes.dtype == np.int8 and scales.dtype == np.float32
        np.testing.assert_array_equal(codes, want_c)
        np.testing.assert_array_equal(scales, want_s)
    c_ref, s_ref = jref.quantize_rows_ref(bank)
    np.testing.assert_array_equal(want_c, np.asarray(c_ref))
    np.testing.assert_array_equal(want_s, np.asarray(s_ref))
