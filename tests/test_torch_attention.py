"""The attention kernels K5/K6 and the model layers of the port against the
JAX package on the CPU.

* Each kernel's plain PyTorch version (what a CPU tensor runs) against the
  Pallas kernel in interpret mode and against the JAX oracle, over the
  cases of the reference's own kernel tests, plus kv_len = 1 and a
  garbage cache tail.  f32 at 2e-5 (the reference's tolerance: online
  against direct softmax round differently), bf16 at 2e-2.
* The layers — norms, RoPE with a partial rotary fraction, the clipping
  embedding, the gated MLP and attention in prefill and decode modes —
  against their JAX counterparts on the same numpy-seeded weights and
  inputs, at 1e-5 (f32 einsum orders differ in the last ulps).

The CUDA kernels themselves are held against the same plain versions on
the card by chip_smoke.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import attention as jattn
from repro.models.layers import embedding as jemb
from repro.models.layers import mlp as jmlp
from repro.models.layers import norms as jnorms
from repro.models.layers import rope as jrope
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models.layers import attention, embedding, mlp, norms, rope

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LAYER_TOL = 1e-5


def _pair(x, dtype="float32"):
    """One numpy array as a JAX array and a torch tensor of `dtype` (both
    cast from the same f32 values)."""
    tdt = getattr(torch, dtype)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(tdt)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# K6: flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,K,G,S,D,bq,bk", [
    (1, 1, 1, 32, 16, 8, 8),
    (2, 2, 4, 64, 32, 16, 32),
    (1, 3, 2, 70, 32, 32, 16),    # ragged vs blocks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas_and_oracle(B, K, G, S, D, bq,
                                                         bk, dtype, causal):
    rng = np.random.default_rng(5)
    jq, tq = _pair(rng.standard_normal((B, K, G, S, D)).astype(np.float32),
                   dtype)
    jk, tk = _pair(rng.standard_normal((B, K, S, D)).astype(np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((B, K, S, D)).astype(np.float32), dtype)
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                                  block_k=bk)
    _close(got, pallas, TOL[dtype])
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal),
           TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_window_matches_pallas(causal):
    B, K, G, S, D = 1, 2, 2, 96, 16
    rng = np.random.default_rng(8)
    jq, tq = _pair(rng.standard_normal((B, K, G, S, D)).astype(np.float32))
    jk, tk = _pair(rng.standard_normal((B, K, S, D)).astype(np.float32))
    jv, tv = _pair(rng.standard_normal((B, K, S, D)).astype(np.float32))
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=16)
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal, window=16,
                                     block_q=32, block_k=32), 2e-5)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                         window=16), 2e-5)


def test_flash_attention_reads_strided_views():
    """The attention layer passes permuted views of (B, S, H, D) and
    (B, T, K, D) tensors; the result equals that of contiguous copies."""
    rng = np.random.default_rng(9)
    B, S, K, G, D = 2, 20, 2, 3, 8
    q = torch.from_numpy(rng.standard_normal((B, S, K * G, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, K, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, K, D)).astype(np.float32))
    qv = q.view(B, S, K, G, D).permute(0, 2, 3, 1, 4)
    got = tfa.flash_attention(qv, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))
    want = tfa.flash_attention(qv.contiguous(), k.permute(0, 2, 1, 3).contiguous(),
                               v.permute(0, 2, 1, 3).contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K5: decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,K,G,T,D,bt", [
    (1, 1, 1, 64, 16, 16),
    (3, 2, 4, 200, 32, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas_and_oracle(B, K, G, T, D, bt,
                                                          dtype):
    rng = np.random.default_rng(11)
    jq, tq = _pair(rng.standard_normal((B, K, G, D)).astype(np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((B, K, T, D)).astype(np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((B, K, T, D)).astype(np.float32), dtype)
    lens = np.asarray([T - 3 - 7 * b for b in range(B)], np.int32)
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    jl = jnp.asarray(lens)
    _close(got, jops.decode_attention(jq, jk, jv, jl, block_t=bt), TOL[dtype])
    _close(got, jref.decode_attention_ref(jq, jk, jv, jl), TOL[dtype])


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_kv_len_one_and_window(window):
    """kv_len = 1 attends to exactly the first row; T and a ragged length
    beside it; a window keeps the last `window` rows."""
    rng = np.random.default_rng(12)
    B, K, G, T, D = 3, 2, 3, 40, 16
    jq, tq = _pair(rng.standard_normal((B, K, G, D)).astype(np.float32))
    jk, tk = _pair(rng.standard_normal((B, K, T, D)).astype(np.float32))
    jv, tv = _pair(rng.standard_normal((B, K, T, D)).astype(np.float32))
    lens = np.asarray([1, T, 17], np.int32)
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(lens),
                                window=window)
    jl = jnp.asarray(lens)
    _close(got, jops.decode_attention(jq, jk, jv, jl, window=window,
                                      block_t=16), 2e-5)
    _close(got, jref.decode_attention_ref(jq, jk, jv, jl, window=window), 2e-5)
    # kv_len = 1: the output is the first value row, for every head
    torch.testing.assert_close(got[0], tv[0, :, :1].expand(K, G, D))


def test_decode_attention_ignores_the_cache_tail():
    """Cache rows past kv_len (stale rows of an earlier slot occupant) must
    not change the output, even when they hold huge values."""
    rng = np.random.default_rng(14)
    B, K, G, T, D = 2, 1, 2, 128, 16
    q = torch.from_numpy(rng.standard_normal((B, K, G, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, K, T, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, K, T, D)).astype(np.float32))
    lens = torch.tensor([40, 90], dtype=torch.int32)
    out1 = tda.decode_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lens.tolist()):
        k2[b, :, n:] = 999.0
        v2[b, :, n:] = -999.0
    out2 = tda.decode_attention(q, k2, v2, lens)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)


def test_a_query_with_no_allowed_key_outputs_zero():
    """Masked keys get exactly zero weight, so a query that may see no key
    outputs 0 (the reference's Pallas decode kernel gives 0 for kv_len 0;
    its oracles average the masked keys).  Every other row is the
    oracle's."""
    rng = np.random.default_rng(15)
    jq, tq = _pair(rng.standard_normal((1, 1, 2, 10, 8)).astype(np.float32))
    jk, tk = _pair(rng.standard_normal((1, 1, 4, 8)).astype(np.float32))
    got = tfa.flash_attention(tq, tk, tk, causal=True, window=2)
    assert torch.equal(got[..., 5:, :], torch.zeros_like(got[..., 5:, :]))
    _close(got[..., :5, :], jref.flash_attention_ref(
        jq, jk, jk, causal=True, window=2)[..., :5, :], 2e-5)
    jq, tq = _pair(rng.standard_normal((2, 1, 2, 8)).astype(np.float32))
    jk, tk = _pair(rng.standard_normal((2, 1, 6, 8)).astype(np.float32))
    lens = np.asarray([0, 3], np.int32)
    got = tda.decode_attention(tq, tk, tk, torch.from_numpy(lens))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1], jref.decode_attention_ref(jq, jk, jk,
                                             jnp.asarray(lens))[1], 2e-5)
    _close(got, jops.decode_attention(jq, jk, jk, jnp.asarray(lens)), 2e-5)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers run the plain versions and launch nothing."""
    before = (tfa.flash_attention.launches, tda.decode_attention.launches)
    q = torch.randn(1, 1, 2, 4, 8)
    k = torch.randn(1, 1, 4, 8)
    torch.testing.assert_close(tfa.flash_attention(q, k, k),
                               tfa.flash_attention_ref(q, k, k))
    lens = torch.tensor([3], dtype=torch.int32)
    torch.testing.assert_close(tda.decode_attention(q[:, :, :, 0], k, k, lens),
                               tda.decode_attention_ref(q[:, :, :, 0], k, k,
                                                        lens))
    assert (tfa.flash_attention.launches,
            tda.decode_attention.launches) == before


@pytest.mark.parametrize("T,B,K,want", [
    (512, 8, 4, 9),             # the agent's decode step: 288 CTAs
    (4096, 8, 4, 9),
    (64, 1, 1, 32),
    (200, 3, 2, 32),
    (100, 128, 8, 1),           # enough CTAs already: one split
])
def test_decode_split_plan_covers_the_cache(T, B, K, want):
    """The grid depends on the shape alone; each CTA's rows come from
    kv_len on the device (`split_range`, the kernel's arithmetic): for every
    kv_len in 1..T and window, the splits tile the allowed range
    [max(0, kv_len - window), kv_len) in order, each position in exactly
    one split, their sizes differing by at most one row."""
    n_split = tda.plan_splits(T, B, K, sms=132)
    assert n_split == want
    for window in (0, 20):
        for kv_len in range(1, T + 1):
            lo_all = max(0, kv_len - window) if window else 0
            bounds = [tda.split_range(kv_len, T, window, n_split, s)
                      for s in range(n_split)]
            assert bounds[0][0] == lo_all and bounds[-1][1] == kv_len
            assert all(hi == lo for (_, hi), (lo, _) in zip(bounds,
                                                           bounds[1:]))
            sizes = [hi - lo for lo, hi in bounds]
            n = kv_len - lo_all
            assert set(sizes) <= {n // n_split, -(-n // n_split)}
            if n >= n_split:
                assert min(sizes) > 0       # no CTA launched empty


def _allowed(S, T, causal, window):
    s = np.arange(S)[:, None]
    t = np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if causal:
        ok &= t <= s
    if window > 0:
        ok &= t > s - window
    return ok


@pytest.mark.parametrize("G,S,T,D", [(3, 150, 150, 64), (3, 4096, 4096, 64),
                                     (1, 64, 64, 64), (2, 100, 40, 16),
                                     (2, 40, 100, 128), (16, 33, 33, 256)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 16),
                                           (False, 16)])
def test_flash_grid_covers_every_allowed_pair_once(G, S, T, D, causal,
                                                   window):
    """K6's grid (`flash_grid`) and each CTA's key loop (`flash_key_range`,
    the kernel's arithmetic) visit every allowed (query row, key) pair of
    the problem exactly once: the row blocks partition the G*S rows and a
    block's tiles hold every key its rows may see."""
    for B, K in ((1, 4), (16, 4)):
        narrow, rows, keys, ctas = tfa.flash_grid(B, K, G, S, D, sms=132)
        dp = tfa.padded_head_dim(D)
        assert (rows, keys) == tfa.FLASH_CONFIGS[dp][narrow][:2]
        n_blocks = -(-G * S // rows)
        assert ctas == n_blocks * K * B
        wide_ctas = -(-G * S // tfa.FLASH_CONFIGS[dp][False][0]) * K * B
        assert narrow == (wide_ctas < 132)
        ok = _allowed(S, T, causal, window)
        visits = np.zeros((G * S, T), np.int8)
        for blk in range(n_blocks):
            r0 = blk * rows
            t0, t1 = tfa.flash_key_range(r0, rows, keys, G, S, T, causal,
                                         window)
            assert t0 % keys == 0
            for t in range(t0, t1, keys):          # the kernel's tile loop
                visits[r0:r0 + rows, t:min(t + keys, T)] += 1
        rows_ok = np.repeat(ok, G, axis=0)          # row r is position r // G
        assert (visits[rows_ok] == 1).all()
        assert visits.max() <= 1
    # the agent's prefill fills the card; the long context takes the wide
    # CTA shape
    assert tfa.flash_grid(1, 4, 3, 150, 64, 132)[3] >= 132
    assert not tfa.flash_grid(1, 4, 3, 4096, 64, 132)[0]


@pytest.mark.parametrize("dtype,D,offset,want", [
    (torch.float32, 64, 0, True), (torch.bfloat16, 64, 0, True),
    (torch.float32, 50, 0, False), (torch.bfloat16, 50, 0, False),
    (torch.bfloat16, 8, 0, True), (torch.float32, 64, 1, False)])
def test_cp_async_ok_needs_16_byte_rows_bases_and_strides(dtype, D, offset,
                                                          want):
    """K5 and K6 stage K/V by 16-byte cp.async only when every row start is
    a 16-byte multiple (`cp_async_ok`, shared by both wrappers); D = 50 or
    a view one element into its storage takes the plain loads."""
    base = torch.zeros(2 * 3 * 40 * D + 64, dtype=dtype)
    start = (-base.data_ptr() // base.element_size()) % (
        16 // base.element_size()) + offset
    cache = base[start:start + 2 * 40 * 3 * D].view(2, 40, 3, D)
    k = cache.permute(0, 2, 1, 3)                 # the engine's (B, T, K, D)
    assert tfa.cp_async_ok(D, base.element_size(), k, k) is want


def test_library_tag_follows_the_shared_headers(tmp_path, monkeypatch):
    """A kernel library is named by a hash of its source and of the shared
    headers, so editing `csrc/attention_common.cuh` rebuilds K5 and K6."""
    from repro_torch.kernels import build
    assert (build.CSRC / "attention_common.cuh").exists()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "common.cuh").write_text("// two\n")
    assert build.library_path("k") != first


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _cfgs():
    jcfg = jget_config("memori-agent").reduced(layers=2, d_model=64)
    return jcfg, get_config("memori-agent").reduced(layers=2, d_model=64)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match(norm):
    jcfg, cfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, norm=norm)
    cfg = dataclasses.replace(cfg, norm=norm)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    if norm == "rmsnorm":
        del p["bias"]
    got = norms.apply({k: torch.from_numpy(v) for k, v in p.items()}, cfg,
                      torch.from_numpy(x))
    want = jnorms.apply({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                        jnp.asarray(x))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("pct", [1.0, 0.25])
def test_rope_matches(pct):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          theta=10000.0, pct=pct)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10000.0,
                            pct=pct)
    _close(got, want, 1e-5)
    if pct < 1:
        torch.testing.assert_close(got[..., 4:], torch.from_numpy(x)[..., 4:])


def test_embedding_clips_out_of_range_ids_and_ties_logits():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(2)
    table = rng.standard_normal((cfg.vocab_size, 64)).astype(np.float32)
    ids = np.asarray([[0, 5, cfg.vocab_size - 1, cfg.vocab_size, 10 ** 6,
                       -3]], np.int32)
    got = embedding.embed({"table": torch.from_numpy(table)}, cfg,
                          torch.from_numpy(ids))
    want = jemb.embed({"table": jnp.asarray(table)}, jcfg, jnp.asarray(ids))
    _close(got, want, 0.0)
    h = rng.standard_normal((1, 3, 64)).astype(np.float32)
    got = embedding.logits({"table": torch.from_numpy(table)}, cfg,
                           torch.from_numpy(h))
    assert got.dtype == torch.float32
    _close(got, jemb.logits({"table": jnp.asarray(table)}, jcfg,
                            jnp.asarray(h)), 1e-4)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches(act):
    jcfg, cfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, act=act)
    cfg = dataclasses.replace(cfg, act=act)
    rng = np.random.default_rng(3)
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.2
         for n, s in (("wi", (64, 128)), ("wg", (64, 128)), ("wo", (128, 64)))}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    got = mlp.apply({k: torch.from_numpy(v) for k, v in p.items()}, cfg,
                    torch.from_numpy(x))
    want = jmlp.apply({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                      jnp.asarray(x))
    _close(got, want, LAYER_TOL)


def _attn_params(cfg, rng):
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {"wq": rng.standard_normal((d, h, hd)).astype(np.float32) / 8,
            "wk": rng.standard_normal((d, kv, hd)).astype(np.float32) / 8,
            "wv": rng.standard_normal((d, kv, hd)).astype(np.float32) / 8,
            "wo": rng.standard_normal((h, hd, d)).astype(np.float32) / 8}


@pytest.mark.parametrize("mask_kind,window", [("causal", 0), ("bidir", 0),
                                              ("causal", 4)])
def test_attention_prefill_matches(mask_kind, window):
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(4)
    p = _attn_params(cfg, rng)
    B, S = 2, 9
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    got, cache = attention.apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, cfg,
        torch.from_numpy(x), positions=torch.from_numpy(pos.copy()),
        mode="prefill", mask_kind=mask_kind, window=window, return_cache=True)
    want, jcache = jattn.apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
        positions=jnp.asarray(pos), mode="prefill", mask_kind=mask_kind,
        window=window, return_cache=True)
    _close(got, want, LAYER_TOL)
    _close(cache["k"], jcache["k"], LAYER_TOL)
    _close(cache["v"], jcache["v"], LAYER_TOL)


def test_attention_decode_matches_and_updates_the_cache_in_place():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(6)
    p = _attn_params(cfg, rng)
    B, T = 3, 12
    shape = (B, T, cfg.num_kv_heads, cfg.resolved_head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray([0, 7, T - 1], np.int32)
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    k_buf = cache["k"]
    got, new = attention.apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, cfg,
        torch.from_numpy(x), positions=torch.from_numpy(pos[:, None].copy()),
        mode="decode", cache=cache, cache_pos=torch.from_numpy(pos))
    want, jnew = jattn.apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
        positions=jnp.asarray(pos[:, None]), mode="decode",
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        cache_pos=jnp.asarray(pos))
    _close(got, want, LAYER_TOL)
    assert new is cache and new["k"] is k_buf
    _close(new["k"], jnew["k"], LAYER_TOL)
    _close(new["v"], jnew["v"], LAYER_TOL)


def test_attention_unsupported_paths_raise():
    """K6 masks a window of positions: a train/prefill call whose query (or
    cross-attention key) positions are not a row offset + 0..S-1 raises
    (an offset window itself is served: tests/test_torch_offsets.py)."""
    _, cfg = _cfgs()
    rng = np.random.default_rng(7)
    p = {k: torch.from_numpy(v) for k, v in _attn_params(cfg, rng).items()}
    x = torch.randn(1, 4, cfg.d_model)
    pos = torch.arange(4)[None]
    with pytest.raises(NotImplementedError, match="0..S-1"):
        attention.apply(p, cfg, x, positions=pos.flip(1), mode="prefill")
    with pytest.raises(NotImplementedError, match="0..S-1"):
        attention.apply(p, cfg, x, positions=pos, mode="prefill",
                        kv_x=torch.randn(1, 6, cfg.d_model),
                        kv_positions=torch.tensor([[0, 1, 2, 4, 5, 6]]),
                        use_rope=False)


# ---------------------------------------------------------------------------
# The zoo's variants: K5 with slot positions and int8 codes, K6 with a
# prefix and across sequences (S != T); plain versions against the
# reference's `attend`
# ---------------------------------------------------------------------------

def _ref_attend_grouped(q, k, v, q_pos, kv_pos, **kw):
    """The reference's `attend` on the kernels' grouped layout: q (B, K, G,
    S, D), k/v (B, K, T, D) numpy -> (B, K, G, S, D)."""
    B, K, G, S, D = q.shape
    qh = jnp.asarray(q).transpose(0, 3, 1, 2, 4).reshape(B, S, K * G, D)
    out = jattn.attend(qh, jnp.asarray(k).transpose(0, 2, 1, 3),
                       jnp.asarray(v).transpose(0, 2, 1, 3),
                       q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
                       **kw)
    return np.asarray(out).reshape(B, S, K, G, D).transpose(0, 2, 3, 1, 4)


def _ring_positions(q_pos, T, rng, holes):
    """Slot positions of a ring cache of T slots for queries at q_pos:
    slot i holds the latest p <= q with p = i (mod T), -1 if none; then
    `holes` random other slots emptied (ragged slot order, -1 slots)."""
    i = np.arange(T)[None, :]
    qp = np.asarray(q_pos)[:, None]
    pos = qp - ((qp - i) % T)
    pos[pos < 0] = -1
    for b in range(len(q_pos)):
        cand = np.flatnonzero(pos[b] != q_pos[b])
        pos[b, rng.choice(cand, size=min(holes, cand.size),
                          replace=False)] = -1
    return pos.astype(np.int32)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("holes", [0, 3])
def test_decode_slot_positions_match_the_reference(window, holes):
    """K5's slot-position variant (the ring-buffer cache): slot t is
    allowed where 0 <= slot_pos <= q_pos (and > q_pos - window), against
    the reference's `attend` with kv_pos = the slots' positions."""
    rng = np.random.default_rng(20 + holes)
    B, K, G, T, D = 4, 2, 3, 16, 8
    q_pos = [3, 15, 16, 41]                 # before, at and past one lap
    q = rng.standard_normal((B, K, G, D)).astype(np.float32)
    k = rng.standard_normal((B, K, T, D)).astype(np.float32)
    v = rng.standard_normal((B, K, T, D)).astype(np.float32)
    sp = _ring_positions(q_pos, T, rng, holes)
    kv_len = np.asarray(q_pos, np.int32) + 1
    got = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(kv_len),
                               window=window, slot_pos=torch.from_numpy(sp))
    want = _ref_attend_grouped(q[:, :, :, None], k, v,
                               np.asarray(q_pos)[:, None], sp, kind="causal",
                               window=window)[:, :, :, 0]
    _close(got, want, 2e-5)
    # the slots' order does not matter: the same keys permuted
    perm = rng.permutation(T)
    got2 = tda.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k[:, :, perm]),
        torch.from_numpy(v[:, :, perm]), torch.from_numpy(kv_len),
        window=window, slot_pos=torch.from_numpy(sp[:, perm].copy()))
    torch.testing.assert_close(got2, got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slots", [False, True])
def test_decode_int8_codes_match_dequantize_then_attend(dtype, slots):
    """K5's int8 variant: codes and per-row scales dequantised as the
    reference's `dequantize_kv` (code * scale in f32, rounded to the
    compute dtype), then the reference's `attend` — also on the ring."""
    rng = np.random.default_rng(30)
    B, K, G, T, D = 3, 2, 2, 12, 16
    tdt = getattr(torch, dtype)
    q = rng.standard_normal((B, K, G, D)).astype(np.float32)
    kc = rng.integers(-127, 128, (B, K, T, D)).astype(np.int8)
    vc = rng.integers(-127, 128, (B, K, T, D)).astype(np.int8)
    ks = (rng.random((B, K, T)) * 0.05 + 1e-3).astype(np.float32)
    vs = (rng.random((B, K, T)) * 0.05 + 1e-3).astype(np.float32)
    q_pos = [2, 11, 30] if slots else [2, 11, 7]
    kv_len = np.asarray(q_pos, np.int32) + 1
    sp = _ring_positions(q_pos, T, rng, 1) if slots else None
    tq = torch.from_numpy(q).to(tdt)
    got = tda.decode_attention(
        tq, torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(kv_len), k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs),
        slot_pos=None if slots is False else torch.from_numpy(sp))
    assert got.dtype == tdt
    jq = jnp.asarray(q).astype(dtype)
    jk = jattn.dequantize_kv(jnp.asarray(kc), jnp.asarray(ks), jq.dtype)
    jv = jattn.dequantize_kv(jnp.asarray(vc), jnp.asarray(vs), jq.dtype)
    kv_pos = sp if slots else np.broadcast_to(np.arange(T), (B, T))
    kw = {} if slots else {"kv_len_valid": jnp.asarray(kv_len)}
    want = _ref_attend_grouped(np.asarray(jq.astype(jnp.float32))[:, :, :, None],
                               np.asarray(jk.astype(jnp.float32)),
                               np.asarray(jv.astype(jnp.float32)),
                               np.asarray(q_pos)[:, None], kv_pos,
                               kind="causal", **kw)[:, :, :, 0]
    _close(got, want, TOL[dtype])
    # the dequantised rows are exactly the reference's, in the dtype
    deq = tda.dequantize(torch.from_numpy(kc), torch.from_numpy(ks), tdt)
    _close(deq, jk, 0.0)


@pytest.mark.parametrize("prefix", [0, 6, 20, "rows"])
@pytest.mark.parametrize("window", [0, 4])
def test_flash_prefix_matches_the_reference(prefix, window):
    """K6's prefix mask (t <= s or t < prefix_len, then the window), with a
    scalar prefix and per-row prefixes, against the reference's
    `attend(kind="prefix")`."""
    rng = np.random.default_rng(40)
    B, K, G, S, D = 3, 2, 2, 14, 8
    q = rng.standard_normal((B, K, G, S, D)).astype(np.float32)
    k = rng.standard_normal((B, K, S, D)).astype(np.float32)
    v = rng.standard_normal((B, K, S, D)).astype(np.float32)
    if prefix == "rows":
        pl = np.asarray([0, 5, 14], np.int32)
        tpl, jpl = torch.from_numpy(pl), jnp.asarray(pl)
    else:
        tpl = jpl = prefix
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window,
                              prefix_len=tpl)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = _ref_attend_grouped(q, k, v, pos, pos, kind="prefix",
                               window=window, prefix_len=jpl)
    _close(got, want, 2e-5)


def test_flash_cross_attention_s_ne_t_matches_the_reference():
    """Cross-attention: bidirectional, queries 0..S-1 over an encoder's
    keys 0..T-1 with S != T (both ways), against the reference's
    `attend(kind="bidir")`."""
    rng = np.random.default_rng(41)
    for S, T in ((5, 23), (23, 5)):
        B, K, G, D = 2, 3, 1, 16
        q = rng.standard_normal((B, K, G, S, D)).astype(np.float32)
        k = rng.standard_normal((B, K, T, D)).astype(np.float32)
        v = rng.standard_normal((B, K, T, D)).astype(np.float32)
        got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False)
        want = _ref_attend_grouped(
            q, k, v, np.broadcast_to(np.arange(S), (B, S)),
            np.broadcast_to(np.arange(T), (B, T)), kind="bidir")
        _close(got, want, 2e-5)


@pytest.mark.parametrize("causal,window,prefix", [
    (True, 0, 40), (True, 16, 40), (True, 0, 200), (True, 16, 1)])
def test_flash_grid_covers_every_prefix_pair_once(causal, window, prefix):
    """With a prefix, each CTA's key loop (`flash_key_range`) reaches
    max(s_hi + 1, prefix_len): every allowed (row, key) pair of the prefix
    mask is visited exactly once."""
    G, S, D = 3, 150, 64
    for B, K in ((1, 4), (16, 4)):
        _, rows, keys, _ = tfa.flash_grid(B, K, G, S, D, sms=132)
        ok = _allowed(S, S, causal, 0)
        ok[:, :prefix] = True
        if window > 0:
            ok &= _allowed(S, S, False, window)
        visits = np.zeros((G * S, S), np.int8)
        for r0 in range(0, G * S, rows):
            t0, t1 = tfa.flash_key_range(r0, rows, keys, G, S, S, causal,
                                         window, prefix)
            for t in range(t0, t1, keys):
                visits[r0:r0 + rows, t:min(t + keys, S)] += 1
        rows_ok = np.repeat(ok, G, axis=0)
        assert (visits[rows_ok] == 1).all() and visits.max() <= 1


def test_quantize_kv_rounds_half_to_even_as_the_reference():
    """quantize_kv: per-(token, head) scale max|x| / 127, codes rounded
    half to even (`jnp.round`), clipped to +-127 — equal codes and scales."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((3, 7, 2, 16)).astype(np.float32)
    x[0, 0, 0] = np.arange(16) - 7.5          # exact .5 steps
    x[1, 1, 1] = 0.0                          # an all-zero row: scale 1e-8
    codes, sc = attention.quantize_kv(torch.from_numpy(x))
    jcodes, jsc = jattn.quantize_kv(jnp.asarray(x))
    assert codes.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


@pytest.mark.parametrize("layout", ["ring", "int8", "ring_int8"])
def test_attention_decode_layouts_match_the_reference(layout):
    """attention.apply(mode="decode") on the ring-buffer cache (slot
    positions written in place), the int8 cache (codes and scales written
    in place) and both: output and every cache entry equal the
    reference's."""
    jcfg, cfg = _cfgs()
    quant = "int8" in layout
    if quant:
        jcfg = dataclasses.replace(jcfg, kv_cache_quant="int8")
        cfg = dataclasses.replace(cfg, kv_cache_quant="int8")
    rng = np.random.default_rng(43)
    p = _attn_params(cfg, rng)
    B, T = 3, 10
    window = 6 if "ring" in layout else 0
    specs = attention.cache_specs(cfg, B, 64 if window else T, torch.float32,
                                  window=window)
    jspecs = jattn.cache_specs(jcfg, B, 64 if window else T, jnp.float32,
                               window=window)
    assert {n: (s, str(d)[6:]) for n, (s, _a, d) in specs.items()} ==         {n: (s, str(np.dtype(d))) for n, (s, _a, d) in jspecs.items()}
    cache = {}
    for name, (shape, _a, dt) in specs.items():
        if name == "pos":
            a = _ring_positions([4, 9, 20], window, rng, 0)
        elif dt == torch.int8:
            a = rng.integers(-127, 128, shape).astype(np.int8)
        else:
            a = (rng.random(shape) * 0.05 + 0.01).astype(np.float32) \
                if "scale" in name else rng.standard_normal(shape).astype(
                    np.float32)
        cache[name] = a
    pos = np.asarray([5, 10, 21], np.int32) if window else \
        np.asarray([0, 5, 9], np.int32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    got, new = attention.apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, cfg,
        torch.from_numpy(x), positions=torch.from_numpy(pos[:, None].copy()),
        mode="decode", cache=tcache, cache_pos=torch.from_numpy(pos),
        window=window)
    want, jnew = jattn.apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
        positions=jnp.asarray(pos[:, None]), mode="decode",
        cache={n: jnp.asarray(a) for n, a in cache.items()},
        cache_pos=jnp.asarray(pos), window=window)
    _close(got, want, LAYER_TOL)
    assert new is tcache and set(new) == set(jnew)
    for name in new:
        tol = 0.0 if new[name].dtype in (torch.int8, torch.int32) else \
            LAYER_TOL
        _close(new[name], jnew[name], tol)


def test_cross_attention_prefill_and_decode_match_the_reference():
    """Cross-attention (no rope, no biases): prefill over an encoder's
    output (S != T, bidirectional) returns its k/v cache, and cross decode
    against that cache equals the reference's."""
    jcfg = jget_config("whisper-small").reduced(layers=2, d_model=64)
    cfg = get_config("whisper-small").reduced(layers=2, d_model=64)
    rng = np.random.default_rng(44)
    p = _attn_params(cfg, rng)
    B, S, F = 2, 7, 19
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, F, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    epos = np.broadcast_to(np.arange(F, dtype=np.int32), (B, F)).copy()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got, cache = attention.apply(
        tp, cfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
        kv_x=torch.from_numpy(enc), kv_positions=torch.from_numpy(epos),
        mode="prefill", use_rope=False, return_cache=True)
    want, jcache = jattn.apply(
        jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
        kv_x=jnp.asarray(enc), kv_positions=jnp.asarray(epos),
        mode="prefill", use_rope=False, return_cache=True)
    _close(got, want, LAYER_TOL)
    _close(cache["k"], jcache["k"], LAYER_TOL)
    xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    got, same = attention.apply(
        tp, cfg, torch.from_numpy(xd), positions=torch.zeros(B, 1),
        mode="cross_decode", cache=cache, use_rope=False)
    want, _ = jattn.apply(jp, jcfg, jnp.asarray(xd),
                          positions=jnp.zeros((B, 1), jnp.int32),
                          mode="cross_decode", cache=jcache, use_rope=False)
    _close(got, want, LAYER_TOL)
    assert same is cache
