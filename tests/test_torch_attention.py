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
    _, cfg = _cfgs()
    rng = np.random.default_rng(7)
    p = {k: torch.from_numpy(v) for k, v in _attn_params(cfg, rng).items()}
    x = torch.randn(1, 4, cfg.d_model)
    pos = torch.arange(4)[None]
    with pytest.raises(NotImplementedError, match="prefix"):
        attention.apply(p, cfg, x, positions=pos, mode="prefill",
                        mask_kind="prefix")
    with pytest.raises(NotImplementedError, match="0..S-1"):
        attention.apply(p, cfg, x, positions=pos + 3, mode="prefill")
    cache = attention.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    for extra in ({"pos": torch.zeros(1, 8, dtype=torch.int32)},
                  {"k_scale": torch.zeros(1, 8, cfg.num_kv_heads)}):
        with pytest.raises(NotImplementedError):
            attention.apply(p, cfg, x[:, :1], positions=pos[:, :1],
                            mode="decode", cache={**cache, **extra},
                            cache_pos=0)
    with pytest.raises(NotImplementedError, match="ring"):
        attention.cache_specs(cfg, 1, 32, torch.float32, window=8)
    with pytest.raises(NotImplementedError, match="int8"):
        attention.cache_specs(dataclasses.replace(cfg, kv_cache_quant="int8"),
                              1, 32, torch.float32)
