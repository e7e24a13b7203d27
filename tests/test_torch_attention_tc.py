"""The bf16 (tensor-core) instances of K5 and K6, on the CPU.

The CUDA kernels run only on the card, where chip_smoke.py holds them
against their plain versions.  Here:

* Grid mirrors.  `flash_grid` / `TC_CONFIGS` / `tc_splits` /
  `tc_split_range` (K6) and `plan_splits` / `split_range` (K5) describe
  the bf16 launches as the C launchers make them: every flattened (s, g)
  row of every (b, kv-head) is finalised by exactly one CTA, every output
  column by one column slice, a narrow cluster's key splits cover the row
  block's key tiles exactly once, and no CTA's key loop skips an allowed
  key.  Checked exhaustively over small shapes, off-tile S, T, prefixes
  and windows included.
* The rounding budget.  A CPU model of the kernels' arithmetic (f32
  products of bf16 values over key tiles, the online softmax in base 2,
  P rounded to bf16 before P.V, l summed from the unrounded f32 p, the
  warps' and the splits' partial states combined) against the JAX
  reference `ref.flash_attention_ref` / `ref.decode_attention_ref` (the
  port's plain version where the reference has no such input: prefix
  masks, slot positions, int8 codes), at the zoo's head shapes and small
  S and T: within 2e-2 x max|v|, the gate the zoo holds the card to.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa

BF16 = torch.bfloat16
LOG2E = 1.4426950408889634
GATE = 2e-2                 # x max|v|: the zoo's bf16 gate (PERF.md)
NEG = -2.0e38               # the kernels' finite starting maximum


def _rand(rng, shape):
    """Seeded normal values, rounded to bf16 (exact in f32 from here)."""
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(BF16)


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _allowed(s, t, T, causal, window, prefix):
    """The kernels' mask for query position s and key t."""
    return (t < T and (not causal or t <= s or t < prefix)
            and (window <= 0 or t > s - window))


# ---------------------------------------------------------------------------
# grid mirrors
# ---------------------------------------------------------------------------

HEAD_DIMS = (16, 50, 64, 100, 128, 180, 192, 250, 256, 515, 576)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("B,K,G,S", [(1, 1, 1, 1), (1, 1, 3, 70), (2, 4, 2, 33),
                                     (1, 128, 1, 200), (2, 12, 1, 64),
                                     (1, 1, 128, 40)])
@pytest.mark.parametrize("sms", [1, 132, 100_000])
def test_tc_grid_finalises_every_row_and_column_once(D, B, K, G, S, sms):
    narrow, rows, keys, ctas = tfa.flash_grid(B, K, G, S, D, sms, BF16)
    block, tile = tfa.TC_CONFIGS[tfa.tc_head_class(D)]
    slices = tfa.column_slices(D, BF16)
    blocks = -(-G * S // block) * K * B
    n_split = tfa.tc_splits(blocks * slices, sms)
    # the C launcher's rule: wide when the grid fills the card, else the
    # fewest of 2, 4, 8 ways
    assert narrow == (blocks * slices < sms)
    if narrow:
        assert n_split in (2, 4, 8)
        assert n_split == 8 or blocks * slices * n_split >= sms
        assert n_split == 2 or blocks * slices * n_split // 2 < sms
    else:
        assert n_split == 1
    assert (rows, keys, ctas) == (block // n_split, tile,
                                  blocks * slices * n_split)
    # rows: (block i, rank r) finalises [i block + r rows, + rows)
    seen = np.zeros(G * S, int)
    for i in range(-(-G * S // block)):
        for r in range(n_split):
            lo = i * block + r * rows
            seen[lo:min(lo + rows, G * S)] += 1
    assert (seen == 1).all()
    # columns: slice c writes [192 c, 192 c + 192) of the 576 class
    cols = np.zeros(D, int)
    width = tfa.TC_SLICE if slices > 1 else D
    for c in range(slices):
        cols[c * width:min(D, (c + 1) * width)] += 1
    assert (cols == 1).all()


def test_f32_grid_is_unchanged_by_the_dtype_argument():
    for D in (16, 64, 128, 256, 576):
        for S in (1, 150, 4096):
            assert (tfa.flash_grid(1, 4, 3, S, D, 132)
                    == tfa.flash_grid(1, 4, 3, S, D, 132, torch.float32))


MASKS = [(True, 0, 0), (False, 0, 0), (True, 5, 0), (False, 7, 0), (True, 0, 9),
         (True, 4, 9), (True, 0, 300)]


@pytest.mark.parametrize("causal,window,prefix", MASKS)
@pytest.mark.parametrize("D", (64, 256))
def test_tc_key_splits_cover_every_allowed_key_once(causal, window, prefix, D):
    block, keys = tfa.TC_CONFIGS[tfa.tc_head_class(D)]
    for G in (1, 3):
        for S, T in ((1, 1), (5, 5), (33, 33), (70, 70), (65, 130), (20, 90),
                     (90, 20)):
            if causal and T < S:
                continue            # causal rows count positions from 0
            R = G * S
            for r0 in range(0, R, block):
                t0, t1 = tfa.flash_key_range(r0, block, keys, G, S, T, causal,
                                             window, prefix)
                assert t0 % keys == 0
                tiles = -(-(t1 - t0) // keys) if t1 > t0 else 0
                for n_split in (1, 2, 4, 8):
                    hit = np.zeros(max(T, t1) + keys, int)
                    for split in range(n_split):
                        lo, hi = tfa.tc_split_range(tiles, n_split, split)
                        hit[t0 + lo * keys:min(t1, t0 + hi * keys)] += 1
                    assert (hit[t0:t1] == 1).all()
                    assert hit.sum() == max(0, t1 - t0)
                for rr in range(r0, min(r0 + block, R)):
                    s = rr // G
                    for t in range(T):
                        if _allowed(s, t, T, causal, window, prefix):
                            assert t0 <= t < t1, (G, S, T, rr, t)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 200, 512, 1500, 2048, 8192, 32768])
@pytest.mark.parametrize("B,K,G", [(4, 1, 16), (4, 8, 4), (1, 8, 2), (2, 12, 1),
                                   (34, 8, 2), (3, 2, 4)])
def test_tc_decode_splits_cover_the_cache_once(T, B, K, G):
    n = tda.plan_splits(T, B, K, 132, G, BF16)
    assert 1 <= n <= min(tda.MAX_SPLITS, T, -(-T // tda.TC_KEYS),
                         max(1, math.isqrt(T // G)))
    assert n <= max(1, -(-tda.CTAS_PER_SM * 132 // (B * K)))
    for kv_len in {1, T // 2 + 1, T, T + 5}:
        for window in (0, 7):
            lo_all = max(0, kv_len - window) if window else 0
            hi_all = min(kv_len, T)
            hit = np.zeros(T + 1, int)
            for split in range(n):
                lo, hi = tda.split_range(kv_len, T, window, n, split)
                hit[lo:hi] += 1
            assert (hit[lo_all:hi_all] == 1).all() and hit.sum() == hi_all - lo_all


def test_f32_decode_plan_is_unchanged():
    for T in (1, 64, 512, 4096):
        for B, K in ((8, 4), (1, 1), (34, 8)):
            assert (tda.plan_splits(T, B, K, 132)
                    == tda.plan_splits(T, B, K, 132, 16, torch.float32))


# ---------------------------------------------------------------------------
# the rounding budget: CPU models of the kernels' arithmetic
# ---------------------------------------------------------------------------

def _online(state, sc, vt, round_p=True):
    """One key tile of the online softmax in base 2: sc (rows, keys) scores
    in log2 units (-inf where masked), vt (keys, D) f32 values; P rounded
    to bf16 before P.V (unless `round_p` is False), l from the unrounded
    p."""
    m, l, acc = state
    m_new = torch.maximum(m, sc.amax(-1))
    corr = torch.exp2(m - m_new)
    p = torch.exp2(sc - m_new[:, None])
    pv = p.to(BF16).float() if round_p else p
    return m_new, l * corr + p.sum(-1), acc * corr[:, None] + pv @ vt


def _merge(parts):
    """Partial (m, l, acc) states merged as the kernels merge them: weights
    2^(m - M), 0 for a part with no allowed key -> (M, L, A)."""
    m = torch.stack([p[0] for p in parts])
    l = torch.stack([p[1] for p in parts])
    M = torch.where(l > 0, m, torch.full_like(m, NEG)).amax(0)
    w = torch.where(l > 0, torch.exp2(m - M), torch.zeros_like(m))
    return M, (l * w).sum(0), sum(p[2] * w[i][:, None] for i, p in enumerate(parts))


def _finish(M, L, A):
    """(output, lse in base e) of a merged state: A / max(L, 1e-37), and
    -inf for a row with no allowed key."""
    lse = torch.where(L > 0, (M + torch.log2(L)) / LOG2E,
                      torch.full_like(M, float("-inf")))
    return A / L.clamp_min(1e-37)[:, None], lse


def tc_flash_model(q, k, v, *, causal=True, window=0, prefix_len=0,
                   sms=132, round_p=True, out_dtype=BF16):
    """K6's bf16 arithmetic: row blocks and key tiles as `flash_grid` lays
    them out (a narrow block's keys split and combined)."""
    B, K, G, S, D = q.shape
    T = k.shape[2]
    sl2 = D ** -0.5 * LOG2E
    narrow, rows, keys, _ = tfa.flash_grid(B, K, G, S, D, sms, BF16)
    block = tfa.TC_CONFIGS[tfa.tc_head_class(D)][0]
    n_split = block // rows
    prefixes = (prefix_len.tolist() if isinstance(prefix_len, torch.Tensor)
                else [prefix_len] * B)
    out = torch.zeros(B, K, G, S, D)
    for b in range(B):
        P = prefixes[b]
        for kh in range(K):
            for r0 in range(0, G * S, block):
                rr = torch.arange(r0, min(r0 + block, G * S))
                s_pos, g = rr // G, rr % G
                Q = q[b, kh, g, s_pos].float()
                t0, t1 = tfa.flash_key_range(r0, block, keys, G, S, T, causal,
                                             window, P)
                tiles = -(-(t1 - t0) // keys) if t1 > t0 else 0
                parts = []
                for split in range(n_split):
                    lo, hi = tfa.tc_split_range(tiles, n_split, split)
                    state = (torch.full((len(rr),), NEG), torch.zeros(len(rr)),
                             torch.zeros(len(rr), D))
                    for i in range(lo, hi):
                        ta, tb = t0 + i * keys, min(t0 + (i + 1) * keys, T)
                        t = torch.arange(ta, tb)
                        sc = Q @ k[b, kh, ta:tb].float().T * sl2
                        ok = torch.ones_like(sc, dtype=torch.bool)
                        if causal:
                            ok &= (t[None] <= s_pos[:, None]) | (t[None] < P)
                        if window > 0:
                            ok &= t[None] > s_pos[:, None] - window
                        sc = torch.where(ok, sc, float("-inf"))
                        state = _online(state, sc, v[b, kh, ta:tb].float(),
                                        round_p)
                    parts.append(state)
                out[b, kh, g, s_pos] = _finish(*_merge(parts))[0]
    return out.to(out_dtype)


def tc_decode_model(q, k, v, kv_len, *, window=0, slot_pos=None,
                    k_scale=None, v_scale=None, sms=132):
    """K5's bf16 arithmetic: splits as `plan_splits` / `split_range` cut
    them, 64-row tiles whose 16-row quarters each warp scores into its own
    state, the warps combined, then the splits; -> (output, lse)."""
    B, K, G, D = q.shape
    T = k.shape[2]
    if k_scale is not None:
        k = tda.dequantize(k, k_scale, BF16)
        v = tda.dequantize(v, v_scale, BF16)
    sl2 = D ** -0.5 * LOG2E
    n_split = tda.plan_splits(T, B, K, sms, G, BF16)
    out = torch.zeros(B, K, G, D)
    lse = torch.zeros(B, K, G)
    for b in range(B):
        kl = int(kv_len[b])
        for kh in range(K):
            Q = q[b, kh].float()
            splits = []
            for split in range(n_split):
                lo, hi = (tda.split_range(T, T, 0, n_split, split)
                          if slot_pos is not None
                          else tda.split_range(kl, T, window, n_split, split))
                warps = [(torch.full((G,), NEG), torch.zeros(G),
                          torch.zeros(G, D)) for _ in range(4)]
                for r0 in range(lo, hi, tda.TC_KEYS):
                    for w in range(4):
                        ta, tb = r0 + 16 * w, min(r0 + 16 * w + 16, hi)
                        if ta >= tb:
                            continue
                        sc = Q @ k[b, kh, ta:tb].float().T * sl2
                        if slot_pos is not None:
                            sp = slot_pos[b, ta:tb]
                            ok = (sp >= 0) & (sp <= kl - 1)
                            if window > 0:
                                ok &= sp > kl - 1 - window
                            sc = torch.where(ok[None], sc, float("-inf"))
                        warps[w] = _online(warps[w], sc,
                                           v[b, kh, ta:tb].float())
                splits.append(_merge(warps))    # the split's (M, L, acc)
            out[b, kh], lse[b, kh] = _finish(*_merge(splits))
    return out.to(BF16), lse


def _gate(got, want, v):
    tol = GATE * max(1.0, float(v.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)
    return err


# the zoo's K6 heads: MLA's decompressed prefill (G 1, D 192), whisper's
# cross-attention (D 64, S != T) and encoder, phi3.5 (G 4, D 128),
# paligemma (G 8, D 256, its image prefix), internlm2 (G 2, D 128) and
# MLA's absorbed latent (D 576), at small S and T
FLASH_CASES = [
    dict(B=1, K=4, G=1, S=40, T=40, D=192, causal=True),
    dict(B=2, K=3, G=1, S=16, T=150, D=64, causal=False),
    dict(B=1, K=2, G=1, S=70, T=70, D=64, causal=False),
    dict(B=1, K=2, G=4, S=50, T=50, D=128, causal=True, window=20),
    dict(B=1, K=2, G=2, S=90, T=90, D=128, causal=True),
    dict(B=1, K=1, G=8, S=40, T=40, D=256, causal=True, prefix_len=24),
    dict(B=2, K=1, G=8, S=24, T=24, D=256, causal=True, prefix_len=[16, 3]),
    dict(B=1, K=1, G=8, S=20, T=20, D=576, causal=True),
    dict(B=1, K=2, G=3, S=33, T=33, D=50, causal=True),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items() if k not in ("B", "causal")))
@pytest.mark.parametrize("sms", [1, 100_000])
def test_tc_flash_rounding_within_the_gate(case, sms):
    case = dict(case)
    B, K, G, S, T, D = (case.pop(n) for n in ("B", "K", "G", "S", "T", "D"))
    rng = np.random.default_rng(11 + D + S)
    q, k, v = (_rand(rng, (B, K, G, S, D)), _rand(rng, (B, K, T, D)),
               _rand(rng, (B, K, T, D)))
    prefix = case.pop("prefix_len", 0)
    causal, window = case["causal"], case.get("window", 0)
    if isinstance(prefix, list):
        prefix = torch.tensor(prefix, dtype=torch.int32)
    got = tc_flash_model(q, k, v, causal=causal, window=window,
                         prefix_len=prefix, sms=sms)
    if isinstance(prefix, torch.Tensor) or prefix:
        want = tfa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       prefix_len=prefix)
    else:
        want = torch.from_numpy(np.asarray(jref.flash_attention_ref(
            _jax(q), _jax(k), _jax(v), causal=causal, window=window),
            np.float32))
    _gate(got, want, v)


# the zoo's K5 heads: phi3.5 (G 4, D 128; its int8 cache), recurrentgemma
# on its ring (G 16, D 256), internlm2's long-context ring (G 2, D 128),
# whisper's cross decode (G 1, D 64)
DECODE_CASES = [
    dict(B=2, K=2, G=4, T=300, D=128, lens=[300, 77]),
    dict(B=2, K=2, G=4, T=300, D=128, lens=[300, 150], window=40),
    dict(B=2, K=1, G=16, T=256, D=256, lens=[400, 90], ring=True, window=256),
    dict(B=1, K=2, G=2, T=512, D=128, lens=[1000], ring=True, window=512),
    dict(B=2, K=3, G=1, T=150, D=64, lens=[150, 150]),
    dict(B=2, K=2, G=4, T=200, D=128, lens=[200, 5], int8=True),
    dict(B=1, K=1, G=8, T=130, D=50, lens=[130]),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items() if k not in ("B", "lens")))
@pytest.mark.parametrize("sms", [1, 132])
def test_tc_decode_rounding_within_the_gate(case, sms):
    case = dict(case)
    B, K, G, T, D = (case.pop(n) for n in ("B", "K", "G", "T", "D"))
    lens, window = case.pop("lens"), case.pop("window", 0)
    rng = np.random.default_rng(7 + D + T)
    q = _rand(rng, (B, K, G, D))
    kv_len = torch.tensor(lens, dtype=torch.int32)
    kw = {"window": window}
    if case.get("int8"):
        codes = rng.integers(-127, 128, (2, B, K, T, D)).astype(np.int8)
        k, v = torch.from_numpy(codes[0]), torch.from_numpy(codes[1])
        kw["k_scale"], kw["v_scale"] = (
            torch.from_numpy(rng.uniform(1e-3, 0.05, (B, K, T)).astype(np.float32))
            for _ in range(2))
        vals = tda.dequantize(v, kw["v_scale"], BF16)
    else:
        k, v = _rand(rng, (B, K, T, D)), _rand(rng, (B, K, T, D))
        vals = v
    if case.get("ring"):
        i = torch.arange(T)[None]
        qp = kv_len[:, None].long() - 1
        pos = qp - ((qp - i) % T)
        kw["slot_pos"] = torch.where(pos >= 0, pos, -1).to(torch.int32)
    got, lse = tc_decode_model(q, k, v, kv_len, sms=sms, **kw)
    want, lse_w = tda.decode_attention_ref(q, k, v, kv_len, return_lse=True,
                                           **kw)
    if not case:        # a full bf16 cache: the JAX reference's own oracle
        want = torch.from_numpy(np.asarray(jref.decode_attention_ref(
            _jax(q), _jax(k), _jax(v), jnp.asarray(kv_len.numpy()),
            window=window), np.float32))
    _gate(got, want, vals)
    np.testing.assert_allclose(lse.numpy(), lse_w.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_the_model_rounds_p_where_the_kernel_does():
    """The budget is the rounding of P: with P kept in f32 the model (in
    f32, before the output's own rounding) is at the reference's f32
    summation-order noise, with P in bf16 an order of magnitude further,
    and that inside the gate: the gate checks the rounding the kernel
    adds."""
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, (1, 2, 4, 64, 128)), _rand(rng, (1, 2, 64, 128)),
               _rand(rng, (1, 2, 64, 128)))
    want = jref.flash_attention_ref(_jax(q).astype(jnp.float32),
                                    _jax(k).astype(jnp.float32),
                                    _jax(v).astype(jnp.float32), causal=True)
    want = torch.from_numpy(np.array(want, np.float32))
    errs = {}
    for round_p in (True, False):
        got = tc_flash_model(q, k, v, round_p=round_p, out_dtype=torch.float32)
        errs[round_p] = float((got - want).abs().max())
    assert errs[False] < 1e-5
    assert 10 * errs[False] < errs[True] <= GATE * float(v.float().abs().max())
