"""Context-parallel decode on the port (M7c): K5's log-sum-exp output, the
combine of per-shard partial attention, and long_500k decode on meshes
whose `long_context_rules` shard the cache's sequence over `data`.

  * K5's plain version with `return_lse` against the reference's oracle
    (`repro.kernels.ref.decode_attention_ref`) and the log-sum-exp of the
    reference's masked f32 scores, rtol 1e-5;
  * `combine_partials` over R in {1, 2, 4, 7} shards of consecutive cache
    rows (a full cache's shard called at kv_len - its first row, a ring's
    slots as they are) equal to one whole call, on full, windowed, ring and
    int8 caches, with shards wholly past kv_len (output 0, lse -inf) and
    kv_len = 1; a row no shard allows stays 0 / -inf, never NaN;
  * 4 gloo ranks (tests/torch_mesh_worker.py, its "context" part, spawned
    once for the module; a FileStore under tmp_path, no TCP port), meshes
    (4, 1) and (2, 2): every family with long context at long_500k cut to
    T = 256 positions (the windowed archs' ring, and recurrentgemma's local
    attention, to 64 slots), batch 1,
    after a one-device prefill of 72 tokens — three decode steps' logits
    equal to the one-device port's and to the reference's
    `Model.decode_step` on the same weights, carried across with
    `params_to_numpy`; and each step's attention calls all-gather fewer
    bytes than one rank's shard of the attention caches (the combine
    gathers each layer's (R, B, 1, H, D) outputs and log-sum-exps, never
    the cache; weights that a step gathers elsewhere are not counted).

Tolerances: logits 1e-4 of their largest |value|, as
test_torch_distribution.py (the ranks' softmax sums add in other orders);
f32 attention outputs 1e-6 absolute (values of order 1).
"""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.models.model_api import Model as JModel
from repro_torch.kernels import decode_attention as da
from repro_torch.models.model_api import Model, params_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_mesh_worker as W  # noqa: E402

LOGIT_TOL = 1e-4
LSE_RTOL = 1e-5
OUT_ATOL = 1e-6
B, K, G, T, D = 4, 2, 3, 40, 16
SPLITS = (1, 2, 4, 7)


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, K, G, D)).astype(np.float32),
            rng.standard_normal((B, K, T, D)).astype(np.float32),
            rng.standard_normal((B, K, T, D)).astype(np.float32))


@pytest.mark.parametrize("window", [0, 6])
def test_plain_lse_matches_the_reference_scores(window):
    q, k, v = _qkv(3)
    kv_len = np.array([1, 9, 23, 40], np.int32)
    out, lse = da.decode_attention_ref(
        *map(torch.from_numpy, (q, k, v, kv_len)), window=window,
        return_lse=True)
    want = jref.decode_attention_ref(*map(jnp.asarray, (q, k, v, kv_len)),
                                     window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=OUT_ATOL)
    # the reference's masked f32 scores, as its oracle builds them
    s = jnp.einsum("bkgd,bktd->bkgt", q, k) * D ** -0.5
    pos = jnp.arange(T)[None, None, None, :]
    kl = jnp.asarray(kv_len)[:, None, None, None]
    ok = pos < kl
    if window:
        ok = ok & (pos > kl - 1 - window)
    want_lse = jax.nn.logsumexp(jnp.where(ok, s, -jnp.inf), axis=-1)
    assert lse.shape == (B, K, G) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=LSE_RTOL)


def _cache(kind, seed):
    """(q, k, v, kv_len, kwargs) of a `kind` cache: "full" and "windowed"
    (window 7) at kv_len [1, 13, 27, 40]; "ring" (T slots, window T, the
    queries past the ring's first lap, a few slots empty); "int8" codes
    with their scales."""
    q, k, v = map(torch.from_numpy, _qkv(seed))
    kw = {}
    if kind == "ring":
        q_pos = torch.tensor([3, 45, 77, 130])
        i = torch.arange(T)[None, :]
        sp = q_pos[:, None] - ((q_pos[:, None] - i) % T)
        sp = torch.where(sp >= 0, sp, -1)
        sp[2, 5] = -1                                    # an empty slot
        kw = {"slot_pos": sp.to(torch.int32), "window": T}
        return q, k, v, (q_pos + 1).to(torch.int32), kw
    if kind == "windowed":
        kw["window"] = 7
    if kind == "int8":
        rng = np.random.default_rng(seed + 1)
        k = torch.from_numpy(rng.integers(-127, 128, (B, K, T, D))
                             .astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, (B, K, T, D))
                             .astype(np.int8))
        kw["k_scale"] = torch.from_numpy(
            (rng.random((B, K, T)) * 0.02 + 1e-3).astype(np.float32))
        kw["v_scale"] = torch.from_numpy(
            (rng.random((B, K, T)) * 0.02 + 1e-3).astype(np.float32))
    return q, k, v, torch.tensor([1, 13, 27, 40], dtype=torch.int32), kw


@pytest.mark.parametrize("R", SPLITS)
@pytest.mark.parametrize("kind", ["full", "windowed", "ring", "int8"])
def test_combined_shards_equal_one_whole_call(kind, R):
    q, k, v, kv_len, kw = _cache(kind, 5)
    whole, whole_lse = da.decode_attention(q, k, v, kv_len, return_lse=True,
                                           **kw)
    assert torch.isfinite(whole_lse).all()
    outs, lses, past = [], [], []
    for r in range(R):
        a, b = T * r // R, T * (r + 1) // R
        part = {n: (x[..., a:b] if n in ("k_scale", "v_scale", "slot_pos")
                    else x) for n, x in kw.items()}
        o, lse = da.decode_attention(
            q, k[:, :, a:b], v[:, :, a:b],
            kv_len if kind == "ring" else kv_len - a, return_lse=True,
            **part)
        outs.append(o)
        lses.append(lse)
        if kind != "ring":
            past += [(r, i) for i in range(B) if int(kv_len[i]) <= a]
    if R > 1 and kind != "ring":
        assert past                      # kv_len = 1 leaves shards empty
    for r, i in past:
        assert not outs[r][i].any()
        assert (lses[r][i] == float("-inf")).all()
    out, lse = da.combine_partials(torch.stack(outs), torch.stack(lses))
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    np.testing.assert_allclose(out.numpy(), whole.numpy(), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), whole_lse.numpy(),
                               rtol=LSE_RTOL)


@pytest.mark.parametrize("kv_len", [-70, -1, 0, 1, 39, 40, 41, 45, 90])
@pytest.mark.parametrize("window", [0, 7])
def test_split_range_cuts_a_shards_local_kv_len(kv_len, window):
    # a shard's local kv_len (kv_len - its first row) may be <= 0 or past
    # its T rows: the splits (the kernel's `split_range` has the same
    # arithmetic) still tile exactly the allowed rows inside [0, T)
    allowed = [t for t in range(T) if t < kv_len
               and (window == 0 or t > kv_len - 1 - window)]
    for n_split in (1, 3, 32):
        rows = []
        for split in range(n_split):
            lo, hi = da.split_range(kv_len, T, window, n_split, split)
            rows += range(lo, hi)
        assert rows == allowed, (n_split, rows)


def test_a_row_no_shard_allows_stays_zero():
    q, k, v, _, _ = _cache("full", 7)
    kv_len = torch.tensor([0, 5, 0, 40], dtype=torch.int32)
    whole, whole_lse = da.decode_attention(q, k, v, kv_len, return_lse=True)
    halves = [da.decode_attention(q, k[:, :, a:a + T // 2],
                                  v[:, :, a:a + T // 2], kv_len - a,
                                  return_lse=True) for a in (0, T // 2)]
    out, lse = da.combine_partials(torch.stack([h[0] for h in halves]),
                                   torch.stack([h[1] for h in halves]))
    for got, got_lse in ((whole, whole_lse), (out, lse)):
        assert not got[[0, 2]].any() and not torch.isnan(got).any()
        assert (got_lse[[0, 2]] == float("-inf")).all()
    np.testing.assert_allclose(out.numpy(), whole.numpy(), atol=OUT_ATOL)


# -- long_500k on 4 gloo ranks ------------------------------------------------

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return W.results(tmp_path_factory.mktemp("ctx"), "context",
                     timeout=150.0)


@functools.lru_cache(maxsize=None)
def _one_device(name):
    """The one-device port's and the reference's logits of the worker's
    steps, on the same weights."""
    cfg = W.long_config(name)
    model = Model(cfg)
    params = W.family_params(model)
    window = cfg.long_context_window or None
    P, caches = W.long_prefill(cfg, model, params)
    port = []
    with torch.no_grad():
        for t in range(W.LONG_STEPS):
            tok, pos = W.long_step_inputs(P, t)
            lg, caches = model.decode_step(params, tok, caches, pos,
                                           window_override=window)
            port.append(lg)
    _, arch, over = next(f for f in W.FAMILIES if f[0] == name)
    jcfg = W.long_window(dataclasses.replace(
        jget_config(arch).reduced(layers=3 if "gemma" in arch else 2,
                                  d_model=64), **over))
    jmodel = JModel(jcfg)
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(cfg, params))
    batch = {k: jnp.asarray(v.numpy()) for k, v in
             W.family_batch(cfg, rows=1, seq=W.LONG_S).items()}
    _, jcaches = jmodel.prefill(jparams, batch, window_override=window)
    jcaches = jmodel.prepare_decode_caches(jcaches, P, W.LONG_T,
                                           window_override=window)
    ref = []
    for t in range(W.LONG_STEPS):
        tok, pos = W.long_step_inputs(P, t)
        lg, jcaches = jmodel.decode_step(jparams, jnp.asarray(tok.numpy()),
                                         jcaches, jnp.asarray(pos.numpy()),
                                         window_override=window)
        ref.append(torch.from_numpy(np.array(lg, np.float32)))
    return port, ref


def _close(got, want, what):
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= LOGIT_TOL * scale, (what, err, scale)


MESHES = [f"{d}x{m}" for d, m in W.LONG_MESHES]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", W.LONG_FAMILIES)
def test_long_500k_decode_equals_one_device_and_the_reference(results, name,
                                                              mesh):
    got = results[f"long_{name}_{mesh}"]["logits"]
    port, ref = _one_device(name)
    assert len(got) == len(port) == W.LONG_STEPS
    for i, (g, p, r) in enumerate(zip(got, port, ref)):
        _close(g, p, (name, mesh, i, "one device"))
        _close(g, r, (name, mesh, i, "reference"))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", W.LONG_FAMILIES)
def test_long_500k_step_gathers_less_than_a_cache_shard(results, name, mesh):
    r = results[f"long_{name}_{mesh}"]
    if r["shard_bytes"] is None:             # fixed-size recurrent states
        assert name == "mamba2" and not r["placements"]
        return
    # the caches' sequence (dim 1) shards over `data`, the mesh's first dim
    assert all(p.startswith("(Shard(dim=1)") for p in r["placements"]), r
    assert all(0 < g < r["shard_bytes"]
               for g in r["attention_gather_bytes"]), r
