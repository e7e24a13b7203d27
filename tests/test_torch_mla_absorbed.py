"""MLA's absorbed form in train and prefill (`mla_absorbed_train`) on the
port against the reference's (pure-JAX `attend` over the latent), on the
CPU: W_UK folded into q, attention against the latent through K6 (one kv
head, q/k width kv_lora_rank + qk_rope_head_dim — 576 at deepseek's full
width, K6's new instance — v zero-padded to that width), then W_UV.

The reduced deepseek (`.reduced(layers=2, d_model=64)`, latent 32 + rope
16: width 48) carries the reference's weights across with
`params_from_numpy`; inputs are numpy-seeded.  Held to f32 rtol 1e-5 on
outputs (the layer's, the prefill's logits and latent caches) and 1e-4 of
each leaf's scale on gradients (max(its largest |g|, 1e-2 x the tree's
largest), test_torch_train_zoo's floor).  K6's plain version at D = 576
(the full-width instance's shape, G = 16 here) against the reference's
oracle, and `FlashAttentionFn`'s backward at D = 576 against autograd
through the plain version.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.models.layers import mla as jmla
from repro.models.model_api import Model as JModel
from repro_torch.checkpoint.io import _flatten
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models.layers import mla as tmla
from repro_torch.models.model_api import (Model, params_from_numpy,
                                          params_to_numpy)
from repro_torch.training.train_loop import loss_and_grads

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _absorbed(cfg):
    return dataclasses.replace(cfg.reduced(layers=2, d_model=64),
                               mla_absorbed_train=True)


@functools.lru_cache(maxsize=None)
def setup():
    jcfg = _absorbed(jget_config("deepseek-v3-671b"))
    cfg = _absorbed(get_config("deepseek-v3-671b"))
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, cfg, jparams, params


def np_batch(cfg, B=2, S=24, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(4, cfg.vocab_size, (B, S)).astype(
        np.int32)}


def _close(t, j, tol=OUT_TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _layer_inputs(cfg, B=2, S=20, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return x, pos


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_layer_forward_equals_the_reference(mode):
    jcfg, cfg, jparams, params = setup()
    jp = jparams["segments"][0][0]["attn"]
    tp = params["layers"][0]["attn"]
    x, pos = _layer_inputs(cfg)
    jout, jcache = jax.jit(lambda p, xx: jmla.apply(
        p, jcfg, xx, positions=jnp.asarray(pos), mode=mode,
        return_cache=mode == "prefill"))(jp, jnp.asarray(x))
    tout, tcache = tmla.apply(tp, cfg, torch.from_numpy(x),
                              positions=torch.from_numpy(pos), mode=mode,
                              return_cache=mode == "prefill")
    _close(tout, jout)
    if mode == "prefill":
        for name in ("ckv", "k_rope"):
            _close(tcache[name], jcache[name])


def test_layer_gradients_equal_the_reference():
    jcfg, cfg, jparams, params = setup()
    jp = jparams["segments"][0][0]["attn"]
    tp = params["layers"][0]["attn"]
    x, pos = _layer_inputs(cfg)
    w = np.random.default_rng(9).standard_normal(
        (x.shape[0], x.shape[1], cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        out, _ = jmla.apply(p, jcfg, xx, positions=jnp.asarray(pos))
        return jnp.sum(out * jnp.asarray(w))

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = tmla.apply(leaves, cfg, xt, positions=torch.from_numpy(pos))
    (out * torch.from_numpy(w)).sum().backward()
    top = max(float(np.abs(np.asarray(v)).max()) for v in jg.values())
    for name, t in leaves.items():
        want = np.asarray(jg[name])
        scale = max(float(np.abs(want).max()), 1e-2 * top)
        err = float(np.abs(t.grad.numpy() - want).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)
    scale = float(np.abs(np.asarray(jgx)).max())
    assert float(np.abs(xt.grad.numpy() - np.asarray(jgx)).max()) <= \
        GRAD_TOL * scale


def test_prefill_logits_and_caches_equal_the_reference():
    jcfg, cfg, jparams, params = setup()
    batch = np_batch(cfg)
    jlogits, jcaches = jax.jit(JModel(jcfg).prefill)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        logits, caches = Model(cfg).prefill(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(logits, jlogits)
    ref_caches = [c for seg in jcaches for c in _unstack(seg)]
    for tc, jc in zip(caches, ref_caches):
        for name in ("ckv", "k_rope"):
            _close(tc[name], jc[name])


def _unstack(seg):
    """A reference cache segment as one dict per layer."""
    blk = seg[0]
    first = next(iter(blk.values()))
    if len(seg) == 1 and np.asarray(first).ndim == 3:
        return [blk]
    n = np.asarray(first).shape[0]
    return [{k: np.asarray(v)[r] for k, v in blk.items()} for r in range(n)]


def test_train_loss_and_gradients_equal_the_reference():
    jcfg, cfg, jparams, params = setup()
    batch = np_batch(cfg)
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        JModel(jcfg).train_loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    metrics, grads = loss_and_grads(
        Model(cfg), params, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key, value in metrics.items():
        np.testing.assert_allclose(float(value), float(jmetrics[key]),
                                   rtol=OUT_TOL, atol=OUT_TOL, err_msg=key)
    got = _flatten(params_to_numpy(cfg, grads))
    want = _flatten(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-2 * top)
        err = float(np.abs(got[key] - w).max())
        assert err <= GRAD_TOL * scale, (key, err, scale)


def test_absorbed_equals_the_decompressed_form():
    _, cfg, _, params = setup()
    tokens = torch.from_numpy(np_batch(cfg)["tokens"])
    plain = Model(dataclasses.replace(cfg, mla_absorbed_train=False))
    with torch.no_grad():
        a = Model(cfg)(params, {"tokens": tokens})
        b = plain(params, {"tokens": tokens})
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_k6_takes_the_absorbed_width():
    assert tfa.MAX_HEAD_DIM == 576 and tfa.padded_head_dim(576) == 576
    assert tfa.padded_head_dim(257) == 576
    assert tfa.FLASH_CONFIGS[576] == {False: (16, 16), True: (8, 16)}
    # deepseek's full-width prefill: G = 128 latent-sharing heads, 8 rows a
    # narrow CTA; the grid stays under 2^31 CTAs
    narrow, rows, keys, ctas = tfa.flash_grid(32, 1, 128, 32768, 576, 132)
    assert not narrow and rows == 16 and ctas < 2 ** 31
    from repro_torch.kernels import decode_attention as tda
    assert tda.MAX_HEAD_DIM == 256


@pytest.mark.parametrize("causal", [True, False])
def test_k6_plain_version_at_576_equals_the_reference_oracle(causal):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((1, 1, 16, 24, 576)).astype(np.float32)
    k = rng.standard_normal((1, 1, 24, 576)).astype(np.float32)
    v = rng.standard_normal((1, 1, 24, 576)).astype(np.float32)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_k6_gradient_at_576_equals_autograd_through_the_plain_version():
    gen = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn(s, generator=gen) for s in
               ((1, 1, 8, 40, 576), (1, 1, 40, 576), (1, 1, 40, 576)))
    w = torch.randn((1, 1, 8, 40, 576), generator=gen)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves, causal=True, scale=576 ** -0.5) * w).sum().backward()
        return [t.grad for t in leaves]

    got = grads(tfa.flash_attention)
    want = grads(tfa.flash_attention_ref)
    for g, r in zip(got, want):
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())
