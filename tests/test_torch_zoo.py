"""The rest of the model zoo on the port against the JAX package on the CPU:
every assigned architecture at reduced size (`.reduced(layers=2,
d_model=64)`, three layers for the hybrid's period; f32), the same weights carried across with
`params_from_numpy` and the same numpy-seeded inputs (tokens, stub image
patches, stub audio frames).  Per arch: the parameter tree, prefill logits
and decode caches, two decode steps and their caches against the JAX
model; prefill + decode against the port's own full forward and the
reference's.  Then the reference's consistency gates
(tests/test_decode_consistency.py, tests/test_perf_variants.py) ported:
multistep decode, the ring cache against the full cache under a window,
the int8 cache near the f32 one and equal to the reference's int8 decode,
MoE local dispatch against global; and each new mixer by name (MoE routing
ties, MLA, SSD, RG-LRU, prefix, cross-attention).  M7's pieces raise.

Logits (of order 1) and caches agree to TOL = 1e-4, as
test_torch_models.py: the same f32 weights and inputs, with matmul, scan
and softmax summation orders that differ between the two frameworks.
Consistency gates against the port's own full forward keep the
reference tests' 2e-3 / 3e-3 (other matmul shapes and orders)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro.models.config import plan_segments
from repro.models.layers import embedding as jembedding
from repro.models.layers import mla as jmla
from repro.models.layers import moe as jmoe
from repro.models.layers import rglru as jrglru
from repro.models.layers import ssm as jssm
from repro.models.model_api import Model as JModel
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.models.layers import mla, moe, rglru, ssm
from repro_torch.models.model_api import Model, params_from_numpy

TOL = 1e-4
S = 12


def _reduce(cfg, **kw):
    """Two layers of width 64; recurrentgemma keeps three, its whole
    (rglru, rglru, local attention) period, so the ring cache is there."""
    layers = 3 if cfg.hybrid_period else 2
    cfg = cfg.reduced(layers=layers, d_model=64)
    return dataclasses.replace(cfg, **kw) if kw else cfg


@functools.lru_cache(maxsize=None)
def _setup(arch, **kw):
    """(jcfg, cfg, jmodel, jparams, model, params) at reduced size."""
    kw = dict(kw)
    jcfg, cfg = _reduce(jget_config(arch), **kw), _reduce(get_config(arch),
                                                         **kw)
    jmodel = JModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = Model(cfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, cfg, jmodel, jparams, model, params


def _inputs(cfg, n_tok, seed=1, B=2):
    """numpy batch: tokens (B, n_tok), plus stub images / audio."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(4, cfg.vocab_size, (B, n_tok)).astype(
        np.int32)}
    if cfg.num_image_tokens:
        batch["images"] = rng.standard_normal(
            (B, cfg.num_image_tokens, 1152)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["audio"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _ref_layers(jcfg, segments):
    """The reference's segment-structured tree (caches or parameters) as
    one dict per layer in layer order (the port's layout)."""
    out = []
    for seg, (period, repeats) in zip(segments, plan_segments(
            jcfg.layer_kinds())):
        for r in range(repeats):
            for b_i in range(len(period)):
                out.append(None if seg[b_i] is None else jax.tree.map(
                    lambda a: np.asarray(a[r] if repeats > 1 else a),
                    seg[b_i]))
    return out


def _drop_free(arch):
    """The reference consistency tests' MoE setting: capacity_factor 8, so
    no token is dropped (a prefill of S and a full forward of S + 1 tokens
    would otherwise drop different tokens)."""
    moe_cfg = get_config(arch).reduced(layers=2, d_model=64).moe
    if not get_config(arch).use_moe:
        return {}
    return {"moe": dataclasses.replace(moe_cfg, capacity_factor=8.0)}


def _close_caches(tcaches, jcfg, jcaches, tol=TOL):
    ref = _ref_layers(jcfg, jcaches)
    assert len(tcaches) == len(ref)
    for i, (tc, jc) in enumerate(zip(tcaches, ref)):
        assert set(tc) == set(jc), (i, set(tc), set(jc))
        for name in tc:
            assert tuple(tc[name].shape) == jc[name].shape, (i, name)
            if tc[name].dtype in (torch.int8, torch.int32):
                # int8 codes: f32 inputs ~1e-6 apart may round to
                # neighbouring codes at a .5 boundary
                d = np.abs(tc[name].numpy().astype(np.int64)
                           - jc[name].astype(np.int64))
                assert d.max() <= (1 if tc[name].dtype == torch.int8 else 0)
            else:
                # entries reach ~10 (whisper's biased cross k/v): TOL
                # relative to the tensor's largest entry
                _close(tc[name], jc[name],
                       tol * max(1.0, float(np.abs(jc[name]).max())))


def _ref_full_logits(jcfg, jmodel, jparams, batch):
    """The reference test's `_full_logits`, every position."""
    x, pos, pl, enc, encp = jmodel._embed_inputs(jparams, batch)
    h, _, _ = jtransformer.decoder_apply(
        jparams, jcfg, x, mode="train", positions=pos,
        mask_kind="prefix" if pl else "causal", prefix_len=pl,
        enc_out=enc, enc_positions=encp,
        use_rope=not jcfg.is_encoder_decoder, remat=False)
    return embedding_logits(jparams, jcfg, h)


def embedding_logits(jparams, jcfg, h):
    return np.asarray(jembedding.logits(jparams["embed"], jcfg, h))


# ---------------------------------------------------------------------------
# Every arch against the reference
# ---------------------------------------------------------------------------

def test_assigned_archs_are_the_reference_list():
    assert tuple(ASSIGNED_ARCHS) == tuple(J_ASSIGNED)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_full_config_constructs(arch):
    """Model(get_config(arch)) at full size: specs only, nothing
    allocated; its parameter count is the config's analytic one wherever
    the reference's specs and count agree."""
    model = Model(get_config(arch))
    jspecs = JModel(jget_config(arch)).param_specs()
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jspecs, is_leaf=lambda x: hasattr(x, "shape")))
    specs = model.param_specs()
    m = 0
    stack = [specs]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        else:
            m += int(np.prod(x.shape))
    assert m == n


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_tree_shapes_match_the_reference(arch):
    """params_from_numpy unstacks every segment (multi-segment plans too)
    into layer order; init_params gives the same shapes and init laws'
    dtypes; the encoder, img_proj and mtp subtrees come across."""
    jcfg, cfg, _, jparams, model, params = _setup(arch)
    init = model.init_params(torch.Generator().manual_seed(0))
    ref = jax.tree.map(np.asarray, jparams)
    flat = _ref_layers(jcfg, ref["segments"])
    for tree in (params, init):
        assert len(tree["layers"]) == cfg.num_layers
        for i, blk in enumerate(tree["layers"]):
            got = jax.tree.map(lambda a: tuple(a.shape), blk)
            want = jax.tree.map(lambda a: a.shape, flat[i])
            assert got == want, (arch, i)
        for name in ("embed", "encoder", "img_proj", "mtp"):
            assert (name in tree) == (name in ref)
    for name in ("img_proj", "mtp"):
        if name in ref:
            got = jax.tree.map(lambda a: a.numpy(), params[name])
            assert jax.tree.all(jax.tree.map(np.array_equal, got, ref[name]))
    # the uniform init laws land in their ranges
    for blk in init["layers"]:
        if "rglru" in blk:
            a = torch.sigmoid(blk["rglru"]["lam"])
            assert a.min() >= 0.9 - 1e-6 and a.max() <= 0.999 + 1e-6
        if "ssm" in blk:
            A = torch.exp(blk["ssm"]["A_log"])
            assert A.min() >= 1 - 1e-5 and A.max() <= 16 + 1e-4
            dt = torch.nn.functional.softplus(blk["ssm"]["dt_bias"])
            assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """Prefill logits, the decode caches prepared from it (every layout:
    k/v, int32 slot positions, MLA latents, SSM/RG-LRU states, cross k/v)
    and two decode steps' logits and caches, against the JAX model."""
    jcfg, cfg, jmodel, jparams, model, params = _setup(arch)
    batch = _inputs(cfg, S + 2)
    pre = {**batch, "tokens": batch["tokens"][:, :S]}
    jl, jc = jmodel.prefill(jparams, _j(pre))
    tl, tc = model.prefill(params, _t(pre))
    assert tuple(tl.shape) == (2, 1, cfg.vocab_size)
    _close(tl, jl)
    P = cfg.num_image_tokens or 0
    jc = jmodel.prepare_decode_caches(jc, P + S, P + S + 8)
    tc = model.prepare_decode_caches(tc, P + S, P + S + 8)
    _close_caches(tc, jcfg, jc)
    toks = batch["tokens"]
    for step in range(2):
        cur = S + step
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(toks[:, cur:cur + 1]),
                                    jc, jnp.int32(P + cur))
        tl, tc = model.decode_step(params, torch.from_numpy(
            toks[:, cur:cur + 1]), tc, P + cur)
        _close(tl, jl)
    _close_caches(tc, jcfg, jc)


def _full_vs_decode(jcfg, cfg, jmodel, jparams, model, params, batch, steps,
                    tol):
    """Prefill on S tokens then `steps` decode steps at per-row positions:
    each step's logits against the port's full forward (tol) and the
    reference's (TOL)."""
    P = cfg.num_image_tokens or 0
    toks = batch["tokens"]
    _, caches = model.prefill(params, _t({**batch, "tokens": toks[:, :S]}))
    caches = model.prepare_decode_caches(caches, P + S, P + S + 8)
    B = toks.shape[0]
    for step in range(steps):
        cur = S + step
        full_batch = {**batch, "tokens": toks[:, : cur + 1]}
        own = model(params, _t(full_batch))[:, -1:]
        ref = _ref_full_logits(jcfg, jmodel, jparams, _j(full_batch))[:, -1:]
        got, caches = model.decode_step(
            params, torch.from_numpy(toks[:, cur: cur + 1]), caches,
            torch.full((B,), P + cur))
        torch.testing.assert_close(got, own, rtol=tol, atol=tol)
        _close(got, ref)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_prefill_then_decode_matches_full_forward(arch):
    """tests/test_decode_consistency.py's gate on the port: prefill then one
    decode step equals the full forward's last position (KV caches, SSM and
    RG-LRU states, MLA latents, the hybrid's ring and cross-attention all
    round-trip)."""
    setup = _setup(arch, **_drop_free(arch))
    _full_vs_decode(*setup, _inputs(setup[1], S + 1, seed=3), 1, 2e-3)


@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-2.7b",
                                  "recurrentgemma-9b", "deepseek-v3-671b"])
def test_multistep_decode_matches_full_forward(arch):
    """Decode 4 tokens autoregressively == 4 teacher-forced full forwards
    (the reference's list)."""
    setup = _setup(arch, **_drop_free(arch))
    _full_vs_decode(*setup, _inputs(setup[1], S + 5, seed=4), 4, 3e-3)


def test_ring_cache_matches_full_cache_window_decode():
    """Sliding-window decode with a ring cache (window_override 8 < max_len:
    K5 with slot positions) equals window attention with the full cache,
    and the reference's ring decode."""
    jcfg, cfg, jmodel, jparams, model, params = _setup("qwen3-8b",
                                                       sliding_window=8)
    n = 20
    toks = _inputs(cfg, n + 3, seed=5, B=1)["tokens"]
    _, c1 = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :n])},
                          window_override=8)
    ring = model.prepare_decode_caches(c1, n, n + 8, window_override=8)
    assert set(ring[0]) == {"k", "v", "pos"} and ring[0]["k"].shape[1] == 8
    _, c2 = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :n])})
    full = model.prepare_decode_caches(c2, n, n + 8)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :n])},
                           window_override=8)
    jring = jmodel.prepare_decode_caches(jc, n, n + 8, window_override=8)
    _close_caches(ring, jcfg, jring)
    for step in range(3):
        cur = n + step
        t = toks[:, cur: cur + 1]
        got_ring, ring = model.decode_step(params, torch.from_numpy(t), ring,
                                           cur, window_override=8)
        got_full, full = model.decode_step(params, torch.from_numpy(t), full,
                                           cur, window_override=8)
        want, jring = jmodel.decode_step(jparams, jnp.asarray(t), jring,
                                         jnp.int32(cur), window_override=8)
        torch.testing.assert_close(got_ring, got_full, rtol=2e-4, atol=2e-4)
        _close(got_ring, want)
    _close_caches(ring, jcfg, jring)


@pytest.mark.parametrize("n", [5, 8])
def test_ring_cache_shorter_prompt_pads_with_empty_slots(n):
    """A prompt shorter than (or as long as) the window: the ring holds
    positions 0..n-1 then -1 slots, and decode past the window's first lap
    still equals the reference's."""
    jcfg, cfg, jmodel, jparams, model, params = _setup("qwen3-8b",
                                                       sliding_window=8)
    toks = _inputs(cfg, n + 6, seed=6, B=1)["tokens"]
    _, c = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :n])},
                         window_override=8)
    ring = model.prepare_decode_caches(c, n, 32, window_override=8)
    want_pos = list(range(n)) + [-1] * (8 - n)
    assert ring[0]["pos"][0].tolist() == want_pos
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :n])},
                           window_override=8)
    jring = jmodel.prepare_decode_caches(jc, n, 32, window_override=8)
    for cur in range(n, n + 6):
        t = toks[:, cur: cur + 1]
        got, ring = model.decode_step(params, torch.from_numpy(t), ring, cur,
                                      window_override=8)
        want, jring = jmodel.decode_step(jparams, jnp.asarray(t), jring,
                                         jnp.int32(cur), window_override=8)
        _close(got, want)
    _close_caches(ring, jcfg, jring)


def test_hybrid_ring_from_a_prompt_past_the_window():
    """recurrentgemma's local attention (window 16) after a 21-token
    prompt: the ring is prepared from S >= W (`_ring_slots`), then decode
    steps wrap it; against the reference and the port's full forward."""
    jcfg, cfg, jmodel, jparams, model, params = _setup("recurrentgemma-9b")
    W = cfg.rglru.local_window
    n = W + 5
    toks = _inputs(cfg, n + 3, seed=17)["tokens"]
    _, c = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :n])})
    caches = model.prepare_decode_caches(c, n, 64)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :n])})
    jcaches = jmodel.prepare_decode_caches(jc, n, 64)
    ring = caches[cfg.layer_kinds().index(("attn", "mlp"))]
    assert ring["k"].shape[1] == W and sorted(ring["pos"][0].tolist()) == \
        list(range(n - W, n))
    _close_caches(caches, jcfg, jcaches)
    for cur in range(n, n + 3):
        t = toks[:, cur: cur + 1]
        got, caches = model.decode_step(params, torch.from_numpy(t), caches,
                                        cur)
        want, jcaches = jmodel.decode_step(jparams, jnp.asarray(t), jcaches,
                                           jnp.int32(cur))
        _close(got, want)
        own = model(params, torch.from_numpy(toks[:, : cur + 1]))[:, -1:]
        torch.testing.assert_close(got, own, rtol=2e-3, atol=2e-3)
    _close_caches(caches, jcfg, jcaches)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_prompt_shorter_than_the_conv_window(arch):
    """A 2-token prompt (conv_width 4): the conv decode state is the last
    3 inputs with a zero row first, the left padding the causal conv saw
    (the reference keeps a 2-row state its decode cannot take), so prefill
    + decode equals the full forward."""
    _, cfg, _, _, model, params = _setup(arch)
    toks = torch.from_numpy(_inputs(cfg, 4, seed=18)["tokens"])
    _, c = model.prefill(params, {"tokens": toks[:, :2]})
    caches = model.prepare_decode_caches(c, 2, 16)
    assert caches[0]["conv"].shape[1] == cfg.ssm.conv_width - 1
    assert torch.equal(caches[0]["conv"][:, 0],
                       torch.zeros_like(caches[0]["conv"][:, 0]))
    for cur in (2, 3):
        got, caches = model.decode_step(params, toks[:, cur: cur + 1],
                                        caches, cur)
        own = model(params, toks[:, : cur + 1])[:, -1:]
        torch.testing.assert_close(got, own, rtol=2e-3, atol=2e-3)


def _int8_decode(model, params, toks, window=None):
    _, c = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])})
    c = model.prepare_decode_caches(c, S, S + 4, window_override=window)
    got, c = model.decode_step(params, torch.from_numpy(toks[:, S:S + 1]), c,
                               S, window_override=window)
    return got, c


def test_kv_int8_decode_close_to_fp():
    """tests/test_perf_variants.py's gate: the int8 cache's decode logits
    stay within 5% (of the largest logit) of the f32 cache's."""
    _, cfg, _, _, model, params = _setup("qwen3-8b")
    mq = Model(dataclasses.replace(cfg, kv_cache_quant="int8"))
    toks = _inputs(cfg, S + 1, seed=7)["tokens"]
    ref, _ = _int8_decode(model, params, toks)
    got, caches = _int8_decode(mq, params, toks)
    assert caches[0]["k"].dtype == torch.int8
    assert caches[0]["k_scale"].shape == caches[0]["k"].shape[:3]
    err = float((got - ref).abs().max())
    assert err / (float(ref.abs().max()) + 1e-6) < 0.05


@pytest.mark.parametrize("window", [None, 8])
def test_kv_int8_decode_equals_the_reference_int8_decode(window):
    """The int8 cache (and int8 on the ring) against the reference's int8
    decode: codes, scales, slot positions and logits."""
    jcfg, cfg, jmodel, jparams, model, params = _setup(
        "qwen3-8b", kv_cache_quant="int8")
    toks = _inputs(cfg, S + 1, seed=8)["tokens"]
    got, caches = _int8_decode(model, params, toks, window)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    jc = jmodel.prepare_decode_caches(jc, S, S + 4, window_override=window)
    want, jc = jmodel.decode_step(jparams, jnp.asarray(toks[:, S:S + 1]), jc,
                                  jnp.int32(S), window_override=window)
    _close(got, want)
    _close_caches(caches, jcfg, jc)


@pytest.mark.parametrize("dispatch,shards", [("global", 1), ("local", 2),
                                             ("local", 4)])
def test_moe_local_dispatch_matches_global(dispatch, shards):
    """The forward half of tests/test_perf_variants.py's gate: at
    drop-free capacity, local dispatch (ranking and capacity per token
    shard) gives the global dispatch's prefill logits; each equals the
    reference's own dispatch."""
    kw = dict(moe=dataclasses.replace(
        get_config("phi3.5-moe-42b-a6.6b").reduced(layers=2, d_model=64).moe,
        capacity_factor=8.0, dispatch=dispatch, local_shards=shards))
    jcfg, cfg, jmodel, jparams, model, params = _setup(
        "phi3.5-moe-42b-a6.6b", **kw)
    toks = _inputs(cfg, 16, seed=9)["tokens"]
    got, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    want, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    _close(got, want)
    g = Model(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="global")))
    base, _ = g.prefill(params, {"tokens": torch.from_numpy(toks)})
    torch.testing.assert_close(got, base, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The new mixers and inputs, by name
# ---------------------------------------------------------------------------

def test_moe_route_breaks_ties_by_expert_index():
    """Top-k by (prob desc, expert asc), as `jax.lax.top_k` keeps the lower
    index on a tie; gates normalised over the k chosen."""
    logits = torch.tensor([[0.0, 1.0, 1.0, 1.0, 0.5, 1.0],
                           [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                           [3.0, -1.0, 3.0, 0.0, 3.0, 0.0]])
    probs, gates, sel = moe.route(logits, 3)
    jv, ji = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy()), -1), 3)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ji))
    np.testing.assert_allclose(gates.numpy(),
                               np.asarray(jv / jv.sum(-1, keepdims=True)),
                               rtol=1e-6)


@pytest.mark.parametrize("capacity", [0.5, 8.0])
def test_moe_layer_matches_the_reference(capacity):
    """The MoE FFN alone: output and the three aux values, with tokens
    dropped at capacity (0.5) and drop-free (8.0); deepseek's shared
    expert and 4 routed experts top-2."""
    jcfg, cfg, _, jparams, _, params = _setup("deepseek-v3-671b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity))
    i = cfg.layer_kinds().index(("attn", "moe"))
    x = np.random.default_rng(10).standard_normal((2, 9, 64)).astype(
        np.float32)
    y, aux = moe.apply(params["layers"][i]["moe"], cfg, torch.from_numpy(x))
    jp = _ref_layers(jcfg, jax.tree.map(np.asarray, jparams)["segments"])[i]
    jy, jaux = jmoe.apply(jax.tree.map(jnp.asarray, jp["moe"]), jcfg,
                          jnp.asarray(x))
    _close(y, jy)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7)
    assert (float(aux["moe_drop_fraction"]) > 0) == (capacity < 1)


def test_mla_decompressed_prefill_and_absorbed_decode_match():
    """MLA alone: the decompressed prefill through K6 (v zero-padded to the
    q/k width, sliced back) and its latent cache; the absorbed decode
    (einsums) against a padded latent cache, written in place."""
    jcfg, cfg, _, jparams, _, params = _setup("deepseek-v3-671b")
    jp = jax.tree.map(jnp.asarray, _ref_layers(
        jcfg, jax.tree.map(np.asarray, jparams)["segments"])[0]["attn"])
    tp = params["layers"][0]["attn"]
    rng = np.random.default_rng(11)
    B, n = 2, 10
    x = rng.standard_normal((B, n, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (B, n)).copy()
    got, c = mla.apply(tp, cfg, torch.from_numpy(x),
                       positions=torch.from_numpy(pos), mode="prefill",
                       return_cache=True)
    want, jc = jmla.apply(jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
                          mode="prefill", return_cache=True)
    _close(got, want)
    _close(c["ckv"], jc["ckv"])
    _close(c["k_rope"], jc["k_rope"])
    T = 16
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, T - n))
             for k, v in c.items()}
    jcache = {k: jnp.pad(v, ((0, 0), (0, T - n), (0, 0)))
              for k, v in jc.items()}
    xd = rng.standard_normal((B, 1, 64)).astype(np.float32)
    dpos = np.asarray([n, 3], np.int32)
    ckv = cache["ckv"]
    got, c2 = mla.apply(tp, cfg, torch.from_numpy(xd),
                        positions=torch.from_numpy(dpos[:, None].copy()),
                        mode="decode", cache=cache,
                        cache_pos=torch.from_numpy(dpos), window=6)
    want, jc2 = jmla.apply(jp, jcfg, jnp.asarray(xd),
                           positions=jnp.asarray(dpos[:, None]),
                           mode="decode", cache=jcache,
                           cache_pos=jnp.asarray(dpos), window=6)
    _close(got, want)
    assert c2 is cache and c2["ckv"] is ckv
    _close(c2["ckv"], jc2["ckv"])


def _ref_layer(jcfg, jparams, i, name):
    return jax.tree.map(jnp.asarray, _ref_layers(
        jcfg, jax.tree.map(np.asarray, jparams)["segments"])[i][name])


@pytest.mark.parametrize("L", [7, 16, 37])
def test_ssd_prefill_and_decode_match_the_reference(L):
    """Mamba-2's chunked SSD (chunk 16: L below, at and past it, padded),
    with an incoming state folded in, and the O(1) decode step written
    into the cache in place."""
    jcfg, cfg, _, jparams, _, params = _setup("mamba2-2.7b")
    jp, tp = _ref_layer(jcfg, jparams, 0, "ssm"), params["layers"][0]["ssm"]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, L, 64)).astype(np.float32)
    d_in, H, G, N, P, W = ssm.dims(cfg)
    state = rng.standard_normal((2, H, P, N)).astype(np.float32)
    for cache in (None, {"state": state}):
        tc = None if cache is None else {"state": torch.from_numpy(state)}
        jc = None if cache is None else {"state": jnp.asarray(state)}
        got, c = ssm.apply(tp, cfg, torch.from_numpy(x), mode="prefill",
                           cache=tc, return_cache=True)
        want, jcc = jssm.apply(jp, jcfg, jnp.asarray(x), mode="prefill",
                               cache=jc, return_cache=True)
        _close(got, want)
        _close(c["state"], jcc["state"])
        _close(c["conv"], jcc["conv"])
    xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
    st = c["state"]
    got, c2 = ssm.apply(tp, cfg, torch.from_numpy(xd), mode="decode", cache=c)
    want, jc2 = jssm.apply(jp, jcfg, jnp.asarray(xd), mode="decode", cache=jcc)
    _close(got, want)
    assert c2["state"] is st
    _close(c2["state"], jc2["state"])
    _close(c2["conv"], jc2["conv"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_depth_gap_matches_the_reference(dtype):
    """Mamba-2 at 16 layers of width 256: prefill + 4 decode steps against
    the full forward, port and reference on the same weights.  At f32 both
    gaps stay within TOL of the logit scale; in bf16 the reference itself
    parts by a few percent (its chunked prefill and recurrent decode round
    in other orders at every layer), and the port's gap may be no more than
    1.5 times the reference's."""
    S, steps = 40, 4
    jcfg = dataclasses.replace(
        jget_config("mamba2-2.7b").reduced(layers=16, d_model=256),
        param_dtype=dtype, compute_dtype=dtype)
    cfg = dataclasses.replace(
        get_config("mamba2-2.7b").reduced(layers=16, d_model=256),
        param_dtype=dtype, compute_dtype=dtype)
    jmodel, model = JModel(jcfg), Model(cfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(
        cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
        device="cpu")
    params = jax.tree.map(lambda t: t.to(cfg.cdtype), params)
    toks = _inputs(cfg, S + steps, seed=14)["tokens"]

    def ref():
        x = jembedding.embed(jparams["embed"], jcfg, jnp.asarray(toks))
        h, _, _ = jtransformer.decoder_apply(
            jparams, jcfg, x, mode="train", positions=jnp.broadcast_to(
                jnp.arange(S + steps), (2, S + steps)), remat=False)
        full = jembedding.logits(jparams["embed"], jcfg, h)[:, S - 1:]
        lg, c = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])})
        c = jmodel.prepare_decode_caches(c, S, S + steps)
        out = [lg[:, 0]]
        for i in range(steps):
            lg, c = jmodel.decode_step(
                jparams, jnp.asarray(toks[:, S + i:S + i + 1]), c,
                jnp.int32(S + i))
            out.append(lg[:, 0])
        return (np.asarray(jnp.stack(out, 1), np.float32),
                np.asarray(full, np.float32))

    def port():
        t = torch.from_numpy(toks)
        with torch.no_grad():
            full = model(params, {"tokens": t})[:, S - 1:]
            lg, c = model.prefill(params, {"tokens": t[:, :S]})
            c = model.prepare_decode_caches(c, S, S + steps)
            out = [lg[:, -1]]
            for i in range(steps):
                lg, c = model.decode_step(params, t[:, S + i:S + i + 1], c,
                                          S + i)
                out.append(lg[:, 0])
        return (torch.stack(out, 1).float().numpy(), full.float().numpy())

    def gap(have, full):
        return float(np.abs(have - full).max() / np.abs(full).max())

    got, want = gap(*port()), gap(*ref())
    if dtype == "float32":
        assert got < TOL and want < TOL, (got, want)
    else:
        assert got <= 1.5 * want, (got, want)


@pytest.mark.parametrize("L", [5, 64, 1100])
def test_rglru_scan_matches_the_reference_two_level_scan(L):
    """RG-LRU prefill: the port's chunked linear recurrence against the
    reference's associative scan (two-level past Q = 1024 steps: L = 1100),
    with an incoming state folded into step 0; then the decode step in
    place.  Tolerance TOL on outputs of order 1."""
    jcfg, cfg, _, jparams, _, params = _setup("recurrentgemma-9b")
    jp = _ref_layer(jcfg, jparams, 0, "rglru")
    tp = params["layers"][0]["rglru"]
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, L, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    for fold in (False, True):
        tc = {"h": torch.from_numpy(h0)} if fold else None
        jc = {"h": jnp.asarray(h0)} if fold else None
        got, c = rglru.apply(tp, cfg, torch.from_numpy(x), mode="prefill",
                             cache=tc, return_cache=True)
        want, jcc = jrglru.apply(jp, jcfg, jnp.asarray(x), mode="prefill",
                                 cache=jc, return_cache=True)
        _close(got, want)
        _close(c["h"], jcc["h"])
    xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
    got, c2 = rglru.apply(tp, cfg, torch.from_numpy(xd), mode="decode",
                          cache=c)
    want, jc2 = jrglru.apply(jp, jcfg, jnp.asarray(xd), mode="decode",
                             cache=jcc)
    _close(got, want)
    _close(c2["h"], jc2["h"])
    _close(c2["conv"], jc2["conv"])


def test_linear_scan_is_the_sequential_recurrence():
    """`linear_scan` against the step-by-step recurrence over f32 at chunk
    edges (L = 1, 63, 64, 65, 200)."""
    g = torch.Generator().manual_seed(14)
    for L in (1, 63, 64, 65, 200):
        a = torch.rand((2, L, 5), generator=g)
        b = torch.randn((2, L, 5), generator=g)
        h, want = torch.zeros(2, 5), []
        for t in range(L):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(rglru.linear_scan(a, b),
                                   torch.stack(want, 1), rtol=1e-5,
                                   atol=1e-6)


def test_image_prefix_prefill_matches_the_reference():
    """paligemma: the image prefix through `img_proj`, the prefix-LM mask
    over P + S positions (K6's prefix variant), and its hidden states
    against the reference's at every position."""
    jcfg, cfg, jmodel, jparams, model, params = _setup("paligemma-3b")
    batch = _inputs(cfg, S, seed=15)
    got = model(params, _t(batch))
    assert got.shape[1] == cfg.num_image_tokens + S
    _close(got, _ref_full_logits(jcfg, jmodel, jparams, _j(batch)))
    # the prefix is bidirectional: changing the last image patch moves the
    # first position's logits; the text stays causal: changing the last
    # token moves no earlier position
    P = cfg.num_image_tokens
    moved = dict(batch, images=batch["images"].copy())
    moved["images"][:, -1] += 1.0
    assert not torch.allclose(model(params, _t(moved))[:, 0], got[:, 0])
    moved = dict(batch, tokens=batch["tokens"].copy())
    moved["tokens"][:, -1] = (moved["tokens"][:, -1] + 1) % cfg.vocab_size
    got2 = model(params, _t(moved))
    torch.testing.assert_close(got2[:, :P + S - 1], got[:, :P + S - 1])
    assert not torch.allclose(got2[:, -1], got[:, -1])


def test_encoder_and_cross_attention_match_the_reference():
    """whisper: the bidirectional encoder over stub audio frames (K6),
    sinusoidal positions on both sides, the decoder's cross-attention
    caches and cross decode (K5 over every frame)."""
    jcfg, cfg, jmodel, jparams, model, params = _setup("whisper-small")
    batch = _inputs(cfg, S, seed=16)
    enc, _ = model.encode(params, torch.from_numpy(batch["audio"]))
    jenc, _ = jmodel.encode(jparams, jnp.asarray(batch["audio"]))
    _close(enc, jenc)
    _, caches = model.prefill(params, _t(batch))
    assert {"cross_k", "cross_v", "k", "v"} <= set(caches[0])
    assert caches[0]["cross_k"].shape[1] == cfg.encoder_seq_len


@pytest.mark.parametrize("piece", ["train_loss", "mtp_loss",
                                   "mla_absorbed_train"])
def test_m7_pieces_raise_naming_the_training_slice(piece):
    """The training slice (M7a) brought train_loss and the MTP loss: on
    deepseek both now run to finite values (tests/test_torch_train_zoo.py
    holds them to the reference).  The absorbed MLA form in train/prefill
    came with the distribution slice (M7b): it gives the decompressed
    form's logits."""
    _, cfg, _, _, model, params = _setup("deepseek-v3-671b")
    toks = torch.from_numpy(_inputs(cfg, 8)["tokens"])
    if piece == "train_loss":
        loss, metrics = model.train_loss(params, {"tokens": toks})
        assert torch.isfinite(loss) and "mtp_ce" in metrics
    elif piece == "mtp_loss":
        h = model.hidden(params, {"tokens": toks})
        pos = torch.arange(toks.shape[1]).expand(toks.shape)
        assert torch.isfinite(model._mtp_loss(params, cfg, h, toks, pos))
    else:
        # the distribution slice brought the absorbed form (K6 against the
        # latent; tests/test_torch_mla_absorbed.py holds it to the
        # reference): its prefill logits are the decompressed form's
        absorbed, _ = Model(dataclasses.replace(
            cfg, mla_absorbed_train=True)).prefill(params, {"tokens": toks})
        plain, _ = model.prefill(params, {"tokens": toks})
        np.testing.assert_allclose(absorbed.numpy(), plain.numpy(),
                                   rtol=1e-4, atol=1e-4)
