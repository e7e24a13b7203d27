"""The dense LM of the port against the JAX package on the CPU: configs and
the registry, the parameter specs and init laws, and `Model.prefill` /
`decode_step` logits from the same weights (the JAX tree carried across
with `params_from_numpy`), at reduced size.  Also the serving invariant of
tests/test_decode_consistency.py for the dense configs: prefill followed
by decode steps reproduces the port's own full forward.  The rest of the
zoo (MoE, MLA, SSM, RG-LRU, encoder-decoder, image prefixes, the ring and
int8 caches) is held in tests/test_torch_zoo.py.

Logits (of order 1) agree to 1e-4: the same f32 weights and inputs, with
matmul, norm and softmax summation orders that differ between the two
frameworks (~1e-5 relative over two layers and the vocab projection)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.models import transformer as jtransformer
from repro.models.config import INPUT_SHAPES as J_INPUT_SHAPES
from repro.models.config import plan_segments as jplan_segments
from repro.models.layers import embedding as jembedding
from repro.models.model_api import Model as JModel
from repro_torch.common.module import ParamSpec, materialize, stack
from repro_torch.configs import get_config, list_archs
from repro_torch.models.config import INPUT_SHAPES, plan_segments
from repro_torch.models.model_api import Model, params_from_numpy

TOL = 1e-4
DENSE = ["memori-agent", "qwen3-8b", "qwen2.5-14b", "stablelm-3b",
         "internlm2-1.8b"]


def _config_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", jlist_archs())
def test_registry_resolves_every_id_as_the_reference(arch):
    assert list_archs() == jlist_archs()
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert str(_config_fields(cfg)) == str(_config_fields(jcfg))
    assert cfg.layer_kinds() == jcfg.layer_kinds()
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.param_count(active_only=True) == jcfg.param_count(
        active_only=True)
    assert plan_segments(cfg.layer_kinds()) == jplan_segments(
        jcfg.layer_kinds())
    red, jred = cfg.reduced(), jcfg.reduced()
    assert str(_config_fields(red)) == str(_config_fields(jred))
    assert cfg.pdtype == getattr(torch, jcfg.param_dtype)
    assert cfg.cdtype == getattr(torch, jcfg.compute_dtype)
    with pytest.raises(KeyError):
        get_config(arch + "-nope")


def test_input_shapes_match():
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in J_INPUT_SHAPES.items()}


def test_materialize_follows_the_init_laws():
    specs = {"a": ParamSpec((64, 8, 4), ("x", "y", "z"), init="scaled_normal",
                            scale=1.0),
             "b": [ParamSpec((7,), ("x",), init="zeros"),
                   ParamSpec((7,), ("x",), init="ones")],
             "c": ParamSpec((4000,), ("x",), init="normal", scale=0.5)}
    gen = torch.Generator().manual_seed(0)
    p = materialize(gen, specs, torch.float32)
    assert p["a"].shape == (64, 8, 4)
    assert abs(float(p["a"].std()) - 1 / np.sqrt(8)) < 0.03   # fan_in = 8
    assert torch.equal(p["b"][0], torch.zeros(7))
    assert torch.equal(p["b"][1], torch.ones(7))
    assert abs(float(p["c"].std()) - 0.5) < 0.03
    again = materialize(torch.Generator().manual_seed(0), specs)
    assert torch.equal(again["a"], p["a"]) and torch.equal(again["c"], p["c"])
    assert stack(specs, 3)["a"].shape == (3, 64, 8, 4)


def _setup(arch, seed=0):
    jcfg = jget_config(arch).reduced(layers=2, d_model=64)
    cfg = get_config(arch).reduced(layers=2, d_model=64)
    jmodel = JModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    model = Model(cfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, cfg, jmodel, jparams, model, params


def test_param_tree_shapes_match_the_reference_unstacked():
    jcfg, cfg, jmodel, jparams, model, params = _setup("memori-agent")
    init = model.init_params(torch.Generator().manual_seed(0))
    for tree in (params, init):
        assert len(tree["layers"]) == cfg.num_layers
        for i, blk in enumerate(tree["layers"]):
            for name, sub in blk.items():
                for leaf, x in sub.items():
                    want = jparams["segments"][0][0][name][leaf][i]
                    assert tuple(x.shape) == want.shape
                    assert x.dtype == torch.float32
        assert tree["embed"]["table"].shape == jparams["embed"]["table"].shape
    torch.testing.assert_close(
        params["layers"][1]["attn"]["wq"],
        torch.from_numpy(np.array(jparams["segments"][0][0]["attn"]["wq"][1])))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_logits_match_the_reference(arch):
    jcfg, cfg, jmodel, jparams, model, params = _setup(arch)
    S = 12
    toks = np.random.default_rng(1).integers(
        4, cfg.vocab_size, (2, S + 2)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])})
    assert tuple(tl.shape) == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    jc = jmodel.prepare_decode_caches(jc, S, S + 8)
    tc = model.prepare_decode_caches(tc, S, S + 8)
    for step in range(2):
        cur = S + step
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(toks[:, cur:cur + 1]),
                                    jc, jnp.int32(cur))
        tl, tc = model.decode_step(params, torch.from_numpy(
            toks[:, cur:cur + 1]), tc, cur)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
    # the caches hold the reference's values at this layer, padded
    jk = np.asarray(jc[0][0]["k"])[1]      # segment 0, block 0, layer 1
    np.testing.assert_allclose(tc[1]["k"].numpy(), jk, rtol=TOL, atol=TOL)


def test_full_forward_matches_the_reference():
    jcfg, cfg, jmodel, jparams, model, params = _setup("memori-agent")
    toks = np.random.default_rng(2).integers(4, cfg.vocab_size,
                                             (2, 10)).astype(np.int32)
    pos = jnp.broadcast_to(jnp.arange(10)[None], (2, 10))
    x = jembedding.embed(jparams["embed"], jcfg, jnp.asarray(toks))
    h, _, _ = jtransformer.decoder_apply(jparams, jcfg, x, mode="train",
                                         positions=pos, remat=False)
    want = jembedding.logits(jparams["embed"], jcfg, h)
    got = model(params, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", ["memori-agent", "stablelm-3b", "qwen3-8b"])
def test_prefill_then_decode_matches_full_forward(arch):
    """The dense case of tests/test_decode_consistency.py on the port: four
    tokens decoded against the prefill cache (per-row cache positions, the
    engine's shape) equal four teacher-forced full forwards."""
    cfg = get_config(arch).reduced()
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(3))
    S = 12
    toks = torch.randint(4, cfg.vocab_size, (2, S + 4),
                         generator=torch.Generator().manual_seed(4))
    _, caches = model.prefill(params, {"tokens": toks[:, :S]})
    caches = model.prepare_decode_caches(caches, S, S + 8)
    for step in range(4):
        cur = S + step
        want = model(params, toks[:, : cur + 1])[:, -1:]
        got, caches = model.decode_step(params, toks[:, cur: cur + 1], caches,
                                        torch.tensor([cur, cur]))
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
