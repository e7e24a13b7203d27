"""Training on the port's zoo against the JAX package, on the CPU: each
reduced `ASSIGNED_ARCHS` arch of the attention families (dense GQA, qk-norm,
qkv biases, the parallel residual, the image prefix, the encoder-decoder)
at `.reduced(layers=2, d_model=64)`, f32, the reference's weights carried
across with `params_from_numpy`: `Model.train_loss` and its metrics, and
every leaf's gradient against `jax.grad` of the reference's `train_loss`.
The recurrent, MoE and MLA archs are in test_torch_train_zoo_mixers.py.

Tolerances: metrics 1e-5; gradients GRAD_TOL = 2e-4 of max(the leaf's
largest |g|, 1e-2 x the tree's largest) — f32 through two layers whose
matmuls, softmaxes, scans and chunked cross-entropy sum in other orders
(the image projection's gradient sums 16 patches x 1152 inputs); the
floor keeps a leaf whose exact gradient is 0 (whisper's key bias `bk`:
a bias on every key shifts all of a query's scores equally) from being
judged on rounding.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.model_api import Model as JModel
from repro_torch.checkpoint.io import _flatten
from repro_torch.configs import get_config
from repro_torch.models.model_api import (Model, params_from_numpy,
                                          params_to_numpy)
from repro_torch.training.train_loop import loss_and_grads

METRIC_TOL = 1e-5
GRAD_TOL = 2e-4
ARCHS = ("stablelm-3b", "qwen2.5-14b", "qwen3-8b", "internlm2-1.8b",
         "whisper-small", "paligemma-3b")


def reduce(cfg):
    """Two layers of width 64; recurrentgemma keeps three, its whole
    (rglru, rglru, local attention) period."""
    return cfg.reduced(layers=3 if cfg.hybrid_period else 2, d_model=64)


@functools.lru_cache(maxsize=None)
def setup(arch):
    jcfg, cfg = reduce(jget_config(arch)), reduce(get_config(arch))
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, cfg, jparams, params


def np_batch(cfg, B=2, S=24, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(4, cfg.vocab_size, (B, S)).astype(
                np.int32),
             "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.num_image_tokens:
        batch["images"] = rng.standard_normal(
            (B, cfg.num_image_tokens, 1152)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["audio"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def check_against_the_reference(arch):
    jcfg, cfg, jparams, params = setup(arch)
    batch = np_batch(cfg)
    jmodel = JModel(jcfg)
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jmodel.train_loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    metrics, grads = loss_and_grads(
        Model(cfg), params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(metrics) == set(jmetrics)
    for key, value in metrics.items():
        assert np.isfinite(float(value)), key
        np.testing.assert_allclose(float(value), float(jmetrics[key]),
                                   rtol=METRIC_TOL, atol=METRIC_TOL,
                                   err_msg=f"{arch} {key}")
    got = _flatten(params_to_numpy(cfg, grads))
    want = _flatten(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        assert np.isfinite(got[key]).all(), key
        scale = max(float(np.abs(w).max()), 1e-2 * top)
        err = float(np.abs(got[key] - w).max())
        assert err <= GRAD_TOL * scale, (
            f"{arch} {key}: {err} > {GRAD_TOL} x {scale}")
    return metrics


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_equal_the_reference(arch):
    metrics = check_against_the_reference(arch)
    assert "mtp_ce" not in metrics
