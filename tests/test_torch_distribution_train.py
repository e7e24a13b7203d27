"""The port's meshed train steps (M7b) on 4 gloo ranks, spawned once for the
module by tests/torch_mesh_worker.py (its "train" part; a FileStore under
tmp_path, no TCP port; 120 s limit): every reduced family's loss and every
leaf's gradient on a (2, 2) ("data", "model") CPU mesh — dense, MoE with
global and local dispatch, MLA absorbed and decompressed, Mamba-2, RG-LRU,
encoder-decoder, VLM, and on a (1, 4) mesh 2 kv heads over the 4-wide
`model` axis — against the one-device port, and the whole dense step
(AdamW on DTensor moments) against the one-device step.

Tolerances: the loss 1e-5 relative; gradients 1e-4 of the leaf's scale,
max(its largest |g|, 1e-2 x the tree's largest), as test_torch_train_zoo's
(a leaf whose exact gradient is 0 is not judged on rounding).  The meshed
sums (partial products reduced over `model`, gradients over `data`) add in
other orders than one device's; the weights have attention at unit score
spread (`torch_mesh_worker.family_params`).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_mesh_worker as W  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return W.results(tmp_path_factory.mktemp("mesh-train"), "train")


def _check_grads(got, want, what):
    top = max(float(w.abs().max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(float(w.abs().max()), 1e-2 * top)
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * scale, (what, i, err, scale)


@pytest.mark.parametrize("name", [f[0] for f in W.FAMILIES])
def test_meshed_train_loss_and_gradients_equal_one_device(results, name):
    from repro_torch.common.module import leaves_with_names
    from repro_torch.training.train_loop import loss_and_grads
    cfg, model, params = W.one_device(name)
    metrics, grads = loss_and_grads(model, params, W.family_batch(cfg))
    got_m, got_g = results[f"train_{name}"]
    assert set(got_m) == set(metrics)
    for key, value in metrics.items():
        np.testing.assert_allclose(got_m[key], float(value), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=f"{name} {key}")
    want = [g for _, g in leaves_with_names(grads)]
    assert len(got_g) == len(want)
    _check_grads(got_g, want, name)


def test_meshed_train_step_runs_adamw_on_dtensor_moments(results):
    from torch.distributed.tensor import Replicate
    from repro_torch.launch.sharding import build_train_step
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.training import optimizer as opt
    cfg, _, params = W.one_device("dense")
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=W.B,
                                seq_len=W.S)
    bundle = build_train_step(cfg, shape, device="cpu")
    _, _, m = bundle.fn(params, opt.init(bundle.opt, params),
                        W.family_batch(cfg))
    got, placements = results["train_step_dense"]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[key], float(m[key]), rtol=LOSS_TOL,
                                   err_msg=key)
    # the embedding's moments shard its vocab over `model`
    assert placements[0] != (Replicate(), Replicate())


