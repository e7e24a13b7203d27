"""Training on the port's zoo against the JAX package, on the CPU: the
reduced archs whose mixers or FFNs are not plain attention — mamba2 (SSD's
chunked scan), recurrentgemma (RG-LRU's two-level scan and its local
attention), phi3.5-moe (MoE dispatch by `index_add_` into fresh zeros, the
auxiliary losses) and deepseek-v3 (MLA's decompressed path, MoE with a
shared expert, the depth-1 MTP loss): `Model.train_loss`, its metrics and
every leaf's gradient against `jax.grad` of the reference's, at the
tolerances of test_torch_train_zoo.py.  Then recompute: the gradients with
each block under `torch.utils.checkpoint` equal those without it, bit for
bit (the MoE routing is a stable sort, so the recomputed forward routes
the same tokens).
"""
import pytest
import torch

from test_torch_train_zoo import check_against_the_reference, np_batch, setup

from repro_torch.common.module import leaves_with_names, unflatten
from repro_torch.models import transformer
from repro_torch.models.model_api import Model

ARCHS = ("mamba2-2.7b", "recurrentgemma-9b", "phi3.5-moe-42b-a6.6b",
         "deepseek-v3-671b")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_equal_the_reference(arch):
    metrics = check_against_the_reference(arch)
    assert ("mtp_ce" in metrics) == (arch == "deepseek-v3-671b")
    if "moe" in arch or "deepseek" in arch:
        assert float(metrics["moe_load_balance"]) > 0


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
                                  "mamba2-2.7b", "recurrentgemma-9b"])
def test_recompute_gives_the_same_gradients(arch, monkeypatch):
    _, cfg, _, params = setup(arch)
    batch = {k: torch.from_numpy(v) for k, v in np_batch(cfg).items()}
    leaves = [p for _, p in leaves_with_names(params)]

    def grads(remat):
        apply = transformer.decoder_apply

        def forced(*args, **kw):
            kw["remat"] = remat and kw.get("remat", False)
            return apply(*args, **kw)
        monkeypatch.setattr(transformer, "decoder_apply", forced)
        tracked = [p.detach().requires_grad_(True) for p in leaves]
        loss, _ = Model(cfg).train_loss(unflatten(params, tracked), batch)
        out = torch.autograd.grad(loss, tracked, allow_unused=True)
        monkeypatch.setattr(transformer, "decoder_apply", apply)
        return loss, out

    l1, g1 = grads(True)
    l0, g0 = grads(False)
    assert float(l1.detach()) == float(l0.detach())
    for a, b in zip(g1, g0):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
