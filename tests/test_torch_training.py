"""The port's training slice on the CPU against the JAX package: the data
pipeline, AdamW, `Model.train_loss`, the train loop, parameter checkpoints
in the reference's layout, the train launcher and the train_100m example.

Weights go across with `params_from_numpy`, inputs are made with numpy (or
by the pipeline, which both packages run from one seed).  Tolerances:
loss and metrics 1e-5 relative (f32 sums in other orders); gradients
GRAD_TOL = 1e-4 of each leaf's largest |g| (a 2-layer f32 model whose
matmuls, softmaxes and the chunked cross-entropy sum in other orders);
one optimizer update UPDATE_TOL = 4e-6 relative on identical inputs (the
clip scale's global norm sums its leaves in another order: an ulp or two).

Comparing parameters after an AdamW step is a trap.  At step 1 the update
is lr * mhat / (sqrt(vhat) + eps) with mhat / sqrt(vhat) = g / |g| = +-1
for every element: a gradient element near zero whose sign differs between
the packages by rounding moves its parameter by 2 lr.  So these tests hold
the gradients to each other directly, and the optimizer to the reference's
on identical gradients, never parameters after a step that each package
took from its own gradients.  (The train loop's accumulated gradients are
compared through the step's `grad_norm`, which is computed before the
update.)
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import get_config as jget_config
from repro.data.pipeline import batches as jbatches
from repro.models.model_api import Model as JModel
from repro.training import optimizer as jopt
from repro.training import train_loop as jtrain_loop
from repro_torch.checkpoint import io as ckpt
from repro_torch.common.module import leaves_with_names, unflatten
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.data.pipeline import batches
from repro_torch.launch.sharding import build_train_step
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.model_api import (Model, params_from_numpy,
                                          params_to_numpy)
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (TrainConfig, loss_and_grads,
                                             make_train_step, train)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
METRIC_TOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 4e-6


def _agent(layers=2, d_model=64):
    return (jget_config("memori-agent").reduced(layers=layers,
                                                d_model=d_model),
            get_config("memori-agent").reduced(layers=layers,
                                               d_model=d_model))


def _pair_params(jcfg, cfg, seed=0):
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _np_batch(cfg, B=2, S=24, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(4, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}


def _flat(tree):
    return ckpt._flatten(tree)


def assert_grads_close(cfg, grads, jgrads, tol=GRAD_TOL):
    """Every leaf of the port's gradient tree against the reference's,
    relative to max(the leaf's largest |g|, 1e-2 x the tree's largest):
    the floor keeps a leaf whose exact gradient is 0 (a key bias shifts
    all of a query's scores equally) from being judged on rounding."""
    got = _flat(params_to_numpy(cfg, grads))
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-2 * top)
        err = float(np.abs(got[key].astype(np.float32) - w).max())
        assert err <= tol * scale, f"{key}: {err} > {tol} x {scale}"


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [0, 2])
def test_pipeline_batches_equal_the_reference(microbatches):
    want = jbatches(3, 40, vocab_size=512, seed=2, microbatches=microbatches)
    got = batches(3, 40, vocab_size=512, seed=2, microbatches=microbatches,
                  device="cpu")
    for _ in range(3):
        w, g = next(want), next(got)
        assert set(g) == {"tokens", "loss_mask"}
        assert g["tokens"].dtype == torch.int32
        assert g["loss_mask"].dtype == torch.float32
        for key in w:
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_schedule_equals_the_reference():
    cfg = opt.OptimizerConfig(peak_lr=6e-4, min_lr=3e-5, warmup_steps=20,
                              total_steps=200)
    jcfg = jopt.OptimizerConfig(peak_lr=6e-4, min_lr=3e-5, warmup_steps=20,
                                total_steps=200)
    for s in [0, 1, 5, 10, 19, 20, 21, 50, 100, 150, 199, 200, 250]:
        got = opt.schedule(cfg, torch.tensor(s, dtype=torch.int32))
        want = jopt.schedule(jcfg, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_schedule_warmup_and_decay():
    cfg = opt.OptimizerConfig(peak_lr=1.0, min_lr=0.1, warmup_steps=10,
                              total_steps=100)
    lrs = [float(opt.schedule(cfg, torch.tensor(s))) for s in
           [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == 0.5
    assert abs(lrs[2] - 1.0) < 1e-6
    assert 0.1 < lrs[3] < 1.0
    assert abs(lrs[4] - 0.1) < 1e-6


@pytest.mark.parametrize("grad_std", [1.0, 1e-4], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_one_update_equals_the_reference(state_dtype, grad_std):
    """One AdamW update (step 3 -> 4) from identical params, grads and
    moments: new params, moments, grad_norm and lr."""
    jcfg, cfg = _agent()
    jparams, params = _pair_params(jcfg, cfg)
    rng = np.random.default_rng(5)
    np_like = lambda scale, f=lambda x: x: jax.tree.map(
        lambda p: f(rng.standard_normal(p.shape) * scale).astype(
            np.float32), jparams)
    g_np = np_like(grad_std)
    mu_np = np_like(1e-3)
    nu_np = np_like(1e-3, np.square)
    sdt = jnp.dtype(state_dtype)
    jstate = jopt.OptState(step=jnp.asarray(3, jnp.int32),
                           mu=jax.tree.map(lambda a: jnp.asarray(a, sdt),
                                           mu_np),
                           nu=jax.tree.map(lambda a: jnp.asarray(a, sdt),
                                           nu_np))
    ocfg = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10,
                state_dtype=state_dtype)
    jnew, jst, jm = jopt.update(jopt.OptimizerConfig(**ocfg), jparams,
                                jax.tree.map(jnp.asarray, g_np), jstate)
    to_port = lambda tree: params_from_numpy(
        cfg, jax.tree.map(np.asarray, tree), device="cpu")
    state = opt.OptState(step=torch.tensor(3, dtype=torch.int32),
                         mu=to_port(jstate.mu), nu=to_port(jstate.nu))
    new, st, m = opt.update(opt.OptimizerConfig(**ocfg), params,
                            to_port(g_np), state)
    assert int(st.step) == 4
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=UPDATE_TOL)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=0)
    for got, want in ((new, jnew), (st.mu, jst.mu), (st.nu, jst.nu)):
        got, want = params_to_numpy(cfg, got), jax.tree.map(np.asarray, want)
        for key, w in _flat(want).items():
            g = _flat(got)[key]
            assert g.dtype.itemsize == w.dtype.itemsize, key
            if w.dtype.itemsize == 2:       # bf16 state: the same bits
                g = torch.from_numpy(g.view(np.int16)).view(
                    torch.bfloat16).float().numpy()
                w = np.asarray(jnp.asarray(w).astype(jnp.float32))
            np.testing.assert_allclose(g, w, rtol=UPDATE_TOL, atol=0,
                                       err_msg=key)


def _ref_decay(path_names) -> bool:
    """The reference's `_decay_mask` on a path of dict keys."""
    return jopt._decay_mask([jax.tree_util.DictKey(n) for n in path_names])


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + ("memori-agent",))
def test_decay_mask_equals_the_reference_on_every_leaf_name(arch):
    """The same leaves decay, by name, at full width; the reference's
    substring test excludes every name holding a `b` or a `D` (so
    `embed/table` gets no decay), and the port copies that as it is."""
    jtree = JModel(jget_config(arch)).abstract_params()
    jdecay = {str(path[-1].key): jopt._decay_mask(path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tdecay = {str(path[-1]): opt._decay_mask(path) for path, _ in
              leaves_with_names(Model(get_config(arch)).param_specs())}
    assert tdecay == jdecay
    assert not tdecay["table"]


# ---------------------------------------------------------------------------
# train_loss and its gradient
# ---------------------------------------------------------------------------

def test_agent_train_loss_and_grads_equal_the_reference():
    jcfg, cfg = _agent()
    jparams, params = _pair_params(jcfg, cfg)
    batch = _np_batch(cfg)
    jmodel = JModel(jcfg)
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_loss(p, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True))(jparams)
    metrics, grads = loss_and_grads(
        Model(cfg), params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(metrics) == set(jmetrics)
    for key, value in metrics.items():
        np.testing.assert_allclose(float(value), float(jmetrics[key]),
                                   rtol=METRIC_TOL, atol=METRIC_TOL,
                                   err_msg=key)
    assert_grads_close(cfg, grads, jgrads)


def test_grad_accumulation_matches_large_batch():
    jcfg, cfg = _agent()
    model = Model(cfg)
    _, params = _pair_params(jcfg, cfg)
    data = next(batches(4, 32, vocab_size=cfg.vocab_size, microbatches=2,
                        device="cpu"))
    big = {k: v.reshape(-1, *v.shape[2:]) for k, v in data.items()}
    with torch.no_grad():
        loss_big, _ = model.train_loss(params, big)
        l0, _ = model.train_loss(params, {k: v[0] for k, v in data.items()})
        l1, _ = model.train_loss(params, {k: v[1] for k, v in data.items()})
    # equal-sized microbatches with near-equal token counts: mean of means
    np.testing.assert_allclose(float((l0 + l1) / 2), float(loss_big),
                               rtol=2e-2)


def test_accumulated_step_equals_the_reference():
    """make_train_step with grad_accum=2 on stacked micro-batches: the
    averaged metrics and the grad_norm of the averaged f32 gradients
    (taken before the update) equal the reference's.  The reference's own
    accumulating step does not trace (its `lax.scan` carry starts with an
    empty metrics dict: ROADMAP.md queue 3), so its side is what that step
    means: the reference's gradient and metrics of each micro-batch,
    averaged, and `optimizer.global_norm` of the averaged gradients."""
    jcfg, cfg = _agent()
    jparams, params = _pair_params(jcfg, cfg)
    data = next(jbatches(2, 24, vocab_size=cfg.vocab_size, microbatches=2))
    jtc = jtrain_loop.TrainConfig(grad_accum=2)
    with pytest.raises(TypeError, match="carry"):
        jax.jit(jtrain_loop.make_train_step(JModel(jcfg), jtc))(
            jparams, jopt.init(jtc.opt, jparams), data)
    jmodel = JModel(jcfg)
    vg = jax.jit(jax.value_and_grad(jmodel.train_loss, has_aux=True))
    micro = [vg(jparams, {k: v[i] for k, v in data.items()})
             for i in range(2)]
    jm = {k: (micro[0][0][1][k] + micro[1][0][1][k]) / 2
          for k in micro[0][0][1]}
    jm["grad_norm"] = jopt.global_norm(jax.tree.map(
        lambda a, b: (a + b) / 2, micro[0][1], micro[1][1]))
    jm["lr"] = jopt.schedule(jtc.opt, jnp.asarray(1))
    tc = TrainConfig(grad_accum=2)
    step = make_train_step(Model(cfg), tc)
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
    _, st, m = step(params, opt.init(tc.opt, params), tdata)
    assert int(st.step) == 1
    for key in ("ce", "accuracy", "loss", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=METRIC_TOL, atol=METRIC_TOL,
                                   err_msg=key)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_TOL)


def test_tiny_lm_loss_decreases():
    cfg = get_config("memori-agent").reduced(layers=2, d_model=128)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    tc = TrainConfig(steps=25, log_every=5,
                     opt=opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=5,
                                             total_steps=25))
    params, hist = train(model, params,
                         batches(4, 64, vocab_size=cfg.vocab_size,
                                 device="cpu"), tc)
    assert [h["step"] for h in hist] == [0, 5, 10, 15, 20, 24]
    assert hist[-1]["ce"] < hist[0]["ce"] - 0.2
    assert np.isfinite(hist[-1]["grad_norm"])
    assert all(p.grad is None and not p.requires_grad
               for _, p in leaves_with_names(params))


class _ProductionMesh:
    """Stands in for the (16, 16) DeviceMesh (what the rules read)."""
    mesh_dim_names = ("data", "model")
    shape = (16, 16)
    device_type = "cpu"


def test_build_train_step_on_one_device_and_its_mesh_raises():
    cfg = get_config("internlm2-1.8b")
    shape = INPUT_SHAPES["train_4k"]
    bundle = build_train_step(cfg, shape, device="cpu")
    assert bundle.opt.state_dtype == "float32"
    assert bundle.inputs == {"tokens": ((256, 4096), torch.int32)}
    assert build_train_step(get_config("deepseek-v3-671b"), shape,
                            device="cpu").opt.state_dtype == "bfloat16"
    pali = build_train_step(get_config("paligemma-3b"), shape, device="cpu")
    assert pali.inputs["tokens"][0] == (256, 4096 - 256)
    # a mesh places params by the rules: FSDP (embed over data) above
    # FSDP_PARAM_THRESHOLD parameters, as the reference's use_fsdp
    mesh = _ProductionMesh()
    meshed = build_train_step(cfg, shape, mesh=mesh)
    assert meshed.mesh is mesh and meshed.meta["fsdp"] is False
    assert meshed.rules.rules["embed"] is None
    big = build_train_step(get_config("deepseek-v3-671b"), shape, mesh=mesh)
    assert big.meta == {"kind": "train", "fsdp": True,
                        "opt_dtype": "bfloat16"}
    assert big.rules.rules["embed"] == "data"
    with pytest.raises(ValueError, match="build_decode_step"):
        build_train_step(cfg, INPUT_SHAPES["decode_32k"], device="cpu")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    cfg = get_config("memori-agent").reduced(layers=2, d_model=64)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    path = str(tmp_path / "ckpt.msgpack")
    n = ckpt.save_params(path, cfg, params)
    assert n > 0
    zeros = unflatten(params, [torch.zeros_like(p) for _, p in
                                   leaves_with_names(params)])
    loaded = ckpt.load_params(path, cfg, like=zeros)
    for (name, a), (_, b) in zip(leaves_with_names(params),
                                 leaves_with_names(loaded)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(name))
    bare = ckpt.load_params(path, cfg, device="cpu")
    assert {n for n, _ in leaves_with_names(bare)} == {
        n for n, _ in leaves_with_names(params)}
    bad = get_config("memori-agent").reduced(layers=2, d_model=128)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_params(path, cfg, like=Model(bad).init_params(
            torch.Generator().manual_seed(0)))


def test_bf16_checkpoint_roundtrip(tmp_path):
    """bf16 leaves go out as the reference writes them (2-byte raw '<V2'
    entries: numpy has no bf16) and come back as the same bf16 bits."""
    cfg = dataclasses.replace(
        get_config("internlm2-1.8b").reduced(layers=2, d_model=64),
        param_dtype="bfloat16")
    params = Model(cfg).init_params(torch.Generator().manual_seed(4))
    path = str(tmp_path / "bf16.msgpack")
    ckpt.save_params(path, cfg, params)
    assert {a.dtype.itemsize for a in ckpt.load_raw(path).values()} == {2}
    back = ckpt.load_params(path, cfg, device="cpu")
    for name, a in leaves_with_names(params):
        got = dict(leaves_with_names(back))[name]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), a.view(torch.int16))


@pytest.mark.parametrize("arch", ["memori-agent", "recurrentgemma-9b",
                                  "whisper-small"])
def test_checkpoints_cross_load_between_the_packages(arch, tmp_path):
    """The port's `save_params` file is the reference's `save` of the same
    weights, byte for byte, and each package loads the other's: the
    segments restacked (recurrentgemma: a (rglru, rglru, attn) period
    stacked 4 times and a (rglru, rglru) remainder; whisper: the encoder's
    own segments)."""
    layers = 14 if arch == "recurrentgemma-9b" else 2
    jcfg = jget_config(arch).reduced(layers=layers, d_model=64)
    cfg = get_config(arch).reduced(layers=layers, d_model=64)
    jparams, params = _pair_params(jcfg, cfg, seed=3)
    mine, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "ref.msgpack")
    ckpt.save_params(mine, cfg, params)
    jckpt.save(theirs, jparams)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    loaded = jckpt.load(mine, jax.tree.map(jnp.zeros_like, jparams))
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back = ckpt.load_params(theirs, cfg, like=params)
    for (name, a), (_, b) in zip(leaves_with_names(back),
                                 leaves_with_names(params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(name))


# ---------------------------------------------------------------------------
# the launcher and the example as subprocesses
# ---------------------------------------------------------------------------

def _run(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=timeout)


def test_train_launcher_host_demo_on_the_cpu():
    out = _run("repro_torch.launch.train", "--arch", "internlm2-1.8b",
               "--shape", "train_4k", "--steps", "2", "--host-demo",
               "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 1", "done"]
    loss = [float(ln.split("loss=")[1].split()[0]) for ln in lines[:2]]
    assert all(np.isfinite(loss))


def test_train_launcher_refuses_multipod(capsys):
    from repro_torch.launch import train as launcher
    with pytest.raises(SystemExit) as ei:
        launcher.parse_args(["--multipod", "--device", "cpu"])
    assert ei.value.code == 2
    assert "under torchrun with 512 ranks" in capsys.readouterr().err


def test_train_100m_example_small_on_the_cpu(tmp_path):
    """The example trains, writes a checkpoint that the reference's
    `checkpoint.io.load` reads into its own tree, and samples."""
    path = str(tmp_path / "agent.msgpack")
    out = _run("repro_torch.examples.train_100m", "--small", "--device",
               "cpu", "--steps", "3", "--out", path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("sample:") == 2
    assert f"checkpoint: {path}" in out.stdout
    jcfg = jget_config("memori-agent").reduced(layers=2, d_model=128)
    like = JModel(jcfg).init_params(jax.random.PRNGKey(1))
    loaded = jckpt.load(path, like)
    cfg = get_config("memori-agent").reduced(layers=2, d_model=128)
    mine = ckpt.load_params(path, cfg, device="cpu")
    want = _flat(params_to_numpy(cfg, mine))
    for key, arr in _flat(jax.tree.map(np.asarray, loaded)).items():
        np.testing.assert_array_equal(arr, want[key])


def test_the_same_archs_in_both_packages():
    assert tuple(ASSIGNED_ARCHS) == tuple(J_ASSIGNED)
    assert dataclasses.fields(opt.OptimizerConfig) and [
        f.name for f in dataclasses.fields(opt.OptimizerConfig)] == [
        f.name for f in dataclasses.fields(jopt.OptimizerConfig)]


def test_update_is_the_same_in_groups_of_any_size(monkeypatch):
    """The foreach runs over groups of leaves (GROUP_ELEMENTS bounds the
    f32 temporaries): any grouping gives the same bits."""
    _, cfg = _agent()
    params = Model(cfg).init_params(torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    grads = unflatten(params, [torch.randn(p.shape, generator=gen)
                                   for _, p in leaves_with_names(params)])
    ocfg = opt.OptimizerConfig(warmup_steps=0, state_dtype="bfloat16")
    whole = opt.update(ocfg, params, grads, opt.init(ocfg, params))
    monkeypatch.setattr(opt, "GROUP_ELEMENTS", 1000)
    split = opt.update(ocfg, params, grads, opt.init(ocfg, params))
    for tree_a, tree_b in zip((whole[0], whole[1].mu, whole[1].nu),
                              (split[0], split[1].mu, split[1].nu)):
        for (_, a), (_, b) in zip(leaves_with_names(tree_a),
                                  leaves_with_names(tree_b)):
            assert torch.equal(a, b)
