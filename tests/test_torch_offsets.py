"""Offset query positions in train/prefill attention (K6), against the JAX
package on the CPU.

The reference masks train/prefill attention from position arrays
(`attention._allowed` on absolute positions); the port's K6 takes per-row
offsets of the queries and the keys (positions `offset + 0..S-1`), read on
the device, and masks the same way: causal kv <= q, window kv > q - window,
prefix kv < prefix_len on the key's absolute position, and a key below
position 0 masked.  Held here, on the same numpy-seeded inputs:

* K6's plain version (what a CPU tensor runs) against the reference's
  `attend`, at offsets 0, 5 on every row, per-row [3, 17], queries ahead
  of their keys, and keys below position 0; causal, window and prefix
  masks; f32 at 2e-5 (online against direct softmax);
* `attention.apply` and MLA's `apply` in train and prefill mode against
  the reference layers at 1e-5, and `Model._embed_inputs(positions_offset=
  7)` with a decoder pass over its positions;
* `FlashAttentionFn`'s gradient at an offset against JAX's gradient of
  the reference's `attend`, at 1e-4 of each gradient's scale.

The CUDA kernels take the same offsets on the card (chip_smoke.py's
attention phase holds them to these plain versions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro.models.layers import attention as jattn
from repro.models.layers import mla as jmla
from repro.models.model_api import Model as JModel
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import transformer
from repro_torch.models.layers import attention
from repro_torch.models.layers import mla as tmla
from repro_torch.models.model_api import Model, params_from_numpy
from test_torch_mla_absorbed import setup as mla_setup

KERNEL_TOL = 2e-5
LAYER_TOL = 1e-5
GRAD_TOL = 1e-4
# (query offsets, key offsets) of the two rows
OFFSETS = {"zero": ([0, 0], [0, 0]), "five": ([5, 5], [5, 5]),
           "rows": ([3, 17], [3, 17]), "ahead": ([9, 20], [5, 16]),
           "below_zero": ([1, 2], [-2, -3])}
# (kind, window, prefix_len)
MASKS = {"causal": ("causal", 0, None), "window": ("causal", 4, None),
         "prefix": ("prefix", 0, 6)}


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _close_to_scale(t, j, tol):
    """Max error within tol x the reference's max |value|: RoPE at
    positions past 0 rounds its angles in each framework's own way, which
    lands on the output's small entries as an error of the output's
    scale, not of the entry's."""
    j = np.asarray(j, np.float32)
    err = float(np.abs(t.detach().float().numpy() - j).max())
    assert err <= tol * float(np.abs(j).max()), err


def _positions(offsets, n):
    return (np.asarray(offsets, np.int32)[:, None]
            + np.arange(n, dtype=np.int32)[None, :])


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("case", sorted(OFFSETS))
def test_flash_attention_plain_version_masks_offset_positions(case, mask):
    kind, window, prefix = MASKS[mask]
    q_off, kv_off = OFFSETS[case]
    # four keys more than queries: every query row keeps an allowed key
    # (a row with none gives 0 in K6 and the mean of v in the reference)
    B, S, T, K, G, D = 2, 11, 15, 2, 3, 8
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, K * G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, K, D)).astype(np.float32)
    v = rng.standard_normal((B, T, K, D)).astype(np.float32)
    want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.asarray(_positions(q_off, S)),
                        kv_pos=jnp.asarray(_positions(kv_off, T)),
                        kind=kind, window=window, prefix_len=prefix)
    got = attention.attend(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), kind=kind, window=window,
                           prefix_len=prefix,
                           q_offset=torch.tensor(q_off),
                           kv_offset=torch.tensor(kv_off))
    _close(got, want, KERNEL_TOL)
    if case == "five":   # an int offset is the same as a tensor of it
        again = tfa.flash_attention_ref(
            torch.from_numpy(q).view(B, S, K, G, D).permute(0, 2, 3, 1, 4),
            torch.from_numpy(k).permute(0, 2, 1, 3),
            torch.from_numpy(v).permute(0, 2, 1, 3), causal=True,
            window=window, prefix_len=prefix, q_offset=5, kv_offset=5)
        torch.testing.assert_close(
            again.permute(0, 3, 1, 2, 4).reshape(B, S, K * G, D), got,
            rtol=0, atol=0)


def test_zero_offsets_are_bit_identical_to_no_offsets():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 2, 3, 13, 8)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 13, 8)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 13, 8)).astype(
        np.float32))
    for kw in ({}, {"window": 5}, {"prefix_len": 4}):
        base = tfa.flash_attention(q, k, v, **kw)
        zero = tfa.flash_attention(q, k, v, q_offset=torch.zeros(2),
                                   kv_offset=0, **kw)
        assert torch.equal(base, zero)


def _cfgs():
    return (jget_config("memori-agent").reduced(layers=2, d_model=64),
            get_config("memori-agent").reduced(layers=2, d_model=64))


def _attn_params(cfg, rng):
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {"wq": rng.standard_normal((d, h, hd)).astype(np.float32) / 8,
            "wk": rng.standard_normal((d, kv, hd)).astype(np.float32) / 8,
            "wv": rng.standard_normal((d, kv, hd)).astype(np.float32) / 8,
            "wo": rng.standard_normal((h, hd, d)).astype(np.float32) / 8}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("case", ["zero", "five", "rows"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_attention_apply_at_offsets_matches_the_reference(mode, case, mask):
    kind, window, prefix = MASKS[mask]
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(5)
    p = _attn_params(cfg, rng)
    B, S = 2, 9
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = _positions(OFFSETS[case][0], S)
    got, cache = attention.apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, cfg,
        torch.from_numpy(x), positions=torch.from_numpy(pos), mode=mode,
        mask_kind=kind, window=window, prefix_len=prefix,
        return_cache=mode == "prefill")
    want, jcache = jattn.apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
        positions=jnp.asarray(pos), mode=mode, mask_kind=kind,
        window=window, prefix_len=prefix, return_cache=mode == "prefill")
    _close(got, want, LAYER_TOL)
    if mode == "prefill":
        _close(cache["k"], jcache["k"], LAYER_TOL)   # RoPE at the offset


@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_prefill_at_per_row_offsets_matches_the_reference(absorbed):
    import dataclasses
    jcfg, cfg, jparams, params = mla_setup()
    jcfg = dataclasses.replace(jcfg, mla_absorbed_train=absorbed)
    cfg = dataclasses.replace(cfg, mla_absorbed_train=absorbed)
    jp = jparams["segments"][0][0]["attn"]
    tp = params["layers"][0]["attn"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    pos = _positions([3, 17], 12)
    jout, _ = jax.jit(lambda p, xx: jmla.apply(
        p, jcfg, xx, positions=jnp.asarray(pos), mode="prefill"))(
            jp, jnp.asarray(x))
    tout, _ = tmla.apply(tp, cfg, torch.from_numpy(x),
                         positions=torch.from_numpy(pos), mode="prefill")
    _close_to_scale(tout, jout, LAYER_TOL)


def test_embed_inputs_positions_offset_and_a_decoder_pass_match():
    """`_embed_inputs(positions_offset=7)` gives the reference's embeddings
    and positions 7..S+6, and both stacks' prefill over those positions
    (RoPE and K6's mask at the offset) agree."""
    jcfg, cfg = _cfgs()
    jmodel = JModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = Model(cfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    tokens = np.random.default_rng(7).integers(4, cfg.vocab_size, (2, 10))
    x, pos, _, _, _ = model._embed_inputs(
        params, {"tokens": torch.from_numpy(tokens.astype(np.int64))},
        positions_offset=7)
    jx, jpos, _, _, _ = jmodel._embed_inputs(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
        positions_offset=7)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert pos[0, 0] == 7 and pos[1, -1] == 16
    _close(x, jx, LAYER_TOL)
    h, _, _ = transformer.decoder_apply(params, cfg, x, mode="prefill",
                                        positions=pos)
    jh, _, _ = jtransformer.decoder_apply(jparams, jcfg, jx, mode="prefill",
                                          positions=jpos)
    _close(h, jh, LAYER_TOL)


@pytest.mark.parametrize("offsets", ["int", "rows"])
def test_flash_attention_gradient_at_an_offset_matches_jax(offsets):
    """FlashAttentionFn (the plain forward on the CPU, the torch-ops
    backward) at offset queries/keys against jax.grad of the reference's
    attend, causal with a window of 6."""
    B, S, K, G, D = 2, 14, 2, 2, 8
    q_off, kv_off = ([4, 4], [2, 2]) if offsets == "int" else ([3, 17],
                                                               [1, 15])
    T = S + 2          # keys from 2 before the queries: none keyless
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, S, K * G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, K, D)).astype(np.float32)
    v = rng.standard_normal((B, T, K, D)).astype(np.float32)
    w = rng.standard_normal((B, S, K * G, D)).astype(np.float32)
    qp, kp = jnp.asarray(_positions(q_off, S)), jnp.asarray(
        _positions(kv_off, T))

    def jloss(a, b, c):
        out = jattn.attend(a, b, c, q_pos=qp, kv_pos=kp, kind="causal",
                           window=6)
        return jnp.sum(out * jnp.asarray(w))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    kw = (dict(q_offset=4, kv_offset=2) if offsets == "int" else
          dict(q_offset=torch.tensor(q_off), kv_offset=torch.tensor(kv_off)))
    out = tfa.flash_attention(ts[0].view(B, S, K, G, D).permute(0, 2, 3, 1, 4),
                              ts[1].permute(0, 2, 1, 3),
                              ts[2].permute(0, 2, 1, 3), causal=True,
                              window=6, **kw)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, K * G, D)
    (out * torch.from_numpy(w)).sum().backward()
    for t, want in zip(ts, jg):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert float(np.abs(t.grad.numpy() - want).max()) <= GRAD_TOL * scale


def test_flash_attention_gradient_keeps_the_key_cut_for_one_offset_tensor(
        monkeypatch):
    """Self-attention over a window passes one (B,) offset tensor for both
    sides: the frames agree, so the backward still cuts each block's keys
    to the causal range (checked by a spy on the mask it builds) and its
    gradient matches jax.grad of the reference's attend at 1e-4 of each
    gradient's scale (blocks of 4 rows, so the cut moves block by block)."""
    B, S, K, G, D = 2, 14, 2, 2, 8
    off = [3, 17]
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, S, K * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    w = rng.standard_normal((B, S, K * G, D)).astype(np.float32)
    pos = jnp.asarray(_positions(off, S))

    def jloss(a, b, c):
        out = jattn.attend(a, b, c, q_pos=pos, kv_pos=pos, kind="causal",
                           window=6)
        return jnp.sum(out * jnp.asarray(w))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    monkeypatch.setattr(tfa, "BWD_BLOCK", 4)
    keys = []
    real = tfa._allowed

    def spy(B, q_rows, k_rows, **kw):
        keys.append((int(q_rows[0]), int(q_rows[-1]), int(k_rows[0]),
                     int(k_rows[-1])))
        return real(B, q_rows, k_rows, **kw)

    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(ts[0].view(B, S, K, G, D).permute(0, 2, 3, 1, 4),
                              ts[1].permute(0, 2, 1, 3),
                              ts[2].permute(0, 2, 1, 3), causal=True,
                              window=6, q_offset=(o := torch.tensor(off)),
                              kv_offset=o)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, K * G, D)
    monkeypatch.setattr(tfa, "_allowed", spy)
    (out * torch.from_numpy(w)).sum().backward()
    # each block's keys: from its first row - window + 1 to its last row
    assert keys == [(s0, min(S, s0 + 4) - 1, max(0, s0 - 5),
                     min(S, s0 + 4) - 1) for s0 in range(0, S, 4)]
    for t, want in zip(ts, jg):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert float(np.abs(t.grad.numpy() - want).max()) <= GRAD_TOL * scale


@pytest.mark.parametrize("arch", ["memori-agent", "paligemma-3b",
                                  "whisper-small", "deepseek-v3-671b"])
def test_model_entry_points_give_k6_no_offsets(arch, monkeypatch):
    """The model's train loss, hidden states and prefill make positions
    0..S-1 and say so: every K6 call (self, prefix, cross, MLA and MTP
    attention) gets int offsets of 0, which the card runs on the
    instances without offsets and whose backward keeps its key cut."""
    seen = []
    real = attention.flash_attention

    def spy(*args, q_offset=None, kv_offset=None, **kw):
        seen.append((q_offset, kv_offset))
        return real(*args, q_offset=q_offset, kv_offset=kv_offset, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    cfg = get_config(arch).reduced(layers=2, d_model=64)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(
        rng.integers(4, cfg.vocab_size, (2, 12)).astype(np.int64))}
    if cfg.num_image_tokens:
        batch["images"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.num_image_tokens, 1152)).astype(np.float32))
    if cfg.is_encoder_decoder:
        batch["audio"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    model.train_loss(params, batch)
    model.hidden(params, batch)
    model.prefill(params, batch)
    assert len(seen) >= 6
    assert all(o == 0 and not isinstance(o, torch.Tensor)
               for pair in seen for o in pair), seen
    assert tfa._offset_rows(0, 0, 2, torch.device("cpu")) is None
