"""K6 under autograd on the CPU: `flash_attention`'s autograd Function
(`FlashAttentionFn`, whose backward is torch ops over query blocks) against
`jax.grad` of the reference's attention (`repro.models.layers.attention.
attend`, the pure-JAX SDPA that XLA differentiates for the reference's
training) and against autograd through the plain version
(`flash_attention_ref`).

Every mask kind of the training path: causal, causal with a window, the
prefix-LM mask (a scalar and a per-row int32 tensor), bidirectional (the
encoder) and cross-attention (bidirectional, S != T); G in {1, 3, 4}; S
off the backward's 256-row block.  Gradients are held relative to the
largest |g| of each input: GRAD_TOL = 2e-5 in f32 (the reference's
forward tolerance; the recomputed probabilities and the dS = P (dP - D)
form sum in other orders than XLA's autodiff), 2e-2 in bf16 (held against
the same computation in f32).  A query row with no allowed key has output
0 and gradient 0.  On the card chip_smoke.py holds the Function's
gradients against autograd through the plain version (phase 15a).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models.layers import attention

GRAD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, S, T, H, K, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, K, D)).astype(np.float32)
    v = rng.standard_normal((B, T, K, D)).astype(np.float32)
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, g


def _rel_close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err} > {tol}"


def _torch_grads(q, k, v, g, dtype=torch.float32, **kw):
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_(True)
                  for x in (q, k, v))
    out = attention.attend(qt, kt, vt, **kw)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g).to(dtype))
    return out, (qt.grad, kt.grad, vt.grad)


CASES = {
    # kind, S, T, window, prefix
    "causal": ("causal", 300, 300, 0, None),
    "window": ("causal", 300, 300, 40, None),
    "prefix": ("prefix", 300, 300, 0, 70),
    "prefix_rows": ("prefix", 300, 300, 0, [5, 290]),
    "bidir": ("bidir", 300, 300, 0, None),
    "cross": ("bidir", 20, 530, 0, None),
}


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_grad_matches_jax_grad_of_the_reference(case, G):
    kind, S, T, window, prefix = CASES[case]
    B, K, D = 2, 2, 16
    H = K * G
    q, k, v, g = _inputs(B, S, T, H, K, D, seed=len(case) + G)
    pl = None if prefix is None else (
        np.asarray(prefix, np.int32) if isinstance(prefix, list) else prefix)

    def jloss(jq, jk, jv):
        out = jattn.attend(
            jq, jk, jv, q_pos=jnp.broadcast_to(jnp.arange(S), (B, S)),
            kv_pos=jnp.broadcast_to(jnp.arange(T), (B, T)), kind=kind,
            window=window,
            prefix_len=None if pl is None else jnp.asarray(pl))
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tpl = None if pl is None else (
        torch.from_numpy(pl) if isinstance(pl, np.ndarray) else pl)
    out, grads = _torch_grads(q, k, v, g, kind=kind, window=window,
                              prefix_len=tpl)
    _rel_close(out.detach().numpy(), jout, GRAD_TOL["float32"], "output")
    for name, t, j in zip("qkv", grads, jgrads):
        _rel_close(t.numpy(), j, GRAD_TOL["float32"], f"d{name}")


@pytest.mark.parametrize("causal,window,prefix,S,T", [
    (True, 0, None, 513, 513),          # three blocks, the last of 1 row
    (True, 25, None, 300, 300),
    (True, 0, 270, 300, 300),
    (True, 0, "rows", 300, 300),
    (True, 25, 100, 300, 300),          # the window cuts the prefix too
    (False, 0, None, 64, 700),
    (False, 30, None, 300, 300),
    (True, 30, None, 600, 100),         # rows past T + window: no key
])
@pytest.mark.parametrize("G", [1, 4])
def test_grad_matches_autograd_through_the_plain_version(causal, window,
                                                         prefix, S, T, G):
    B, K, D = 2, 2, 8
    torch.manual_seed(S + T + G)
    q = torch.randn(B, K, G, S, D, requires_grad=True)
    k = torch.randn(B, K, T, D, requires_grad=True)
    v = torch.randn(B, K, T, D, requires_grad=True)
    g = torch.randn(B, K, G, S, D)
    if prefix == "rows":
        prefix = torch.tensor([3, 280], dtype=torch.int32)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    out = tfa.flash_attention(q, k, v, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = tfa.flash_attention_ref(q, k, v, **kw)
    want = torch.autograd.grad(ref, (q, k, v), g)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for name, a, b in zip("qkv", got, want):
        _rel_close(a.numpy(), b.numpy(), GRAD_TOL["float32"], f"d{name}")
    if S > T + window:          # the rows with no allowed key: 0 and 0
        empty = slice(T + window, None)
        assert float(out.detach()[:, :, :, empty].abs().max()) == 0.0
        assert float(got[0][:, :, :, empty].abs().max()) == 0.0


def test_bf16_grads_follow_the_f32_ones_in_the_inputs_dtype():
    q, k, v, g = _inputs(2, 160, 160, 6, 2, 32, seed=9)
    _, g32 = _torch_grads(q, k, v, g, kind="causal")
    _, g16 = _torch_grads(q, k, v, g, dtype=torch.bfloat16, kind="causal")
    for name, a, b in zip("qkv", g16, g32):
        assert a.dtype == torch.bfloat16
        _rel_close(a.float().numpy(), b.numpy(), GRAD_TOL["bfloat16"],
                   f"bf16 d{name}")


def test_the_function_runs_only_where_a_gradient_is_wanted():
    """No input needing a gradient (prefill, decode, the eval paths): the
    plain dispatch, no graph.  Under no_grad too.  Else the Function."""
    q = torch.randn(1, 1, 2, 8, 4)
    k = torch.randn(1, 1, 8, 4)
    v = torch.randn(1, 1, 8, 4)
    assert tfa.flash_attention(q, k, v).grad_fn is None
    k.requires_grad_(True)
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).grad_fn is None
    out = tfa.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    dk, = torch.autograd.grad(out.sum(), (k,))
    assert dk.shape == k.shape


def test_the_models_strided_views_take_gradients():
    """`attend` hands K6 the (B, S, H, D) projection as a grouped
    (B, K, G, S, D) view and folds the (B, S, K, G, D) output back: a
    gradient through that path equals the one through contiguous copies."""
    q, k, v, g = _inputs(2, 40, 40, 6, 2, 8, seed=4)
    _, grads = _torch_grads(q, k, v, g, kind="causal")
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    B, S, H, D = qt.shape
    qg = qt.reshape(B, S, 2, 3, D).permute(0, 2, 3, 1, 4).contiguous()
    out = tfa.flash_attention(qg, kt.permute(0, 2, 1, 3).contiguous(),
                              vt.permute(0, 2, 1, 3).contiguous())
    out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).backward(
        torch.from_numpy(g))
    for a, b in zip(grads, (qt.grad, kt.grad, vt.grad)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
