"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060) — the
reference's `repro/models/layers/ssm.py` in torch.

Train/prefill run the chunked SSD matmul form with the reference's
`chunk_size` (so rounding follows it): intra-chunk attention-like einsums,
then a recurrence over the chunks' summary states (a Python loop over
L / chunk_size steps).  Decode is the O(1) recurrent state update, written
into the cache {"conv", "state"} in place so the step can be captured as
a CUDA graph.  All of it is plain torch arithmetic: the reference has no
Pallas kernel here.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.common import partitioning as pt
from repro_torch.common.module import ParamSpec


def dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    return d_in, H, s.n_groups, s.state_dim, s.head_dim, s.conv_width


def specs(cfg):
    d = cfg.d_model
    d_in, H, G, N, P, W = dims(cfg)
    conv_dim = d_in + 2 * G * N
    return {
        "in_proj": ParamSpec((d, 2 * d_in + 2 * G * N + H), ("embed", "state"),
                             init="scaled_normal", scale=1.0),
        "conv_w": ParamSpec((W, conv_dim), (None, "state"), init="scaled_normal", scale=1.0),
        "conv_b": ParamSpec((conv_dim,), ("state",), init="zeros"),
        "A_log": ParamSpec((H,), ("state",), init="ssm_alog"),
        "D": ParamSpec((H,), ("state",), init="ones"),
        "dt_bias": ParamSpec((H,), ("state",), init="ssm_dt_bias"),
        "norm_scale": ParamSpec((d_in,), ("state",), init="ones"),
        "out_proj": ParamSpec((d_in, d), ("state", "embed"), init="scaled_normal", scale=1.0),
    }


def causal_conv(x, w, b):
    """Depthwise causal conv, as the reference sums it.  x: (B,L,C),
    w: (W,C)."""
    W, L = w.shape[0], x.shape[1]
    xp = pt.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + L] * w[i] for i in range(W))
    return out + b


def conv_state(x, W: int):
    """The causal conv's decode state after a prefill: the last W - 1
    inputs (B, W-1, C), zero rows first when the prompt is shorter (the
    zeros the conv padded on the left).  The reference keeps the short
    (B, L, C) slice there, which its decode cannot take."""
    return pt.pad(x[:, -(W - 1):], (0, 0, max(0, W - 1 - x.shape[1]), 0))


def _gated_norm(y, z, scale, eps):
    y = y * F.silu(z)
    yf = y.float()
    var = (yf * yf).mean(-1, keepdim=True)
    return ((yf / torch.sqrt(var + eps)) * scale.float()).to(y.dtype)


def _chunked_scan(xh, Bh, Ch, dtx, log_a, h0=None, *, Q: int):
    """The chunked SSD over a whole sequence: xh/dtx (B,L,H,P), Bh/Ch
    (B,L,H,N), log_a (B,L,H), h0 (B,H,N,P) f32 or None (zeros) -> (y
    (B,L,H,P) f32 without the D skip, the final state h (B,H,N,P) f32)."""
    B_, L, H, P = xh.shape
    N = Bh.shape[-1]
    f32 = torch.float32
    Q = min(Q, L)
    pad = (Q - L % Q) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bh = F.pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = F.pad(Ch, (0, 0, 0, 0, 0, pad))
        dtx = F.pad(dtx, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
    Lp = L + pad
    nc = Lp // Q
    xc = dtx.reshape(B_, nc, Q, H, P)
    bc = Bh.reshape(B_, nc, Q, H, N)
    cc = Ch.reshape(B_, nc, Q, H, N)
    la = log_a.reshape(B_, nc, Q, H)
    la_cum = torch.cumsum(la, dim=2)                           # (B,nc,Q,H)
    la_tot = la_cum[:, :, -1]                                  # (B,nc,H)

    # intra-chunk (the "attention" dual): scores[s,t] = C_s·B_t e^{la_s-la_t}
    cb = torch.einsum("bcshn,bcthn->bchst", cc.float(), bc.float())
    seg = la_cum.transpose(2, 3)                               # (B,nc,H,Q)
    ldiff = seg[..., :, None] - seg[..., None, :]              # (B,nc,H,Q,Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))
    # masked before the exp (exp(-inf) = 0, the same values): above the
    # diagonal ldiff > 0 can overflow, and an inf there would turn the
    # gradient of a where() around the exp into NaN
    L_mat = torch.exp(torch.where(
        causal, ldiff, torch.full((), float("-inf"), device=xh.device)))
    y_intra = torch.einsum("bchst,bcthp->bcshp", cb * L_mat, xc.float())

    # chunk summary states: S_c = Σ_t e^{la_tot - la_t} B_t ⊗ x_t
    decay_to_end = torch.exp(la_tot[:, :, None] - la_cum)      # (B,nc,Q,H)
    S_c = torch.einsum("bcthn,bcthp->bchnp",
                       bc.float() * decay_to_end[..., None],
                       xc.float())                             # (B,nc,H,N,P)

    # recurrence over the nc chunks, the state before each chunk kept
    a_chunk = torch.exp(la_tot)                                # (B,nc,H)
    h = (h0 if h0 is not None
         else torch.zeros((B_, H, N, P), dtype=f32, device=xh.device))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * a_chunk[:, c, :, None, None] + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                      # (B,nc,H,N,P)

    # inter-chunk contribution: y_inter[s] = e^{la_s} C_s · h_prev
    decay_in = torch.exp(la_cum)                               # (B,nc,Q,H)
    y_inter = torch.einsum("bcshn,bchnp->bcshp", cc.float(),
                           h_prevs) * decay_in[..., None]
    return (y_intra + y_inter).reshape(B_, Lp, H, P)[:, :L], h


def _scan_meshed(xh, Bh, Ch, dtx, log_a, h0, Q: int):
    """`_chunked_scan` on DTensors under `local_map`: the scan is
    independent across batch rows and heads, so each rank scans its batch
    shard of its `model` shard of the heads (DTensor's strategies for the
    scan's reshapes of sharded dims are not relied on)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xh.device_mesh
    rows = pt.batch_axes_placements(mesh, xh.shape[0], 0)
    H = xh.shape[2]

    def heads_on_model(dim):       # and the heads on `model` where divisible
        return [Shard(dim) if name == "model" and H % mesh.size(i) == 0
                else rows[i] for i, name in enumerate(mesh.mesh_dim_names)]

    seq, state = heads_on_model(2), heads_on_model(1)
    args = [pt.with_placements(pt.replicated(t, mesh), seq)
            for t in (xh, Bh, Ch, dtx, log_a)]
    places = [seq] * 5
    if h0 is not None:
        args.append(pt.with_placements(pt.replicated(h0, mesh), state))
        places.append(state)
    return local_map(functools.partial(_chunked_scan, Q=Q),
                     out_placements=(seq, state),
                     in_placements=tuple(places), device_mesh=mesh)(*args)


def _decode_step(h, log_a, dtx, Bh, Ch):
    """One recurrent step: h (B,H,P,N), log_a (B,H), dtx (B,H,P), Bh/Ch
    (B,H,N) f32 -> (h' = exp(log_a) h + dtx ⊗ B, y = h'·C (B,H,P))."""
    upd = torch.einsum("bhp,bhn->bhpn", dtx, Bh)
    h_new = torch.exp(log_a)[:, :, None, None] * h + upd
    return h_new, torch.einsum("bhpn,bhn->bhp", h_new, Ch)


def _step_meshed(h, log_a, dtx, Bh, Ch):
    """`_decode_step` under `local_map`: each rank steps its batch shard
    of its `model` shard of the heads."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = h.device_mesh
    rows = pt.batch_axes_placements(mesh, h.shape[0], 0)
    pl = [Shard(1) if name == "model" and h.shape[1] % mesh.size(i) == 0
          else rows[i] for i, name in enumerate(mesh.mesh_dim_names)]
    args = [pt.with_placements(pt.replicated(t, mesh), pl)
            for t in (h, log_a, dtx, Bh, Ch)]
    return local_map(_decode_step, out_placements=(pl, pl),
                     in_placements=(pl,) * 5, device_mesh=mesh)(*args)


def apply(params, cfg, x, *, mode: str = "train", cache=None,
          return_cache: bool = False):
    """x: (B,L,d).  train/prefill: chunked SSD over the whole sequence
    (optionally emitting a decode cache); decode: one step against cache =
    {"conv": (B,W-1,conv_dim), "state": (B,H,P,N)}, updated in place."""
    s = cfg.ssm
    d_in, H, G, N, P, W = dims(cfg)
    dt_ = x.dtype
    f32 = torch.float32
    B_, L, d = x.shape

    # on a mesh the SSD runs batch-parallel: the projection's `state`
    # columns and the per-head/per-channel vectors are gathered, so the
    # split, the conv and the chunked scan see whole heads (the out
    # projection contracts them back)
    proj = pt.gather_dims(torch.matmul(x, params["in_proj"].to(dt_)), -1)
    if pt.is_dtensor(proj):
        params = {k: v if k.endswith("_proj") else
                  pt.gather_dims(v, *range(v.dim()))
                  for k, v in params.items()}
    z, xs, Bc, Cc, dtp = torch.split(
        proj, [d_in, d_in, G * N, G * N, H], dim=-1)
    xBC = torch.cat([xs, Bc, Cc], dim=-1)

    if mode == "decode":
        window = torch.cat([cache["conv"].to(dt_), xBC], dim=1)   # (B,W,·)
        conv_out = (window * params["conv_w"].to(dt_)).sum(1, keepdim=True)
        conv_out = conv_out + params["conv_b"].to(dt_)
        new_conv = window[:, 1:]
    else:
        conv_out = causal_conv(xBC, params["conv_w"].to(dt_),
                               params["conv_b"].to(dt_))
        new_conv = conv_state(xBC, W) if return_cache else None
    conv_out = F.silu(conv_out)
    xs, Bc, Cc = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)

    xh = xs.reshape(B_, L, H, P)
    rep = H // G                                    # groups over heads
    Bh = Bc.reshape(B_, L, G, N).repeat_interleave(rep, dim=2)   # (B,L,H,N)
    Ch = Cc.reshape(B_, L, G, N).repeat_interleave(rep, dim=2)
    dt_full = F.softplus(dtp.float() + params["dt_bias"].float())  # (B,L,H)
    A = torch.exp(params["A_log"].float())                         # (H,)
    log_a = -dt_full * A                                           # (B,L,H)
    dtx = xh * dt_full.to(dt_)[..., None]                          # (B,L,H,P)

    if mode == "decode":
        # h: (B,H,P,N);  h' = exp(log_a) h + dtx ⊗ B;  y = h'·C + D x
        step_args = (cache["state"].float(), log_a[:, 0], dtx[:, 0].float(),
                     Bh[:, 0].float(), Ch[:, 0].float())
        h_new, y = (_step_meshed(*step_args) if pt.is_dtensor(xh)
                    else _decode_step(*step_args))
        y = y + params["D"].float()[:, None] * xh[:, 0].float()
        y = y.reshape(B_, 1, d_in).to(dt_)
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(h_new)
        new_cache = cache
    else:
        h0 = (cache["state"].float().transpose(2, 3)
              if (mode == "prefill" and cache is not None) else None)
        if pt.is_dtensor(xh):
            y, h = _scan_meshed(xh, Bh, Ch, dtx, log_a, h0, s.chunk_size)
        else:
            y, h = _chunked_scan(xh, Bh, Ch, dtx, log_a, h0,
                                 Q=s.chunk_size)
        y = y + params["D"].float()[:, None] * xh.float()
        y = y.reshape(B_, L, d_in).to(dt_)
        new_cache = None
        if return_cache:
            new_cache = {"conv": new_conv.to(dt_),
                         "state": h.transpose(2, 3).to(dt_)}

    y = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"].to(dt_))
    return out, new_cache


def cache_specs(cfg, batch: int, dtype):
    d_in, H, G, N, P, W = dims(cfg)
    return {
        "conv": ((batch, W - 1, d_in + 2 * G * N), ("batch", None, "state"), dtype),
        "state": ((batch, H, P, N), ("batch", "state", None, None), dtype),
    }
