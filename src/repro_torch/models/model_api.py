"""Model facade: one API over the whole zoo, as the reference's
`repro/models/model_api.py`:

  model = Model(cfg)
  params = model.init_params(generator)          # or params_from_numpy(...)
  loss, metrics = model.train_loss(params, batch)
  logits = model(params, batch)                  # full forward, (B, S, V)
  logits, caches = model.prefill(params, batch)
  caches = model.prepare_decode_caches(caches, prefill_len, max_len)
  logits, caches = model.decode_step(params, tokens, caches, cache_pos)

Batches are dicts (a bare (B, S) token tensor is taken as {"tokens"}):
  tokens  (B, S) int                        — always
  images  (B, P, vision_dim)                — vlm (stub SigLIP patch embeds)
  audio   (B, F, d_model)                   — audio (stub conv/mel frames)
  loss_mask (B, S) f32                      — optional (training)

Parameters are a plain tree: {"embed": {...}, "layers": [block dicts],
"final_norm": {...}}, plus {"encoder": {"layers", "final_norm"}} for the
encoder-decoder, {"img_proj": {"w", "b"}} for image prefixes and {"mtp":
{...}} for multi-token prediction, every tensor on one device.  Attention
runs through the kernels K6 (prefill, full forward, the encoder) and K5
(decode) on CUDA tensors and through their plain versions on CPU tensors.
Decode updates the caches in place.

Training: `train_loss` runs the stack in train mode with recompute (each
block under `torch.utils.checkpoint`; K6 with its autograd Function), the
cross-entropy over 256-position chunks, each chunk itself recomputed in
the backward so the (B, S, V) f32 logits are never all held, plus the MoE
auxiliary losses and deepseek's depth-1 MTP loss.  `params_to_numpy`
inverts `params_from_numpy`: the reference's segment-stacked tree, so a
checkpoint (`checkpoint.io.save_params`) has the reference's keys.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common import partitioning as pt
from repro_torch.common.module import (ParamSpec, leaves_with_names,
                                      materialize, shardings_of,
                                      spec_tree_to_pspecs, tree_map,
                                      unflatten)
from repro_torch.common.utils import resolve_device
from repro_torch.models import blocks, transformer
from repro_torch.models.config import ModelConfig, plan_segments
from repro_torch.models.layers import embedding, norms
from repro_torch.models.layers import rope as rope_lib

PyTree = Any


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg, num_layers=cfg.encoder_layers, arch_type="dense", use_moe=False,
        use_mla=False, hybrid_period=0, first_k_dense=0, mtp_depth=0,
        sliding_window=0, is_encoder_decoder=False)


def cfg_vision_dim(cfg) -> int:
    return 1152  # SigLIP-so400m patch embedding width (stub frontend)


class Model(nn.Module):
    """A stateless facade (the parameters are passed in, as in the
    reference); `forward` is the full forward to logits."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.param_specs()

    # -- specs / init --------------------------------------------------------
    def param_specs(self) -> PyTree:
        cfg = self.cfg
        s = {"embed": embedding.specs(cfg),
             **transformer.decoder_specs(cfg, cross=cfg.is_encoder_decoder)}
        if cfg.is_encoder_decoder:
            s["encoder"] = transformer.decoder_specs(encoder_cfg(cfg))
        if cfg.num_image_tokens:
            s["img_proj"] = {
                "w": ParamSpec((cfg_vision_dim(cfg), cfg.d_model),
                               (None, "embed"), init="scaled_normal",
                               scale=1.0),
                "b": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
            }
        if cfg.mtp_depth:
            s["mtp"] = {
                "proj": ParamSpec((2 * cfg.d_model, cfg.d_model),
                                  ("embed", None), init="scaled_normal",
                                  scale=1.0),
                "norm_h": norms.specs(cfg),
                "norm_e": norms.specs(cfg),
                "block": blocks.block_specs(cfg, ("attn", "mlp")),
                "final_norm": norms.specs(cfg),
            }
        return s

    # -- partitioning ----------------------------------------------------------
    def param_pspecs(self, rules) -> PyTree:
        """The rules' per-dim mapping of every parameter (the reference's
        PartitionSpec tree, one dict per layer here)."""
        return spec_tree_to_pspecs(self.param_specs(), rules)

    def param_shardings(self, rules) -> PyTree:
        """DTensor placements of every parameter on `rules.mesh`."""
        return shardings_of(self.param_specs(), rules)

    def shard_params(self, params, mesh, rules) -> PyTree:
        """One-device params (the same on every rank, as a seed or
        `params_from_numpy` gives them) -> DTensors on `mesh` placed by
        the rules; each rank keeps its own slice, with no communication."""
        specs = [s for _, s in leaves_with_names(self.param_specs())]
        return unflatten(params, [
            pt.shard_local(p, mesh, rules.placements_for(s.axes, s.shape))
            for (_, p), s in zip(leaves_with_names(params), specs)])

    def cache_pspecs(self, batch, max_len, rules, *, window_override=None):
        """The rules' per-dim mapping of every decode-cache entry: one
        {name: mapping} per layer."""
        return [{name: rules.spec_for(axes, shape)
                 for name, (shape, axes, _dt) in layer.items()}
                for layer in self._cache_shape_specs(batch, max_len,
                                                     window_override)]

    def cache_shardings(self, batch, max_len, rules, *,
                        window_override=None):
        return [{name: pt.placements_for(spec, rules.mesh)
                 for name, spec in layer.items()}
                for layer in self.cache_pspecs(
                    batch, max_len, rules, window_override=window_override)]

    def _cache_shape_specs(self, batch, max_len, window_override):
        cfg = self.cfg
        return transformer.decoder_cache_shape_specs(
            cfg, batch, max_len, cfg.cdtype, cross=cfg.is_encoder_decoder,
            enc_len=cfg.encoder_seq_len, window_override=window_override)

    def init_params(self, generator: torch.Generator) -> PyTree:
        """Random init on the generator's device, in the config's dtype."""
        return materialize(generator, self.param_specs(), self.cfg.pdtype)

    # -- embedding front-ends ------------------------------------------------
    def _embed_inputs(self, params, batch, *, positions_offset: int = 0):
        """-> (x (B,S,d), positions (B,S), prefix_len, enc_out, enc_pos);
        positions are positions_offset + 0..S-1 on every row."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B = tokens.shape[0]
        x = embedding.embed(params["embed"], cfg, tokens)
        prefix_len = None
        enc_out = enc_pos = None
        if cfg.num_image_tokens and "images" in batch:
            dt = cfg.cdtype
            img = torch.einsum("bpv,vd->bpd", batch["images"].to(dt),
                               params["img_proj"]["w"].to(dt))
            img = img + params["img_proj"]["b"].to(dt)
            x = torch.cat([img, x], dim=1)
            prefix_len = cfg.num_image_tokens
        S = x.shape[1]
        positions = torch.arange(S, device=x.device).expand(B, S)
        if positions_offset:
            positions = positions + positions_offset
        if cfg.is_encoder_decoder and "audio" in batch:
            enc_out, enc_pos = self.encode(params, batch["audio"])
            # whisper-style decoder: sinusoidal absolute positions, no rope
            x = x + rope_lib.sinusoidal_positions(
                S, cfg.d_model, cfg.cdtype, device=x.device)[None]
        return x, positions, prefix_len, enc_out, enc_pos

    def encode(self, params, audio_frames):
        """The encoder's bidirectional pass over (B, F, d) frames (K6) ->
        (enc_out (B, F, d), positions (B, F))."""
        cfg = self.cfg
        B, F, _ = audio_frames.shape
        x = audio_frames.to(cfg.cdtype)
        x = x + rope_lib.sinusoidal_positions(F, cfg.d_model, cfg.cdtype,
                                              device=x.device)[None]
        pos = torch.arange(F, device=x.device).expand(B, F)
        h, _, _ = transformer.decoder_apply(
            params["encoder"], encoder_cfg(cfg), x, mode="train",
            positions=pos, mask_kind="bidir", use_rope=False,
            positions_offset=0)
        return h, pos

    @staticmethod
    def _batch(batch):
        return batch if isinstance(batch, dict) else {"tokens": batch}

    def hidden(self, params, batch, *, mask_kind: Optional[str] = None):
        """Final-norm hidden states (B, S, d) of a whole sequence (image
        prefix positions first); `mask_kind` overrides the config's mask
        (the bidirectional embedder)."""
        cfg = self.cfg
        x, positions, prefix_len, enc_out, enc_pos = self._embed_inputs(
            params, self._batch(batch))
        if mask_kind is None:
            mask_kind = "prefix" if prefix_len is not None else "causal"
        h, _, _ = transformer.decoder_apply(
            params, cfg, x, mode="train", positions=positions,
            mask_kind=mask_kind, prefix_len=prefix_len, enc_out=enc_out,
            enc_positions=enc_pos, use_rope=not cfg.is_encoder_decoder,
            positions_offset=0, enc_positions_offset=0)
        return h

    def forward(self, params, batch):
        """Full forward: logits (B, S, V) of every position."""
        return embedding.logits(params["embed"], self.cfg,
                                self.hidden(params, batch))

    # -- training ----------------------------------------------------------------
    def train_loss(self, params, batch):
        """-> (loss, metrics {ce, accuracy, moe_load_balance, moe_router_z,
        moe_drop_fraction[, mtp_ce], loss}), each a 0-d f32 tensor: the
        next-token cross-entropy over the text positions (an image prefix
        sliced off, `loss_mask[:, 1:]` weighting the targets) plus the
        MoE auxiliary losses and mtp_loss_weight times the MTP loss."""
        cfg = self.cfg
        batch = self._batch(batch)
        x, positions, prefix_len, enc_out, enc_pos = self._embed_inputs(
            params, batch)
        h, _, aux = transformer.decoder_apply(
            params, cfg, x, mode="train", positions=positions,
            mask_kind="prefix" if prefix_len is not None else "causal",
            prefix_len=prefix_len, enc_out=enc_out, enc_positions=enc_pos,
            use_rope=not cfg.is_encoder_decoder, remat=True,
            positions_offset=0, enc_positions_offset=0)
        tokens = batch["tokens"]
        P = prefix_len or 0
        h_text = h[:, P:]                               # (B, S_text, d)
        loss_mask = batch.get("loss_mask")
        ce, acc = _chunked_xent(
            params, cfg, h_text[:, :-1], tokens[:, 1:],
            loss_mask[:, 1:] if loss_mask is not None else None)
        total = ce + aux["moe_load_balance"] + aux["moe_router_z"]
        metrics = {"ce": ce, "accuracy": acc, **aux}
        if cfg.mtp_depth:
            mtp = self._mtp_loss(params, cfg, h_text, tokens,
                                 positions[:, P:], P)
            total = total + cfg.mtp_loss_weight * mtp
            metrics["mtp_ce"] = mtp
        metrics["loss"] = total
        return total, metrics

    def _mtp_loss(self, params, cfg, h, tokens, positions, offset=None):
        """DeepSeek-V3 MTP (depth 1): from h_t and emb(token_{t+1}) predict
        token_{t+2} through one extra transformer block; `positions` are
        offset + 0..S-1 (None: read from them)."""
        mtp = params["mtp"]
        emb_next = embedding.embed(params["embed"], cfg, tokens[:, 1:])
        hin = torch.cat([norms.apply(mtp["norm_h"], cfg, h[:, :-1]),
                         norms.apply(mtp["norm_e"], cfg, emb_next)], dim=-1)
        hin = torch.einsum("bsd,de->bse", hin, mtp["proj"].to(hin.dtype))
        hb, _, _ = blocks.apply(mtp["block"], cfg, hin, ("attn", "mlp"),
                                mode="train", positions=positions[:, :-1],
                                positions_offset=offset)
        hb = norms.apply(mtp["final_norm"], cfg, hb)
        ce, _ = _chunked_xent(params, cfg, hb[:, :-1], tokens[:, 2:], None)
        return ce

    # -- serving ---------------------------------------------------------------
    def prefill(self, params, batch, *, window_override=None):
        """batch {"tokens": (B, S)[, "images" | "audio"]} -> (logits of the
        last position (B, 1, V), per-layer caches of the P + S positions)."""
        cfg = self.cfg
        x, positions, prefix_len, enc_out, enc_pos = self._embed_inputs(
            params, self._batch(batch))
        h, caches, _ = transformer.decoder_apply(
            params, cfg, x, mode="prefill", positions=positions,
            mask_kind="prefix" if prefix_len is not None else "causal",
            prefix_len=prefix_len, enc_out=enc_out, enc_positions=enc_pos,
            window_override=window_override, return_cache=True,
            use_rope=not cfg.is_encoder_decoder, positions_offset=0,
            enc_positions_offset=0)
        return embedding.logits(params["embed"], cfg, h[:, -1:]), caches

    def decode_step(self, params, tokens, caches, cache_pos, *,
                    window_override=None):
        """tokens: (B, 1); caches from prepare_decode_caches/init_caches,
        updated in place; cache_pos a scalar or a per-slot (B,) vector
        (continuous batching).  -> (logits (B, 1, V), caches)."""
        cfg = self.cfg
        B = tokens.shape[0]
        x = embedding.embed(params["embed"], cfg, tokens)
        pos = torch.as_tensor(cache_pos, device=tokens.device)
        if pos.dim() == 0:
            pos = pos.expand(B)
        if cfg.is_encoder_decoder:
            # absolute sinusoidal position = cache_pos (per row)
            x = x + rope_lib.sinusoidal_at(pos, cfg.d_model).to(
                cfg.cdtype)[:, None]
        h, caches, _ = transformer.decoder_apply(
            params, cfg, x, mode="decode", positions=pos[:, None],
            caches=caches, cache_pos=pos, window_override=window_override,
            use_rope=not cfg.is_encoder_decoder)
        return embedding.logits(params["embed"], cfg, h), caches

    def prepare_decode_caches(self, caches, prefill_len, max_len, *,
                              window_override=None):
        return transformer.prepare_decode_caches(
            self.cfg, caches, prefill_len, max_len,
            window_override=window_override)

    def init_caches(self, batch, max_len, *, window_override=None,
                    device="cuda"):
        cfg = self.cfg
        return transformer.init_caches(
            cfg, batch, max_len, cfg.cdtype, cross=cfg.is_encoder_decoder,
            enc_len=cfg.encoder_seq_len, window_override=window_override,
            device=device)


def _xent_chunk(params, cfg, h, targets, mask):
    """Summed cross-entropy, correct predictions and weight of one chunk:
    h (B, c, d), targets (B, c), mask (B, c) f32."""
    logits = embedding.logits(params["embed"], cfg, h)      # (B, c, V) f32
    if pt.is_dtensor(logits):
        return _xent_meshed(logits, targets, mask)
    return _xent_sums(logits, targets, mask)


def _xent_meshed(logits, targets, mask):
    """`_xent_sums` of DTensor logits: the vocab gathered, then each rank's
    batch rows under `local_map` (the gold-logit gather and the argmax
    read across the whole vocab), its three sums stacked over the batch
    ranks and summed as DTensor ops."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    rows = pt.batch_axes_placements(mesh, logits.shape[0], 0)
    logits = pt.with_placements(logits, rows)
    targets, mask = (pt.with_placements(pt.replicated(t, mesh), rows)
                     for t in (targets, mask))
    stacked = [Shard(0) if isinstance(p, Shard) else Replicate()
               for p in rows]
    sums = local_map(lambda *a: tuple(x[None] for x in _xent_sums(*a)),
                     out_placements=(stacked,) * 3,
                     in_placements=(rows, rows, rows),
                     device_mesh=mesh)(logits, targets, mask)
    return tuple(x.sum() for x in sums)


def _xent_sums(logits, targets, mask):
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    ce = (logz - gold) * mask
    correct = (logits.argmax(-1) == targets).float() * mask
    return ce.sum(), correct.sum().detach(), mask.sum()


def _chunked_xent(params, cfg, h, targets, loss_mask, chunk: int = 256):
    """(mean cross-entropy, accuracy) over `chunk`-position slices of h
    (B, S, d) against targets (B, S), weighted by loss_mask (B, S) (all
    ones when None).  With grad enabled each chunk runs under
    `torch.utils.checkpoint`, so its (B, chunk, V) f32 logits are
    recomputed in the backward, never kept."""
    B, S, _ = h.shape
    mask = (torch.ones((B, S), dtype=torch.float32, device=h.device)
            if loss_mask is None else loss_mask.float())
    grad = torch.is_grad_enabled()
    ces, cors, cnts = [], [], []
    for c0 in range(0, S, chunk):
        args = (params, cfg, h[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk])
        ce, cor, cnt = (checkpoint(_xent_chunk, *args, use_reentrant=False)
                        if grad else _xent_chunk(*args))
        ces.append(ce)
        cors.append(cor)
        cnts.append(cnt)
    denom = torch.clamp(torch.stack(cnts).sum(), min=1.0)
    return torch.stack(ces).sum() / denom, torch.stack(cors).sum() / denom


def _layers_from_numpy(cfg: ModelConfig, segments, tensor):
    """The reference's segments (each a tuple of period blocks, stacked on
    a leading `repeats` axis when repeats > 1) unstacked into one dict per
    layer, in `layer_kinds()` order."""
    layers = []
    for seg, (period, repeats) in zip(segments,
                                      plan_segments(cfg.layer_kinds())):
        for r in range(repeats):
            for b_i in range(len(period)):
                layers.append(tree_map(
                    lambda a: tensor(a[r] if repeats > 1 else a), seg[b_i]))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers in the tree, config has "
                         f"{cfg.num_layers}")
    return layers


def params_from_numpy(cfg: ModelConfig, tree: PyTree,
                      device="cuda") -> PyTree:
    """The reference's parameter tree (after `jax.tree.map(np.asarray,
    params)`: nested dicts and tuples, each scanned segment stacked on a
    leading `repeats` axis) -> the port's tree, with the segments unstacked
    into one dict per layer (every segment of a multi-segment plan, e.g.
    deepseek's dense layers then its MoE layers, or the hybrid's (rglru,
    rglru, attn) period and its remainder), every leaf a tensor on
    `device` ("cuda", the default, or "cpu").  A 2-byte leaf with no
    numpy type (bf16: '<V2' raw, or ml_dtypes' bfloat16) becomes a bf16
    tensor of the same bits."""
    device = resolve_device(device)

    def tensor(a):
        a = np.array(a)
        if a.dtype.str.endswith("V2"):
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    out = {"embed": tree_map(tensor, tree["embed"]),
           "layers": _layers_from_numpy(cfg, tree["segments"], tensor),
           "final_norm": tree_map(tensor, tree["final_norm"])}
    if cfg.is_encoder_decoder:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": _layers_from_numpy(encoder_cfg(cfg), enc["segments"],
                                         tensor),
            "final_norm": tree_map(tensor, enc["final_norm"])}
    for name in ("img_proj", "mtp"):
        if name in tree:
            out[name] = tree_map(tensor, tree[name])
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as a host array; bf16 as the raw 2-byte void array the
    reference's `np.asarray` of a bf16 array writes ('<V2')."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _layers_to_numpy(cfg: ModelConfig, layers):
    """Per-layer dicts restacked into the reference's segments."""
    segments, i = [], 0
    for period, repeats in plan_segments(cfg.layer_kinds()):
        blks = []
        for b_i in range(len(period)):
            group = [layers[i + r * len(period) + b_i]
                     for r in range(repeats)]
            blks.append(tree_map(_numpy, group[0]) if repeats == 1 else
                        _stack_trees(group))
        segments.append(tuple(blks))
        i += len(period) * repeats
    return tuple(segments)


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return np.stack([_numpy(t) for t in trees])


def params_to_numpy(cfg: ModelConfig, params: PyTree) -> PyTree:
    """The port's tree -> the reference's (numpy leaves): per-layer dicts
    restacked into `segments` (a tuple of segments, each a tuple of period
    blocks stacked on a leading `repeats` axis when repeats > 1), the
    inverse of `params_from_numpy`."""
    out = {"embed": tree_map(_numpy, params["embed"]),
           "segments": _layers_to_numpy(cfg, params["layers"]),
           "final_norm": tree_map(_numpy, params["final_norm"])}
    if cfg.is_encoder_decoder:
        enc = params["encoder"]
        out["encoder"] = {
            "segments": _layers_to_numpy(encoder_cfg(cfg), enc["layers"]),
            "final_norm": tree_map(_numpy, enc["final_norm"])}
    for name in ("img_proj", "mtp"):
        if name in params:
            out[name] = tree_map(_numpy, params[name])
    return out
