"""Model facade for the dense decoder LMs of the zoo (memori-agent, and the
dense configs whose blocks this slice carries):

  model = Model(cfg)
  params = model.init_params(generator)          # or params_from_numpy(...)
  logits = model(params, tokens)                 # full forward, (B, S, V)
  logits, caches = model.prefill(params, {"tokens": tokens})
  caches = model.prepare_decode_caches(caches, prefill_len, max_len)
  logits, caches = model.decode_step(params, tokens, caches, cache_pos)

Parameters are a plain tree: {"embed": {...}, "layers": [block dicts],
"final_norm": {...}}, every tensor on one device.  Attention runs through
the kernels K6 (prefill, full forward) and K5 (decode) on CUDA tensors and
through their plain versions on CPU tensors.  Decode updates the caches in
place.  Configs with experts, MLA, SSM / RG-LRU mixers, an encoder, image
prefixes or multi-token prediction raise NotImplementedError at
construction; training (`train_loss`) arrives with the training slice.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.common.module import materialize, tree_map
from repro_torch.common.utils import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, plan_segments
from repro_torch.models.layers import embedding

PyTree = Any

SLICE_ENCDEC = "the encoder-decoder slice of the port"
SLICE_VLM = "the image-prefix (VLM) slice of the port"
SLICE_MTP = "the training slice of the port (multi-token prediction)"


class Model(nn.Module):
    """A stateless facade (the parameters are passed in, as in the
    reference); `forward` is the full causal forward to logits."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.param_specs()      # raises for what this slice does not carry

    # -- specs / init --------------------------------------------------------
    def param_specs(self) -> PyTree:
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            raise NotImplementedError(f"{cfg.name}: {SLICE_ENCDEC}")
        if cfg.num_image_tokens:
            raise NotImplementedError(f"{cfg.name}: {SLICE_VLM}")
        if cfg.mtp_depth:
            raise NotImplementedError(f"{cfg.name}: {SLICE_MTP}")
        return {"embed": embedding.specs(cfg),
                **transformer.decoder_specs(cfg)}

    def init_params(self, generator: torch.Generator) -> PyTree:
        """Random init on the generator's device, in the config's dtype."""
        return materialize(generator, self.param_specs(), self.cfg.pdtype)

    # -- forward ---------------------------------------------------------------
    @staticmethod
    def _positions(tokens):
        B, S = tokens.shape
        return torch.arange(S, device=tokens.device).expand(B, S)

    def hidden(self, params, tokens, *, mask_kind: str = "causal"):
        """Final-norm hidden states (B, S, d) of a whole sequence."""
        x = embedding.embed(params["embed"], self.cfg, tokens)
        h, _ = transformer.decoder_apply(
            params, self.cfg, x, mode="train", positions=self._positions(tokens),
            mask_kind=mask_kind)
        return h

    def forward(self, params, tokens):
        """Full causal forward: logits (B, S, V) of every position."""
        return embedding.logits(params["embed"], self.cfg,
                                self.hidden(params, tokens))

    # -- serving ---------------------------------------------------------------
    def prefill(self, params, batch):
        """batch {"tokens": (B, S)} -> (logits of the last position
        (B, 1, V), per-layer caches of S positions)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embedding.embed(params["embed"], cfg, tokens)
        h, caches = transformer.decoder_apply(
            params, cfg, x, mode="prefill", positions=self._positions(tokens),
            return_cache=True)
        return embedding.logits(params["embed"], cfg, h[:, -1:]), caches

    def decode_step(self, params, tokens, caches, cache_pos):
        """tokens: (B, 1); caches from prepare_decode_caches/init_caches,
        updated in place; cache_pos a scalar or a per-slot (B,) vector
        (continuous batching).  -> (logits (B, 1, V), caches)."""
        cfg = self.cfg
        B = tokens.shape[0]
        x = embedding.embed(params["embed"], cfg, tokens)
        pos = torch.as_tensor(cache_pos, device=tokens.device)
        if pos.dim() == 0:
            pos = pos.expand(B)
        h, caches = transformer.decoder_apply(
            params, cfg, x, mode="decode", positions=pos[:, None],
            caches=caches, cache_pos=pos)
        return embedding.logits(params["embed"], cfg, h), caches

    def prepare_decode_caches(self, caches, prefill_len, max_len):
        return transformer.prepare_decode_caches(self.cfg, caches,
                                                 prefill_len, max_len)

    def init_caches(self, batch, max_len, *, device="cuda"):
        return transformer.init_caches(self.cfg, batch, max_len,
                                       self.cfg.cdtype, device=device)


def params_from_numpy(cfg: ModelConfig, tree: PyTree,
                      device="cuda") -> PyTree:
    """The reference's parameter tree (after `jax.tree.map(np.asarray,
    params)`: nested dicts and tuples, each scanned segment stacked on a
    leading `repeats` axis) -> the port's tree, with the segments unstacked
    into one dict per layer, every leaf a tensor on `device` ("cuda", the
    default, or "cpu")."""
    device = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device)

    layers = []
    for seg, (period, repeats) in zip(tree["segments"],
                                      plan_segments(cfg.layer_kinds())):
        for r in range(repeats):
            for b_i in range(len(period)):
                blk = seg[b_i]
                layers.append(tree_map(
                    lambda a: tensor(a[r] if repeats > 1 else a), blk))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers in the tree, config has "
                         f"{cfg.num_layers}")
    return {"embed": tree_map(tensor, tree["embed"]),
            "layers": layers,
            "final_norm": tree_map(tensor, tree["final_norm"])}
