"""ModelConfig: a single config dataclass spanning the whole model zoo
(dense / MoE / SSM / hybrid / enc-dec audio / VLM) plus the layer-plan
machinery that turns a per-layer kind list into scannable segments.

A copy of the reference's `repro/models/config.py`; only `pdtype`/`cdtype`
differ: they return `torch.dtype`s.  The port runs the layers as a Python
loop, so `plan_segments` serves to read the reference's stacked parameter
trees (`model_api.params_from_numpy`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def torch_dtype(name: str) -> torch.dtype:
    """"float32" / "bfloat16" / ... -> the torch dtype of that name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    # dispatch = "global": one global capacity ranking + scatter (baseline —
    # simple, but SPMD materialises cross-shard traffic for the buffers).
    # dispatch = "local": per-data-shard ranking/capacity with vmap'd local
    # scatter; only the (E, cap, d) buffers cross chips (the true all-to-all).
    # See EXPERIMENTS.md §Perf.
    dispatch: str = "global"
    # number of data shards the local dispatch assumes (set by the launcher
    # to mesh batch-axis size; 1 == degenerate/local single shard)
    local_shards: int = 1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 128
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    width: int = 0            # 0 => d_model
    conv_width: int = 4
    local_window: int = 2048
    c_exponent: float = 8.0   # the RG-LRU "c" constant


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads
    source: str = ""                  # citation bracket from the assignment

    # Attention flavour ------------------------------------------------------
    attention: str = "causal"         # causal | sliding | prefix_lm
    sliding_window: int = 0           # 0 => full
    rope_theta: float = 10000.0
    rope_pct: float = 1.0             # partial rotary (stablelm = 0.25)
    qkv_bias: bool = False
    qk_norm: bool = False
    use_mla: bool = False
    mla: MLAConfig = MLAConfig()

    # Block pattern ----------------------------------------------------------
    # kinds: "attn" | "ssm" | "rglru" (rglru layers use local attention when
    # the pattern says "attn" in a hybrid). FFN kind is attached per layer.
    hybrid_period: int = 0            # recurrentgemma: every Nth layer = attn
    first_k_dense: int = 0            # deepseek: first k layers use dense FFN

    # Norm / MLP -------------------------------------------------------------
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"                 # silu | gelu
    mlp_gated: bool = True
    tie_embeddings: bool = False
    parallel_residual: bool = False   # stablelm-style parallel attn+mlp

    # MoE / SSM / RG-LRU -----------------------------------------------------
    use_moe: bool = False
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    rglru: RGLRUConfig = RGLRUConfig()

    # Multi-token prediction (deepseek-v3) ------------------------------------
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.3

    # §Perf variants -----------------------------------------------------------
    # MLA absorbed-form attention in train/prefill too (never materialise the
    # decompressed (B,S,H,Dqk) K — trades score FLOPs for bytes).
    mla_absorbed_train: bool = False
    # Quantised KV cache for decode ("int8" or "" = compute dtype).
    kv_cache_quant: str = ""

    # Encoder-decoder (whisper) ----------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 1500       # whisper: 30s of audio -> 1500 frames
    # VLM (paligemma) ---------------------------------------------------------
    num_image_tokens: int = 0         # >0 => prefix-LM over image embeddings

    # Long-context policy -----------------------------------------------------
    # For full-attention archs, long_500k decode runs with this window (the
    # documented sliding-window variant); 0 = arch is natively sub-quadratic
    # or long_500k is skipped (see DESIGN.md §9).
    long_context_window: int = 8192
    supports_long_context: bool = True

    # Numerics ----------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logits_dtype: str = "float32"

    # Dry-run probe mode: unroll scanned segments so XLA cost analysis counts
    # every layer (used by launch/roofline.py probes; see EXPERIMENTS.md).
    force_unroll: bool = False

    # ------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.num_heads))

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """Per-layer (mixer_kind, ffn_kind) for the decoder stack."""
        kinds = []
        for i in range(self.num_layers):
            if self.arch_type == "ssm":
                mixer = "ssm"
            elif self.hybrid_period > 0:
                mixer = "attn" if (i % self.hybrid_period == self.hybrid_period - 1) else "rglru"
            else:
                mixer = "attn"
            if self.use_moe and i >= self.first_k_dense:
                ffn = "moe"
            elif self.d_ff > 0 or (self.use_moe and i < self.first_k_dense):
                ffn = "mlp"
            else:
                ffn = "none"   # mamba2: the block IS the mixer
            kinds.append((mixer, ffn))
        return tuple(kinds)

    def reduced(self, *, layers: int = 2, d_model: int = 256, experts: int = 4,
                vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family (mandated: <=2 layers,
        d_model<=512, <=4 experts)."""
        heads = max(2, min(4, self.num_heads))
        kvh = max(1, min(heads, self.num_kv_heads if self.num_kv_heads < self.num_heads else heads))
        changes = dict(
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kvh,
            head_dim=d_model // heads,
            d_ff=0 if self.d_ff == 0 else d_model * 2,
            vocab_size=vocab,
            encoder_layers=min(self.encoder_layers, layers),
            encoder_seq_len=min(self.encoder_seq_len, 32),
            num_image_tokens=min(self.num_image_tokens, 16),
            first_k_dense=min(self.first_k_dense, 1),
            mtp_depth=min(self.mtp_depth, 1),
            hybrid_period=min(self.hybrid_period, 3) if self.hybrid_period else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.use_moe:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(experts, self.moe.num_experts),
                experts_per_token=min(2, self.moe.experts_per_token),
                d_ff_expert=d_model * 2,
            )
        if self.use_mla:
            changes["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32)
            changes["head_dim"] = 0
        if self.arch_type == "ssm" or self.hybrid_period:
            changes["ssm"] = dataclasses.replace(self.ssm, state_dim=16, head_dim=16, chunk_size=16)
            changes["rglru"] = dataclasses.replace(self.rglru, width=0, local_window=16)
        return dataclasses.replace(self, **changes)

    # Parameter count (analytic; used for MODEL_FLOPS = 6 N D) ---------------
    def param_count(self, active_only: bool = False) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.resolved_head_dim
        n = 0
        emb = self.vocab_size * d
        n += emb if self.tie_embeddings else 2 * emb
        for mixer, ffn in self.layer_kinds():
            if mixer == "attn":
                if self.use_mla:
                    m = self.mla
                    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
                    n += d * m.q_lora_rank + m.q_lora_rank * h * qk_hd
                    n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    n += m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                    n += h * m.v_head_dim * d
                else:
                    n += d * h * hd + 2 * d * kv * hd + h * hd * d
            elif mixer == "ssm":
                di = self.ssm.expand * d
                nh = di // self.ssm.head_dim
                bc = 2 * self.ssm.n_groups * self.ssm.state_dim
                n += d * (2 * di + bc + nh)        # in_proj (z,x,B,C,dt)
                n += (di + bc) * self.ssm.conv_width
                n += di * d                         # out_proj
                n += 2 * nh                         # A_log, D
            elif mixer == "rglru":
                w = self.rglru.width or d
                n += d * 2 * w + w * d              # in/out proj
                n += w * self.rglru.conv_width
                n += 2 * w + 2 * w * w // 1         # gates (diag-ish; approx block)
            if ffn == "mlp":
                ff = self.d_ff
                n += d * ff * (3 if self.mlp_gated else 2)
            elif ffn == "moe":
                e = self.moe.experts_per_token if active_only else self.moe.num_experts
                ff = self.moe.d_ff_expert or self.d_ff
                n += (e + self.moe.num_shared_experts) * d * ff * (3 if self.mlp_gated else 2)
                n += d * self.moe.num_experts       # router
        if self.is_encoder_decoder:
            # encoder self-attn + mlp, decoder cross-attn
            enc = self.encoder_layers * (d * h * hd + 2 * d * kv * hd + h * hd * d
                                         + d * self.d_ff * (3 if self.mlp_gated else 2))
            cross = self.num_layers * (d * h * hd + 2 * d * kv * hd + h * hd * d)
            n += enc + cross
        return n


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def plan_segments(kinds: Tuple) -> Tuple[Tuple[Tuple, int], ...]:
    """Partition a per-layer kind list into (period_kinds, repeats) segments,
    greedily maximising scanned coverage.  Homogeneous stacks -> one segment;
    recurrentgemma's (r, r, a)*12 + (r, r) -> two segments; deepseek's
    3 dense + 58 moe -> two segments."""
    segments = []
    i, n = 0, len(kinds)
    while i < n:
        # Prefer genuinely repeating patterns (r >= 2); a period-p segment
        # with r == 1 is just p unrolled layers and blocks a better scan of
        # the suffix (e.g. deepseek: 3 dense then 58 scanned moe layers).
        best_p, best_r = 1, 1
        for p in range(1, min(8, (n - i) // 2) + 1):
            pat = kinds[i:i + p]
            r = 1
            while i + (r + 1) * p <= n and kinds[i + r * p: i + (r + 1) * p] == pat:
                r += 1
            if r >= 2 and (r * p > best_p * best_r
                           or (r * p == best_p * best_r and p < best_p)):
                best_p, best_r = p, r
        segments.append((kinds[i:i + best_p], best_r))
        i += best_p * best_r
    assert sum(len(p) * r for p, r in segments) == n
    return tuple(segments)
