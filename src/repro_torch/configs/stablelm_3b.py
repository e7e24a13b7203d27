"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b family: LayerNorm, partial
rotary (25%), full MHA.]"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        arch_type="dense",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        source="[hf:stabilityai/stablelm-2-1_6b]",
        norm="layernorm",
        rope_pct=0.25,
        rope_theta=10000.0,
        act="silu",
        mlp_gated=True,
        long_context_window=8192,   # sliding-window variant for long_500k
    )
