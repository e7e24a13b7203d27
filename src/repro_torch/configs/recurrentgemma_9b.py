"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000.  RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427]."""
from repro_torch.models.config import ModelConfig, RGLRUConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        arch_type="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,               # MQA on the local-attention layers
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        source="[arXiv:2402.19427]",
        hybrid_period=3,              # (rglru, rglru, local-attn) repeating
        rglru=RGLRUConfig(width=0, conv_width=4, local_window=2048,
                          c_exponent=8.0),
        act="gelu",
        mlp_gated=True,
        tie_embeddings=True,
        long_context_window=0,        # natively sub-quadratic (fixed-size caches)
    )
