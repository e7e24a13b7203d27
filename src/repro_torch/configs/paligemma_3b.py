"""paligemma-3b [vlm] — 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216.  SigLIP vision tower is a STUB per the assignment —
input_specs provides (B, 256, 1152) patch embeddings consumed through a
learned projector; the Gemma decoder uses prefix-LM masking over the image
tokens.  [arXiv:2407.07726]"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        arch_type="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,               # MQA (gemma-2b)
        head_dim=256,
        d_ff=16384,
        vocab_size=257216,
        source="[arXiv:2407.07726]",
        num_image_tokens=256,
        act="gelu",
        mlp_gated=True,
        tie_embeddings=True,
        attention="prefix_lm",
        long_context_window=8192,     # sliding-window variant for long_500k
    )
