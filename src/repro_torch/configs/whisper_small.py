"""whisper-small [audio] — 12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865.  Enc-dec; the mel/conv frontend is a STUB per the assignment —
input_specs provides (B, 1500, 768) frame embeddings.  Decoder positions are
adapted to sinusoidal so decode_32k lowers (DESIGN.md §3); long_500k is
skipped (full-attention enc-dec, DESIGN.md §9).  [arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        arch_type="audio",
        num_layers=12,                 # decoder layers
        encoder_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        source="[arXiv:2212.04356]",
        is_encoder_decoder=True,
        encoder_seq_len=1500,
        norm="layernorm",
        act="gelu",
        mlp_gated=False,
        qkv_bias=True,
        rope_pct=0.0,                  # sinusoidal absolute positions
        supports_long_context=False,   # long_500k skipped (DESIGN.md §9)
        long_context_window=0,
    )
