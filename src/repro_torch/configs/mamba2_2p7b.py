"""mamba2-2.7b [ssm] — 64L d_model=2560 (attn-free) d_ff=0 vocab=50280,
ssm_state=128.  SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        arch_type="ssm",
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,                       # the SSD block is the whole layer
        vocab_size=50280,
        source="[arXiv:2405.21060]",
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      chunk_size=128, n_groups=1),
        tie_embeddings=True,
        long_context_window=0,        # natively sub-quadratic
    )
