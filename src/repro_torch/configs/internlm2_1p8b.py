"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544.  GQA [arXiv:2403.17297]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        arch_type="dense",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92544,
        source="[arXiv:2403.17297]",
        long_context_window=8192,
    )
